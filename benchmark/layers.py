"""What the per-layer readers share: stage times, launches, idle share and
kernel rooflines, each read from the traced run's context (``ctx``, built by
``harness.run_cell``). A reader returns None where it finds nothing to read."""

from __future__ import annotations

import torch

from benchmark import roofline
from benchmark.reference.leg import FOOT_RADIUS, GROUND_Z


def stage_ms(ctx, stage: str):
    """Mean host milliseconds a cycle of one stage of ``mpc_cycle_batch``
    (``update``, ``solve``, ``apply``), from its ``profile=`` times."""
    s = ctx.stage_s.get(stage)
    return None if s is None or ctx.stage_cycles == 0 else 1e3 * s / ctx.stage_cycles


def launches_per_cycle(ctx):
    t = ctx.trace
    return None if t is None or t.cycles == 0 else t.launches / t.cycles


def device_idle_pct(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def share(ctx, kernel_names, work) -> dict | None:
    """A kernel's share of its roofline over the profiled cycles: the bound of
    ``work`` (bytes, operations) over the device time of the kernels named."""
    if ctx.trace is None or work is None:
        return None
    dev_s = ctx.trace.kernel_s(kernel_names)
    if dev_s <= 0:
        return None
    bytes_moved, flops = work
    t, by = roofline.bound(bytes_moved, flops)
    return {"value": 100.0 * t / dev_s, "bound_by": by, "bound_s": t, "device_s": dev_s,
            "power_limit_w": ctx.power_limit_w}


def cycle_iterations(ctx) -> list[int]:
    """Iterations the batch ran in each profiled cycle: the solve's chunks run
    every scenario until the last has converged, so the largest count."""
    return [int(p.log.solver_iters.max()) for p in ctx.prof_logs]


def tick_counts(ctx):
    """Leg-tick counts of the profiled windows: (swing (leg-ticks,
    scenario-ticks), active, touching, takeoff); the plant's contact and the
    controller's early-contact test as the window's logs show them."""
    sw = sw_t = act = touch = take = 0
    contact = ctx.contact
    for p in ctx.prof_logs:
        ticks = p.log.ticks
        mask = ticks.contact_mask
        swing = mask == 0
        prev = torch.cat([p.last_mask0[:, None, :], mask[:, :-1]], 1)
        foot_z = ticks.foot_pos_now[..., 2]
        pen = contact.ground_z[:, None, None] - (foot_z - contact.foot_radius[:, None, None])
        touching = (GROUND_Z + 1e-3) - (foot_z - FOOT_RADIUS) >= 0.0
        sw += int(swing.sum())
        sw_t += int(swing.any(-1).sum())
        act += int((pen > 0.0).sum())
        touch += int((swing & touching).sum())
        take += int((swing & (prev != 0)).sum())
    return (sw, sw_t), act, touch, take


SPD_KERNELS = ("spd_inverse_kernel", "spd_inverse_cluster_kernel")
ADMM_KERNELS = ("admm_structured_kernel",)
TICK_KERNELS = ("tick_window_kernel",)


def spd_inverse_install(ctx):
    """Count the matrices the solve hands ``spd_inverse`` in the profiled
    cycles (the solver's own count, until the system keeps one)."""
    admm = ctx.prog.admm
    inner = admm.spd_inverse
    calls = ctx.counters.setdefault("spd_inverse", [])

    def counted(A):
        if ctx.trace is None:  # only while the profiled cycles run
            calls.append((A.shape[-1], A.shape[0]))
        return inner(A)

    ctx.patch(admm, "spd_inverse", counted)


def _summed(works):
    return sum(w[0] for w in works), sum(w[1] for w in works)


def spd_inverse_share(ctx):
    calls = ctx.counters.get("spd_inverse", [])
    if not calls:
        return None
    return share(ctx, SPD_KERNELS, _summed([roofline.spd_inverse_work(n, b) for n, b in calls]))


def admm_structured_share(ctx):
    its = cycle_iterations(ctx)
    if not its:
        return None
    return share(ctx, ADMM_KERNELS,
                 _summed([roofline.admm_structured_work(ctx.batch, ctx.nz, i) for i in its]))


def tick_window_share(ctx):
    if not ctx.fused or not ctx.prof_logs:
        return None
    swing, active, touching, takeoff = tick_counts(ctx)
    b, ops = roofline.tick_window_work(ctx.batch, ctx.steps, swing, active, touching, takeoff)
    return share(ctx, TICK_KERNELS, (b * len(ctx.prof_logs), ops))
