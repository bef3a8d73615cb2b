"""Bitwise equality, on the card, of the structured kernel and its plain version inside the solver.

The port's counterpart of ``tools/check_bitexact_tpu.py``: the on-card
witness that ``admm_structured.cu`` (kernel 2) and its plain PyTorch version
``admm_iterations_structured_plain`` (the JAX XLA twin transcribed) give
bit-identical iterates, so what is certified on one route holds for the
other. Checks:

  1. chunk level: the kernel against the plain version over 1 / 25 / 150
     iterations on ``tests/test_kernels._structured_problem``'s inputs (B = 8,
     nb = 64, seed 11), rebuilt without JAX (``chip_smoke.structured_problem``);
  2. solver level: ``admm.solve_adaptive`` (cap 600) on real mid-trot
     condensed QPs (B = 8 scenarios, lateral velocities across +-0.05 m/s,
     8 production cycles), warm-started from the engine's solver state and
     cold, once with the kernel and once with the plain version swapped in
     (``torch_cycle_ablation.plain_structured_chunk``): ``iters`` and the
     state's ``x``, ``z``, ``y``, ``rho``.

Prints per-field bit differences and exits non-zero on any mismatch. Needs
the card (the comparison is of the kernel; no ``--cpu``):

    python3 tools/torch_check_bitexact.py
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def real_qp_batch(dev, B: int = 8, cycles: int = 8):
    """Real condensed QPs: B perturbed mid-trot scenarios and their warm state."""
    from convex_mpc_tpu_torch.control import gait as G
    from convex_mpc_tpu_torch.models import dynamics as D
    from convex_mpc_tpu_torch.sim import engine as E
    from convex_mpc_tpu_torch.sim import physics as P

    dyn = D.build_dyn(device=dev)
    gait_b = E.broadcast_batch(G.make_gait_params(3.0, 0.6, device=dev), B)
    contact_b = E.broadcast_batch(P.default_contact(device=dev), B)
    sched_b = E.broadcast_batch(E.constant_schedule(vx=0.5, device=dev), B)
    state_b = E.broadcast_batch(E.init_state(dyn, n=16)._replace(plant=P.init_plant(dyn)), B)
    dq = state_b.plant.dq.clone()
    dq[:, 1] += torch.linspace(-0.05, 0.05, B, device=dev)  # lateral velocity per scenario
    state_b = state_b._replace(plant=state_b.plant._replace(dq=dq))
    for _ in range(cycles):
        state_b, _ = E.mpc_cycle_batch(dyn, gait_b, contact_b, sched_b, state_b)
    return dyn, gait_b, sched_b, state_b


def bitdiff(name: str, a: torch.Tensor, b: torch.Tensor) -> bool:
    ai, bi = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    nbad = int((ai != bi).sum())
    if nbad:
        d = float((a.double() - b.double()).abs().max())
        print(f"  FAIL {name}: nbad={nbad}/{a.numel()} max|d|={d:.3e}")
    else:
        print(f"  ok   {name}: bitwise equal ({a.numel()} elements)")
    return nbad == 0


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    from chip_smoke import print_launches, structured_problem, tool_device
    from convex_mpc_tpu_torch.control import reference as R
    from convex_mpc_tpu_torch.mpc import admm, condensed, kernels
    from convex_mpc_tpu_torch.sim import engine as E
    from torch_cycle_ablation import plain_structured_chunk

    dev = tool_device("torch_check_bitexact", cpu=False)
    ok = True
    print("[1/2] chunk-level: admm_iterations_structured (kernel) vs its plain version")
    args = structured_problem(8, 64, seed=11, dev=dev)
    for iters in (1, 25, 150):
        ax = kernels.admm_iterations_structured_plain(*args, iters=iters)
        ap = kernels.admm_iterations_structured(*args, iters=iters)
        for name, a, b in zip("xzy", ax, ap):
            ok &= bitdiff(f"iters={iters} {name}", a, b)

    print("[2/2] solver-level: solve_adaptive on real engine QPs (warm batch)")
    dyn, gait_b, sched_b, state_b = real_qp_batch(dev)
    n = 16
    cmd = E.lookup_command(sched_b, state_b.t)
    obs, _, _ = E.observe(dyn, state_b.plant, state_b.yaw_cont, state_b.yaw_prev,
                          state_b.vel_filt)
    traj, _ = R.generate(state_b.refgen, gait_b, obs, cmd, state_b.t, (1 / 3.0) / n, n)
    p0 = traj.x0[:, 0:3]
    qd = torch.as_tensor([1, 1, 50, 10, 20, 1, 2, 2, 1, 1, 1, 1], dtype=torch.float32,
                         device=dev)
    x0 = torch.cat([torch.zeros_like(p0), traj.x0[:, 3:]], dim=-1)
    x_ref = torch.cat([traj.x_ref[:, :, 0:3] - p0[:, None, :], traj.x_ref[:, :, 3:]], dim=-1)
    data_b, _ = condensed.build_condensed_structured(traj.dyn, x0, x_ref, traj.contact, qd,
                                                     1e-5, 0.8, 10.0)
    for label, st in (("warm", state_b.solver), ("cold", admm.init_state(data_b))):
        with plain_structured_chunk():
            sol_x = admm.solve_adaptive(data_b, st, max_iter=600, box_tail=n * 12)
        sol_p = admm.solve_adaptive(data_b, st, max_iter=600, box_tail=n * 12)
        ok &= bitdiff(f"{label} iters", sol_x.iters, sol_p.iters)
        for name in ("x", "z", "y", "rho"):
            ok &= bitdiff(f"{label} state.{name}", getattr(sol_x.state, name),
                          getattr(sol_p.state, name))

    print("RESULT:", "BITWISE EQUAL" if ok else "MISMATCH")
    print_launches()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
