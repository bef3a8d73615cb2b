"""Host-side matplotlib dashboards for simulation results.

The port's copy of ``convex_mpc_tpu/utils/plots.py`` (a capability port of
the reference's plot_helper.py:4-307): contact forces with swing shading,
per-leg torques, COM state grids, swing-foot tracking, solver
timing/iteration views, and 3-D trajectory comparison, on the engine's
stacked ``CycleLog`` tensors, which are moved to the host first
(``.detach().cpu().numpy()``). ``matplotlib`` is imported on first use, with
the Agg backend; the card's machine has none, so nothing there plots.
"""

from __future__ import annotations

import numpy as np
import torch

LEG_NAMES = ("FL", "FR", "RL", "RR")


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def flatten_ticks(logs) -> dict:
    """CycleLog (stacked over cycles) -> dict of flat per-tick arrays."""
    t = logs.ticks
    out = {
        "x_vec": _host(t.x_vec).reshape(-1, 12),
        "tau": _host(t.tau).reshape(-1, 12),
        "force": _host(t.force).reshape(-1, 12),
        "foot_pos_des": _host(t.foot_pos_des).reshape(-1, 4, 3),
        "foot_pos_now": _host(t.foot_pos_now).reshape(-1, 4, 3),
        "contact_mask": _host(t.contact_mask).reshape(-1, 4),
        "solver_iters": _host(logs.solver_iters),
        "prim_res": _host(logs.prim_res),
        "dual_res": _host(logs.dual_res),
    }
    out["t"] = np.arange(out["x_vec"].shape[0]) * 1e-3
    return out


def _shade_swing(ax, t, mask):
    """Shade swing intervals (mask == 0), reference plot_helper.py:21-33."""
    in_swing = mask == 0
    if not in_swing.any():
        return
    d = np.diff(in_swing.astype(int))
    starts = list(np.where(d == 1)[0] + 1)
    ends = list(np.where(d == -1)[0] + 1)
    if in_swing[0]:
        starts = [0] + starts
    if in_swing[-1]:
        ends = ends + [len(t) - 1]
    for s, e in zip(starts, ends):
        ax.axvspan(t[s], t[e], color="0.9", zorder=0)


def plot_contact_forces(logs, path=None, block=False):
    """Per-leg MPC contact forces with swing shading (plot_helper.py:4-40)."""
    plt = _plt()
    d = flatten_ticks(logs)
    fig, axes = plt.subplots(4, 1, figsize=(10, 9), sharex=True)
    for leg in range(4):
        ax = axes[leg]
        _shade_swing(ax, d["t"], d["contact_mask"][:, leg])
        for k, lbl in enumerate("xyz"):
            ax.step(d["t"], d["force"][:, 3 * leg + k], where="post", label=f"f{lbl}")
        ax.set_ylabel(f"{LEG_NAMES[leg]} [N]")
        ax.legend(loc="upper right", fontsize=7)
    axes[-1].set_xlabel("time [s]")
    fig.suptitle("MPC contact forces (shaded = swing)")
    return _finish(fig, path, block)


def plot_mpc_result(logs, path=None, block=False):
    """4x3 grid: leg forces, leg torques, COM pos/rpy, COM vel/omega
    (plot_helper.py:82-184)."""
    plt = _plt()
    d = flatten_ticks(logs)
    fig, axes = plt.subplots(4, 3, figsize=(15, 11), sharex=True)
    x = d["x_vec"]
    for leg in range(4):
        axes[0, 0].plot(d["t"], d["force"][:, 3 * leg + 2], label=LEG_NAMES[leg])
    axes[0, 0].set_title("fz per leg [N]")
    for leg in range(4):
        axes[0, 1].plot(d["t"], d["tau"][:, 3 * leg], label=LEG_NAMES[leg])
    axes[0, 1].set_title("hip torque [Nm]")
    for leg in range(4):
        axes[0, 2].plot(d["t"], d["tau"][:, 3 * leg + 2], label=LEG_NAMES[leg])
    axes[0, 2].set_title("calf torque [Nm]")
    titles = [
        ("x [m]", 0), ("y [m]", 1), ("z [m]", 2),
        ("roll [rad]", 3), ("pitch [rad]", 4), ("yaw [rad]", 5),
        ("vx [m/s]", 6), ("vy [m/s]", 7), ("vz [m/s]", 8),
    ]
    for i, (ttl, idx) in enumerate(titles):
        ax = axes[1 + i // 3, i % 3]
        ax.plot(d["t"], x[:, idx])
        ax.set_title(ttl)
    for ax in axes[0]:
        ax.legend(fontsize=7)
    axes[-1, 0].set_xlabel("time [s]")
    fig.suptitle("MPC closed-loop result")
    return _finish(fig, path, block)


def plot_swing_foot_traj(logs, path=None, block=False):
    """Desired vs actual foot trajectories (plot_helper.py:187-214)."""
    plt = _plt()
    d = flatten_ticks(logs)
    fig, axes = plt.subplots(4, 3, figsize=(14, 10), sharex=True)
    for leg in range(4):
        for k, lbl in enumerate("xyz"):
            ax = axes[leg, k]
            _shade_swing(ax, d["t"], d["contact_mask"][:, leg])
            ax.plot(d["t"], d["foot_pos_des"][:, leg, k], "--", label="des")
            ax.plot(d["t"], d["foot_pos_now"][:, leg, k], label="now")
            if leg == 0:
                ax.set_title(lbl)
            if k == 0:
                ax.set_ylabel(LEG_NAMES[leg])
    axes[0, 0].legend(fontsize=7)
    fig.suptitle("swing foot tracking (shaded = swing)")
    return _finish(fig, path, block)


def plot_solver_stats(logs, mpc_dt=1 / 48.0, path=None, block=False):
    """Solver iterations + residuals per MPC cycle vs the real-time budget
    (capability of plot_helper.py:217-253's solve-time view)."""
    plt = _plt()
    d = flatten_ticks(logs)
    cycles = np.arange(len(d["solver_iters"]))
    fig, axes = plt.subplots(2, 1, figsize=(10, 7), sharex=True)
    axes[0].bar(cycles, d["solver_iters"], width=1.0)
    axes[0].set_ylabel("ADMM iterations")
    axes[0].axhline(d["solver_iters"].mean(), color="r", ls="--",
                    label=f"mean {d['solver_iters'].mean():.0f}")
    axes[0].legend()
    axes[1].semilogy(cycles, d["prim_res"], label="primal residual")
    axes[1].semilogy(cycles, d["dual_res"], label="dual residual")
    axes[1].set_xlabel("MPC cycle")
    axes[1].legend()
    fig.suptitle(f"QP solver per cycle (budget {mpc_dt*1e3:.1f} ms/cycle)")
    return _finish(fig, path, block)


def plot_traj_tracking(x_log, x_ref=None, path=None, block=False):
    """3-D COM trajectory, actual vs reference (plot_helper.py:43-78)."""
    plt = _plt()
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    x_log = _host(x_log)
    ax.plot(x_log[:, 0], x_log[:, 1], x_log[:, 2], label="actual")
    if x_ref is not None:
        x_ref = _host(x_ref)
        ax.plot(x_ref[:, 0], x_ref[:, 1], x_ref[:, 2], "--", label="reference")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    ax.legend()
    fig.suptitle("COM trajectory")
    return _finish(fig, path, block)


_STATE_GROUPS = (
    (slice(0, 3), ("pos_x", "pos_y", "pos_z"), "position [m]"),
    (slice(3, 6), ("roll", "pitch", "yaw"), "attitude [rad]"),
    (slice(6, 9), ("vel_x", "vel_y", "vel_z"), "velocity [m/s]"),
    (slice(9, 12), ("roll_rate", "pitch_rate", "yaw_rate"), "omega [rad/s]"),
)


def plot_full_traj(x_opt, x_ref, path=None, block=False):
    """Reference vs MPC-optimized 12-state horizon overlay.

    Port of the reference's `plot_full_traj` (plot_helper.py:255-304): a
    2x2 grid of (position, attitude, velocity, omega), solid = reference
    trajectory, dotted = the QP's optimal state trajectory over one horizon.
    Inputs are (N, 12) arrays (this package's row-major state layout).
    """
    plt = _plt()
    x_opt = _host(x_opt)
    x_ref = _host(x_ref)
    k = np.arange(x_ref.shape[0])
    fig, axes = plt.subplots(2, 2, figsize=(13, 8), constrained_layout=True)
    colors = ("r", "g", "b")
    for ax, (sl, names, ylabel) in zip(axes.T.reshape(-1), _STATE_GROUPS):
        for j, name in enumerate(names):
            ax.plot(k, x_ref[:, sl][:, j], color=colors[j], label=f"{name}_ref")
            ax.plot(k, x_opt[:, sl][:, j], color=colors[j], linestyle=":",
                    linewidth=2.5, label=f"{name}_opt")
        ax.set_ylabel(ylabel)
        ax.set_xlabel("horizon step")
        ax.legend(fontsize=7)
        ax.grid(True)
    fig.suptitle("MPC horizon: reference vs optimized 12-state trajectory")
    return _finish(fig, path, block)


def plot_open_loop_validation(x_opt, x_rollout, x_ref=None, path=None, block=False):
    """Open-loop SRB validation (reference test_MPC.py:256-266).

    Overlays the QP's optimal state trajectory against an independent
    open-loop rollout of the SRB dynamics under the optimal forces
    (srb.rollout). The two must agree to solver accuracy; divergence means
    the QP's internal dynamics model and the rollout disagree. ``x_rollout``
    is (N+1, 12) (includes x0); ``x_opt`` is (N, 12).
    """
    plt = _plt()
    x_opt = _host(x_opt)
    x_roll = _host(x_rollout)[1:]
    err = np.abs(x_opt - x_roll).max()
    k = np.arange(x_opt.shape[0])
    fig, axes = plt.subplots(2, 2, figsize=(13, 8), constrained_layout=True)
    colors = ("r", "g", "b")
    for ax, (sl, names, ylabel) in zip(axes.T.reshape(-1), _STATE_GROUPS):
        for j, name in enumerate(names):
            ax.plot(k, x_roll[:, sl][:, j], color=colors[j], label=f"{name}_rollout")
            ax.plot(k, x_opt[:, sl][:, j], color=colors[j], linestyle=":",
                    linewidth=2.5, label=f"{name}_opt")
            if x_ref is not None:
                ax.plot(k, _host(x_ref)[:, sl][:, j], color=colors[j],
                        linestyle="--", linewidth=0.8, alpha=0.5)
        ax.set_ylabel(ylabel)
        ax.set_xlabel("horizon step")
        ax.legend(fontsize=7)
        ax.grid(True)
    fig.suptitle(
        f"Open-loop SRB validation: X_opt vs rollout(U_opt), max |err| = {err:.2e}"
    )
    return _finish(fig, path, block)


def plot_cycle_time(update_ms, solve_ms, apply_ms=None, budget_ms=20.0,
                    batch=1, path=None, block=False):
    """Per-cycle update-vs-solve stacked bars against the real-time budget
    (reference plot_helper.py:217-253 `plot_solve_time`).

    ``update_ms``/``solve_ms``/``apply_ms`` are per-MPC-cycle wall times of
    the QP-assembly ("update"), QP-solve, and 1 kHz tick stages for the
    WHOLE batch; the budget line defaults to the engine's actual replan
    period steps_per_mpc * sim_dt = 20 ms (pass mpc_dt * 1e3 = 20.833
    explicitly if the horizon step is the intended budget) — a batch cycle
    under the line serves all ``batch`` scenarios in real time on one chip.
    """
    plt = _plt()
    update_ms = _host(update_ms)
    solve_ms = _host(solve_ms)
    cycles = np.arange(len(update_ms))
    fig, ax = plt.subplots(figsize=(11, 4.5))
    ax.bar(cycles, update_ms, width=1.0, label="update (ref gen + QP build)")
    ax.bar(cycles, solve_ms, width=1.0, bottom=update_ms, label="QP solve")
    total = update_ms + solve_ms
    if apply_ms is not None:
        apply_ms = _host(apply_ms)
        ax.bar(cycles, apply_ms, width=1.0, bottom=total,
               label="1 kHz ticks")
        total = total + apply_ms
    ax.axhline(budget_ms, color="r", ls="--",
               label=f"real-time budget {budget_ms:.1f} ms")
    ax.set_xlabel("MPC cycle")
    ax.set_ylabel(f"wall ms / cycle (batch {batch})")
    ax.set_title(
        f"cycle time: mean {total.mean():.1f} ms, p99 "
        f"{np.percentile(total, 99):.1f} ms "
        f"({batch} scenarios/cycle -> "
        f"{batch / (total.mean() * 1e-3):,.0f} solves/s)"
    )
    ax.legend(fontsize=8)
    return _finish(fig, path, block)


def hold_until_all_fig_closed():
    """Block until every figure window is closed (plot_helper.py:306-307)."""
    import matplotlib.pyplot as plt

    plt.show(block=True)


def _finish(fig, path, block):
    if path is not None:
        fig.savefig(path, dpi=110, bbox_inches="tight")
        import matplotlib.pyplot as plt

        plt.close(fig)
        return path
    if block:
        hold_until_all_fig_closed()
    return fig
