"""Cold restarts under ``solve_adaptive(snap_first=True)``: JAX and the port side by side (CPU).

On ``tests/test_torch_qp.py``'s B = 16 batch (16 gait phases of a
perturbed standing start, trot 3 Hz duty 0.6, vx = 0.4, wz = 0.3), warm
from a cold solve, each of ``--rows`` is restarted cold alone and solved
by both packages (``max_iter=1000``, ``box_tail=nz``); prints that row's
iterations in each and the largest relative difference of the first-step
forces. Options:

- ``--perturb N``: N more draws per row with q scaled by 1 + 1e-6 N(0, 1)
  (seeds 100, 101, ...), and the count of runs that reach the cap;
  ``--first-draw K`` starts the draws at seed 100 + K and skips the
  unperturbed run;
- ``--f64``: both packages in float64 (JAX's Pallas inverse is f32-only, so
  both take their plain inverse and chunk);
- ``--drop-fill``: JAX from a temporary copy whose compacted ladder has no
  fill rows (``fill_value=B``, scatters with ``mode="drop"``);
- ``--trace ROW``: per 25-iteration chunk, that row's rho and residuals in
  each package (their ``debug=True`` lines).

    python tools/torch_snap_parity.py --rows 0 3 7 12 --perturb 10
"""

from __future__ import annotations

import argparse
import contextlib
import io
import re
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _jax_from_copy() -> None:
    """Import ``convex_mpc_tpu`` from a temporary copy without fill rows."""
    tmp = Path(tempfile.mkdtemp())
    shutil.copytree(ROOT / "convex_mpc_tpu", tmp / "convex_mpc_tpu")
    src = tmp / "convex_mpc_tpu" / "mpc" / "admm.py"
    s = src.read_text()
    for old, new in [("fill_value=0)[0]", "fill_value=B)[0]"),
                     ("x_base[idx])\n                    )", "x_base[idx]), mode=\"drop\"\n                    )"),
                     ("ok_sn[idx] | take)", "ok_sn[idx] | take, mode=\"drop\")")]:
        if s.count(old) != 1:
            sys.exit(f"--drop-fill: JAX admm.py no longer has {old!r}")
        s = s.replace(old, new)
    src.write_text(s)
    sys.path.insert(0, str(tmp))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[0])
    ap.add_argument("--perturb", type=int, default=0)
    ap.add_argument("--first-draw", type=int, default=0)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--drop-fill", action="store_true")
    ap.add_argument("--trace", type=int, default=None)
    a = ap.parse_args()
    if a.drop_fill:
        _jax_from_copy()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    if a.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    import convex_mpc_tpu.ops.chol_kernel as JCK
    from convex_mpc_tpu.control import gait as JG
    from convex_mpc_tpu.models import dynamics as JD
    from convex_mpc_tpu.mpc import admm as JA
    from convex_mpc_tpu.sim import engine as JE
    from convex_mpc_tpu.sim import physics as JP
    from convex_mpc_tpu_torch.mpc import admm as TA
    from convex_mpc_tpu_torch.ops.chol_kernel import spd_inverse_plain
    from convex_mpc_tpu_torch.utils.interop import tree_map
    from torch_parity import to_port

    print(f"JAX package: {Path(JA.__file__).parent.parent}")
    dtype = np.float64 if a.f64 else np.float32
    if a.f64:
        JCK.spd_inverse = jnp.linalg.inv
        TA.spd_inverse = spd_inverse_plain
        TA.kernels.admm_iterations_structured = TA.kernels.admm_iterations_structured_plain

    dyn = JD.build_dyn()
    contact = JP.default_contact(kn=30000, dn=1000)
    B = 16
    rng = np.random.default_rng(21)
    sb = JE.broadcast_batch(
        JE.init_state(dyn, n=16)._replace(plant=JP.init_plant(dyn, contact=contact)), B)
    sb = sb._replace(
        plant=sb.plant._replace(q=sb.plant.q.at[:, 0].add(jnp.linspace(-0.02, 0.02, B)),
                                dq=jnp.asarray(rng.normal(0, 0.05, (B, 18)), jnp.float32)),
        t=jnp.asarray(np.linspace(0.0, 1.0 / 3.0, B, endpoint=False), jnp.float32))
    gb = JE.broadcast_batch(JG.make_gait_params(3.0, 0.6), B)
    scb = JE.broadcast_batch(JE.constant_schedule(vx=0.4, wz=0.3), B)
    qd = jnp.asarray((1, 1, 50, 10, 20, 1, 2, 2, 1, 1, 1, 1), jnp.float32)
    data = jax.vmap(lambda g, s, st: JE.cycle_update(
        dyn, g, s, st, qd, 16, (1.0 / 3.0) / 16, 1e-5, 0.8, 10.0)[0])(gb, scb, sb)
    qp16 = jax.tree.map(np.asarray, data)

    def port(tree):
        t = to_port(tree)
        return tree_map(lambda v: v.double() if a.f64 and v.is_floating_point() else v, t)

    def solve(qp, row, debug=False):
        qp = jax.tree.map(lambda v: v.astype(dtype) if v.dtype.kind == "f" else v, qp)
        nz, m = qp.q.shape[-1], qp.l.shape[-1]
        cold = JA.AdmmState(x=jnp.zeros((B, nz), dtype), z=jnp.zeros((B, m), dtype),
                            y=jnp.zeros((B, m), dtype), rho=jnp.full((B,), 0.1, dtype))
        kw = dict(max_iter=1000, box_tail=nz)
        warm = JA.solve_adaptive(qp, cold, **kw).state
        warm = jax.tree.map(np.asarray, warm._replace(rho=jnp.clip(warm.rho, 1e-5, 0.1)))
        sel = (np.arange(B) == row)
        warm = JA.AdmmState(*[np.where(sel.reshape((-1,) + (1,) * (w.ndim - 1)), c, w)
                              for w, c in zip(warm, jax.tree.map(np.asarray, cold))])
        out = {}
        with contextlib.redirect_stdout(buf := io.StringIO()):
            js = JA.solve_adaptive(qp, warm, snap_first=True, debug=debug, **kw)
            jax.block_until_ready(js.x)
        out["jax_log"] = buf.getvalue()
        with contextlib.redirect_stdout(buf := io.StringIO()):
            ts = TA.solve_adaptive(port(qp), port(warm), snap_first=True, debug=debug, **kw)
        out["port_log"] = buf.getvalue()
        f_ref = np.asarray(js.x[:, :12])
        out["force_rel"] = float(np.abs(ts.x[:, :12].numpy() - f_ref).max() / np.abs(f_ref).max())
        out["iters"] = (int(np.asarray(js.iters)[row]), int(ts.iters.numpy()[row]))
        return out

    if a.trace is not None:
        np.set_printoptions(threshold=100000, linewidth=100000)
        r = a.trace
        o = solve(qp16, r, debug=True)
        pat = re.compile(r"chunk (\d+) rho=\[([^\]]*)\] pr=\[([^\]]*)\] dr=\[([^\]]*)\] "
                         r"step=\[([^\]]*)\]", re.S)
        logs = [[[float(g.split()[r]) for g in m.groups()[1:]] for m in pat.finditer(o[k])]
                for k in ("jax_log", "port_log")]
        print(f"row {r}: iterations JAX {o['iters'][0]}, port {o['iters'][1]}")
        for k in range(max(map(len, logs))):
            cells = [("rho %.3e pr %.3e dr %.3e step %.3e" % tuple(lg[k])) if k < len(lg) else "-"
                     for lg in logs]
            print(f"chunk {k:2d}: JAX {cells[0]} | port {cells[1]}")
        return

    caps = [0, 0]
    runs = 0
    for r in a.rows:
        for k in range(-1 if a.first_draw == 0 else a.first_draw, a.first_draw + a.perturb):
            qp = qp16
            if k >= 0:
                g = np.random.default_rng(100 + k)
                qp = qp16._replace(q=(qp16.q * (1 + 1e-6 * g.standard_normal(qp16.q.shape)))
                                   .astype(np.float32))
            o = solve(qp, r)
            runs += 1
            caps = [c + (i >= 1000) for c, i in zip(caps, o["iters"])]
            what = "as built" if k < 0 else f"q x (1 + 1e-6 N(0, 1)) draw {k}"
            print(f"row {r} cold, {what}: iterations JAX {o['iters'][0]}, port {o['iters'][1]}; "
                  f"forces within {o['force_rel']:.2e} relative", flush=True)
    print(f"runs {runs}: at the 1000 cap JAX {caps[0]}, port {caps[1]}")


if __name__ == "__main__":
    main()
