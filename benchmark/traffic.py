"""The one traffic generator: a traffic file's parameters -> a cell's scenarios.

A traffic file (``traffic/<name>.json``) gives the batch ``batch`` and, for
each scenario parameter (``vx``, ``vy``, ``wz`` in m/s and rad/s, the start's
``x_offset`` in m, the contact's ``kn``, ``dn``, ``mu``), one of:

- a number: every scenario has it;
- ``{"uniform": [lo, hi]}``: ``batch`` values drawn once from the file's
  ``set_seed``;
- ``{"linspace": [lo, hi]}``: ``batch`` evenly spaced values.

``gait`` names each scenario's gait among the configuration's: absent, the
configuration's only gait; a name, every scenario's; ``{"shares": {name:
share}}``, round(share x ``batch``) scenarios of each named gait.

Every ``--seed`` gets the same set of values, each parameter's in its own
order drawn from the seed, so that every seed gives the batch-global solver
the same work. The scenarios are closed-loop clients: each waits for its
cycle's forces before the next.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

# drawn in this order: a parameter added later goes last, so that the
# traffic files before it give the same values
PARAMS = ("vx", "vy", "wz", "x_offset", "kn", "dn", "mu", "gait")


def _values(spec, batch: int, set_rng: np.random.Generator) -> np.ndarray:
    if isinstance(spec, (int, float)):
        return np.full(batch, float(spec))
    (kind, (lo, hi)), = spec.items()
    if kind == "uniform":
        return set_rng.uniform(lo, hi, size=batch)
    if kind == "linspace":
        return np.linspace(lo, hi, batch)
    raise ValueError(f"unknown traffic spec {spec!r}")


def _gaits(spec, batch: int, gaits: Sequence[str]) -> np.ndarray:
    """Each scenario's gait name, from the traffic's ``gait`` (None where it
    states none) among the configuration's ``gaits``, grouped by gait (the
    seed's order shuffles them)."""
    if spec is None:
        if len(gaits) != 1:
            raise ValueError(f"the traffic names no gait and the configuration has {len(gaits)}")
        spec = gaits[0]
    if isinstance(spec, str):
        shares = {spec: 1.0}
    else:
        (kind, shares), = spec.items()
        if kind != "shares":
            raise ValueError(f"unknown gait spec {spec!r}")
    unknown = sorted(set(shares) - set(gaits))
    if unknown:
        raise ValueError(f"the traffic names gaits {unknown} that the configuration lacks")
    counts = [round(float(s) * batch) for s in shares.values()]
    if sum(counts) != batch:
        raise ValueError(f"the gait shares {shares} give {sum(counts)} of {batch} scenarios")
    return np.repeat(np.array(list(shares)), counts)


def scenarios(traffic: dict, seed: int, gaits: Sequence[str]) -> dict:
    """{parameter: (batch,) values} for ``seed`` (any whole number): float64
    numbers, and under ``gait`` each scenario's gait name among ``gaits``,
    the configuration's."""
    batch = int(traffic["batch"])
    set_rng = np.random.default_rng(int(traffic["set_seed"]))
    order = np.random.default_rng(np.random.SeedSequence([int(seed) & (2**64 - 1), 1]))
    out = {}
    for name in PARAMS:
        vals = (_gaits(traffic.get("gait"), batch, gaits) if name == "gait"
                else _values(traffic[name], batch, set_rng))
        out[name] = vals[order.permutation(batch)]
    return out


def check_plan(traffic: dict, seed: int) -> tuple[list[int], list[int]]:
    """(rows, cycles) whose answers a run judges: ``check_rows`` scenarios and
    ``check_cycles`` cycles of the window among its first ``check_span``,
    drawn from the seed. A drawn cycle that the window does not reach is not
    due."""
    batch = int(traffic["batch"])
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) & (2**64 - 1), 2]))
    rows = sorted(rng.choice(batch, size=min(int(traffic["check_rows"]), batch),
                             replace=False).tolist())
    cycles = sorted(rng.choice(int(traffic["check_span"]), size=int(traffic["check_cycles"]),
                               replace=False).tolist())
    return rows, cycles
