"""The 500k-cell engine race: which large-N engine serves the flagship.

At the settled 500k-cell branching state (``.bench_cache``), for each
engine: one pair pass, one Heun step and one 11-substep flagship frame
(``models/branching.make_frame``), each compiled and warmed up first,
then timed with ``block_until_ready``:

* ``sweep``   -- ``SweepEngine``: the cube-sorted sweep kernel
  (``ops/sweep_triton.py``, Pallas through Triton);
* ``lattice`` -- ``LatticeEngine``, plain XLA: ``models.branching.
  xla_engine``, the engine ``default_engine`` picks off the GPU;
* ``grid``    -- ``GridEngine``, plain XLA gather grid, sized for the
  tissue's extent.

Usage: python benchmarks/race_500k.py [engine ...]   (default: all three)
Prints one JSON line per engine, naming the device and the card.  Needs
a GPU; exits non-zero without one.
"""
import json
import os
import statistics
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from yalla_tpu import backend  # noqa: E402
from yalla_tpu.models import branching as B  # noqa: E402
from yalla_tpu.ops.common import friction_w_neighbour, grid_for  # noqa: E402
from yalla_tpu.solvers import GridEngine, SweepEngine, heun_step  # noqa: E402
from yalla_tpu.utils.checks import (N_FLAGSHIP, extent,  # noqa: E402
                                    flagship_state, pair_pass,
                                    settled_flagship)


def engines(X, n):
    p = B.Params()
    gs = grid_for(extent(X, n), p.r_max)
    return {"sweep": SweepEngine(grid_size=gs),
            "lattice": B.xla_engine(N_FLAGSHIP, p),
            "grid": GridEngine(grid_size=gs, row_cap=64)}


def timed(f, *args, reps):
    t0 = time.perf_counter()
    out = jax.block_until_ready(f(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(*args))
        times.append(time.perf_counter() - t0)
    return out, first, times


def race(name, engine, X, old_v, n, card):
    p = B.Params()
    force = B.make_force(p)
    pair = pair_pass(engine, X, old_v, n)
    _, pair_first, pair_t = timed(pair, X, old_v, n, reps=5)

    step = jax.jit(lambda X, old_v, n: heun_step(
        engine, force, friction_w_neighbour, None, "com", X, old_v, n,
        jnp.float32(p.dt), jnp.float32(p.r_max), jnp.int32(0), None,
        B.precompute))
    (_, _, aux), step_first, step_t = timed(step, X, old_v, n, reps=5)
    step_flags = {k: float(v) for k, v in aux.items()
                  if k.startswith("__err_") and float(v)}

    frame = B.make_frame(p, engine, substeps=11)
    state = flagship_state(X, old_v, n)
    (st, errs), frame_first, frame_t = timed(frame, state, jnp.float32(0.0),
                                             reps=3)
    frame_flags = {k: float(v) for k, v in errs.items() if float(v)}
    rec = {"engine": name, "config": repr(engine), "n": int(n),
           "pair_pass_s": statistics.median(pair_t),
           "heun_step_s": statistics.median(step_t),
           "frame_11_substeps_s": statistics.median(frame_t),
           "runs": {"pair_pass_s": pair_t, "heun_step_s": step_t,
                    "frame_11_substeps_s": frame_t},
           "first_call_s": {"pair_pass": pair_first, "heun_step": step_first,
                            "frame": frame_first},
           "flags": {**step_flags, **frame_flags},
           "device": backend.device_info(), "card": card}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv):
    backend.require_gpu()
    from yalla_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    card = backend.card_line()
    X, old_v, n = settled_flagship()
    eng = engines(X, int(n))
    names = argv or list(eng)
    recs = [race(k, eng[k], X, old_v, n, card) for k in names]
    clean = [r for r in recs if not r["flags"]]
    if clean:
        best = min(clean, key=lambda r: r["frame_11_substeps_s"])
        print(f"# fastest flag-clean frame: {best['engine']} "
              f"({best['frame_11_substeps_s']:.6f} s)  [{card}]")
    if len(clean) < len(recs):
        sys.exit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
