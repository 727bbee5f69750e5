"""Smoke test of the system's main path on one NVIDIA GPU.

Usage:  python chip_smoke.py           # one card, phases 1-5
        python chip_smoke.py --four    # z-slab path over four cards only

Phases (one process, in order; any failure ends the run non-zero and
without the final JSON line):

1. device     -- JAX's default backend must be a GPU; prints the card's
                 name and power limit as ``nvidia-smi`` reports them.
2. kernel     -- the sweep pair pass (``ops/sweep_triton.py``) compiled for
                 the card at the settled 500k-cell flagship state, against
                 the plain XLA ``GridEngine`` at the same widths and against
                 the all-pairs ``TileEngine`` on a 20k-cell sub-ball.
3. flagship   -- 3 frames x 11 substeps of ``models/branching.make_frame``
                 from the settled 500k state, with ``default_engine``'s pick.
4. entry      -- ``examples/branching.py 500000 3`` (VTK into ``output/``).
5. sorting 5k -- ``bench.py``'s 5k all-pairs builder for a few steps.

``--four`` runs only the z-slab lattice path
(``parallel/lattice_spmd.py``) over four cards on the settled 500k state
and compares it with the same steps on one of those cards.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import gc
import json
import os
import runpy
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SUB_BALL = 20_000
# z-slab over 4 cards vs 1 card: same binning and pair order, only the
# momentum-fix reduction is split, so the states agree to f32 roundoff
FOUR_TOL = 1e-5


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def phase_device(four=False):
    import jax

    from yalla_tpu import backend
    backend.require_gpu()
    info = backend.device_info()
    need = 4 if four else 1
    if info["count"] < need:
        raise RuntimeError(f"need {need} GPUs, JAX sees {info['count']}")
    log("device", f"{info}")
    log("device", f"card: {backend.card_line()}")
    log("device", f"jax {jax.__version__}")
    return info


def phase_kernel(X, old_v, n):
    import jax

    from yalla_tpu import backend
    from yalla_tpu.ops.common import grid_for
    from yalla_tpu.solvers import GridEngine, SweepEngine, TileEngine
    from yalla_tpu.utils.checks import (PAIR_TOL, compare_pairwise, extent,
                                        pair_pass, sub_ball)
    n_i = int(n)
    gs = grid_for(extent(X, n_i), 1.0)
    sweep = SweepEngine(grid_size=gs)
    f = pair_pass(sweep, X, old_v, n)
    t0 = time.perf_counter()
    compiled = f.lower(X, old_v, n).compile()
    log("kernel", f"sweep pair pass compiled for {backend.platform()} at "
        f"n={n_i} (n_pad={X.x.shape[0]}, grid {gs}^3) in "
        f"{time.perf_counter() - t0:.1f} s")
    log("kernel", f"memory_analysis: {compiled.memory_analysis()}")
    out = jax.block_until_ready(compiled(X, old_v, n))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(X, old_v, n))
    log("kernel", f"sweep pair pass: {time.perf_counter() - t0:.6f} s "
        f"(one pass, compiled, warm)")
    # the plain reference: XLA's gather grid (itself tested against the
    # all-pairs engine on the CPU).  The pair math is elementwise -- no
    # matrix product on this path -- but the reference runs at the
    # highest matmul precision all the same.
    row_cap = 64
    with jax.default_matmul_precision("highest"):
        ref = jax.block_until_ready(
            pair_pass(GridEngine(grid_size=gs, row_cap=row_cap), X, old_v,
                      n)(X, old_v, n))
    worst = compare_pairwise(out, ref, n_i)
    log("kernel", f"sweep vs GridEngine(row_cap={row_cap}) at n={n_i}: "
        f"max|dF|/max|F| = {worst:.3g} <= {PAIR_TOL}, counters and flags "
        f"exact (reference at matmul precision 'highest')")
    del out, ref
    Xs, ovs, ns = sub_ball(X, old_v, n, SUB_BALL)
    gs_s = grid_for(extent(Xs, SUB_BALL), 1.0)
    out = jax.block_until_ready(
        pair_pass(SweepEngine(grid_size=gs_s), Xs, ovs, ns)(Xs, ovs, ns))
    with jax.default_matmul_precision("highest"):
        ref = jax.block_until_ready(
            pair_pass(TileEngine(), Xs, ovs, ns)(Xs, ovs, ns))
    worst = compare_pairwise(out, ref, SUB_BALL)
    log("kernel", f"sweep vs TileEngine (all pairs) on a {SUB_BALL}-cell "
        f"sub-ball: max|dF|/max|F| = {worst:.3g} <= {PAIR_TOL}, counters "
        f"and flags exact")
    stats = jax.devices()[0].memory_stats() or {}
    log("kernel", f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def phase_flagship(X, old_v, n, card):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from yalla_tpu.models import branching as B
    from yalla_tpu.utils.checks import N_FLAGSHIP, flagship_state
    p = B.Params()
    engine = B.default_engine(N_FLAGSHIP, N_FLAGSHIP, p)
    frame = B.make_frame(p, engine, substeps=11)
    state = flagship_state(X, old_v, n)
    n0 = int(state.n)
    log("flagship", f"engine {engine}, n={n0}")
    for t in range(3):
        t0 = time.perf_counter()
        state, errs = frame(state, jnp.float32(t / 3))
        jax.block_until_ready(state)
        dt = time.perf_counter() - t0
        fired = {k: float(v) for k, v in errs.items() if float(v) != 0.0}
        assert not fired, f"frame {t}: flags {fired}"
        n_now = int(state.n)
        assert n_now >= n0, f"frame {t}: n {n0} -> {n_now}"
        finite = all(bool(np.all(np.isfinite(np.asarray(a)[:n_now])))
                     for a in state.X)
        assert finite, f"frame {t}: non-finite state"
        what = "compile + run" if t == 0 else "run"
        log("flagship", f"frame {t}: {dt:.6f} s ({what}, 11 substeps), "
            f"n={n_now}, flags clean  [{card}]")


def phase_entry():
    import glob

    from yalla_tpu.utils.checks import N_FLAGSHIP
    out = os.path.join(HERE, "output")
    frame_glob = os.path.join(out, "branching_*.vtk")
    tree_glob = os.path.join(out, "branching.tree_*.vtk")
    # only files this run writes count
    for f in glob.glob(frame_glob) + glob.glob(tree_glob):
        os.remove(f)
    argv = sys.argv
    cwd = os.getcwd()
    os.chdir(HERE)
    try:
        sys.argv = ["examples/branching.py", str(N_FLAGSHIP), "3"]
        t0 = time.perf_counter()
        runpy.run_path(os.path.join(HERE, "examples", "branching.py"),
                       run_name="__main__")
        dt = time.perf_counter() - t0
    finally:
        sys.argv = argv
        os.chdir(cwd)
    frames, tree = glob.glob(frame_glob), glob.glob(tree_glob)
    assert len(frames) >= 4 and tree, (frames, tree)
    log("entry", f"examples/branching.py {N_FLAGSHIP} 3: {len(frames)} "
        f"frames + lineage tree written in {dt:.1f} s")


def phase_sorting(card):
    import jax
    import numpy as np

    import bench
    run = bench.build_sorting_tile(5000)
    steps = 40
    X, old_v, aux = jax.block_until_ready(run(steps))
    t0 = time.perf_counter()
    X, old_v, aux = jax.block_until_ready(run(steps))
    dt = time.perf_counter() - t0
    fired = {k: float(np.max(np.asarray(v))) for k, v in aux.items()
             if k.startswith("__err_") and np.any(np.asarray(v))}
    assert not fired, f"flags {fired}"
    assert all(bool(np.all(np.isfinite(np.asarray(a)[:5000]))) for a in X)
    log("sorting", f"5k TileEngine: {steps} Heun steps in {dt:.6f} s "
        f"({dt / steps * 1e3:.4f} ms/step)  [{card}]")


def phase_four(X, old_v, n, card):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from yalla_tpu.models import branching as B
    from yalla_tpu.ops.common import friction_w_neighbour, grid_for
    from yalla_tpu.parallel.lattice_spmd import (lattice_sharded_heun_steps,
                                                 make_z_mesh)
    from yalla_tpu.utils.checks import extent
    p = B.Params()
    force = B.make_force(p)
    n_i = int(n)
    zb = 2
    gs = grid_for(extent(X, n_i), p.r_max)
    gs = -(-gs // (4 * zb)) * (4 * zb)          # 4 slabs of z_block planes
    q = [np.floor(np.asarray(a)[:n_i] / p.r_max).astype(np.int64)
         for a in (X.x, X.y, X.z)]
    # capacity: the settled max cube occupancy plus room for the cells
    # that move between cubes during the steps
    C = int(np.unique((q[0] * 4096 + q[1]) * 4096 + q[2],
                      return_counts=True)[1].max()) + 4
    steps = 2

    def runner(devices):
        mesh = make_z_mesh(devices)
        return jax.jit(lambda X, old_v, n: lattice_sharded_heun_steps(
            mesh, steps, 1, force, friction_w_neighbour, "com", gs, C, zb,
            X, old_v, n, jnp.float32(p.dt), jnp.float32(p.r_max),
            jnp.int32(0), B.precompute))

    devs = jax.devices()[:4]
    res = {}
    for name, d in (("4 cards", devs), ("1 card", devs[:1])):
        f = runner(d)
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(X, old_v, n))
        t1 = time.perf_counter()
        out = jax.block_until_ready(f(X, old_v, n))
        t2 = time.perf_counter()
        fired = {k: float(np.max(np.asarray(v))) for k, v in out[2].items()
                 if k.startswith("__err_") and np.any(np.asarray(v))}
        assert not fired, f"{name}: flags {fired}"
        res[name] = out
        log("four", f"z-slab lattice, {name}: {steps} Heun steps at n={n_i} "
            f"(grid {gs}^3, C={C}): first call {t1 - t0:.1f} s, then "
            f"{t2 - t1:.6f} s  [{card}]")
    (X4, ov4, _), (X1, ov1, _) = res["4 cards"], res["1 card"]
    worst = 0.0
    for name, a, b in ([(f"X.{k}", getattr(X4, k), getattr(X1, k))
                        for k in X4._fields]
                       + [(f"old_v.{k}", getattr(ov4, k), getattr(ov1, k))
                          for k in ov4._fields]):
        a, b = np.asarray(a)[:n_i], np.asarray(b)[:n_i]
        rel = float(np.max(np.abs(a - b))) / max(1.0,
                                                 float(np.max(np.abs(b))))
        assert rel <= FOUR_TOL, f"{name}: 4 vs 1 card rel diff {rel:.3g}"
        worst = max(worst, rel)
    log("four", f"4 cards vs 1 card: max|d|/max(1, max|ref|) = {worst:.3g} "
        f"<= {FOUR_TOL}, flags clean")


def main(argv):
    four = "--four" in argv
    from yalla_tpu.utils import enable_compilation_cache

    info = phase_device(four)
    enable_compilation_cache()
    from yalla_tpu import backend
    from yalla_tpu.utils.checks import settled_flagship
    card = backend.card_line()
    X, old_v, n = settled_flagship()
    if four:
        phase_four(X, old_v, n, card)
    else:
        phase_kernel(X, old_v, n)
        phase_flagship(X, old_v, n, card)
        del X, old_v
        gc.collect()
        phase_entry()
        phase_sorting(card)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": info}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
