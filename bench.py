"""Benchmark: cell-steps/sec of the two measured cells, on one NVIDIA GPU.

Cells:

* **branching 500k** -- Heun steps of the flagship branching-class
  physics (type-dependent ReLU mechanics + Turing reaction/diffusion +
  epithelial bending + neighbour counters) at 500,000 cells, on the
  engine ``models.branching.default_engine`` picks for that size (asked
  of ``yalla_tpu.backend``; on the GPU the sweep kernel), rebuilt per
  pass.
* **sorting 5k** -- differential-adhesion mechanics
  (ref examples/sorting.cu:16-28) at 5,000 cells: the all-pairs
  ``TileEngine`` against the dense lattice's ladder.

Both tissues are *relaxed to mechanical equilibrium* before timing (every
reference model benches in this regime -- branching starts from
``relaxed_sphere``, branching.cu:178); the settled states are cached in
``.bench_cache/*.npz`` (committed; ``BENCH_REFRESH=1`` re-settles).  The
in-loop failure flags certify every timed run: a flagged rung is not in
the race.

Lattice ladder (the 5k lattice contender): capacity ``C`` comes from the
measured max cube occupancy (+ headroom); ``REBUILD_EVERY = 4`` refreshes
the binning every 4 steps with the state lattice-resident in between,
certified by the staleness flag, raced against reference-exact per-pass
rebuilds.

A run needs a GPU: without one it exits non-zero before measuring.  Any
cell that fails fails the run.  ``BENCH_BUDGET_S`` (env, default 2100 s)
bounds the ladder's wall clock.

Usage: python bench.py [n_cells] [n_steps]
Prints JSON lines: {"metric", "value", "unit", "device", "card", "extra"}
-- ``device`` as JAX reports it, ``card`` as ``nvidia-smi`` reports the
card's name and power limit; the LAST line is the final (superset) result.
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from yalla_tpu.utils.checks import load_settled, save_settled

REBUILD_EVERY = 4
RELAX_STEPS = 48

_REPO = os.path.dirname(os.path.abspath(__file__))
BENCH_STATE_PATH = os.path.join(_REPO, "bench_state.json")
_REFRESH = os.environ.get("BENCH_REFRESH", "") not in ("", "0")

_DEADLINE = None  # monotonic deadline set by main(); None = no budget
# extra seconds measure()'s probes must leave on the clock -- main() sets
# this during the headline 500k phase so the exploration ladder cannot
# starve the 5k races of their budget
_RESERVE_S = 0.0


def _expired(reserve=None):
    """True when the wall-clock budget is exhausted (minus ``reserve``
    seconds the caller wants to keep for later phases; defaults to the
    module phase reserve)."""
    if reserve is None:
        reserve = _RESERVE_S
    return _DEADLINE is not None and time.monotonic() > _DEADLINE - reserve


def _time_left():
    return float("inf") if _DEADLINE is None \
        else _DEADLINE - time.monotonic()


def _load_bench_state():
    try:
        with open(BENCH_STATE_PATH) as f:
            return json.load(f)
    except Exception:
        return {}


def _save_bench_state(state):
    tmp = BENCH_STATE_PATH + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, BENCH_STATE_PATH)


def _ic(n_cells, n_pad, seed=0):
    from yalla_tpu.models import branching as B

    rng = np.random.default_rng(seed)
    # Jittered lattice at relaxed-tissue spacing 0.75 carved to a BALL,
    # epithelial shell on the boundary: the flagship's grown-tissue
    # composition and shape (branching.cu grows a spheroid from
    # relaxed_sphere; a ball also exercises the kernel's empty-block
    # skip the way real tissues do -- a cube IC would fill the whole
    # bounding lattice)
    side = int(np.ceil((n_cells * 6 / np.pi) ** (1 / 3))) + 2
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    pos = (g - side / 2) * 0.75 + rng.uniform(-0.2, 0.2, (len(g), 3))
    rr0 = np.linalg.norm(pos, axis=1)
    pos = pos[np.argsort(rr0)][:n_pad]
    pos[n_cells:] = 0.0
    rr = np.linalg.norm(pos, axis=1)
    surface = rr > (rr[:n_cells].max() - 1.0)
    surface[n_cells:] = False
    rr = np.maximum(rr, 1e-6)
    return B.Cell(
        x=jnp.asarray(pos[:, 0], jnp.float32),
        y=jnp.asarray(pos[:, 1], jnp.float32),
        z=jnp.asarray(pos[:, 2], jnp.float32),
        theta=jnp.asarray(np.where(surface, np.arccos(
            np.clip(pos[:, 2] / rr, -1, 1)), 0), jnp.float32),
        phi=jnp.asarray(np.where(surface, np.arctan2(pos[:, 1], pos[:, 0]),
                                 0), jnp.float32),
        u=jnp.asarray(rng.random(n_pad) * 0.1, jnp.float32),
        v=jnp.asarray(rng.random(n_pad) * 0.1, jnp.float32),
        ctype=jnp.asarray(surface.astype(np.float32)),
    )


def _max_occ(X, n_cells, gs, cube):
    q = [np.asarray(X.x)[:n_cells], np.asarray(X.y)[:n_cells],
         np.asarray(X.z)[:n_cells]]
    cid = 0
    for a in q:
        cid = cid * gs + np.clip(np.floor(a / cube).astype(np.int64)
                                 + gs // 2, 0, gs - 1)
    return int(np.bincount(cid).max()), max(float(np.abs(a).max())
                                            for a in q)


def _extents(X, n_cells):
    """Per-axis max |coord| of the active cells (x, y, z)."""
    return tuple(float(np.abs(np.asarray(a)[:n_cells]).max())
                 for a in (X.x, X.y, X.z))


def _occ_cubes(X, n_cells, gs, cube):
    """(z, y, x) cube coords + per-cube counts of the active points."""
    q = [np.clip(np.floor(np.asarray(a)[:n_cells] / cube).astype(np.int64)
                 + gs // 2, 0, gs - 1)
         for a in (X.z, X.y, X.x)]
    cid = (q[0] * gs + q[1]) * gs + q[2]
    uniq, counts = np.unique(cid, return_counts=True)
    return uniq, counts


def _overflow(X, n_cells, gs, cube, C):
    """Cells a (cube, capacity ``C``) binning of the active points would
    not hold: the settle loops' density-convergence probe."""
    _, counts = _occ_cubes(X, n_cells, gs, cube)
    return int(np.maximum(counts - C, 0).sum())


def _settle_sorting(X, old_v, n_cells, adhesion, dt, r_max):
    """Relu pre-relaxation + full-force settling until the compact
    adhesive tissue's density profile stops drifting (same convergence
    gate as the 500k builder: the sticky potential compacts for many
    hundreds of steps, and a bench timed mid-transient outruns both its
    capacity plan and its staleness margin)."""
    from yalla_tpu.inits import relu_force
    from yalla_tpu.ops.common import friction_w_neighbour
    from yalla_tpu.ops.common import grid_for
    from yalla_tpu.ops.lattice_xla import lattice_heun_steps

    n = jnp.int32(n_cells)
    _, extent0 = _max_occ(X, n_cells, 64, r_max)
    gs0 = grid_for(extent0 * 1.1 + 1.0, r_max)

    def phase(pw, dt_, X, old_v):
        X, old_v, aux = lattice_heun_steps(
            RELAX_STEPS, REBUILD_EVERY, pw, friction_w_neighbour,
            "com", gs0, 24, 2, X, old_v, n, jnp.float32(dt_),
            jnp.float32(r_max), jnp.int32(0), None)
        assert int(aux["__err_out_of_grid"]) == 0
        return X, old_v

    X, old_v = phase(relu_force, 0.1, X, old_v)
    prev_e = None
    for phase_i in range(20):
        X, old_v = phase(adhesion, dt, X, old_v)
        n_e = _overflow(X, n_cells, 64, r_max, 16)
        if prev_e is not None and abs(n_e - prev_e) <= max(5, prev_e // 20):
            break
        prev_e = n_e
    print(f"# settle (sorting 5k-class): {phase_i + 1} full-force phases, "
          f"probe overflow {n_e}", file=sys.stderr)
    return X, jax.tree.map(jnp.zeros_like, old_v)


def _settle_sorting_cached(X, old_v, n_cells, adhesion, dt, r_max, seed):
    """Cache wrapper around ``_settle_sorting``: the two 5k builders
    (lattice / tile) share the IC recipe but pad to different shapes, so
    the cache key carries n_pad."""
    cell_cls, n_pad = type(X), int(X.x.shape[0])
    tag = f"sorting_p{n_pad}"
    cached = None if _REFRESH else load_settled(tag, n_cells, seed, cell_cls)
    if cached is not None:
        return cached
    X, old_v = _settle_sorting(X, old_v, n_cells, adhesion, dt, r_max)
    save_settled(tag, n_cells, seed, X, old_v)
    return X, old_v


def _plan_lattice(X, n_cells, r_max, ms, min_C=0):
    """Cost-optimal (cube multiple, (gx, gy, gz), C) over candidate cube
    margins ``ms``.  The XLA lattice pass evaluates, per slot, 9 (dz, dy)
    windows of ``4C - 1`` flat shifts, so its pair work is
    ``gx*gy*gz * C * 9(4C - 1)``; each axis covers the tissue's own
    extent.  Capacity keeps 2 cells of headroom over the measured max
    occupancy (density drifts during the timed window); ``min_C`` lets a
    flagged caller escalate it."""
    from yalla_tpu.ops.common import grid_for

    ex, ey, ez = _extents(X, n_cells)
    best = None
    for m in ms:
        cube_m = r_max * m
        occ_m, _ = _max_occ(X, n_cells, 96, cube_m)
        dims = tuple(grid_for(e, cube_m) for e in (ex, ey, ez))
        C_m = max(occ_m + 2, min_C, 4)
        cost = dims[0] * dims[1] * dims[2] * C_m * 9 * (4 * C_m - 1)
        if best is None or cost < best[0]:
            best = (cost, m, dims, C_m, occ_m, max(ex, ey, ez))
    return best


def _prepare_branching(n_cells, seed=0):
    """Settled 500k-class branching state: IC, relu relaxation, full-force
    settling to density convergence (cached in ``.bench_cache``)."""
    from yalla_tpu.models import branching as B
    from yalla_tpu.dtypes import Float3
    from yalla_tpu.ops.common import friction_w_neighbour
    from yalla_tpu.ops.common import grid_for
    from yalla_tpu.ops.lattice_xla import lattice_heun_steps
    from yalla_tpu.polarity import polarity_precompute3 as polarity_precompute

    n_pad = -(-n_cells // 4096) * 4096 if n_cells > 4096 else \
        max(64, -(-n_cells // 64) * 64)
    p = B.Params()
    force = B.make_force(p)
    n = jnp.int32(n_cells)
    cached = None if _REFRESH else load_settled("branching", n_cells, seed,
                                                B.Cell)
    if cached is not None and int(cached[0].x.shape[0]) == n_pad:
        return cached[0], cached[1], p, force, n
    X = _ic(n_cells, n_pad, seed)
    old_v = Float3.zeros(n_pad)

    # relax to mechanical equilibrium with the plain relu band (exactly the
    # reference's relaxed-IC recipe, inits.cuh:95-155), then pick the
    # cheapest (grid, capacity) for the measured occupancy
    from yalla_tpu.inits import relu_force
    _, extent0 = _max_occ(X, n_cells, 64, p.r_max)
    # generous transient headroom: the jittered IC compresses locally and
    # expands toward its ~0.8 rest spacing while settling
    gs0 = grid_for(extent0 * 1.04 + 1.0, p.r_max)
    # two phases at C=8 / C=16: geometric
    # relaxation with the relu band, then settling under the *full*
    # force -- the full force's tighter rest bands re-compress the
    # tissue, and capacity must be sized for the regime actually timed
    # (measured: settled max occupancy is 8+ at 500k, so the timed run
    # gets C = 10; a handful of transiently dropped cells during IC
    # preparation are reported but acceptable -- they freeze for at most
    # one rebuild interval of the prep phase)
    def _phase(pw, pre, X, old_v, C_s=8):
        X, old_v, aux = lattice_heun_steps(
            RELAX_STEPS, REBUILD_EVERY, pw, friction_w_neighbour, "com",
            gs0, C_s, 2, X, old_v, n, jnp.float32(p.dt),
            jnp.float32(p.r_max), jnp.int32(0), pre)
        assert int(aux["__err_out_of_grid"]) == 0, "settling left the grid"
        dropped = int(aux["__err_lattice_dropped"])
        if dropped:
            print(f"# bench IC prep: {dropped} cells transiently dropped",
                  file=sys.stderr)
        return X, old_v

    X, old_v = _phase(relu_force, None, X, old_v)
    # settle under the FULL force until the density profile stops
    # drifting: the adhesive tail re-compresses the relu-relaxed ball for
    # hundreds of steps, and a bench timed mid-transient outruns any
    # capacity plan sized at its start.  Convergence gate: the overflow
    # count a fixed (cube, C) probe binning would see changes < 5% per
    # 48-step phase.
    prev_e = None
    for phase_i in range(20):
        X, old_v = _phase(force, polarity_precompute, X, old_v, C_s=16)
        n_e = _overflow(X, n_cells, 96, 1.2 * p.r_max, 10)
        print(f"# settle phase {phase_i}: probe overflow {n_e}",
              file=sys.stderr)
        if prev_e is not None and abs(n_e - prev_e) <= max(20, prev_e // 20):
            break
        prev_e = n_e
    save_settled("branching", n_cells, seed, X, old_v)
    return X, old_v, p, force, n


def build_engine(n_cells, seed=0):
    """The engine ``models.branching.default_engine`` picks for ``n_cells``
    on the settled tissue, driven through ``heun_steps`` with the
    reference's rebuild-per-pass cadence (solvers.cuh:494)."""
    from yalla_tpu.models import branching as B
    from yalla_tpu.ops.common import friction_w_neighbour
    from yalla_tpu.polarity import polarity_precompute3 as polarity_precompute
    from yalla_tpu.solvers import heun_steps

    X, old_v, p, force, n = _prepare_branching(n_cells, seed)
    engine = B.default_engine(n_cells, n_cells, p)
    print(f"# bench config: n={n_cells} engine={engine}", file=sys.stderr)

    def run(n_steps, rebuild=1, cube_mult=1.0):
        del rebuild, cube_mult  # per-pass binning inside the engine
        return heun_steps(n_steps, engine, force, friction_w_neighbour,
                          None, "com", X, old_v, n, jnp.float32(p.dt),
                          jnp.float32(p.r_max), jnp.int32(0), None,
                          polarity_precompute)

    run.start_rebuild = 1
    run.config = {"engine": repr(engine)}
    return run


def build_sorting(n_cells, seed=0):
    """5k-class configuration per BASELINE.json: "sorting/epithelium-class
    models" -- differential-adhesion cubic mechanics
    (ref examples/sorting.cu:16-28) on a relaxed ball.  Unlike the
    branching force, the adhesive potential keeps the tissue compact, so
    this is the representative small-model regime."""
    import jax.numpy as jnp
    from yalla_tpu.dtypes import Float3, make_pt
    from yalla_tpu.inits import relu_force
    from yalla_tpu.ops.common import friction_w_neighbour
    from yalla_tpu.ops.lattice_xla import lattice_heun_steps

    Cell = make_pt("SortCell", "ctype")
    rng = np.random.default_rng(seed)
    n_pad = max(64, -(-n_cells // 64) * 64)
    side = int(np.ceil(n_cells ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_pad]
    pos = (g - side / 2) * 0.75 + rng.uniform(-0.2, 0.2, (len(g), 3))
    pos = np.concatenate(
        [pos, np.zeros((max(0, n_pad - len(pos)), 3))])[:n_pad]
    X = Cell(x=jnp.asarray(pos[:, 0], jnp.float32),
             y=jnp.asarray(pos[:, 1], jnp.float32),
             z=jnp.asarray(pos[:, 2], jnp.float32),
             ctype=jnp.asarray((rng.random(n_pad) < 0.5)
                               .astype(np.float32)))
    old_v = Float3.zeros(n_pad)
    n = jnp.int32(n_cells)
    r_max, r_min, dt = 1.0, 0.5, 0.05

    def adhesion(Xi, r, dist, i, j):
        # ref sorting.cu:16-28: strength by type pair
        near = (i != j) & (dist < r_max)
        same = r.ctype == 0.0
        strength = jnp.where(same, jnp.where(Xi.ctype > 0.5, 9.0, 1.0),
                             3.0)
        F = 2 * (r_min - dist) * (r_max - dist) + (r_max - dist) ** 2
        pos_ = dist > 0
        inv = jnp.where(pos_, jax.lax.rsqrt(
            jnp.where(pos_, dist * dist, 1.0)), 0.0)
        w = jnp.where(near, strength * F * inv, 0.0)
        zero = jnp.zeros_like(dist)
        return Cell(x=r.x * w, y=r.y * w, z=r.z * w, ctype=zero)

    X, old_v = _settle_sorting_cached(X, old_v, n_cells, adhesion, dt,
                                      r_max, seed)
    zb = 2

    def make_run(ms, min_C=0):
        # same cost-model planner as the 500k builder
        best = _plan_lattice(X, n_cells, r_max, ms, min_C)
        _, m, gs, C, max_occ, extent = best
        cube = r_max * m
        print(f"# bench config (sorting 5k-class): n={n_cells} "
              f"extent={extent:.1f} max_occ={max_occ} (cube x{m}) -> "
              f"gs={gs} C={C}", file=sys.stderr)

        def run(n_steps, rebuild=1, cube_mult=1.0, rebin=False,
                rebin_scale=1):
            k = 1 if rebin == "pass" else rebuild
            k = max(d for d in range(1, k + 1) if n_steps % d == 0)
            if k != (1 if rebin == "pass" else rebuild):
                print(f"# cadence: rebuild_every={rebuild} does not "
                      f"divide n_steps={n_steps}; timing k={k}",
                      file=sys.stderr)
            m_cap = max(4096, -(-n_cells * rebin_scale // 8 // 64) * 64) \
                if rebin else 0
            return lattice_heun_steps(
                n_steps, k, adhesion, friction_w_neighbour, "com", gs, C,
                zb, X, old_v, n, jnp.float32(dt),
                jnp.float32(cube * cube_mult), jnp.int32(0), None,
                None, None, jnp.float32(r_max), m_cap, rebin == "pass")

        run.config = {"gs": list(gs), "C": int(C),
                      "max_occ": int(max_occ), "cube": float(cube)}
        run.remake = make_run
        run.remake_cap = lambda m=m, C=C: make_run(
            (m,), min_C=C + max(2, C // 2))
        run.r_max = float(r_max)
        run.supports_rebin = True
        run.plan_cost = float(best[0])
        run.spec = {"ms": [float(m)], "min_C": int(min_C)}
        return run

    # cube 1.0 stays in the candidate set even at rebuild_every > 1: the
    # certification ladder falls back to rebuild-per-pass on the
    # cost-optimal config, and for this compact tissue that IS cube 1.0
    # (bigger cubes push occupancy/C up faster than they buy margin)
    return make_run((1.0, 1.1, 1.2))


def build_sorting_tile(n_cells, seed=0):
    """5k-class contender: the all-pairs ``TileEngine``.  Compact adhesive
    tissues pack ~20 cells/cube, which drives the lattice capacity (cost
    ~C^2) up at small n while n^2 is only 26M pairs at 5k; the bench
    races both engines and reports the better."""
    from yalla_tpu.dtypes import Float3, make_pt
    from yalla_tpu.ops.common import friction_w_neighbour
    from yalla_tpu.solvers import TileEngine, heun_steps

    Cell = make_pt("SortCell", "ctype")
    rng = np.random.default_rng(seed)
    # 128-row padding: the settled cache entry is keyed by n_pad
    n_pad = max(128, -(-n_cells // 128) * 128)
    side = int(np.ceil(n_cells ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_pad]
    pos = (g - side / 2) * 0.75 + rng.uniform(-0.2, 0.2, (len(g), 3))
    pos = np.concatenate(
        [pos, np.zeros((max(0, n_pad - len(pos)), 3))])[:n_pad]
    X = Cell(x=jnp.asarray(pos[:, 0], jnp.float32),
             y=jnp.asarray(pos[:, 1], jnp.float32),
             z=jnp.asarray(pos[:, 2], jnp.float32),
             ctype=jnp.asarray((rng.random(n_pad) < 0.5)
                               .astype(np.float32)))
    old_v = Float3.zeros(n_pad)
    n = jnp.int32(n_cells)
    r_max, r_min, dt = 1.0, 0.5, 0.05

    def adhesion(Xi, r, dist, i, j):
        near = (i != j) & (dist < r_max)
        same = r.ctype == 0.0
        strength = jnp.where(same, jnp.where(Xi.ctype > 0.5, 9.0, 1.0),
                             3.0)
        F = 2 * (r_min - dist) * (r_max - dist) + (r_max - dist) ** 2
        pos_ = dist > 0
        inv = jnp.where(pos_, jax.lax.rsqrt(
            jnp.where(pos_, dist * dist, 1.0)), 0.0)
        w = jnp.where(near, strength * F * inv, 0.0)
        zero = jnp.zeros_like(dist)
        return Cell(x=r.x * w, y=r.y * w, z=r.z * w, ctype=zero)

    X, old_v = _settle_sorting_cached(X, old_v, n_cells, adhesion, dt,
                                      r_max, seed)

    engine = TileEngine()
    print(f"# bench config (sorting 5k-class, all-pairs TileEngine): "
          f"n={n_cells} n_pad={n_pad}", file=sys.stderr)

    def run(n_steps, rebuild=1, cube_mult=1.0):
        del rebuild, cube_mult  # no binning in the all-pairs engine
        return heun_steps(n_steps, engine, adhesion, friction_w_neighbour,
                          None, "com", X, old_v, n, jnp.float32(dt),
                          jnp.float32(r_max), jnp.int32(0), None)

    run.start_rebuild = 1
    run.config = {"engine": "tile", "n_pad": int(n_pad)}
    return run


def _probe_clean(aux):
    return not any(k.startswith("__err") and k != "__err_rebin_overflow"
                   and bool(np.max(np.asarray(v))) for k, v in aux.items())


def _capacity_only_flags(aux):
    """Did a flagged probe fail ONLY on lattice capacity -- i.e. fixable
    by re-planning at a higher capacity with the same binning?"""
    fired = {k for k, v in aux.items()
             if k.startswith("__err") and float(np.max(np.asarray(v)))}
    return fired == {"__err_lattice_dropped"}


def measure(n_cells, n_steps, builder, seed=0, on_certify=None,
            winner_spec=None, winner_rate=None):
    """Race certified rungs; return (best_rate, best_cfg, best_spec).

    ``on_certify(rate, cfg, spec)`` fires every time a rung certifies
    that beats the current best -- the caller emits the provisional JSON
    line there, so a later rung's crash or the driver's clock can never
    erase a measured result.  ``winner_spec`` (from bench_state.json)
    re-builds and races the last certified winner FIRST.  Every probe
    respects the module wall-clock budget (``_expired``).

    CONFIRM-ONLY re-runs: when the stored winner reproduces its stored
    ``winner_rate`` (>= 95%), the exploration ladder is SKIPPED entirely
    unless ``BENCH_EXPLORE=1``."""
    explore = os.environ.get("BENCH_EXPLORE", "") not in ("", "0")
    run0 = builder(n_cells, seed)

    # The staleness certifier (__err_stale) may reject the default
    # rebuild cadence: an actively-signalling tissue shears more per
    # chunk than the binning margin (cube_size - r_max) allows.  The
    # ladder is MEASUREMENT-DRIVEN: the first probe publishes the actual
    # shear closure, and every alternative it implies is re-planned
    # (cube, gs, C), probed, and -- if its flags are clean --
    # TIMED: same cadence with the margin sized to 1.3x the measurement,
    # halved cadences sized to the ~0.6x/halving scaling, and the
    # reference-exact rebuild-per-pass at the cost-optimal cube.  The
    # reported number is the fastest CERTIFIED config by measurement,
    # not the first that happens to pass (a wide-margin lattice pays
    # ~C^2 lane work; per-pass rebuilds pay sort+pour+unbuild -- which
    # wins depends on the physics' shear rate).
    #
    # FAIL-SOFT: a probe flagged on capacity re-plans at the next C rung,
    # and a rung that never certifies is simply not in the race --
    # measure() raises only when NOTHING certified at all.
    records = []   # {"rate", "cfg", "run", "rebuild", "cm", "rebin"}
    raced = {}     # (config, rebuild, cm, rebin, scale) -> result memo

    def _winner_spec(rec):
        """Reconstruction recipe for a certified rung: enough for a
        future run to remake + race it first (bench_state.json)."""
        run = rec["run"]
        spec = dict(getattr(run, "spec", {}) or {})
        if spec and getattr(run, "r_max", None):
            spec["ms"] = [round(rec["cfg"]["cube"] / run.r_max, 6)]
        spec["rebuild"] = int(rec["rebuild"])
        spec["rebin"] = rec["rebin"] if isinstance(rec["rebin"], str) \
            else bool(rec["rebin"])
        return spec

    def probe_and_time(run, rebuild, cm=1.0, rebin=False, rebin_scale=1):
        """Probe once; if flag-clean, time the same program and record.
        Returns None on success, else the flagged aux dict.  Budget- and
        memo-guarded: an exhausted wall clock skips the rung (marker
        aux), an already-raced identical rung returns its prior result."""
        key = (json.dumps(run.config, sort_keys=True), rebuild, cm,
               str(rebin), rebin_scale)
        if key in raced:
            return raced[key]
        if _expired():
            print(f"# budget exhausted ({_time_left():.0f} s left); "
                  f"skipping rung (rebuild={rebuild}, rebin={rebin}, "
                  f"{run.config})", file=sys.stderr)
            return {"__budget_expired": np.float32(1.0)}
        raced[key] = _probe_and_time(run, rebuild, cm, rebin, rebin_scale)
        return raced[key]

    def _probe_and_time(run, rebuild, cm, rebin, rebin_scale):
        kw = {"rebin": rebin} if rebin else {}
        if rebin and rebin_scale > 1:
            kw["rebin_scale"] = rebin_scale
        out = run(n_steps, rebuild, cm, **kw)  # compile + warm up
        _ = float(np.asarray(out[0].x)[0])  # force completion (readback)
        aux = out[2]
        if not _probe_clean(aux) or int(aux.get("__err_rebin_overflow",
                                                0)) != 0:
            fired = {k: float(np.max(np.asarray(v)))
                     for k, v in aux.items()
                     if k.startswith("__err") and float(
                         np.max(np.asarray(v))) != 0.0}
            print(f"# probe flagged (rebuild={rebuild}, cm={cm}, "
                  f"rebin={rebin}): {fired} "
                  f"closure={float(aux.get('stale_shear_closure', np.nan)):.3f}",
                  file=sys.stderr)
            return aux
        t0 = time.perf_counter()
        out = run(n_steps, rebuild, cm, **kw)
        _ = float(np.asarray(out[0].x)[0])
        dt = time.perf_counter() - t0
        rate = n_cells * n_steps / dt
        aux = out[2]
        if not _probe_clean(aux) or int(aux.get("__err_rebin_overflow",
                                                0)) != 0 \
                or bool(np.max(np.asarray(aux["__err_non_finite"]))):
            # deterministic programs should match their probe; treat a
            # divergence as an uncertified rung, never as a fatal abort
            print(f"# timed run flagged after a clean probe "
                  f"(rebuild={rebuild}, cm={cm}, rebin={rebin}); "
                  f"discarding rung", file=sys.stderr)
            return aux
        print(f"# certified {n_cells}: {rate:.4g} cell-steps/s "
              f"(rebuild_every={rebuild}, rebin={rebin}, {run.config})",
              file=sys.stderr)
        cfg = dict(run.config)
        cfg["rebuild_every"] = rebuild
        cfg["cube_mult"] = cm
        cfg["rebin"] = rebin if isinstance(rebin, str) else bool(rebin)
        if rebin and rebin_scale > 1:
            cfg["rebin_scale"] = rebin_scale
        rec = {"rate": rate, "cfg": cfg, "run": run,
               "rebuild": rebuild, "cm": cm, "rebin": rebin}
        records.append(rec)
        if on_certify is not None and rate >= max(r["rate"]
                                                  for r in records):
            # emit-first: the caller prints the provisional JSON line NOW
            on_certify(rate, dict(cfg), _winner_spec(rec))
        return None

    rebuild0 = getattr(run0, "start_rebuild", REBUILD_EVERY)
    can_rebin = getattr(run0, "supports_rebin", False)

    def _fired(aux):
        return {k for k, v in aux.items()
                if k.startswith("__err") and float(np.max(np.asarray(v)))}

    def probe_time_track(run, rebuild, cm=1.0, rebin=False):
        aux = probe_and_time(run, rebuild, cm, rebin)
        if aux is None:
            return None
        # mover-list-only overflow on a rebin rung: the slot-space
        # rebinning is exact once its mover capacity covers the tissue's
        # cube-face crossing rate -- escalate the cap, nothing else
        if rebin and _fired(aux) == {"__err_rebin_overflow"}:
            for s in (2, 4):
                aux = probe_and_time(run, rebuild, cm, rebin,
                                     rebin_scale=s)
                if aux is None:
                    return None
                if _fired(aux) != {"__err_rebin_overflow"}:
                    break
            return aux
        # capacity-only failures are re-planned in place at a CAPACITY
        # rung half as large again (density fluctuates past the measured
        # occupancy while the tissue moves)
        if _capacity_only_flags(aux) and \
                getattr(run, "remake_cap", None) is not None:
            up = run.remake_cap()
            if up is not None and up.config != run.config:
                aux2 = probe_and_time(up, rebuild, cm, rebin)
                if aux2 is None:
                    return None
                aux = aux2
        return aux

    # ---- rung order is RECORD-first
    # 1. the persisted winner from bench_state.json, raced verbatim
    if winner_spec and hasattr(run0, "remake"):
        w = None
        try:
            kw = {k: winner_spec[k] for k in ("min_C",)
                  if winner_spec.get(k)}
            w = run0.remake(tuple(winner_spec.get("ms", ())), **kw)
        except Exception as e:
            print(f"# stored winner rebuild failed: "
                  f"{type(e).__name__}: {e}"[:300], file=sys.stderr)
        if w is not None:
            probe_time_track(w, int(winner_spec.get("rebuild", 1)),
                             rebin=winner_spec.get("rebin", False))

    # confirm-only fast path: stored winner reproduced -> don't explore
    skip_explore = False
    if records and winner_rate and not explore:
        got = max(r["rate"] for r in records)
        if got >= 0.95 * float(winner_rate):
            skip_explore = True
            print(f"# stored winner reproduced ({got:.4g} vs stored "
                  f"{float(winner_rate):.4g} cell-steps/s); skipping the "
                  f"exploration ladder (BENCH_EXPLORE=1 races all rungs)",
                  file=sys.stderr)

    # 2. known-strong per-pass families (no staleness certificate, no
    # margin): the margin-free cube-1.0 rebuild plan, the cost-optimal
    # plan, and their slot-space rebin variants
    aux = None
    base = None
    if skip_explore:
        pass
    elif can_rebin and hasattr(run0, "remake"):
        base = run0.remake((1.0,))
        if base is not None:
            probe_time_track(base, 1)
        if rebuild0 == 1:
            probe_time_track(run0, 1)
        probe_time_track(run0, 1, rebin="pass")
        if base is not None and not _expired():
            probe_time_track(base, 1, rebin="pass")
        # 3. resident-cadence exploration, only once the per-pass record
        # is already in hand
        if rebuild0 > 1 and not _expired():
            aux = probe_time_track(run0, rebuild0)
    elif rebuild0 > 1:
        aux = probe_time_track(run0, rebuild0)
    else:
        probe_time_track(run0, rebuild0)
    if aux is not None and "__budget_expired" not in aux:
        closure = float(aux.get("stale_shear_closure", np.nan))
        print(f"# flags at rebuild_every={rebuild0} "
              f"(closure {closure:.3f}); racing certified alternatives",
              file=sys.stderr)
        can_size = hasattr(run0, "remake") and np.isfinite(closure)
        if rebuild0 > 1 and can_size:
            # candidate rungs, cheapest-margin first; each may still flag
            # (the 0.6x/halving closure scaling is an estimate) -- a
            # flagged rung re-sizes once from ITS measured closure before
            # giving up.  Per-step rebinning (rebuild 1 + lattice_rebin)
            # joins the race: it needs only the single-step margin but
            # skips the per-pass sort/unbuild round trip entirely.
            cands = []
            margin = 1.3 * closure
            if margin <= 0.45 * run0.r_max:
                cands.append((round(1.0 + margin / run0.r_max, 3),
                              rebuild0, False))
            r, m = rebuild0 // 2, margin
            while r > 1:
                m *= 0.6
                cands.append((round(1.0 + min(m / run0.r_max, 0.45), 3),
                              r, False))
                r //= 2
            if can_rebin:
                # rebin at rebuild 1 still evaluates the corrector under
                # the chunk-start binning -- needs the single-step
                # margin, sized by the same 0.6x/halving scaling
                m1 = m * 0.6 if rebuild0 > 1 else margin
                cands.append((round(1.0 + min(m1 / run0.r_max, 0.45), 3),
                              1, True))
                cands.append((1.0, 1, True))  # base cube; resized on flag
            for cube_m, rb, rbn in cands:
                sized = run0 if cube_m == 1.0 else run0.remake((cube_m,))
                if sized is None:
                    continue
                aux2 = probe_time_track(sized, rb, rebin=rbn)
                if aux2 is not None:
                    cl2 = float(aux2.get("stale_shear_closure", np.nan))
                    if np.isfinite(cl2) and 1.3 * cl2 <= 0.45 * run0.r_max:
                        resized = run0.remake(
                            (round(1.0 + 1.3 * cl2 / run0.r_max, 3),))
                        if resized is not None:
                            probe_time_track(resized, rb, rebin=rbn)
        if rebuild0 > 1:
            # reference-exact rebuild-per-pass at the cost-optimal cube
            # (solvers.cuh:494): no staleness possible, margin irrelevant
            probe_time_track(run0, 1)
    if records and not skip_explore:
        best = max(records, key=lambda r: r["rate"])
        if can_rebin and not best["rebin"]:
            # rebin variant of the best certified rung: certification
            # transfers (same binning per chunk), only the chunk
            # round-trip cost changes
            probe_and_time(best["run"], best["rebuild"], best["cm"],
                           rebin=True)
        # cadence UP-rungs on the best certified config: the measured
        # closure is dominated by instantaneous approach speed (see
        # benchmarks/diag_rebin.py), so longer residencies usually
        # certify at the SAME margin while paying 1/2, 1/4, ... of the
        # rebuild cost; stop at the first flagged doubling
        best = max(records, key=lambda r: r["rate"])
        rb = best["rebuild"] * 2
        while best["rebuild"] > 1 and rb <= 16 and n_steps % rb == 0:
            if probe_time_track(best["run"], rb, best["cm"],
                                best["rebin"]) is not None:
                break
            rb *= 2
    if not records:
        raise AssertionError(
            f"no config certified for n={n_cells} (all rungs flagged, "
            f"including rebuild-per-pass after capacity escalation)")
    best = max(records, key=lambda r: r["rate"])
    print(f"# measured {n_cells}: {best['rate']:.4g} cell-steps/s "
          f"(best of {len(records)} certified: {best['cfg']})",
          file=sys.stderr)
    return best["rate"], best["cfg"], _winner_spec(best)


def _emit(n_cells, rate, extra):
    """One JSON result line on stdout.  Called PROVISIONALLY the moment
    the headline rung certifies and again after every improvement and at
    exit (final, superset), so a later rung's crash can never erase an
    already-measured result.  Every line names the device it measured."""
    from yalla_tpu import backend
    print(json.dumps({
        "metric": f"cell_steps_per_sec_branching_{n_cells // 1000}k",
        "value": round(rate, 1) if rate is not None else None,
        "unit": "cell-steps/s",
        "device": backend.device_info(),
        "card": backend.card_line(),
        "extra": extra,
    }), flush=True)


def main():
    global _DEADLINE
    from yalla_tpu import backend
    from yalla_tpu.utils import enable_compilation_cache

    backend.require_gpu()
    n_cells = int(sys.argv[1]) if len(sys.argv) > 1 else 500_000
    n_steps = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    budget = float(os.environ.get("BENCH_BUDGET_S", "2100"))
    if budget > 0:
        _DEADLINE = time.monotonic() + budget
        print(f"# wall-clock budget: {budget:.0f} s "
              f"(BENCH_BUDGET_S; <= 0 disables)", file=sys.stderr)
    enable_compilation_cache()

    import traceback
    bench_state = _load_bench_state()
    head_key = f"branching_{n_cells}"
    rate, extra = None, {}
    errors = []

    def on_certify(r, cfg, spec):
        """Provisional emit + winner persistence on every improvement."""
        nonlocal rate
        if rate is None or r > rate:
            rate = r
            extra["config"] = cfg
            bench_state[head_key] = {"rate": round(r, 1), "spec": spec,
                                     "cfg": cfg}
            _save_bench_state(bench_state)
            _emit(n_cells, rate, extra)

    global _RESERVE_S
    if n_cells >= 100_000:
        _RESERVE_S = 600.0  # keep the 5k races alive behind the ladder
    try:
        r, config, spec = measure(
            n_cells, n_steps, builder=build_engine,
            on_certify=on_certify,
            winner_spec=(bench_state.get(head_key) or {}).get("spec"),
            winner_rate=(bench_state.get(head_key) or {}).get("rate"))
        on_certify(r, config, spec)
    except Exception as e:
        traceback.print_exc(file=sys.stderr)
        errors.append(f"{n_cells}: {type(e).__name__}: {e}"[:300])
    _RESERVE_S = 0.0
    if n_cells >= 100_000:
        # the second size: 5k cells.  Race the two small-N engines
        # (all-pairs tile vs dense lattice) on the identical sorting-class
        # physics and relaxed IC, and report the better; the stored 5k
        # winner races first.  320 steps: the reference's own sorting.cu
        # runs 300, and 320 keeps every cadence rung (4/8/16) exact.
        builders = {"build_sorting_tile": build_sorting_tile,
                    "build_sorting": build_sorting}
        won_5k = (bench_state.get("sorting_5000") or {}).get("builder")
        order = sorted(builders, key=lambda k: k != won_5k)
        best = None
        explore5 = os.environ.get("BENCH_EXPLORE", "") not in ("", "0")
        stored5 = (bench_state.get("sorting_5000") or {}).get("rate")
        for i, name in enumerate(order):
            if i > 0 and best is not None and _expired(reserve=60):
                print(f"# budget: skipping 5k runner-up {name}",
                      file=sys.stderr)
                break
            if (i > 0 and best is not None and not explore5 and stored5
                    and best[0] >= 0.95 * float(stored5)):
                # confirm-only: the stored 5k winner reproduced; the
                # runner-up engine is already measured slower on record
                print(f"# stored 5k winner reproduced; skipping "
                      f"runner-up {name} (BENCH_EXPLORE=1 races it)",
                      file=sys.stderr)
                break
            b = builders[name]
            spec5 = (bench_state.get("sorting_5000") or {}).get("spec") \
                if name == won_5k else None

            def on5(r5, c5, s5, name=name):
                nonlocal best
                if best is None or r5 > best[0]:
                    best = (r5, c5)
                    extra["cell_steps_per_sec_5k"] = round(r5, 1)
                    extra["config_5k"] = c5
                    bench_state["sorting_5000"] = {
                        "rate": round(r5, 1), "builder": name, "spec": s5,
                        "cfg": c5}
                    _save_bench_state(bench_state)
                    _emit(n_cells, rate, extra)

            try:
                rate5 = (bench_state.get("sorting_5000") or {}).get("rate") \
                    if name == won_5k else None
                r5, c5, s5 = measure(5_000, max(n_steps, 320), builder=b,
                                     on_certify=on5, winner_spec=spec5,
                                     winner_rate=rate5)
                on5(r5, c5, s5)
            except Exception as e:
                traceback.print_exc(file=sys.stderr)
                errors.append(f"5000 {name}: {type(e).__name__}: {e}"[:300])
    if errors:
        extra["errors"] = errors
    _emit(n_cells, rate, extra)
    if errors or rate is None:
        sys.exit(1)


if __name__ == "__main__":
    main()
