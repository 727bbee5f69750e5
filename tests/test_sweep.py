"""Cube-sorted sweep kernel (ops/sweep_triton.py) in explicit interpret
mode against the all-pairs oracle.

The kernel compiles only for an NVIDIA GPU; here the Pallas interpreter
runs the same kernel body, so every case below checks the kernel's
arithmetic, its row ranges and its padding.  The comparison
(``utils/checks.compare_pairwise``) is the one ``chip_smoke.py`` applies
on the card (float channels to 1e-5 of the reference's largest value,
neighbour counters exact, flags clear).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yalla_tpu import Float3
from yalla_tpu.inits import relu_force
from yalla_tpu.models import branching as B
from yalla_tpu.ops.common import (friction_on_background,
                                  friction_w_neighbour)
from yalla_tpu.ops.pairwise_xla import tile_pairwise
from yalla_tpu.ops.sweep_triton import BLOCK, sweep_pairwise, sweep_tables
from yalla_tpu.solvers import SweepEngine, augment
from yalla_tpu.utils.checks import compare_pairwise

GS = 16   # cubes per axis: the grid covers [-8, 8)^3 at cube size 1


def _spring(Xi, r, dist, i, j):
    valid = (i != j) & (dist < 1.0)
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(valid, (0.5 - dist) / safe, 0.0)
    return Float3(x=r.x * w, y=r.y * w, z=r.z * w)


def _wall_spring(Xi, r, dist, i, j):
    """Stable ids beyond i == j: point 0 neither pushes nor is pushed
    (growth_w_wall.cu's wall-node exclusion by index)."""
    near = (i != j) & (i != 0) & (j != 0) & (dist < 1.0)
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(near, (0.8 - dist) / safe, 0.0)
    return Float3(x=r.x * w, y=r.y * w, z=r.z * w)


def _positions(layout, n_pad, rng):
    if layout == "sparse":     # most cubes and rows empty
        return rng.uniform(-7.5, 7.5, (n_pad, 3))
    if layout == "dense":      # ~20 cells per cube
        d = rng.normal(size=(n_pad, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return d * 1.6 * rng.random((n_pad, 1)) ** (1 / 3)
    if layout == "edge":       # on the grid's faces, edges and corners
        pos = rng.uniform(-8.0, 7.99, (n_pad, 3))
        side = rng.integers(0, 3, n_pad)
        lo = rng.random(n_pad) < 0.5
        pos[np.arange(n_pad), side] = np.where(
            lo, rng.uniform(-8.0, -7.2, n_pad), rng.uniform(7.2, 7.99, n_pad))
        pos[:8] = [[sx, sy, sz] for sx in (-7.9, 7.9) for sy in (-7.9, 7.9)
                   for sz in (-7.9, 7.9)]
        return pos
    raise ValueError(layout)


def _state(layout, n, n_pad, seed=0, cell=Float3):
    rng = np.random.default_rng(seed)
    pos = _positions(layout, n_pad, rng).astype(np.float32)
    extra = {f: jnp.asarray(rng.random(n_pad), jnp.float32)
             for f in cell._fields[3:]}
    if "ctype" in extra:
        extra["ctype"] = jnp.asarray((rng.random(n_pad) < 0.4)
                                     .astype(np.float32))
    X = cell(x=jnp.asarray(pos[:, 0]), y=jnp.asarray(pos[:, 1]),
             z=jnp.asarray(pos[:, 2]), **extra)
    ov = Float3(*(jnp.asarray(rng.normal(size=n_pad) * 0.1, jnp.float32)
                  for _ in range(3)))
    return X, ov, jnp.int32(n)


def _check(pw_int, pw_friction, X, ov, n, grid_size=GS):
    out = sweep_pairwise(pw_int, pw_friction, X, ov, n, jnp.float32(1.0),
                         grid_size=grid_size, interpret=True)
    ref = tile_pairwise(pw_int, pw_friction, X, ov, n)
    compare_pairwise(out, ref, int(n))
    return out, ref


FORCES = {"spring": (_spring, None), "relu": (relu_force, None),
          "branching": (B.make_force(B.Params()), B.precompute)}


@pytest.mark.parametrize("friction", ["w_neighbour", "on_background"])
@pytest.mark.parametrize("force", sorted(FORCES))
def test_sweep_matches_tile(force, friction):
    """Spring, ReLU and the full branching force (polarity precompute,
    Meinhardt self-pair terms through ``offdiag``, aux counters), with
    neighbour friction and with background friction."""
    pw, pre = FORCES[force]
    fr = {"w_neighbour": friction_w_neighbour,
          "on_background": friction_on_background}[friction]
    cell = B.Cell if force == "branching" else Float3
    X, ov, n = _state("dense", 300, 384, seed=1, cell=cell)
    _check(pw, fr, augment(X, n, pre), ov, n)


@pytest.mark.parametrize("layout,n,n_pad", [
    ("sparse", 150, 200),    # n_pad not a multiple of the block
    ("dense", 383, 384),
    ("edge", 250, 256),
])
def test_sweep_layouts(layout, n, n_pad):
    """Sparse tissue (empty rows), dense cubes and cells in the grid's
    edge and corner cubes (clipped row ranges)."""
    X, ov, n = _state(layout, n, n_pad, seed=2)
    _check(_spring, friction_w_neighbour, X, ov, n)


def test_sweep_no_active_cells():
    X, ov, _ = _state("dense", 10, 128, seed=3)
    out, _ = _check(_spring, friction_w_neighbour, X, ov, jnp.int32(0))
    assert not np.any(np.asarray(out[0].x))


def test_sweep_passes_stable_ids():
    """The force sees stable point ids, not sorted positions: point 0
    sits mid-tissue, so a mixup would move its force to another cell."""
    X, ov, n = _state("dense", 300, 384, seed=4)
    X = X._replace(x=X.x.at[0].set(0.1), y=X.y.at[0].set(0.1),
                   z=X.z.at[0].set(0.1))
    out, _ = _check(_wall_spring, friction_w_neighbour, X, ov, n)
    assert float(out[0].x[0]) == 0.0


def test_sweep_anisotropic_grid():
    X, ov, n = _state("dense", 300, 384, seed=5)
    _check(relu_force, friction_w_neighbour, X, ov, n, grid_size=(16, 8, 8))


def test_sweep_flags_out_of_grid():
    X, ov, n = _state("dense", 100, 128, seed=6)
    X = X._replace(x=X.x.at[7].set(20.0))
    out = sweep_pairwise(_spring, friction_w_neighbour, X, ov, n,
                         jnp.float32(1.0), grid_size=GS, interpret=True)
    flag = np.asarray(out[3]["__err_out_of_grid"])
    assert flag[7] == 1.0 and flag.sum() == 1.0


def test_sweep_tables_bound_the_neighbour_rows():
    """Each [lo, hi) holds exactly the sorted cells of the three x-cubes
    of one (dz, dy) row, clipped to the grid; inactive cells and rows off
    the grid get empty ranges."""
    X, ov, n = _state("edge", 200, 256, seed=7)
    order, lo, hi = jax.jit(sweep_tables, static_argnums=(3,))(
        X, n, jnp.float32(1.0), GS)
    order, lo, hi = map(np.asarray, (order, lo, hi))
    c = np.stack([np.clip(np.floor(np.asarray(a)) + GS // 2, 0, GS - 1)
                  for a in (X.x, X.y, X.z)], 1).astype(int)[order]
    live = order < int(n)
    for s in range(0, 256, 7):
        for row in range(9):
            dz, dy = row // 3 - 1, row % 3 - 1
            want = np.flatnonzero(
                live & (np.abs(c[:, 0] - c[s, 0]) <= 1)
                & (c[:, 1] == c[s, 1] + dy) & (c[:, 2] == c[s, 2] + dz))
            if not live[s]:
                want = want[:0]
            got = np.arange(lo[row, s], hi[row, s])
            assert np.array_equal(got, want), (s, row)


def test_sweep_engine_in_branching_frame():
    """Two substeps of the flagship frame on the sweep kernel track the
    same frame on the XLA gather grid."""
    p = B.Params()
    state, _, _ = B.init_state(200, 512, p, seed=3)
    grid = B.make_frame(p, B.GridEngine(grid_size=32, row_cap=64),
                        substeps=2)
    sweep = B.make_frame(p, SweepEngine(grid_size=32, interpret=True),
                         substeps=2)
    (sa, ea), (sb, eb) = (f(state, jnp.float32(0.1)) for f in (grid, sweep))
    assert not any(float(v) for v in ea.values()), ea
    assert not any(float(v) for v in eb.values()), eb
    n = int(sa.n)
    assert int(sb.n) == n
    for f in B.Cell._fields:
        a = np.asarray(getattr(sa.X, f))[:n]
        b = np.asarray(getattr(sb.X, f))[:n]
        assert np.allclose(a, b, atol=1e-5), (f, np.abs(a - b).max())


def test_compare_pairwise_catches_a_wrong_pair_pass():
    """The smoke test's comparison rejects a kernel that drops a pair."""
    X, ov, n = _state("dense", 300, 384, seed=8)
    ref = tile_pairwise(_spring, friction_w_neighbour, X, ov, n)
    bad_F = ref[0]._replace(x=ref[0].x.at[5].add(1e-3))
    with pytest.raises(AssertionError, match="F.x"):
        compare_pairwise((bad_F,) + ref[1:], ref, int(n))
    bad_f = ref[1].at[9].add(-1.0)
    with pytest.raises(AssertionError, match="sum_friction"):
        compare_pairwise((ref[0], bad_f) + ref[2:], ref, int(n))


def test_block_padding_shapes():
    """Outputs come back in stable order at the caller's n_pad, whatever
    the block padding inside the kernel."""
    X, ov, n = _state("sparse", 90, 130, seed=9)
    out = sweep_pairwise(_spring, friction_w_neighbour, X, ov, n,
                         jnp.float32(1.0), grid_size=GS, interpret=True)
    assert 130 % BLOCK != 0
    for leaf in jax.tree.leaves(out):
        assert leaf.shape == (130,)


@pytest.mark.gpu
def test_sweep_compiled_for_the_card(gpu):
    """The kernel compiled for the card (no interpreter) at a small size;
    chip_smoke.py runs the same check at the flagship's 500k widths."""
    X, ov, n = _state("dense", 300, 384, seed=10)
    out = sweep_pairwise(_spring, friction_w_neighbour, X, ov, n,
                         jnp.float32(1.0), grid_size=GS)
    ref = tile_pairwise(_spring, friction_w_neighbour, X, ov, n)
    compare_pairwise(out, ref, int(n))
