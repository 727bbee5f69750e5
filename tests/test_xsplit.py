"""Thin-x lattice cubes (``x_split > 1``).

``x_split=2`` bins x at ``cube_size / 2``: capacity tracks the HALF-cube
occupancy (roughly half the isotropic one) while the pair pass sweeps
``+-2`` x-neighbours to keep the full ``cube_size`` interaction reach --
total flat shifts go ``4C - 1 -> 6C' - 1`` at ``C' = C/2``.  These tests
pin that the split binning is *physics-exact* against the all-pairs
oracle through every per-pass cadence: XLA resident stencil and
slot-space rebinning (cf. the cross-solver oracle, ref
tests/test_solvers.cu:102-125).
"""
import jax.numpy as jnp
import numpy as np

from yalla_tpu import Float3, Solution
from yalla_tpu.inits import relu_force
from yalla_tpu.ops.common import friction_w_neighbour
from yalla_tpu.ops.lattice_xla import lattice_heun_steps


def _ball(n_pad, seed=3, scale=(3.0, 3.0, 3.0)):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n_pad, 3)).astype(np.float32) * scale
    X = Float3(x=jnp.asarray(pos[:, 0]), y=jnp.asarray(pos[:, 1]),
               z=jnp.asarray(pos[:, 2]))
    return pos, X, Float3.zeros(n_pad)


def _tile_oracle(pos, n, steps, dt):
    tile = Solution(Float3, n, solver="tile")
    tile.h_X.x[:], tile.h_X.y[:], tile.h_X.z[:] = pos.T
    tile.copy_to_device()
    for _ in range(steps):
        tile.take_step(dt, relu_force)
    return tile.copy_to_host()


def _assert_clean(aux):
    for k, v in aux.items():
        if k.startswith("__err"):
            assert float(np.max(np.asarray(v))) == 0, k


def test_xsplit_matches_tile():
    """x_split=2 lattice == all-pairs, per-pass rebuild.

    The grid is (32, 8, 8) with the 32 x-cubes HALF-width (x spans the
    same extent as 16 isotropic cubes); capacity 8 covers the half-cube occupancy (5 at this IC).
    """
    n = 400
    pos, X0, ov0 = _ball(512)
    ht = _tile_oracle(pos, n, 5, 0.1)
    X, ov, aux = lattice_heun_steps(
        5, 1, relu_force, friction_w_neighbour, "com", (32, 8, 8),
        8, 2, X0, ov0, jnp.int32(n), jnp.float32(0.1),
        jnp.float32(1.0), jnp.int32(0), None,
        None, None, None, 0, False, 2)
    _assert_clean(aux)
    for f in ("x", "y", "z"):
        got = np.asarray(getattr(X, f))[:n]
        ref = getattr(ht, f)[:n]
        assert np.allclose(got, ref, atol=2e-5), \
            f"x_split lattice differs in {f}"


def test_xsplit_capacity2_matches_tile():
    """C=2 half-cubes (the smallest capacity the bench planner admits for
    x_split plans, bench.py planner C rungs): lane arithmetic at tiny C is
    a distinct corner (slot index = lane % C wraps every 2 lanes).
    Jittered grid IC at spacing
    (0.9, 1.1, 1.1), so every half-cube holds exactly one point by
    construction (x half-cubes are 0.5 wide < 0.9 spacing; y/z cubes are
    1.0 wide < 1.1 - jitter spacing) while x-neighbour pairs still
    interact inside the 1.0 cutoff -- exercising the split +-2x stencil."""
    n = 400
    # grid IC, max half-cube occupancy <= 2
    rng = np.random.default_rng(17)
    g = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(8),
                             indexing="ij"), -1).reshape(-1, 3)[:512]
    posg = ((g - 4) * [0.9, 1.1, 1.1]
            + rng.uniform(-0.04, 0.04, (512, 3))).astype(np.float32)
    htg = _tile_oracle(posg, n, 4, 0.05)
    Xg = Float3(x=jnp.asarray(posg[:, 0]), y=jnp.asarray(posg[:, 1]),
                z=jnp.asarray(posg[:, 2]))
    X, ov, aux = lattice_heun_steps(
        4, 1, relu_force, friction_w_neighbour, "com", (64, 16, 16),
        2, 2, Xg, Float3.zeros(512), jnp.int32(n), jnp.float32(0.05),
        jnp.float32(1.0), jnp.int32(0), None, None, None,
        jnp.float32(1.0), 0, False, 2)
    _assert_clean(aux)
    for f in ("x", "y", "z"):
        got = np.asarray(getattr(X, f))[:n]
        ref = np.asarray(getattr(htg, f))[:n]
        assert np.allclose(got, ref, atol=2e-5), \
            f"x_split C=2 differs in {f}"


def test_xsplit_rebin_per_pass_matches_tile():
    """Per-pass slot-space rebinning under x_split=2 (the 500k bench
    cadence) stays exact vs the all-pairs oracle."""
    n = 400
    pos, X0, ov0 = _ball(512, seed=11)
    ht = _tile_oracle(pos, n, 4, 0.05)
    X, ov, aux = lattice_heun_steps(
        4, 1, relu_force, friction_w_neighbour, "com", (32, 8, 8),
        8, 2, X0, ov0, jnp.int32(n), jnp.float32(0.05),
        jnp.float32(1.0), jnp.int32(0), None, None, None, None,
        2048, True, 2)
    _assert_clean(aux)
    for f in ("x", "y", "z"):
        got = np.asarray(getattr(X, f))[:n]
        ref = getattr(ht, f)[:n]
        assert np.allclose(got, ref, atol=2e-5), \
            f"x_split rebin-per-pass differs in {f}"


def test_xsplit_engine_take_step():
    """LatticeEngine(x_split=2) through the Solution facade (single
    take_step path) matches the tile engine."""
    from yalla_tpu.solvers import LatticeEngine
    n = 200
    tile = Solution(Float3, n, solver="tile")
    pos, _, _ = _ball(tile.n_pad, seed=5)
    lat = Solution(Float3, n, engine=LatticeEngine(
        grid_size=(32, 8, 8), capacity=8, z_block=2, x_split=2))
    for s in (tile, lat):
        s.h_X.x[:], s.h_X.y[:], s.h_X.z[:] = pos.T
        s.copy_to_device()
        for _ in range(2):
            s.take_step(0.1, relu_force)
    ht, hl = tile.copy_to_host(), lat.copy_to_host()
    for f in ("x", "y", "z"):
        assert np.allclose(getattr(ht, f)[:n], getattr(hl, f)[:n],
                           atol=2e-5), f"engine x_split differs in {f}"
