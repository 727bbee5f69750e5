"""Anisotropic lattice grids: ``grid_size=(gx, gy, gz)``.

A ball- or rod-shaped tissue needs fewer cubes along its short axes;
these tests pin that the anisotropic paths (build, XLA resident, rebin)
are exactly equivalent to the cubic/oracle formulations.
"""
import jax
import jax.numpy as jnp
import numpy as np

from yalla_tpu import Float3, Solution
from yalla_tpu.inits import relu_force
from yalla_tpu.ops.common import friction_w_neighbour
from yalla_tpu.ops.lattice_xla import lattice_heun_steps


def _elongated(n_pad, seed=42, scale=(5.0, 2.5, 1.5)):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n_pad, 3)).astype(np.float32) * scale
    X = Float3(x=jnp.asarray(pos[:, 0]), y=jnp.asarray(pos[:, 1]),
               z=jnp.asarray(pos[:, 2]))
    return pos, X, Float3.zeros(n_pad)


def test_lattice_aniso_matches_tile():
    n = 400
    tile = Solution(Float3, n, solver="tile")
    pos, X0, ov0 = _elongated(tile.n_pad)
    tile.h_X.x[:], tile.h_X.y[:], tile.h_X.z[:] = pos.T
    tile.copy_to_device()
    for _ in range(5):
        tile.take_step(0.1, relu_force)
    ht = tile.copy_to_host()

    X, ov, aux = lattice_heun_steps(
        5, 1, relu_force, friction_w_neighbour, "com", (16, 8, 8),
        16, 2, X0, ov0, jnp.int32(n), jnp.float32(0.1),
        jnp.float32(1.0), jnp.int32(0), None)
    for k, v in aux.items():
        if k.startswith("__err"):
            assert float(np.max(np.asarray(v))) == 0, k
    for f in ("x", "y", "z"):
        got = np.asarray(getattr(X, f))[:n]
        ref = getattr(ht, f)[:n]
        assert np.allclose(got, ref, atol=2e-5), \
            f"aniso lattice differs in {f}"


def test_lattice_aniso_rebin_flags_clean():
    _, X0, ov0 = _elongated(512)
    n = 400
    X, ov, aux = lattice_heun_steps(
        8, 4, relu_force, friction_w_neighbour, "com", (16, 8, 8), 16, 2,
        X0, ov0, jnp.int32(n), jnp.float32(0.01), jnp.float32(1.2),
        jnp.int32(0), None, None, None, jnp.float32(1.0), 2048)
    for k, v in aux.items():
        if k.startswith("__err"):
            assert float(np.max(np.asarray(v))) == 0, k
    assert np.isfinite(np.asarray(X.x)[:n]).all()
