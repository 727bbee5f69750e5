"""Multi-chip consistency: the shard_map step over an 8-device CPU mesh
must reproduce the single-chip trajectory (the cross-engine oracle of
``test_solvers.test_compare_methods`` applied across device counts)."""
import jax
import jax.numpy as jnp
import numpy as np

from helpers import isclose
from yalla_tpu import Float3, GridEngine, Solution, TileEngine
from yalla_tpu.inits import random_sphere, set_seed
from yalla_tpu.ops.common import friction_w_neighbour
from yalla_tpu.parallel.spmd import (make_cells_mesh, make_sharded_step,
                                     shard_state)

set_seed(2024)


def clipped_spring(Xi, r, dist, i, j):
    valid = (i != j) & (dist < 1.0)
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(valid, (0.5 - dist) / safe, 0.0)
    return jax.tree.map(lambda a: jnp.zeros_like(w), Xi)._replace(
        x=r.x * w, y=r.y * w, z=r.z * w)


def _run_single(engine_kind, n, steps):
    pts = Solution(Float3, n, solver=engine_kind)
    random_sphere(0.733333, pts)
    ref = pts.pt_type(*[f.copy() for f in pts.h_X])
    for _ in range(steps):
        pts.take_step(0.1, clipped_spring)
    return ref, pts.copy_to_host()


def _run_sharded(engine, init_h, n, n_pad, steps):
    mesh = make_cells_mesh()
    X = Float3(*[jnp.asarray(f) for f in init_h])
    old_v = Float3.zeros(n_pad)
    X, old_v = shard_state(mesh, X, old_v)
    step = make_sharded_step(mesh, engine, clipped_spring, n_steps=steps)
    X, old_v, errs = step(X, old_v, jnp.int32(n), jnp.float32(0.1),
                    jnp.float32(1.0), jnp.int32(0))
    return Float3(*[np.asarray(f) for f in X])


def test_sharded_tile_matches_single():
    assert jax.device_count() >= 8, "conftest must provide 8 CPU devices"
    n = 50
    init, single = _run_single("tile", n, 2)
    sharded = _run_sharded(TileEngine(), init, n, len(init.x), 2)
    assert isclose(sharded.x[:n], single.x[:n]), "Sharded tile disagrees in x"
    assert isclose(sharded.y[:n], single.y[:n]), "Sharded tile disagrees in y"
    assert isclose(sharded.z[:n], single.z[:n]), "Sharded tile disagrees in z"


def test_sharded_grid_matches_single():
    n = 50
    init, single = _run_single("grid", n, 2)
    sharded = _run_sharded(GridEngine(), init, n, len(init.x), 2)
    assert isclose(sharded.x[:n], single.x[:n]), "Sharded grid disagrees in x"
    assert isclose(sharded.y[:n], single.y[:n]), "Sharded grid disagrees in y"
    assert isclose(sharded.z[:n], single.z[:n]), "Sharded grid disagrees in z"


def test_lattice_z_slab_sharded_matches_single():
    """The z-slab halo decomposition (ppermute halo exchange over the
    devices ring) reproduces the single-chip lattice trajectory at 10k
    cells / 10 steps, including resident chunks (rebuild_every=2)."""
    from yalla_tpu.inits import relu_force
    from yalla_tpu.ops.lattice_xla import lattice_heun_steps
    from yalla_tpu.parallel.lattice_spmd import (lattice_sharded_heun_steps,
                                                 make_z_mesh)

    n = 10_000
    n_pad = 10_240
    gs, C, zb = 32, 8, 2
    rng = np.random.default_rng(11)
    side = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_pad]
    pos = (g - side / 2) * 0.75 + rng.uniform(-0.15, 0.15, (len(g), 3))
    pos = np.concatenate(
        [pos, np.zeros((max(0, n_pad - len(pos)), 3))])[:n_pad]
    X0 = Float3(x=jnp.asarray(pos[:, 0], jnp.float32),
                y=jnp.asarray(pos[:, 1], jnp.float32),
                z=jnp.asarray(pos[:, 2], jnp.float32))
    ov0 = Float3.zeros(n_pad)
    args = (jnp.int32(n), jnp.float32(0.1), jnp.float32(1.0), jnp.int32(0))

    Xs, ovs, auxs = lattice_heun_steps(
        10, 2, relu_force, friction_w_neighbour, "com", gs, C, zb,
        X0, ov0, *args)

    mesh = make_z_mesh()
    assert mesh.shape["z"] == 8

    @jax.jit
    def run(X0, ov0, n, dt, cs, fp):
        return lattice_sharded_heun_steps(
            mesh, 10, 2, relu_force, friction_w_neighbour, "com",
            gs, C, zb, X0, ov0, n, dt, cs, fp)

    Xm, ovm, auxm = run(X0, ov0, *args)
    assert int(auxm["__err_lattice_dropped"]) == 0
    assert not bool(auxm["__err_non_finite"])
    for f in ("x", "y", "z"):
        a = np.asarray(getattr(Xs, f))[:n]
        b = np.asarray(getattr(Xm, f))[:n]
        assert np.allclose(a, b, atol=5e-5), \
            f"sharded lattice diverges in {f}: {np.abs(a - b).max()}"
    # halo path actually exercised: cells span every z slab
    cz = np.clip(np.floor(pos[:n, 2]) + gs // 2, 0, gs - 1)
    assert len(np.unique(cz // (gs // 8))) >= 4


def test_resident_sharded_links_match_single():
    """Links INSIDE the resident sharded loop (all_gather to stable order,
    replicated hook, slab-local scatter) match the single-chip resident
    integrator with the same generic force -- the intercalation-class
    protrusion path scaled past one chip without leaving the lattice."""
    from yalla_tpu.links import Links, link_forces
    from yalla_tpu.ops.lattice_xla import lattice_heun_steps
    from yalla_tpu.parallel.lattice_spmd import (lattice_sharded_heun_steps,
                                                 make_z_mesh)

    n = 3_000
    n_pad = 3_072
    gs, C, zb = 16, 16, 2
    rng = np.random.default_rng(31)
    side = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_pad]
    pos = (g - side / 2) * 0.8 + rng.uniform(-0.15, 0.15, (len(g), 3))
    pos = np.concatenate(
        [pos, np.zeros((max(0, n_pad - len(pos)), 3))])[:n_pad]
    X0 = Float3(x=jnp.asarray(pos[:, 0], jnp.float32),
                y=jnp.asarray(pos[:, 1], jnp.float32),
                z=jnp.asarray(pos[:, 2], jnp.float32))
    ov0 = Float3.zeros(n_pad)
    links = Links(n // 2, strength=0.25, seed=7)
    # z-spanning protrusions so the stable-space hook crosses slabs
    links.h_a[:n // 2] = rng.integers(0, n, n // 2)
    links.h_b[:n // 2] = rng.integers(0, n, n // 2)
    links.copy_to_device()
    gen = link_forces(links)
    gen_static = gen._replace(args=None)
    args = (jnp.int32(n), jnp.float32(0.1), jnp.float32(1.0), jnp.int32(0))

    Xs, ovs, auxs = lattice_heun_steps(
        4, 2, clipped_spring, friction_w_neighbour, "com", gs, C, zb,
        X0, ov0, *args, None, gen_static, gen.args)
    assert int(auxs["__err_lattice_dropped"]) == 0

    mesh = make_z_mesh()

    @jax.jit
    def run(X0, ov0, n, dt, cs, fp, gen_args):
        return lattice_sharded_heun_steps(
            mesh, 4, 2, clipped_spring, friction_w_neighbour, "com",
            gs, C, zb, X0, ov0, n, dt, cs, fp,
            gen=gen_static, gen_args=gen_args)

    Xm, ovm, auxm = run(X0, ov0, *args, gen.args)
    assert int(auxm["__err_lattice_dropped"]) == 0
    for f in ("x", "y", "z"):
        a = np.asarray(getattr(Xs, f))[:n]
        b = np.asarray(getattr(Xm, f))[:n]
        assert np.allclose(a, b, atol=5e-5), \
            f"resident sharded links diverge in {f}: {np.abs(a - b).max()}"


def test_sharded_lattice_engine_with_links():
    """ShardedLatticeEngine composes with the generic integrator: links
    (generic forces) + friction mixing + COM fix reproduce the single-chip
    trajectory over the 8-device ring (multi-chip protrusion models)."""
    from yalla_tpu.links import Links, link_forces
    from yalla_tpu.parallel.lattice_spmd import (ShardedLatticeEngine,
                                                 make_z_mesh)
    from yalla_tpu.solvers import heun_steps

    n = 4_000
    n_pad = 4_096
    gs, C = 16, 16
    rng = np.random.default_rng(21)
    side = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_pad]
    pos = (g - side / 2) * 0.8 + rng.uniform(-0.15, 0.15, (len(g), 3))
    pos = np.concatenate(
        [pos, np.zeros((max(0, n_pad - len(pos)), 3))])[:n_pad]
    X0 = Float3(x=jnp.asarray(pos[:, 0], jnp.float32),
                y=jnp.asarray(pos[:, 1], jnp.float32),
                z=jnp.asarray(pos[:, 2], jnp.float32))
    ov0 = Float3.zeros(n_pad)
    links = Links(n // 2, strength=0.2, seed=5)
    links.h_a[:n // 2] = rng.integers(0, n, n // 2)
    links.h_b[:n // 2] = rng.integers(0, n, n // 2)
    links.copy_to_device()
    gen = link_forces(links)
    gen_static = gen._replace(args=None)
    args = (jnp.int32(n), jnp.float32(0.1), jnp.float32(1.0), jnp.int32(0),
            gen.args)

    from yalla_tpu.solvers import TileEngine
    Xr, ovr, auxr = heun_steps(4, TileEngine(), clipped_spring,
                               friction_w_neighbour, gen_static, "com",
                               X0, ov0, *args)

    mesh = make_z_mesh()
    eng = ShardedLatticeEngine(mesh=mesh, grid_size=gs, capacity=C,
                               z_block=2)
    Xm, ovm, auxm = heun_steps(4, eng, clipped_spring,
                               friction_w_neighbour, gen_static, "com",
                               X0, ov0, *args)
    assert float(auxm["__err_lattice_dropped"]) == 0
    for f in ("x", "y", "z"):
        a = np.asarray(getattr(Xr, f))[:n]
        b = np.asarray(getattr(Xm, f))[:n]
        assert np.allclose(a, b, atol=5e-5), \
            f"sharded engine + links diverges in {f}: {np.abs(a - b).max()}"
