"""Fast-path equivalence tests: the Cartesian precomputed-trig polarity
forces and the dense lattice engine must reproduce the reference-form
implementations exactly (same math, different evaluation order)."""
import jax
import jax.numpy as jnp
import numpy as np

from helpers import isclose
from yalla_tpu import Float3, Po_cell, Solution
from yalla_tpu.inits import random_sphere
from yalla_tpu.ops.common import friction_w_neighbour
from yalla_tpu.ops.lattice_xla import lattice_heun_steps
from yalla_tpu.polarity import (bending_force, bending_force_fast,
                                polarity_precompute)

rng = np.random.default_rng(31)


def test_bending_fast_equivalence():
    n = 256
    th = np.arccos(2 * rng.random(n) - 1).astype(np.float32)
    ph = (rng.random(n) * 2 * np.pi - np.pi).astype(np.float32)
    # include near-pole cases (the gimbal guard path)
    th[:8] = np.array([0, 1e-12, np.pi, np.pi - 1e-12, 0, 0, 1e-8, 3e-11])
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    Xi = Po_cell(x=jnp.asarray(xyz[:, 0]), y=jnp.asarray(xyz[:, 1]),
                 z=jnp.asarray(xyz[:, 2]), theta=jnp.asarray(th),
                 phi=jnp.asarray(ph))
    r_np = rng.normal(size=(n, 3)).astype(np.float32)
    dist = jnp.asarray(np.linalg.norm(r_np, axis=1))

    # reference-form (per-pair trig)
    rth = jnp.asarray(rng.normal(size=n).astype(np.float32) * 0.3)
    rph = jnp.asarray(rng.normal(size=n).astype(np.float32) * 0.3)
    r = Po_cell(x=jnp.asarray(r_np[:, 0]), y=jnp.asarray(r_np[:, 1]),
                z=jnp.asarray(r_np[:, 2]), theta=rth, phi=rph)
    ref = bending_force(Xi, r, dist)

    # fast path: augment with precomputed trig; r's aug components are
    # p(Xi) - p(Xj) with Xj = Xi - r, as the engines would compute them
    from yalla_tpu.dtypes import make_pt
    aug_i = polarity_precompute(Xi, n)
    Xj = Po_cell(x=Xi.x - r.x, y=Xi.y - r.y, z=Xi.z - r.z,
                 theta=Xi.theta - r.theta, phi=Xi.phi - r.phi)
    aug_j = polarity_precompute(Xj, n)
    AugT = make_pt("PoAug", "theta", "phi", *aug_i.keys())
    Xi_a = AugT(*Xi, *aug_i.values())
    r_a = AugT(*r, *(aug_i[k] - aug_j[k] for k in aug_i))
    fast = bending_force_fast(Xi_a, r_a, dist)

    for f in ("x", "y", "z", "theta", "phi"):
        a = np.asarray(getattr(ref, f))
        b = np.asarray(getattr(fast, f))
        assert np.allclose(a, b, atol=5e-5, rtol=1e-4), \
            f"bending fast path differs in {f}: {np.abs(a-b).max()}"


def test_apical_constriction_fast_equivalence():
    from yalla_tpu.dtypes import make_pt
    from yalla_tpu.polarity import (apical_constriction_force,
                                    apical_constriction_force_fast)
    n = 128
    gen = np.random.default_rng(32)
    th = np.arccos(2 * gen.random(n) - 1).astype(np.float32)
    ph = (gen.random(n) * 2 * np.pi - np.pi).astype(np.float32)
    xyz = gen.normal(size=(n, 3)).astype(np.float32)
    Xi = Po_cell(x=jnp.asarray(xyz[:, 0]), y=jnp.asarray(xyz[:, 1]),
                 z=jnp.asarray(xyz[:, 2]), theta=jnp.asarray(th),
                 phi=jnp.asarray(ph))
    r_np = gen.normal(size=(n, 3)).astype(np.float32)
    dist = jnp.asarray(np.linalg.norm(r_np, axis=1))
    r = Po_cell(x=jnp.asarray(r_np[:, 0]), y=jnp.asarray(r_np[:, 1]),
                z=jnp.asarray(r_np[:, 2]),
                theta=jnp.asarray(gen.normal(size=n).astype(np.float32) * .3),
                phi=jnp.asarray(gen.normal(size=n).astype(np.float32) * .3))
    pref = np.pi / 2 - 20 * np.pi / 180
    ref = apical_constriction_force(Xi, r, dist, pref)

    aug_i = polarity_precompute(Xi, n)
    Xj = Po_cell(x=Xi.x - r.x, y=Xi.y - r.y, z=Xi.z - r.z,
                 theta=Xi.theta - r.theta, phi=Xi.phi - r.phi)
    aug_j = polarity_precompute(Xj, n)
    AugT = make_pt("PoAug", "theta", "phi", *aug_i.keys())
    Xi_a = AugT(*Xi, *aug_i.values())
    r_a = AugT(*r, *(aug_i[k] - aug_j[k] for k in aug_i))
    fast = apical_constriction_force_fast(Xi_a, r_a, dist, pref)

    for f in ("x", "y", "z", "theta", "phi"):
        a = np.asarray(getattr(ref, f))
        b = np.asarray(getattr(fast, f))
        assert np.allclose(a, b, atol=5e-5, rtol=1e-4), \
            f"apical fast path differs in {f}: {np.abs(a-b).max()}"


def _spring(Xi, r, dist, i, j):
    valid = (i != j) & (dist < 1.0)
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(valid, (0.5 - dist) / safe, 0.0)
    return jax.tree.map(lambda a: jnp.zeros_like(w), Xi)._replace(
        x=r.x * w, y=r.y * w, z=r.z * w)


def test_lattice_matches_tile():
    """Dense lattice engine (exact rebuild mode) vs all-pairs oracle."""
    n = 50
    tile = Solution(Float3, n, solver="tile")
    random_sphere(0.733333, tile, rng=np.random.default_rng(77))
    X0, ov0 = tile.d_X, tile.d_old_v
    for _ in range(5):
        tile.take_step(0.1, _spring)
    ht = tile.copy_to_host()

    X, ov, aux = lattice_heun_steps(
        5, 1, _spring, friction_w_neighbour, "com", 16, 32, 4,
        X0, ov0, jnp.int32(n), jnp.float32(0.1), jnp.float32(1.0),
        jnp.int32(0))
    assert isclose(np.asarray(X.x)[:n], ht.x[:n]), "lattice disagrees in x"
    assert isclose(np.asarray(X.y)[:n], ht.y[:n]), "lattice disagrees in y"
    assert isclose(np.asarray(X.z)[:n], ht.z[:n]), "lattice disagrees in z"


def test_lattice_resident_mode():
    """rebuild_every > 1 stays finite and close for vanishing-at-cutoff
    forces (relu band)."""
    from yalla_tpu.inits import relu_force
    n = 100
    pts = Solution(Float3, n, solver="tile")
    random_sphere(0.8, pts, rng=np.random.default_rng(79))
    X0, ov0 = pts.d_X, pts.d_old_v
    for _ in range(8):
        pts.take_step(0.1, relu_force)
    ht = pts.copy_to_host()

    X, ov, aux = lattice_heun_steps(
        8, 4, relu_force, friction_w_neighbour, "com", 16, 16, 4,
        X0, ov0, jnp.int32(n), jnp.float32(0.1), jnp.float32(1.0),
        jnp.int32(0))
    xs = np.asarray(X.x)[:n]
    assert np.isfinite(xs).all()
    # relu_force vanishes smoothly at dist=1 -> stale binning error stays
    # small relative to the motion scale (~unit cell distances)
    assert np.abs(xs - ht.x[:n]).max() < 0.05


def test_lattice_gen_forces_match_tile():
    """Generic forces (links) inside the lattice-resident loop match the
    tile oracle -- the reference feeds link forces through the same hook
    on every solver (links.cuh:128-140, solvers.cuh:43-53)."""
    from yalla_tpu.links import Links, link_forces
    from yalla_tpu.solvers import LatticeEngine

    n = 96
    gen = np.random.default_rng(8)

    def relu_force(Xi, r, dist, i, j):
        near = (i != j) & (dist < 1.0)
        F = jnp.maximum(0.7 - dist, 0) * 2 - jnp.maximum(dist - 0.8, 0)
        safe = jnp.where(dist > 0, dist, 1.0)
        w = jnp.where(near, F / safe, 0.0)
        return Float3(x=r.x * w, y=r.y * w, z=r.z * w)

    la = gen.integers(0, n, n // 2)
    lb = gen.integers(0, n, n // 2)

    def make_links():
        links = Links(n // 2, strength=0.25, seed=5)
        links.h_a[:n // 2] = la
        links.h_b[:n // 2] = lb
        links.copy_to_device()
        return links

    sol_t = Solution(Float3, n, solver="tile")
    random_sphere(0.6, sol_t, rng=np.random.default_rng(7))
    start = np.stack([np.array(sol_t.h_X.x), np.array(sol_t.h_X.y),
                      np.array(sol_t.h_X.z)])

    links = make_links()
    for _ in range(4):
        sol_t.take_step(0.1, relu_force, gen_forces=link_forces(links))
    ref = np.stack([np.asarray(sol_t.d_X.x), np.asarray(sol_t.d_X.y),
                    np.asarray(sol_t.d_X.z)])[:, :n]

    def run_lattice(rebuild_every):
        sol_l = Solution(
            Float3, n, cube_size=1.0,
            engine=LatticeEngine(grid_size=16, capacity=16, z_block=2,
                                 rebuild_every=rebuild_every))
        sol_l.h_X.x[:], sol_l.h_X.y[:], sol_l.h_X.z[:] = start
        sol_l.copy_to_device()
        sol_l.take_steps(4, 0.1, relu_force,
                         gen_forces=link_forces(make_links()))
        return np.stack([np.asarray(sol_l.d_X.x), np.asarray(sol_l.d_X.y),
                         np.asarray(sol_l.d_X.z)])[:, :n]

    # per-pass rebuild is reference-exact: must match the tile oracle
    got = run_lattice(1)
    assert np.allclose(ref, got, atol=2e-5), (
        f"lattice(rebuild=1) diverges from tile with links: "
        f"{np.abs(ref - got).max()}")
    # resident mode (rebuild_every=4): vs tile only the pair binning
    # staleness differs
    a = run_lattice(4)
    assert np.allclose(ref, a, atol=0.05), (
        f"resident lattice links path unphysically far from tile: "
        f"{np.abs(ref - a).max()}")


def test_migration_fast_equivalence():
    from yalla_tpu.dtypes import make_pt
    from yalla_tpu.polarity import migration_force, migration_force_fast
    n = 128
    gen = np.random.default_rng(33)
    th = np.arccos(2 * gen.random(n) - 1).astype(np.float32)
    ph = (gen.random(n) * 2 * np.pi - np.pi).astype(np.float32)
    th[:4] = 0.0  # unset-polarity branch
    ph[:4] = 0.0
    xyz = gen.normal(size=(n, 3)).astype(np.float32)
    Xi = Po_cell(x=jnp.asarray(xyz[:, 0]), y=jnp.asarray(xyz[:, 1]),
                 z=jnp.asarray(xyz[:, 2]), theta=jnp.asarray(th),
                 phi=jnp.asarray(ph))
    r_np = gen.normal(size=(n, 3)).astype(np.float32)
    dist = jnp.asarray(np.linalg.norm(r_np, axis=1))
    r = Po_cell(x=jnp.asarray(r_np[:, 0]), y=jnp.asarray(r_np[:, 1]),
                z=jnp.asarray(r_np[:, 2]),
                theta=jnp.asarray(gen.normal(size=n).astype(np.float32) * .3),
                phi=jnp.asarray(gen.normal(size=n).astype(np.float32) * .3))
    ref = migration_force(Xi, r, dist)

    aug_i = polarity_precompute(Xi, n)
    Xj = Po_cell(x=Xi.x - r.x, y=Xi.y - r.y, z=Xi.z - r.z,
                 theta=Xi.theta - r.theta, phi=Xi.phi - r.phi)
    aug_j = polarity_precompute(Xj, n)
    AugT = make_pt("PoAugM", "theta", "phi", *aug_i.keys())
    Xi_a = AugT(*Xi, *aug_i.values())
    r_a = AugT(*r, *(aug_i[k] - aug_j[k] for k in aug_i))
    fast = migration_force_fast(Xi_a, r_a, dist)

    for f in ("x", "y", "z"):
        a = np.asarray(getattr(ref, f))
        b = np.asarray(getattr(fast, f))
        # the +-0.15 gates can flip for pairs sitting exactly on the
        # threshold under reordered f32 arithmetic; none in this draw
        assert np.allclose(a, b, atol=5e-5, rtol=1e-4), \
            f"migration fast path differs in {f}: {np.abs(a-b).max()}"


def test_bending_fast_second_axis():
    """The fast path composes with a second polarity axis (PCP, ref
    epithelia_double_polarity.cu:53): precompute with prefix='q' over
    (theta2, phi2) must match the reference form on that axis."""
    from yalla_tpu.dtypes import make_pt
    Pcp = make_pt("PcpCell", "theta", "phi", "theta2", "phi2")
    n = 128
    gen = np.random.default_rng(44)
    axis = ("theta2", "phi2")
    X = Pcp(x=jnp.asarray(gen.normal(size=n).astype(np.float32)),
            y=jnp.asarray(gen.normal(size=n).astype(np.float32)),
            z=jnp.asarray(gen.normal(size=n).astype(np.float32)),
            theta=jnp.zeros(n), phi=jnp.zeros(n),
            theta2=jnp.asarray(np.arccos(2 * gen.random(n) - 1)
                               .astype(np.float32)),
            phi2=jnp.asarray((gen.random(n) * 2 * np.pi - np.pi)
                             .astype(np.float32)))
    r_np = gen.normal(size=(n, 3)).astype(np.float32)
    dist = jnp.asarray(np.linalg.norm(r_np, axis=1))
    r = Pcp(x=jnp.asarray(r_np[:, 0]), y=jnp.asarray(r_np[:, 1]),
            z=jnp.asarray(r_np[:, 2]),
            theta=jnp.zeros(n), phi=jnp.zeros(n),
            theta2=jnp.asarray(gen.normal(size=n).astype(np.float32) * .3),
            phi2=jnp.asarray(gen.normal(size=n).astype(np.float32) * .3))
    ref = bending_force(X, r, dist, axis=axis)

    from yalla_tpu.dtypes import make_pt as mp
    aug_i = polarity_precompute(X, n, axis=axis, prefix="q")
    Xj = X.replace(**{f: getattr(X, f) - getattr(r, f)
                      for f in X._fields})
    aug_j = polarity_precompute(Xj, n, axis=axis, prefix="q")
    AugT = mp("PcpAug", *(list(X._fields[3:]) + list(aug_i.keys())))
    Xi_a = AugT(*X, *aug_i.values())
    r_a = AugT(*r, *(aug_i[k] - aug_j[k] for k in aug_i))
    fast = bending_force_fast(Xi_a, r_a, dist, axis=axis, p="q")

    for f in ("x", "y", "z", "theta2", "phi2"):
        a = np.asarray(getattr(ref, f))
        b = np.asarray(getattr(fast, f))
        assert np.allclose(a, b, atol=5e-5, rtol=1e-4), \
            f"PCP fast path differs in {f}: {np.abs(a-b).max()}"
    assert np.asarray(fast.theta).max() == 0  # first axis untouched


def test_resident_staleness_metric():
    """rebuild_every > 1 publishes the measured max in-chunk displacement
    (certifies the stale-binning approximation instead of assuming it)."""
    from yalla_tpu.inits import relu_force
    n = 80
    pts = Solution(Float3, n, solver="tile")
    random_sphere(0.8, pts, rng=np.random.default_rng(12))
    X, ov, aux = lattice_heun_steps(
        8, 4, relu_force, friction_w_neighbour, "com", 16, 16, 4,
        pts.d_X, pts.d_old_v, jnp.int32(n), jnp.float32(0.1),
        jnp.float32(1.0), jnp.int32(0))
    d = float(aux["stale_max_disp"])
    assert 0 < d < 0.5, f"staleness metric implausible: {d}"

def test_resident_staleness_flag():
    """With force_r_max given, rebuild_every > 1 self-certifies: a chunk
    whose motion could hide a just-entering pair inside the binning margin
    (2*disp > cube_size - r_max) raises __err_stale; a slow run does not."""
    from yalla_tpu.inits import relu_force
    n = 80
    pts = Solution(Float3, n, solver="tile")
    random_sphere(0.8, pts, rng=np.random.default_rng(12))

    def run(dt):
        # bin at 1.3 x the force's r_max = 1.0 -> margin 0.3
        return lattice_heun_steps(
            8, 4, relu_force, friction_w_neighbour, "com", 16, 16, 4,
            pts.d_X, pts.d_old_v, jnp.int32(n), jnp.float32(dt),
            jnp.float32(1.3), jnp.int32(0), None, None, None,
            jnp.float32(1.0))

    _, _, aux_slow = run(0.002)
    assert float(aux_slow["__err_stale"]) == 0.0, \
        f"slow run flagged stale (disp={float(aux_slow['stale_max_disp'])})"
    _, _, aux_fast = run(0.8)
    assert float(aux_fast["__err_stale"]) == 1.0, \
        f"fast run not flagged (disp={float(aux_fast['stale_max_disp'])})"


def test_resident_staleness_collective_flow_not_flagged():
    """A rigidly-rotating tissue has LARGE absolute displacement but
    closes no pair gaps: the shear-based certificate must stay clean
    where a 2*max|dX| bound would reject every chunk (the flagship's
    friction velocity mixing sustains exactly such collective flows)."""
    from yalla_tpu.ops.common import friction_w_neighbour

    def no_force(Xi, r, dist, i, j):
        return jax.tree.map(lambda a: jnp.zeros_like(dist), Xi)

    rng = np.random.default_rng(5)
    n, n_pad = 2000, 2048
    pos = rng.uniform(-1, 1, (n_pad, 3))
    pos = (pos / np.maximum(np.linalg.norm(pos, axis=1, keepdims=True),
                            1e-6)) * (6.3 * rng.random((n_pad, 1)) **
                                      (1 / 3))
    X = Float3(x=jnp.asarray(pos[:, 0], jnp.float32),
               y=jnp.asarray(pos[:, 1], jnp.float32),
               z=jnp.asarray(pos[:, 2], jnp.float32))
    # rigid rotation about z, carried by the friction velocity mixing
    w = 0.12
    ov = Float3(x=jnp.asarray(-w * pos[:, 1], jnp.float32),
                y=jnp.asarray(w * pos[:, 0], jnp.float32),
                z=jnp.zeros(n_pad, jnp.float32))
    X1, ov1, aux = lattice_heun_steps(
        4, 4, no_force, friction_w_neighbour, "com", 16, 24, 4,
        X, ov, jnp.int32(n), jnp.float32(0.1), jnp.float32(1.3),
        jnp.int32(0), None, None, None, jnp.float32(1.0))
    d = float(aux["stale_max_disp"])
    margin = 1.3 - 1.0
    assert 2 * d > margin, \
        f"rotation too slow to discriminate the bounds (disp={d})"
    assert float(aux["__err_stale"]) == 0.0, \
        f"collective rotation falsely flagged stale (disp={d})"


def test_resident_staleness_radial_flow_not_flagged():
    """A radially-expanding ball (the settling flagship tissue's literal
    flow pattern) moves its rim by several binning margins per chunk but
    only OPENS pair gaps: the per-evaluation-state gap certificate stays
    clean.  Running chunk-wide extrema would compare an inner cube's
    end-of-chunk max against an outer cube's start-of-chunk min and eat
    the whole margin (measured 0.4 closure per 4-step chunk at 500k)."""
    from yalla_tpu.ops.common import friction_w_neighbour

    def no_force(Xi, r, dist, i, j):
        return jax.tree.map(lambda a: jnp.zeros_like(dist), Xi)

    gen = np.random.default_rng(9)
    n, n_pad = 2000, 2048
    pos = gen.uniform(-1, 1, (n_pad, 3))
    pos = (pos / np.maximum(np.linalg.norm(pos, axis=1, keepdims=True),
                            1e-6)) * (5.0 * gen.random((n_pad, 1)) **
                                      (1 / 3))
    X = Float3(x=jnp.asarray(pos[:, 0], jnp.float32),
               y=jnp.asarray(pos[:, 1], jnp.float32),
               z=jnp.asarray(pos[:, 2], jnp.float32))
    # radial outflow carried by the friction velocity mixing; rim speed
    # 0.75 -> ~0.3 rim displacement per 4-step chunk at dt=0.1, far past
    # the 0.1 binning margin of cube 1.1 / r_max 1.0
    ov = jax.tree.map(lambda a: 0.15 * a, X)
    _, _, aux = lattice_heun_steps(
        4, 4, no_force, friction_w_neighbour, "com", 16, 24, 4,
        X, ov, jnp.int32(n), jnp.float32(0.1), jnp.float32(1.1),
        jnp.int32(0), None, None, None, jnp.float32(1.0))
    d = float(aux["stale_max_disp"])
    assert 2 * d > 1.1 - 1.0, \
        f"expansion too slow to discriminate the bounds (disp={d})"
    assert float(aux["__err_out_of_grid"]) == 0.0
    assert float(aux["__err_stale"]) == 0.0, (
        f"radial expansion falsely flagged stale (disp={d}, "
        f"closure={float(aux['stale_shear_closure'])})")


def test_resident_staleness_lateral_slip_not_flagged():
    """Two rigid plates two z-cubes apart (z-gap > r_max: they can never
    interact) slide past each other in x by several cube sizes per
    chunk.  Their x-gaps across the 2-cube z offset close and reopen
    constantly, but interaction would also need the z-gap to close --
    the per-axis certificate with +-1 lateral pooling plus the
    min-of-two-gaps diagonal term must stay clean (the round-3 +-2
    lateral pool charged exactly this slip as staleness)."""
    from yalla_tpu.ops.common import friction_w_neighbour

    def no_force(Xi, r, dist, i, j):
        return jax.tree.map(lambda a: jnp.zeros_like(dist), Xi)

    gen = np.random.default_rng(11)
    n, n_pad = 1024, 1024
    half = n // 2
    xy = gen.uniform(-4.0, 4.0, (n_pad, 2))
    # cube 0.8, r_max 0.55 (margin 0.25): plates in z-cubes 0 and 2,
    # z-gap 1.54 > r_max forever
    z = np.where(np.arange(n_pad) < half, 0.44, 1.98)
    X = Float3(x=jnp.asarray(xy[:, 0], jnp.float32),
               y=jnp.asarray(xy[:, 1], jnp.float32),
               z=jnp.asarray(z, jnp.float32))
    # top plate slides +x by 0.5 per chunk (2x the margin; below the
    # >=3-apart displacement fallback threshold 2*cube - r_max = 1.05),
    # carried by the friction velocity mixing (plates internally rigid)
    ov = Float3(x=jnp.asarray(np.where(np.arange(n_pad) < half, 0.0, 0.25),
                              jnp.float32),
                y=jnp.zeros(n_pad, jnp.float32),
                z=jnp.zeros(n_pad, jnp.float32))
    _, _, aux = lattice_heun_steps(
        4, 4, no_force, friction_w_neighbour, "point", 24, 24, 4,
        X, ov, jnp.int32(n), jnp.float32(0.5), jnp.float32(0.8),
        jnp.int32(0), None, None, None, jnp.float32(0.55))
    d = float(aux["stale_max_disp"])
    assert 2 * d > 0.8 - 0.55, f"slip too slow to discriminate (disp={d})"
    assert 2 * d < 2 * 0.8 - 0.55, f"slip trips the >=3-apart fallback"
    assert float(aux["__err_out_of_grid"]) == 0.0
    assert float(aux["__err_stale"]) == 0.0, (
        f"pure lateral slip falsely flagged (disp={d}, "
        f"closure={float(aux['stale_shear_closure'])})")


def test_resident_staleness_diagonal_escape_flagged():
    """A pair approaching through the DIAGONAL escape (2 cubes apart in
    both x and z, both gaps closing below r_max) must flag: the
    min-of-two-gaps term is what keeps the +-1 lateral pooling sound."""
    from yalla_tpu.ops.common import friction_w_neighbour

    def no_force(Xi, r, dist, i, j):
        return jax.tree.map(lambda a: jnp.zeros_like(dist), Xi)

    n_pad = 64
    # two cell pairs binned (2, 0, 2) cubes apart in (x, y, z) at cube
    # 1.1, approaching diagonally by 0.25/axis each (axis gaps 1.2 ->
    # 0.7 < r_max) -- per-cell displacement 0.35, far below the
    # >=3-apart fallback threshold (2*cube - r_max)/2 = 0.6, so ONLY the
    # min-of-two-gaps diagonal term can catch this.  Buddies at +0.5 y
    # carry the velocity through the friction mixing.
    pos = np.zeros((n_pad, 3), np.float32)
    pos[0] = [1.05, 0.0, 1.05]
    pos[1] = [1.05, 0.5, 1.05]           # buddy of 0
    pos[2] = [2.25, 0.0, 2.25]
    pos[3] = [2.25, 0.5, 2.25]           # buddy of 2
    v = np.zeros((n_pad, 3), np.float32)
    v[:2] = [0.0625, 0.0, 0.0625]
    v[2:4] = [-0.0625, 0.0, -0.0625]
    X = Float3(x=jnp.asarray(pos[:, 0]), y=jnp.asarray(pos[:, 1]),
               z=jnp.asarray(pos[:, 2]))
    ov = Float3(x=jnp.asarray(v[:, 0]), y=jnp.asarray(v[:, 1]),
                z=jnp.asarray(v[:, 2]))
    _, _, aux = lattice_heun_steps(
        4, 4, no_force, friction_w_neighbour, "point", 16, 8, 4,
        X, ov, jnp.int32(4), jnp.float32(1.0), jnp.float32(1.1),
        jnp.int32(0), None, None, None, jnp.float32(1.0))
    d = float(aux["stale_max_disp"])
    assert 2 * d < 2 * 1.1 - 1.0, "fallback fired; test must isolate " \
        "the diagonal term"
    assert float(aux["__err_stale"]) == 1.0, (
        f"diagonal escape not flagged "
        f"(closure={float(aux['stale_shear_closure'])}, disp={d})")


def test_rebin_resident_matches_stable_resident():
    """rebin_m_cap > 0 (lattice-resident slot-space rebinning) must match
    the stable-resident chunk path to f32 roundoff, flags clean."""
    from yalla_tpu.inits import relu_force
    from yalla_tpu.ops.common import friction_w_neighbour

    rng = np.random.default_rng(0)
    n, n_pad = 1200, 1280
    pos = rng.uniform(-4, 4, (n_pad, 3)).astype(np.float32)
    X = Float3(x=jnp.asarray(pos[:, 0]), y=jnp.asarray(pos[:, 1]),
               z=jnp.asarray(pos[:, 2]))
    ov = Float3.zeros(n_pad)
    common = (relu_force, friction_w_neighbour, "com", 16, 16, 2, X, ov,
              jnp.int32(n), jnp.float32(0.01), jnp.float32(1.2),
              jnp.int32(0), None, None, None, jnp.float32(1.0))
    ref = lattice_heun_steps(8, 4, *common)
    for rebuild in (4, 1):
        out = lattice_heun_steps(8, rebuild, *common, 2048)
        for k, v in out[2].items():
            if k.startswith("__err"):
                assert float(np.max(v)) == 0.0, (rebuild, k)
        d = max(float(jnp.max(jnp.abs(a - b))) for a, b in
                zip(jax.tree.leaves(out[0])[:3],
                    jax.tree.leaves(ref[0])[:3]))
        assert d < 1e-5, (rebuild, d)


def test_rebin_per_pass_matches_per_pass_build():
    """rebin_per_pass=True (slot-resident state, binning re-derived
    before EVERY pairwise pass with the predictor derivative transported
    through the rebin permutation) must match the chunk_exact path --
    both are reference-exact cadences (solvers.cuh:494), differing only
    in slot assignment within a cube (f32 reduction order)."""
    from yalla_tpu.inits import relu_force
    from yalla_tpu.ops.common import friction_w_neighbour

    rng = np.random.default_rng(0)
    n, n_pad = 1200, 1280
    pos = rng.uniform(-4, 4, (n_pad, 3)).astype(np.float32)
    X = Float3(x=jnp.asarray(pos[:, 0]), y=jnp.asarray(pos[:, 1]),
               z=jnp.asarray(pos[:, 2]))
    ov = Float3.zeros(n_pad)
    common = (relu_force, friction_w_neighbour, "com", 16, 16, 2, X, ov,
              jnp.int32(n), jnp.float32(0.01), jnp.float32(1.2),
              jnp.int32(0), None, None, None, jnp.float32(1.0))
    ref = lattice_heun_steps(8, 1, *common)
    out = lattice_heun_steps(8, 1, *common, 2048, True)
    for k, v in out[2].items():
        if k.startswith("__err"):
            assert float(np.max(v)) == 0.0, (k, float(np.max(v)))
    d = max(float(jnp.max(jnp.abs(a - b))) for a, b in
            zip(jax.tree.leaves(out[0])[:3], jax.tree.leaves(ref[0])[:3]))
    dov = max(float(jnp.max(jnp.abs(a - b))) for a, b in
              zip(jax.tree.leaves(out[1]), jax.tree.leaves(ref[1])))
    assert d < 1e-5 and dov < 1e-5, (d, dov)
