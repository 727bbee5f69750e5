"""Port of the reference's integrator/engine tests
(``tests/test_solvers.cu``): Heun accuracy, equilibrium
fixed points, COM conservation, tile-vs-grid consistency, friction
semantics, spatial-hash structure, and Gabriel neighbour counts."""
import jax
import jax.numpy as jnp
import numpy as np

from helpers import center_of_mass, isclose
from yalla_tpu import (Float3, Float4, GenericForce, Solution,
                       friction_on_background)
from yalla_tpu.inits import random_sphere, regular_hexagon, set_seed
from yalla_tpu.ops.grid_xla import build_grid, row_ranges

set_seed(12345)

L_0 = 0.5


def oscillator(Xi, r, dist, i, j):
    """Antisymmetric coupling in w -> harmonic oscillator
    (ref test_solvers.cu:8-16)."""
    sign = jnp.where(i == j, 0.0, jnp.where(i == 0, 1.0, -1.0))
    Xj = Xi - r
    return jax.tree.map(lambda a: sign * a, Xj)


def clipped_spring(Xi, r, dist, i, j):
    valid = (i != j) & (dist < 1.0)
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(valid, (L_0 - dist) / safe, 0.0)
    return jax.tree.map(lambda a: jnp.zeros_like(w), Xi)._replace(
        x=r.x * w, y=r.y * w, z=r.z * w)


def no_pw_int(Xi, r, dist, i, j):
    return jax.tree.map(lambda a: jnp.zeros_like(dist), Xi)


def test_oscillation():
    osc = Solution(Float4, 2, solver="tile")
    osc.h_X.w[0] = 1.0
    osc.h_X.w[1] = 0.0
    osc.copy_to_device()
    n_steps = 100
    for _ in range(n_steps):
        osc.take_step(2 * np.pi / n_steps, oscillator)
        h = osc.copy_to_host()
        assert isclose(h.w[0] ** 2 + h.w[1] ** 2, 1.0), "Oscillator off circle"
    assert isclose(osc.h_X.w[0], 1.0), "Oscillator final cosine"


def _tetrahedron(solver):
    pts = Solution(Float3, 4, solver=solver)
    random_sphere(L_0, pts)
    com_i = center_of_mass(pts)
    pts.take_steps(500, 0.1, clipped_spring)
    h = pts.copy_to_host()
    for i in range(1, 4):
        d = np.sqrt((h.x[0] - h.x[i]) ** 2 + (h.y[0] - h.y[i]) ** 2
                    + (h.z[0] - h.z[i]) ** 2)
        assert isclose(d, L_0), f"Spring not relaxed in {solver} tetrahedron"
    com_f = center_of_mass(pts)
    assert all(isclose(a, b) for a, b in zip(com_i, com_f)), \
        f"Momentum not conserved in {solver} tetrahedron"


def test_tile_tetrahedron():
    _tetrahedron("tile")


def test_grid_tetrahedron():
    _tetrahedron("grid")


def test_compare_methods():
    """Tile, grid, and lattice engines must agree point by point on the
    same IC (ref test_solvers.cu:102-125, extended to all engines)."""
    from yalla_tpu.solvers import LatticeEngine
    n = 50
    tile = Solution(Float3, n, solver="tile")
    others = {"grid": Solution(Float3, n, solver="grid"),
              # the 50-cell ball is dense: give the lattice enough
              # per-cube capacity for the compact IC
              "lattice": Solution(Float3, n, engine=LatticeEngine(
                  grid_size=16, capacity=32, z_block=2))}
    random_sphere(0.733333, tile)
    for o in others.values():
        o.h_X.x[:] = tile.h_X.x
        o.h_X.y[:] = tile.h_X.y
        o.h_X.z[:] = tile.h_X.z
        o.copy_to_device()
    for _ in range(2):
        tile.take_step(0.1, clipped_spring)
        for o in others.values():
            o.take_step(0.1, clipped_spring)
    ht = tile.copy_to_host()
    for name, o in others.items():
        hg = o.copy_to_host()
        assert isclose(ht.x[:n], hg.x[:n]), f"{name} disagrees in x"
        assert isclose(ht.y[:n], hg.y[:n]), f"{name} disagrees in y"
        assert isclose(ht.z[:n], hg.z[:n]), f"{name} disagrees in z"


def _push(X, n):
    """dX[1] = (1, 0, 0) (ref test_solvers.cu:133-144)."""
    dX = jax.tree.map(jnp.zeros_like, X)
    return dX._replace(x=dX.x.at[1].set(1.0))


def test_generic_forces():
    for solver, pw in (("tile", no_pw_int), ("grid", clipped_spring)):
        pts = Solution(Float3, 2, solver=solver)
        pts.h_X.x[:2] = [0, 0]
        pts.h_X.y[:2] = [0, 0]
        pts.h_X.z[:2] = [10, 0]
        pts.copy_to_device()
        com_i = center_of_mass(pts)
        pts.take_step(1.0, pw, gen_forces=_push)
        h = pts.copy_to_host()
        com_f = center_of_mass(pts)
        assert all(isclose(a, b) for a, b in zip(com_i, com_f)), \
            "Momentum not conserved under generic force"
        assert isclose(h.x[1], 0.5), f"{solver} generic force failed in x"
        assert isclose(h.y[1], 0.0)
        assert isclose(h.z[1], 0.0)


def test_friction():
    """Unit push moves a point 1.0 against the background; with neighbour
    friction, momentum sharing gives 0.75 (ref test_solvers.cu:186-225)."""
    for solver in ("tile", "grid"):
        pts = Solution(Float3, 2, solver=solver)
        pts.h_X.x[:2] = [0.0, 0.5]
        pts.h_X.y[:2] = 0
        pts.h_X.z[:2] = 0
        pts.copy_to_device()
        for _ in range(10):
            pts.take_step(0.05, no_pw_int,
                          pw_friction=friction_on_background,
                          gen_forces=_push)
        h = pts.copy_to_host()
        assert isclose(h.x[1] - h.x[0], 1.0), f"{solver} background friction"

        pts.h_X.x[:2] = [0.0, 0.5]
        pts.copy_to_device()  # old_v carries over, exactly like the reference
        for _ in range(10):
            pts.take_step(0.05, no_pw_int, gen_forces=_push)
        h = pts.copy_to_host()
        assert isclose(h.x[1] - h.x[0], 0.75), f"{solver} neighbour friction"


def test_fix_point():
    pts = Solution(Float3, 100, solver="tile")
    random_sphere(0.733333, pts)
    fix_point = 13
    pts.h_X.x[fix_point] = 0
    pts.h_X.y[fix_point] = 0
    pts.h_X.z[fix_point] = 0
    pts.copy_to_device()
    pts.set_fixed(fix_point)
    pts.take_step(0.1, clipped_spring)
    h = pts.copy_to_host()
    assert isclose(h.x[fix_point], 0), "Fixed point moved in x"
    assert isclose(h.y[fix_point], 0), "Fixed point moved in y"
    assert isclose(h.z[fix_point], 0), "Fixed point moved in z"


def test_fix_point_xy():
    """``set_fixed_xy``: the pinned point's x/y never move while z follows
    the COM-fixed dynamics (ref solvers.cuh:204-208, 240-253).  Pins the
    documented deviation: we apply the predictor rule (point-xy + COM-z) in
    BOTH Heun passes, where the reference's corrector falls back to fixing
    full xyz (solvers.cuh:265-272)."""
    import numpy as np
    pts = Solution(Float3, 100, solver="tile")
    random_sphere(0.733333, pts)
    fix_point = 7
    pts.h_X.x[fix_point] = 0.125
    pts.h_X.y[fix_point] = -0.25
    pts.copy_to_device()
    pts.set_fixed_xy(fix_point)
    h0 = pts.copy_to_host()
    com_z0 = float(np.mean(h0.z[:100]))
    for _ in range(5):
        pts.take_step(0.1, clipped_spring)
    h = pts.copy_to_host()
    assert isclose(h.x[fix_point], 0.125), "set_fixed_xy moved the pin in x"
    assert isclose(h.y[fix_point], -0.25), "set_fixed_xy moved the pin in y"
    # z is COM-fixed, not point-fixed: the COM must be conserved while the
    # pinned point itself is free to move in z
    assert isclose(float(np.mean(h.z[:100])), com_z0), "COM z drifted"


def test_grid_structure():
    """7x7x7 unit lattice: cube ids match the reference formula and the
    row-gathered neighbourhood equals the brute-force 27-cube set
    (ref test_solvers.cu:247-315)."""
    n_x = n_y = n_z = 7
    n = n_x * n_y * n_z
    pts = Solution(Float3, n, solver="grid", grid_size=70)
    for i in range(n_z):
        for j in range(n_y):
            for k in range(n_x):
                idx = n_x * n_y * i + n_x * j + k
                pts.h_X.x[idx] = k + 0.5
                pts.h_X.y[idx] = j + 0.5
                pts.h_X.z[idx] = i + 0.5
    pts.copy_to_device()

    gs = 70
    bg = jax.jit(build_grid, static_argnames=("grid_size",))
    grid = bg(pts.d_X, pts.d_n, jnp.float32(1.0), grid_size=gs)
    origin = gs ** 3 // 2 + gs ** 2 // 2 + gs // 2
    cid = np.asarray(grid.cid)
    for i in range(n_z):
        for j in range(n_y):
            for k in range(n_x):
                idx = n_x * n_y * i + n_x * j + k
                assert cid[idx] == origin + k + gs * j + gs * gs * i

    # With cube_size=1 each cube holds exactly one point
    order = np.asarray(grid.order)
    rr = jax.jit(row_ranges, static_argnames=("grid_size",))(
        grid, grid.cid, grid_size=gs)
    rs, re = np.asarray(rr[0]), np.asarray(rr[1])
    x, y, z = pts.h_X.x, pts.h_X.y, pts.h_X.z
    for idx in (0, 171, 342, 100):
        cands = set()
        for row in range(9):
            for p in range(rs[idx, row], re[idx, row] + 1):
                cands.add(int(order[p]))
        brute = {
            other for other in range(n)
            if max(abs(np.floor(x[idx]) - np.floor(x[other])),
                   abs(np.floor(y[idx]) - np.floor(y[other])),
                   abs(np.floor(z[idx]) - np.floor(z[other]))) <= 1
        }
        assert cands == brute, f"27-cube neighbourhood wrong for point {idx}"

    # cube_size=2: points group in 2x2x2 blocks
    grid2 = bg(pts.d_X, pts.d_n, jnp.float32(2.0), grid_size=gs)
    cid2 = np.asarray(grid2.cid)
    for i in range(n_z):
        for j in range(n_y):
            for k in range(n_x):
                idx = n_x * n_y * i + n_x * j + k
                expected = (gs ** 3 // 2 + gs ** 2 // 2 + gs // 2
                            + k // 2 + gs * (j // 2) + gs * gs * (i // 2))
                assert cid2[idx] == expected


def test_cube_size():
    pts = Solution(Float3, 2, solver="grid")
    pts.h_X.x[:2] = [0.0, 0.75]
    pts.h_X.y[:2] = 0
    pts.h_X.z[:2] = 0
    pts.copy_to_device()

    pts.cube_size = 0.5
    pts.take_step(0.1, clipped_spring)
    h = pts.copy_to_host()
    assert h.x[0] == 0, "Cell outside cube moved"

    pts.cube_size = 1.0
    pts.take_step(0.1, clipped_spring)
    h = pts.copy_to_host()
    assert h.x[0] != 0, "Cell inside cube did not move"


def count_neighbours(Xi, r, dist, i, j):
    dF = jax.tree.map(lambda a: jnp.zeros_like(dist), Xi)
    nbs = jnp.where((i != j) & (dist <= 1.0), 1.0, 0.0)
    return dF, {"n_nbs": nbs}


def test_gabriel_solver():
    """Hexagonal lattice: interior points have exactly 6 Gabriel
    neighbours, boundary alternates 3/4 (ref test_solvers.cu:354-381)."""
    pts = Solution(Float3, 19, solver="gabriel", grid_size=5, cube_size=1.0,
                   gabriel_coefficient=0.8, row_cap=32)
    regular_hexagon(0.5, pts)
    aux = pts.take_step(0.1, count_neighbours)
    n_nbs = np.asarray(aux["n_nbs"]).astype(int)
    for i in range(7):
        assert n_nbs[i] == 6, f"Wrong number of neighbours at {i}: {n_nbs[i]}"
    for i in range(7, 19):
        expected = 3 if i % 2 != 0 else 4
        assert n_nbs[i] == expected, \
            f"Wrong number of neighbours at {i}: {n_nbs[i]}"


def test_gabriel_windowed_matches_gather():
    """The sorted-order shared-window Gabriel formulation reproduces the
    per-point gather formulation (forces, friction sums, and kept-pair
    structure) on a random tissue."""
    import jax.numpy as jnp
    import numpy as np
    from yalla_tpu.ops.common import friction_w_neighbour
    from yalla_tpu.ops.grid_xla import gabriel_pairwise, gabriel_windowed

    rng = np.random.default_rng(17)
    n, n_pad = 700, 768
    pos = rng.uniform(-4, 4, (n_pad, 3)).astype(np.float32)
    X = Float3(x=jnp.asarray(pos[:, 0]), y=jnp.asarray(pos[:, 1]),
               z=jnp.asarray(pos[:, 2]))
    ov = Float3(x=jnp.asarray(rng.random(n_pad), jnp.float32),
                y=jnp.asarray(rng.random(n_pad), jnp.float32),
                z=jnp.asarray(rng.random(n_pad), jnp.float32))

    a = gabriel_pairwise(clipped_spring, friction_w_neighbour, X, ov,
                         jnp.int32(n), jnp.float32(1.0), grid_size=16,
                         row_cap=48, max_candidates=64)
    b = gabriel_windowed(clipped_spring, friction_w_neighbour, X, ov,
                         jnp.int32(n), jnp.float32(1.0), grid_size=16,
                         i_block=64, window_cap=256, max_candidates=64)
    assert float(np.max(np.asarray(a[3]["__err_gabriel_candidates"]))) == 0
    assert float(np.max(np.asarray(b[3]["__err_gabriel_candidates"]))) == 0
    assert float(np.max(np.asarray(b[3]["__err_grid_overflow"]))) == 0
    for f in ("x", "y", "z"):
        fa = np.asarray(getattr(a[0], f))[:n]
        fb = np.asarray(getattr(b[0], f))[:n]
        assert np.allclose(fa, fb, atol=1e-5), \
            f"windowed Gabriel force differs in {f}: {np.abs(fa - fb).max()}"
    assert np.allclose(np.asarray(a[1])[:n], np.asarray(b[1])[:n],
                       atol=1e-5), "sum_friction differs"


def test_gabriel_stable_id_semantics():
    """Reference forces use point ids beyond i == j (growth_w_wall.cu's
    wall-node exclusion by index): every Gabriel formulation must hand
    the force REAL stable ids, not sorted-slot numbers.  Point 0 sits
    mid-tissue so a slot-id mixup shifts its force to the wrong cell."""
    import jax.numpy as jnp
    import numpy as np
    from yalla_tpu.ops.common import friction_w_neighbour
    from yalla_tpu.ops.grid_xla import gabriel_pairwise, gabriel_windowed

    def wall_spring(Xi, r, dist, i, j):
        near = (i != j) & (i != 0) & (j != 0) & (dist < 1.0)
        w = jnp.where(near, (0.8 - dist), 0.0)
        safe = jnp.where(dist > 0, dist, 1.0)
        return Float3(x=r.x * w / safe, y=r.y * w / safe, z=r.z * w / safe)

    rng = np.random.default_rng(23)
    n, n_pad = 500, 512
    pos = rng.uniform(-3.5, 3.5, (n_pad, 3)).astype(np.float32)
    pos[0] = [0.3, 0.2, 0.1]  # the "wall node", mid-tissue
    X = Float3(x=jnp.asarray(pos[:, 0]), y=jnp.asarray(pos[:, 1]),
               z=jnp.asarray(pos[:, 2]))
    ov = Float3.zeros(n_pad)
    args = (wall_spring, friction_w_neighbour, X, ov, jnp.int32(n),
            jnp.float32(1.0))

    a = gabriel_pairwise(*args, grid_size=16, row_cap=48,
                         max_candidates=64)
    w = gabriel_windowed(*args, grid_size=16, i_block=64, window_cap=256,
                         max_candidates=64)
    assert float(np.abs(np.asarray(a[0].x)[0])) == 0, "wall node must sit still"
    for name, got in (("windowed", w),):
        for f in ("x", "y", "z"):
            fa = np.asarray(getattr(a[0], f))[:n]
            fb = np.asarray(getattr(got[0], f))[:n]
            assert np.allclose(fa, fb, atol=1e-5), (
                f"{name} Gabriel id semantics broken in {f}: "
                f"{np.abs(fa - fb).max()}")


def test_gabriel_windowed_misfit_salvage():
    """A point whose non-empty neighbour rows span more sorted positions
    than one window can cover (here: a corner cluster whose +1-z row sits
    past a 300-point strip of intervening cube ids) must be masked out of
    the windowed pass and salvaged exactly by the gather pass (no flag,
    matches the gather formulation); more misfits than ``salvage_cap``
    must raise ``__err_gabriel_window``."""
    import jax.numpy as jnp
    import numpy as np
    from yalla_tpu.ops.common import friction_w_neighbour
    from yalla_tpu.ops.grid_xla import gabriel_pairwise, gabriel_windowed

    rng = np.random.default_rng(3)
    n, n_pad = 2000, 2048
    pos = rng.uniform(2, 14, (n_pad, 3)).astype(np.float32)
    # a sparse 28-cube probe strip (one point per cube, all in one sorted
    # block) under a 250-point filler row one z-plane up, with anchor
    # pairs at both filler ends: the probe points' (dz=+1) row ranges pin
    # anywhere across the ~250-position filler span, so no single
    # 192-slot per-row window can serve the whole subgroup -- the ends
    # must misfit (window-fit disagreement is the only misfit mode left
    # after per-row median anchoring; a single point's own 3-cube range
    # is bounded by row_cap and always fits)
    pos[0:28, 0] = -13.5 + np.arange(28)          # cx = 2..29, cz = 2
    pos[0:28, 1] = -14.0
    pos[0:28, 2] = -14.0
    pos[28:30] = [[-13.6, -14.0, -12.5], [-13.4, -14.0, -12.5]]
    pos[30:280, 0] = np.linspace(-8.4, 8.4, 250)  # cx = 7..24, cz = 3
    pos[30:280, 1] = -14.0
    pos[30:280, 2] = -12.5
    pos[280:282] = [[13.4, -14.0, -12.5], [13.6, -14.0, -12.5]]
    X = Float3(x=jnp.asarray(pos[:, 0]), y=jnp.asarray(pos[:, 1]),
               z=jnp.asarray(pos[:, 2]))
    ov = Float3.zeros(n_pad)

    a = gabriel_pairwise(clipped_spring, friction_w_neighbour, X, ov,
                         jnp.int32(n), jnp.float32(1.0), grid_size=32,
                         row_cap=48, max_candidates=64)
    b = gabriel_windowed(clipped_spring, friction_w_neighbour, X, ov,
                         jnp.int32(n), jnp.float32(1.0), grid_size=32,
                         i_block=64, window_cap=128, max_candidates=64,
                         row_cap=48, salvage_cap=64)
    assert float(np.max(np.asarray(b[3]["__err_gabriel_window"]))) == 0
    assert float(np.max(np.asarray(b[3]["__err_grid_overflow"]))) == 0
    for f in ("x", "y", "z"):
        fa = np.asarray(getattr(a[0], f))[:n]
        fb = np.asarray(getattr(b[0], f))[:n]
        assert np.allclose(fa, fb, atol=1e-5), \
            f"salvaged Gabriel force differs in {f}: {np.abs(fa - fb).max()}"

    # too many misfits for the salvage capacity must raise the flag
    c = gabriel_windowed(clipped_spring, friction_w_neighbour, X, ov,
                         jnp.int32(n), jnp.float32(1.0), grid_size=32,
                         i_block=64, window_cap=128, max_candidates=64,
                         row_cap=48, salvage_cap=1)
    assert float(np.max(np.asarray(c[3]["__err_gabriel_window"]))) == 1
