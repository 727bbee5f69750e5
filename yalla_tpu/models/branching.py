"""Flagship model: branching morphogenesis on a spheroid.

Rebuild of ``examples/branching.cu``: a mesenchymal core
with an epithelial surface running Meinhardt activator-inhibitor kinetics;
the inhibitor diffuses into the mesenchyme and gates proliferation, driving
branch outgrowth.  Cell lineage is traced through every division.

Design notes:
* cell type lives *in the point type* (field ``ctype``: 0 mesenchyme,
  1 epithelium) with zero dynamics, so the pairwise force can branch on
  type without device-global property bindings
  (replaces ``cudaMemcpyToSymbol(d_type, ...)``, branching.cu:180).
* neighbour counters are aux-channel reductions, not atomic side effects
  (replaces ``atomicAdd(&d_epi_nbs[i], 1)``, branching.cu:104-107).
* proliferation uses the prefix-sum division framework
  (``yalla_tpu.growth``) instead of ``atomicAdd`` slot allocation.
* one "frame" = ``substeps`` proliferate+integrate iterations fused into a
  single jitted ``lax.scan`` -- the reference's inner loop
  (branching.cu:263-270) with zero per-step host round trips.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..dtypes import make_pt
from ..growth import Lineage, lineage_init, proliferate, record_divisions
from ..polarity import (bending_force_cart, bending_post_pair,
                        polarity_precompute, polarity_precompute3)
from ..solvers import GridEngine, friction_w_neighbour, heun_step

Cell = make_pt("BranchingCell", "theta", "phi", "u", "v", "ctype")

# The pair body reads only the polarity UNIT VECTOR (bending_force_cart
# leaves the angular gradient Cartesian; the trig conversion runs once
# per cell in force.post_pair), so the compact 3-channel precompute is
# the model's hook everywhere.  ``polarity_precompute`` stays importable
# for forces on the per-pair trig path (bending_force_fast).
precompute = polarity_precompute3

MESENCHYME, EPITHELIUM = 0.0, 1.0


class Params(NamedTuple):
    r_max: float = 1.0
    dt: float = 0.2
    lam: float = 0.0075          # Turing time scale (branching.cu:22)
    D_u: float = 0.001
    D_v: float = 0.2
    f_v: float = 1.0
    f_u: float = 80.0
    g_u: float = 80.0
    m_u: float = 0.25
    m_v: float = 0.75
    s_u: float = 0.05
    epi_proliferation_rate: float = 0.2
    mes_proliferation_rate: float = 0.1
    prolif_threshold: float = 1150.0  # v conc. gating mesenchymal division
    mean_distance: float = 0.75


class State(NamedTuple):
    X: Cell
    old_v: object
    n: jnp.ndarray
    lineage: Lineage
    epi_nbs: jnp.ndarray   # aux counters from the last force pass
    mes_nbs: jnp.ndarray
    key: jnp.ndarray


def make_force(p: Params):
    """Pairwise force in single-reciprocal form: ONE reciprocal per pair
    (the 1/dist rsqrt, shared with the bending fast path); everything
    else is mul/add, since this body runs on every candidate pair of the
    pair pass.

    The returned function carries an ``offdiag`` attribute: the same force
    without the i == j (Meinhardt reaction) terms.  Engines that evaluate
    the self-pair separately (the sweep kernel) use it to keep the
    reaction ODE math out of the neighbour loop; by contract
    ``force.offdiag(...) == force(...)`` wherever ``i != j``
    (cf. the reference's explicit i == j early branch, branching.cu:64-78).
    """
    def body(Xi, r, dist, i, j, with_diag):
        both = Xi.ctype * (Xi.ctype - r.ctype)     # 1 iff both epithelial
        same = r.ctype == 0.0
        diag = i == j

        # Mechanics: type-dependent ReLU band (branching.cu:82-87)
        near = (~diag) & (dist < p.r_max)
        F_same = jnp.maximum(0.7 - dist, 0) * 2 - jnp.maximum(dist - 0.8, 0)
        F_diff = jnp.maximum(0.8 - dist, 0) * 2 - jnp.maximum(dist - 0.9, 0)
        F = jnp.where(same, F_same, F_diff)
        pos = dist > 0
        # rsqrt(dist^2) == 1/dist for dist > 0: one rsqrt instead of a
        # sqrt and an f32 divide
        inv = jnp.where(pos, jax.lax.rsqrt(jnp.where(pos, dist * dist,
                                                     1.0)), 0.0)
        w = jnp.where(near, F * inv, 0.0)
        fx, fy, fz = r.x * w, r.y * w, r.z * w

        # Diffusion between epithelial pairs; v also leaks into the
        # mesenchyme to license proliferation (branching.cu:91-103).
        # The v gate simplifies: epi_pair | (near & ~epi) == near.
        epi_pair = near & (both == 1.0)
        du = jnp.where(epi_pair, -p.D_u * r.u, 0.0)
        dv0 = jnp.where(near, -p.D_v * r.v, 0.0)
        # The reference clamps u/v only in the epithelium-epithelium branch
        # (branching.cu:92-103); mesenchymal v uptake passes unclamped.
        # du is already epi_pair-gated, so the clamp's epi_pair factor is
        # redundant (a zero du never exceeds a clamp that zeroes it); dv
        # keeps it because the near-gated term must pass unclamped for
        # mesenchymal uptake.
        du = jnp.where(-du > Xi.u, 0.0, du)
        dv = jnp.where(epi_pair & (-dv0 > Xi.v), 0.0, dv0)

        if with_diag:
            # Meinhardt kinetics on the epithelium only (branching.cu:66-77)
            du_r = p.lam * ((p.f_u * Xi.u * Xi.u) / (1 + p.f_v * Xi.v)
                            - p.m_u * Xi.u + p.s_u)
            dv_r = p.lam * (p.g_u * Xi.u * Xi.u - p.m_v * Xi.v)
            du_r = jnp.where(-du_r > Xi.u, 0.0, du_r)  # clamp: no negatives
            dv_r = jnp.where(-dv_r > Xi.v, 0.0, dv_r)
            react = diag & (Xi.ctype == EPITHELIUM)
            du = du + jnp.where(react, du_r, 0.0)
            dv = dv + jnp.where(react, dv_r, 0.0)

        # Epithelial bending stiffness (branching.cu:100); Cartesian form
        # sharing inv: the angular gradient accumulates as the raw vector
        # sum G = sum(-prodi * r_hat) in three aux channels, converted to
        # (theta, phi) once per CELL in force.post_pair -- exact algebra
        # (the spherical-basis contraction is linear in r_hat and commutes
        # with the pair sum), no per-pair trig channels in the hot loop
        bx, by, bz, gx, gy, gz = bending_force_cart(Xi, r, dist, inv=inv)
        bw = jnp.where(epi_pair, 0.2, 0.0)
        fx = fx + bx * bw
        fy = fy + by * bw
        fz = fz + bz * bw

        zero = jnp.zeros_like(dist)
        dF = Cell(x=fx, y=fy, z=fz, theta=zero, phi=zero, u=du, v=dv,
                  ctype=zero)
        Xj_epi = Xi.ctype - r.ctype
        # only the epithelial count rides the hot loop when the friction
        # gate coincides with ``near`` (r_max == 1, the default): the
        # mesenchymal count is then derived post-pass as
        # sum_friction - epi_nbs (friction_w_neighbour counts i != j and
        # dist < 1, ref solvers.cuh:27-35 / branching.cu:82)
        aux = {
            "epi_nbs": jnp.where(near & (Xj_epi == EPITHELIUM), 1.0, 0.0),
            "pg_x": gx * bw, "pg_y": gy * bw, "pg_z": gz * bw,
        }
        if p.r_max != 1.0:
            aux["mes_nbs"] = jnp.where(near & (Xj_epi == MESENCHYME),
                                       1.0, 0.0)
        return dF, aux

    def force(Xi, r, dist, i, j):
        return body(Xi, r, dist, i, j, True)

    force.offdiag = lambda Xi, r, dist, i, j: body(Xi, r, dist, i, j, False)
    force.post_pair = bending_post_pair
    if p.r_max == 1.0:
        force.derive_aux = {
            "mes_nbs": lambda aux, sum_f: sum_f - aux["epi_nbs"]}
    return force


def make_want_fn(p: Params):
    def want(X, props, rnd, i, n):
        epi_nbs, mes_nbs = props
        guard = i < (n * (1 - p.epi_proliferation_rate)).astype(jnp.int32)
        mes_ok = ((X.ctype == MESENCHYME) & (X.v >= p.prolif_threshold)
                  & (rnd <= p.mes_proliferation_rate))
        epi_ok = ((X.ctype == EPITHELIUM) & (epi_nbs <= 5) & (mes_nbs > 0)
                  & (rnd <= p.epi_proliferation_rate))
        return guard & (mes_ok | epi_ok)
    return want


def make_child_fn(p: Params):
    def child(X, props, direction, i):
        off = p.mean_distance / 4
        parent = X.replace(u=X.u / 2, v=X.v / 2)  # conserved species halve
        daughter = parent.replace(x=X.x + off * direction.x,
                                  y=X.y + off * direction.y,
                                  z=X.z + off * direction.z)
        return parent, daughter
    return child


def tier_caps(n_max):
    """Capacity tiers for a tissue growing toward ``n_max``.

    The per-pass cost of every static-shape engine is bound by its PADDED
    size (the binning sorts n_pad rows; the kernels cover every padded
    row or the full grid), not the live count -- a 500-cell seed on a
    500k-sized engine pays the 500k structural floor.  Growing models therefore
    run each growth phase at the smallest sufficient tier and re-pad
    upward (``repad_state``); the reference gets this for free because
    its kernel launches follow the live count (branching.cu:265 sizes
    <<<(n + 128 - 1)/128, 128>>>)."""
    from ..solvers import _pad_size
    final = _pad_size(n_max)
    tiers, t = [], 4096
    while t < final:
        tiers.append(t)
        t *= 4
    return tiers + [final]


def next_tier(n_now, n_max, headroom=0.7):
    """Smallest tier with ``n_now <= headroom * tier`` (the last tier
    regardless)."""
    tiers = tier_caps(n_max)
    for t in tiers:
        if n_now <= headroom * t:
            return t
    return tiers[-1]


def repad_state(state: State, n_pad_new: int) -> State:
    """Re-pad the per-cell arrays of ``state`` to ``n_pad_new`` slots
    (device-side; lineage node arrays keep their full capacity)."""
    def repad(a, fill):
        m = a.shape[0]
        if n_pad_new <= m:
            return a[:n_pad_new]
        pad = jnp.full((n_pad_new - m,) + a.shape[1:], fill, a.dtype)
        return jnp.concatenate([a, pad])

    lin = state.lineage._replace(
        cell_parent=repad(state.lineage.cell_parent, -1),
        cell_clone=repad(state.lineage.cell_clone, 0))
    return state._replace(
        X=jax.tree.map(lambda a: repad(a, 0), state.X),
        old_v=jax.tree.map(lambda a: repad(a, 0), state.old_v),
        lineage=lin,
        epi_nbs=repad(state.epi_nbs, 0),
        mes_nbs=repad(state.mes_nbs, 0),
    )


def _planned_extent(n_max, extent):
    """Half-extent a grid must cover: the caller's ``extent``, else the
    final population's.  Measured equilibrium half-extent of the settled
    adhesive tissue is ~n^(1/3) * rest_spacing / 2 (the branching
    potential packs up to 8 cells per unit cube, BASELINE.md), NOT the
    0.8-spacing ball model; branch outgrowth margin on top."""
    if extent is not None:
        return extent
    return max(n_max, 1) ** (1 / 3) * 0.8 / 2 + 4.0


def default_engine(n_now, n_max, p: Params = Params(), extent=None,
                   max_occ=9):
    """Engine for the model, asked of ``yalla_tpu.backend``: on the GPU
    the sweep kernel at every size; elsewhere :func:`xla_engine`.

    The grid is sized for the FINAL population's extent (``n_max``), not
    the current one, so a growing run never hits a mid-run resize.
    ``engine_for_state`` remains the reactive fallback for states that
    escape the predicted envelope."""
    from .. import backend
    from ..ops.common import grid_for
    from ..solvers import SweepEngine
    if backend.on_gpu():
        # no per-cube capacity: only the grid's extent matters
        return SweepEngine(
            grid_size=grid_for(_planned_extent(n_max, extent), p.r_max))
    return xla_engine(n_max, p, extent, max_occ)


def xla_engine(n_max, p: Params = Params(), extent=None, max_occ=9):
    """The plain-XLA engine :func:`default_engine` picks off the GPU: the
    gather grid at small ``n_max`` and the dense lattice above."""
    from ..ops.lattice_xla import pick_lattice_dims
    from ..solvers import LatticeEngine
    if n_max <= 20_000:
        # honour the measured occupancy: engine_for_state retries after a
        # __err_grid_overflow must return a roomier engine, not the same
        # one.  row_cap bounds a 3-cube row (ops/grid_xla.py:94-98), so
        # size it from 3x the worst single cube plus headroom.
        return GridEngine(grid_size=100, row_cap=max(32, 3 * max_occ + 16))
    # An actively DIVIDING tissue packs ~15 cells/cube around the
    # division zones (daughters placed at mean_distance/4 of the parent
    # are nearly co-located until the mechanics spread them), so the
    # lattice capacity is planned for the division regime up front.
    gs, C = pick_lattice_dims(_planned_extent(n_max, extent), p.r_max,
                              max(max_occ, 15))
    return LatticeEngine(grid_size=gs, capacity=C, z_block=2)


def engine_for_state(state, n_max, p: Params = Params()):
    """Re-derive the lattice engine from the live state's extent AND
    measured cube occupancy (use when a frame reports
    ``__err_out_of_grid`` / ``__err_lattice_dropped``: a fixed occupancy
    guess would rebuild the identical engine and retry-fail forever)."""
    import numpy as np
    n = int(state.n)
    h = [np.asarray(a[:max(n, 1)])
         for a in (state.X.x, state.X.y, state.X.z)]
    extent = max(float(np.max(np.abs(a))) for a in h)
    cid = 0
    for a in h:
        cid = cid * (2 ** 21) + np.floor(a / p.r_max).astype(np.int64)
    max_occ = int(np.unique(cid, return_counts=True)[1].max()) if n else 1
    return default_engine(n, n_max, p, extent=extent + 2.0,
                          max_occ=max_occ + 1)


def init_state(n_0, n_max, p: Params = Params(), engine: GridEngine = None,
               seed=0, lineage_cap=None):
    """Initial condition: relaxed mesenchymal ball, outer shell converted to
    epithelium with radial polarity and noisy morphogen seed
    (branching.cu:176-254).  Returns (State, Solution, engine)."""
    import numpy as np

    from ..inits import relaxed_sphere
    from ..solvers import Solution

    if engine is None:
        engine = default_engine(n_0, n_max, p)
    rng = np.random.default_rng(seed)

    cells = Solution(Cell, n_max, engine=engine, cube_size=p.r_max)
    cells.h_n = n_0
    relaxed_sphere(p.mean_distance, cells, rng=rng)
    cells.copy_to_host()
    n_pad = cells.n_pad

    # Mesenchymal-neighbour counting pre-pass (take_step with dt = 0,
    # branching.cu:241-242)
    force = make_force(p)
    aux = cells.take_step(0.0, force, precompute=precompute)
    mes_nbs = np.asarray(aux["mes_nbs"])

    # Surface cells (few mesenchymal neighbours) become epithelium with
    # radial apical-basal polarity (branching.cu:243-254).  The reference
    # threshold is 20 but its pre-pass counters accumulate over BOTH Heun
    # passes (no reset hook is passed at branching.cu:241-242); our aux
    # channel counts one pass, so the equivalent threshold is 10.
    h = cells.h_X
    surface = (mes_nbs < 10) & (np.arange(n_pad) < n_0)
    r = np.sqrt(h.x ** 2 + h.y ** 2 + h.z ** 2)
    r = np.where(r > 0, r, 1.0)
    h.ctype[surface] = EPITHELIUM
    h.theta[surface] = np.arccos(np.clip(h.z / r, -1, 1))[surface]
    h.phi[surface] = np.arctan2(h.y, h.x)[surface]
    h.u[surface] = (rng.random(n_pad)[surface] / 5) - 0.1
    h.v[surface] = (rng.random(n_pad)[surface] / 5) - 0.1
    cells.copy_to_device()

    cap = lineage_cap if lineage_cap is not None else 2 * n_pad
    state = State(
        X=cells.d_X, old_v=cells.d_old_v, n=cells.d_n,
        lineage=lineage_init(cap, n_pad, n_0),
        epi_nbs=jnp.zeros(n_pad), mes_nbs=jnp.zeros(n_pad),
        key=jax.random.PRNGKey(seed),
    )
    return state, cells, engine


def make_frame(p: Params, engine: GridEngine, substeps=11):
    """One output frame: ``substeps`` x (proliferate; integrate), fused.

    Mirrors the reference's calculation thread (branching.cu:263-270).
    Returns ``(state, errs)`` where ``errs`` holds the in-loop D_ASSERT
    flags (engine capacity / out-of-grid / NaN / cells lost to n_max),
    reduced over the substeps -- check them per frame and resize the
    engine when the growing tissue outruns it."""
    force = make_force(p)
    want = make_want_fn(p)
    child = make_child_fn(p)

    @partial(jax.jit, static_argnums=())
    def frame(state: State, time_progression):
        def body(carry, key):
            X, old_v, n, lin, epi_nbs, mes_nbs = carry
            X, old_v, n, (epi_nbs, mes_nbs), info = proliferate(
                want, child, X, old_v, n, key, props=(epi_nbs, mes_nbs))
            lin = record_divisions(lin, info, X, X.ctype.astype(jnp.int32),
                                   time_progression)
            X, old_v, aux = heun_step(
                engine, force, friction_w_neighbour, None, "com",
                X, old_v, n, jnp.float32(p.dt), jnp.float32(p.r_max),
                jnp.int32(0), None, precompute)
            errs = {k: v for k, v in aux.items() if k.startswith("__err_")}
            errs["__err_cells_lost"] = info.n_lost.astype(jnp.float32)
            return ((X, old_v, n, lin, aux["epi_nbs"], aux["mes_nbs"]),
                    errs)

        keys = jax.random.split(state.key, substeps + 1)
        carry = (state.X, state.old_v, state.n, state.lineage,
                 state.epi_nbs, state.mes_nbs)
        carry, errs = jax.lax.scan(body, carry, keys[1:])
        X, old_v, n, lin, epi_nbs, mes_nbs = carry
        return (State(X=X, old_v=old_v, n=n, lineage=lin,
                      epi_nbs=epi_nbs, mes_nbs=mes_nbs, key=keys[0]),
                jax.tree.map(lambda a: a.max(0), errs))

    return frame
