"""Dense cube-lattice engine: the plain-XLA binned path for large N.

Same physics as the spatial-hash grid engine (rebuilding ``Grid_computer``
semantics from the reference's ``solvers.cuh:345-502``), laid out as
dense arrays.  The population lives in a fixed-capacity cell list:

    T[field][gs, gs, gs, C]   (C = per-cube capacity; empty slots masked)

and the 27-neighbour-cube sweep becomes a *27-point shifted-slice stencil*
-- contiguous reads only, dense [.., C, C] pair blocks, no gathers in the
force pass.  Translation between stable-id arrays and the lattice happens
once per rebuild; ``lattice_heun_steps`` keeps the state lattice-resident
for ``rebuild_every`` steps (the reference's potentials vanish at the
cutoff, so a brief stale binning has negligible force error; use
rebuild_every=1 for exactness).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..dtypes import Float3
from .common import evaluate_pairs, grid_for, mask_tree

__all__ = ["LatticeLayout", "lattice_build", "lattice_unbuild",
           "lattice_pairwise_resident", "lattice_heun_steps",
           "lattice_overflow_count", "pick_lattice_dims",
           "slot_to_stable"]


def pick_lattice_dims(pos_max, cube_size, max_occ):
    """``(grid_size, capacity)``: the covering grid, and one slot of
    headroom over ``max_occ`` (at least 4).  The in-loop overflow flags
    catch any occupancy growth past C during a run."""
    return grid_for(pos_max, cube_size), max(4, max_occ + 1)

_OFFSETS = [(dz, dy, dx)
            for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


class LatticeLayout(NamedTuple):
    T: object            # Pt of f32[n_slots]
    Tov: object          # Float3 of f32[n_slots] (old_v)
    pid: jnp.ndarray     # int32[n_slots], stable id; n_pad = empty
    slot_of: jnp.ndarray  # int32[n_pad], slot per stable id; n_slots = none
    n_dropped: jnp.ndarray  # int32: points that overflowed cube capacity
    n_oob: jnp.ndarray      # int32: points clipped into edge cubes (out of
    #                         grid -- mis-binned; ref D_ASSERTs instead,
    #                         solvers.cuh:361-364)


from .common import cube_ids as _cube_ids
from .common import grid_dims as _grid_dims
from .common import out_of_grid_mask as _oob_mask


def lattice_build(X, old_v, n, cube_size, grid_size, capacity, x_split=1):
    """Sort by cube id and pour points into the dense lattice.

    Every channel rides the cube-id sort as a *payload*, and the sorted
    values land in their slots with one n_pad-sized unique-index scatter
    per channel.  Cells past a cube's ``capacity`` are dropped and
    counted in ``n_dropped``."""
    n_pad = X.x.shape[0]
    gx, gy, gz = _grid_dims(grid_size)
    C = capacity
    n_cubes = gx * gy * gz
    n_slots = n_cubes * C
    cid = _cube_ids(X, n, cube_size, grid_size, x_split)
    iota = jnp.arange(n_pad, dtype=jnp.int32)

    n_oob = jnp.sum(_oob_mask(X, n, cube_size, grid_size, x_split),
                    dtype=jnp.int32)

    leaves_X, tree_X = jax.tree.flatten(X)
    leaves_ov, tree_ov = jax.tree.flatten(old_v)
    nx = len(leaves_X)
    sorted_all = jax.lax.sort((cid, iota, *leaves_X, *leaves_ov),
                              num_keys=2)
    sorted_cid, order = sorted_all[0], sorted_all[1]
    sorted_vals = sorted_all[2:]

    # rank within the cube, from segment starts of the sorted ids
    first = jnp.concatenate([jnp.ones(1, bool),
                             sorted_cid[1:] != sorted_cid[:-1]])
    seg_start = jax.lax.cummax(jnp.where(first, iota, 0))
    rank = iota - seg_start
    ok = (rank < C) & (sorted_cid < n_cubes)
    slot_sorted = jnp.where(ok, sorted_cid * C + rank, n_slots)  # drop

    def pour(sorted_a, fill=0.0):
        # NOTE: indices_are_sorted would be faster but is UNSAFE here:
        # overflow entries carry an interleaved drop sentinel, so the index
        # array is not monotone whenever any cube exceeds capacity
        return jnp.full(n_slots, fill, sorted_a.dtype) \
            .at[slot_sorted].set(sorted_a, mode="drop",
                                 unique_indices=True)

    T = jax.tree.unflatten(tree_X, [pour(v) for v in sorted_vals[:nx]])
    Tov = jax.tree.unflatten(tree_ov, [pour(v) for v in sorted_vals[nx:]])
    pid = pour(order, n_pad)
    slot_of = jnp.full(n_pad, n_slots, jnp.int32) \
        .at[order].set(slot_sorted, mode="drop", unique_indices=True)
    n_dropped = jnp.sum((rank >= C) & (sorted_cid < n_cubes))
    return LatticeLayout(T=T, Tov=Tov, pid=pid, slot_of=slot_of,
                         n_dropped=n_dropped, n_oob=n_oob)


def lattice_rebin(layout: LatticeLayout, cube_size, grid_size, capacity,
                  m_cap, carry=None, x_split=1):
    """Re-derive the binning from the CURRENT slot-space positions.

    Produces the same cube MEMBERSHIP as ``lattice_unbuild`` followed by
    a fresh ``lattice_build`` -- without the global n_pad sort or the
    stable-order round trip.  Between rebuilds only a few percent of
    cells cross a cube face, so: stayers keep their slots; movers are
    compacted into a side list of capacity ``m_cap``, each assigned a
    free lane of its target cube (freed lanes are reused in lane order),
    and scattered in.  Movers whose target cube is full are dropped --
    exactly ``lattice_build``'s capacity semantics.  Slot placement
    WITHIN a cube differs from a fresh build (pair sums are
    reduction-order equivalent, f32 roundoff aside).

    Returns ``(layout, n_unrebinned)``: nonzero means the mover list
    overflowed ``m_cap`` and that many points kept a STALE cube
    assignment -- callers must surface it as an in-loop error flag
    (their forces would silently differ from a fresh build's).

    ``carry`` (optional): a pytree of ``[n_slots]`` arrays transported
    through the same slot permutation as the state channels.  This is
    what makes the *per-pass* rebin cadence of ``lattice_heun_steps``
    possible: the Heun corrector needs the predictor derivative ``d1`` in
    the NEW binning's slot order (``X_new = X1 + dt/2 * (d2 - d1)``), so
    ``d1`` rides the rebin instead of a stable-order round trip.  Returns
    ``(layout, n_unrebinned, carry2)`` in that case; values at
    vacated-but-unfilled slots are stale and must stay masked by
    occupancy, exactly like the state channels.
    """
    from .common import cube_coord
    gx, gy, gz = _grid_dims(grid_size)
    C = capacity
    n_cubes = gx * gy * gz
    n_slots = layout.pid.shape[0]
    n_pad = layout.slot_of.shape[0]
    T, Tov = layout.T, layout.Tov
    occ = layout.pid < n_pad

    cube_x = cube_size / x_split

    def cid_of(P, live):
        cid = (cube_coord(P.z, cube_size, gz) * gy
               + cube_coord(P.y, cube_size, gy)) * gx \
            + cube_coord(P.x, cube_x, gx)
        return jnp.where(live, cid, n_cubes)

    def oob_of(P, live):
        bad = jnp.zeros_like(live)
        for v, g, cs in ((P.x, gx, cube_x), (P.y, gy, cube_size),
                         (P.z, gz, cube_size)):
            c = jnp.floor(v / cs).astype(jnp.int32) + g // 2
            bad = bad | (c < 0) | (c >= g)
        return bad & live

    cid_new = cid_of(T, occ)
    slot_iota = jnp.arange(n_slots, dtype=jnp.int32)
    mover = occ & (cid_new != slot_iota // C)
    stay = occ & ~mover
    n_mov = jnp.sum(mover, dtype=jnp.int32)
    n_unrebinned = jnp.maximum(n_mov - m_cap, 0)
    n_oob = jnp.sum(oob_of(T, occ), dtype=jnp.int32)

    # free lanes per cube after removing movers, in lane order
    lane = jnp.arange(C, dtype=jnp.int32)[None, :]
    free2 = (~stay).reshape(n_cubes, C)
    free_lane = jnp.sort(jnp.where(free2, lane, lane + C), axis=1)
    free_cnt = jnp.sum(free2, axis=1)

    # compact the movers into one list
    L = m_cap
    mov_rank = jnp.cumsum(mover) - 1
    dst_list = jnp.where(mover & (mov_rank < m_cap),
                         mov_rank.astype(jnp.int32), m_cap)
    msrc = jnp.full(m_cap + 1, n_slots, jnp.int32) \
        .at[dst_list].set(slot_iota, mode="drop",
                          unique_indices=True)[:m_cap]
    pick = jnp.minimum(msrc, n_slots - 1)
    lat_live = msrc < n_slots

    leaves_T, tree_T = jax.tree.flatten(T)
    leaves_ov, tree_ov = jax.tree.flatten(Tov)
    nx = len(leaves_T)
    if carry is not None:
        leaves_c, tree_c = jax.tree.flatten(carry)
    else:
        leaves_c, tree_c = [], None
    lat_chans = leaves_T + leaves_ov + leaves_c
    chans = [a[pick] for a in lat_chans]
    list_pid = jnp.where(lat_live, layout.pid[pick], n_pad)
    tq = jnp.where(lat_live, cid_new[pick], n_cubes)

    # rank within target cube -> free lane (or drop)
    iota_L = jnp.arange(L, dtype=jnp.int32)
    s_tq, s_idx = jax.lax.sort((tq, iota_L), num_keys=1)
    first = jnp.concatenate([jnp.ones(1, bool), s_tq[1:] != s_tq[:-1]])
    r = iota_L - jax.lax.cummax(jnp.where(first, iota_L, 0))
    qc = jnp.minimum(s_tq, n_cubes - 1)
    fits = (s_tq < n_cubes) & (r < free_cnt[qc])
    dst = jnp.where(fits, qc * C + free_lane[qc, jnp.minimum(r, C - 1)],
                    n_slots)
    n_dropped = jnp.sum((s_tq < n_cubes) & ~fits, dtype=jnp.int32)

    pid_s = list_pid[s_idx]
    chans_s = [a[s_idx] for a in chans]

    # apply: clear vacated slots, then scatter the re-homed entries
    clear_at = jnp.where(lat_live, msrc, n_slots)
    pid2 = layout.pid.at[clear_at].set(n_pad, mode="drop") \
        .at[dst].set(pid_s, mode="drop")
    outs = [a.at[dst].set(v, mode="drop")
            for a, v in zip(lat_chans, chans_s)]
    slot_of2 = layout.slot_of.at[
        jnp.where(pid_s < n_pad, pid_s, n_pad)].set(
        jnp.where(fits, dst, n_slots), mode="drop")
    T2 = jax.tree.unflatten(tree_T, outs[:nx])
    Tov2 = jax.tree.unflatten(tree_ov, outs[nx:nx + 3])
    new = layout._replace(T=T2, Tov=Tov2, pid=pid2, slot_of=slot_of2,
                          n_dropped=n_dropped, n_oob=n_oob)
    if carry is not None:
        carry2 = jax.tree.unflatten(tree_c, outs[nx + 3:])
        return new, n_unrebinned, carry2
    return new, n_unrebinned


def lattice_unbuild(layout: LatticeLayout, X, old_v):
    """Back to stable-id arrays; untouched entries (inactive or dropped)
    keep their previous values (one stacked column gather)."""
    n_slots = layout.pid.shape[0]
    ok = layout.slot_of < n_slots
    pick = jnp.where(ok, layout.slot_of, 0)
    leaves_T, tree_T = jax.tree.flatten(layout.T)
    leaves_ov, tree_ov = jax.tree.flatten(layout.Tov)
    G = jnp.stack(leaves_T + leaves_ov)[:, pick]   # [K, n_pad]
    olds = jax.tree.leaves(X) + jax.tree.leaves(old_v)
    outs = [jnp.where(ok, G[k], old) for k, old in enumerate(olds)]
    nx = len(leaves_T)
    return (jax.tree.unflatten(tree_T, outs[:nx]),
            jax.tree.unflatten(tree_ov, outs[nx:]))


def lattice_overflow_count(layout):
    return layout.n_dropped


def _gap_deficit(P, Q, grid_size):
    """Missed-pair gap deficit for ``rebuild_every > 1`` from per-cube
    INSTANTANEOUS position extrema of ONE force-evaluation state --
    immune to collective flow and keeping the slack of cells that sit
    away from their cube faces.

    A pair can be missed only if it is outside the 27-cube stencil at
    build time (>= 2 cubes apart along some axis u) yet comes within
    ``force_r_max`` at SOME single force evaluation of the chunk -- at
    that moment its coordinate gap along u is < r_max.  With ``P``/``Q``
    the [3, gs^3] per-axis per-cube max/min of the cells' positions *at
    that evaluation state* (cube membership frozen at build time;
    -inf/+inf where empty), the gap of any (i in a, j in b) is
    >= Q[b] - P[a], so ``min over 2-apart (a, b) of (Q[b] - P[a])
    >= r_max`` certifies no missed pair at this state.  The caller
    accumulates ``max`` of the returned deficit (= -(min gap)) over
    every evaluation state of the chunk.

    Extrema must be INSTANTANEOUS, not running over the chunk: running
    extrema compare cube a at one time against cube b at another, so
    uniform collective flow -- which a settling tissue sustains through
    the friction velocity mixing -- eats the whole margin spuriously
    (measured 0.4 closure per 4-step chunk at 500k where the true
    same-state shear is ~100x smaller).

    Coverage: pairs exactly 2 apart along ONE axis with lateral offsets
    <= 1 take the tight single-axis gap check; pairs 2 apart along TWO
    axes (diagonal escape) must close BOTH axis gaps below r_max, so
    their deficit is the min of the two (pairs 2 apart along all three
    axes ride the same term with the third axis pooled +-2,
    conservatively ignoring its gap); pairs >= 3 apart along any axis
    would need a gap closure > 2*cube - r_max, covered by the caller's
    global displacement fallback term.  Pooling laterally +-2 into the
    single-axis check instead would charge the u-gap of cells 2 cubes
    apart in v -- cells that can only interact by ALSO closing the v-gap
    -- and flag tissue shear (lateral slip) that misses no pairs at all.
    """
    gx, gy, gz = _grid_dims(grid_size)
    shape3 = (gz, gy, gx)
    big = jnp.float32(3e38)
    # cube ids are x-minor (common.cube_ids): reshaped array axes are
    # (z, y, x), so data axis u (0=x, 1=y, 2=z) lives on array axis
    # 2 - u.
    P3 = [P[u].reshape(shape3) for u in range(3)]
    Q3 = [Q[u].reshape(shape3) for u in range(3)]

    def pool(A, ax, k, keep_max):
        fill = -big if keep_max else big
        Ap = jnp.pad(A, [(k, k) if a == ax else (0, 0) for a in range(3)],
                     constant_values=fill)
        m = None
        for t in range(2 * k + 1):
            s = jax.lax.dynamic_slice_in_dim(Ap, t, shape3[ax], axis=ax)
            m = s if m is None else (jnp.maximum(m, s) if keep_max
                                     else jnp.minimum(m, s))
        return m

    def shift(A, ax, d, fill):
        # a-centric partner value: out[i] = A[i + d] (d static, +-2)
        pad = [(0, d) if a == ax else (0, 0) for a in range(3)] if d >= 0 \
            else [(-d, 0) if a == ax else (0, 0) for a in range(3)]
        Ap = jnp.pad(A, pad, constant_values=fill)
        return jax.lax.dynamic_slice_in_dim(Ap, max(d, 0), shape3[ax],
                                            axis=ax)

    deficit = jnp.float32(-big)
    # single-axis escapes: partner +2 along u, lateral pooled +-1
    for u in range(3):
        au = 2 - u
        Qp = Q3[u]
        for lat in range(3):
            if lat != au:
                Qp = pool(Qp, lat, 1, False)
        deficit = jnp.maximum(deficit,
                              jnp.max(P3[u] - shift(Qp, au, 2, big)))
    # two-axis (diagonal) escapes: partner (+2 u, +-2 v), third axis
    # pooled +-2; BOTH gaps must close, so the pair deficit is the min
    for u in range(3):
        for v in range(u + 1, 3):
            au, av = 2 - u, 2 - v
            w = 3 - u - v
            aw = 2 - w
            for s in (2, -2):
                def bside(A, keep_max):
                    fill = -big if keep_max else big
                    Ap = pool(A, aw, 2, keep_max)
                    return shift(shift(Ap, au, 2, fill), av, s, fill)
                d_u = P3[u] - bside(Q3[u], False)
                if s > 0:
                    d_v = P3[v] - bside(Q3[v], False)
                else:
                    d_v = bside(P3[v], True) - Q3[v]
                deficit = jnp.maximum(deficit,
                                      jnp.max(jnp.minimum(d_u, d_v)))
    return deficit


def slot_to_stable(layout, tree, fill=0.0):
    """Gather a slot-space pytree back to stable-id order (``fill`` for
    ids with no slot: inactive or capacity-dropped).  Multi-leaf trees
    ride one stacked column gather."""
    n_slots = layout.pid.shape[0]
    ok = layout.slot_of < n_slots
    pick = jnp.where(ok, layout.slot_of, 0)
    leaves, treedef = jax.tree.flatten(tree)
    f32 = [a for a in leaves if a.dtype == jnp.float32
           and a.shape == (n_slots,)]
    if len(f32) >= 3:
        G = jnp.stack(f32)[:, pick]
        it = iter(range(len(f32)))
        outs = [jnp.where(ok, G[next(it)], fill)
                if (a.dtype == jnp.float32 and a.shape == (n_slots,))
                else jnp.where(ok, a[pick], fill) for a in leaves]
        return jax.tree.unflatten(treedef, outs)
    return jax.tree.map(lambda a: jnp.where(ok, a[pick], fill), tree)


def lattice_pairwise_resident(pw_int, pw_friction, layout, n, cube_size, *,
                              grid_size, capacity, z_block, x_split=1):
    """Pairwise sums in lattice layout.

    Lane-aligned formulation: fields are viewed as ``[gs_z, gs_y, gs_x*C]``
    so the minor (lane) dimension is the whole x-row of slots.  For each of
    the 9 (dz, dy) neighbour rows, the 3 x-cubes' candidates are exactly the
    x-flat shifts ``r in [-2C+1, 2C-1]`` of that row; cube membership per
    shift is a C-periodic constant mask.  Every pair term is an elementwise
    op on ``[z_block, gs, gs*C]`` tiles -- no gathers, no tiny minor dims.
    """
    gx, gy, gz = _grid_dims(grid_size)
    C = capacity
    n_pad = layout.slot_of.shape[0]  # empty-slot sentinel value in pid
    occ = layout.pid < n_pad

    def padded(a, fill=0):
        return jnp.pad(a.reshape(gz, gy, gx * C), ((1, 1), (1, 1), (0, 0)),
                       constant_values=fill)

    P = jax.tree.map(padded, layout.T)
    Pov = Float3(padded(layout.Tov.x), padded(layout.Tov.y),
                 padded(layout.Tov.z))
    Pocc = padded(occ, False)
    Ppid = padded(layout.pid, n_pad)
    return pairwise_on_padded(pw_int, pw_friction, P, Pov, Pocc, Ppid,
                              cube_size, grid_size=gx, capacity=C,
                              z_block=z_block, x_split=x_split)


def pairwise_on_padded(pw_int, pw_friction, P, Pov, Pocc, Ppid, cube_size, *,
                       grid_size, capacity, z_block, x_split=1):
    """Core shifted-slice pass over channels already carrying one halo
    plane on each z and y edge (``[gs_z + 2, gs_y + 2, gs_x * C]``).

    Split out of :func:`lattice_pairwise_resident` so the multi-chip z-slab
    decomposition (``parallel/lattice_spmd.py``) can attach *exchanged*
    halo planes (via ``ppermute``) instead of the single-chip zero padding.
    Returns flat ``[gs_z * gs_y * gs_x * C]`` sums for the interior.
    """
    gs, C = grid_size, capacity      # gs = x cubes (lane-aligned axis)
    xs_k = x_split                   # x-neighbour reach in (thin) cubes
    gz = Pocc.shape[0] - 2          # interior z planes (local slab extent)
    gy = Pocc.shape[1] - 2          # interior y rows
    W = gs * C                      # flat x-row width
    PAD = (xs_k + 1) * C            # x halo for shifts
    n_slots = gz * gy * W

    def xpad(a, fill=0):
        return jnp.pad(a, ((0, 0), (0, 0), (PAD, PAD)),
                       constant_values=fill)

    P = jax.tree.map(xpad, P)
    Pov = Float3(xpad(Pov.x), xpad(Pov.y), xpad(Pov.z))
    Pocc = xpad(Pocc, False)
    Ppid = xpad(Ppid, 0)

    # C-periodic cube-membership pattern per shift r: slot c of a cube may
    # pair with slot at flat offset r iff (c + r) falls in cubes -1..+1.
    lane_c = jnp.arange(W, dtype=jnp.int32) % C

    zb = z_block
    assert gz % zb == 0
    nz = gz // zb
    # All (dz, dy, x-shift) partner offsets.  Scanned in groups of UNROLL:
    # the scan carry (the per-slab accumulators, a few MB) round-trips
    # through HBM once per iteration, so unrolling several offsets per
    # iteration divides that traffic; full unrolling would blow up compile
    # time.
    UNROLL = 16
    smax = (xs_k + 1) * C - 1
    shifts = list(range(-smax, smax + 1))
    combos = [(dz, dy, r) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
              for r in shifts]
    while len(combos) % UNROLL:
        combos.append((0, 0, 0))  # no-op duplicates, masked by weight 0
    pad_from = 9 * len(shifts)
    weights = [1.0] * pad_from + [0.0] * (len(combos) - pad_from)
    n_groups = len(combos) // UNROLL
    dzs = jnp.asarray([c[0] for c in combos], jnp.int32).reshape(n_groups,
                                                                 UNROLL)
    dys = jnp.asarray([c[1] for c in combos], jnp.int32).reshape(n_groups,
                                                                 UNROLL)
    rss = jnp.asarray([c[2] for c in combos], jnp.int32).reshape(n_groups,
                                                                 UNROLL)
    wts = jnp.asarray(weights, jnp.float32).reshape(n_groups, UNROLL)

    def eval_slab(zi):
        z0 = zi * zb
        isl = lambda a: jax.lax.dynamic_slice(
            a, (z0 + 1, 1, PAD), (zb, gy, W))
        Xi = jax.tree.map(isl, P)
        occ_i = isl(Pocc)
        i_ids = isl(Ppid)

        def one_group(acc, offs):
            dzg, dyg, rg, wg = offs
            for u in range(UNROLL):
                dz, dy, r, wt = dzg[u], dyg[u], rg[u], wg[u]
                jsl = lambda a: jax.lax.dynamic_slice(
                    a, (z0 + 1 + dz, 1 + dy, PAD + r), (zb, gy, W))
                # x-cube offset of the partner slot, per lane (C-periodic)
                dcube = (lane_c + r) // C
                in_x = (dcube >= -xs_k) & (dcube <= xs_k)
                Xj = jax.tree.map(jsl, P)
                ovj = (jsl(Pov.x), jsl(Pov.y), jsl(Pov.z))
                pair_mask = (occ_i & jsl(Pocc) & in_x[None, None, :]
                             & (wt > 0.5))
                out = evaluate_pairs(pw_int, pw_friction, Xi, Xj, ovj,
                                     i_ids, jsl(Ppid), pair_mask,
                                     sum_axes=(), cutoff=cube_size)
                acc = (jax.tree.map(jnp.add, acc[0], out[0]),
                       acc[1] + out[1],
                       tuple(a + b for a, b in zip(acc[2], out[2])),
                       {k: acc[3][k] + out[3][k] for k in acc[3]})
            return acc, None

        zero = jnp.zeros((zb, gy, W), jnp.float32)
        # Probe the force's output structure (dF type may differ from the
        # augmented input type; aux dict keys must be static).
        from .common import split_force_output
        dF_probe, aux_probe = split_force_output(
            pw_int(Xi, Xi - Xi, jnp.ones_like(zero), i_ids, i_ids))
        acc0 = (jax.tree.map(lambda a: zero, dF_probe), zero,
                (zero, zero, zero), {k: zero for k in aux_probe})
        acc, _ = jax.lax.scan(one_group, acc0, (dzs, dys, rss, wts))
        return acc

    _, outs = jax.lax.scan(lambda c, z: (c, eval_slab(z)), None,
                           jnp.arange(nz, dtype=jnp.int32))
    flat = lambda a: a.reshape((n_slots,) + a.shape[4:])
    F, sum_f, sum_v, aux = outs
    return (jax.tree.map(flat, F), flat(sum_f), tuple(map(flat, sum_v)),
            {k: flat(v) for k, v in aux.items()})


@partial(jax.jit,
         static_argnums=(0, 1, 2, 3, 4, 5, 6, 7, 14, 15, 18, 19, 20))
def lattice_heun_steps(n_steps, rebuild_every, pw_int, pw_friction, fix_mode,
                       grid_size, capacity, z_block,
                       X, old_v, n, dt, cube_size, fix_point,
                       precompute=None, gen=None, gen_args=None,
                       force_r_max=None, rebin_m_cap=0,
                       rebin_per_pass=False, x_split=1):
    """``n_steps`` Heun steps with lattice-resident state.

    Same integration semantics as ``solvers.heun_steps`` (COM/point fixes,
    friction-weighted velocity mixing), with the pair pass on the dense
    lattice.  ``rebuild_every == 1`` rebuilds the binning before *every
    pairwise pass* -- bit-matching the reference's per-pass ``grid.build``
    (solvers.cuh:494).  ``rebuild_every > 1`` keeps the state
    lattice-resident between rebuilds: cheaper, and physically equivalent
    for forces that vanish at the cutoff (all the reference potentials do).

    ``force_r_max`` (optional, traced float): the force's own interaction
    radius.  When given with ``rebuild_every > 1``, the run is
    *self-certifying*: a chunk whose measured in-chunk displacement could
    have brought a missed pair inside ``force_r_max``
    (``2 * stale_max_disp > cube_size - force_r_max``) raises the
    ``__err_stale`` flag -- the resident cadence is then exact by
    measurement, not assumption (the reference re-bins per pass,
    solvers.cuh:494, so its exactness burden sits on the rebuild cadence).

    ``rebin_m_cap > 0`` keeps the state LATTICE-RESIDENT across chunks:
    each chunk re-derives the binning in slot space (``lattice_rebin``,
    mover-list capacity ``rebin_m_cap``) instead of paying the
    unbuild + global-sort + pour round trip -- same cube membership as a
    fresh rebuild, so the staleness certificate applies unchanged.  A
    mover-list overflow surfaces as ``__err_rebin_overflow`` (those
    points kept a stale cube assignment).  With ``rebuild_every == 1``
    this rebins per STEP (the corrector pass still evaluates at the
    predictor state under chunk-start binning -- certified via the
    position-extrema tracking); use ``rebin_m_cap == 0`` with
    ``rebuild_every == 1`` for the reference's per-PASS rebuild.

    ``gen`` (a static ``GenericForce`` with ``args=None``) + ``gen_args``
    run the reference's generic-forces hook (links, walls,
    solvers.cuh:43-53) *inside* the resident loop: the state is gathered
    back to stable-id order for the hook (XLA dead-code-eliminates channels
    the hook never reads), and the resulting dX is scattered into slot
    order through ``slot_of`` -- only for ``gen.fields`` when given.
    """
    assert n_steps % rebuild_every == 0
    gs, C = grid_size, capacity
    # thin x-cubes change what "out of stencil" means, and the resident
    # gap-deficit certificate's 2-apart escape analysis is written for
    # the isotropic 27-stencil -- x_split pairs with cadences that
    # re-derive the binning before EVERY pairwise pass and therefore need
    # no certificate: plain per-pass rebuilds (rebuild_every == 1,
    # rebin_m_cap == 0) or per-PASS slot-space rebinning
    # (rebin_per_pass).  The per-STEP rebin path (rebuild_every == 1,
    # rebin_m_cap > 0, rebin_per_pass=False) still runs run_chunk's
    # isotropic staleness certificate on the corrector pass, so it is
    # excluded too (its extrema scatter also assumes full-width x-cubes).
    assert x_split == 1 or (rebuild_every == 1
                            and (rebin_m_cap == 0 or rebin_per_pass)), \
        ("x_split > 1 requires per-pass-exact binning: rebuild_every == 1 "
         "with rebin_m_cap == 0 (plain rebuilds) or rebin_per_pass")
    occ_of = lambda lay: lay.pid < lay.slot_of.shape[0]

    def build_lay(Xc, ovc):
        return lattice_build(Xc, ovc, n, cube_size, gs, C, x_split=x_split)

    def deriv(lay, T, n):
        """Derivative in slot space."""
        from ..solvers import augment, truncate_aug
        orig_type = type(T)
        # derived per-point fields computed in slot layout (cheap,
        # garbage in empty slots is masked by occupancy)
        lay = lay._replace(T=augment(T, n, precompute))
        F, sum_f, sum_v, aux = lattice_pairwise_resident(
            pw_int, pw_friction, lay, n, cube_size, grid_size=gs,
            capacity=C, z_block=z_block, x_split=x_split)
        from .common import apply_derived_aux, apply_post_pair
        aux = apply_derived_aux(pw_int, aux, sum_f)
        F, aux = apply_post_pair(pw_int, F, aux, lay.T)
        F = truncate_aug(F, orig_type)
        if gen is not None:
            ok = lay.slot_of < lay.pid.shape[0]
            X_st = slot_to_stable(lay, T)
            dXg = gen.fn(X_st, n, gen_args)
            fields = gen.fields if gen.fields is not None \
                else type(F)._fields
            upd = {}
            for f in fields:
                g = jnp.where(ok, getattr(dXg, f), 0.0)
                upd[f] = getattr(F, f).at[lay.slot_of].add(
                    g, mode="drop", unique_indices=True)
            F = F.replace(**upd)

        inv = jnp.where(sum_f > 0, 1.0 / jnp.where(sum_f > 0, sum_f, 1.0),
                        0.0)
        occ = occ_of(lay)
        dX = mask_tree(F.replace(x=F.x + sum_v[0] * inv,
                                 y=F.y + sum_v[1] * inv,
                                 z=F.z + sum_v[2] * inv), occ)
        n_occ = jnp.sum(occ)

        def com(a):
            return jnp.sum(jnp.where(occ, a, 0.0)) / jnp.maximum(n_occ, 1)

        def at_point(a):
            # value at the pinned stable id's slot
            return jnp.sum(jnp.where(lay.pid == fix_point, a, 0.0))

        if fix_mode == "com":
            fx, fy, fz = com(dX.x), com(dX.y), com(dX.z)
        elif fix_mode == "point":
            fx, fy, fz = at_point(dX.x), at_point(dX.y), at_point(dX.z)
        elif fix_mode == "com_z":
            fx, fy, fz = at_point(dX.x), at_point(dX.y), com(dX.z)
        else:
            raise ValueError(fix_mode)
        dX = dX.replace(x=jnp.where(occ, dX.x - fx, 0.0),
                        y=jnp.where(occ, dX.y - fy, 0.0),
                        z=jnp.where(occ, dX.z - fz, 0.0))
        return dX, aux

    to_stable = slot_to_stable

    def nonfinite(tree):
        return jnp.any(jnp.stack([jnp.any(~jnp.isfinite(a))
                                  for a in jax.tree.leaves(tree)]))

    def chunk_exact(carry, _):
        """rebuild_every == 1: fresh binning per pass (reference-exact)."""
        X, old_v, dropped, oob, bad = carry

        def dstable(Xc):
            lay = build_lay(Xc, old_v)
            dXs, aux_s = deriv(lay, lay.T, n)
            return (to_stable(lay, dXs), to_stable(lay, aux_s),
                    lay.n_dropped, lay.n_oob)

        d1, aux1, dr1, ob1 = dstable(X)
        X1 = jax.tree.map(lambda a, b: a + b * dt, X, d1)
        d2, aux, dr2, ob2 = dstable(X1)
        # force-published __err_* flags must survive the predictor pass too
        for k in aux:
            if k.startswith("__err_"):
                aux[k] = jnp.maximum(aux[k], aux1[k])
        X_new = jax.tree.map(lambda a, b, c: a + (b + c) * (0.5 * dt),
                             X, d1, d2)
        ov = Float3(x=(d1.x + d2.x) * 0.5, y=(d1.y + d2.y) * 0.5,
                    z=(d1.z + d2.z) * 0.5)
        dropped = jnp.maximum(dropped, jnp.maximum(dr1, dr2))
        oob = jnp.maximum(oob, jnp.maximum(ob1, ob2))
        bad = bad | nonfinite(X_new)
        return (X_new, ov, dropped, oob, bad), aux

    def run_chunk(lay):
        """``rebuild_every`` resident steps + staleness certificate on a
        freshly-binned layout; returns (updated layout, stable-order aux,
        non-finite flag contribution)."""
        occ = occ_of(lay)

        def heun(a, b, c2):
            return jax.tree.map(
                lambda x, y, z2: x + (y + z2) * (0.5 * dt), a, b, c2)

        def mean_v(d1, d2):
            return Float3(x=(d1.x + d2.x) * 0.5, y=(d1.y + d2.y) * 0.5,
                          z=(d1.z + d2.z) * 0.5)

        def max_disp(new, ref, live):
            # displacement vs the chunk-start binning positions (running
            # max below: non-monotonic motion must not hide staleness)
            d = jnp.zeros(())
            for f in ("x", "y", "z"):
                delta = jnp.abs(getattr(new, f) - getattr(ref, f))
                d = jnp.maximum(d, jnp.max(jnp.where(live, delta, 0.0)))
            return d

        # gap-deficit staleness certificate, evaluated at EVERY
        # force-evaluation state of the chunk from that state's own
        # instantaneous per-axis per-cube position extrema (collective
        # flow cancels and mid-cube slack counts; see _gap_deficit).
        # The predictor states X1 are checked too: the corrector pass
        # evaluates forces THERE, so their excursions must not escape
        # the certificate.
        big = jnp.float32(3e38)
        gdx, gdy, gdz = _grid_dims(gs)
        n_cubes = gdx * gdy * gdz
        track = force_r_max is not None

        def cube_red(arr, fill, red):
            """Per-cube reduction over the slot axis (cube-rank flat
            slot order: [n_cubes, C])."""
            v = jnp.where(occ, arr, fill)
            return red(v.reshape(n_cubes, C), axis=1)

        def state_deficit(T_at):
            P = jnp.full((3, n_cubes), -big)
            Q = jnp.full((3, n_cubes), big)
            for u, f in enumerate(("x", "y", "z")):
                d2 = getattr(T_at, f)
                P = P.at[u].set(cube_red(d2, -big, jnp.max))
                Q = Q.at[u].set(cube_red(d2, big, jnp.min))
            return _gap_deficit(P, Q, gs)

        def step(c, _):
            T, Tov, dfc = c
            lay_t = lay._replace(Tov=Tov)
            d1, aux1 = deriv(lay_t, T, n)
            T1 = jax.tree.map(lambda a, b: a + b * dt, T, d1)
            d2, aux = deriv(lay_t, T1, n)
            for k in aux:
                if k.startswith("__err_"):
                    aux[k] = jnp.maximum(aux[k], aux1[k])
            T_new = heun(T, d1, d2)
            if track:
                dfc = jnp.maximum(dfc, state_deficit(T1))
                dfc = jnp.maximum(dfc, state_deficit(T_new))
            disp_t = jnp.maximum(max_disp(T_new, lay.T, occ),
                                 max_disp(T1, lay.T, occ))
            return ((T_new, mean_v(d1, d2), dfc), (aux, disp_t))

        # the chunk-start (binning) state is itself the first pass's
        # evaluation state
        dfc0 = state_deficit(lay.T) if track else jnp.float32(-big)
        (T, Tov, dfc), (auxs, disps) = jax.lax.scan(
            step, (lay.T, lay.Tov, dfc0), None, length=rebuild_every)
        lay = lay._replace(T=T, Tov=Tov)
        # staleness certification: the largest in-chunk displacement bounds
        # how far the binning went stale between rebuilds (with
        # cube_size == cutoff the missed just-entering pairs carry force
        # ~|F(cutoff)| for at most this long) -- published as a metric so
        # rebuild_every > 1 is certified by measurement, not assumption
        disp = jnp.max(disps)
        # aux accumulators back to stable-id order; transient __err_*
        # flags accumulate (max) over the chunk's steps
        aux_last = to_stable(lay, {
            k: (a.max(0) if k.startswith("__err_") else a[-1])
            for k, a in auxs.items()})
        aux_last["stale_max_disp"] = disp
        if track:
            # a missed pair needs an actual position gap < r_max across
            # >= 2 cubes at some single force evaluation; collective
            # flow cancels in the per-state per-cube position extrema
            # where the absolute 2*max|dX| bound would flag every
            # resident chunk.  The closure VALUE is published too, so a
            # caller can size the binning margin (cube_size - r_max) from
            # measurement instead of probing flag-by-flag; the flag
            # condition is closure > margin.  The displacement fallback
            # covers pairs >= 3 cubes apart.
            closure = dfc + cube_size
            flag = ((closure > (cube_size - force_r_max))
                    | ((2.0 * disp) > (2.0 * cube_size - force_r_max)))
            aux_last["__err_stale"] = flag.astype(jnp.float32)
            aux_last["stale_shear_closure"] = closure
        return lay, aux_last, nonfinite(lay.T)

    def chunk(carry, _):
        X, old_v, dropped, oob, bad = carry
        lay = build_lay(X, old_v)
        dropped = jnp.maximum(dropped, lay.n_dropped)
        oob = jnp.maximum(oob, lay.n_oob)
        lay, aux_last, bad_c = run_chunk(lay)
        X, old_v = lattice_unbuild(lay, X, old_v)
        return (X, old_v, dropped, oob, bad | bad_c), aux_last

    def chunk_rebin(carry, _):
        # lattice-RESIDENT across chunks: re-derive the binning in slot
        # space (lattice_rebin) instead of the unbuild + sort + pour
        # round trip; first chunk runs on the fresh build (its rebin is
        # a no-op pass)
        lay, dropped, oob, bad, unre = carry
        lay, un = lattice_rebin(lay, cube_size, gs, C, rebin_m_cap,
                                x_split=x_split)
        unre = jnp.maximum(unre, un)
        dropped = jnp.maximum(dropped, lay.n_dropped)
        oob = jnp.maximum(oob, lay.n_oob)
        lay, aux_last, bad_c = run_chunk(lay)
        return (lay, dropped, oob, bad | bad_c, unre), aux_last

    zero = jnp.int32(0)
    if rebin_m_cap and rebin_per_pass:
        # Reference-exact cadence (grid.build before EVERY pairwise pass,
        # solvers.cuh:494) without the reference's cost structure: the
        # state never leaves slot space.  Each pass re-derives the binning
        # by slot-space rebinning (movers only), and the Heun corrector
        # runs in the *predictor state's* binning with the predictor
        # derivative transported through the rebin permutation
        # (X_new = X1 + dt/2 * (d2 - d1)).  No staleness certificate is
        # needed -- every pass evaluates under a fresh binning.  Aux
        # accumulators ride the scan carry in slot order and are gathered
        # to stable ids ONCE at the end (__err_* merge elementwise-max
        # across passes; their contract is global-any, and slot orders
        # differ across passes only by the movers).
        assert rebuild_every == 1, \
            "rebin_per_pass implies rebuild_every == 1"
        lay0 = build_lay(X, old_v)

        def reb(lay, carry=None):
            return lattice_rebin(lay, cube_size, gs, C, rebin_m_cap, carry,
                                 x_split=x_split)

        def halfdiff(x1, a, b):
            return x1 + (b - a) * (0.5 * dt)

        def fold_aux(acc, aux2, aux1):
            """Accumulate: non-err keys take the corrector pass's latest
            value; __err_* keys max over (accumulated, pass 1, pass 2)."""
            out = dict(aux2)
            for k in out:
                if k.startswith("__err_"):
                    out[k] = jnp.maximum(jnp.maximum(out[k], acc[k]),
                                         jnp.max(aux1[k]))
            return out

        aux_shape = jax.eval_shape(lambda lay: deriv(lay, lay.T, n)[1], lay0)

        def step_pass(carry, _):
            lay, aux_c, dropped, oob, bad, unre = carry
            lay, un1 = reb(lay)
            dropped = jnp.maximum(dropped, lay.n_dropped)
            oob = jnp.maximum(oob, lay.n_oob)
            unre = jnp.maximum(unre, un1)
            d1, aux1 = deriv(lay, lay.T, n)
            lay = lay._replace(
                T=jax.tree.map(lambda a, b: a + b * dt, lay.T, d1))
            lay, un2, d1 = reb(lay, d1)
            unre = jnp.maximum(unre, un2)
            dropped = jnp.maximum(dropped, lay.n_dropped)
            oob = jnp.maximum(oob, lay.n_oob)
            d2, aux = deriv(lay, lay.T, n)
            lay = lay._replace(
                T=jax.tree.map(halfdiff, lay.T, d1, d2),
                Tov=Float3(x=(d1.x + d2.x) * 0.5, y=(d1.y + d2.y) * 0.5,
                           z=(d1.z + d2.z) * 0.5))
            # pass-1 flags fold in as their global max (orders differ by
            # the movers; per-cell attribution is best-effort for flags)
            aux_c = fold_aux(aux_c, aux, aux1)
            bad = bad | nonfinite(lay.T)
            return (lay, aux_c, dropped, oob, bad, unre), None

        carry0 = (lay0, {k: jnp.zeros(v.shape, v.dtype)
                         for k, v in aux_shape.items()},
                  lay0.n_dropped, lay0.n_oob, jnp.bool_(False), zero)
        (lay, aux_c, dropped, oob, bad, unre), _ = jax.lax.scan(
            step_pass, carry0, None, length=n_steps)
        X, old_v = lattice_unbuild(lay, X, old_v)
        aux = to_stable(lay, aux_c)
        aux["__err_lattice_dropped"] = dropped
        aux["__err_out_of_grid"] = oob
        aux["__err_non_finite"] = bad
        aux["__err_rebin_overflow"] = unre
        return X, old_v, aux

    if rebin_m_cap and rebuild_every >= 1:
        lay0 = build_lay(X, old_v)
        carry0 = (lay0, lay0.n_dropped, lay0.n_oob, jnp.bool_(False),
                  zero)
        (lay, dropped, oob, bad, unre), auxs = jax.lax.scan(
            chunk_rebin, carry0, None, length=n_steps // rebuild_every)
        X, old_v = lattice_unbuild(lay, X, old_v)
        aux = {k: (a.max(0) if k.startswith("__err_") else a[-1])
               for k, a in auxs.items()}
        for k in ("stale_max_disp", "stale_shear_closure"):
            if k in aux:
                aux[k] = jnp.max(auxs[k])
        aux["__err_lattice_dropped"] = dropped
        aux["__err_out_of_grid"] = oob
        aux["__err_non_finite"] = bad
        aux["__err_rebin_overflow"] = unre
        return X, old_v, aux

    body = chunk_exact if rebuild_every == 1 else chunk
    carry0 = (X, old_v, jnp.int32(0), jnp.int32(0), jnp.bool_(False))
    (X, old_v, dropped, oob, bad), auxs = jax.lax.scan(
        body, carry0, None, length=n_steps // rebuild_every)
    aux = {k: (a.max(0) if k.startswith("__err_") else a[-1])
           for k, a in auxs.items()}
    for k in ("stale_max_disp", "stale_shear_closure"):
        if k in aux:
            # worst staleness across ALL chunks, not just the last
            aux[k] = jnp.max(auxs[k])
    # in-loop failure flags (the reference's D_ASSERT layer): cube-capacity
    # drops / out-of-grid clipping at any rebuild and non-finite state at
    # any chunk boundary (ref solvers.cuh:82,90,153-154,361-364)
    aux["__err_lattice_dropped"] = dropped
    aux["__err_out_of_grid"] = oob
    aux["__err_non_finite"] = bad
    return X, old_v, aux
