"""Spatial-hash grid engine (XLA path) and Gabriel-graph refinement.

Rebuild of the reference's sort-based uniform grid
(``include/solvers.cuh:345-502``) and Gabriel computer
(``solvers.cuh:505-644``).  Key design translations:

* ``thrust::sort_by_key(cube_id, point_id)``  ->  ``lax.sort`` with payload.
* per-cube start/end boundary-detection kernel  ->  scatter-min/scatter-max
  into dense ``cube_start`` / ``cube_end`` tables (one gather per query
  instead of a binary search).
* the 27-neighbour-cube sweep  ->  9 *contiguous row ranges*: because cube
  ids along x are consecutive integers and points are sorted by cube id, the
  three cubes ``(c-1, c, c+1)`` of each (dy, dz) row occupy one contiguous
  span of the sorted order.  Each point gathers ``row_cap`` fixed-capacity
  candidates per row -- static shapes, fully vectorized, no atomics.
* dynamic cells-per-cube  ->  fixed capacity + masking.  ``row_cap`` bounds
  points per 3-cube row; overflow is detectable via ``grid_overflow``.

Padded (inactive) points get a sentinel cube id that sorts past every real
cube, so they never appear as candidates of real points.

All pairwise entry points take an optional ``(i_offset, i_size)`` window so
a multi-chip caller (shard_map over a cells axis) can compute derivatives
for its own shard of points against the full gathered population.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .common import evaluate_pairs

__all__ = ["GridTables", "build_grid", "row_ranges", "grid_pairwise",
           "gabriel_pairwise", "grid_overflow"]


class GridTables(NamedTuple):
    order: jnp.ndarray       # int32[n_pad]: point id per sorted slot
    cid: jnp.ndarray         # int32[n_pad]: cube id per point (unsorted)
    cube_start: jnp.ndarray  # int32[n_cubes + 1]: first sorted slot per cube
    cube_end: jnp.ndarray    # int32[n_cubes + 1]: last sorted slot (incl.)


def _row_offsets(grid_size):
    """27 neighbour-cube offsets grouped as 9 rows of 3 consecutive cubes
    (cf. the ``d_nhood`` construction, ref solvers.cuh:472-484)."""
    offs = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            row = dz * grid_size * grid_size + dy * grid_size
            offs.append([row - 1, row, row + 1])
    return jnp.asarray(offs, dtype=jnp.int32)  # [9, 3]


def build_grid(X, n, cube_size, grid_size):
    """Bin points into cubes and index the sorted order.

    Cube id = (floor(x/s) + gs/2) + (floor(y/s) + gs/2)*gs +
    (floor(z/s) + gs/2)*gs^2 (ref solvers.cuh:349-365).  Coordinates are
    clipped to the grid (the reference device-asserts instead; models must
    stay within gs/2 cubes of the origin either way).
    """
    from .common import cube_ids
    n_pad = X.x.shape[0]
    gs = grid_size
    n_cubes = gs * gs * gs
    cid = cube_ids(X, n, cube_size, gs)  # sentinel n_cubes sorts last

    iota = jnp.arange(n_pad, dtype=jnp.int32)
    sorted_cid, order = jax.lax.sort((cid, iota), num_keys=1)

    slot = jnp.arange(n_pad, dtype=jnp.int32)
    cube_start = jnp.full((n_cubes + 1,), n_pad, jnp.int32) \
        .at[sorted_cid].min(slot)
    cube_end = jnp.full((n_cubes + 1,), -1, jnp.int32) \
        .at[sorted_cid].max(slot)
    return GridTables(order, cid, cube_start, cube_end)


def row_ranges(tables: GridTables, cid_blk, grid_size):
    """Sorted-order span [rs, re] (inclusive) of each of the 9 neighbour
    rows for a block of cube ids.  The union of 3 consecutive cubes is one
    contiguous span of the sorted order."""
    n_cubes = grid_size ** 3
    qc = jnp.clip(cid_blk[:, None, None] + _row_offsets(grid_size)[None],
                  0, n_cubes - 1)
    rs = jnp.min(tables.cube_start[qc], axis=2)  # [B, 9]
    re = jnp.max(tables.cube_end[qc], axis=2)    # [B, 9] inclusive
    return rs, re


def grid_overflow(tables: GridTables, grid_size, row_cap):
    """True if any 3-cube row holds more candidates than ``row_cap``
    (the rebuild's analogue of the reference's D_ASSERT capacity checks)."""
    rs, re = row_ranges(tables, tables.cid, grid_size)
    return jnp.any(re - rs + 1 > row_cap)


def grid_out_of_bounds(X, n, cube_size, grid_size):
    """True if any active point's unclipped cube coordinate falls outside
    [0, grid_size).  ``build_grid`` clips such points into edge cubes (where
    the reference D_ASSERTs in-bounds ids, solvers.cuh:361-364); for points
    folded into corner cubes two neighbour rows can clip to overlapping
    spans and double-count pairs, so out-of-grid states must be detected
    rather than silently mis-integrated."""
    from .common import out_of_grid_mask
    return jnp.any(out_of_grid_mask(X, n, cube_size, grid_size))


def _candidates(order, rs, re, row_cap):
    """Candidate point ids for an i-block: [B, 9, row_cap] from row ranges."""
    pos = rs[:, :, None] + jnp.arange(row_cap, dtype=jnp.int32)
    valid = pos <= re[:, :, None]
    n_pad = order.shape[0]
    jidx = order[jnp.clip(pos, 0, n_pad - 1)]
    return jidx, valid


def _block_size(n, want):
    b = min(want, n)
    while n % b:
        b //= 2
    return b


def _scan_blocks(eval_block, i_size, B):
    if i_size == B:
        return eval_block(jnp.int32(0))
    starts = jnp.arange(i_size // B, dtype=jnp.int32) * B
    _, outs = jax.lax.scan(lambda c, s: (c, eval_block(s)), None, starts)
    flat = lambda a: a.reshape((i_size,) + a.shape[2:])
    F, sum_f, sum_v, aux = outs
    return (jax.tree.map(flat, F), flat(sum_f), tuple(map(flat, sum_v)),
            {k: flat(v) for k, v in aux.items()})


def grid_pairwise(pw_int, pw_friction, X, old_v, n, cube_size, *,
                  grid_size=50, row_cap=32, i_block=4096,
                  i_offset=0, i_size=None):
    """Pairwise sums over grid neighbours with ``dist < cube_size`` cutoff,
    for points ``[i_offset, i_offset + i_size)`` against the full population.

    Equivalent of ``Grid_computer::pwints`` + ``compute_cube``
    (ref solvers.cuh:430-499): the grid is rebuilt from scratch on every
    call, exactly like the reference rebuilds per pass.
    """
    n_pad = X.x.shape[0]
    if i_size is None:
        i_size = n_pad
    tables = build_grid(X, n, cube_size, grid_size)

    B = _block_size(i_size, i_block)

    def eval_block(local_start):
        start = i_offset + local_start
        blk = lambda a: jax.lax.dynamic_slice_in_dim(a, start, B)
        cid_blk = blk(tables.cid)
        rs, re = row_ranges(tables, cid_blk, grid_size)
        jidx, valid = _candidates(tables.order, rs, re, row_cap)
        Xi = jax.tree.map(lambda a: blk(a)[:, None, None], X)
        Xj = jax.tree.map(lambda a: a[jidx], X)
        ovj = (old_v.x[jidx], old_v.y[jidx], old_v.z[jidx])
        i_arr = (start + jnp.arange(B, dtype=jnp.int32))[:, None, None]
        pair_mask = valid & (i_arr < n)
        out = evaluate_pairs(pw_int, pw_friction, Xi, Xj, ovj, i_arr, jidx,
                             pair_mask, sum_axes=(1, 2), cutoff=cube_size)
        # in-loop capacity check (ref D_ASSERT, solvers.cuh:82,90): a row
        # with more candidates than row_cap silently drops pairs -- flag it
        over = jnp.any((re - rs + 1 > row_cap)
                       & (i_arr[:, :, 0] < n), axis=1).astype(jnp.float32)
        out[3]["__err_grid_overflow"] = over
        return out

    return _scan_blocks(eval_block, i_size, B)


def gabriel_pairwise(pw_int, pw_friction, X, old_v, n, cube_size, *,
                     grid_size=50, row_cap=32, gabriel_coefficient=0.8,
                     i_block=256, i_offset=0, i_size=None,
                     max_candidates=100):
    """Grid neighbours pruned to (scaled) Gabriel-graph pairs.

    Rebuild of ``compute_cube_gabriel`` (ref solvers.cuh:509-602): collect
    candidates, sort by distance, and keep pair (i, j) only if no *closer*
    candidate k falls inside the sphere of radius
    ``0.5 * dist_ij * gabriel_coefficient`` around the i-j midpoint.

    ``max_candidates`` bounds the per-point candidate list like the
    reference's fixed 100-entry array (solvers.cuh:525-527): the midpoint
    test runs on the ``max_candidates`` *nearest* candidates only, which
    keeps the [B, NC, NC] pair block O(NC^2) regardless of ``row_cap``
    (the reference silently overruns its array past 100; here overflow
    raises through the in-loop ``__err`` flags instead).
    """
    return _gabriel_gather(pw_int, pw_friction, X, old_v, n, cube_size,
                           grid_size=grid_size, row_cap=row_cap,
                           gabriel_coefficient=gabriel_coefficient,
                           i_block=i_block, i_offset=i_offset,
                           i_size=i_size, max_candidates=max_candidates)


def _gabriel_block(pw_int, pw_friction, X, old_v, n, cube_size, tables, *,
                   ids, act, grid_size, row_cap, gabriel_coefficient,
                   max_candidates):
    """Gabriel force sums for an explicit vector of point ids (per-point
    row-gather formulation); shared by the legacy gather path and the
    windowed path's misfit-salvage pass."""
    B = ids.shape[0]
    K = 9 * row_cap
    NC = min(max_candidates, K)
    cid_blk = tables.cid[ids]
    rs, re = row_ranges(tables, cid_blk, grid_size)
    jidx, valid = _candidates(tables.order, rs, re, row_cap)
    jidx = jidx.reshape(B, K)
    i_arr = ids[:, None]
    valid = valid.reshape(B, K) & act[:, None]

    xj, yj, zj = X.x[jidx], X.y[jidx], X.z[jidx]
    xi = X.x[ids][:, None]
    yi = X.y[ids][:, None]
    zi = X.z[ids][:, None]
    dx, dy, dz = xi - xj, yi - yj, zi - zj
    dist = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    cand = valid & (dist < cube_size)
    n_cand = jnp.sum(cand, axis=1)  # per point, before the NC cap

    # NC nearest candidates (invalid -> +inf): top_k on the negated
    # key replaces a full [B, K] argsort -- the reference
    # selection-sorts a fixed 100-entry array (solvers.cuh:549-566),
    # but only the NC nearest ever matter
    sort_key = jnp.where(cand, dist, jnp.inf)
    _, sort_ord = jax.lax.top_k(-sort_key, NC)
    take = lambda a: jnp.take_along_axis(a, sort_ord, axis=1)
    jidx_s, cand_s, dist_s = take(jidx), take(cand), take(dist)
    xj_s, yj_s, zj_s = take(xj), take(yj), take(zj)

    # Keep (i, j) unless a closer candidate k lies inside the sphere on
    # the i-j midpoint (ref solvers.cuh:572-597).  Elementwise [B, K, K]
    # distance evaluation (exact in f32).
    mx, my, mz = (xi + xj_s) * 0.5, (yi + yj_s) * 0.5, (zi + zj_s) * 0.5
    d2 = ((mx[:, :, None] - xj_s[:, None, :]) ** 2
          + (my[:, :, None] - yj_s[:, None, :]) ** 2
          + (mz[:, :, None] - zj_s[:, None, :]) ** 2)
    radius2 = (0.5 * dist_s * gabriel_coefficient) ** 2  # [B, NC]
    m_ids = jnp.arange(NC)[:, None]
    k_ids = jnp.arange(NC)[None, :]
    closer = (k_ids < m_ids)[None] & cand_s[:, None, :]
    blocked = jnp.any(closer & (d2 < radius2[:, :, None]), axis=2)
    is_self = jidx_s == i_arr
    keep = cand_s & (is_self | ~blocked)

    Xi = jax.tree.map(lambda a: a[ids][:, None], X)
    # positions were already gathered above; only the remaining
    # fields pay a [B, NC] gather here
    Xj = jax.tree.map(lambda a: a[jidx_s], X)
    Xj = Xj.replace(x=xj_s, y=yj_s, z=zj_s)
    ovj = (old_v.x[jidx_s], old_v.y[jidx_s], old_v.z[jidx_s])
    out = evaluate_pairs(pw_int, pw_friction, Xi, Xj, ovj, i_arr, jidx_s,
                         keep, sum_axes=(1,))
    over = jnp.any((re - rs + 1 > row_cap) & act[:, None],
                   axis=1).astype(jnp.float32)
    out[3]["__err_grid_overflow"] = over
    # candidate-list capacity (ref's fixed 100-entry array): pairs past
    # the NC nearest are silently dropped -- surface it like a D_ASSERT
    out[3]["__err_gabriel_candidates"] = (
        (n_cand > NC) & act).astype(jnp.float32)
    return out


def _gabriel_gather(pw_int, pw_friction, X, old_v, n, cube_size, *,
                    grid_size, row_cap, gabriel_coefficient,
                    i_block, i_offset, i_size, max_candidates):
    """Per-point row-gather formulation (original; see gabriel_windowed
    for the shared-window formulation)."""
    n_pad = X.x.shape[0]
    if i_size is None:
        i_size = n_pad
    tables = build_grid(X, n, cube_size, grid_size)
    B = _block_size(i_size, i_block)

    def eval_block(local_start):
        start = i_offset + local_start
        ids = start + jnp.arange(B, dtype=jnp.int32)
        return _gabriel_block(
            pw_int, pw_friction, X, old_v, n, cube_size, tables,
            ids=ids, act=ids < n, grid_size=grid_size, row_cap=row_cap,
            gabriel_coefficient=gabriel_coefficient,
            max_candidates=max_candidates)

    return _scan_blocks(eval_block, i_size, B)


def gabriel_windowed(pw_int, pw_friction, X, old_v, n, cube_size, *,
                     grid_size=50, gabriel_coefficient=0.8,
                     i_block=64, window_cap=256, max_candidates=32,
                     row_cap=32, salvage_cap=256, subgroup=None):
    """Gabriel pairs via SORTED-ORDER shared windows: a rewrite of
    :func:`gabriel_pairwise` with fewer random accesses.

    The gather formulation moves ~(9 * row_cap * 3 + NC * K) randomly
    addressed elements per point.  Here consecutive SORTED points share their
    neighbourhood: for each block of ``i_block`` sorted points, the nine
    (dz, dy) candidate rows are fetched as CONTIGUOUS ``dynamic_slice``
    windows of the cube-sorted channel matrix (one slice per row, all
    channels at once), per-point validity is index arithmetic, and only
    the ``max_candidates`` nearest survivors pay a (row-local)
    ``take_along_axis``.  The midpoint test then runs on the compact
    candidates for BOTH j and k: any blocker k lies within
    ``0.9 * dist_ij < cube_size`` of i (|k - m| < 0.4 d and |i - m| =
    0.5 d), so i's within-cutoff candidate list -- certified complete by
    the ``__err_gabriel_candidates`` flag -- contains every possible
    blocker (ref solvers.cuh:572-597 restricts k to closer candidates,
    which this set supersedes).

    Each block's shared window is anchored at the block-MEDIAN active
    point's row starts, so a lone point sorted far from the rest of its
    block (e.g. a wall node below the tissue sharing a sorted block with
    tissue corner cells) cannot blow the shared span: points whose own
    rows do not fit the window are masked out of the windowed pass and
    salvaged EXACTLY by a compacted per-point gather pass
    (:func:`_gabriel_block`, capacity ``salvage_cap``/``row_cap``).

    ``subgroup`` (default: the whole block) splits each block into
    subgroups of that many CONSECUTIVE sorted points, each with its own
    nine median-anchored windows: a subgroup of ~8-32 points spans only a
    few cubes, so ``window_cap`` can drop from the block's sorted span
    (~i_block + rows) to a few cube-rows (~32-64) -- the per-point
    candidate domain (and the top-NC selection under it) shrinks by the
    same factor.  Tightness is safe: cube-row wraps are CONTIGUOUS in
    cube-sorted order (cube ids (cy, gs-1) and (cy+1, 0) are adjacent), so
    a wrap-straddling subgroup's union of row ranges still fits one
    window; anything that doesn't fit is salvaged exactly as before.

    Flags: ``__err_gabriel_window`` (more misfit points than
    ``salvage_cap``: some points lost all their pairs),
    ``__err_grid_overflow`` (a salvaged point's 3-cube row exceeded
    ``row_cap``), ``__err_gabriel_candidates`` (a point had more
    within-cutoff candidates than ``max_candidates``).
    """
    n_pad = X.x.shape[0]
    gs = grid_size
    B = _block_size(n_pad, i_block)
    g = B if subgroup is None else max(1, min(subgroup, B))
    while B % g:
        g -= 1
    G = B // g
    Wr = min(window_cap, n_pad)
    # effective window: whole 64-element segments covering [w0, w0 + Wr)
    # at any alignment (one extra segment absorbs the round-down)
    assert n_pad % 64 == 0, "gabriel_windowed needs n_pad % 64 == 0"
    We = min((-(-Wr // 64) + 1) * 64, n_pad)
    NC = min(max_candidates, 9 * We)
    tables = build_grid(X, n, cube_size, gs)

    # cube-sorted channel matrix: one gather per pass builds it, every
    # window afterwards is a contiguous slice.  Row order: X leaves,
    # old_v x/y/z, stable id, sorted cube id, active flag.
    leaves_X, tree_X = jax.tree.flatten(X)
    nx = len(leaves_X)
    order = tables.order
    sorted_cid = tables.cid[order]
    srt = jnp.stack(
        [a[order] for a in leaves_X]
        + [old_v.x[order], old_v.y[order], old_v.z[order]]
        + [order.astype(jnp.float32),
           sorted_cid.astype(jnp.float32),
           (order < n).astype(jnp.float32)])          # [K + 6, n_pad]
    K = srt.shape[0]
    srt3 = srt.reshape(K, n_pad // 64, 64)             # aligned segments
    offs = _row_offsets(gs)                            # [9, 3]
    n_cubes = gs ** 3

    def eval_block(b0):
        isl = lambda a: jax.lax.dynamic_slice_in_dim(a, b0, B)
        blk = jax.lax.dynamic_slice(srt, (0, b0), (K, B))
        Xi = jax.tree.unflatten(tree_X, list(blk[:nx]))
        cid_i = blk[K - 2].astype(jnp.int32)
        act_i = blk[K - 1] > 0.5
        i_ids = isl(order)

        # per-i row ranges -> per-SUBGROUP shared window per row, anchored
        # at the subgroup-median ACTIVE point (actives occupy the block
        # prefix: the padded-point sentinel cube id sorts last).  A lone
        # misfit cannot shift the median, so windows cover the majority.
        qc = jnp.clip(cid_i[:, None, None] + offs[None], 0, n_cubes - 1)
        rs = jnp.min(tables.cube_start[qc], axis=2)    # [B, 9]
        re = jnp.max(tables.cube_end[qc], axis=2)      # [B, 9] inclusive
        rs_g = rs.reshape(G, g, 9)
        re_g = re.reshape(G, g, 9)
        act_g = act_i.reshape(G, g)
        # center each row's window on the PER-ROW median range over the
        # subgroup's non-empty entries (a point's row can be empty while
        # its neighbours' is not, so the median point's own ranges won't
        # do): the rs spread straddles the median symmetrically, so this
        # maximizes the fitting majority
        nonempty = act_g[:, :, None] & (rs_g <= re_g)
        rs_f = jnp.where(nonempty, rs_g, n_pad)        # empties sort last
        re_f = jnp.where(nonempty, re_g, n_pad)
        mid_r = (jnp.maximum(jnp.sum(nonempty, axis=1) - 1, 0)
                 // 2)[:, None]                        # [G, 1, 9]
        rs_med = jnp.take_along_axis(jnp.sort(rs_f, axis=1), mid_r,
                                     axis=1)[:, 0]     # [G, 9]
        re_med = jnp.take_along_axis(jnp.sort(re_f, axis=1), mid_r,
                                     axis=1)[:, 0]
        w0 = jnp.clip((rs_med + re_med - Wr) // 2, 0, n_pad - Wr)  # [G, 9]
        # ALIGNED fetch: round the window down to a 64-element segment
        # boundary and take whole segments (one row gather instead of an
        # arbitrary-offset dynamic slice per window); the wider effective
        # window only reduces misfits
        w0a = jnp.clip((w0 // 64) * 64, 0, max(n_pad - We, 0))  # [G, 9]
        # a point fits iff every non-empty row range sits inside its
        # subgroup's (effective) window
        row_empty = rs_g > re_g
        fit_g = jnp.all(row_empty | ((rs_g >= w0a[:, None])
                                     & (re_g <= w0a[:, None] + (We - 1))),
                        axis=2) & act_g                # [G, g]
        misfit = (act_g & ~fit_g).reshape(B)

        segs = (w0a // 64)[..., None] \
            + jnp.arange(We // 64, dtype=jnp.int32)    # [G, 9, nseg]
        win = jnp.take(srt3, segs.reshape(-1), axis=1) \
            .reshape(K, G, 9, We).transpose(1, 2, 0, 3)  # [G, 9, K, We]
        wpos = (w0a[:, :, None]
                + jnp.arange(We, dtype=jnp.int32)[None, None])  # [G, 9, We]
        # per-(i, row, w) validity: the window slot sits in i's row range
        valid = ((wpos[:, None] >= rs_g[..., None])
                 & (wpos[:, None] <= re_g[..., None])
                 & (win[:, None, :, K - 1] > 0.5))     # [G, g, 9, We]

        xj = win[:, None, :, 0]                        # [G, 1, 9, We]
        yj = win[:, None, :, 1]
        zj = win[:, None, :, 2]
        Xi_g = jax.tree.map(lambda a: a.reshape(G, g)[..., None, None], Xi)
        dist = jnp.sqrt((Xi_g.x - xj) ** 2 + (Xi_g.y - yj) ** 2
                        + (Xi_g.z - zj) ** 2)          # [G, g, 9, We]
        cand = valid & (dist < cube_size) & fit_g[..., None, None]
        n_cand = jnp.sum(cand, axis=(2, 3)).reshape(B)

        # NC nearest candidates (flattened over the 9 windows)
        key = jnp.where(cand, dist, jnp.inf).reshape(B, 9 * We)
        _, sel = jax.lax.top_k(-key, NC)                  # [B, NC]
        take = lambda a: jnp.take_along_axis(
            jnp.broadcast_to(a, (G, g, 9, We)).reshape(B, 9 * We),
            sel, axis=1)
        cand_s = jnp.take_along_axis(cand.reshape(B, 9 * We), sel, axis=1)
        dist_s = jnp.take_along_axis(dist.reshape(B, 9 * We), sel, axis=1)
        xj_s, yj_s, zj_s = take(xj), take(yj), take(zj)

        # midpoint test on the compact set: j AND k from the same NC list
        mx = (Xi.x[:, None] + xj_s) * 0.5
        my = (Xi.y[:, None] + yj_s) * 0.5
        mz = (Xi.z[:, None] + zj_s) * 0.5
        d2 = ((mx[:, :, None] - xj_s[:, None, :]) ** 2
              + (my[:, :, None] - yj_s[:, None, :]) ** 2
              + (mz[:, :, None] - zj_s[:, None, :]) ** 2)
        radius2 = (0.5 * dist_s * gabriel_coefficient) ** 2
        blocked = jnp.any(cand_s[:, None, :]
                          & (d2 < radius2[:, :, None]), axis=2)
        keep = cand_s & ~blocked

        # force evaluation on the kept pairs; j channels ride the compact
        # row-local take (XLA DCEs leaves the force never reads)
        Xi_b = jax.tree.map(lambda a: a[:, None], Xi)
        Xj = jax.tree.unflatten(
            tree_X, [take(win[:, None, :, k]) for k in range(nx)])
        Xj = Xj.replace(x=xj_s, y=yj_s, z=zj_s)
        ovj = tuple(take(win[:, None, :, nx + c]) for c in range(3))
        # REAL stable ids on both sides: reference forces use ids beyond
        # i == j semantics (growth_w_wall.cu:49-71 excludes the wall
        # node by index), so sorted-slot numbers would silently change
        # the physics.  The self-pair survives the midpoint test
        # naturally (radius 0 admits no blocker -- the reference's
        # is_self keep, solvers.cuh:572-597).
        pid_j = take(win[:, None, :, nx + 3])
        out = evaluate_pairs(pw_int, pw_friction, Xi_b, Xj, ovj,
                             i_ids.astype(jnp.float32)[:, None], pid_j,
                             keep, sum_axes=(1,))
        aux = out[3]
        # fitting points see their complete candidate rows inside the
        # window, so row clipping is impossible here; the key exists so
        # the salvage pass (which CAN overflow row_cap) merges into it
        aux["__err_grid_overflow"] = jnp.zeros(B, jnp.float32)
        aux["__err_gabriel_candidates"] = (
            (n_cand > NC) & fit_g.reshape(B)).astype(jnp.float32)
        return out, i_ids, misfit.astype(jnp.float32)

    starts = jnp.arange(n_pad // B, dtype=jnp.int32) * B
    (F, sum_f, sum_v, aux), ids, misfit = jax.lax.map(eval_block, starts)
    ids = ids.reshape(-1)

    def back(a, fill=0.0):
        flat = a.reshape((n_pad,) + a.shape[2:])
        return jnp.full(flat.shape, fill, flat.dtype) \
            .at[ids].set(flat, mode="drop", unique_indices=True)

    F, sum_f, sum_v, aux = (jax.tree.map(back, F), back(sum_f),
                            tuple(back(v) for v in sum_v),
                            {k: back(v) for k, v in aux.items()})

    # misfit salvage: the (few) points masked out of the windowed pass
    # get their EXACT Gabriel forces from a compacted gather pass.  A
    # fixed-size pass costs ~salvage_cap * 9 * row_cap gathered elements
    # (sub-ms) whether or not any misfits exist.
    misfit_g = back(misfit)                              # global order
    n_mis = jnp.sum(misfit_g > 0.5)
    mis_idx = jnp.nonzero(misfit_g > 0.5, size=salvage_cap,
                          fill_value=n_pad)[0].astype(jnp.int32)
    act_s = mis_idx < n_pad
    Fs, sum_fs, sum_vs, aux_s = _gabriel_block(
        pw_int, pw_friction, X, old_v, n, cube_size, tables,
        ids=jnp.clip(mis_idx, 0, n_pad - 1), act=act_s,
        grid_size=gs, row_cap=row_cap,
        gabriel_coefficient=gabriel_coefficient, max_candidates=NC)
    tgt = jnp.where(act_s, mis_idx, n_pad)
    put = lambda d, v: d.at[tgt].set(v, mode="drop", unique_indices=True)
    F = jax.tree.map(put, F, Fs)
    sum_f = put(sum_f, sum_fs)
    sum_v = tuple(put(a, b) for a, b in zip(sum_v, sum_vs))
    aux = {k: put(aux[k], aux_s[k]) for k in aux}
    # more misfits than the salvage capacity: the excess lost all pairs
    aux["__err_gabriel_window"] = jnp.broadcast_to(
        (n_mis > salvage_cap).astype(jnp.float32), (n_pad,))
    return F, sum_f, sum_v, aux
