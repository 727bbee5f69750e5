"""Cube-sorted neighbour sweep: the pair pass as a Pallas kernel (Triton).

The reference's grid solver (``solvers.cuh:345-502``) as it runs on the
card it was written for.  Cells are sorted by cube id (x-minor, ref
``solvers.cuh:349-365``).  The 27 neighbour cubes of a cell form 9 rows
of 3 consecutive x-cubes, and each row is ONE contiguous range of the
sorted order.  So:

* :func:`sweep_tables` sorts once per pass and derives, for every sorted
  cell, the ``[lo, hi)`` range of each of its 9 rows from a per-cube
  start table (a counting scatter and a prefix sum; no per-cube
  capacity, so nothing can overflow);
* the kernel gives each program ``BLOCK`` consecutive sorted cells with
  their i-side fields in registers.  For each row it walks the row's
  range with masked loads inside a ``fori_loop`` whose bound is the
  block's longest range.  The j-side fields come through L2 (the whole
  500k-cell state is ~22 MB); accumulators stay in registers and each
  output channel is stored once per cell.

The force contract is the one every engine keeps
(``ops/common.evaluate_pairs``): ``pw_int`` and ``pw_friction`` get
stable point ids, pairs at ``dist >= cube_size`` are masked, aux
channels are summed per cell, and the self pair is evaluated once per
cell with ``r = 0``.  The off-diagonal sweep uses ``pw_int.offdiag``
when the force declares one (same force without its i == j terms).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .common import cube_ids, grid_dims, out_of_grid_mask, \
    split_force_output

__all__ = ["sweep_tables", "sweep_pairwise", "BLOCK"]

# Sorted cells per program: one cell per thread at four warps.
BLOCK = 128
NUM_WARPS = 4


def sweep_tables(X, n, cube_size, grid_size):
    """``(order, lo, hi)`` for one pass.

    ``order[s]`` is the stable id at sorted position ``s`` (inactive
    points sort last).  ``lo[r, s]`` / ``hi[r, s]`` bound, in sorted
    positions, row ``r = 3 * (dz + 1) + (dy + 1)`` of the cell at sorted
    position ``s``: the cubes ``(cx - 1 .. cx + 1, cy + dy, cz + dz)``
    clipped to the grid.  Rows outside the grid, and inactive cells, get
    empty ranges.
    """
    gx, gy, gz = grid_dims(grid_size)
    n_cubes = gx * gy * gz
    n_pad = X.x.shape[0]
    cid = cube_ids(X, n, cube_size, grid_size)      # n_cubes if inactive
    iota = jnp.arange(n_pad, dtype=jnp.int32)
    scid, order = jax.lax.sort((cid, iota), num_keys=1)
    counts = jnp.zeros(n_cubes + 1, jnp.int32).at[cid].add(1)
    start = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts)])
    live = iota < n
    c = jnp.minimum(scid, n_cubes - 1)
    cx, cy, cz = c % gx, (c // gx) % gy, c // (gx * gy)
    x_lo = jnp.maximum(cx - 1, 0)
    x_hi = jnp.minimum(cx + 1, gx - 1)
    los, his = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            yy, zz = cy + dy, cz + dz
            ok = live & (yy >= 0) & (yy < gy) & (zz >= 0) & (zz < gz)
            row = (jnp.clip(zz, 0, gz - 1) * gy + jnp.clip(yy, 0, gy - 1)) * gx
            los.append(jnp.where(ok, start[row + x_lo], 0))
            his.append(jnp.where(ok, start[row + x_hi + 1], 0))
    return order, jnp.stack(los), jnp.stack(his)


def _force_structure(pw_int, X):
    """(dF treedef, number of dF leaves, aux keys) of a force's output."""
    one = jax.tree.map(lambda a: jnp.zeros((1,), a.dtype), X)
    ids = jnp.zeros((1,), jnp.int32)
    dF, aux = split_force_output(
        pw_int(one, one - one, jnp.ones((1,), jnp.float32), ids, ids))
    leaves, tree = jax.tree.flatten(dF)
    return tree, len(leaves), list(aux.keys())


def sweep_pairwise(pw_int, pw_friction, X, old_v, n, cube_size, *,
                   grid_size, interpret=False):
    """Pairwise sums over all pairs closer than ``cube_size`` (the grid
    engines' cutoff, ref solvers.cuh:450), in stable-id order.

    Returns ``(F, sum_friction, sum_v, aux)`` like every engine's
    ``pairwise``.  ``aux["__err_out_of_grid"]`` flags active cells whose
    cube lies outside ``grid_size`` (they are clipped into edge cubes
    and would be mis-binned).  ``interpret=True`` runs the kernel in the
    Pallas interpreter (tests only); otherwise it is compiled for the
    GPU through Triton.
    """
    n_pad = X.x.shape[0]
    order, lo, hi = sweep_tables(X, n, cube_size, grid_size)
    n_blk = -(-n_pad // BLOCK) * BLOCK
    extra = n_blk - n_pad

    leaves, x_tree = jax.tree.flatten(X)
    nf = len(leaves)
    chans = jnp.stack([a.astype(jnp.float32) for a in leaves]
                      + [old_v.x, old_v.y, old_v.z])[:, order]
    chans = jnp.pad(chans, ((0, 0), (0, extra)))
    sid = jnp.pad(order, (0, extra))
    lo = jnp.pad(lo, ((0, 0), (0, extra))).reshape(-1)
    hi = jnp.pad(hi, ((0, 0), (0, extra))).reshape(-1)
    cut = jnp.reshape(jnp.asarray(cube_size, jnp.float32), (1,))
    n_arr = jnp.reshape(jnp.asarray(n, jnp.int32), (1,))

    dF_tree, n_dF, aux_keys = _force_structure(pw_int, X)
    n_acc = n_dF + 4 + len(aux_keys)
    pw_off = getattr(pw_int, "offdiag", None) or pw_int

    def kernel(cut_ref, n_ref, sid_ref, lo_ref, hi_ref, chan_ref, out_ref):
        idx = pl.program_id(0) * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
        cutoff = cut_ref[0]
        live = idx < n_ref[0]

        def load_cell(j, mask=None):
            vals = [plgpu.load(chan_ref.at[k * n_blk + j], mask=mask,
                               other=None if mask is None else 0.0)
                    for k in range(nf + 3)]
            sid_j = plgpu.load(sid_ref.at[j], mask=mask,
                               other=None if mask is None else 0)
            return jax.tree.unflatten(x_tree, vals[:nf]), vals[nf:], sid_j

        Xi, ov_i, sid_i = load_cell(idx)

        def pair_terms(fn, Xj, ovj, sid_j, ok):
            r = Xi - Xj
            dist = jnp.sqrt(r.x * r.x + r.y * r.y + r.z * r.z)
            ok = ok & (dist < cutoff)
            dF, aux = split_force_output(fn(Xi, r, dist, sid_i, sid_j))
            fr = pw_friction(Xi, r, dist, sid_i, sid_j)

            def masked(v):
                v = jnp.broadcast_to(jnp.asarray(v, jnp.float32), (BLOCK,))
                return jnp.where(ok, v, 0.0)

            fr = masked(fr)
            return ([masked(v) for v in jax.tree.leaves(dF)]
                    + [fr, fr * ovj[0], fr * ovj[1], fr * ovj[2]]
                    + [masked(aux[k]) for k in aux_keys])

        # the self pair, once per cell: r == 0, dist == 0, j == i
        acc = tuple(pair_terms(pw_int, Xi, ov_i, sid_i, live))
        for row in range(9):
            lo_r = plgpu.load(lo_ref.at[row * n_blk + idx])
            cnt = jnp.where(live, plgpu.load(hi_ref.at[row * n_blk + idx])
                            - lo_r, 0)

            def body(k, acc, lo_r=lo_r, cnt=cnt):
                m = k < cnt
                j = jnp.where(m, lo_r + k, 0)
                Xj, ovj, sid_j = load_cell(j, m)
                vals = pair_terms(pw_off, Xj, ovj, sid_j, m & (j != idx))
                return tuple(a + v for a, v in zip(acc, vals))

            acc = jax.lax.fori_loop(0, jnp.max(cnt), body, acc)
        for a, v in enumerate(acc):
            plgpu.store(out_ref.at[a * n_blk + idx], v)

    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n_acc * n_blk,), jnp.float32),
        grid=(n_blk // BLOCK,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="sweep_pairwise",
    )(cut, n_arr, sid, lo, hi, chans.reshape(-1))

    # back to stable-id order through the inverse permutation
    rank = jnp.zeros(n_pad, jnp.int32).at[order].set(
        jnp.arange(n_pad, dtype=jnp.int32), unique_indices=True)
    res = out.reshape(n_acc, n_blk)[:, rank]
    F = jax.tree.unflatten(dF_tree, list(res[:n_dF]))
    sum_f = res[n_dF]
    sum_v = (res[n_dF + 1], res[n_dF + 2], res[n_dF + 3])
    aux = {k: res[n_dF + 4 + i] for i, k in enumerate(aux_keys)}
    aux["__err_out_of_grid"] = out_of_grid_mask(
        X, n, cube_size, grid_size).astype(jnp.float32)
    return F, sum_f, sum_v, aux
