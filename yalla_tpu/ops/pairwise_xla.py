"""All-pairs O(N^2) pairwise engine (XLA path).

Rebuild of the reference's GPU-Gems-31 tiled N-body kernel
``compute_tile`` (``include/solvers.cuh:282-339``): instead
of staging 32 j-points in CUDA shared memory, we stream j-blocks through a
``lax.scan`` so that only an ``[n_pad, B]`` pair block is live at a time;
XLA fuses the force evaluation into the block reduction.

All pairs are evaluated, including i == j -- models rely on the diagonal for
reaction/self terms (e.g. Meinhardt kinetics, ``examples/turing.cu:38-46``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .common import evaluate_pairs

__all__ = ["tile_pairwise"]


def tile_pairwise(pw_int, pw_friction, X, old_v, n, *, j_block=None,
                  i_offset=0, i_size=None):
    """Compute pairwise sums over all pairs for points
    ``[i_offset, i_offset + i_size)`` (default: everyone) against everyone.

    Args:
      X: Pt of ``f32[n_pad]`` field arrays.
      old_v: Pt-like with x, y, z ``f32[n_pad]`` (previous velocities).
      n: active point count (traced scalar).
      j_block: static j-block size; must divide n_pad.  ``None`` chooses
        full-broadcast for small n_pad, 1024-blocks otherwise.

    Returns: (dF (Pt [i_size]), sum_friction [i_size], sum_v ([i_size],)*3,
      aux dict of [i_size]).
    """
    n_pad = X.x.shape[0]
    if i_size is None:
        i_size = n_pad
    idx = jnp.arange(n_pad, dtype=jnp.int32)
    i_idx = i_offset + jnp.arange(i_size, dtype=jnp.int32)

    blk = lambda a: jax.lax.dynamic_slice_in_dim(a, i_offset, i_size)
    Xi = jax.tree.map(lambda a: blk(a)[:, None], X)
    i_arr = i_idx[:, None]

    if j_block is None:
        j_block = n_pad if n_pad <= 2048 else 1024
    while n_pad % j_block:
        j_block //= 2
    assert j_block >= 1, (n_pad, j_block)

    def eval_block(jb):
        """jb: int32[j_block] of j indices."""
        Xj = jax.tree.map(lambda a: a[jb][None, :], X)
        ovj = (old_v.x[jb][None, :], old_v.y[jb][None, :],
               old_v.z[jb][None, :])
        j_arr = jb[None, :]
        pair_mask = (i_arr < n) & (jb < n)[None, :]
        return evaluate_pairs(pw_int, pw_friction, Xi, Xj, ovj, i_arr, j_arr,
                              pair_mask, sum_axes=(1,))

    if j_block == n_pad:
        return eval_block(idx)

    j_blocks = idx.reshape(n_pad // j_block, j_block)

    def body(carry, jb):
        F, sum_f, sum_v, aux = carry
        dF, d_sum_f, d_sum_v, d_aux = eval_block(jb)
        F = jax.tree.map(jnp.add, F, dF)
        sum_f = sum_f + d_sum_f
        sum_v = tuple(a + b for a, b in zip(sum_v, d_sum_v))
        aux = {k: aux[k] + d_aux[k] for k in aux}
        return (F, sum_f, sum_v, aux), None

    # One probe evaluation to learn the aux structure, folded into the init.
    init = eval_block(j_blocks[0])
    (F, sum_f, sum_v, aux), _ = jax.lax.scan(body, init, j_blocks[1:])
    return F, sum_f, sum_v, aux
