"""Proliferation (dynamic N) and lineage tracing as framework features.

The reference implements cell division per model with ``atomicAdd`` slot
allocation (e.g. ``examples/branching.cu:113-170``, ``passive_growth.cu:
60-91``): thread i draws a uniform, applies gates, claims slot
``n = atomicAdd(d_n_cells, 1)``, places the daughter at the parent plus a
random ``mean_distance / 4`` offset, halves conserved fields, and copies
``d_old_v``.  Newborn cells are protected from dividing by the guard
``i >= n * (1 - rate)``.

Translation: capacity is static; a boolean *division mask* is
turned into daughter slots by an exclusive prefix sum (replacing the atomic
counter -- birth order differs from the reference, which is fine because the
reference itself is nondeterministic through atomics and time-seeded RNG).

Daughters always land in the CONTIGUOUS slot range ``[n, n + k)``, so the
writes are windowed: a ``birth_cap``-wide window of each array is updated
with ``lax.dynamic_update_slice`` after gathering the (few) dividing
parents through a ``searchsorted`` on the prefix sum.  A full-width
scatter (``.at[tgt].set`` with mostly-dropped targets) costs in proportion
to its update count, not its hit count; the windowed form is O(birth_cap)
per channel, so the flagship's per-substep division pass stays small.  Parent-side field updates stay elementwise (``where(ok, ...)``).

Lineage tracing (``branching.cu:46-55, 154-169``) records a tree node per
division into preallocated arrays with its own prefix-sum-allocated counter,
windowed the same way at the node cursor.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .dtypes import Float3

__all__ = ["proliferate", "DivisionInfo", "Lineage", "lineage_init",
           "record_divisions"]


class DivisionInfo(NamedTuple):
    ok: jnp.ndarray         # bool[n_pad]: cell i divided this call
    child_idx: jnp.ndarray  # int32[n_pad]: daughter slot (valid where ok)
    n_divided: jnp.ndarray  # int32 scalar
    n_lost: jnp.ndarray     # int32 scalar: divisions dropped at capacity
    #                         (the reference hard-asserts instead,
    #                          solvers.cuh:82; callers must check)


def _auto_birth_cap(n_pad):
    """Window width: full for small states (exact legacy semantics), a
    generous fraction for large ones (~3% of slots; divisions per pass in
    every reference model are a few permille of n at most)."""
    return n_pad if n_pad <= 2048 else min(n_pad, max(2048, n_pad // 32))


def _random_unit(key, n_pad):
    """Uniform directions via the reference's own parameterization
    (theta = acos(2u - 1), phi = 2 pi u; branching.cu:141-143)."""
    k1, k2 = jax.random.split(key)
    theta = jnp.arccos(2.0 * jax.random.uniform(k1, (n_pad,)) - 1.0)
    phi = jax.random.uniform(k2, (n_pad,)) * (2.0 * jnp.pi)
    return Float3(x=jnp.sin(theta) * jnp.cos(phi),
                  y=jnp.sin(theta) * jnp.sin(phi),
                  z=jnp.cos(theta))


def _window_place(base, child_vals, s, is_child, src, W):
    """Overlay ``child_vals[src]`` onto ``base[s : s + W]`` where
    ``is_child``; exact for any clamped window start s."""
    win = jax.lax.dynamic_slice_in_dim(base, s, W)
    win = jnp.where(is_child, child_vals[src], win)
    return jax.lax.dynamic_update_slice_in_dim(base, win, s, axis=0)


@partial(jax.jit, static_argnums=(0, 1, 7))
def proliferate(want_fn, child_fn, X, old_v, n, key, props=(),
                birth_cap=None):
    """One division pass.

    want_fn(X, props, rnd, i, n) -> bool[n_pad]
        division decision per cell; ``rnd`` is a fresh uniform [n_pad].
        Apply rate gates / newborn guards here (cf. branching.cu:118-137).
    child_fn(X, props, direction, i) -> (X_parent, X_child)
        how fields split between parent and daughter; ``direction`` is a
        random unit Float3 per cell (scale it by mean_distance / 4 to match
        the reference placement).
    props: tuple of int/float arrays copied parent -> daughter verbatim.
    birth_cap: static max divisions applied per call (window width);
        defaults to all of n_pad below 2048 slots, n_pad / 32 above.
        Divisions beyond it (or beyond n_pad capacity) are dropped and
        counted in ``n_lost`` -- the same accounting the capacity bound
        already has (ref hard-asserts at n_max, solvers.cuh:82).

    Returns (X', old_v', n', props', DivisionInfo).
    """
    n_pad = X.x.shape[0]
    W = _auto_birth_cap(n_pad) if birth_cap is None else min(birth_cap, n_pad)
    i = jnp.arange(n_pad, dtype=jnp.int32)
    active = i < n
    k_rnd, k_dir = jax.random.split(key)
    rnd = jax.random.uniform(k_rnd, (n_pad,))
    want = want_fn(X, props, rnd, i, n) & active

    offs = jnp.cumsum(want.astype(jnp.int32))
    child_idx = n + offs - 1
    # both cutoffs are monotone in offs, so the surviving divisions are
    # exactly the first n_divided wants (a slot-ordered prefix)
    ok = want & (child_idx < n_pad) & (offs <= W)
    n_divided = jnp.sum(ok.astype(jnp.int32))
    n_lost = jnp.sum(want.astype(jnp.int32)) - n_divided

    direction = _random_unit(k_dir, n_pad)
    X_parent, X_child = child_fn(X, props, direction, i)

    # parent of the k-th division (k in [0, W)): the first i with offs == k+1
    parent_of = jnp.searchsorted(
        offs, jnp.arange(1, W + 1, dtype=offs.dtype), side="left"
    ).astype(jnp.int32)
    # daughters occupy global slots [n, n + n_divided); clamp the window so
    # it stays in bounds, then mask by true slot identity
    s = jnp.clip(n, 0, n_pad - W).astype(jnp.int32)
    g = s + jnp.arange(W, dtype=jnp.int32)
    is_child = (g >= n) & (g < n + n_divided)
    src = parent_of[jnp.clip(g - n, 0, W - 1)]
    src = jnp.where(is_child, src, 0)

    def place(cur, parent_new, child):
        base = jnp.where(ok, parent_new, cur)
        return _window_place(base, child, s, is_child, src, W)

    X_new = jax.tree.map(place, X, X_parent, X_child)
    old_v_new = jax.tree.map(
        lambda a: _window_place(a, a, s, is_child, src, W), old_v)
    # scalars pass through untouched (e.g. dynamic rates for want_fn)
    props_new = tuple(
        p if jnp.ndim(p) == 0 else _window_place(p, p, s, is_child, src, W)
        for p in props)
    return (X_new, old_v_new, n + n_divided, props_new,
            DivisionInfo(ok=ok, child_idx=child_idx, n_divided=n_divided,
                         n_lost=n_lost))


# --------------------------------------------------------------------------
# Lineage tracing (ref branching.cu:46-55, 154-169, 283-339)
# --------------------------------------------------------------------------

class Lineage(NamedTuple):
    """Preallocated tree-node arrays + per-cell parent/clone labels."""
    n_nodes: jnp.ndarray        # int32 scalar
    node_x: jnp.ndarray         # f32[cap]
    node_y: jnp.ndarray
    node_z: jnp.ndarray
    node_time: jnp.ndarray      # f32[cap]
    node_parent: jnp.ndarray    # int32[cap]
    node_clone: jnp.ndarray     # int32[cap]
    node_type: jnp.ndarray      # int32[cap]
    cell_parent: jnp.ndarray    # int32[n_pad], -1 = root
    cell_clone: jnp.ndarray     # int32[n_pad]


def lineage_init(cap, n_pad, n_0):
    """Founders get clone id i + 1 and no parent (branching.cu:222-228)."""
    i = jnp.arange(n_pad, dtype=jnp.int32)
    return Lineage(
        n_nodes=jnp.int32(0),
        node_x=jnp.zeros(cap, jnp.float32),
        node_y=jnp.zeros(cap, jnp.float32),
        node_z=jnp.zeros(cap, jnp.float32),
        node_time=jnp.zeros(cap, jnp.float32),
        node_parent=jnp.full(cap, -1, jnp.int32),
        node_clone=jnp.zeros(cap, jnp.int32),
        node_type=jnp.zeros(cap, jnp.int32),
        cell_parent=jnp.full(n_pad, -1, jnp.int32),
        cell_clone=jnp.where(i < n_0, i + 1, 0),
    )


@partial(jax.jit, static_argnums=(5,))
def record_divisions(lin: Lineage, info: DivisionInfo, X, cell_type,
                     time_progression, birth_cap=None):
    """Append one internal node per division; relabel parent + daughter
    (branching.cu:154-169).  ``birth_cap`` must match the value given to
    ``proliferate`` (both default to the same n_pad-derived window)."""
    cap = lin.node_x.shape[0]
    n_pad = info.ok.shape[0]
    W = _auto_birth_cap(n_pad) if birth_cap is None else min(birth_cap, n_pad)
    Wn = min(W, cap)
    offs = jnp.cumsum(info.ok.astype(jnp.int32))
    node_idx = lin.n_nodes + offs - 1

    # parent (cell index) of the k-th division this call
    parent_of = jnp.searchsorted(
        offs, jnp.arange(1, W + 1, dtype=offs.dtype), side="left"
    ).astype(jnp.int32)
    n_div = jnp.sum(info.ok.astype(jnp.int32))

    # ---- node window at the node cursor --------------------------------
    sn = jnp.clip(lin.n_nodes, 0, cap - Wn).astype(jnp.int32)
    gn = sn + jnp.arange(Wn, dtype=jnp.int32)
    is_node = (gn >= lin.n_nodes) & (gn < lin.n_nodes + n_div) & (gn < cap)
    psrc = parent_of[jnp.clip(gn - lin.n_nodes, 0, W - 1)]
    psrc = jnp.where(is_node, psrc, 0)

    def put_node(arr, vals):
        win = jax.lax.dynamic_slice_in_dim(arr, sn, Wn)
        win = jnp.where(is_node, vals, win)
        return jax.lax.dynamic_update_slice_in_dim(arr, win, sn, axis=0)

    # ---- daughter window in cell space ([n, n + n_div)) ----------------
    # the cell count n is info.child_idx of the first divider (child slots
    # are allocated from n upward); degenerate when nothing divided
    n_cells = jnp.where(n_div > 0, info.child_idx[parent_of[0]], 0)
    sc = jnp.clip(n_cells, 0, n_pad - W).astype(jnp.int32)
    gc = sc + jnp.arange(W, dtype=jnp.int32)
    is_child = (gc >= n_cells) & (gc < n_cells + n_div)
    csrc = parent_of[jnp.clip(gc - n_cells, 0, W - 1)]
    csrc = jnp.where(is_child, csrc, 0)
    child_node = lin.n_nodes + (gc - n_cells)  # node id of the child's parent

    def put_child(arr, vals):
        win = jax.lax.dynamic_slice_in_dim(arr, sc, W)
        win = jnp.where(is_child, vals, win)
        return jax.lax.dynamic_update_slice_in_dim(arr, win, sc, axis=0)

    cell_parent_par = jnp.where(info.ok, node_idx, lin.cell_parent)
    new = lin._replace(
        n_nodes=lin.n_nodes + n_div,
        node_x=put_node(lin.node_x, X.x[psrc]),
        node_y=put_node(lin.node_y, X.y[psrc]),
        node_z=put_node(lin.node_z, X.z[psrc]),
        node_time=put_node(lin.node_time,
                           jnp.full(Wn, time_progression,
                                    lin.node_time.dtype)),
        node_parent=put_node(lin.node_parent, lin.cell_parent[psrc]),
        node_clone=put_node(lin.node_clone, lin.cell_clone[psrc]),
        node_type=put_node(lin.node_type, cell_type[psrc]),
        cell_clone=put_child(lin.cell_clone, lin.cell_clone[csrc]),
        cell_parent=put_child(cell_parent_par,
                              jnp.where(is_child, child_node, 0)),
    )
    return new
