"""Links between points (protrusions) and solid walls.

Rebuild of ``include/links.cuh``.  A link table
is a fixed-capacity array of (a, b) index pairs with its own active count;
``a == b`` marks an inactive link (ref links.cuh:121-122).  Forces are
applied to both endpoints with scatter-add (``.at[].add``) -- the race-free
equivalent of the reference's ``atomicAdd`` (links.cuh:105-110) -- and enter
the solver through the ``GenericForce`` hook.

Randomness for protrusion rewiring uses counter-based ``jax.random`` keys
held by the ``Links`` object, replacing per-link ``curandState``
(links.cuh:39-44); seeds are explicit for reproducibility.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .dtypes import pt_zeros_like
from .solvers import GenericForce

__all__ = ["Links", "linear_force", "link_forces", "wall_forces",
           "link_wall_forces", "xy_wall_relu_force"]


def _pad(n):
    return max(64, -(-int(n) // 64) * 64)


class Links:
    """Fixed-capacity link container (ref links.cuh:24-91)."""

    def __init__(self, n_max, strength=1.0 / 5, seed=None):
        self.n_max = int(n_max)
        self.n_pad = _pad(self.n_max)
        self.strength = float(strength)
        self.h_a = np.zeros(self.n_pad, np.int32)
        self.h_b = np.zeros(self.n_pad, np.int32)
        self.h_n = self.n_max
        self.d_a = jnp.zeros(self.n_pad, jnp.int32)
        self.d_b = jnp.zeros(self.n_pad, jnp.int32)
        self.d_n = jnp.int32(self.n_max)
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2 ** 63))
        self.key = jax.random.PRNGKey(seed)

    def next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def set_d_n(self, n):
        assert n <= self.n_max
        self.d_n = jnp.int32(n)

    def get_d_n(self):
        n = int(self.d_n)
        assert n <= self.n_max
        return n

    def copy_to_device(self):
        assert self.h_n <= self.n_max
        self.d_a = jnp.asarray(self.h_a)
        self.d_b = jnp.asarray(self.h_b)
        self.d_n = jnp.int32(self.h_n)

    def copy_to_host(self):
        # np.array (not asarray): the host mirror must be writable
        self.h_a = np.array(self.d_a)
        self.h_b = np.array(self.d_b)
        self.h_n = int(self.d_n)
        assert self.h_n <= self.n_max

    def reset(self, check=None):
        """Deactivate links for which ``check(a, b)`` is True (all by
        default), ref links.cuh:66-76.  ``check`` may be vectorized
        (numpy arrays in, bool array out) or a scalar predicate."""
        self.copy_to_host()
        if check is None:
            self.h_a[:] = 0
            self.h_b[:] = 0
        else:
            a = self.h_a[:self.n_max]
            b = self.h_b[:self.n_max]
            try:
                kill = np.asarray(check(a, b), dtype=bool)
                if kill.shape != a.shape:
                    raise TypeError
            except Exception:
                kill = np.fromiter(
                    (bool(check(int(x), int(y))) for x, y in zip(a, b)),
                    dtype=bool, count=self.n_max)
            a[kill] = 0
            b[kill] = 0
        self.copy_to_device()

    @property
    def state(self):
        return (self.d_a, self.d_b, self.d_n, jnp.float32(self.strength))

    def update(self, rule, cells):
        """Protrusion rewiring (pattern P2 of the reference models, e.g.
        ``examples/intercalation.cu:32-56``): apply a jitted per-link rule
        ``rule(a, b, X, n_cells, key) -> (a', b')`` that may draw randoms
        with shapes ``[n_pad]`` from its key.  Replaces the per-model
        ``update_protrusions`` CUDA kernels with their curand state."""
        fn = _rule_jit(rule)
        self.d_a, self.d_b = fn(self.d_a, self.d_b, self.d_n, cells.d_X,
                                cells.d_n, self.next_key())


def random_cube_neighbours(X, n_cells, cube_size, grid_size, src, key):
    """For each source cell, draw a random cell from a random one of its 27
    neighbour cubes -- the protrusion-proposal pattern of the reference's
    grid-sampled rewiring kernels (``examples/growth_w_wall.cu:99-136``,
    ``intercalation_w_gradient.cu:119-173``).

    Returns (candidate ids, found mask).  Use inside a ``Links.update``
    rule; builds the spatial hash on the fly.
    """
    from .ops.grid_xla import build_grid, _row_offsets
    m = src.shape[0]
    gs = grid_size
    n_cubes = gs ** 3
    tables = build_grid(X, n_cells, cube_size, gs)
    k1, k2 = jax.random.split(key)
    offs27 = _row_offsets(gs).reshape(27)
    pick_cube = jax.random.randint(k1, (m,), 0, 27)
    c = jnp.clip(tables.cid[src] + offs27[pick_cube], 0, n_cubes - 1)
    start = tables.cube_start[c]
    end = tables.cube_end[c]
    cnt = end - start + 1
    u = jax.random.uniform(k2, (m,))
    pick = start + jnp.minimum((u * cnt).astype(jnp.int32),
                               jnp.maximum(cnt - 1, 0))
    n_pad = tables.order.shape[0]
    cand = tables.order[jnp.clip(pick, 0, n_pad - 1)]
    return cand, cnt >= 1


@lru_cache(maxsize=None)
def _rule_jit(rule):
    @jax.jit
    def fn(a, b, n_links, X, n_cells, key):
        live = jnp.arange(a.shape[0], dtype=jnp.int32) < n_links
        a2, b2 = rule(a, b, X, n_cells, key)
        return jnp.where(live, a2, a), jnp.where(live, b2, b)
    return fn


def linear_force(Xa, Xb, r, dist, strength):
    """Unit-vector spring of constant magnitude (ref links.cuh:99-111).
    Returns (dFa, dFb)."""
    safe = jnp.where(dist > 0, dist, 1.0)
    fx = strength * r.x / safe
    fy = strength * r.y / safe
    fz = strength * r.z / safe
    dFa = pt_zeros_like(Xa).replace(x=-fx, y=-fy, z=-fz)
    dFb = pt_zeros_like(Xb).replace(x=fx, y=fy, z=fz)
    return dFa, dFb


@lru_cache(maxsize=None)
def _link_gen_fn(force):
    def fn(X, n_cells, args):
        a, b, n_links, strength = args
        m_pad = a.shape[0]
        live = (jnp.arange(m_pad, dtype=jnp.int32) < n_links) & (a != b)
        Xa = jax.tree.map(lambda f: f[a], X)
        Xb = jax.tree.map(lambda f: f[b], X)
        r = Xa - Xb
        dist = jnp.sqrt(r.x * r.x + r.y * r.y + r.z * r.z)
        dFa, dFb = force(Xa, Xb, r, dist, strength)
        dX = pt_zeros_like(X)
        upd = {}
        for f in X._fields:
            fa = jnp.where(live, jnp.broadcast_to(getattr(dFa, f), live.shape),
                           0.0)
            fb = jnp.where(live, jnp.broadcast_to(getattr(dFb, f), live.shape),
                           0.0)
            upd[f] = getattr(dX, f).at[a].add(fa).at[b].add(fb)
        return dX.replace(**upd)
    return fn


def link_forces(links: Links, force=linear_force, fields=None):
    """GenericForce applying ``force`` over the link table
    (ref links.cuh:128-140).  ``fields`` names the Pt fields the force
    writes (auto-detected as x/y/z for the default ``linear_force``); the
    lattice-resident fast path translates only those channels."""
    if fields is None and force is linear_force:
        fields = ("x", "y", "z")
    return GenericForce(fn=_link_gen_fn(force), args=links.state,
                        fields=fields)


# --------------------------------------------------------------------------
# Walls (ref links.cuh:142-228): planes tracked by a "wall node" point.
# --------------------------------------------------------------------------

def xy_wall_relu_force(X, i, wall_idx):
    """ReLU band force on point-to-plane distance for a wall normal to Z
    (ref links.cuh:157-169).  Returns (F_z per point, interacting mask)."""
    z_wall = X.z[wall_idx]
    dist_wall = jnp.abs(X.z - z_wall)
    interacting = (dist_wall < 1.0) & (i != wall_idx)
    F = jnp.maximum(0.8 - dist_wall, 0) - jnp.maximum(dist_wall - 0.8, 0)
    return jnp.where(interacting, F, 0.0), interacting


@lru_cache(maxsize=None)
def _wall_gen_fn(w_force, with_links, link_force):
    def fn(X, n_cells, args):
        if with_links:
            link_args, wall_idx = args
            dX = _link_gen_fn(link_force)(X, n_cells, link_args)
        else:
            wall_idx = args
            dX = pt_zeros_like(X)
        n_pad = X.x.shape[0]
        i = jnp.arange(n_pad, dtype=jnp.int32)
        active = i < n_cells
        F, interacting = w_force(X, i, wall_idx)
        F = jnp.where(active, F, 0.0)
        interacting = interacting & active
        n_ints = jnp.sum(interacting)
        # Reaction on the wall node, averaged over interactions
        # (ref links.cuh:166-167, 183-195).  The division applies to the
        # wall node's entire generic-force dX, as in update_wall_node.
        wall_reaction = -jnp.sum(F)
        dX = dX.replace(z=dX.z + F)
        scale = jnp.where(n_ints > 0, 1.0 / jnp.maximum(n_ints, 1), 1.0)
        upd = {}
        for f in ("x", "y", "z"):
            arr = getattr(dX, f)
            val = arr[wall_idx] + (wall_reaction if f == "z" else 0.0)
            upd[f] = arr.at[wall_idx].set(val * scale)
        return dX.replace(**upd)
    return fn


def wall_forces(wall_idx, w_force=xy_wall_relu_force, fields=("x", "y", "z")):
    """Wall node, no links (ref links.cuh:198-210)."""
    return GenericForce(fn=_wall_gen_fn(w_force, False, None),
                        args=jnp.int32(wall_idx), fields=fields)


def link_wall_forces(links: Links, wall_idx, l_force=linear_force,
                     w_force=xy_wall_relu_force, fields=None):
    """Wall node + links (ref links.cuh:213-228)."""
    if fields is None and l_force is linear_force:
        fields = ("x", "y", "z")
    return GenericForce(fn=_wall_gen_fn(w_force, True, l_force),
                        args=(links.state, jnp.int32(wall_idx)),
                        fields=fields)
