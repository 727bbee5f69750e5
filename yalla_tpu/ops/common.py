"""Shared pair-evaluation machinery for all neighbor engines.

The user-facing pairwise contract mirrors the reference's
``Pairwise_interaction`` / ``Pairwise_friction`` functors
(``include/solvers.cuh:15-41``):

    pw_int(Xi, r, dist, i, j) -> dF            (a Pt)
                               | (dF, aux)      (aux: dict name -> per-pair array)

with ``r = Xi - Xj``.  Unlike the reference (one CUDA thread per point), the
function here is an *elementwise jnp function over blocks of pairs*: every
argument is an array (or a Pt of arrays) of one broadcastable pair-block
shape.  The same user code therefore runs unchanged in the O(N^2) engine,
the spatial-hash grid engine, the Gabriel engine, and the sweep kernel.

The optional ``aux`` channel replaces the reference's global-memory
side-channels (e.g. neighbour counters incremented inside force functors,
``examples/branching.cu:104-107``): per-pair values are masked and summed
over neighbours into named per-cell accumulators -- race-free by
construction, no atomics.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

__all__ = [
    "friction_w_neighbour",
    "friction_on_background",
    "evaluate_pairs",
    "apply_derived_aux",
    "apply_post_pair",
    "mask_tree",
    "cube_coord",
    "cube_ids",
    "grid_dims",
    "grid_for",
    "central_force",
    "CENTRAL_SENTINEL",
    "out_of_grid_mask",
    "split_force_output",
    "ERR_PREFIX",
]

# Reserved aux-channel prefix for in-loop failure flags (the rebuild of the
# reference's in-kernel D_ASSERTs, cudebug.cuh:8-35, solvers.cuh:82,90,
# 153-154).  Engines and the integrator publish per-cell error indicators
# under this prefix; ``Solution`` checks them after every launch and raises.
ERR_PREFIX = "__err_"


def friction_w_neighbour(Xi, r, dist, i, j):
    """Default friction: points closer than 1 exert friction on each other
    (ref solvers.cuh:27-35)."""
    return jnp.where((i != j) & (dist < 1.0), 1.0, 0.0)


def friction_on_background(Xi, r, dist, i, j):
    """No neighbour friction, drag against the background only
    (ref solvers.cuh:37-41)."""
    return jnp.zeros_like(dist)


# Distance a central force's coefficient sees on the i == j diagonal:
# past every physical cutoff, small enough that polynomial coefficients
# of dist stay finite in f32.
CENTRAL_SENTINEL = 1e4


class _CentralForce:
    """Callable satisfying the generic pairwise contract; see
    ``central_force``."""

    def __init__(self, Pt, coef, fields, bilinear, aux, diag, name):
        self.Pt = Pt
        self.coef = coef
        self.fields = tuple(fields)
        self.bilinear = dict(bilinear or {})
        self.aux = dict(aux or {})
        self.diag = diag
        self.__name__ = name

    # -- generic elementwise evaluation (any engine) ------------------------
    def _channels(self, Xi, r):
        Si = {f: getattr(Xi, f) for f in self.fields}
        Sj = {f: getattr(Xi, f) - getattr(r, f) for f in self.fields}
        Xj = Xi - r
        ch = {}
        for name, (fa, fb) in self.bilinear.items():
            a, b = fa(Xi), fb(Xj)
            ch[name] = sum(ai * bi for ai, bi in zip(a, b))
        return Si, Sj, ch

    def __call__(self, Xi, r, dist, i, j):
        Si, Sj, ch = self._channels(Xi, r)
        off = (i != j)
        # poisoned dist on the diagonal: the coefficient's own cutoff
        # gating excludes the self pair
        d = jnp.where(off, dist, CENTRAL_SENTINEL)
        w = self.coef(d, Si, Sj, **ch)
        zero = jnp.zeros_like(dist + w)
        vals = {"x": w * r.x, "y": w * r.y, "z": w * r.z}
        if self.diag is not None:
            dPt = self.diag(Xi)
            on = 1.0 - off.astype(w.dtype)
            for f in self.Pt._fields:
                dv = getattr(dPt, f)
                if f in vals:
                    vals[f] = vals[f] + on * dv
                elif dv is not None:
                    vals[f] = on * dv
        dF = self.Pt(**{f: vals.get(f, zero) for f in self.Pt._fields})
        if not self.aux:
            return dF
        return dF, {k: g(d, Si, Sj, **ch) for k, g in self.aux.items()}


def central_force(Pt, coef, *, fields=(), bilinear=None, aux=None,
                  diag=None, name="central_force"):
    """Declare a central pairwise force.

    ``coef(dist, Si, Sj, **bilinear_channels) -> w`` is the radial
    coefficient (``dF_xyz = w * r``); ``Si``/``Sj`` are dicts of the
    named per-cell scalar ``fields`` for each side.  ``bilinear`` maps a
    channel name to ``(a, b)`` with ``a(X) -> tuple`` / ``b(X) -> tuple``
    of per-cell columns; the channel delivered to ``coef`` is
    ``sum_k a_k(Xi) * b_k(Xj)``.  ``aux``
    maps names to per-pair functions with coef's signature, summed over
    neighbours (the counter side channel, SURVEY P3).  ``diag(Xi) -> Pt``
    supplies the i == j reaction term (models put reaction/self dynamics
    there, ref examples/turing.cu:38-46).

    The result follows the standard ``pw_int(Xi, r, dist, i, j)``
    contract on every engine.
    """
    return _CentralForce(Pt, coef, fields, bilinear, aux, diag, name)


def mask_tree(tree, mask):
    return jax.tree.map(lambda a: jnp.where(mask, a, jnp.zeros_like(a)), tree)


def grid_dims(grid_size):
    """``(gx, gy, gz)`` from an int (cubic grid) or a 3-tuple."""
    if isinstance(grid_size, (tuple, list)):
        gx, gy, gz = (int(g) for g in grid_size)
        return gx, gy, gz
    g = int(grid_size)
    return g, g, g


def grid_for(pos_max, cube_size):
    """Smallest even number of cubes per axis (at least 16) covering
    ``|coord| <= pos_max`` plus a 0.75 margin; cubes are centred on the
    origin (``cube_coord``)."""
    need = math.ceil(2.0 * (pos_max + 0.75) / cube_size)
    return max(-(-need // 2) * 2, 16)


def cube_coord(v, cube_size, grid_size):
    """Grid coordinate of one axis, clipped into the grid (the reference
    D_ASSERTs in-bounds instead, solvers.cuh:361-364; out-of-grid states
    are detected separately via :func:`out_of_grid_mask`)."""
    c = jnp.floor(v / cube_size).astype(jnp.int32) + grid_size // 2
    return jnp.clip(c, 0, grid_size - 1)


def cube_ids(X, n, cube_size, grid_size, x_split=1):
    """Cube id per point, x-minor (ref solvers.cuh:349-365); inactive
    points get the sentinel ``gx * gy * gz`` (sorts past every cube).

    ``x_split > 1`` bins x at ``cube_size / x_split`` (thin x-cubes: the
    lattice kernels then sweep ``+-x_split`` x-neighbours to keep the
    full ``cube_size`` interaction reach, trading a *lower per-cube
    capacity* -- the kernel-cost lever -- for more, cheaper x shifts;
    ``gx`` counts the thin cubes)."""
    gx, gy, gz = grid_dims(grid_size)
    active = jnp.arange(X.x.shape[0], dtype=jnp.int32) < n
    cid = (cube_coord(X.x, cube_size / x_split, gx)
           + (cube_coord(X.y, cube_size, gy)
              + cube_coord(X.z, cube_size, gz) * gy) * gx)
    return jnp.where(active, cid, gx * gy * gz)


def out_of_grid_mask(X, n, cube_size, grid_size, x_split=1):
    """Per-point True where an active point's UNCLIPPED cube coordinate
    falls outside the grid (clipping would mis-bin it)."""
    gx, gy, gz = grid_dims(grid_size)
    active = jnp.arange(X.x.shape[0], dtype=jnp.int32) < n

    def bad(v, g, cs):
        c = jnp.floor(v / cs).astype(jnp.int32) + g // 2
        return (c < 0) | (c >= g)

    return active & (bad(X.x, gx, cube_size / x_split)
                     | bad(X.y, gy, cube_size)
                     | bad(X.z, gz, cube_size))


def split_force_output(out):
    """(dF, aux) from a force's return value.  A Pt is itself a tuple; the
    (dF, aux) form is a plain 2-tuple whose second element is a dict of
    named per-pair accumulators."""
    if (isinstance(out, tuple) and not hasattr(out, "_fields")
            and len(out) == 2 and isinstance(out[1], dict)):
        return out
    return out, {}


def apply_derived_aux(pw_int, aux, sum_f):
    """Aux channels recovered from other per-cell sums AFTER the pair pass.

    A force may declare ``pw_int.derive_aux = {name: fn(aux, sum_f)}`` to
    drop an accumulator from the hot loop when its value is recoverable --
    e.g. the branching model's mesenchymal neighbour count is
    ``sum_friction - epi_nbs`` whenever the friction gate coincides with
    the force's ``near`` gate (``friction_w_neighbour`` at r_max = 1, ref
    solvers.cuh:27-35).  Called once per pairwise pass by every engine
    path, after the sums exist."""
    der = getattr(pw_int, "derive_aux", None)
    if not der:
        return aux
    out = dict(aux)
    for k, fn in der.items():
        out[k] = fn(aux, sum_f)
    return out


def apply_post_pair(pw_int, F, aux, X):
    """Per-cell transform applied AFTER the pair reduction.

    A force may declare ``pw_int.post_pair = fn(F, aux, X) -> (F, aux)``
    to move per-pair arithmetic that is LINEAR in some per-pair vector
    out of the hot loop: the pairs accumulate the raw vector sum as aux
    channels and the per-cell (nonlinear, e.g. trig) conversion runs once
    per point here -- see ``polarity.bending_post_pair``.  ``X`` is the
    per-point state in the engine's own layout (augmented type; garbage
    rows in empty lattice slots are fine, downstream occupancy masking
    discards them).  Called by every engine path right after
    ``apply_derived_aux``."""
    pp = getattr(pw_int, "post_pair", None)
    if pp is None:
        return F, aux
    return pp(F, aux, X)


def evaluate_pairs(pw_int, pw_friction, Xi, Xj, old_v_j, i, j, pair_mask,
                   sum_axes, cutoff=None):
    """Evaluate forces + friction over one block of candidate pairs.

    Xi fields broadcast against Xj fields (e.g. ``[B, 1]`` vs ``[B, K]``).
    Returns per-i sums: (dF (Pt), sum_friction, sum_v (Pt-like xyz), aux dict),
    reduced over ``sum_axes``.  If ``cutoff`` is given, pairs with
    ``dist >= cutoff`` are additionally masked out (the grid engine's
    cube-size cutoff, ref solvers.cuh:450).

    Mirrors the accumulation loops of ``compute_tile``
    (ref solvers.cuh:299-315) and ``compute_cube`` (ref solvers.cuh:443-459):
    ``F += pw_int(...)``, ``sum_friction += f``, ``sum_v += f * old_v[j]``.
    """
    r = Xi - Xj
    dist = jnp.sqrt(r.x * r.x + r.y * r.y + r.z * r.z)
    if cutoff is not None:
        pair_mask = pair_mask & (dist < cutoff)

    dF, aux = split_force_output(pw_int(Xi, r, dist, i, j))

    def msum(a):
        a = jnp.broadcast_to(a, pair_mask.shape)
        return jnp.sum(jnp.where(pair_mask, a, 0.0), axis=sum_axes)

    F = jax.tree.map(msum, dF)
    friction = jnp.where(
        pair_mask,
        jnp.broadcast_to(pw_friction(Xi, r, dist, i, j), pair_mask.shape),
        0.0,
    )
    sum_friction = jnp.sum(friction, axis=sum_axes)
    sum_vx = jnp.sum(friction * old_v_j[0], axis=sum_axes)
    sum_vy = jnp.sum(friction * old_v_j[1], axis=sum_axes)
    sum_vz = jnp.sum(friction * old_v_j[2], axis=sum_axes)
    aux_sums = {k: msum(v) for k, v in aux.items()}
    return F, sum_friction, (sum_vx, sum_vy, sum_vz), aux_sums
