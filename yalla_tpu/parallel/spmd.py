"""Multi-chip scaling: cells-axis decomposition over a device mesh.

The reference is strictly single-GPU (no NCCL/MPI anywhere; SURVEY.md §2.3).
The natural scale axis of this workload is the *cell count*, so the
multi-device design shards every per-cell array over a 1-D
``jax.sharding.Mesh`` axis (``cells``) and runs the Heun step under
``shard_map``:

* each device owns ``n_pad / D`` cells and computes their derivatives
  against the full population, obtained with one ``all_gather`` per Heun
  pass (one NVLink collective; at 500k cells the gathered state is ~10-20 MB);
* the momentum fix (COM drift subtraction, ref solvers.cuh:240-253) becomes
  a ``psum`` of per-shard partial sums;
* the engine's ``(i_offset, i_size)`` window restricts the pairwise work to
  the local shard, so compute scales 1/D while neighbour search data stays
  replicated (the grid sort is tiny next to the force pass).

This mirrors the "data parallel with replicated gather" recipe: pick a
mesh, annotate shardings, let XLA insert the collectives.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..dtypes import Float3
from ..ops.common import friction_w_neighbour

__all__ = ["make_cells_mesh", "make_sharded_step", "shard_state"]


def make_cells_mesh(devices=None, axis="cells"):
    import numpy as np
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices).reshape(-1), (axis,))


def shard_state(mesh, X, old_v, axis="cells"):
    """Place per-cell arrays with the cells axis sharded over the mesh."""
    sh = NamedSharding(mesh, P(axis))
    return (jax.tree.map(lambda a: jax.device_put(a, sh), X),
            jax.tree.map(lambda a: jax.device_put(a, sh), old_v))


def make_sharded_step(mesh, engine, pw_int, *,
                      pw_friction=friction_w_neighbour, gen=None,
                      fix_mode="com", axis="cells", n_steps=1,
                      precompute=None):
    """Build a jitted multi-chip Heun step (or ``n_steps``-step scan).

    Returns ``step(X, old_v, n, dt, cube_size, fix_point, gen_args)`` where
    the per-cell arrays are sharded over ``axis``; semantics match the
    single-chip ``heun_step`` exactly (same physics, same fix rules).
    """
    n_dev = mesh.shape[axis]

    def body(X_sh, old_v_sh, n, dt, cube_size, fix_point, gen_args):
        size = X_sh.x.shape[0]
        offset = jax.lax.axis_index(axis) * size
        i_idx = offset + jnp.arange(size, dtype=jnp.int32)
        active = i_idx < n
        gather = lambda t: jax.tree.map(
            lambda a: jax.lax.all_gather(a, axis, tiled=True), t)

        def deriv(X_full, old_v_full):
            from ..solvers import augment, truncate_aug
            Xa_full = augment(X_full, n, precompute)
            F, sum_f, sum_v, aux = engine.pairwise(
                pw_int, pw_friction, Xa_full,
                old_v_full, n, cube_size, i_offset=offset, i_size=size)
            from ..ops.common import apply_derived_aux, apply_post_pair
            aux = apply_derived_aux(pw_int, aux, sum_f)
            # per-cell post transform on the local i-rows of the
            # (gathered, full) augmented state
            F, aux = apply_post_pair(
                pw_int, F, aux, jax.tree.map(
                    lambda a: jax.lax.dynamic_slice_in_dim(a, offset, size),
                    Xa_full))
            # in-loop failure flags: reduce engine __err_* channels to
            # scalars and psum-max over the ring (the ERR_PREFIX contract,
            # ops/common.py; the single-chip path raises on these)
            errs = {k: jax.lax.pmax(jnp.max(v), axis)
                    for k, v in aux.items() if k.startswith("__err_")}
            F = truncate_aug(F, type(X_full))
            if gen is not None:
                dXg = gen.fn(X_full, n, gen_args)
                F = F + jax.tree.map(
                    lambda a: jax.lax.dynamic_slice_in_dim(a, offset, size),
                    dXg)
            inv = jnp.where(sum_f > 0,
                            1.0 / jnp.where(sum_f > 0, sum_f, 1.0), 0.0)
            dX = F.replace(x=F.x + sum_v[0] * inv,
                           y=F.y + sum_v[1] * inv,
                           z=F.z + sum_v[2] * inv)
            dX = jax.tree.map(lambda a: jnp.where(active, a, 0.0), dX)

            def com(a):
                return jax.lax.psum(jnp.sum(jnp.where(active, a, 0.0)),
                                    axis) / n

            def at_point(a):
                local = fix_point - offset
                mine = (local >= 0) & (local < size)
                v = a[jnp.clip(local, 0, size - 1)]
                return jax.lax.psum(jnp.where(mine, v, 0.0), axis)

            if fix_mode == "com":
                fx, fy, fz = com(dX.x), com(dX.y), com(dX.z)
            elif fix_mode == "point":
                fx, fy, fz = at_point(dX.x), at_point(dX.y), at_point(dX.z)
            elif fix_mode == "com_z":
                fx, fy, fz = at_point(dX.x), at_point(dX.y), com(dX.z)
            else:
                raise ValueError(fix_mode)
            return dX.replace(x=jnp.where(active, dX.x - fx, 0.0),
                              y=jnp.where(active, dX.y - fy, 0.0),
                              z=jnp.where(active, dX.z - fz, 0.0)), errs

        def one_step(carry, _):
            X_sh, old_v_sh = carry
            old_v_full = gather(old_v_sh)  # re-gathered every step
            d1, e1 = deriv(gather(X_sh), old_v_full)
            X1_sh = jax.tree.map(lambda a, b: a + b * dt, X_sh, d1)
            d2, e2 = deriv(gather(X1_sh), old_v_full)
            X_new = jax.tree.map(lambda a, b, c: a + (b + c) * (0.5 * dt),
                                 X_sh, d1, d2)
            ov = Float3(x=(d1.x + d2.x) * 0.5, y=(d1.y + d2.y) * 0.5,
                        z=(d1.z + d2.z) * 0.5)
            errs = {k: jnp.maximum(e1[k], e2[k]) for k in e1}
            nonfin = jnp.zeros((), jnp.float32)
            for leaf in jax.tree.leaves(X_new):
                nonfin = jnp.maximum(
                    nonfin, jnp.any(~jnp.isfinite(leaf)).astype(jnp.float32))
            errs["__err_non_finite"] = jnp.maximum(
                errs.get("__err_non_finite", 0.0),
                jax.lax.pmax(nonfin, axis))
            return (X_new, ov), errs

        (X_out, ov_out), errs = jax.lax.scan(
            one_step, (X_sh, old_v_sh), None, length=n_steps)
        return X_out, ov_out, jax.tree.map(lambda a: a.max(0), errs)

    spec_cells = P(axis)
    spec_rep = P()

    def specs_like(tree, spec):
        return jax.tree.map(lambda _: spec, tree,
                            is_leaf=lambda x: x is None) if tree is not None \
            else None

    _cache = {}

    def step(X, old_v, n, dt, cube_size, fix_point, gen_args=None):
        """Returns (X, old_v, errs): errs holds the scalar in-loop
        ``__err_*`` flags (max over steps, passes, and devices) -- check
        them like ``Solution._check_errors`` does.

        The jitted shard_map is cached per pytree structure, so repeated
        calls hit the jit cache instead of retracing."""
        key = (jax.tree.structure((X, old_v)),
               jax.tree.structure(gen_args) if gen_args is not None
               else None)
        if key not in _cache:
            in_specs = (jax.tree.map(lambda _: spec_cells, X),
                        jax.tree.map(lambda _: spec_cells, old_v),
                        spec_rep, spec_rep, spec_rep, spec_rep,
                        specs_like(gen_args, spec_rep))
            out_specs = (jax.tree.map(lambda _: spec_cells, X),
                         jax.tree.map(lambda _: spec_cells, old_v),
                         spec_rep)
            _cache[key] = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=in_specs,
                out_specs=out_specs, check_vma=False))
        return _cache[key](X, old_v, n, dt, cube_size, fix_point, gen_args)

    return step
