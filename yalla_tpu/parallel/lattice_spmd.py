"""Multi-chip lattice integration: z-slab domain decomposition.

The dense cube-lattice pass (``ops/lattice_xla.py``) is a 27-point shifted
-slice stencil over ``[gs_z, gs_y, gs_x * C]`` channels -- its natural
multi-chip decomposition is one z-slab per device with a one-plane halo
exchange, the pattern NVLink-joined cards serve well (SURVEY.md §2.3; the
reference is strictly single-GPU, solvers.cuh has no multi-device path).

Design:

* every per-slot channel is sharded over the *flat slot axis* -- slot ids
  are z-major (``slot = ((cz * gs) + cy) * gs * C + ...``, ref cube id
  convention solvers.cuh:349-365), so an even 1-D sharding IS the z-slab
  decomposition, and ``lattice_build``'s sort/scatter runs under GSPMD
  with the same arrays;
* the force pass runs under ``shard_map``: each device exchanges one
  ``[1, gs, W]`` halo plane per channel with each z-neighbour via
  ``ppermute`` (non-periodic: edge devices receive ppermute's zero fill,
  which carries ``occ = False``), then runs the identical
  ``pairwise_on_padded`` core on its local ``[gz + 2, gs + 2, W]`` view;
* integration is local; the momentum fix reduces with ``psum``
  (ref solvers.cuh:240-253); the in-loop failure flags (capacity drops,
  non-finite state) reduce with ``psum``/``pmax`` like everything else.

Memory per chip is O(n_slots / D) for the lattice plus the stable-id
arrays, so capacity scales with the ring size -- unlike the replicated
all-gather path in ``parallel/spmd.py`` (kept for the gather engines).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..dtypes import Float3
from ..ops.common import friction_w_neighbour, mask_tree
from ..ops.lattice_xla import lattice_build, lattice_unbuild, \
    pairwise_on_padded


__all__ = ["make_z_mesh", "lattice_sharded_heun_steps",
           "ShardedLatticeEngine"]


def make_z_mesh(devices=None, axis="z"):
    import numpy as np
    devices = devices if devices is not None else jax.devices()
    from jax.sharding import Mesh
    return Mesh(np.array(devices).reshape(-1), (axis,))


def _halo_fns(axis, D, gz, gs, W):
    """(with_halo) for a local [gz, gs, W] slab: one-plane ppermute
    exchange on z (zeros at the ring edges) plus the y zero padding the
    pairwise core expects."""
    fwd = [(i, i + 1) for i in range(D - 1)]
    bwd = [(i + 1, i) for i in range(D - 1)]

    def with_halo(a_flat, fill=0.0):
        a3 = a_flat.reshape(gz, gs, W).astype(jnp.float32) \
            if a_flat.dtype == jnp.bool_ else a_flat.reshape(gz, gs, W)
        if D == 1:
            lo = hi = jnp.zeros_like(a3[:1])
        else:
            lo = jax.lax.ppermute(a3[-1:], axis, fwd)
            hi = jax.lax.ppermute(a3[:1], axis, bwd)
        a3 = jnp.concatenate([lo, a3, hi], axis=0)
        return jnp.pad(a3, ((0, 0), (1, 1), (0, 0)), constant_values=fill)

    return with_halo


from dataclasses import dataclass


@dataclass(frozen=True)
class ShardedLatticeEngine:
    """Neighbour engine running the dense-lattice pass z-slab-sharded over
    a device ring -- a drop-in ``engine`` for ``heun_step``/``Solution``,
    so generic forces (links, walls) and every integrator feature compose
    with multi-chip execution unchanged.  The lattice build runs under
    GSPMD (slot arrays constrained to the z sharding); the force pass runs
    under ``shard_map`` with one-plane ``ppermute`` halos; results return
    in stable-id order (sharding chosen by GSPMD).

    Unlike ``lattice_sharded_heun_steps`` (fully lattice-resident chunks)
    this rebuilds per pairwise pass -- the reference's own cadence
    (solvers.cuh:494) -- trading throughput for full composability."""
    mesh: object
    grid_size: int = 64
    capacity: int = 8
    z_block: int = 2
    axis: str = "z"

    def pairwise(self, pw_int, pw_friction, X, old_v, n, cube_size,
                 i_offset=0, i_size=None):
        assert i_offset == 0 and i_size is None
        from ..solvers import augment  # noqa: F401 (documented contract)
        gs, C = self.grid_size, self.capacity
        mesh, axis = self.mesh, self.axis
        D = mesh.shape[axis]
        assert gs % D == 0
        gz = gs // D
        assert gz % self.z_block == 0
        W = gs * C
        n_pad = X.x.shape[0]
        slot_sh = NamedSharding(mesh, P(axis))
        with_halo = _halo_fns(axis, D, gz, gs, W)

        lay = lattice_build(X, old_v, n, cube_size, gs, C)
        constrain = lambda a: jax.lax.with_sharding_constraint(a, slot_sh)
        T_leaves = [constrain(a) for a in jax.tree.leaves(lay.T)]
        ov_leaves = [constrain(a) for a in lay.Tov]
        pid = constrain(lay.pid)
        T_tree = jax.tree.structure(lay.T)
        zb = self.z_block

        def local(T_leaves, ov_leaves, pid, cube_size):
            occ = pid < n_pad
            Pp = jax.tree.unflatten(T_tree, [with_halo(a)
                                             for a in T_leaves])
            Pov = Float3(*[with_halo(a) for a in ov_leaves])
            Pocc = with_halo(occ) > 0.5
            Ppid = with_halo(pid.astype(jnp.float32),
                             float(n_pad)).astype(jnp.int32)
            F, sum_f, sum_v, aux = pairwise_on_padded(
                pw_int, pw_friction, Pp, Pov, Pocc, Ppid, cube_size,
                grid_size=gs, capacity=C, z_block=zb)
            return (F, sum_f, list(sum_v), aux)

        spec_slot, spec_rep = P(axis), P()
        nT = len(T_leaves)
        inner = jax.shard_map(
            local, mesh=mesh,
            in_specs=([spec_slot] * nT, [spec_slot] * 3, spec_slot,
                      spec_rep),
            out_specs=(spec_slot, spec_slot, [spec_slot] * 3, spec_slot),
            check_vma=False)
        F, sum_f, sum_v, aux = inner(T_leaves, ov_leaves, pid, cube_size)

        # slot space -> stable ids (GSPMD decides the gather layout)
        from ..ops.lattice_xla import slot_to_stable
        back = lambda t: slot_to_stable(lay, t)
        aux = back(aux)
        aux["__err_lattice_dropped"] = lay.n_dropped.astype(jnp.float32)
        aux["__err_out_of_grid"] = lay.n_oob.astype(jnp.float32)
        return (back(F), back(sum_f), tuple(back(list(sum_v))), aux)


def lattice_sharded_heun_steps(mesh, n_steps, rebuild_every,
                               pw_int, pw_friction, fix_mode,
                               grid_size, capacity, z_block,
                               X, old_v, n, dt, cube_size, fix_point,
                               precompute=None, axis="z",
                               gen=None, gen_args=None):
    """``n_steps`` Heun steps, lattice z-slabs sharded over ``mesh[axis]``.

    Same semantics as the single-chip ``lattice_heun_steps`` (COM/point
    fixes, friction mixing, in-loop failure flags); pure -- call it inside
    your own ``jax.jit``.  ``X``/``old_v`` are stable-id pytrees (any
    sharding; outputs match inputs' structure).

    ``gen`` (a static ``GenericForce`` with ``args=None``) + ``gen_args``
    run the generic-forces hook (links, walls; ref solvers.cuh:43-53)
    INSIDE the resident loop: per pass, the slot channels the hook reads
    are ``all_gather``-ed to stable-id order over the ring (short
    NVLink hop; XLA dead-code-eliminates channels the hook never touches), the
    hook runs replicated, and each device scatter-adds the rows whose
    slot lives in its slab.  Protrusion/wall models therefore scale past
    one device without leaving the resident loop.

    Known deviation: ``rebuild_every == 1`` still bins once per *step*
    (both Heun passes share the predictor-state binning), where the
    single-chip ``chunk_exact`` rebuilds per pass; use
    ``ShardedLatticeEngine`` with the generic ``heun_step`` when per-pass
    rebuild exactness matters more than resident throughput.
    """
    from ..solvers import augment, truncate_aug
    assert n_steps % rebuild_every == 0
    gs, C = grid_size, capacity
    D = mesh.shape[axis]
    assert gs % D == 0, "grid_size must divide over the mesh"
    gz = gs // D
    assert gz % z_block == 0, "z_block must divide the local slab"
    W = gs * C
    n_pad = X.x.shape[0]
    n_local = gz * gs * W
    n_slots_total = n_local * D
    slot_sh = NamedSharding(mesh, P(axis))

    with_halo = _halo_fns(axis, D, gz, gs, W)

    def local_chunk(T_leaves, ov_leaves, pid, slot_of, n, dt, cube_size,
                    fix_point, gen_args):
        """rebuild_every steps on the local slab (runs under shard_map)."""
        T_tree = jax.tree.structure(T_example)
        T0 = jax.tree.unflatten(T_tree, T_leaves)
        Tov0 = Float3(*ov_leaves)
        occ = pid < n_pad
        n_occ = jax.lax.psum(jnp.sum(occ), axis)
        offset = jax.lax.axis_index(axis) * n_local

        def gen_hook(T, F):
            """Generic forces in stable space: all_gather slot channels
            (DCE prunes unread ones), run the hook replicated, scatter-add
            this slab's rows back."""
            ok = slot_of < n_slots_total
            pick = jnp.where(ok, slot_of, 0)
            X_st = jax.tree.map(
                lambda a: jnp.where(
                    ok, jax.lax.all_gather(a, axis, tiled=True)[pick],
                    0.0), T)
            dXg = gen.fn(X_st, n, gen_args)
            fields = gen.fields if gen.fields is not None \
                else type(F)._fields
            mine = ok & (slot_of >= offset) & (slot_of < offset + n_local)
            local_idx = jnp.where(mine, slot_of - offset, n_local)
            upd = {}
            for f in fields:
                g = jnp.where(mine, getattr(dXg, f), 0.0)
                upd[f] = getattr(F, f).at[local_idx].add(
                    g, mode="drop", unique_indices=True)
            return F.replace(**upd)

        def deriv(T, Tov):
            Taug = augment(T, n, precompute)
            Pp = jax.tree.map(with_halo, Taug)
            Pov = Float3(with_halo(Tov.x), with_halo(Tov.y),
                         with_halo(Tov.z))
            Pocc = with_halo(occ) > 0.5
            Ppid = with_halo(pid.astype(jnp.float32),
                             float(n_pad)).astype(jnp.int32)
            F, sum_f, sum_v, aux = pairwise_on_padded(
                pw_int, pw_friction, Pp, Pov, Pocc, Ppid, cube_size,
                grid_size=gs, capacity=C, z_block=z_block)
            from ..ops.common import apply_derived_aux, apply_post_pair
            aux = apply_derived_aux(pw_int, aux, sum_f)
            F, aux = apply_post_pair(pw_int, F, aux, Taug)
            F = truncate_aug(F, type(T))
            if gen is not None:
                F = gen_hook(T, F)
            inv = jnp.where(sum_f > 0,
                            1.0 / jnp.where(sum_f > 0, sum_f, 1.0), 0.0)
            dX = F.replace(x=F.x + sum_v[0] * inv,
                           y=F.y + sum_v[1] * inv,
                           z=F.z + sum_v[2] * inv)
            dX = mask_tree(dX, occ)

            def com(a):
                return jax.lax.psum(jnp.sum(jnp.where(occ, a, 0.0)),
                                    axis) / jnp.maximum(n_occ, 1)

            def at_point(a):
                sel = pid == fix_point
                return jax.lax.psum(jnp.sum(jnp.where(sel, a, 0.0)), axis)

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

        def step(c, _):
            T, Tov = c
            d1, aux1 = deriv(T, Tov)
            T1 = jax.tree.map(lambda a, b: a + b * dt, T, d1)
            d2, aux = deriv(T1, Tov)
            # force-published __err_* flags must survive the predictor pass
            # too (same max-merge as heun_step / lattice_heun_steps)
            for k in aux:
                if k.startswith("__err_"):
                    aux[k] = jnp.maximum(aux[k], aux1[k])
            T_new = jax.tree.map(lambda a, b, c2: a + (b + c2) * (0.5 * dt),
                                 T, d1, d2)
            ov = Float3(x=(d1.x + d2.x) * 0.5, y=(d1.y + d2.y) * 0.5,
                        z=(d1.z + d2.z) * 0.5)
            return (T_new, ov), aux

        (T, Tov), auxs = jax.lax.scan(step, (T0, Tov0), None,
                                      length=rebuild_every)
        aux_last = {k: (a.max(0) if k.startswith("__err_") else a[-1])
                    for k, a in auxs.items()}
        bad = jnp.zeros((), bool)
        for leaf in jax.tree.leaves(T) + jax.tree.leaves(Tov):
            bad = bad | jnp.any(~jnp.isfinite(jnp.where(occ, leaf, 0.0)))
        bad = jax.lax.pmax(bad.astype(jnp.int32), axis)
        return (jax.tree.leaves(T), list(Tov), aux_last, bad)

    # specs: every per-slot channel over the z axis, scalars replicated
    T_example = X  # structure only
    spec_slot = P(axis)
    spec_rep = P()

    def chunk(carry, _):
        X, old_v, dropped, oob, bad = carry
        lay = lattice_build(X, old_v, n, cube_size, gs, C)
        constrain = lambda t: jax.tree.map(
            lambda a: jax.lax.with_sharding_constraint(a, slot_sh), t)
        lay = lay._replace(T=constrain(lay.T), Tov=constrain(lay.Tov),
                           pid=jax.lax.with_sharding_constraint(lay.pid,
                                                                slot_sh))
        dropped = jnp.maximum(dropped, lay.n_dropped)
        oob = jnp.maximum(oob, lay.n_oob)

        T_leaves = jax.tree.leaves(lay.T)
        ov_leaves = list(lay.Tov)

        gen_specs = jax.tree.map(lambda _: spec_rep, gen_args)
        inner = jax.shard_map(
            local_chunk, mesh=mesh,
            in_specs=([spec_slot] * len(T_leaves), [spec_slot] * 3,
                      spec_slot, spec_rep, spec_rep, spec_rep, spec_rep,
                      spec_rep, gen_specs),
            out_specs=([spec_slot] * len(T_leaves), [spec_slot] * 3,
                       spec_slot, spec_rep),
            check_vma=False)
        T_new, ov_new, aux_last, bad_c = inner(
            T_leaves, ov_leaves, lay.pid, lay.slot_of, n, dt, cube_size,
            fix_point, gen_args)
        lay = lay._replace(
            T=jax.tree.unflatten(jax.tree.structure(lay.T), T_new),
            Tov=Float3(*ov_new))
        X, old_v = lattice_unbuild(lay, X, old_v)

        # aux accumulators back to stable-id order
        from ..ops.lattice_xla import slot_to_stable
        aux_st = slot_to_stable(lay, aux_last)
        bad = bad | (bad_c > 0)
        for leaf in jax.tree.leaves(X):
            bad = bad | jnp.any(~jnp.isfinite(leaf))
        return (X, old_v, dropped, oob, bad), aux_st

    carry0 = (X, old_v, jnp.int32(0), jnp.int32(0), jnp.bool_(False))
    (X, old_v, dropped, oob, bad), auxs = jax.lax.scan(
        chunk, carry0, None, length=n_steps // rebuild_every)
    aux = {k: (a.max(0) if k.startswith("__err_") else a[-1])
           for k, a in auxs.items()}
    aux["__err_lattice_dropped"] = dropped
    aux["__err_out_of_grid"] = oob
    aux["__err_non_finite"] = bad
    return X, old_v, aux
