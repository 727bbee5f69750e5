"""Heun integrator + neighbour engines + the ``Solution`` facade.

Rebuild of the reference's ``include/solvers.cuh``:

* ``Heun_solver`` (ref solvers.cuh:164-276) becomes a *pure function*
  ``(X, old_v, n) -> (X', old_v', aux)`` traced once under ``jax.jit``;
  the whole predictor/corrector body fuses into a single XLA program.
* ``Tile_solver`` / ``Grid_solver`` / ``Gabriel_solver`` become engine
  objects selecting the pairwise implementation (see ``yalla_tpu.ops``).
* dynamic point counts: arrays have static padded capacity ``n_pad`` and a
  traced active count ``n`` -- growth never triggers recompilation.

The equation of motion is v = F + <v(t - dt)> for x, y, z, where <v> is the
friction-weighted mean neighbour velocity (ref solvers.cuh:109-161, after
http://dx.doi.org/10.1007/s10237-014-0613-5), and dw/dt = F_w for every
other field of Pt.

Deliberate deviation from the reference: with ``set_fixed_xy`` the
reference's *corrector* pass falls back to fixing the full xyz of the pinned
point (ref solvers.cuh:265-272 checks only ``fix_com``), while its predictor
mixes point-xy with COM-z.  We apply the same (predictor) rule in both
passes -- symmetric and closer to the documented intent.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .dtypes import Float3, make_pt
from .ops.common import (ERR_PREFIX, friction_on_background,
                         friction_w_neighbour, mask_tree)
from .ops.grid_xla import gabriel_pairwise, grid_pairwise, grid_overflow, \
    grid_out_of_bounds, build_grid
from .ops.pairwise_xla import tile_pairwise

__all__ = [
    "TileEngine", "GridEngine", "GabrielEngine",
    "LatticeEngine", "SweepEngine",
    "GenericForce", "Solution", "SimulationError", "heun_step", "heun_steps",
    "friction_w_neighbour", "friction_on_background",
]


class SimulationError(RuntimeError):
    """A D_ASSERT-class failure detected inside the hot loop: engine
    capacity overflow (silent pair/cell loss) or non-finite state
    (ref cudebug.cuh:8-35, solvers.cuh:82, 90, 153-154)."""


# --------------------------------------------------------------------------
# Neighbour engines (the reference's "Computer" template parameter)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class TileEngine:
    """All-pairs O(N^2) (ref Tile_computer, solvers.cuh:324-342)."""
    j_block: int | None = None

    def pairwise(self, pw_int, pw_friction, X, old_v, n, cube_size,
                 i_offset=0, i_size=None):
        del cube_size  # no cutoff in the all-pairs engine
        return tile_pairwise(pw_int, pw_friction, X, old_v, n,
                             j_block=self.j_block,
                             i_offset=i_offset, i_size=i_size)


@dataclass(frozen=True)
class GridEngine:
    """Spatial-hash O(N) with dist < cube_size cutoff
    (ref Grid_computer, solvers.cuh:465-502)."""
    grid_size: int = 50
    row_cap: int = 32
    i_block: int = 4096

    def pairwise(self, pw_int, pw_friction, X, old_v, n, cube_size,
                 i_offset=0, i_size=None):
        return grid_pairwise(pw_int, pw_friction, X, old_v, n, cube_size,
                             grid_size=self.grid_size, row_cap=self.row_cap,
                             i_block=self.i_block,
                             i_offset=i_offset, i_size=i_size)


@dataclass(frozen=True)
class SweepEngine:
    """Cube-sorted neighbour sweep as a GPU kernel (ops/sweep_triton.py):
    the reference's grid solver (solvers.cuh:345-502) with no per-cube or
    per-row capacity, the large-N path on the card.  ``grid_size`` only
    has to cover the tissue (``__err_out_of_grid`` flags cells outside
    it); it costs one int32 per cube.  ``interpret=True`` runs the
    kernel in the Pallas interpreter, for tests on the CPU."""
    grid_size: int | tuple = 64
    interpret: bool = False

    def pairwise(self, pw_int, pw_friction, X, old_v, n, cube_size,
                 i_offset=0, i_size=None):
        from .ops.sweep_triton import sweep_pairwise
        assert i_offset == 0 and i_size is None
        return sweep_pairwise(pw_int, pw_friction, X, old_v, n, cube_size,
                              grid_size=self.grid_size,
                              interpret=self.interpret)


@dataclass(frozen=True)
class LatticeEngine:
    """Dense cube-lattice engine (see ops/lattice_xla.py), plain XLA.
    ``Solution.take_step(s)`` routes to the lattice-resident integrator;
    ``rebuild_every`` controls the binning refresh cadence (1 =
    reference-exact per-pass rebuild).  ``capacity`` bounds the cells per
    cube: overflow raises ``__err_lattice_dropped``.  ``force_r_max``
    (the force's interaction radius) opts in to staleness certification
    when ``rebuild_every > 1``: a chunk whose measured displacement could
    hide a just-entering pair within the binning margin
    (``cube_size - force_r_max``) raises ``__err_stale``."""
    grid_size: int | tuple = 64   # int (cubic) or (gx, gy, gz)
    capacity: int = 8
    z_block: int = 4
    rebuild_every: int = 1
    force_r_max: float | None = None
    # x_split > 1 bins x at ``cube_size / x_split`` (thin x-cubes): the
    # per-cube capacity drops toward 1/x_split of the isotropic one while
    # the pair pass sweeps +-x_split x-neighbours -- total flat shifts go
    # 4C - 1 -> 2(x_split + 1)C' - 1.  Requires rebuild_every == 1
    # (per-pass rebuild/rebin: the staleness certificate is isotropic).
    # ``grid_size`` x then counts THIN cubes.
    x_split: int = 1

    def __post_init__(self):
        # z_block must divide the grid's z extent (slab scan); shrink
        # quietly so e.g. Solution(solver="lattice", grid_size=50) works
        from .ops.common import grid_dims
        gz = grid_dims(self.grid_size)[2]
        zb = min(self.z_block, gz)
        while gz % zb:
            zb -= 1
        object.__setattr__(self, "z_block", max(zb, 1))

    def pairwise(self, pw_int, pw_friction, X, old_v, n, cube_size,
                 i_offset=0, i_size=None):
        from .ops.lattice_xla import (lattice_build,
                                      lattice_pairwise_resident,
                                      slot_to_stable)
        assert i_offset == 0 and i_size is None
        lay = lattice_build(X, old_v, n, cube_size, self.grid_size,
                            self.capacity, x_split=self.x_split)
        F, sum_f, sum_v, aux = lattice_pairwise_resident(
            pw_int, pw_friction, lay, n, cube_size,
            grid_size=self.grid_size, capacity=self.capacity,
            z_block=self.z_block, x_split=self.x_split)
        back = lambda t: slot_to_stable(lay, t)
        F, sum_f, sum_v, aux = (back(F), back(sum_f),
                                tuple(back(list(sum_v))), back(aux))
        # per-pass D_ASSERT flags (dropped cells silently lose all their
        # pairs; out-of-grid cells are mis-binned, ref solvers.cuh:361-364)
        aux["__err_lattice_dropped"] = lay.n_dropped.astype(jnp.float32)
        aux["__err_out_of_grid"] = lay.n_oob.astype(jnp.float32)
        return (F, sum_f, sum_v, aux)


@dataclass(frozen=True)
class GabrielEngine:
    """Grid + Gabriel-graph neighbourhood pruning
    (ref Gabriel_computer, solvers.cuh:604-644).  ``max_candidates``
    mirrors the reference's fixed 100-candidate arrays
    (solvers.cuh:525-527); overflow raises via the in-loop flags."""
    grid_size: int = 50
    row_cap: int = 32
    gabriel_coefficient: float = 0.8
    i_block: int = 256
    max_candidates: int = 100
    # windowed=True runs the sorted-order shared-window formulation
    # (ops/grid_xla.gabriel_windowed): contiguous dynamic-slice windows
    # instead of per-point row gathers.  window_cap bounds
    # a block's shared row span; points that don't fit the median-anchored
    # window are salvaged exactly by a gather pass of up to salvage_cap
    # points (overflow flagged in-loop).
    windowed: bool = True
    window_cap: int = 64
    salvage_cap: int = 256
    # consecutive sorted points sharing one set of 9 windows; smaller
    # subgroups allow a much tighter window_cap (see gabriel_windowed).
    # (64, 16) is the fastest flag-clean pair at the reference's 100k
    # growth_w_wall density (benchmarks/diag_gabriel.py sweep).
    subgroup: int | None = 16
    def pairwise(self, pw_int, pw_friction, X, old_v, n, cube_size,
                 i_offset=0, i_size=None):
        if self.windowed and i_offset == 0 and i_size is None:
            from .ops.grid_xla import gabriel_windowed
            return gabriel_windowed(
                pw_int, pw_friction, X, old_v, n, cube_size,
                grid_size=self.grid_size,
                gabriel_coefficient=self.gabriel_coefficient,
                i_block=self.i_block,
                window_cap=self.window_cap,
                max_candidates=self.max_candidates,
                row_cap=self.row_cap, salvage_cap=self.salvage_cap,
                subgroup=self.subgroup)
        return gabriel_pairwise(
            pw_int, pw_friction, X, old_v, n, cube_size,
            grid_size=self.grid_size, row_cap=self.row_cap,
            gabriel_coefficient=self.gabriel_coefficient,
            i_block=self.i_block, i_offset=i_offset, i_size=i_size,
            max_candidates=self.max_candidates)


# --------------------------------------------------------------------------
# Generic forces (the reference's Generic_forces hook, solvers.cuh:43-53)
# --------------------------------------------------------------------------

class GenericForce(NamedTuple):
    """A generic force with explicit state.

    ``fn(X, n, args) -> dX`` runs *before* the pairwise pass and its result
    is added to dX, exactly like the reference's host-lambda hook -- but as
    a pure function so it stays inside jit.  ``args`` is an arbitrary
    pytree of dynamic state (e.g. link tables) so updating it never
    recompiles.

    ``fields`` optionally names the Pt fields the force actually writes
    (e.g. ``("x", "y", "z")`` for link springs).  The lattice-resident
    integrator uses it to translate only those channels between stable-id
    and slot order; ``None`` means all fields.
    """
    fn: Callable[..., Any]
    args: Any = None
    fields: tuple | None = None


@lru_cache(maxsize=None)
def _wrap_plain_gen(fn):
    return GenericForce(lambda X, n, args: fn(X, n), None)


def _as_generic(gen_forces):
    if gen_forces is None:
        return None
    if isinstance(gen_forces, GenericForce):
        return gen_forces
    return _wrap_plain_gen(gen_forces)


# --------------------------------------------------------------------------
# Heun predictor-corrector (ref Heun_solver::take_step, solvers.cuh:226-275)
# --------------------------------------------------------------------------

def _fix_components(dX, n, active, fix_mode, fix_point):
    """Momentum fix: COM drift (default), pinned point, or xy-point/z-COM
    (ref solvers.cuh:196-208, 240-253).  Only x, y, z are ever fixed."""
    def com(a):
        return jnp.sum(jnp.where(active, a, 0.0)) / n
    if fix_mode == "com":
        return com(dX.x), com(dX.y), com(dX.z)
    if fix_mode == "point":
        return dX.x[fix_point], dX.y[fix_point], dX.z[fix_point]
    if fix_mode == "com_z":
        return dX.x[fix_point], dX.y[fix_point], com(dX.z)
    raise ValueError(fix_mode)


def augment(X, n, precompute):
    """Append derived per-point fields (e.g. polarity vectors) for the
    duration of one pairwise pass; they flow through Xi / Xj / r."""
    if precompute is None:
        return X
    aug = precompute(X, n)
    AugT = make_pt(type(X).__name__ + "Aug",
                   *(list(type(X)._fields[3:]) + list(aug.keys())))
    return AugT(*X, *aug.values())


def truncate_aug(F, orig_type):
    if type(F).__name__ == orig_type.__name__:
        return F
    return orig_type(*tuple(F)[:len(orig_type._fields)])


def _deriv(engine, pw_int, pw_friction, gen, fix_mode, precompute,
           X, old_v, n, cube_size, fix_point, gen_args):
    active = jnp.arange(X.x.shape[0], dtype=jnp.int32) < n
    Xa = augment(X, n, precompute)
    F, sum_f, sum_v, aux = engine.pairwise(
        pw_int, pw_friction, Xa, old_v, n, cube_size)
    from .ops.common import apply_derived_aux, apply_post_pair
    aux = apply_derived_aux(pw_int, aux, sum_f)
    F, aux = apply_post_pair(pw_int, F, aux, Xa)
    # engine failure flags reduce to scalars (cheap to carry through scans)
    aux = {k: (jnp.max(v) if k.startswith(ERR_PREFIX) else v)
           for k, v in aux.items()}
    F = truncate_aug(F, type(X))
    if gen is not None:
        F = F + gen.fn(X, n, gen_args)
    # add_rhs: mean neighbour velocity weighted by friction (solvers.cuh:146-161)
    inv = jnp.where(sum_f > 0, 1.0 / jnp.where(sum_f > 0, sum_f, 1.0), 0.0)
    dX = F.replace(x=F.x + sum_v[0] * inv,
                   y=F.y + sum_v[1] * inv,
                   z=F.z + sum_v[2] * inv)
    dX = mask_tree(dX, active)
    fx, fy, fz = _fix_components(dX, n, active, fix_mode, fix_point)
    dX = dX.replace(x=jnp.where(active, dX.x - fx, 0.0),
                    y=jnp.where(active, dX.y - fy, 0.0),
                    z=jnp.where(active, dX.z - fz, 0.0))
    # NaN guard in the hot path (ref add_rhs D_ASSERTs, solvers.cuh:153-154)
    bad = jnp.zeros((), dtype=bool)
    for leaf in jax.tree.leaves(dX):
        bad = bad | jnp.any(~jnp.isfinite(leaf))
    aux["__err_non_finite"] = bad.astype(jnp.float32)
    return dX, aux


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 12))
def heun_step(engine, pw_int, pw_friction, gen, fix_mode,
              X, old_v, n, dt, cube_size, fix_point, gen_args,
              precompute=None):
    """One 2nd-order step.  Pure; jitted once per (engine, forces) combo."""
    d = partial(_deriv, engine, pw_int, pw_friction, gen, fix_mode,
                precompute)
    dX, aux1 = d(X, old_v, n, cube_size, fix_point, gen_args)
    X1 = jax.tree.map(lambda a, b: a + b * dt, X, dX)
    dX1, aux = d(X1, old_v, n, cube_size, fix_point, gen_args)
    # failure flags must survive from BOTH passes: a capacity overflow in
    # the predictor already mis-integrated the state even if the corrector
    # pass happens to fit (ref asserts fire in every kernel launch)
    for k in aux:
        if k.startswith(ERR_PREFIX):
            aux[k] = jnp.maximum(aux[k], aux1[k])
    X_new = jax.tree.map(lambda a, b, c: a + (b + c) * (0.5 * dt), X, dX, dX1)
    old_v_new = Float3(x=(dX.x + dX1.x) * 0.5,
                       y=(dX.y + dX1.y) * 0.5,
                       z=(dX.z + dX1.z) * 0.5)
    return X_new, old_v_new, aux


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5, 13))
def heun_steps(n_steps, engine, pw_int, pw_friction, gen, fix_mode,
               X, old_v, n, dt, cube_size, fix_point, gen_args,
               precompute=None):
    """``n_steps`` fused steps via lax.scan (device-resident hot loop)."""
    def body(carry, _):
        X, old_v = carry
        X, old_v, aux = heun_step(engine, pw_int, pw_friction, gen, fix_mode,
                                  X, old_v, n, dt, cube_size, fix_point,
                                  gen_args, precompute)
        return (X, old_v), aux
    (X, old_v), auxs = jax.lax.scan(body, (X, old_v), None, length=n_steps)
    # failure flags accumulate (max) across the fused steps: a transient
    # overflow mid-run already mis-integrated the state and must surface
    aux = {k: (a.max(0) if k.startswith(ERR_PREFIX) else a[-1])
           for k, a in auxs.items()} if auxs else {}
    return X, old_v, aux


# --------------------------------------------------------------------------
# Solution facade (ref Solution<Pt, Solver>, solvers.cuh:60-106)
# --------------------------------------------------------------------------

def _pad_size(n_max):
    # padded sizes snap to few values -- multiples of 128 up to 4096, then
    # of 4096 (the capacity tiers of growing models, models/branching.py)
    # -- so compiled programs are reused across nearby sizes
    if n_max <= 4096:
        return max(128, -(-n_max // 128) * 128)
    return -(-n_max // 4096) * 4096


_ENGINES = {"tile": TileEngine, "grid": GridEngine, "gabriel": GabrielEngine}


class Solution:
    """Host facade owning padded device state + a host mirror.

    Mirrors the reference's ``Solution`` UX: ``h_X`` (numpy, mutable in
    place), ``copy_to_device`` / ``copy_to_host``, ``take_step``.  Device
    state is a struct-of-arrays pytree; every field is ``f32[n_pad]``.
    """

    def __init__(self, pt_type, n_max, *, solver="tile", grid_size=50,
                 cube_size=1.0, row_cap=32, gabriel_coefficient=0.8,
                 engine=None, n_pad=None):
        self.pt_type = pt_type
        self.n_max = int(n_max)
        self.n_pad = int(n_pad) if n_pad else _pad_size(self.n_max)
        assert self.n_pad >= self.n_max
        # set when solver="grid" resolves to an auto lattice: the lattice
        # must then cover the REQUESTED grid extent, not just the initial
        # state's bounding box (a user who sized the grid for later growth
        # would otherwise hit __err_out_of_grid mid-run)
        self._requested_grid_size = None
        if engine is None:
            if solver == "auto":
                # resolved lazily from the initial state (tile below the
                # all-pairs crossover, a binned engine above; cf. the
                # reference's ~7k-point grid crossover, solvers.cuh:346-347)
                engine = None
            elif solver == "tile":
                engine = TileEngine()
            elif solver == "grid":
                # the reference's workhorse name; above 20k points resolve
                # to the large-N engine of the backend (identical cutoff
                # semantics, cross-engine tests pin the physics)
                if self.n_max <= 20_000:
                    engine = GridEngine(grid_size=grid_size, row_cap=row_cap)
                else:
                    engine = None
                    self._requested_grid_size = int(grid_size)
            elif solver == "lattice":
                engine = LatticeEngine(grid_size=grid_size)
            elif solver == "gabriel":
                engine = GabrielEngine(
                    grid_size=grid_size, row_cap=row_cap,
                    gabriel_coefficient=gabriel_coefficient)
            else:
                raise ValueError(f"unknown solver {solver!r}")
        self.engine = engine
        self.cube_size = float(cube_size)  # mutable, traced dynamically

        self.h_X = pt_type(*[np.zeros(self.n_pad, np.float32)
                             for _ in pt_type._fields])
        self.h_n = self.n_max
        self.d_X = None
        self.d_old_v = Float3.zeros(self.n_pad)
        self.d_n = jnp.int32(self.n_max)
        self.aux: dict = {}

        self._fix_mode = "com"
        self._fix_point = 0

    # -- host <-> device ----------------------------------------------------
    def copy_to_device(self):
        assert self.h_n <= self.n_max
        self.d_X = self.pt_type(*[jnp.asarray(f, jnp.float32)
                                  for f in self.h_X])
        self.d_n = jnp.int32(self.h_n)

    def copy_to_host(self):
        assert self.d_X is not None
        # np.array (not asarray): the host mirror must be writable
        self.h_X = self.pt_type(*[np.array(f) for f in self.d_X])
        self.h_n = int(self.d_n)
        assert self.h_n <= self.n_max
        return self.h_X

    def get_d_n(self):
        return int(self.d_n)

    @property
    def n_active(self):
        return self.d_n

    # -- momentum fixing (ref solvers.cuh:196-208) ---------------------------
    def set_fixed(self, point_id=None):
        if point_id is None:
            self._fix_mode = "com"
        else:
            self._fix_mode = "point"
            self._fix_point = int(point_id)

    def set_fixed_xy(self, point_id):
        self._fix_mode = "com_z"
        self._fix_point = int(point_id)

    # -- integration ----------------------------------------------------------
    def _ensure_device(self):
        if self.d_X is None:
            self.copy_to_device()
        if self.engine is None:
            self.engine = self._auto_engine()

    def _auto_engine(self):
        """Pick an engine from capacity and the current state extent:
        all-pairs below the crossover (cf. ref solvers.cuh:346-347, "maybe
        7k points"), a binned engine above, sized to the populated
        bounding box plus a growth margin.  The binned engine is the
        backend's (``yalla_tpu.backend``): the sweep kernel on the GPU,
        else the dense lattice with capacity from the measured cube
        occupancy.  Growth/drift past either raises via the in-loop
        flags."""
        from . import backend
        from .ops.common import grid_for
        from .ops.lattice_xla import pick_lattice_dims
        if self.n_max <= 2048:
            return TileEngine()
        n = int(self.d_n)
        h = [np.asarray(a[:max(n, 1)]) for a in
             (self.d_X.x, self.d_X.y, self.d_X.z)]
        extent = max(float(np.max(np.abs(a))) for a in h) if n else 1.0
        margin = max(2.0 * self.cube_size, 0.3 * extent)
        extent = extent + margin
        if self._requested_grid_size is not None:
            # solver="grid": honour the extent the caller sized the grid
            # for (grid_size cubes across), not just today's bounding box
            extent = max(extent,
                         self._requested_grid_size * self.cube_size / 2)
            warnings.warn(
                f"Solution(solver='grid', n_max={self.n_max}) uses the "
                f"large-N engine above 20k points (same cutoff physics; "
                f"sized to cover the requested "
                f"{self._requested_grid_size}-cube grid). Pass an explicit "
                f"engine= to override.", stacklevel=3)
        if backend.on_gpu():
            return SweepEngine(grid_size=grid_for(extent, self.cube_size))
        cid = 0
        for a in h:
            cid = cid * (2 ** 21) + np.floor(
                a / self.cube_size).astype(np.int64)
        max_occ = int(np.unique(cid, return_counts=True)[1].max()) \
            if n else 1
        gs, cap = pick_lattice_dims(extent, self.cube_size, max_occ + 1)
        return LatticeEngine(grid_size=gs, capacity=cap, z_block=2)

    def take_step(self, dt, pw_int, *, pw_friction=friction_w_neighbour,
                  gen_forces=None, precompute=None, check_errors=True):
        """One Heun step (ref Solution::take_step, solvers.cuh:94-105)."""
        self._ensure_device()
        gen = _as_generic(gen_forces)
        gen_args = gen.args if gen is not None else None
        gen_static = gen._replace(args=None) if gen is not None else None
        self.d_X, self.d_old_v, self.aux = heun_step(
            self.engine, pw_int, pw_friction, gen_static, self._fix_mode,
            self.d_X, self.d_old_v, self.d_n, jnp.float32(dt),
            jnp.float32(self.cube_size), jnp.int32(self._fix_point), gen_args,
            precompute)
        if check_errors:
            self._check_errors()
        return self.aux

    def _check_errors(self):
        """Check the in-loop failure flags published by the last launch and
        raise ``SimulationError`` -- the rebuild of the reference's
        in-kernel D_ASSERTs (capacity, solvers.cuh:82,90; NaN,
        solvers.cuh:153-154).  One host readback per launch, exactly like
        the reference's per-launch CHECK_CUDA."""
        problems = []
        for k, v in self.aux.items():
            if not k.startswith("__err_"):
                continue
            val = np.asarray(v)
            if val.any():
                detail = f" ({val.sum():.0f})" if val.size == 1 and \
                    val.dtype.kind in "iu" else ""
                problems.append(k[len("__err_"):] + detail)
        if problems:
            raise SimulationError(
                "in-loop failure detected: " + ", ".join(problems)
                + " -- raise engine capacity (grid row_cap / lattice "
                "capacity / grid_size) or check the forces for NaN")

    def take_steps(self, n_steps, dt, pw_int, *,
                   pw_friction=friction_w_neighbour, gen_forces=None,
                   precompute=None, check_errors=True):
        """``n_steps`` device-fused steps (lax.scan hot loop).

        With a LatticeEngine this routes to the lattice-resident
        integrator (binning kept on-lattice between rebuilds -- the
        high-throughput path); generic forces (links, walls) run inside
        the resident loop through the slot map."""
        self._ensure_device()
        if isinstance(self.engine, LatticeEngine):
            from .ops.lattice_xla import lattice_heun_steps
            e = self.engine
            gen = _as_generic(gen_forces)
            gen_args = gen.args if gen is not None else None
            gen_static = gen._replace(args=None) if gen is not None else None
            if int(n_steps) % e.rebuild_every == 0:
                k = e.rebuild_every
            else:
                # largest divisor of n_steps not above the configured
                # cadence: closest honest approximation (the lattice loop
                # needs n_steps % k == 0).  Silently falling to k=1 would
                # time/behave as per-pass rebuilds while the engine says
                # otherwise.
                k = max(d for d in range(1, e.rebuild_every + 1)
                        if int(n_steps) % d == 0)
                warnings.warn(
                    f"take_steps(n_steps={int(n_steps)}) is not a multiple "
                    f"of rebuild_every={e.rebuild_every}; rebuilding every "
                    f"{k} steps for this call", stacklevel=2)
            rmax = jnp.float32(e.force_r_max) \
                if e.force_r_max is not None else None
            self.d_X, self.d_old_v, self.aux = lattice_heun_steps(
                int(n_steps), k, pw_int, pw_friction, self._fix_mode,
                e.grid_size, e.capacity, e.z_block,
                self.d_X, self.d_old_v, self.d_n, jnp.float32(dt),
                jnp.float32(self.cube_size), jnp.int32(self._fix_point),
                precompute, gen_static, gen_args, rmax, 0, False,
                e.x_split)
            if check_errors:
                self._check_errors()
            return self.aux
        gen = _as_generic(gen_forces)
        gen_args = gen.args if gen is not None else None
        gen_static = gen._replace(args=None) if gen is not None else None
        self.d_X, self.d_old_v, self.aux = heun_steps(
            int(n_steps), self.engine, pw_int, pw_friction, gen_static,
            self._fix_mode, self.d_X, self.d_old_v, self.d_n,
            jnp.float32(dt), jnp.float32(self.cube_size),
            jnp.int32(self._fix_point), gen_args, precompute)
        if check_errors:
            self._check_errors()
        return self.aux

    # -- diagnostics ----------------------------------------------------------
    def validate(self):
        """Runtime sanity checks: NaN/inf in state, count within capacity,
        and engine capacity overflow -- the rebuild's D_ASSERT layer
        (ref cudebug.cuh:8-14; NaN guards at solvers.cuh:153-154).
        Returns a dict of findings; empty means healthy."""
        self._ensure_device()
        problems = {}
        n = self.get_d_n()
        if n > self.n_max:
            problems["over_capacity"] = n
        h = {f: np.asarray(getattr(self.d_X, f)[:n])
             for f in self.pt_type._fields}
        bad = {f: int(np.sum(~np.isfinite(a))) for f, a in h.items()
               if np.sum(~np.isfinite(a))}
        if bad:
            problems["non_finite"] = bad
        if self.check_grid_capacity():
            problems["grid_capacity_overflow"] = True
        gs = getattr(self.engine, "grid_size", None)
        if gs is not None:
            # Out-of-grid points are clipped into edge cubes by every binned
            # engine (the reference D_ASSERTs instead, solvers.cuh:361-364);
            # flag them so mis-binned states are detected, not silently
            # mis-integrated (corner-cube clipping can double-count pairs).
            bin_size = self.cube_size * (1.0 + getattr(self.engine, "skin",
                                                       0.0))
            oob = jax.jit(grid_out_of_bounds, static_argnums=(3,))(
                self.d_X, self.d_n, jnp.float32(bin_size), gs)
            if bool(oob):
                problems["out_of_grid"] = True
        if isinstance(self.engine, LatticeEngine):
            from .ops.lattice_xla import lattice_build
            lay = lattice_build(self.d_X, self.d_old_v, self.d_n,
                                jnp.float32(self.cube_size),
                                self.engine.grid_size, self.engine.capacity,
                                x_split=self.engine.x_split)
            dropped = int(lay.n_dropped)
            if dropped:
                problems["lattice_capacity_dropped"] = dropped
        return problems

    def check_grid_capacity(self):
        """True if the current configuration overflows ``row_cap``
        (rebuild of the reference's capacity D_ASSERTs)."""
        if not isinstance(self.engine, (GridEngine, GabrielEngine)):
            return False
        self._ensure_device()
        gs = self.engine.grid_size

        @partial(jax.jit, static_argnums=(2, 3))
        def _check(X, n, gs, cap, cube_size):
            return grid_overflow(build_grid(X, n, cube_size, gs), gs, cap)

        return bool(_check(self.d_X, self.d_n, gs, self.engine.row_cap,
                           jnp.float32(self.cube_size)))
