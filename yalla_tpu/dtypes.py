"""Point types: a vector space over named float fields.

Rebuild of the reference's ``MAKE_PT`` macro
(``include/dtypes.cuh:58-147``): a point type ``Pt`` carries
``x, y, z`` plus arbitrary extra float fields (polarity angles, morphogen
concentrations, ...), all of which are integrated component-wise.

Instead of a CUDA struct, a ``Pt`` here is a registered JAX pytree
(a NamedTuple of arrays).  A single ``Pt`` instance usually holds *batched*
fields -- e.g. ``f32[n_max]`` per field for a whole cell population, or
``f32[B, K]`` pair blocks inside a pairwise engine -- so arithmetic on ``Pt``
is vectorized by construction and fuses under ``jax.jit``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "make_pt",
    "Float3",
    "Float4",
    "Po_cell",
    "Polarity",
    "pt_zeros_like",
    "dot_product",
]

_PT_REGISTRY: dict[tuple[str, tuple[str, ...]], type] = {}


class _PtMixin:
    """Component-wise vector-space operators (ref dtypes.cuh:151-217)."""

    __slots__ = ()

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other):
        return jax.tree.map(jnp.add, self, other)

    def __sub__(self, other):
        return jax.tree.map(jnp.subtract, self, other)

    def __neg__(self):
        return jax.tree.map(jnp.negative, self)

    def __mul__(self, scalar):
        return jax.tree.map(lambda v: v * scalar, self)

    __rmul__ = __mul__

    def __truediv__(self, scalar):
        return jax.tree.map(lambda v: v / scalar, self)

    # -- convenience --------------------------------------------------------
    @classmethod
    def zeros(cls, shape=(), dtype=jnp.float32):
        z = jnp.zeros(shape, dtype)
        return cls(*([z] * len(cls._fields)))

    @classmethod
    def from_xyz(cls, xyz, **extras):
        """Build from an ``[..., 3]`` coordinate array; extras default to 0."""
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        vals = {"x": x, "y": y, "z": z}
        zero = jnp.zeros_like(x)
        for f in cls._fields[3:]:
            vals[f] = extras.get(f, zero)
        return cls(**vals)

    @property
    def xyz(self):
        """Stacked ``[..., 3]`` view of the positional components."""
        return jnp.stack(
            [jnp.asarray(self.x), jnp.asarray(self.y), jnp.asarray(self.z)],
            axis=-1,
        )

    def replace(self, **kw):
        return self._replace(**kw)

    def astuple(self):
        return tuple(self)


def make_pt(name: str, *extra_fields: str) -> type:
    """Create a point type with fields ``x, y, z, *extra_fields``.

    The JAX analogue of ``MAKE_PT(Pt, ...)``
    (ref dtypes.cuh:58-75).  Returns a NamedTuple subclass that is a JAX
    pytree and supports ``+ - * /`` component-wise.  Types are memoized so
    repeated calls with the same signature return the identical class
    (important for pytree structure equality under jit).
    """
    fields = ("x", "y", "z") + tuple(extra_fields)
    key = (name, fields)
    if key in _PT_REGISTRY:
        return _PT_REGISTRY[key]
    base = NamedTuple(name, [(f, jnp.ndarray) for f in fields])
    cls = type(name, (_PtMixin, base), {"__slots__": ()})
    # Default all components to float 0.0 so ``Pt()`` works like ``Pt{0}``.
    cls.__new__.__defaults__ = tuple(0.0 for _ in fields)
    _PT_REGISTRY[key] = cls
    return cls


# Predefined types mirroring the reference's float3 / float4 / Po_cell
Float3 = make_pt("Float3")
Float4 = make_pt("Float4", "w")
# Polarized cell (ref dtypes.cuh:147): unit vector in spherical coordinates,
# 0 <= theta < pi, -pi <= phi <= pi.
Po_cell = make_pt("Po_cell", "theta", "phi")


class Polarity(NamedTuple):
    """Bare (theta, phi) pair (ref polarity.cuh:9-11)."""

    theta: jnp.ndarray
    phi: jnp.ndarray


def pt_zeros_like(pt):
    return jax.tree.map(jnp.zeros_like, pt)


def dot_product(a, b):
    """3D dot product over the positional components (ref utils.cuh:22-26)."""
    return a.x * b.x + a.y * b.y + a.z * b.z
