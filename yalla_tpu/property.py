"""Per-cell state that is not numerically integrated (cell type, counters,
lineage ids, ...).  Rebuild of ``include/property.cuh``.

A ``Property`` is a named, fixed-capacity array with a mutable host mirror
and a device array, named for VTK export.  Integer by default, like the
reference's ``Property<Prop = int>``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["Property"]


class Property:
    def __init__(self, n_max, name="cell_type", dtype=np.int32):
        self.n_max = int(n_max)
        self.name = name
        self.dtype = np.dtype(dtype)
        self.h_prop = np.zeros(self.n_max, self.dtype)
        self.d_prop = None

    def copy_to_device(self):
        self.d_prop = jnp.asarray(self.h_prop)

    def copy_to_host(self):
        if self.d_prop is not None:
            # np.array (not asarray): the host mirror must stay writable so
            # checkpoint/VTK restore can assign into it
            self.h_prop = np.array(self.d_prop)
        return self.h_prop
