"""Epithelial cells with two polarity axes: apical-basal (theta, phi) and
planar cell polarity (iota, chi).

Rebuild of ``examples/epithelia_double_polarity.cu``:
first half of the run bends against the AB axis, second half against the
PCP axis -- the ``axis=`` keyword replaces the reference's member-pointer
template parameters.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from yalla_tpu import Solution, make_pt
from yalla_tpu.inits import random_sphere
from yalla_tpu.polarity import bending_force
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
n_cells = 300
n_time_steps = 500
skip_step = 5
dt = 0.1

Pcp_epi = make_pt("Pcp_epi", "theta", "phi", "iota", "chi")


def _mk_force(axis):
    def force(Xi, r, dist, i, j):
        near = (i != j) & (dist <= r_max)
        F = jnp.maximum(0.8 - dist, 0) * 1.0 - jnp.maximum(dist - 0.8, 0) * 1.5
        safe = jnp.where(dist > 0, dist, 1.0)
        w = jnp.where(near, F / safe, 0.0)
        bend = bending_force(Xi, r, jnp.where(near, dist, 1.0),
                             axis=axis) * 0.3
        m = jnp.where(near, 1.0, 0.0)
        zero = jnp.zeros_like(dist)
        upd = {axis[0]: getattr(bend, axis[0]) * m,
               axis[1]: getattr(bend, axis[1]) * m}
        other = [f for f in ("theta", "phi", "iota", "chi") if f not in axis]
        upd.update({f: zero for f in other})
        return Pcp_epi(x=r.x * w + bend.x * m, y=r.y * w + bend.y * m,
                       z=r.z * w + bend.z * m, **upd)
    return force


force_A = _mk_force(("theta", "phi"))
force_B = _mk_force(("iota", "chi"))


def main(n_steps=n_time_steps):
    rng = np.random.default_rng(14)
    cells = Solution(Pcp_epi, n_cells, solver="grid")
    random_sphere(0.8, cells, rng=rng)
    h = cells.h_X
    d = np.maximum(np.sqrt(h.x ** 2 + h.y ** 2 + h.z ** 2), 1e-6)
    h.theta[:n_cells] = np.arccos(np.clip(h.z / d, -1, 1))[:n_cells]
    h.phi[:n_cells] = np.arctan2(h.y, h.x)[:n_cells]
    h.iota[:n_cells] = np.arccos(0.0)
    h.chi[:n_cells] = np.arctan2(0.0, 1.0)
    cells.copy_to_device()

    with Vtk_output("epithelia_double_polarity") as output:
        for half, force in ((0, force_A), (1, force_B)):
            for step in range(n_steps // 2 // skip_step):
                cells.take_steps(skip_step, dt, force)
                output.write_positions(cells)
                output.write_polarity(cells)
                output.write_polarity(cells, "pcp", axis=("iota", "chi"))


if __name__ == "__main__":
    main()
