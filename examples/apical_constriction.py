"""Apical constriction: wedge-shaped cells bend a flat sheet into a cup.

Rebuild of ``examples/apical_constriction.cu``: bending
force with a preferred angle != 90 deg.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from yalla_tpu import Po_cell, Solution, friction_on_background
from yalla_tpu.inits import regular_rectangle
from yalla_tpu.polarity import apical_constriction_force
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
n_cells = 225
n_time_steps = 4000
skip_steps = 40
dt = 0.1
pref_angle_dev = 20.0 * np.pi / 180.0


def constriction_force(Xi, r, dist, i, j):
    near = (i != j) & (dist <= r_max)
    F = jnp.maximum(0.8 - dist, 0) * 2 - jnp.maximum(dist - 0.8, 0) * 2
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(near, F / safe, 0.0)
    con = apical_constriction_force(
        Xi, r, jnp.where(near, dist, 1.0),
        jnp.pi / 2 - pref_angle_dev) * 0.6
    m = jnp.where(near, 1.0, 0.0)
    return Po_cell(x=r.x * w + con.x * m, y=r.y * w + con.y * m,
                   z=r.z * w + con.z * m,
                   theta=con.theta * m, phi=con.phi * m)


def main():
    cells = Solution(Po_cell, n_cells, solver="grid")
    regular_rectangle(0.8, 15, cells)
    cells.h_X.theta[:n_cells] = np.arccos(1.0)
    cells.h_X.phi[:n_cells] = np.arctan2(1.0, 1.0)
    cells.copy_to_device()

    with Vtk_output("apical_constriction", verbose=False) as output:
        for _ in range(n_time_steps // skip_steps + 1):
            output.write_positions(cells)
            output.write_polarity(cells)
            output.write_field(cells, "z", field="z")
            cells.take_steps(skip_steps, dt, constriction_force,
                             pw_friction=friction_on_background)


if __name__ == "__main__":
    main()
