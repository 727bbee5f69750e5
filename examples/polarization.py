"""Tissue polarization: nematic alignment of cell polarities.

Rebuild of ``examples/polarization.cu``: clipped cubic
mechanics + bidirectional polarization force aligns random polarities.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from yalla_tpu import Po_cell, Solution
from yalla_tpu.inits import random_sphere
from yalla_tpu.polarity import bidirectional_polarization_force
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
r_min = 0.6
n_cells = 200
n_time_steps = 300
dt = 0.025


def polarization(Xi, r, dist, i, j):
    near = (i != j) & (dist <= r_max)
    F = 2 * (r_min - dist) * (r_max - dist) + (r_max - dist) ** 2
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(near, F / safe, 0.0)
    pol = bidirectional_polarization_force(Xi, Xi - r)
    m = jnp.where(near, 1.0, 0.0)
    return Po_cell(x=r.x * w, y=r.y * w, z=r.z * w,
                   theta=pol.theta * m, phi=pol.phi * m)


def main():
    rng = np.random.default_rng(3)
    cells = Solution(Po_cell, n_cells, solver="grid")
    cells.h_X.theta[:n_cells] = np.arccos(2 * rng.random(n_cells) - 1)
    cells.h_X.phi[:n_cells] = 2 * np.pi * rng.random(n_cells)
    random_sphere(0.5, cells)

    with Vtk_output("polarization") as output:
        for _ in range(n_time_steps + 1):
            output.write_positions(cells)
            output.write_polarity(cells)
            cells.take_step(dt, polarization)


if __name__ == "__main__":
    main()
