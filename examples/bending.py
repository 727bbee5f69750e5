"""A bent epithelium (hexagonal sheet wrapped on a cylinder) relaxing flat.

Rebuild of ``examples/bending.cu``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from yalla_tpu import Po_cell, Solution
from yalla_tpu.inits import regular_hexagon
from yalla_tpu.polarity import bending_force
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
n_cells = 91
n_time_steps = 500
dt = 0.1


def layer_force(Xi, r, dist, i, j):
    near = (i != j) & (dist <= r_max)
    F = jnp.maximum(0.7 - dist, 0) * 2 - jnp.maximum(dist - 0.8, 0)
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(near, F / safe, 0.0)
    bend = bending_force(Xi, r, jnp.where(near, dist, 1.0)) * 0.5
    m = jnp.where(near, 1.0, 0.0)
    return Po_cell(x=r.x * w + bend.x * m, y=r.y * w + bend.y * m,
                   z=r.z * w + bend.z * m,
                   theta=bend.theta * m, phi=bend.phi * m)


def main():
    cells = Solution(Po_cell, n_cells, solver="tile")
    regular_hexagon(0.75, cells)
    radius = 1.6
    h = cells.h_X
    # Rotate by pi/6, then wrap around a cylinder (ref bending.cu:38-52)
    x = h.x[:n_cells].copy()
    y = h.y[:n_cells].copy()
    h.x[:n_cells] = np.cos(np.pi / 6) * x - np.sin(np.pi / 6) * y
    h.y[:n_cells] = np.sin(np.pi / 6) * x + np.cos(np.pi / 6) * y
    phi = h.x[:n_cells] / radius
    phi = np.where(phi == 0, 0.01, phi)
    h.x[:n_cells] = radius * np.sin(phi)
    h.z[:n_cells] = radius * np.cos(phi)
    h.theta[:n_cells] = phi
    cells.copy_to_device()

    with Vtk_output("bending") as output:
        for _ in range(n_time_steps + 1):
            output.write_positions(cells)
            output.write_polarity(cells)
            cells.take_step(dt, layer_force)


if __name__ == "__main__":
    main()
