"""Mesenchyme-to-epithelium transition: polarities relax radially outward.

Rebuild of ``examples/epithelium.cu``: ReLU mechanics plus
bending stiffness on a relaxed ball whose polarities start roughly radial.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from yalla_tpu import Po_cell, Solution, friction_on_background
from yalla_tpu.inits import relaxed_sphere
from yalla_tpu.polarity import bending_force
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
n_cells = 250
n_time_steps = 100
dt = 0.05


def layer_force(Xi, r, dist, i, j):
    near = (i != j) & (dist <= r_max)
    F = jnp.maximum(0.7 - dist, 0) * 2 - jnp.maximum(dist - 0.8, 0)
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(near, F / safe, 0.0)
    bend = bending_force(Xi, r, jnp.where(near, dist, 1.0)) * 0.2
    bw = jnp.where(near, 1.0, 0.0)
    return Po_cell(x=r.x * w + bend.x * bw, y=r.y * w + bend.y * bw,
                   z=r.z * w + bend.z * bw,
                   theta=bend.theta * bw, phi=bend.phi * bw)


def main():
    rng = np.random.default_rng(2)
    cells = Solution(Po_cell, n_cells, solver="grid")
    relaxed_sphere(0.8, cells, rng=rng)
    h = cells.h_X
    d = np.sqrt(h.x ** 2 + h.y ** 2 + h.z ** 2)
    d = np.where(d > 0, d, 1.0)
    n = cells.h_n
    h.theta[:n] = (np.arccos(np.clip(h.z / d, -1, 1))
                   + rng.random(cells.n_pad) * 0.5)[:n]
    h.phi[:n] = (np.arctan2(h.y, h.x) + rng.random(cells.n_pad) * 0.5)[:n]
    cells.copy_to_device()

    with Vtk_output("epithelium") as output:
        for _ in range(n_time_steps + 1):
            output.write_positions(cells)
            output.write_polarity(cells)
            output.write_field(cells, "z", field="z")
            cells.take_step(dt, layer_force,
                            pw_friction=friction_on_background)


if __name__ == "__main__":
    main()
