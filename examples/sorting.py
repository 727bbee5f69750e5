"""Cell sorting by differential adhesion strength.

Rebuild of ``examples/sorting.cu``: two cell types with a
clipped cubic potential whose strength depends on both types; the stickier
population sorts to the core.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from yalla_tpu import Float3, Property, Solution
from yalla_tpu.inits import random_sphere
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
r_min = 0.5
n_cells = 100
n_time_steps = 300
dt = 0.05


def differential_adhesion(Xi, r, dist, i, j):
    valid = (i != j) & (dist <= r_max)
    strength = (1 + 2 * (j < n_cells // 2)) * (1 + 2 * (i < n_cells // 2))
    F = 2 * (r_min - dist) * (r_max - dist) + (r_max - dist) ** 2
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(valid, strength * F / safe, 0.0)
    return Float3(x=r.x * w, y=r.y * w, z=r.z * w)


def main():
    cells = Solution(Float3, n_cells, solver="grid")
    random_sphere(r_min, cells)
    cell_type = Property(n_cells, "cell_type")
    cell_type.h_prop[:] = (np.arange(n_cells) >= n_cells // 2).astype(np.int32)

    with Vtk_output("sorting") as output:
        for _ in range(n_time_steps + 1):
            output.write_positions(cells)
            output.write_property(cell_type)
            cells.take_step(dt, differential_adhesion)


if __name__ == "__main__":
    main()
