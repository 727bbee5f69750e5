"""Mono-polar migration: one polarized cell crawls through a cuboid tissue.

Rebuild of ``examples/migration.cu``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from yalla_tpu import Po_cell, Solution
from yalla_tpu.inits import relaxed_cuboid
from yalla_tpu.polarity import migration_force
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
n_cells = 261
n_time_steps = 100
dt = 0.05


def relu_w_migration(Xi, r, dist, i, j):
    near = (i != j) & (dist <= r_max)
    F = jnp.maximum(0.7 - dist, 0) * 2 - jnp.maximum(dist - 0.8, 0)
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(near, F / safe, 0.0)
    mig = migration_force(Xi, r, jnp.where(near, dist, 1.0))
    m = jnp.where(near, 1.0, 0.0)
    return Po_cell(x=r.x * w + mig.x * m, y=r.y * w + mig.y * m,
                   z=r.z * w + mig.z * m,
                   theta=jnp.zeros_like(dist), phi=jnp.zeros_like(dist))


def main():
    rng = np.random.default_rng(4)
    cells = Solution(Po_cell, n_cells, solver="tile")
    relaxed_cuboid(0.75, (-1.5, -1.5, 0), (1.5, 1.5, 10), cells, rng=rng)
    # Add the migrating cell at the origin with polarity ~ +x
    mig_idx = cells.h_n
    cells.h_X.x[mig_idx] = 0
    cells.h_X.y[mig_idx] = 0
    cells.h_X.z[mig_idx] = 0
    cells.h_X.theta[mig_idx] = 0.0
    cells.h_X.phi[mig_idx] = 0.01
    cells.h_n += 1
    cells.copy_to_device()

    with Vtk_output("migration") as output:
        for _ in range(n_time_steps + 1):
            output.write_positions(cells)
            output.write_polarity(cells)
            cells.take_step(dt, relu_w_migration)


if __name__ == "__main__":
    main()
