"""Integrate an N-body problem with springs between all bodies.

Rebuild of ``examples/springs.cu`` -- the minimal
end-to-end slice: all-pairs engine, Heun integration, VTK time series.

Run: python examples/springs.py  (writes output/springs_*.vtk)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from yalla_tpu import Float3, Solution
from yalla_tpu.inits import random_sphere
from yalla_tpu.vtkio import Vtk_output

L_0 = 0.5        # relaxed spring length
n_bodies = 800
n_time_steps = 100
dt = 0.001


def spring(Xi, r, dist, i, j):
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(i != j, (L_0 - dist) / safe, 0.0)
    return Float3(x=r.x * w, y=r.y * w, z=r.z * w)


def main():
    bodies = Solution(Float3, n_bodies, solver="tile")
    random_sphere(L_0, bodies)

    with Vtk_output("springs") as output:
        for _ in range(n_time_steps + 1):
            output.write_positions(bodies)  # host write overlaps async step
            bodies.take_step(dt, spring)


if __name__ == "__main__":
    main()
