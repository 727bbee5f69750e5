"""Morphogen gradient forming by cell-to-cell diffusion from one source.

Rebuild of ``examples/gradient.cu``: the extra field w
diffuses pairwise (dw = -D * r.w) from a clamped source cell.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from yalla_tpu import Float4, Solution
from yalla_tpu.inits import regular_hexagon
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
D = 10.0
n_cells = 61
n_time_steps = 200
dt = 0.005
SOURCE = 11


def diffusion(Xi, r, dist, i, j):
    valid = (i != j) & (dist <= r_max) & (i != SOURCE)
    dw = jnp.where(valid, -r.w * D, 0.0)
    zero = jnp.zeros_like(dw)
    return Float4(x=zero, y=zero, z=zero, w=dw)


def main():
    cells = Solution(Float4, n_cells, solver="tile")
    cells.h_X.w[SOURCE] = 1.0
    regular_hexagon(0.75, cells)

    with Vtk_output("gradient") as output:
        for _ in range(n_time_steps + 1):
            output.write_positions(cells)
            output.write_field(cells, "w")
            cells.take_step(dt, diffusion)


if __name__ == "__main__":
    main()
