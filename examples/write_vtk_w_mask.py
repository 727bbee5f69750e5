"""Write a masked subset of a Solution to VTK.

Rebuild of ``examples/write_vtk_w_mask.cu``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import math

import numpy as np

from yalla_tpu import Solution, make_pt
from yalla_tpu.vtkio import Vtk_output

Po_cell4 = make_pt("Po_cell4", "w", "theta", "phi")
n_cells = 100


def main():
    rng = np.random.default_rng(0)
    pts = Solution(Po_cell4, n_cells, solver="tile")
    pts.h_X.x[:n_cells] = rng.random(n_cells)
    pts.h_X.y[:n_cells] = rng.random(n_cells)
    pts.h_X.z[:n_cells] = rng.random(n_cells)
    pts.h_X.w[:n_cells] = rng.random(n_cells)
    pts.h_X.phi[:n_cells] = rng.random(n_cells) * 2 * math.pi - math.pi
    pts.h_X.theta[:n_cells] = np.arccos(2 * rng.random(n_cells) - 1)
    pts.copy_to_device()

    mask = pts.h_X.x[:n_cells] > 0.5
    output = Vtk_output("test_vtk", verbose=False)
    output.write_positions(pts, mask=mask)
    output.write_field(pts, "w")


if __name__ == "__main__":
    main()
