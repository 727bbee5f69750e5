"""Cut the Utah teapot out of a cuboid full of points (mesh exclusion).

Rebuild of ``examples/teapot.cu``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from yalla_tpu import Float3, Solution
from yalla_tpu.inits import random_cuboid
from yalla_tpu.mesh import Mesh
from yalla_tpu.vtkio import Vtk_output

n_points = 70000
HERE = os.path.dirname(os.path.abspath(__file__))


def main(n=n_points):
    points = Solution(Float3, n, solver="tile")
    teapot = Mesh(os.path.join(HERE, "teapot.vtk"))
    random_cuboid(0.125 * (n_points / n) ** (1 / 3),
                  teapot.get_minimum(), teapot.get_maximum(), points)

    with Vtk_output("teapot", verbose=False) as output:
        output.write_positions(points)

        h = points.h_X
        m = points.h_n
        pts = np.stack([h.x[:m], h.y[:m], h.z[:m]], 1)
        outside = teapot.test_exclusion_many(pts)
        keep = pts[~outside]
        points.h_X.x[:len(keep)] = keep[:, 0]
        points.h_X.y[:len(keep)] = keep[:, 1]
        points.h_X.z[:len(keep)] = keep[:, 2]
        points.h_n = len(keep)
        points.copy_to_device()
        output.write_positions(points)


if __name__ == "__main__":
    main()
