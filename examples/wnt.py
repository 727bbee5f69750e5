"""Polarities aligning along a morphogen (WNT) gradient.

Rebuild of ``examples/wnt.cu``: w diffuses from a source;
the polarization force is weighted by the w gradient so polarities end up
pointing up the gradient.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from yalla_tpu import Polarity, Solution, make_pt
from yalla_tpu.inits import regular_hexagon
from yalla_tpu.polarity import bidirectional_polarization_force
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
D = 1.0
n_cells = 61
n_time_steps = 150
dt = 0.025
SOURCE = 11

Po_cell4 = make_pt("Po_cell4", "w", "theta", "phi")


def diffusion(Xi, r, dist, i, j):
    near = (i != j) & (dist <= r_max)
    dw = jnp.where(near & (i != SOURCE), -r.w * D, 0.0)

    # Alignment active only towards higher w (ref wnt.cu:27-32)
    act = near & (r.w <= 0)
    safe = jnp.where(dist > 0, dist, 1.0)
    rhat = Polarity(jnp.arccos(jnp.clip(-r.z / safe, -1, 1)),
                    jnp.arctan2(-r.y, -r.x))
    pol = bidirectional_polarization_force(Xi, rhat)
    wgt = jnp.where(act, Xi.w - r.w, 0.0)
    zero = jnp.zeros_like(dist)
    return Po_cell4(x=zero, y=zero, z=zero, w=dw,
                    theta=pol.theta * wgt, phi=pol.phi * wgt)


def main():
    cells = Solution(Po_cell4, n_cells, solver="tile")
    regular_hexagon(0.75, cells)
    h = cells.h_X
    h.w[SOURCE] = 50.0
    for i in range(n_cells):
        if i != SOURCE:
            h.theta[i] = 0.01
            h.phi[i] = np.arctan2(-(h.y[i] - h.y[SOURCE]),
                                  -(h.x[i] - h.x[SOURCE]))
    cells.copy_to_device()

    with Vtk_output("wnt") as output:
        for _ in range(n_time_steps + 1):
            output.write_positions(cells)
            output.write_polarity(cells)
            output.write_field(cells, "w")
            cells.take_step(dt, diffusion)


if __name__ == "__main__":
    main()
