"""Meinhardt activator-inhibitor patterning within an epithelium.

Rebuild of ``examples/turing.cu``: reaction on the
diagonal (i == j), pairwise diffusion, mechanics + bending keep the sheet
flat while spots emerge in u.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from yalla_tpu import Solution, make_pt
from yalla_tpu.inits import random_disk
from yalla_tpu.polarity import bending_force
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
r_min = 0.6
n_cells = 500
n_time_steps = 10000
skip_steps = 100

lam = 1.0
D_v = 4.0
f_v = 1.0
f_u = 80.0
g_u = 40.0
m_u = 0.25
m_v = 0.5
s_u = 0.05
D_u = 0.1

dt = 0.05 * r_min * r_min / D_v

Epi_cell = make_pt("Epi_cell", "theta", "phi", "u", "v")


def epithelium_w_turing(Xi, r, dist, i, j):
    diag = i == j
    # Meinhardt reaction terms on the diagonal (ref turing.cu:37-46)
    du_r = lam * ((f_u * Xi.u * Xi.u) / (1 + f_v * Xi.v) - m_u * Xi.u + s_u)
    dv_r = lam * (g_u * Xi.u * Xi.u - m_v * Xi.v)

    near = (~diag) & (dist <= r_max)
    du_d = jnp.where(near, -D_u * r.u, 0.0)
    dv_d = jnp.where(near, -D_v * r.v, 0.0)
    du = jnp.where(diag, du_r, du_d)
    dv = jnp.where(diag, dv_r, dv_d)

    F = 2 * (r_min - dist) * (r_max - dist) + (r_max - dist) ** 2
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(near, F / safe, 0.0)

    bend = bending_force(Xi, r, jnp.where(near, dist, 1.0)) * 3.0
    bw = jnp.where(near, 1.0, 0.0)
    zero = jnp.zeros_like(dist)
    return Epi_cell(x=r.x * w + bend.x * bw, y=r.y * w + bend.y * bw,
                    z=r.z * w + bend.z * bw,
                    theta=bend.theta * bw, phi=bend.phi * bw, u=du, v=dv)


def main(n_steps=n_time_steps):
    rng = np.random.default_rng(1)
    cells = Solution(Epi_cell, n_cells, solver="grid")
    cells.h_X.theta[:n_cells] = np.pi / 2
    cells.h_X.u[:n_cells] = rng.random(n_cells) / 5 - 0.1
    cells.h_X.v[:n_cells] = rng.random(n_cells) / 5 - 0.1
    random_disk(0.5, cells)

    with Vtk_output("turing") as output:
        for frame in range(n_steps // skip_steps + 1):
            output.write_positions(cells)
            output.write_polarity(cells)
            output.write_field(cells, "u")
            output.write_field(cells, "v")
            cells.take_steps(skip_steps, dt, epithelium_w_turing)


if __name__ == "__main__":
    main()
