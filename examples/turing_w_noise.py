"""Meinhardt patterning with per-cell noise injected into the reaction.

Rebuild of ``examples/turing_w_noise.cu``: same model as
``turing.py`` but each diagonal (reaction) evaluation perturbs u with
counter-based per-cell noise -- the JAX replacement for the
reference's per-cell curandState inside the force functor.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from yalla_tpu import GenericForce, Solution, make_pt
from yalla_tpu.dtypes import pt_zeros_like
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
noise_amp = 0.01

dt = 0.05 * r_min * r_min / D_v

Epi_cell = make_pt("Epi_cell", "theta", "phi", "u", "v")


def epithelium_w_turing(Xi, r, dist, i, j):
    diag = i == j
    du_r = lam * ((f_u * Xi.u * Xi.u) / (1 + f_v * Xi.v) - m_u * Xi.u + s_u)
    dv_r = lam * (g_u * Xi.u * Xi.u - m_v * Xi.v)
    near = (~diag) & (dist <= r_max)
    du = jnp.where(diag, du_r, jnp.where(near, -D_u * r.u, 0.0))
    dv = jnp.where(diag, dv_r, jnp.where(near, -D_v * r.v, 0.0))
    F = 2 * (r_min - dist) * (r_max - dist) + (r_max - dist) ** 2
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(near, F / safe, 0.0)
    bend = bending_force(Xi, r, jnp.where(near, dist, 1.0)) * 3.0
    bw = jnp.where(near, 1.0, 0.0)
    return Epi_cell(x=r.x * w + bend.x * bw, y=r.y * w + bend.y * bw,
                    z=r.z * w + bend.z * bw,
                    theta=bend.theta * bw, phi=bend.phi * bw, u=du, v=dv)


def _noise_fn(X, n, key):
    """Uniform per-cell noise added to du (counter-based jax.random keys
    replace curandState, ref turing_w_noise.cu:36-40)."""
    dX = pt_zeros_like(X)
    active = jnp.arange(X.x.shape[0], dtype=jnp.int32) < n
    rnd = jax.random.uniform(key, X.x.shape) * noise_amp
    return dX.replace(u=jnp.where(active, rnd, 0.0))


def main(n_steps=n_time_steps):
    rng = np.random.default_rng(8)
    cells = Solution(Epi_cell, n_cells, solver="grid")
    cells.h_X.theta[:n_cells] = np.pi / 2
    cells.h_X.u[:n_cells] = rng.random(n_cells) / 5 - 0.1
    cells.h_X.v[:n_cells] = rng.random(n_cells) / 5 - 0.1
    random_disk(0.5, cells)
    key = jax.random.PRNGKey(8)

    with Vtk_output("turing_w_noise") as output:
        for frame in range(n_steps // skip_steps + 1):
            output.write_positions(cells)
            output.write_polarity(cells)
            output.write_field(cells, "u")
            output.write_field(cells, "v")
            for _ in range(skip_steps):
                key, sub = jax.random.split(key)
                cells.take_step(dt, epithelium_w_turing,
                                gen_forces=GenericForce(_noise_fn, sub))


if __name__ == "__main__":
    main()
