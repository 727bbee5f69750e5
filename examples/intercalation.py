"""Intercalating cells: protrusions along x drive convergent extension.

Rebuild of ``examples/intercalation.cu``: link table with
random rewiring (keep links 1 < dist < 2 roughly aligned with x).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from yalla_tpu import Float3, Solution
from yalla_tpu.inits import random_sphere
from yalla_tpu.links import Links, link_forces
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
r_min = 0.5
n_cells = 500
prots_per_cell = 1
n_time_steps = 250
dt = 0.2


def clipped_cubic(Xi, r, dist, i, j):
    near = (i != j) & (dist <= r_max)
    F = 2 * (r_min - dist) * (r_max - dist) + (r_max - dist) ** 2
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(near, F / safe, 0.0)
    return Float3(x=r.x * w, y=r.y * w, z=r.z * w)


def update_protrusions(a, b, X, n_cells_d, key):
    """Drop stretched/collapsed links; propose random x-aligned links
    (ref intercalation.cu:32-56)."""
    m = a.shape[0]
    dist = jnp.sqrt((X.x[a] - X.x[b]) ** 2 + (X.y[a] - X.y[b]) ** 2
                    + (X.z[a] - X.z[b]) ** 2)
    drop = (dist < 1) | (dist > 2)
    a = jnp.where(drop, 0, a)
    b = jnp.where(drop, 0, b)

    link_id = jnp.arange(m, dtype=jnp.int32)
    jj = ((link_id + 0.5) / prots_per_cell).astype(jnp.int32)
    kk = jnp.minimum((jax.random.uniform(key, (m,)) * n_cells_d)
                     .astype(jnp.int32), n_cells_d - 1)
    rx = X.x[jj] - X.x[kk]
    ry = X.y[jj] - X.y[kk]
    rz = X.z[jj] - X.z[kk]
    d = jnp.sqrt(rx * rx + ry * ry + rz * rz)
    ok = (jj != kk) & (jnp.abs(rx / jnp.where(d > 0, d, 1.0)) < 0.2) \
        & (d > 1) & (d < 2)
    return jnp.where(ok, jj, a), jnp.where(ok, kk, b)


def main():
    cells = Solution(Float3, n_cells, solver="grid", row_cap=64)
    random_sphere(r_min, cells)
    protrusions = Links(n_cells * prots_per_cell, seed=11)

    with Vtk_output("intercalation") as output:
        for _ in range(n_time_steps + 1):
            output.write_positions(cells)
            output.write_links(protrusions)
            protrusions.update(update_protrusions, cells)
            cells.take_step(dt, clipped_cubic,
                            gen_forces=link_forces(protrusions))


if __name__ == "__main__":
    main()
