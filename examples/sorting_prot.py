"""Cell sorting driven by type-dependent protrusion turnover rates.

Rebuild of ``examples/sorting_prot.cu``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from yalla_tpu import Float3, Property, Solution
from yalla_tpu.inits import random_sphere
from yalla_tpu.links import Links, link_forces
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
r_min = 0.5
n_cells = 200
n_protrusions = n_cells * 5
n_time_steps = 300
dt = 0.05


def clipped_cubic(Xi, r, dist, i, j):
    near = (i != j) & (dist <= r_max)
    F = 2 * (r_min - dist) * (r_max - dist) + (r_max - dist) ** 2
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(near, F / safe, 0.0)
    return Float3(x=r.x * w, y=r.y * w, z=r.z * w)


def update_protrusions(a, b, X, n_cells_d, key):
    """Type-dependent turnover (ref sorting_prot.cu:33-69): links between
    the sticky type rewire slowly, the loose type quickly."""
    m = a.shape[0]
    dist = jnp.sqrt((X.x[a] - X.x[b]) ** 2 + (X.y[a] - X.y[b]) ** 2
                    + (X.z[a] - X.z[b]) ** 2)
    drop = (dist < 1) | (dist > 2)
    a = jnp.where(drop, 0, a)
    b = jnp.where(drop, 0, b)

    k1, k2, k3 = jax.random.split(key, 3)
    rnd = jax.random.uniform(k1, (m,))
    half = n_cells // 2
    rate = jnp.where((a < half) & (b < half), 0.05,
                     jnp.where((a > half) & (b > half), 0.25, 0.125))
    turnover = rnd <= rate

    new_j = jnp.minimum((jax.random.uniform(k2, (m,)) * n_cells_d)
                        .astype(jnp.int32), n_cells_d - 1)
    new_k = jnp.minimum((jax.random.uniform(k3, (m,)) * n_cells_d)
                        .astype(jnp.int32), n_cells_d - 1)
    ok = turnover & (new_j != new_k)
    return jnp.where(ok, new_j, a), jnp.where(ok, new_k, b)


def main():
    cells = Solution(Float3, n_cells, solver="grid")
    random_sphere(r_min, cells)
    protrusions = Links(n_protrusions, seed=12)
    cell_type = Property(n_cells, "cell_type")
    cell_type.h_prop[:] = (np.arange(n_cells) >= n_cells // 2).astype(np.int32)

    with Vtk_output("sorting_prot") as output:
        for _ in range(n_time_steps + 1):
            output.write_positions(cells)
            output.write_links(protrusions)
            output.write_property(cell_type)
            protrusions.update(update_protrusions, cells)
            cells.take_step(dt, clipped_cubic,
                            gen_forces=link_forces(protrusions))


if __name__ == "__main__":
    main()
