"""A randomly migrating cell: cone-sampled polarity perturbations rotated
into the migration frame (Rodrigues rotation).

Rebuild of ``examples/random_walk.cu``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from yalla_tpu import Float3, Po_cell, Polarity, Solution
from yalla_tpu.inits import relaxed_sphere
from yalla_tpu.polarity import migration_force, pol_to_float3, pt_to_pol
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
n_cells = 500
n_time_steps = 150
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


@jax.jit
def update_polarity(X, key):
    """Perturb cell 0's polarity in a cone about its current direction
    (ref random_walk.cu:34-60)."""
    k1, k2 = jax.random.split(key)
    pert_theta = jax.random.normal(k1, ())
    pert_phi = 2 * jnp.pi * jax.random.uniform(k2, ())
    d = pol_to_float3(Polarity(pert_theta, pert_phi))
    u_phi = X.phi[0] + jnp.pi / 2
    ux, uy = jnp.cos(u_phi), jnp.sin(u_phi)
    st, ct = jnp.sin(X.theta[0]), jnp.cos(X.theta[0])
    nx = (ct + ux * ux * (1 - ct)) * d.x + ux * uy * (1 - ct) * d.y \
        + uy * st * d.z
    ny = ux * uy * (1 - ct) * d.x + (ct + uy * uy * (1 - ct)) * d.y \
        - ux * st * d.z
    nz = -uy * st * d.x + ux * st * d.y + ct * d.z
    new_pol = pt_to_pol(Float3(nx, ny, nz))
    return X.replace(theta=X.theta.at[0].set(new_pol.theta),
                     phi=X.phi.at[0].set(new_pol.phi))


def main():
    rng = np.random.default_rng(6)
    cells = Solution(Po_cell, n_cells, solver="tile")
    relaxed_sphere(0.75, cells, rng=rng)
    cells.h_X.x[0] = cells.h_X.y[0] = cells.h_X.z[0] = 0
    cells.h_X.theta[0] = 0
    cells.h_X.phi[0] = 0.01
    cells.copy_to_device()
    key = jax.random.PRNGKey(6)

    with Vtk_output("random_walk") as output:
        for _ in range(n_time_steps + 1):
            output.write_positions(cells)
            output.write_polarity(cells)
            key, sub = jax.random.split(key)
            cells.d_X = update_polarity(cells.d_X, sub)
            cells.take_step(dt, relu_w_migration)


if __name__ == "__main__":
    main()
