"""Growing mesenchyme constrained by a planar wall, with protrusions.

Rebuild of ``examples/growth_w_wall.cu``: a "wall node"
(cell 0) tracks a plane normal to z; cells interact with it through a
point-to-plane ReLU band (``link_wall_forces``), proliferate, and rewire
grid-sampled protrusions; uses the Gabriel solver.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from yalla_tpu import Float3, Property, Solution, friction_on_background
from yalla_tpu.solvers import GabrielEngine
from yalla_tpu.growth import proliferate
from yalla_tpu.inits import random_sphere
from yalla_tpu.links import Links, link_wall_forces, wall_forces, \
    random_cube_neighbours
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
mean_dist = 0.75
r_protrusion = 1.0
protrusion_strength = 0.15
prots_per_cell = 1
n_0 = 500
n_max = 100000
dt = 0.1
n_time_steps = 500
update_prob = 0.5
prolif_rate = 0.005
WALL = 0  # the wall node index


def wall_friction(Xi, r, dist, i, j):
    """No friction with the wall node (ref growth_w_wall.cu:40-47)."""
    ok = (i != WALL) & (j != WALL) & (i != j) & (dist < r_max)
    return jnp.where(ok, 1.0, 0.0)


def relu_force(Xi, r, dist, i, j):
    """Nobody interacts with the wall node via pwints
    (ref growth_w_wall.cu:49-71)."""
    ok = (i != WALL) & (j != WALL) & (i != j) & (dist <= r_max)
    F = jnp.maximum(0.7 - dist, 0) - jnp.maximum(dist - 0.8, 0)
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(ok, F / safe, 0.0)
    return Float3(x=r.x * w, y=r.y * w, z=r.z * w)


def update_protrusions_wall(a, b, X, n_cells, key):
    m = a.shape[0]
    k1, k2 = jax.random.split(key)
    link_id = jnp.arange(m, dtype=jnp.int32)
    src = jnp.minimum(((link_id + 0.5) / prots_per_cell).astype(jnp.int32),
                      X.x.shape[0] - 1)
    cand, found = random_cube_neighbours(X, n_cells,
                                         jnp.float32(r_protrusion), 50,
                                         src, k1)
    d = jnp.sqrt((X.x[src] - X.x[cand]) ** 2 + (X.y[src] - X.y[cand]) ** 2
                 + (X.z[src] - X.z[cand]) ** 2)
    noise = jax.random.uniform(k2, (m,))
    not_init = a == b
    ok = (found & (src != cand) & (src != WALL) & (cand != WALL)
          & (src < n_cells) & (d <= r_protrusion)
          & (not_init | (noise < update_prob)))
    return jnp.where(ok, src, a), jnp.where(ok, cand, b)


def want_fn(X, props, rnd, i, n):
    return (i != WALL) & (rnd <= prolif_rate)


def child_fn(X, props, direction, i):
    off = mean_dist / 4
    daughter = X.replace(x=X.x + off * direction.x,
                         y=X.y + off * direction.y,
                         z=X.z + off * direction.z)
    return X, daughter


def main(n_steps=n_time_steps):
    rng = np.random.default_rng(15)
    # the windowed Gabriel formulation; the in-loop flags certify its
    # row and candidate capacities every step.
    cells = Solution(Float3, n_max, solver="gabriel", grid_size=64,
                     row_cap=64)
    cells.h_n = n_0
    cells.h_X.x[0] = 0
    cells.h_X.y[0] = 0
    cells.h_X.z[0] = -mean_dist  # the wall node
    random_sphere(0.5, cells, n_0=1, rng=rng)
    cells.h_X.z[1:n_0] = np.abs(cells.h_X.z[1:n_0])
    cells.copy_to_device()

    cell_type = Property(cells.n_pad, "cell_type")
    cell_type.h_prop[0] = 0   # wall_node
    cell_type.h_prop[1:] = 1  # mesenchyme

    # Initial relaxation against the wall (ref :172-174).  The UNRELAXED
    # seed ball (spacing 0.5, ref :150) is ~3.4x denser than the relaxed
    # tissue, so this transient runs on its own windowed-Gabriel engine
    # sized for it (row_cap 128)
    relax = Solution(Float3, n_max, n_pad=cells.n_pad,
                     engine=GabrielEngine(grid_size=64, row_cap=128))
    relax.h_X, relax.h_n = cells.h_X, n_0
    relax.copy_to_device()
    for _ in range(101):
        relax.take_step(dt, relu_force, pw_friction=friction_on_background,
                        gen_forces=wall_forces(WALL))
    relax.copy_to_host()
    cells.h_X = relax.h_X
    cells.copy_to_device()
    cells.d_old_v = relax.d_old_v

    protrusions = Links(n_max, protrusion_strength, seed=15)
    protrusions.set_d_n(n_0)
    key = jax.random.PRNGKey(15)

    skip = max(1, n_steps // 100)
    with Vtk_output("growth_w_wall") as output:
        for step in range(n_steps + 1):
            protrusions.set_d_n(min(cells.get_d_n() * prots_per_cell,
                                    protrusions.n_max))
            protrusions.update(update_protrusions_wall, cells)
            cells.take_step(dt, relu_force, pw_friction=wall_friction,
                            gen_forces=link_wall_forces(protrusions, WALL))
            key, sub = jax.random.split(key)
            cells.d_X, cells.d_old_v, cells.d_n, _, _ = proliferate(
                want_fn, child_fn, cells.d_X, cells.d_old_v, cells.d_n, sub)
            if step % skip == 0:
                output.write_positions(cells)
                output.write_links(protrusions)
                output.write_property(cell_type)


if __name__ == "__main__":
    main()
