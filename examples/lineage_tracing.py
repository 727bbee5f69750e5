"""Lineage tracing of a small group of dividing cells; writes the lineage
tree as a second VTK (nodes + LINES branches).

Rebuild of ``examples/lineage_tracing.cu`` on the
prefix-sum division framework (``yalla_tpu.growth``).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from yalla_tpu import Po_cell, Property, Solution
from yalla_tpu.growth import lineage_init, proliferate, record_divisions
from yalla_tpu.inits import regular_rectangle
from yalla_tpu.links import Links
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
mean_dist = 0.75
prolif_rate = 0.005
n_0 = 5
n_max = 5000
n_time_steps = 1000
dt = 0.1


def relaxation_force(Xi, r, dist, i, j):
    near = (i != j) & (dist <= r_max)
    F = jnp.maximum(0.8 - dist, 0) * 2 - jnp.maximum(dist - 0.8, 0)
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(near, F / safe, 0.0)
    zero = jnp.zeros_like(dist)
    return Po_cell(x=r.x * w, y=r.y * w, z=r.z * w, theta=zero, phi=zero)


def want_fn(X, props, rnd, i, n):
    (rate,) = props
    return rnd <= rate


def child_fn(X, props, direction, i):
    off = mean_dist / 4
    daughter = X.replace(x=X.x + off * direction.x,
                         y=X.y + off * direction.y,
                         z=X.z + off * direction.z)
    return X, daughter


def main(n_steps=n_time_steps):
    cells = Solution(Po_cell, n_max, solver="grid")
    cells.h_n = n_0
    regular_rectangle(mean_dist, n_0, cells)
    lin = lineage_init(2 * cells.n_pad, cells.n_pad, n_0)
    key = jax.random.PRNGKey(21)

    cell_parent = Property(cells.n_pad, "cell_parent")
    cell_clone = Property(cells.n_pad, "cell_clone")
    with Vtk_output("lineage_tracing", verbose=False) as output:
        for step in range(n_steps + 1):
            cells.take_step(dt, relaxation_force)
            key, sub = jax.random.split(key)
            rate = jnp.float32(prolif_rate * (step > 100))
            cells.d_X, cells.d_old_v, cells.d_n, _, info = proliferate(
                want_fn, child_fn, cells.d_X, cells.d_old_v, cells.d_n,
                sub, props=(rate,))
            lin = record_divisions(
                lin, info, cells.d_X,
                jnp.zeros(cells.n_pad, jnp.int32), step / n_steps)
            if step % 20 == 0:
                output.write_positions(cells)
                cell_parent.h_prop = np.asarray(lin.cell_parent)
                cell_clone.h_prop = np.asarray(lin.cell_clone)
                output.write_property(cell_parent)
                output.write_property(cell_clone)

    # Assemble the tree: internal nodes then current cells as leaves
    # (ref lineage_tracing.cu:168-215)
    n_tree = int(lin.n_nodes)
    n_cells_final = cells.get_d_n()
    h = cells.copy_to_host()
    tree = Solution(Po_cell, max(n_tree + n_cells_final, 1), solver="grid")
    branches = Links(max(n_tree + n_cells_final, 1), strength=0.0)
    node_clone = Property(tree.n_pad, "node_clone")

    nx = np.asarray(lin.node_x)
    ny = np.asarray(lin.node_y)
    nz = np.asarray(lin.node_z)
    nparent = np.asarray(lin.node_parent)
    nclone = np.asarray(lin.node_clone)
    cparent = np.asarray(lin.cell_parent)
    cclone = np.asarray(lin.cell_clone)

    tree.h_X.x[:n_tree] = nx[:n_tree]
    tree.h_X.y[:n_tree] = ny[:n_tree]
    tree.h_X.z[:n_tree] = nz[:n_tree]
    node_clone.h_prop[:n_tree] = nclone[:n_tree]
    for i in range(n_tree):
        if nparent[i] >= 0:
            branches.h_a[i] = i
            branches.h_b[i] = nparent[i]
    for i in range(n_cells_final):
        tree.h_X.x[n_tree + i] = h.x[i]
        tree.h_X.y[n_tree + i] = h.y[i]
        tree.h_X.z[n_tree + i] = h.z[i]
        node_clone.h_prop[n_tree + i] = cclone[i]
        if cparent[i] >= 0:
            branches.h_a[n_tree + i] = n_tree + i
            branches.h_b[n_tree + i] = cparent[i]
    tree.h_n = n_tree + n_cells_final
    branches.h_n = n_tree + n_cells_final
    tree.copy_to_device()
    branches.copy_to_device()

    with Vtk_output("lineage_tree", verbose=False) as tree_output:
        tree_output.write_positions(tree)
        tree_output.write_links(branches)
        tree_output.write_property(node_clone)


if __name__ == "__main__":
    main()
