"""Tutorial model: framework features added one part at a time.

Rebuild of ``examples/model_features_sequential_addition.cu``:
1) relax a mesenchymal ball, 2) surround it with epithelium, 3) add a
morphogen gradient, 4) add proliferation, 5) add gradient-oriented
protrusion intercalation.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from yalla_tpu import (Property, Solution, friction_on_background, make_pt)
from yalla_tpu.growth import proliferate
from yalla_tpu.inits import random_sphere
from yalla_tpu.links import Links, link_forces, random_cube_neighbours
from yalla_tpu.polarity import bending_force_fast, polarity_precompute
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
r_min = 0.8
dt = 0.1
n_0 = 200
n_max = 4000
prots_per_cell = 1
protrusion_strength = 0.25
r_protrusion = 2.0
proliferation_rate = 0.040
MESENCHYME, EPITHELIUM = 0.0, 1.0

Cell = make_pt("MsaCell", "w", "theta", "phi", "ctype")


def force(Xi, r, dist, i, j):
    diag = i == j
    mes_i = Xi.ctype == MESENCHYME
    dw = jnp.where(diag & mes_i & (Xi.w >= 0), -0.01 * Xi.w, 0.0)

    near = (~diag) & (dist <= r_max)
    same = r.ctype == 0.0
    F_mes = jnp.maximum(0.7 - dist, 0) * 3 - jnp.maximum(dist - 0.8, 0)
    F_epi = jnp.maximum(0.7 - dist, 0) * 2 - jnp.maximum(dist - 0.8, 0)
    F_diff = jnp.maximum(0.8 - dist, 0) * 2 - jnp.maximum(dist - 0.9, 0) * 1.5
    F = jnp.where(same, jnp.where(mes_i, F_mes, F_epi), F_diff)
    safe = jnp.where(dist > 0, dist, 1.0)
    wgt = jnp.where(near, F / safe, 0.0)
    dw = dw + jnp.where(near & mes_i & (Xi.w >= 0), -r.w * 0.4, 0.0)

    both_epi = near & (Xi.ctype * (Xi.ctype - r.ctype) == 1.0)
    bend = bending_force_fast(Xi, r, jnp.where(near, dist, 1.0)) * 0.10
    bw = jnp.where(both_epi, 1.0, 0.0)
    zero = jnp.zeros_like(dist)
    dF = Cell(x=r.x * wgt + bend.x * bw, y=r.y * wgt + bend.y * bw,
              z=r.z * wgt + bend.z * bw, w=dw,
              theta=bend.theta * bw, phi=bend.phi * bw, ctype=zero)
    Xj_type = Xi.ctype - r.ctype
    aux = {"epi_nbs": jnp.where(near & (Xj_type == EPITHELIUM), 1.0, 0.0),
           "mes_nbs": jnp.where(near & (Xj_type == MESENCHYME), 1.0, 0.0)}
    return dF, aux


def update_protrusions(a, b, X, n_cells, key):
    """Protrusions orient normal to the w gradient (ref :110-155)."""
    m = a.shape[0]
    k1, k2 = jax.random.split(key)
    link_id = jnp.arange(m, dtype=jnp.int32)
    src = jnp.minimum(((link_id + 0.5) / prots_per_cell).astype(jnp.int32),
                      X.x.shape[0] - 1)
    cand, found = random_cube_neighbours(X, n_cells,
                                         jnp.float32(r_protrusion), 32,
                                         src, k1)
    both_mes = (X.ctype[src] == MESENCHYME) & (X.ctype[cand] == MESENCHYME)
    nd = jnp.sqrt((X.x[src] - X.x[cand]) ** 2 + (X.y[src] - X.y[cand]) ** 2
                  + (X.z[src] - X.z[cand]) ** 2)
    od = jnp.sqrt((X.x[a] - X.x[b]) ** 2 + (X.y[a] - X.y[b]) ** 2
                  + (X.z[a] - X.z[b]) ** 2)
    noise = jax.random.uniform(k2, (m,))
    normal_to_w = (jnp.abs((X.w[src] - X.w[cand])
                           / jnp.where(nd > 0, nd, 1.0))
                   < jnp.abs((X.w[a] - X.w[b]) / jnp.where(od > 0, od, 1.0))
                   * (1.0 - noise))
    ok = (found & both_mes & (src != cand) & (nd <= r_protrusion)
          & (src < n_cells) & ((a == b) | normal_to_w))
    return jnp.where(ok, src, a), jnp.where(ok, cand, b)


def want_fn(X, props, rnd, i, n):
    epi_nbs, mes_nbs = props
    guard = i < (n * (1 - proliferation_rate)).astype(jnp.int32)
    mes_ok = (X.ctype == MESENCHYME) & (rnd <= proliferation_rate)
    epi_ok = ((X.ctype == EPITHELIUM) & (epi_nbs <= 14) & (mes_nbs >= 1)
              & (rnd <= 2 * proliferation_rate))
    return guard & (mes_ok | epi_ok)


def child_fn(X, props, direction, i):
    off = r_min / 4
    mes = X.ctype == MESENCHYME
    parent = X.replace(w=jnp.where(mes, X.w / 2, X.w))
    daughter = parent.replace(x=X.x + off * direction.x,
                              y=X.y + off * direction.y,
                              z=X.z + off * direction.z)
    return parent, daughter


def main(part_steps=100):
    rng = np.random.default_rng(16)
    cells = Solution(Cell, n_max, solver="grid", grid_size=50)
    cells.h_n = n_0
    random_sphere(0.55, cells, rng=rng)
    ctype_prop = Property(cells.n_pad, "cell_type")

    def write(output, links=None):
        output.write_positions(cells)
        if links is not None:
            output.write_links(links)
        output.write_polarity(cells)
        ctype_prop.h_prop = np.asarray(cells.h_X.ctype).astype(np.int32)
        output.write_property(ctype_prop)
        output.write_field(cells, "w")

    pre = polarity_precompute
    with Vtk_output("model_features_sequential_addition") as output:
        # Part 1: relax the mesenchymal ball
        mes_nbs = None
        for _ in range(part_steps + 1):
            write(output)
            aux = cells.take_step(dt, force,
                                  pw_friction=friction_on_background,
                                  precompute=pre)
            mes_nbs = aux["mes_nbs"]

        # Part 2: surface cells become epithelium (ref :204-215, counter
        # threshold halved: ours counts one Heun pass)
        mes = np.asarray(mes_nbs)
        h = cells.copy_to_host()
        surf = (mes < 20) & (np.arange(cells.n_pad) < n_0)
        d = np.maximum(np.sqrt(h.x ** 2 + h.y ** 2 + h.z ** 2), 1e-6)
        h.ctype[surf] = EPITHELIUM
        h.theta[surf] = np.arccos(np.clip(h.z / d, -1, 1))[surf]
        h.phi[surf] = np.arctan2(h.y, h.x)[surf]
        cells.copy_to_device()
        for _ in range(part_steps + 1):
            write(output)
            cells.take_step(dt, force, precompute=pre)

        # Part 3: morphogen source on one side
        h = cells.copy_to_host()
        h.w[(h.x > 1.0) & (np.arange(cells.n_pad) < cells.h_n)] = 1.0
        cells.copy_to_device()
        for _ in range(part_steps + 1):
            write(output)
            cells.take_step(dt, force, precompute=pre)

        # Part 4: proliferation
        key = jax.random.PRNGKey(16)
        epi_nbs = jnp.zeros(cells.n_pad)
        mes_nbs = jnp.zeros(cells.n_pad)
        for _ in range(part_steps + 1):
            write(output)
            aux = cells.take_step(dt, force, precompute=pre)
            epi_nbs, mes_nbs = aux["epi_nbs"], aux["mes_nbs"]
            key, sub = jax.random.split(key)
            cells.d_X, cells.d_old_v, cells.d_n, _, _ = proliferate(
                want_fn, child_fn, cells.d_X, cells.d_old_v, cells.d_n,
                sub, props=(epi_nbs, mes_nbs))

        # Part 5: gradient-oriented intercalation
        protrusions = Links(n_max * prots_per_cell, protrusion_strength,
                            seed=16)
        protrusions.set_d_n(n_0 * prots_per_cell)
        for _ in range(part_steps + 1):
            write(output, protrusions)
            protrusions.set_d_n(min(cells.get_d_n() * prots_per_cell,
                                    protrusions.n_max))
            protrusions.update(update_protrusions, cells)
            cells.take_step(dt, force, gen_forces=link_forces(protrusions),
                            precompute=pre)


if __name__ == "__main__":
    main()
