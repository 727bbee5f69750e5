"""Growing mesenchyme enveloped by an epithelium.

Rebuild of ``examples/passive_growth.cu``: type-dependent
mechanics, neighbour-count side channels (aux reductions instead of device
counters), mesenchyme-to-epithelium transition, and proliferation gated by
type and neighbourhood.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from yalla_tpu import Solution, make_pt
from yalla_tpu.growth import proliferate
from yalla_tpu.inits import relaxed_sphere
from yalla_tpu.polarity import bending_force
from yalla_tpu.vtkio import Vtk_output

r_max = 1.0
mean_dist = 0.75
prolif_rate = 0.006
n_0 = 200
n_max = 5000
n_time_steps = 500
dt = 0.2

MESENCHYME, EPITHELIUM = 0.0, 1.0
# Cell type rides in the point type with zero dynamics so the force can
# branch on it (replaces the reference's d_type device global).
PgCell = make_pt("PgCell", "theta", "phi", "ctype")


def relu_w_epithelium(Xi, r, dist, i, j):
    near = (i != j) & (dist <= r_max)
    same = r.ctype == 0.0
    F_same = jnp.maximum(0.7 - dist, 0) * 2 - jnp.maximum(dist - 0.8, 0)
    F_diff = jnp.maximum(0.8 - dist, 0) * 2 - jnp.maximum(dist - 0.9, 0)
    F = jnp.where(same, F_same, F_diff)
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(near, F / safe, 0.0)

    both_epi = near & (Xi.ctype * (Xi.ctype - r.ctype) == 1.0)
    bend = bending_force(Xi, r, jnp.where(near, dist, 1.0)) * 0.15
    bw = jnp.where(both_epi, 1.0, 0.0)
    zero = jnp.zeros_like(dist)
    dF = PgCell(x=r.x * w + bend.x * bw, y=r.y * w + bend.y * bw,
                z=r.z * w + bend.z * bw,
                theta=bend.theta * bw, phi=bend.phi * bw, ctype=zero)
    Xj_type = Xi.ctype - r.ctype
    aux = {"mes_nbs": jnp.where(near & (Xj_type == MESENCHYME), 1.0, 0.0),
           "epi_nbs": jnp.where(near & (Xj_type == EPITHELIUM), 1.0, 0.0)}
    return dF, aux


def want_fn(X, props, rnd, i, n):
    rate, mes_nbs, epi_nbs = props
    mes_ok = (X.ctype == MESENCHYME) & (rnd <= rate)
    epi_ok = (X.ctype == EPITHELIUM) & (epi_nbs <= mes_nbs)
    return mes_ok | epi_ok


def child_fn(X, props, direction, i):
    off = mean_dist / 4
    daughter = X.replace(x=X.x + off * direction.x,
                         y=X.y + off * direction.y,
                         z=X.z + off * direction.z)
    return X, daughter


def main(n_steps=n_time_steps):
    rng = np.random.default_rng(13)
    cells = Solution(PgCell, n_max, solver="grid")
    cells.h_n = n_0
    relaxed_sphere(mean_dist, cells, rng=rng)

    # Find the epithelium: surface cells have few mesenchymal neighbours
    # (ref passive_growth.cu:120-139; < 12*2 there because its counters
    # accumulate over both Heun passes -- ours count one pass)
    aux = cells.take_step(dt, relu_w_epithelium)
    mes_nbs = np.asarray(aux["mes_nbs"])
    h = cells.copy_to_host()
    surface = (mes_nbs < 12) & (np.arange(cells.n_pad) < n_0)
    d = np.sqrt(h.x ** 2 + h.y ** 2 + h.z ** 2)
    d = np.where(d > 0, d, 1.0)
    h.ctype[surface] = EPITHELIUM
    h.theta[surface] = np.arccos(np.clip(h.z / d, -1, 1))[surface]
    h.phi[surface] = np.arctan2(h.y, h.x)[surface]
    cells.copy_to_device()

    key = jax.random.PRNGKey(13)
    epi_nbs = jnp.zeros(cells.n_pad)
    mes_nbs_d = jnp.zeros(cells.n_pad)
    with Vtk_output("passive_growth") as output:
        for step in range(n_steps + 1):
            output.write_positions(cells)
            output.write_field(cells, "ctype", field="ctype")
            output.write_polarity(cells)
            aux = cells.take_step(dt, relu_w_epithelium)
            mes_nbs_d, epi_nbs = aux["mes_nbs"], aux["epi_nbs"]
            key, sub = jax.random.split(key)
            rate = jnp.float32(prolif_rate * (step > 100))
            (cells.d_X, cells.d_old_v, cells.d_n, _, _) = proliferate(
                want_fn, child_fn, cells.d_X, cells.d_old_v, cells.d_n,
                sub, props=(rate, mes_nbs_d, epi_nbs))


if __name__ == "__main__":
    main()
