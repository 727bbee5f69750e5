"""Mesenchymal intercalation orchestrated by epithelial signals.

Rebuild of ``examples/intercalation_w_gradient.cu``: an
11,557-cell embryo IC restarts from ``examples/sphere_ic.vtk`` (VTK files
double as checkpoints); two morphogens (w, f) diffuse from epithelial
sources and steer grid-sampled protrusion rewiring; epithelium
proliferates.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from yalla_tpu import Property, Solution, make_pt
from yalla_tpu.growth import proliferate
from yalla_tpu.links import Links, link_forces, random_cube_neighbours
from yalla_tpu.polarity import bending_force_fast, polarity_precompute
from yalla_tpu.vtkio import Vtk_input, Vtk_output

r_max = 1.0
r_min = 0.8
dt = 0.1
n_max = 150000
prots_per_cell = 1
protrusion_strength = 0.2
r_protrusion = 2.0
mean_proliferation_rate = 0.015
n_time_steps = 500
MESENCHYME, EPITHELIUM = 0.0, 1.0

Cell = make_pt("IwgCell", "w", "f", "theta", "phi", "ctype")
HERE = os.path.dirname(os.path.abspath(__file__))


def force(Xi, r, dist, i, j):
    diag = i == j
    mes_i = Xi.ctype == MESENCHYME
    # degradation on the diagonal (ref :34-41)
    dw = jnp.where(diag & mes_i, -0.01 * Xi.w, 0.0)
    df = jnp.where(diag & mes_i, -0.01 * Xi.f, 0.0)

    near = (~diag) & (dist <= r_max)
    same = r.ctype == 0.0
    F_mes = jnp.maximum(0.8 - dist, 0) * 2 - jnp.maximum(dist - 0.8, 0)
    F_epi = jnp.maximum(0.8 - dist, 0) * 2 - jnp.maximum(dist - 0.8, 0) * 2
    F_diff = jnp.maximum(0.9 - dist, 0) * 2 - jnp.maximum(dist - 0.9, 0) * 2
    F = jnp.where(same, jnp.where(mes_i, F_mes, F_epi), F_diff)
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(near, F / safe, 0.0)

    dw = dw + jnp.where(near & mes_i, -r.w * 0.1, 0.0)
    df = df + jnp.where(near & mes_i, -r.f * 0.1, 0.0)

    both_epi = near & (Xi.ctype * (Xi.ctype - r.ctype) == 1.0)
    bend = bending_force_fast(Xi, r, jnp.where(near, dist, 1.0)) * 0.15
    bw = jnp.where(both_epi, 1.0, 0.0)
    zero = jnp.zeros_like(dist)
    dF = Cell(x=r.x * w + bend.x * bw, y=r.y * w + bend.y * bw,
              z=r.z * w + bend.z * bw, w=dw, f=df,
              theta=bend.theta * bw, phi=bend.phi * bw, ctype=zero)
    Xj_type = Xi.ctype - r.ctype
    aux = {"epi_nbs": jnp.where(near & (Xj_type == EPITHELIUM), 1.0, 0.0),
           "mes_nbs": jnp.where(near & (Xj_type == MESENCHYME), 1.0, 0.0)}
    return dF, aux


def make_update_protrusions(n_pad):
    def update(a, b, X, n_cells, key):
        """Grid-sampled candidates; superficial cells align normal to the f
        gradient, deep cells along the w gradient (ref :120-173)."""
        m = a.shape[0]
        k1, k2 = jax.random.split(key)
        link_id = jnp.arange(m, dtype=jnp.int32)
        src = jnp.minimum(((link_id + 0.5) / prots_per_cell)
                          .astype(jnp.int32), n_pad - 1)
        cand, found = random_cube_neighbours(
            X, n_cells, jnp.float32(r_protrusion), 32, src, k1)

        both_mes = (X.ctype[src] == MESENCHYME) & (X.ctype[cand] == MESENCHYME)
        new_rw = X.w[src] - X.w[cand]
        new_rf = X.f[src] - X.f[cand]
        nd = jnp.sqrt((X.x[src] - X.x[cand]) ** 2
                      + (X.y[src] - X.y[cand]) ** 2
                      + (X.z[src] - X.z[cand]) ** 2)
        nd_safe = jnp.where(nd > 0, nd, 1.0)
        od = jnp.sqrt((X.x[a] - X.x[b]) ** 2 + (X.y[a] - X.y[b]) ** 2
                      + (X.z[a] - X.z[b]) ** 2)
        od_safe = jnp.where(od > 0, od, 1.0)
        old_rw = X.w[a] - X.w[b]
        old_rf = X.f[a] - X.f[b]
        noise = jax.random.uniform(k2, (m,))
        superficial = X.w[src] + X.w[cand] > 0.3
        normal_to_f = superficial & (
            jnp.abs(new_rf / nd_safe) < jnp.abs(old_rf / od_safe)
            * (1.0 - noise))
        parallel_to_w = (~superficial) & (
            jnp.abs(new_rw / nd_safe) > jnp.abs(old_rw / od_safe)
            * (1.0 - noise))
        not_init = a == b
        ok = (found & both_mes & (src != cand) & (nd <= r_protrusion)
              & (src < n_cells) & (not_init | parallel_to_w | normal_to_f))
        return jnp.where(ok, src, a), jnp.where(ok, cand, b)
    return update


def want_fn(X, props, rnd, i, n):
    epi_nbs, mes_nbs = props
    guard = i < (n * (1 - mean_proliferation_rate)).astype(jnp.int32)
    return (guard & (X.ctype == EPITHELIUM) & (epi_nbs <= 7) & (mes_nbs >= 1)
            & (rnd <= mean_proliferation_rate))


def child_fn(X, props, direction, i):
    off = r_min / 4
    mes = X.ctype == MESENCHYME
    parent = X.replace(w=jnp.where(mes, X.w / 2, X.w),
                       f=jnp.where(mes, X.f / 2, X.f))
    daughter = parent.replace(x=X.x + off * direction.x,
                              y=X.y + off * direction.y,
                              z=X.z + off * direction.z)
    return parent, daughter


def main(n_steps=n_time_steps):
    inp = Vtk_input(os.path.join(HERE, "sphere_ic.vtk"))
    n_0 = inp.n_points
    # auto: all-pairs below the crossover, a binned engine above (the
    # sweep kernel on the GPU, the lattice elsewhere); the protrusion
    # link forces run inside the step either way
    cells = Solution(Cell, n_max, solver="auto")
    cells.h_n = n_0
    inp.read_positions(cells)
    inp.read_polarity(cells)
    intype = Property(cells.n_pad, "cell_type")
    inp.read_property(intype, "cell_type")

    h = cells.h_X
    h.ctype[:n_0] = (intype.h_prop[:n_0] == 1).astype(np.float32)
    epi_top = (h.ctype == 1.0) & (h.z > 0)
    h.w[epi_top] = 1.0
    h.f[epi_top & (h.x > 0) & (np.abs(h.y) < 2.5) & (h.z < 3.0)] = 1.0
    cells.copy_to_device()

    protrusions = Links(n_max * prots_per_cell, protrusion_strength, seed=9)
    update = make_update_protrusions(cells.n_pad)
    key = jax.random.PRNGKey(9)
    ctype_prop = Property(cells.n_pad, "cell_type")

    # One jitted program per step: rewire + Heun step (link forces through
    # the generic hook) + proliferate -- a single device dispatch, mirroring
    # the reference's per-step kernel sequence (intercalation_w_gradient.cu
    # :226-248) without its per-launch round trips.
    cells._ensure_device()
    engine = cells.engine
    from yalla_tpu.links import linear_force, _link_gen_fn
    from yalla_tpu.solvers import GenericForce, heun_step
    from yalla_tpu.ops.common import friction_w_neighbour
    gen_static = GenericForce(fn=_link_gen_fn(linear_force),
                              fields=("x", "y", "z"))

    @jax.jit
    def fused_step(X, old_v, n, a, b, key):
        n_links = jnp.minimum(n * prots_per_cell, a.shape[0])
        live = jnp.arange(a.shape[0], dtype=jnp.int32) < n_links
        k1, k2 = jax.random.split(key)
        a2, b2 = update(a, b, X, n, k1)
        a = jnp.where(live, a2, a)
        b = jnp.where(live, b2, b)
        X, old_v, aux = heun_step(
            engine, force, friction_w_neighbour, gen_static, "com",
            X, old_v, n, jnp.float32(dt), jnp.float32(r_max), jnp.int32(0),
            (a, b, n_links, jnp.float32(protrusion_strength)),
            polarity_precompute)
        X, old_v, n, _, _ = proliferate(
            want_fn, child_fn, X, old_v, n, k2,
            props=(aux["epi_nbs"], aux["mes_nbs"]))
        errs = {k: v for k, v in aux.items() if k.startswith("__err_")}
        return X, old_v, n, a, b, n_links, errs

    with Vtk_output("intercalation_w_gradient") as output:
        for _ in range(n_steps + 1):
            output.write_positions(cells)
            output.write_links(protrusions)
            ctype_prop.h_prop = np.asarray(cells.h_X.ctype).astype(np.int32)
            output.write_property(ctype_prop)
            output.write_field(cells, "w")
            output.write_field(cells, "f")

            key, sub = jax.random.split(key)
            (cells.d_X, cells.d_old_v, cells.d_n, protrusions.d_a,
             protrusions.d_b, protrusions.d_n, errs) = fused_step(
                cells.d_X, cells.d_old_v, cells.d_n,
                protrusions.d_a, protrusions.d_b, sub)
            assert not any(float(np.max(np.asarray(v)))
                           for v in errs.values()), errs


if __name__ == "__main__":
    main()
