"""intercalation_w_gradient-class step (150k cells, 1 protrusion/cell,
per-step grid-sampled rewiring, link forces inside the lattice-resident
loop) on one GPU; exits non-zero without one.

Synthesizes a 150k-cell two-layer tissue directly (the example grows into
this regime over ~200 steps); measures rewire + Heun step throughput.
Usage: python benchmarks/bench_intercalation.py [n] [steps]
"""
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import os  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "examples"))

from yalla_tpu import backend  # noqa: E402

backend.require_gpu()
print(f"device: {backend.device_info()}; card: {backend.card_line()}")

import intercalation_w_gradient as IWG  # noqa: E402
from yalla_tpu import Solution  # noqa: E402
from yalla_tpu.links import Links, link_forces  # noqa: E402
from yalla_tpu.polarity import polarity_precompute  # noqa: E402

n_cells = int(sys.argv[1]) if len(sys.argv) > 1 else 150_000
n_steps = int(sys.argv[2]) if len(sys.argv) > 2 else 20

rng = np.random.default_rng(0)
cells = Solution(IWG.Cell, n_cells, solver="auto")
n_pad = cells.n_pad
side = int(np.ceil(n_cells ** (1 / 3)))
g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
             -1).reshape(-1, 3)[:n_pad]
pos = (g - side / 2) * 0.75 + rng.uniform(-0.2, 0.2, (len(g), 3))
pos = np.concatenate([pos, np.zeros((max(0, n_pad - len(pos)), 3))])[:n_pad]
surface = np.abs(pos).max(1) > (side / 2 * 0.75 - 1.0)
h = cells.h_X
h.x[:], h.y[:], h.z[:] = pos.T.astype(np.float32)
h.ctype[:] = surface.astype(np.float32)
rr = np.maximum(np.linalg.norm(pos, axis=1), 1e-6)
h.theta[:] = np.where(surface, np.arccos(np.clip(pos[:, 2] / rr, -1, 1)), 0)
h.phi[:] = np.where(surface, np.arctan2(pos[:, 1], pos[:, 0]), 0)
h.w[:] = rng.random(n_pad).astype(np.float32)
h.f[:] = rng.random(n_pad).astype(np.float32)
cells.h_n = n_cells
cells.copy_to_device()
cells._ensure_device()
print("engine:", cells.engine)

prot = Links(n_cells * IWG.prots_per_cell, IWG.protrusion_strength, seed=9)
prot.set_d_n(n_cells)
update = IWG.make_update_protrusions(n_pad)


import jax.numpy as jnp
from yalla_tpu.links import linear_force, _link_gen_fn
from yalla_tpu.solvers import GenericForce, heun_step
from yalla_tpu.ops.common import friction_w_neighbour

cells._ensure_device()
engine = cells.engine
gen_static = GenericForce(fn=_link_gen_fn(linear_force),
                          fields=("x", "y", "z"))
key = jax.random.PRNGKey(0)


@jax.jit
def fused(X, old_v, n, a, b, key):
    n_links = jnp.minimum(n * IWG.prots_per_cell, a.shape[0])
    live = jnp.arange(a.shape[0], dtype=jnp.int32) < n_links
    k1, k2 = jax.random.split(key)
    a2, b2 = update(a, b, X, n, k1)
    a = jnp.where(live, a2, a)
    b = jnp.where(live, b2, b)
    X, old_v, aux = heun_step(
        engine, IWG.force, friction_w_neighbour, gen_static, "com",
        X, old_v, n, jnp.float32(IWG.dt), jnp.float32(IWG.r_max),
        jnp.int32(0), (a, b, n_links, jnp.float32(prot.strength)),
        polarity_precompute)
    return X, old_v, a, b, k2


def one_step():
    global key
    cells.d_X, cells.d_old_v, prot.d_a, prot.d_b, key = fused(
        cells.d_X, cells.d_old_v, cells.d_n, prot.d_a, prot.d_b, key)


one_step()
_ = float(np.asarray(cells.d_X.x)[0])
t0 = time.perf_counter()
for _ in range(n_steps):
    one_step()
_ = float(np.asarray(cells.d_X.x)[0])
dt = time.perf_counter() - t0
print(f"intercalation_w_gradient-class: n={n_cells} "
      f"{dt / n_steps * 1000:.1f} ms/step "
      f"({n_cells * n_steps / dt:.3g} cell-steps/s, per-step rewiring)")
