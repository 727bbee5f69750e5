"""growth_w_wall-class step at the reference scale (100k cells, Gabriel
solver + wall + protrusion links) on one GPU; exits non-zero without one.
Synthesizes the grown half-space tissue directly.
Usage: python benchmarks/bench_growth_w_wall.py [n] [steps]
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

import growth_w_wall as G  # noqa: E402
from yalla_tpu import Float3, Solution  # noqa: E402
from yalla_tpu.links import Links, link_wall_forces  # noqa: E402
from yalla_tpu.solvers import GabrielEngine  # noqa: E402

n_cells = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
n_steps = int(sys.argv[2]) if len(sys.argv) > 2 else 5

rng = np.random.default_rng(0)
# half-space slab above the wall plane (wall node = cell 0 at origin).
# max_candidates: the Gabriel midpoint test is O(NC^2) per point -- the
# dominant cost at the reference's fixed 100 (solvers.cuh:525-527).  At
# this tissue's density ~12 candidates sit within the cutoff, so NC = 32
# is generous; the in-loop __err_gabriel_candidates flag certifies that
# no point ever exceeded it (the reference silently overruns instead).
# the shared window needs the block's sorted span (~i_block) plus ~3
# tissue rows (~100 cells each at this density); misfits (e.g. the wall
# node) ride the salvage pass
cells = Solution(Float3, n_cells, cube_size=G.r_max,
                 engine=GabrielEngine(grid_size=64, row_cap=32,
                                      i_block=2048, max_candidates=24,
                                      window_cap=96, subgroup=16,
                                      salvage_cap=1024))
n_pad = cells.n_pad
side = int(np.ceil((2 * n_cells) ** (1 / 3)))
g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
             -1).reshape(-1, 3)
pos = (g - side / 2) * 0.75 + rng.uniform(-0.2, 0.2, (len(g), 3))
pos = pos[pos[:, 2] > 0.2][:n_pad - 1]
h = cells.h_X
h.x[1:1 + len(pos)] = pos[:, 0]
h.y[1:1 + len(pos)] = pos[:, 1]
h.z[1:1 + len(pos)] = pos[:, 2]
cells.h_n = min(n_cells, len(pos) + 1)
cells.copy_to_device()
print(f"n={cells.h_n} grid_size=64 row_cap=24 max_candidates=100")

prot = Links(n_cells, G.protrusion_strength, seed=15)
prot.set_d_n(cells.h_n)
gen = link_wall_forces(prot, G.WALL)

# warm-up + compile (fused scan: one dispatch for all steps)
cells.take_steps(n_steps, G.dt, G.relu_force,
                 pw_friction=G.wall_friction, gen_forces=gen)
_ = float(np.asarray(cells.d_X.x)[0])
t0 = time.perf_counter()
cells.take_steps(n_steps, G.dt, G.relu_force,
                 pw_friction=G.wall_friction, gen_forces=gen)
_ = float(np.asarray(cells.d_X.x)[0])
dt = time.perf_counter() - t0
n = cells.h_n
print(f"growth_w_wall-class (Gabriel): {dt / n_steps * 1000:.0f} ms/step "
      f"({n * n_steps / dt:.3g} cell-steps/s)")
