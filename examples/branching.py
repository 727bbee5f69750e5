"""Branching morphogenesis on a spheroid (the flagship model).

Rebuild of the reference's ``examples/branching.cu`` on
``yalla_tpu.models.branching``: Turing signaling on the epithelium,
type-dependent mechanics, gated proliferation with lineage tracing.
Writes positions/polarity/u/v/type/clone per frame plus the lineage tree.

Usage: python examples/branching.py [n_max] [n_frames]
(defaults mirror the reference: 500000 cells, 500 frames x 11 substeps)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from yalla_tpu import Property, Solution
from yalla_tpu.links import Links
from yalla_tpu.models import branching as B
from yalla_tpu.solvers import GridEngine
from yalla_tpu.vtkio import Vtk_output

def _argv_int(i, default):
    try:
        return int(sys.argv[i])
    except (IndexError, ValueError):
        return default


n_0 = 500
n_max = _argv_int(1, 500000)
n_frames = _argv_int(2, 500)
substeps = 11
CKPT_EVERY = 20
CKPT_PATH = "output/branching.ckpt.npz"


def _state_treedef():
    """Tree structure of a branching State (shape-independent)."""
    from yalla_tpu.dtypes import Float3
    from yalla_tpu.growth import lineage_init
    z = jnp.zeros(1)
    cell = B.Cell(*([z] * len(B.Cell._fields)))
    tmpl = B.State(X=cell, old_v=Float3(z, z, z), n=jnp.int32(0),
                   lineage=lineage_init(1, 1, 0), epi_nbs=z, mes_nbs=z,
                   key=jax.random.PRNGKey(0))
    return jax.tree_util.tree_structure(tmpl)


def save_ckpt(path, state, t_next, tier, cell_steps, n_resizes, wall):
    """Atomic npz snapshot of the full State + loop bookkeeping, so an
    interrupted run (``--resume``) costs at most CKPT_EVERY frames instead
    of the whole run."""
    leaves = jax.tree_util.tree_leaves(state)
    data = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)}
    data["meta"] = np.array([t_next, tier, cell_steps, n_resizes], np.int64)
    data["wall"] = np.float64(wall)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **data)
    os.replace(tmp, path)


def load_ckpt(path):
    """Restore (state, t_next, tier, cell_steps, n_resizes, wall)."""
    with np.load(path) as data:
        t_next, tier, cell_steps, n_resizes = (int(x) for x in data["meta"])
        wall = float(data["wall"])
        n_leaves = sum(1 for k in data.files if k.startswith("leaf_"))
        leaves = [jnp.asarray(data[f"leaf_{i}"]) for i in range(n_leaves)]
    state = jax.tree_util.tree_unflatten(_state_treedef(), leaves)
    return state, t_next, tier, cell_steps, n_resizes, wall


def main():
    import time

    from yalla_tpu.utils import enable_compilation_cache
    enable_compilation_cache()

    t_start = time.perf_counter()
    n_resizes = 0
    cell_steps = 0
    p = B.Params()
    # Capacity-tier scheduling: a static-shape engine's per-pass cost
    # tracks its PADDED size, not the live count, so the growing tissue
    # runs each phase at the smallest sufficient tier and re-pads upward.
    # The reference gets this for free: its kernel launches follow the
    # live n (branching.cu:265).
    tier = B.next_tier(n_0, n_max)
    lineage_cap = 2 * Solution(B.Cell, n_max, solver="grid").n_pad
    t0 = 0
    if "--resume" in sys.argv and os.path.exists(CKPT_PATH):
        state, t0, tier, cell_steps, n_resizes, prev_wall = \
            load_ckpt(CKPT_PATH)
        t_start -= prev_wall  # keep cumulative wall-clock honest
        engine = B.default_engine(tier, tier, p)
        cells = Solution(B.Cell, tier, engine=engine, cube_size=p.r_max)
        print(f"# resuming from {CKPT_PATH}: frame {t0}, tier {tier}, "
              f"n = {int(state.n)}")
    else:
        state, cells, engine = B.init_state(n_0, tier, p, seed=42,
                                            lineage_cap=lineage_cap)
    frame = B.make_frame(p, engine, substeps=substeps)

    # Pre-compile the NEXT tier's frame on a background thread: the AOT
    # compile fills the persistent cache while the current tier runs, so
    # a tier jump costs a cache load instead of a compile.
    import threading

    def precompile(tier_next, state_now):
        eng = B.default_engine(tier_next, tier_next, p)
        frm = B.make_frame(p, eng, substeps=substeps)
        shapes = jax.eval_shape(lambda s: B.repad_state(s, tier_next),
                                state_now)
        frm.lower(shapes, jax.ShapeDtypeStruct((), jnp.float32)).compile()

    def start_precompile(tier_now, state_now):
        caps = B.tier_caps(n_max)
        if tier_now < caps[-1]:
            nxt = caps[caps.index(tier_now) + 1]
            th = threading.Thread(target=precompile, args=(nxt, state_now),
                                  daemon=True)
            th.start()
            return th
        return None

    pre_thread = start_precompile(tier, state)

    def fused_errs(errs, n):
        """One device round trip for the error flags + live count (each
        separate float() would be its own device-to-host readback)."""
        keys = [k for k in errs if k != "__err_cells_lost"]
        vec = jnp.concatenate([
            jnp.stack([errs[k] for k in keys]) if keys else jnp.zeros(0),
            n.astype(jnp.float32)[None]])
        host = np.asarray(vec)
        return bool(np.any(host[:-1])), int(host[-1]), {
            k: float(v) for k, v in zip(keys, host)}

    # async_write: frame t transfers/formats/writes on a worker thread
    # while the device computes frame t+1 (ref branching.cu:263-281)
    n_live = int(state.n) if t0 else n_0
    with Vtk_output("branching", async_write=True) as output:
        output.time_step = t0
        for t in range(t0, n_frames + 1):
            new_tier = B.next_tier(n_live, n_max)
            if new_tier > tier:
                if pre_thread is not None:
                    pre_thread.join()  # cache is filled; load, don't compile
                tier = new_tier
                state = B.repad_state(state, tier)
                engine = B.default_engine(tier, tier, p)
                frame = B.make_frame(p, engine, substeps=substeps)
                cells = Solution(B.Cell, tier, engine=engine,
                                 cube_size=p.r_max)
                print(f"\nframe {t}: tier -> {tier} ({engine})")
                pre_thread = start_precompile(tier, state)
            cells.d_X, cells.d_old_v, cells.d_n = \
                state.X, state.old_v, state.n
            # the whole frame's outputs in ONE device->host transfer
            output.write_frame(
                cells, polarity=True, fields=("u", "v"),
                properties=(("type", state.X.ctype, np.int32),
                            ("cell_clone", state.lineage.cell_clone,
                             np.int32)))
            prev, prev_n = state, n_live
            cell_steps += substeps * n_live
            state, errs = frame(state, jnp.float32(t / max(n_frames, 1)))
            bad, n_live, _ = fused_errs(errs, state.n)
            if bad:
                # the growing tissue outran the engine (out-of-grid or
                # cube capacity): resize from the live extent, recompile
                # the frame, and redo this frame from the saved state
                engine = B.engine_for_state(prev, tier, p)
                n_resizes += 1
                print(f"\nframe {t}: resizing engine -> {engine}")
                frame = B.make_frame(p, engine, substeps=substeps)
                state, errs = frame(prev, jnp.float32(t / max(n_frames, 1)))
                bad, n_live, detail = fused_errs(errs, state.n)
                assert not bad, f"still failing: {detail}"
            if t and t % CKPT_EVERY == 0:
                save_ckpt(CKPT_PATH, state, t + 1, tier, cell_steps,
                          n_resizes, time.perf_counter() - t_start)
    if pre_thread is not None:
        pre_thread.join()  # a compile still running must not outlive main
    wall = time.perf_counter() - t_start
    print(f"\n# branching flagship: {n_frames} frames x {substeps} substeps"
          f" in {wall:.1f} s ({n_frames / wall:.2f} frames/s,"
          f" ~{cell_steps / wall:.3g} cell-steps/s incl. I/O),"
          f" final n = {int(state.n)}, engine resizes = {n_resizes}")

    # Lineage tree output (ref branching.cu:283-339)
    lin = state.lineage
    n_tree = int(lin.n_nodes)
    n_cells_final = int(state.n)
    h = cells.copy_to_host()
    total = n_tree + n_cells_final
    tree = Solution(B.Cell, max(total, 1), solver="grid")
    branches = Links(max(total, 1), strength=0.0)
    node_clone = Property(tree.n_pad, "node_clone")
    node_time = Property(tree.n_pad, "node_time", np.float32)
    node_type = Property(tree.n_pad, "node_type")

    tree.h_X.x[:n_tree] = np.asarray(lin.node_x)[:n_tree]
    tree.h_X.y[:n_tree] = np.asarray(lin.node_y)[:n_tree]
    tree.h_X.z[:n_tree] = np.asarray(lin.node_z)[:n_tree]
    node_clone.h_prop[:n_tree] = np.asarray(lin.node_clone)[:n_tree]
    node_time.h_prop[:n_tree] = np.asarray(lin.node_time)[:n_tree]
    node_type.h_prop[:n_tree] = np.asarray(lin.node_type)[:n_tree]
    nparent = np.asarray(lin.node_parent)
    cparent = np.asarray(lin.cell_parent)
    idx = np.arange(n_tree)
    m = nparent[:n_tree] >= 0
    branches.h_a[:n_tree][m] = idx[m]
    branches.h_b[:n_tree][m] = nparent[:n_tree][m]
    sl = slice(n_tree, total)
    tree.h_X.x[sl] = h.x[:n_cells_final]
    tree.h_X.y[sl] = h.y[:n_cells_final]
    tree.h_X.z[sl] = h.z[:n_cells_final]
    node_clone.h_prop[sl] = np.asarray(lin.cell_clone)[:n_cells_final]
    node_time.h_prop[sl] = 1.0
    node_type.h_prop[sl] = np.asarray(h.ctype[:n_cells_final]).astype(np.int32)
    ci = np.arange(n_cells_final)
    cm = cparent[:n_cells_final] >= 0
    branches.h_a[sl][cm] = n_tree + ci[cm]
    branches.h_b[sl][cm] = cparent[:n_cells_final][cm]
    tree.h_n = total
    branches.h_n = total
    tree.copy_to_device()
    branches.copy_to_device()

    with Vtk_output("branching.tree", verbose=False) as tree_output:
        tree_output.write_positions(tree)
        tree_output.write_links(branches)
        tree_output.write_property(node_clone)
        tree_output.write_property(node_time)
        tree_output.write_property(node_type)


if __name__ == "__main__":
    main()
