"""Smoke tests: every example model runs end-to-end (reduced step counts)
and produces ParaView-loadable VTK output -- the rebuild's analogue of the
reference's ``examples/compile_all.py`` compile-and-run coverage."""
import importlib
import os
import sys

import pytest

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
sys.path.insert(0, EXAMPLES)


@pytest.fixture()
def outdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _load(name, **overrides):
    mod = importlib.import_module(name)
    importlib.reload(mod)  # re-evaluate module constants
    for k, v in overrides.items():
        setattr(mod, k, v)
    return mod


def _check_vtk(outdir, base):
    files = list((outdir / "output").glob(f"{base}_*.vtk"))
    assert files, f"no VTK output for {base}"
    head = files[0].read_text().splitlines()
    assert head[0].startswith("# vtk DataFile")
    assert any("POINTS" in l for l in head[:8])


def test_springs(outdir):
    m = _load("springs", n_time_steps=5)
    m.main()
    _check_vtk(outdir, "springs")


def test_sorting(outdir):
    m = _load("sorting", n_time_steps=5)
    m.main()
    _check_vtk(outdir, "sorting")


def test_sorting_prot(outdir):
    m = _load("sorting_prot", n_time_steps=5)
    m.main()
    _check_vtk(outdir, "sorting_prot")


def test_gradient(outdir):
    m = _load("gradient", n_time_steps=5)
    m.main()
    _check_vtk(outdir, "gradient")


def test_turing(outdir):
    m = _load("turing")
    m.main(n_steps=100)
    _check_vtk(outdir, "turing")


def test_turing_w_noise(outdir):
    m = _load("turing_w_noise")
    m.main(n_steps=4)
    _check_vtk(outdir, "turing_w_noise")


def test_epithelium(outdir):
    m = _load("epithelium", n_cells=60, n_time_steps=4)
    m.main()
    _check_vtk(outdir, "epithelium")


def test_bending(outdir):
    m = _load("bending", n_time_steps=5)
    m.main()
    _check_vtk(outdir, "bending")


def test_apical_constriction(outdir):
    m = _load("apical_constriction", n_time_steps=80)
    m.main()
    _check_vtk(outdir, "apical_constriction")


def test_polarization(outdir):
    m = _load("polarization", n_time_steps=5)
    m.main()
    _check_vtk(outdir, "polarization")


def test_epithelia_double_polarity(outdir):
    m = _load("epithelia_double_polarity")
    m.main(n_steps=20)
    _check_vtk(outdir, "epithelia_double_polarity")


def test_migration(outdir):
    m = _load("migration", n_time_steps=4)
    m.main()
    _check_vtk(outdir, "migration")


def test_random_walk(outdir):
    m = _load("random_walk", n_cells=60, n_time_steps=4)
    m.main()
    _check_vtk(outdir, "random_walk")


def test_wnt(outdir):
    m = _load("wnt", n_time_steps=5)
    m.main()
    _check_vtk(outdir, "wnt")


def test_intercalation(outdir):
    m = _load("intercalation", n_time_steps=5)
    m.main()
    _check_vtk(outdir, "intercalation")


def test_passive_growth(outdir):
    m = _load("passive_growth", n_0=100, n_max=400)
    m.main(n_steps=4)
    _check_vtk(outdir, "passive_growth")


def test_lineage_tracing(outdir):
    m = _load("lineage_tracing", n_max=500)
    m.main(n_steps=120)  # divisions start after step 100
    _check_vtk(outdir, "lineage_tracing")
    _check_vtk(outdir, "lineage_tree")


def test_growth_w_wall(outdir):
    m = _load("growth_w_wall", n_0=100, n_max=400)
    m.main(n_steps=4)
    _check_vtk(outdir, "growth_w_wall")


def test_model_features_sequential_addition(outdir):
    m = _load("model_features_sequential_addition")
    m.main(part_steps=3)
    _check_vtk(outdir, "model_features_sequential_addition")


def test_intercalation_w_gradient(outdir):
    m = _load("intercalation_w_gradient")
    m.main(n_steps=2)
    _check_vtk(outdir, "intercalation_w_gradient")


def test_teapot(outdir):
    m = _load("teapot")
    m.main(n=4000)
    _check_vtk(outdir, "teapot")


def test_write_vtk_w_mask(outdir):
    m = _load("write_vtk_w_mask")
    m.main()
    _check_vtk(outdir, "test_vtk")


def test_branching_example(outdir):
    import branching as m
    importlib.reload(m)
    m.n_0 = 100
    m.n_max = 300
    m.n_frames = 2
    m.substeps = 2
    m.main()
    _check_vtk(outdir, "branching")
    _check_vtk(outdir, "branching.tree")


def test_branching_resume(outdir):
    """An interrupted run resumes from the periodic checkpoint with
    loop bookkeeping (frame index, tier, counters) intact."""
    import sys

    import branching as m
    importlib.reload(m)
    m.n_0 = 100
    m.n_max = 300
    m.n_frames = 8
    m.substeps = 2
    m.CKPT_EVERY = 3
    m.main()
    assert (outdir / "output" / "branching.ckpt.npz").exists()
    state, t0, tier, cell_steps, n_resizes, wall = m.load_ckpt(m.CKPT_PATH)
    assert t0 == 7 and cell_steps > 0 and wall > 0
    old_argv = sys.argv
    sys.argv = ["branching.py", "300", "10", "--resume"]
    try:
        m.n_frames = 10
        m.main()
    finally:
        sys.argv = old_argv
    _check_vtk(outdir, "branching")
    # resumed frames continue the numbering where the checkpoint left off
    assert (outdir / "output" / "branching_10.vtk").exists()
