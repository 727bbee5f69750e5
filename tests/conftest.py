"""Test configuration: run on a virtual 8-device CPU mesh.

Must set platform flags before jax initializes its backends.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"  # the suite runs on the CPU only
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# The config API wins over any platform plugin: force the CPU backend
# (card-only checks are ``gpu``-marked and run by chip_smoke.py).  An
# 8-device virtual CPU mesh exercises the sharded paths.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

from yalla_tpu.utils import enable_compilation_cache  # noqa: E402

enable_compilation_cache(min_compile_secs=0.5)

import zlib  # noqa: E402

import pytest  # noqa: E402


# Two-tier suite.  The multi-hundred-step oracle and
# statistics scans below are marked ``slow`` centrally (no per-file
# churn; names without parametrization suffixes); `pytest -q` runs the
# fast tier (default addopts in pytest.ini), the full suite runs with
# `pytest -m "slow or not slow"`.  Durations are from a CPU run; the
# fast tier keeps at least one cross-engine
# oracle per subsystem (test_compare_methods, test_lattice_matches_tile,
# test_growth_w_wall, ...).
SLOW_TESTS = {
    # test_fastpath.py
    "test_resident_staleness_lateral_slip_not_flagged",   # 147 s
    "test_rebin_per_pass_matches_per_pass_build",         # 89 s
    "test_resident_staleness_radial_flow_not_flagged",    # 79 s
    "test_rebin_resident_matches_stable_resident",        # 48 s
    "test_resident_staleness_collective_flow_not_flagged",  # 47 s
    "test_lattice_gen_forces_match_tile",                 # 44 s
    "test_resident_staleness_flag",                       # 34 s
    "test_resident_staleness_diagonal_escape_flagged",    # 15 s
    # test_xsplit.py
    "test_xsplit_capacity2_matches_tile",                 # 99 s
    "test_xsplit_rebin_per_pass_matches_tile",            # 16 s
    "test_xsplit_matches_tile",                           # 16 s
    # test_growth.py (fast tier keeps the proliferation oracles;
    # the resize drill spins 4 engine recompiles)
    "test_frame_error_flags_and_engine_resize",           # 13 s
    # test_aniso.py (fast tier keeps the aniso rebin flags)
    "test_lattice_aniso_matches_tile",                    # 11 s
    # test_physics_stats.py
    "test_turing_pattern_emerges",                        # 107 s
    "test_branching_engines_agree",                       # 89 s
    # test_parallel.py
    "test_lattice_z_slab_sharded_matches_single",         # 106 s
    "test_sharded_lattice_engine_with_links",             # 26 s
    "test_resident_sharded_links_match_single",           # 25 s
    # test_aniso.py
    # test_solvers.py
    "test_gabriel_stable_id_semantics",                   # 43 s
    "test_gabriel_windowed_misfit_salvage",               # 21 s
    # test_examples.py
    "test_intercalation_w_gradient",                      # 40 s
    # test_validate.py
    "test_auto_solver",                                   # 22 s
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name.split("[")[0] in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True)
def _deterministic_global_rng(request):
    """Reseed the shared inits RNG per test from the test name, so results
    never depend on which other tests ran first (collection order)."""
    from yalla_tpu import inits
    inits.set_seed(zlib.crc32(request.node.nodeid.encode()))


@pytest.fixture
def gpu():
    """Skip the test unless JAX's default backend is a GPU.  Decided here,
    when the test runs -- never at import or collection time, so every
    test worker collects the same tests."""
    from yalla_tpu import backend
    if not backend.on_gpu():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check on "
                    "the card")
