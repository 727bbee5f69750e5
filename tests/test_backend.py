"""The one backend decision (yalla_tpu/backend.py), the engine choices
that follow from it, the compile-cache location, and the measurement
entry points refusing to run without a GPU."""
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from yalla_tpu import Float3, Solution, backend
from yalla_tpu.inits import random_sphere
from yalla_tpu.models import branching as B
from yalla_tpu.solvers import GridEngine, LatticeEngine, SweepEngine
from yalla_tpu.utils import cache, checks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def on_gpu(monkeypatch):
    """Make the backend module report a GPU (the engines ask it, so this
    is what a run on the card sees)."""
    monkeypatch.setattr(backend, "platform", lambda: "gpu")


def test_backend_on_the_cpu():
    assert backend.platform() == "cpu"
    assert not backend.on_gpu()
    info = backend.device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}
    with pytest.raises(RuntimeError, match="no GPU"):
        backend.require_gpu()


def test_backend_on_a_gpu(on_gpu):
    assert backend.on_gpu()
    backend.require_gpu()


def test_default_engine_off_the_gpu():
    """Without the kernel: the gather grid at small n_max, the dense XLA
    lattice (capacity planned for the division regime) above."""
    assert isinstance(B.default_engine(500, 4096), GridEngine)
    eng = B.default_engine(500_000, 500_000)
    assert isinstance(eng, LatticeEngine)
    assert eng.capacity >= 16


@pytest.mark.parametrize("n_max", [4096, 500_000])
def test_default_engine_off_the_gpu_is_xla_engine(n_max):
    """Off the card default_engine is xla_engine, which the 500k engine
    race calls directly."""
    assert B.default_engine(500, n_max) == B.xla_engine(n_max)
    assert (B.default_engine(500, n_max, extent=30.0, max_occ=12)
            == B.xla_engine(n_max, extent=30.0, max_occ=12))


@pytest.mark.parametrize("n_max", [4096, 500_000])
def test_default_engine_on_the_gpu(on_gpu, n_max):
    """On the card the sweep kernel serves every size, its grid covering
    the final tissue's extent plus the outgrowth margin."""
    eng = B.default_engine(500, n_max)
    assert isinstance(eng, SweepEngine) and not eng.interpret
    extent = n_max ** (1 / 3) * 0.8 / 2 + 4.0
    assert eng.grid_size * B.Params().r_max >= 2 * extent


def _ball(n_max, n):
    sol = Solution(Float3, n_max, solver="auto")
    sol.h_n = n
    random_sphere(0.8, sol, rng=np.random.default_rng(0))
    sol.copy_to_device()
    return sol


def test_auto_engine_choice(on_gpu):
    """Solution(solver="auto") above the all-pairs crossover takes the
    sweep kernel on the card, sized to the populated box plus margin."""
    sol = _ball(5000, 3000)
    eng = sol._auto_engine()
    assert isinstance(eng, SweepEngine)
    ext = max(float(np.max(np.abs(np.asarray(a)[:3000])))
              for a in (sol.d_X.x, sol.d_X.y, sol.d_X.z))
    assert eng.grid_size >= 2 * ext


def test_auto_engine_off_the_gpu():
    sol = _ball(5000, 3000)
    eng = sol._auto_engine()
    assert isinstance(eng, LatticeEngine)
    # capacity from the measured cube occupancy, with headroom
    h = [np.floor(np.asarray(a)[:3000]).astype(np.int64)
         for a in (sol.d_X.x, sol.d_X.y, sol.d_X.z)]
    occ = np.unique((h[0] * 4096 + h[1]) * 4096 + h[2],
                    return_counts=True)[1].max()
    assert eng.capacity >= occ + 1


def test_cache_dir_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = cache.cache_dir()
    assert d == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_settled_cache_round_trip(monkeypatch, tmp_path):
    """The settled-state cache restores what it stored, and refuses a
    state stored for another Cell layout."""
    monkeypatch.setattr(checks, "SETTLED_DIR", str(tmp_path))
    rng = np.random.default_rng(0)
    X = Float3(*(rng.random(64).astype(np.float32) for _ in range(3)))
    ov = Float3(*(rng.random(64).astype(np.float32) for _ in range(3)))
    assert checks.load_settled("t", 50, 0, Float3) is None
    checks.save_settled("t", 50, 0, X, ov)
    assert os.path.dirname(checks.settled_path("t", 50, 0)) == str(tmp_path)
    X2, ov2 = checks.load_settled("t", 50, 0, Float3)
    for a, b in zip(X + ov, X2 + ov2):
        assert np.array_equal(a, np.asarray(b))
    assert checks.load_settled("t", 50, 0, B.Cell) is None


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_measurement_scripts_refuse_the_cpu(script):
    """No GPU: non-zero exit, and no result line."""
    r = _run([script], REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout and '"value"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repository, the smoke test cannot import the
    system and fails without printing a result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
