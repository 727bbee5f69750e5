"""Settled states and pair-pass comparisons shared by the measurement
scripts (``chip_smoke.py``, ``bench.py``, ``benchmarks/race_500k.py``)
and the tests.

* The settled-state cache: relaxed tissues stored as ``.npz`` under
  ``.bench_cache/`` in the checkout (the 500k flagship state is
  committed), so a run skips the settle phases.
* The flagship at size: :func:`settled_flagship` (the settled 500k-cell
  branching state) and :func:`flagship_state` (the model state around
  it, with room for a few frames of divisions).
* :func:`pair_pass` / :func:`compare_pairwise`: one engine's pair pass of
  the flagship force, and the check that two engines' pair passes agree.
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SETTLED_DIR", "settled_path", "save_settled", "load_settled",
           "N_FLAGSHIP", "N_PAD_FRAMES", "PAIR_TOL", "settled_flagship",
           "flagship_state", "pair_pass", "sub_ball", "extent",
           "compare_pairwise"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SETTLED_DIR = os.path.join(_REPO, ".bench_cache")
# bump when the settle recipe / IC / force physics changes: a cached
# settled state is only valid for the regime it was settled under
SETTLE_VER = 1

N_FLAGSHIP = 500_000
# the settled state is padded to 503,808 slots; the frames' divisions
# need room, or they are lost (measured on the card: +66k cells in the
# first frame from the settled state, +43k in the second)
N_PAD_FRAMES = 786_432
# float32 pair sums taken in another order (sorted sweep vs binned gather
# vs all-pairs scan): max |a - b| over a channel, relative to max |ref|
PAIR_TOL = 1e-5


def settled_path(tag, n_cells, seed):
    return os.path.join(
        SETTLED_DIR, f"settled_{tag}_{n_cells}_s{seed}_v{SETTLE_VER}.npz")


def save_settled(tag, n_cells, seed, X, old_v):
    """Persist a settled (X, old_v) pytree so re-runs skip the settle
    phases -- the single biggest cost of a cold bench run."""
    os.makedirs(SETTLED_DIR, exist_ok=True)
    data = {"__cell_fields": np.array(list(type(X)._fields))}
    for fld in type(X)._fields:
        data["X_" + fld] = np.asarray(getattr(X, fld))
    for fld in type(old_v)._fields:
        data["V_" + fld] = np.asarray(getattr(old_v, fld))
    path = settled_path(tag, n_cells, seed)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **data)
    os.replace(tmp, path)
    print(f"# settled state cached: {os.path.relpath(path, _REPO)} "
          f"({os.path.getsize(path) // 1024} KiB)", file=sys.stderr)


def load_settled(tag, n_cells, seed, cell_cls):
    """Restore a cached settled state, or None.  The pytree layout must
    match the caller's Cell class exactly (field-name check)."""
    from ..dtypes import Float3
    path = settled_path(tag, n_cells, seed)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as d:
            if list(d["__cell_fields"]) != list(cell_cls._fields):
                print(f"# settled cache {path}: field mismatch, ignoring",
                      file=sys.stderr)
                return None
            X = cell_cls(**{f: jnp.asarray(d["X_" + f])
                            for f in cell_cls._fields})
            old_v = Float3(**{f: jnp.asarray(d["V_" + f])
                              for f in Float3._fields})
    except Exception as e:  # a corrupt cache is re-settled, not fatal
        print(f"# settled cache unreadable ({e}); re-settling",
              file=sys.stderr)
        return None
    print(f"# settled state loaded from cache: "
          f"{os.path.relpath(path, _REPO)}", file=sys.stderr)
    return X, old_v


def settled_flagship():
    """The committed settled 500k-cell branching state: (X, old_v, n)."""
    from ..models import branching as B
    got = load_settled("branching", N_FLAGSHIP, 0, B.Cell)
    if got is None:
        raise RuntimeError("settled 500k state missing from .bench_cache/")
    X, old_v = got
    return X, old_v, jnp.int32(N_FLAGSHIP)


def flagship_state(X, old_v, n):
    """Model state around the settled cells, re-padded to
    ``N_PAD_FRAMES`` slots so that frames can divide cells."""
    from ..growth import lineage_init
    from ..models import branching as B
    n_pad = X.x.shape[0]
    state = B.State(X=X, old_v=old_v, n=n,
                    lineage=lineage_init(2 * N_PAD_FRAMES, n_pad, int(n)),
                    epi_nbs=jnp.zeros(n_pad), mes_nbs=jnp.zeros(n_pad),
                    key=jax.random.PRNGKey(0))
    return B.repad_state(state, N_PAD_FRAMES)


def pair_pass(engine, X, old_v, n):
    """Jitted pair pass of the flagship force through ``engine`` on the
    augmented state (the polarity precompute rides along, as in a step)."""
    from ..models import branching as B
    from ..ops.common import friction_w_neighbour
    from ..solvers import augment
    force = B.make_force(B.Params())

    def fn(X, old_v, n):
        Xa = augment(X, n, B.precompute)
        return engine.pairwise(force, friction_w_neighbour, Xa, old_v, n,
                               jnp.float32(B.Params().r_max))

    return jax.jit(fn)


def sub_ball(X, old_v, n, n_keep):
    """The ``n_keep`` active cells closest to the origin, padded to a
    multiple of 128 (a compact piece of the same tissue)."""
    from ..dtypes import Float3
    r2 = sum(np.asarray(a)[:int(n)] ** 2 for a in (X.x, X.y, X.z))
    keep = np.argsort(r2, kind="stable")[:n_keep]
    n_pad = -(-n_keep // 128) * 128
    take = lambda a: jnp.asarray(np.pad(np.asarray(a)[keep],
                                        (0, n_pad - n_keep)))
    return (type(X)(*[take(a) for a in X]),
            Float3(*[take(a) for a in old_v]), jnp.int32(n_keep))


def extent(X, n):
    """Largest |coordinate| of the first ``n`` points."""
    return max(float(np.max(np.abs(np.asarray(a)[:n])))
               for a in (X.x, X.y, X.z))


def compare_pairwise(out, ref, n, tol=PAIR_TOL):
    """Worst relative error of an engine's pair-pass output against a
    reference engine's, over the first ``n`` points.

    Float channels (force leaves, friction-weighted velocity sums, aux
    sums) must agree to ``max|a - b| <= tol * max|ref|``; the neighbour
    counters (``sum_friction`` with ``friction_w_neighbour`` counts
    neighbours, the ``*_nbs`` aux channels) must agree exactly; every
    ``__err_*`` flag of either side must be clear.  Raises
    ``AssertionError`` with the offending channel; returns the worst
    relative error of the float channels."""
    F, sum_f, sum_v, aux = out
    rF, rsum_f, rsum_v, raux = ref
    pairs = [(f"F.{k}", getattr(F, k), getattr(rF, k)) for k in F._fields]
    pairs += [(f"sum_v{k}", a, b) for k, (a, b) in
              enumerate(zip(sum_v, rsum_v))]
    exact = [("sum_friction", sum_f, rsum_f)]
    for k in raux:
        if k.startswith("__err_"):
            continue
        (exact if k.endswith("_nbs") else pairs).append(
            (f"aux.{k}", aux[k], raux[k]))
    for side in (aux, raux):
        for k, v in side.items():
            if k.startswith("__err_"):
                assert not np.any(np.asarray(v)), f"flag {k} raised"
    worst = 0.0
    for name, a, b in pairs:
        a, b = np.asarray(a)[:n], np.asarray(b)[:n]
        assert np.all(np.isfinite(a)), f"{name}: non-finite"
        scale = float(np.max(np.abs(b))) if b.size else 0.0
        err = float(np.max(np.abs(a - b))) if b.size else 0.0
        rel = err / scale if scale > 0 else err
        assert rel <= tol, f"{name}: max|d|/max|ref| = {rel:.3g} > {tol}"
        worst = max(worst, rel)
    for name, a, b in exact:
        a, b = np.asarray(a)[:n], np.asarray(b)[:n]
        assert np.array_equal(a, b), \
            f"{name}: counters differ at {int(np.sum(a != b))} points"
    return worst
