"""central_force declarations (ops/common.py).

The central declaration must satisfy the generic pairwise contract on
every engine -- same numbers as a handwritten force on the all-pairs
engine, and the same sums on the sweep kernel.  Physics fixture: the reference's differential-adhesion sorting force
(examples/sorting.cu:16-28) whose type-pair strength table is exactly
bilinear in the two type bits.
"""
import jax
import jax.numpy as jnp
import numpy as np

from helpers import isclose
from yalla_tpu.dtypes import Float3, make_pt
from yalla_tpu.ops.common import central_force, friction_w_neighbour
from yalla_tpu.ops.pairwise_xla import tile_pairwise
from yalla_tpu.solvers import SweepEngine, TileEngine, heun_steps

Cell = make_pt("CentralCell", "ctype")
R_MAX, R_MIN = 1.0, 0.5


def handwritten_adhesion(Xi, r, dist, i, j):
    """ref sorting.cu:16-28, as bench.py writes it by hand."""
    near = (i != j) & (dist < R_MAX)
    same = r.ctype == 0.0
    strength = jnp.where(same, jnp.where(Xi.ctype > 0.5, 9.0, 1.0), 3.0)
    F = 2 * (R_MIN - dist) * (R_MAX - dist) + (R_MAX - dist) ** 2
    pos_ = dist > 0
    inv = jnp.where(pos_, 1.0 / jnp.where(pos_, dist, 1.0), 0.0)
    w = jnp.where(near, strength * F * inv, 0.0)
    zero = jnp.zeros_like(dist)
    return Cell(x=r.x * w, y=r.y * w, z=r.z * w, ctype=zero)


def central_adhesion(aux=None, diag=None):
    """Same physics in central form.  strength(t_i, t_j) on the binary
    type bits is {same 0: 1, same 1: 9, mixed: 3} = 1 + 2 t_i + 2 t_j
    + 4 t_i t_j -- exactly bilinear in the type bits."""
    def coef(dist, Si, Sj, strength):
        a = jnp.maximum(R_MAX - dist, 0.0)       # 0 past the cutoff
        b = a + 2.0 * (R_MIN - dist)
        rs = jax.lax.rsqrt(jnp.maximum(dist * dist, 1e-12))
        return strength * (a * b) * rs

    return central_force(
        Cell, coef,
        bilinear={"strength": (
            lambda X: (jnp.ones_like(X.ctype), 2.0 * X.ctype),
            lambda X: (1.0 + 2.0 * X.ctype, 1.0 + 2.0 * X.ctype))},
        aux=aux, diag=diag)


def _ball(n, n_pad, seed=3):
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_pad]
    pos = (g - side / 2) * 0.8 + rng.uniform(-0.2, 0.2, (len(g), 3))
    pos = np.concatenate([pos, np.zeros((max(0, n_pad - len(pos)), 3))])
    return Cell(x=jnp.asarray(pos[:n_pad, 0], jnp.float32),
                y=jnp.asarray(pos[:n_pad, 1], jnp.float32),
                z=jnp.asarray(pos[:n_pad, 2], jnp.float32),
                ctype=jnp.asarray((rng.random(n_pad) < 0.5)
                                  .astype(np.float32)))


def test_central_wrapper_matches_handwritten():
    """The generic-form evaluation of a central_force is the same
    physics as the handwritten functor, on the generic tile engine."""
    n, n_pad = 200, 256
    X = _ball(n, n_pad)
    ov = Float3(x=X.x * 0.01, y=X.y * -0.02, z=X.z * 0.005)
    a = tile_pairwise(handwritten_adhesion, friction_w_neighbour, X, ov,
                      jnp.int32(n))
    b = tile_pairwise(central_adhesion(), friction_w_neighbour, X, ov,
                      jnp.int32(n))
    for f in ("x", "y", "z"):
        assert isclose(np.asarray(getattr(a[0], f))[:n],
                       np.asarray(getattr(b[0], f))[:n]), f
    assert isclose(np.asarray(a[1])[:n], np.asarray(b[1])[:n])


def test_central_aux_and_diag_on_sweep_kernel():
    """A central force with an aux counter and an i == j reaction term
    (ref turing.cu:38-46 idiom, through ``diag``) gives the same sums on
    the sweep kernel (interpret mode) as on the all-pairs engine."""
    n, n_pad = 300, 384
    X = _ball(n, n_pad)
    ov = Float3(x=X.x * 0.01, y=X.y * -0.02, z=X.z * 0.005)
    diag = lambda Xi: Cell(x=jnp.zeros_like(Xi.x), y=jnp.zeros_like(Xi.x),
                           z=jnp.zeros_like(Xi.x),
                           ctype=0.1 * (1.0 - Xi.ctype))
    cf = central_adhesion(
        aux={"nbs": lambda dist, Si, Sj, strength:
             (dist < R_MAX).astype(jnp.float32)}, diag=diag)
    gen = tile_pairwise(cf, friction_w_neighbour, X, ov, jnp.int32(n))
    swp = SweepEngine(grid_size=16, interpret=True).pairwise(
        cf, friction_w_neighbour, X, ov, jnp.int32(n), jnp.float32(R_MAX))
    for f in Cell._fields:
        assert isclose(np.asarray(getattr(gen[0], f))[:n],
                       np.asarray(getattr(swp[0], f))[:n]), f"F.{f}"
    assert np.array_equal(np.asarray(gen[1])[:n], np.asarray(swp[1])[:n])
    for c in range(3):
        assert isclose(np.asarray(gen[2][c])[:n],
                       np.asarray(swp[2][c])[:n]), f"sum_v[{c}]"
    assert np.array_equal(np.asarray(gen[3]["nbs"])[:n],
                          np.asarray(swp[3]["nbs"])[:n]), "aux nbs"


def test_central_heun_trajectory():
    """A short Heun integration of the central declaration tracks the
    handwritten functor on the all-pairs engine."""
    n, n_pad = 200, 256
    X = _ball(n, n_pad)
    ov = Float3.zeros(n_pad)
    rest = (friction_w_neighbour, None, "com", X, ov, jnp.int32(n),
            jnp.float32(0.05), jnp.float32(1.0), jnp.int32(0), None)
    Xa, _, aux_a = heun_steps(4, TileEngine(), handwritten_adhesion, *rest)
    Xb, _, aux_b = heun_steps(4, TileEngine(), central_adhesion(), *rest)
    for f in ("x", "y", "z"):
        assert isclose(np.asarray(getattr(Xa, f))[:n],
                       np.asarray(getattr(Xb, f))[:n]), f
    assert not bool(aux_b["__err_non_finite"])
