"""Port of the reference's link tests (``tests/test_links.cu``):
a square of four relaxing under link springs, and custom link forces on a
non-positional field."""
import jax
import jax.numpy as jnp
import numpy as np

from helpers import center_of_mass, isclose
from yalla_tpu import Float3, Float4, Solution
from yalla_tpu.dtypes import pt_zeros_like
from yalla_tpu.links import Links, link_forces


def no_pw_int(Xi, r, dist, i, j):
    return jax.tree.map(lambda a: jnp.zeros_like(dist), Xi)


def test_square_of_four():
    pts = Solution(Float3, 4, solver="tile")
    links = Links(4)
    pts.h_X.x[:4] = [1, 1, -1, -1]
    pts.h_X.y[:4] = [1, -1, -1, 1]
    pts.h_X.z[:4] = 0
    pts.copy_to_device()
    links.h_a[:4] = [0, 1, 2, 3]
    links.h_b[:4] = [1, 2, 3, 0]
    links.copy_to_device()

    com_i = center_of_mass(pts)
    for _ in range(500):
        pts.take_step(0.1, no_pw_int, gen_forces=link_forces(links))
    h = pts.copy_to_host()
    com_f = center_of_mass(pts)
    assert all(isclose(a, b) for a, b in zip(com_i, com_f)), \
        "Momentum not conserved in square"
    assert isclose(h.x[0], h.x[1]), "Not close in x"
    assert isclose(h.y[1], h.y[2]), "Not close in y"
    assert isclose(h.z[2], h.z[3]), "Not close in z"


def custom_force(Xa, Xb, r, dist, strength):
    """Transfers w from a to b (ref test_links.cu custom_force)."""
    dFa = pt_zeros_like(Xa).replace(w=jnp.full_like(dist, -1.0))
    dFb = pt_zeros_like(Xb).replace(w=jnp.full_like(dist, 1.0))
    return dFa, dFb


def test_custom_force():
    pts = Solution(Float4, 2, solver="tile")
    links = Links(1)
    pts.h_X.x[:2] = [1, 1]
    pts.h_X.y[:2] = [1, -1]
    pts.h_X.z[:2] = 0
    pts.h_X.w[:2] = [1, -1]
    links.h_a[0], links.h_b[0] = 0, 1
    pts.copy_to_device()
    links.copy_to_device()

    dt = 0.1
    pts.take_step(dt, no_pw_int, gen_forces=link_forces(links))
    pts.take_step(dt, no_pw_int, gen_forces=link_forces(links, custom_force))
    h = pts.copy_to_host()
    assert isclose(h.x[0] - h.x[1], 0), "Wrong x"
    assert isclose(h.y[0] - h.y[1], 2 - 2 * dt * links.strength), "Wrong y"
    assert isclose(h.z[0] - h.z[1], 0), "Wrong z"
    assert isclose(h.w[0] - h.w[1], 2 - 2 * dt), "Wrong w"
