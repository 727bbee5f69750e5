"""Port of the reference's polarity tests
(``tests/test_polarity.cu``): transform round trips,
known-value forces, great-circle relaxation, epithelial line equilibrium,
and migration force antisymmetry."""
import math

import jax
import jax.numpy as jnp
import numpy as np

from helpers import center_of_mass, isclose
from yalla_tpu import Po_cell, Polarity, Solution
from yalla_tpu.polarity import (bending_force,
                                bidirectional_polarization_force,
                                migration_force, orthonormal,
                                pol_dot_product, pol_to_float3, pt_to_pol)

rng = np.random.default_rng(7)


def test_transformations():
    # phi drawn in the documented range -pi <= phi <= pi (ref polarity.cuh:8)
    pol = Polarity(theta=float(np.arccos(2 * rng.random() - 1)),
                   phi=float(rng.random() * 2 * math.pi - math.pi))
    inverse = pt_to_pol(pol_to_float3(pol))
    assert isclose(pol.theta, float(inverse.theta)), "Inverse wrong in theta"
    assert isclose(pol.phi, float(inverse.phi)), "Inverse wrong in phi"


def test_polarization_force():
    i = Po_cell(0.601, 0.305, 0.320, 0.209, 0.295)
    j = Po_cell(0.762, 0.403, 0.121, 0.340, 0.431)
    dF = bidirectional_polarization_force(i, j)
    assert isclose(float(dF.x), 0)
    assert isclose(float(dF.y), 0)
    assert isclose(float(dF.z), 0)
    assert isclose(float(dF.theta), 0.126), "Polarization force wrong in theta"
    assert isclose(float(dF.phi), 0.215), "Polarization force wrong in phi"


def _pairwise_polarization(Xi, r, dist, i, j):
    """Cell 0 aligns to cell 1; cell 1 is frozen (ref test_polarity.cu:37-45)."""
    dF = bidirectional_polarization_force(Xi, Xi - r)
    m = jnp.where((i == j) | (i == 1), 0.0, 1.0)
    return jax.tree.map(lambda a: m * a, dF)


def test_polarization_great_circle():
    pts = Solution(Po_cell, 2, solver="tile")
    p_i = Polarity(math.pi / 2 + math.pi / 4 + 0.01, 0.5)
    p_f = Polarity(math.pi / 2 + math.pi / 4 + 0.01, math.pi)
    arc_if = math.acos(float(pol_dot_product(p_i, p_f)))

    pts.h_X.theta[0], pts.h_X.phi[0] = p_i.theta, p_i.phi
    pts.h_X.theta[1], pts.h_X.phi[1] = p_f.theta, p_f.phi
    pts.copy_to_device()

    for step in range(5000):
        pts.take_step(0.01, _pairwise_polarization)
        if step % 50 == 0:
            h = pts.copy_to_host()
            me = Polarity(float(h.theta[0]), float(h.phi[0]))
            arc_i0 = math.acos(np.clip(float(pol_dot_product(p_i, me)), -1, 1))
            arc_0f = math.acos(np.clip(float(pol_dot_product(me, p_f)), -1, 1))
            assert isclose(arc_i0 + arc_0f, arc_if), "Polarity off great circle"

    h = pts.copy_to_host()
    prod = float(pol_dot_product(Polarity(h.theta[0], h.phi[0]),
                                 Polarity(h.theta[1], h.phi[1])))
    assert isclose(abs(prod), 1), "Polarities not aligned"


def test_bending_force():
    i = Po_cell(0.935, 0.675, 0.649, 0.793, 0.073)
    j = Po_cell(0.566, 0.809, 0.533, 0.297, 0.658)
    r = i - j
    dist = math.sqrt(float(r.x) ** 2 + float(r.y) ** 2 + float(r.z) ** 2)
    dF = bending_force(i, r, dist)
    assert isclose(float(dF.x), 0.214), "Bending force wrong in x"
    assert isclose(float(dF.y), -0.971), "Bending force wrong in y"
    assert isclose(float(dF.z), -1.802), "Bending force wrong in z"
    assert isclose(float(dF.theta), -0.339), "Bending force wrong in theta"
    assert isclose(float(dF.phi), 0.453), "Bending force wrong in phi"


def _pw_bending(Xi, r, dist, i, j):
    """Spring + bending (ref test_polarity.cu:97-112)."""
    valid = (i != j) & (dist <= 1.0)
    safe = jnp.where(dist > 0, dist, 1.0)
    F = 2 * (0.6 - dist) * (1 - dist) + (1 - dist) ** 2
    w = jnp.where(valid, F / safe, 0.0)
    bend = bending_force(Xi, r, jnp.where(valid, dist, 1.0)) * 0.2
    dF = jax.tree.map(lambda a: jnp.where(valid, a, 0.0) * 1.0, bend)
    return dF.replace(x=dF.x + r.x * w, y=dF.y + r.y * w, z=dF.z + r.z * w)


def test_line_of_four():
    pts = Solution(Po_cell, 4, solver="tile")
    for i in range(4):
        pts.h_X.x[i] = 0.733333 * math.cos((i - 0.5) * math.pi / 3)
        pts.h_X.y[i] = 0.733333 * math.sin((i - 0.5) * math.pi / 3)
        pts.h_X.z[i] = 0
        pts.h_X.theta[i] = math.pi / 2
        pts.h_X.phi[i] = (i - 0.5) * math.pi / 3
    pts.copy_to_device()
    com_i = center_of_mass(pts)
    pts.take_steps(500, 0.5, _pw_bending)
    h = pts.copy_to_host()

    for i in range(1, 4):
        prod = float(pol_dot_product(Polarity(h.theta[0], h.phi[0]),
                                     Polarity(h.theta[i], h.phi[i])))
        assert isclose(prod, 1), "Epithelial polarity not aligned"

    r01 = (h.x[1] - h.x[0], h.y[1] - h.y[0], h.z[1] - h.z[0])
    r12 = (h.x[2] - h.x[1], h.y[2] - h.y[1], h.z[2] - h.z[1])
    r23 = (h.x[3] - h.x[2], h.y[3] - h.y[2], h.z[3] - h.z[2])
    for a, b in zip(r01, r12):
        assert isclose(a, b), "Cells not on a line"
    for a, b in zip(r12, r23):
        assert isclose(a, b), "Cells not on a line"

    com_f = center_of_mass(pts)
    assert all(isclose(a, b) for a, b in zip(com_i, com_f)), \
        "Momentum not conserved in line of four"


def test_orthonormal():
    from yalla_tpu.dtypes import Float3, dot_product
    r = Float3(*rng.random(3).astype(np.float32))
    p = Float3(*rng.random(3).astype(np.float32))
    norm = math.sqrt(float(dot_product(p, p)))
    p = p / norm
    n = orthonormal(r, p)
    assert isclose(float(dot_product(p, n)), 0), "Not orthogonal"
    assert isclose(float(dot_product(n, n)), 1), "Not normal"


def test_migration_force():
    Xi = Po_cell(0.0, 0.0, 0.0, math.pi / 2, 0.0)
    Xj = Po_cell(1.0, 1e-3, 0.0, 0.0, 0.0)
    Fi = migration_force(Xi, Xi - Xj, 1.0)
    assert isclose(float(Fi.x), 0.6), "Migration force wrong in x"
    assert isclose(float(Fi.y), -0.8), "Migration force wrong in y"
    assert abs(float(Fi.z)) < 5e-5, "Migration force wrong in z"

    Fj = migration_force(Xj, Xj - Xi, 1.0)
    assert isclose(float(Fi.x), -float(Fj.x)), "Migration not antisymmetric"
    assert isclose(float(Fi.y), -float(Fj.y)), "Migration not antisymmetric"
    assert isclose(float(Fi.z), -float(Fj.z)), "Migration not antisymmetric"
