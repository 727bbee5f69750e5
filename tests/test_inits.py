"""Port of the reference's IC tests (``tests/test_inits.cu``):
relaxed spheres/cuboids reach equilibrium (mean step displacement < 5e-4)
with correct neighbour spacing and bounds.  Sizes are reduced vs the
reference's 5000 cells to keep the CPU test mesh fast; the physics contract
(equilibrium + spacing + bounds) is identical.
"""
import numpy as np

from yalla_tpu import Float3, Solution
from yalla_tpu.inits import (random_cuboid, relaxed_cuboid, relaxed_sphere,
                             set_seed)

set_seed(987)


def _mean_step_displacement(points, dt=0.1):
    from yalla_tpu.inits import relu_force
    before = np.stack([points.h_X.x.copy(), points.h_X.y.copy(),
                       points.h_X.z.copy()])
    points.take_step(dt, relu_force)
    h = points.copy_to_host()
    after = np.stack([h.x, h.y, h.z])
    n = points.h_n
    return float(np.mean(np.linalg.norm(
        (after - before)[:, :n], axis=0)))


def _mean_dist_to_nbs(points, cut_off=1.0, rnd_cell=17):
    h = points.h_X
    n = points.h_n
    d = np.sqrt((h.x[rnd_cell] - h.x[:n]) ** 2
                + (h.y[rnd_cell] - h.y[:n]) ** 2
                + (h.z[rnd_cell] - h.z[:n]) ** 2)
    sel = (d < cut_off) & (np.arange(n) != rnd_cell)
    return float(d[sel].mean())


def test_relaxed_sphere():
    r_mean = 0.8
    points = Solution(Float3, 800, solver="grid")
    relaxed_sphere(r_mean, points)
    points.copy_to_host()
    diff = _mean_step_displacement(points)
    assert diff < 5e-4, f"Sphere not relaxed: {diff}"
    mean_dist = _mean_dist_to_nbs(points)
    assert r_mean - 0.05 < mean_dist < r_mean + 0.05, \
        f"Sphere mean dist to neighbours wrong: {mean_dist}"


def test_relaxed_cuboid_dimensions():
    r_mean = 0.8
    points = Solution(Float3, 1000, solver="grid")
    relaxed_cuboid(r_mean, (0, 0, 0), (6, 6, 6), points)
    points.copy_to_host()
    diff = _mean_step_displacement(points)
    assert diff < 5e-4, f"Cuboid not relaxed: {diff}"
    mean_dist = _mean_dist_to_nbs(points)
    assert r_mean - 0.05 < mean_dist < r_mean + 0.05, \
        f"Cuboid mean dist to neighbours wrong: {mean_dist}"

    h = points.h_X
    n = points.h_n
    mins = [h.x[:n].min(), h.y[:n].min(), h.z[:n].min()]
    maxs = [h.x[:n].max(), h.y[:n].max(), h.z[:n].max()]
    for m in mins:
        assert -r_mean * 2 < m < 0, f"Cuboid bounds wrong: min {m}"
    for m in maxs:
        assert 6 < m < 6 + r_mean * 2, f"Cuboid bounds wrong: max {m}"


def test_random_cuboid_sets_n():
    """random_cuboid derives the active count from the density
    (ref inits.cuh:62-65)."""
    points = Solution(Float3, 2000, solver="grid")
    random_cuboid(0.8, (0, 0, 0), (6, 6, 6), points)
    import math
    expected = int(6 ** 3 / (4 / 3 * math.pi * 0.4 ** 3) * 0.64)
    assert points.h_n == expected
    h = points.h_X
    assert h.x[:points.h_n].min() >= 0 and h.x[:points.h_n].max() <= 6
