"""Shared test helpers, mirroring the reference's minunit fixture
(``tests/minunit.cuh``)."""
import numpy as np


def isclose(a, b):
    """The reference tolerance: atol 1e-6 + rtol 1e-2 (minunit.cuh:37)."""
    return np.all(np.abs(np.asarray(a) - np.asarray(b))
                  <= 1e-6 + 1e-2 * np.abs(np.asarray(b)))


def center_of_mass(points):
    """Mean position over active points (minunit.cuh:40-53)."""
    h = points.copy_to_host()
    n = points.h_n
    return (float(np.mean(h.x[:n])), float(np.mean(h.y[:n])),
            float(np.mean(h.z[:n])))
