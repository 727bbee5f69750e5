"""Teapot-scale mesh-exclusion benchmark (native C++ kernel).

The reference's largest mesh model fills a teapot with 70k points
(examples/teapot.cu:13) by rejection-sampling against
``Mesh::test_exclusion`` -- a per-point ray-parity test over every facet
(meix.cuh:303-325, single-threaded host code).  The rebuild's kernel is
native C++ with OpenMP over points and O(1) memory
(_native/vtkio_native.cpp: yt_test_exclusion); this benchmark measures it
at teapot scale and a 10x rung, reporting points/s and ray-triangle
tests/s.

Usage: python benchmarks/bench_mesh_exclusion.py [n_points]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 700_000
    from yalla_tpu.mesh import Mesh

    mesh = Mesh(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "teapot.vtk"))
    lo = np.asarray(mesh.get_minimum())
    hi = np.asarray(mesh.get_maximum())
    n_facets = len(mesh.triangles)

    rng = np.random.default_rng(0)
    for n_pts in (70_000, n):
        pts = rng.uniform(lo, hi, (n_pts, 3))
        # warm-up (thread pool spin-up, page faults)
        mesh.test_exclusion_many(pts[: min(n_pts, 8_192)])
        t0 = time.perf_counter()
        inside = mesh.test_exclusion_many(pts)
        dt = time.perf_counter() - t0
        rate = n_pts / dt
        print(f"n={n_pts}: {dt * 1e3:.1f} ms, {rate:.3g} points/s, "
              f"{rate * n_facets:.3g} ray-triangle tests/s "
              f"({int(inside.sum())} inside, {n_facets} facets)")


if __name__ == "__main__":
    main()
