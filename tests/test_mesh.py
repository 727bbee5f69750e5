"""Port of the reference's mesh tests (``tests/test_mesh.cu``):
transforms vs analytic bounds, torus inclusion vs analytic ring distance,
and Chamfer distance 0 / 0.1 after grow_normally(0.1).  Fixture:
``tests/torus.vtk`` (copied verbatim -- it is a data file)."""
import math
import os

import numpy as np

from helpers import isclose
from yalla_tpu import Float3, Solution
from yalla_tpu.inits import random_cuboid, set_seed
from yalla_tpu.mesh import Mesh

TORUS = os.path.join(os.path.dirname(__file__), "torus.vtk")
set_seed(5)


def test_transformations():
    mesh = Mesh(TORUS)
    mn, mx = mesh.get_minimum(), mesh.get_maximum()
    assert isclose(mn, [-1.5, -1.5, -0.5])
    assert isclose(mx, [1.5, 1.5, 0.5])

    mesh.translate((1, 0, 0))
    assert isclose(mesh.get_minimum(), [-0.5, -1.5, -0.5])
    assert isclose(mesh.get_maximum(), [2.5, 1.5, 0.5])
    mesh.translate((-1, 0, 0))

    mesh.rotate(0, math.pi / 2, 0)
    assert isclose(mesh.get_minimum(), [-0.5, -1.5, -1.5])
    assert isclose(mesh.get_maximum(), [0.5, 1.5, 1.5])
    mesh.rotate(0, -math.pi / 2, 0)

    mesh.rescale(2)
    assert isclose(mesh.get_minimum(), [-3, -3, -1])
    assert isclose(mesh.get_maximum(), [3, 3, 1])
    mesh.rescale(0.5)

    mesh.grow_normally(0.1)
    assert isclose(mesh.get_minimum(), [-1.6, -1.6, -0.6])
    assert isclose(mesh.get_maximum(), [1.6, 1.6, 0.6])


def test_exclusion():
    n_points = 500
    points = Solution(Float3, n_points, solver="grid")
    random_cuboid(0.35, (-1.5, -1.5, -0.5), (1.5, 1.5, 0.5), points)
    mesh = Mesh(TORUS)
    n = points.h_n
    pts = np.stack([points.h_X.x[:n], points.h_X.y[:n],
                    points.h_X.z[:n]], 1)
    out = mesh.test_exclusion_many(pts)
    dist_from_ring = np.sqrt(
        (1 - np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)) ** 2 + pts[:, 2] ** 2)
    sel = np.abs(dist_from_ring - 0.5) >= 0.01  # tolerance for mesh facets
    assert np.array_equal((dist_from_ring >= 0.5)[sel], out[sel]), \
        "Exclusion test wrong"


def test_shape_comparison():
    mesh = Mesh(TORUS)
    n = len(mesh.vertices)
    points = Solution(Float3, n, solver="grid")
    points.h_X.x[:n] = mesh.vertices[:, 0]
    points.h_X.y[:n] = mesh.vertices[:, 1]
    points.h_X.z[:n] = mesh.vertices[:, 2]
    points.copy_to_device()

    assert isclose(mesh.shape_comparison_mesh_to_points(points), 0.0), \
        "Shape comparison wrong"
    mesh.grow_normally(0.1)
    assert isclose(mesh.shape_comparison_mesh_to_points(points), 0.1), \
        "Grown shape comparison wrong"


def test_write_roundtrip(tmp_path):
    mesh = Mesh(TORUS)
    mesh.write_vtk("torus_copy", str(tmp_path) + "/")
    again = Mesh(str(tmp_path) + "/torus_copy.mesh.vtk")
    assert isclose(again.get_minimum(), mesh.get_minimum())
    assert isclose(again.get_maximum(), mesh.get_maximum())


def test_native_exclusion_matches_numpy():
    """The native C++ parity kernel agrees with the numpy form on the
    torus fixture (incl. points near facets and far outside)."""
    import os
    from yalla_tpu import _native
    mesh = Mesh(os.path.join(os.path.dirname(__file__), "torus.vtk"))
    rng = np.random.default_rng(9)
    pts = np.concatenate([
        rng.uniform(-2, 2, (500, 3)),
        mesh.vertices[:50] + rng.normal(0, 1e-3, (50, 3)),
        np.array([[10.0, 10.0, 10.0]]),
    ])
    native = _native.test_exclusion(pts, mesh.facet_vertices(),
                                    mesh._RAY_DIR)
    if native is None:  # no toolchain: nothing to compare
        return
    os.environ["YALLA_TPU_NATIVE"] = "1"
    # numpy path, forced (bypasses the native branch)
    P0 = np.asarray(pts, np.float64)
    V = mesh.facet_vertices()
    n = mesh.facet_normals()
    d = mesh._RAY_DIR
    num = np.einsum("fc,pfc->pf", n, V[None, :, 0] - P0[:, None])
    den = np.einsum("fc,c->f", n, d)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        r = num / den
    PI = P0[:, None, :] + d[None, None, :] * r[:, :, None]
    u = V[:, 1] - V[:, 0]
    v = V[:, 2] - V[:, 0]
    w = PI - V[None, :, 0]
    uu = np.einsum("fc,fc->f", u, u)[None]
    uv = np.einsum("fc,fc->f", u, v)[None]
    vv = np.einsum("fc,fc->f", v, v)[None]
    wu = np.einsum("pfc,fc->pf", w, u)
    wv = np.einsum("pfc,fc->pf", w, v)
    denom = uv * uv - uu * vv
    s = (uv * wv - vv * wu) / denom
    t = (uv * wu - uu * wv) / denom
    hit = ((r >= 0) & (s >= 0) & (s <= 1) & (t >= 0) & (s + t <= 1))
    ref = (hit.sum(axis=1) % 2) == 0
    agree = native == ref
    # jittered near-facet points may legitimately flip under different
    # summation order; the bulk must agree exactly
    assert agree[:500].all() and agree[-1]
    assert agree.mean() > 0.98
