"""Closed surface meshes for image-based models + Chamfer shape comparison.

Rebuild of ``include/mesh.cuh``: read VTK POLYDATA triangle
meshes, transform them (translate / rotate / rescale / grow_normally),
test point inclusion by ray-triangle parity, and quantify shape agreement
with the symmetric Chamfer distance (``shape_comparison``, the library's
fitness metric, ref mesh.cuh:58-88).

The reference's tiled min-distance kernel (ref mesh.cuh:27-56) becomes a
jitted, blocked elementwise ``|a - b|^2`` (exact in f32); host-side
geometry stays vectorized numpy.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Mesh", "shape_comparison", "shape_comparison_points_to_points"]


@jax.jit
def _min_dists(A, B, n2):
    """min_j |A_i - B_j| with B padded to n2 active rows.

    Blocked elementwise |a - b|^2 (exact in f32), streamed over A blocks by
    lax.map so only a [block, n2] tile is live -- the XLA analogue of the
    reference's TILE_SIZE shared-memory staging (ref mesh.cuh:27-56)."""
    n1 = A.shape[0]
    block = 256
    n_pad = -(-n1 // block) * block
    A_pad = jnp.pad(A, ((0, n_pad - n1), (0, 0)))
    pad_mask = jnp.arange(B.shape[0]) < n2

    def one_block(Ab):
        diff = Ab[:, None, :] - B[None, :, :]
        d2 = jnp.sum(diff * diff, axis=2)
        d2 = jnp.where(pad_mask[None, :], d2, jnp.inf)
        return jnp.sqrt(jnp.min(d2, axis=1))

    d = jax.lax.map(one_block, A_pad.reshape(n_pad // block, block, 3))
    return d.reshape(n_pad)[:n1]


def shape_comparison(xyz1, n1, xyz2, n2):
    """Symmetric Chamfer distance: mean nearest-point distance both ways
    (ref mesh.cuh:58-79)."""
    A = jnp.asarray(xyz1, jnp.float32)
    B = jnp.asarray(xyz2, jnp.float32)
    d12 = _min_dists(A, B, jnp.int32(n2))
    d21 = _min_dists(B, A, jnp.int32(n1))
    m1 = jnp.arange(A.shape[0]) < n1
    m2 = jnp.arange(B.shape[0]) < n2
    mean12 = jnp.sum(jnp.where(m1, d12, 0.0)) / n1
    mean21 = jnp.sum(jnp.where(m2, d21, 0.0)) / n2
    return float((mean12 + mean21) / 2)


def shape_comparison_points_to_points(points1, points2):
    h1, h2 = points1.copy_to_host(), points2.copy_to_host()
    a = np.stack([h1.x, h1.y, h1.z], 1)
    b = np.stack([h2.x, h2.y, h2.z], 1)
    return shape_comparison(a, points1.h_n, b, points2.h_n)


class Mesh:
    """Triangle mesh with transforms and inclusion tests
    (ref mesh.cuh:121-462)."""

    def __init__(self, file_name=None):
        self.vertices = np.zeros((0, 3), np.float64)
        self.triangles = np.zeros((0, 3), np.int64)  # vertex indices
        if file_name is not None:
            self._read_vtk(file_name)

    # -- I/O ------------------------------------------------------------------
    def _read_vtk(self, file_name):
        with open(file_name) as f:
            lines = f.read().splitlines()
        i = 0
        while not (lines[i].split() and lines[i].split()[0] == "POINTS"):
            i += 1
        n_vertices = int(lines[i].split()[1])
        i += 1
        vals = []
        while len(vals) < 3 * n_vertices:
            vals.extend(float(v) for v in lines[i].split())
            i += 1
        self.vertices = np.asarray(vals, np.float64).reshape(n_vertices, 3)

        while not (lines[i].split()
                   and lines[i].split()[0] in ("POLYGONS", "CELLS")):
            i += 1
        n_facets = int(lines[i].split()[1])
        assert n_facets % 2 == 0, "Mesh cannot be closed (ref mesh.cuh:190)"
        i += 1
        tris = []
        for k in range(n_facets):
            items = lines[i + k].split()
            tris.append((int(items[1]), int(items[2]), int(items[3])))
        self.triangles = np.asarray(tris, np.int64)

    def write_vtk(self, output_tag, output_dir="output/"):
        """Write facets as disconnected triangles (ref mesh.cuh:421-449)."""
        import os
        os.makedirs(output_dir, exist_ok=True)
        V = self.facet_vertices().reshape(-1, 3)
        nf = len(self.triangles)
        with open(f"{output_dir}{output_tag}.mesh.vtk", "w") as f:
            f.write("# vtk DataFile Version 3.0\n")
            f.write(f"{output_tag}.mesh\nASCII\nDATASET POLYDATA\n")
            f.write(f"\nPOINTS {3 * nf} float\n")
            np.savetxt(f, V, fmt="%.6g")
            f.write(f"\nPOLYGONS {nf} {4 * nf}\n")
            ids = np.arange(3 * nf).reshape(nf, 3)
            np.savetxt(f, np.hstack([np.full((nf, 1), 3), ids]), fmt="%d")

    # -- derived geometry ------------------------------------------------------
    def facet_vertices(self):
        """[n_facets, 3, 3]: the triangle corners."""
        return self.vertices[self.triangles]

    def facet_normals(self):
        V = self.facet_vertices()
        u = V[:, 1] - V[:, 0]
        v = V[:, 2] - V[:, 0]
        n = np.cross(u, v)
        return n / np.linalg.norm(n, axis=1, keepdims=True)

    def facet_centroids(self):
        return self.facet_vertices().mean(axis=1)

    def get_minimum(self):
        return self.vertices.min(axis=0)

    def get_maximum(self):
        return self.vertices.max(axis=0)

    # -- transforms (ref mesh.cuh:243-377) --------------------------------------
    def translate(self, offset):
        self.vertices = self.vertices + np.asarray(offset, np.float64)

    def rescale(self, factor):
        self.vertices = self.vertices * factor

    def rotate(self, around_z, around_y, around_x):
        """Sequential rotations about z, then y, then x (ref mesh.cuh:257-333;
        same axis conventions)."""
        cz, sz = math.cos(around_z), math.sin(around_z)
        cy, sy = math.cos(around_y), math.sin(around_y)
        cx, sx = math.cos(around_x), math.sin(around_x)
        V = self.vertices
        x, y = V[:, 0].copy(), V[:, 1].copy()
        V[:, 0] = x * cz - y * sz
        V[:, 1] = x * sz + y * cz
        x, z = V[:, 0].copy(), V[:, 2].copy()
        V[:, 0] = x * cy - z * sy
        V[:, 2] = x * sy + z * cy
        y, z = V[:, 1].copy(), V[:, 2].copy()
        V[:, 1] = y * cx - z * sx
        V[:, 2] = y * sx + z * cx

    def grow_normally(self, amount, boundary=False):
        """Displace each vertex by ``amount`` along its mean facet normal;
        optionally pin x == 0 boundary vertices (ref mesh.cuh:349-377)."""
        normals = self.facet_normals()
        avg = np.zeros_like(self.vertices)
        for corner in range(3):
            np.add.at(avg, self.triangles[:, corner], normals)
        d = np.linalg.norm(avg, axis=1, keepdims=True)
        step = avg * (amount / d)
        if boundary:
            step[self.vertices[:, 0] == 0.0] = 0.0
        self.vertices = self.vertices + step

    # -- inclusion test (ref mesh.cuh:379-419) ------------------------------------
    _RAY_DIR = np.array([0.22788, 0.38849, 0.81499])

    def test_exclusion(self, point):
        """True if ``point`` lies OUTSIDE the closed mesh (even number of
        ray-triangle intersections along a fixed direction)."""
        return bool(self.test_exclusion_many(np.asarray(point, np.float64)
                                             .reshape(1, 3))[0])

    def test_exclusion_many(self, points):
        """Vectorized parity test: [n, 3] points -> bool[n] (True = outside).

        Uses the native C++ kernel when available (O(1) memory, OpenMP
        over points); the numpy form below materializes a
        [points, facets] block, so large batches chunk through it."""
        P0 = np.asarray(points, np.float64)
        V = self.facet_vertices()
        from . import _native
        out = _native.test_exclusion(P0, V, self._RAY_DIR)
        if out is not None:
            return out
        block = max(1, 50_000_000 // max(len(V), 1))
        if len(P0) > block:
            return np.concatenate([
                self.test_exclusion_many(P0[i:i + block])
                for i in range(0, len(P0), block)])
        n = self.facet_normals()
        d = self._RAY_DIR

        # r = n.(V0 - P0) / n.d per (point, facet)
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
        return (hit.sum(axis=1) % 2) == 0

    # -- fitness metric -----------------------------------------------------------
    def shape_comparison_mesh_to_points(self, points):
        h = points.copy_to_host()
        pts = np.stack([h.x, h.y, h.z], 1)
        return shape_comparison(self.vertices, len(self.vertices),
                                pts, points.h_n)
