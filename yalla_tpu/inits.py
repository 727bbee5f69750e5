"""Initial states (rebuild of ``include/inits.cuh``).

Host-side numpy generators fill the Solution's host mirror and push to
device; the ``relaxed_*`` variants then run a device-fused relaxation under
the built-in ReLU force (one ``lax.scan`` instead of the reference's ~3000
individual kernel-launch steps, ref inits.cuh:95-155).

Reproducibility upgrade over the reference (which seeds C ``rand()`` from
``std::random_device``): every generator takes an optional ``rng`` /
``seed``; by default a module-level ``numpy`` Generator is used.
"""
from __future__ import annotations

import math

import jax

import jax.numpy as jnp
import numpy as np

__all__ = [
    "set_seed", "relu_force",
    "random_disk", "random_sphere", "random_cuboid",
    "relaxed_sphere", "relaxed_cuboid",
    "regular_hexagon", "regular_rectangle",
]

_rng = np.random.default_rng()


def set_seed(seed):
    global _rng
    _rng = np.random.default_rng(seed)


def _get_rng(rng):
    return rng if rng is not None else _rng


def relu_force(Xi, r, dist, i, j):
    """Built-in repulsion/adhesion used for IC relaxation
    (ref inits.cuh:78-93)."""
    valid = (i != j) & (dist <= 1.0)
    F = jnp.maximum(0.8 - dist, 0) * 2.0 - jnp.maximum(dist - 0.8, 0)
    safe = jnp.where(dist > 0, dist * dist, 1.0)
    w = jnp.where(valid & (dist > 0), F * jax.lax.rsqrt(safe), 0.0)
    return Xi.replace(x=r.x * w, y=r.y * w, z=r.z * w,
                      **{f: jnp.zeros_like(dist) for f in Xi._fields[3:]})


def random_disk(dist_to_nb, points, n_0=0, rng=None):
    """Uniform disk in the y-z plane, radius from hexagonal packing
    (ref inits.cuh:14-31)."""
    rng = _get_rng(rng)
    assert n_0 < points.h_n
    n = points.h_n - n_0
    r_max = (n / 0.9069) ** 0.5 * dist_to_nb / 2
    r = r_max * rng.random(n) ** 0.5
    phi = rng.random(n) * 2 * math.pi
    points.h_X.x[n_0:points.h_n] = 0
    points.h_X.y[n_0:points.h_n] = r * np.sin(phi)
    points.h_X.z[n_0:points.h_n] = r * np.cos(phi)
    points.copy_to_device()


def random_sphere(dist_to_nb, points, n_0=0, rng=None):
    """Uniform ball, radius from 0.64 random sphere packing
    (ref inits.cuh:33-51)."""
    rng = _get_rng(rng)
    assert n_0 < points.h_n
    n = points.h_n - n_0
    r_max = (n / 0.64) ** (1.0 / 3) * dist_to_nb / 2
    r = r_max * rng.random(n) ** (1.0 / 3)
    theta = np.arccos(2.0 * rng.random(n) - 1)
    phi = rng.random(n) * 2 * math.pi
    points.h_X.x[n_0:points.h_n] = r * np.sin(theta) * np.cos(phi)
    points.h_X.y[n_0:points.h_n] = r * np.sin(theta) * np.sin(phi)
    points.h_X.z[n_0:points.h_n] = r * np.cos(theta)
    points.copy_to_device()


def random_cuboid(dist_to_nb, minimum, maximum, points, n_0=0, rng=None):
    """Uniform cuboid; sets the active count from the packing density
    (ref inits.cuh:53-75 -- note it assigns ``*h_n``!)."""
    rng = _get_rng(rng)
    mn = np.asarray(minimum, np.float64)
    mx = np.asarray(maximum, np.float64)
    dim = mx - mn
    cube_volume = float(np.prod(dim))
    sphere_volume = 4.0 / 3 * math.pi * (dist_to_nb / 2) ** 3
    n = int(cube_volume / sphere_volume * 0.64)
    assert n_0 + n < points.h_n
    points.h_n = n_0 + n
    u = rng.random((n, 3))
    points.h_X.x[n_0:points.h_n] = mn[0] + dim[0] * u[:, 0]
    points.h_X.y[n_0:points.h_n] = mn[1] + dim[1] * u[:, 1]
    points.h_X.z[n_0:points.h_n] = mn[2] + dim[2] * u[:, 2]
    points.copy_to_device()


def _relax(points, steps, dt=0.1):
    """Run the relu relaxation.  Relaxation sizes are small by design (the
    reference warns above 10-15k points, inits.cuh:110-112), so the
    all-pairs engine is both faster and kinder to the device than a
    2000-step scan of a neighbor-search engine.

    The scratch Solution is sized to the ACTIVE count, not the caller's
    capacity: growth models relax a few hundred seeds inside an n_max of
    10^5-10^6, and an all-pairs pass over the padded capacity would be
    ~n_pad^2 wasted lanes per step (enough to trip device watchdogs)."""
    from .solvers import Solution, TileEngine
    m = points.h_n
    if isinstance(points.engine, TileEngine) and points.n_pad <= 2 * m:
        points.take_steps(steps, dt, relu_force)
        return
    tmp = Solution(points.pt_type, max(m, 1), engine=TileEngine())
    for f in points.pt_type._fields:
        getattr(tmp.h_X, f)[:m] = getattr(points.h_X, f)[:m]
    tmp.h_n = m
    tmp.copy_to_device()
    tmp.take_steps(steps, dt, relu_force)
    h = tmp.copy_to_host()
    for f in points.pt_type._fields:
        getattr(points.h_X, f)[:m] = getattr(h, f)[:m]
    ov = np.asarray(
        [np.array(a[:m]) for a in tmp.d_old_v])  # [3, m]
    import jax.numpy as jnp
    from .dtypes import Float3
    pad = np.zeros((3, points.n_pad - m), np.float32)
    full = np.concatenate([ov, pad], axis=1)
    points.d_old_v = Float3(x=jnp.asarray(full[0]), y=jnp.asarray(full[1]),
                            z=jnp.asarray(full[2]))
    points.copy_to_device()


def _relax_steps_sphere(n):
    if n <= 100:
        return 500
    if n <= 1000:
        return 1000
    if n <= 6000:
        return 2000
    return 3000


def _relax_steps_cuboid(n):
    if n <= 3000:
        return 1000
    if n <= 12000:
        return 2000
    return 3000


def relaxed_sphere(dist_to_nb, points, n_0=0, rng=None):
    """Random ball relaxed under relu_force, then rescaled so the relaxed
    spacing 0.8 maps to ``dist_to_nb`` (ref inits.cuh:95-125)."""
    random_sphere(0.6, points, n_0, rng=rng)
    steps = _relax_steps_sphere(points.h_n)
    _relax(points, steps)
    points.copy_to_host()
    scale = dist_to_nb / 0.8
    points.h_X.x[:points.h_n] *= scale
    points.h_X.y[:points.h_n] *= scale
    points.h_X.z[:points.h_n] *= scale
    points.copy_to_device()


def relaxed_cuboid(dist_to_nb, minimum, maximum, points, n_0=0, rng=None):
    """Random cuboid relaxed under relu_force (ref inits.cuh:127-155)."""
    scale = dist_to_nb / 0.8
    mn = np.asarray(minimum, np.float64) / scale
    mx = np.asarray(maximum, np.float64) / scale
    random_cuboid(0.8, mn, mx, points, n_0, rng=rng)
    steps = _relax_steps_cuboid(points.h_n)
    _relax(points, steps)
    points.copy_to_host()
    points.h_X.x[:points.h_n] *= scale
    points.h_X.y[:points.h_n] *= scale
    points.h_X.z[:points.h_n] *= scale
    points.copy_to_device()


def regular_hexagon(dist_to_nb, points, n_0=0):
    """Concentric hexagonal rings in the x-y plane (ref inits.cuh:158-214)."""
    assert n_0 < points.h_n
    beta = math.pi / 3.0
    coords = [(0.0, 0.0)]
    i = 1
    while len(coords) < points.h_n - n_0:
        ring = []
        for j in range(6):
            angle = beta * j
            p = (-dist_to_nb * i * math.sin(angle),
                 dist_to_nb * i * math.cos(angle))
            ring.append(p)
            n_int = i - 1
            if n_int < 1:
                continue
            next_angle = beta * (j + 1)
            q = (-dist_to_nb * i * math.sin(next_angle),
                 dist_to_nb * i * math.cos(next_angle))
            v = (q[0] - p[0], q[1] - p[1])
            modulus = math.hypot(*v)
            v = (v[0] / modulus, v[1] / modulus)
            for k in range(1, n_int + 1):
                frac = modulus * (k / (n_int + 1))
                ring.append((p[0] + v[0] * frac, p[1] + v[1] * frac))
        coords.extend(ring)
        i += 1
    coords = coords[: points.h_n - n_0]
    arr = np.asarray(coords, np.float32)
    points.h_X.x[n_0:points.h_n] = arr[:, 0]
    points.h_X.y[n_0:points.h_n] = arr[:, 1]
    points.h_X.z[n_0:points.h_n] = 0.0
    points.copy_to_device()


def regular_rectangle(dist_to_nb, nx, points, n_0=0):
    """Hexagonally offset rows in the x-y plane (ref inits.cuh:216-247)."""
    assert n_0 < points.h_n
    n = points.h_n - n_0
    row_h = math.sqrt(dist_to_nb ** 2 - (dist_to_nb / 2) ** 2)
    xs, ys = [], []
    i = 0
    while len(xs) < n:
        off = dist_to_nb / 2 if i % 2 else 0.0
        for j in range(nx):
            xs.append(off + j * dist_to_nb)
            ys.append(i * row_h)
            if len(xs) == n:
                break
        i += 1
    points.h_X.x[n_0:points.h_n] = np.asarray(xs, np.float32)
    points.h_X.y[n_0:points.h_n] = np.asarray(ys, np.float32)
    points.h_X.z[n_0:points.h_n] = 0.0
    points.copy_to_device()
