"""Polarity: forces for polarization, epithelial sheets, and migration.

Rebuild of ``include/polarity.cuh``.  Polarity is
a unit vector p in spherical coordinates, 0 <= theta < pi, -pi <= phi <= pi,
stored as two extra Pt fields.  All forces are analytic gradients of pair
potentials and are written as elementwise jnp functions, so they compose
directly inside any pairwise engine (arguments may be scalars or pair
blocks).

The reference selects which (theta, phi) pair to act on via member-pointer
template parameters -- supporting a second polarity axis per cell (PCP,
``examples/epithelia_double_polarity.cu:53``).  Here the same is done with
the ``axis=('theta', 'phi')`` keyword naming the Pt fields.

The spherical-coordinate integration (including the |sin theta| > 1e-10
gimbal guard, ref polarity.cuh:57) is part of the physics contract; do not
"upgrade" to quaternions or the great-circle relaxation statistics change.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .dtypes import Float3, Polarity, pt_zeros_like

__all__ = [
    "pol_to_float3", "pt_to_pol", "pol_dot_product",
    "unidirectional_polarization_force", "bidirectional_polarization_force",
    "bending_force", "apical_constriction_force",
    "orthonormal", "migration_force",
    "polarity_precompute", "polarity_precompute3",
    "bending_force_fast", "apical_constriction_force_fast",
    "migration_force_fast", "bending_force_cart", "bending_post_pair",
]

DEFAULT_AXIS = ("theta", "phi")


def _angles(p, axis):
    return getattr(p, axis[0]), getattr(p, axis[1])


def pol_to_float3(p, axis=DEFAULT_AXIS):
    """Spherical -> Cartesian unit vector (ref polarity.cuh:13-21)."""
    th, ph = _angles(p, axis)
    return Float3(x=jnp.sin(th) * jnp.cos(ph),
                  y=jnp.sin(th) * jnp.sin(ph),
                  z=jnp.cos(th))


def pt_to_pol(r, dist=None):
    """Cartesian -> spherical (ref polarity.cuh:23-39).

    The cosine is clamped to [-1, 1]: for real inputs |r.z| <= dist always
    (identical result), but our engines evaluate masked-out pair lanes the
    reference never runs (e.g. dist substituted by 1.0 beyond the cutoff),
    and an out-of-domain arccos there poisons the whole per-cell sum
    through NaN * 0 = NaN."""
    if dist is None:
        dist = jnp.sqrt(r.x * r.x + r.y * r.y + r.z * r.z)
    return Polarity(theta=jnp.arccos(jnp.clip(r.z / dist, -1.0, 1.0)),
                    phi=jnp.arctan2(r.y, r.x))


def pol_dot_product(a, p, axis=DEFAULT_AXIS, p_axis=DEFAULT_AXIS):
    """p_a . p_p for two spherical polarities (ref polarity.cuh:41-46)."""
    ath, aph = _angles(a, axis)
    pth, pph = _angles(p, p_axis)
    return (jnp.sin(ath) * jnp.sin(pth) * jnp.cos(aph - pph)
            + jnp.cos(ath) * jnp.cos(pth))


def unidirectional_polarization_force(Xi, p, axis=DEFAULT_AXIS):
    """dU/d(theta,phi) of U = -p_i . p (ref polarity.cuh:48-60).

    Returns a Pt of Xi's type with only the axis fields nonzero.
    """
    th, ph = _angles(Xi, axis)
    pth, pph = p.theta, p.phi  # p is a Polarity (or anything with theta/phi)
    d_theta = (jnp.cos(th) * jnp.sin(pth) * jnp.cos(ph - pph)
               - jnp.sin(th) * jnp.cos(pth))
    sin_th = jnp.sin(th)
    # Gimbal guard at the poles (ref polarity.cuh:56-58)
    safe = jnp.abs(sin_th) > 1e-10
    d_phi = jnp.where(
        safe,
        -jnp.sin(pth) * jnp.sin(ph - pph) / jnp.where(safe, sin_th, 1.0),
        0.0)
    dF = pt_zeros_like(Xi)
    return dF.replace(**{axis[0]: d_theta, axis[1]: d_phi})


def bidirectional_polarization_force(Xi, p, axis=DEFAULT_AXIS):
    """Gradient of U = -(p_i . p)^2 / 2: nematic alignment
    (ref polarity.cuh:62-69)."""
    prod = pol_dot_product(Xi, p, axis=axis)
    return prod * unidirectional_polarization_force(Xi, p, axis=axis)


def bending_force(Xi, r, dist, axis=DEFAULT_AXIS):
    """Resistance to bending: U = sum (p_i . r_ij / r)^2 / 2, including the
    reverse j-term; returns positional xyz and angular components
    (ref polarity.cuh:72-94)."""
    pi = pol_to_float3(Xi, axis)
    prodi = (pi.x * r.x + pi.y * r.y + pi.z * r.z) / dist
    r_hat = pt_to_pol(r, dist)
    dF = (-prodi) * unidirectional_polarization_force(Xi, r_hat, axis=axis)

    d2 = dist * dist
    fx = -prodi / dist * pi.x + prodi * prodi / d2 * r.x
    fy = -prodi / dist * pi.y + prodi * prodi / d2 * r.y
    fz = -prodi / dist * pi.z + prodi * prodi / d2 * r.z

    # Contribution from (p_j . r_ji / r)^2 / 2; Xj angles = Xi - r
    # (ref polarity.cuh:85-91)
    th, ph = _angles(Xi, axis)
    rth, rph = _angles(r, axis)
    pj = pol_to_float3(Polarity(th - rth, ph - rph))
    prodj = (pj.x * r.x + pj.y * r.y + pj.z * r.z) / dist
    fx = fx - prodj / dist * pj.x + prodj * prodj / d2 * r.x
    fy = fy - prodj / dist * pj.y + prodj * prodj / d2 * r.y
    fz = fz - prodj / dist * pj.z + prodj * prodj / d2 * r.z

    return dF.replace(x=fx, y=fy, z=fz)


def apical_constriction_force(Xi, r, dist, pref_angle, axis=DEFAULT_AXIS):
    """Bending with preferred angle != 90 deg: wedge-shaped cells;
    pref_angle = pi/2 gives a flat epithelium (ref polarity.cuh:96-121)."""
    cos_pref = jnp.cos(pref_angle)
    pi = pol_to_float3(Xi, axis)
    prodi = (pi.x * r.x + pi.y * r.y + pi.z * r.z) / dist + cos_pref
    r_hat = pt_to_pol(r, dist)
    dF = (-prodi) * unidirectional_polarization_force(Xi, r_hat, axis=axis)

    d2 = dist * dist
    fx = -prodi / dist * pi.x + prodi * prodi / d2 * r.x
    fy = -prodi / dist * pi.y + prodi * prodi / d2 * r.y
    fz = -prodi / dist * pi.z + prodi * prodi / d2 * r.z

    th, ph = _angles(Xi, axis)
    rth, rph = _angles(r, axis)
    pj = pol_to_float3(Polarity(th - rth, ph - rph))
    prodj = (pj.x * r.x + pj.y * r.y + pj.z * r.z) / dist - cos_pref
    fx = fx - prodj / dist * pj.x + prodj * prodj / d2 * r.x
    fy = fy - prodj / dist * pj.y + prodj * prodj / d2 * r.y
    fz = fz - prodj / dist * pj.z + prodj * prodj / d2 * r.z

    return dF.replace(x=fx, y=fy, z=fz)


# ---------------------------------------------------------------------------
# Cartesian fast path: trig per POINT instead of per PAIR.
#
# Every angular force above is an analytic function of the per-point polarity
# vector p_i = (sin t cos f, sin t sin f, cos t) and r-hat.  Precomputing p_i
# once per cell (``polarity_precompute``) turns the per-pair evaluation into
# pure arithmetic -- identical math, ~20x fewer transcendentals in the hot
# loop.
# ---------------------------------------------------------------------------

def polarity_precompute(X, n, axis=DEFAULT_AXIS, prefix="p"):
    """Per-cell polarity trig as derived fields
    {px, py, pz, pcf, psf, pst, psg}: the unit vector, cos(phi) / sin(phi),
    *signed* sin(theta) (matching the reference's division by the signed
    value near the poles, polarity.cuh:56-58), and the gimbal-guarded
    reciprocal 1/sin(theta) (zero at the poles) so the pair pass divides
    nowhere.

    Use as the ``precompute`` hook of the solvers; the fields flow through
    Xi / Xj / r in any engine.  Only the unit vector is ever read on the
    j side, so engines with i-only channel analysis carry the other four
    for free.
    """
    th, ph = _angles(X, axis)
    cf, sf = jnp.cos(ph), jnp.sin(ph)
    st = jnp.sin(th)
    safe = jnp.abs(st) > 1e-10
    sg = jnp.where(safe, 1.0 / jnp.where(safe, st, 1.0), 0.0)
    return {prefix + "x": st * cf, prefix + "y": st * sf,
            prefix + "z": jnp.cos(th), prefix + "cf": cf, prefix + "sf": sf,
            prefix + "st": st, prefix + "sg": sg}


def polarity_precompute3(X, n, axis=DEFAULT_AXIS, prefix="p"):
    """Compact variant of ``polarity_precompute``: only the unit vector
    {px, py, pz}.  ``bending_force_fast`` then derives cos(phi)/sin(phi)/
    sin(theta) per pair from the vector -- 3 fewer channels through the
    engines (~20% less pair-pass bandwidth for the flagship model).
    Deviates from the reference only for cells at theta == pi exactly,
    where the reference divides by the f32 rounding artifact
    sin(pi) ~= -8.7e-8 with its sign; here |sin theta| is used.
    """
    th, ph = _angles(X, axis)
    st = jnp.sin(th)
    return {prefix + "x": st * jnp.cos(ph), prefix + "y": st * jnp.sin(ph),
            prefix + "z": jnp.cos(th)}


def _trig_of(Xi, p):
    """(st, cf, sf, inv_st) from precomputed channels, or derived from the
    unit vector (compact ``polarity_precompute3`` mode).  ``inv_st`` is the
    gimbal-guarded 1/sin(theta) (zero at the poles, polarity.cuh:56-58)."""
    pxi, pyi = getattr(Xi, p + "x"), getattr(Xi, p + "y")
    if hasattr(Xi, p + "st"):
        st = getattr(Xi, p + "st")
        cf = getattr(Xi, p + "cf")
        sf = getattr(Xi, p + "sf")
        if hasattr(Xi, p + "sg"):
            inv_st = getattr(Xi, p + "sg")
        else:
            safe = jnp.abs(st) > 1e-10
            inv_st = jnp.where(safe, 1.0 / jnp.where(safe, st, 1.0), 0.0)
    else:  # compact precompute: derive per-pair from the vector
        st = jnp.sqrt(pxi * pxi + pyi * pyi)   # |sin theta|
        safe = st > 1e-10
        inv_st = jnp.where(safe, 1.0 / jnp.where(safe, st, 1.0), 0.0)
        cf = jnp.where(safe, pxi * inv_st, 1.0)
        sf = pyi * inv_st
    return st, cf, sf, inv_st


def _unidir_from_vec(pz, st, cf, sf, inv_st, rx, ry, rz, inv):
    """unidirectional_polarization_force(Xi, r_hat) from the precomputed
    per-point trig, in reciprocal form (``inv`` = 1/dist):
    d_theta = (cos t (cf rx + sf ry) - sin t rz) / d,
    d_phi = (cf ry - sf rx) / (d sin t); ``inv_st`` carries the reference's
    |sin theta| > 1e-10 gimbal guard (polarity.cuh:56-58) as a zero."""
    d_theta = (pz * (cf * rx + sf * ry) - st * rz) * inv
    d_phi = (cf * ry - sf * rx) * inv * inv_st
    return d_theta, d_phi


def bending_force_fast(Xi, r, dist, axis=DEFAULT_AXIS, p="p", inv=None):
    """``bending_force`` on precomputed polarity trig (see
    ``polarity_precompute``); identical physics, no per-pair trig, and --
    given ``inv`` = 1/dist -- no per-pair division either (the hot-loop
    form for the pair kernels: everything below is mul/add).

    Xi must carry the {p}x/{p}y/{p}z (and ideally {p}cf/{p}sf/{p}st/{p}sg)
    fields; Xj's vector arrives as ``Xi.p - r.p`` because engines form r
    component-wise.
    """
    pxi, pyi, pzi = (getattr(Xi, p + f) for f in ("x", "y", "z"))
    rpx = getattr(r, p + "x")
    rpy = getattr(r, p + "y")
    rpz = getattr(r, p + "z")
    if inv is None:
        inv = 1.0 / dist
    st, cf, sf, inv_st = _trig_of(Xi, p)

    # prodi = (p_i . r) / d; a = prodi / d; force = a^2 r - a p.
    # p_j = p_i - r.p never needs materializing: its dot folds through
    # prodi (prodj = prodi - (r.p . r)/d) and the two ends' positional
    # terms combine with p_j eliminated -- ~25% fewer hot-loop ops, same
    # physics to f32 roundoff (ref polarity.cuh:72-94).
    prodi = (pxi * r.x + pyi * r.y + pzi * r.z) * inv
    prodj = prodi - (rpx * r.x + rpy * r.y + rpz * r.z) * inv
    d_theta, d_phi = _unidir_from_vec(pzi, st, cf, sf, inv_st,
                                      r.x, r.y, r.z, inv)
    ai = prodi * inv
    aj = prodj * inv
    s1 = ai + aj
    s2 = ai * ai + aj * aj
    # ai^2 r - ai p_i  +  aj^2 r - aj (p_i - r.p)
    fx = s2 * r.x - s1 * pxi + aj * rpx
    fy = s2 * r.y - s1 * pyi + aj * rpy
    fz = s2 * r.z - s1 * pzi + aj * rpz

    dF = pt_zeros_like(Xi)
    return dF.replace(x=fx, y=fy, z=fz,
                      **{axis[0]: -prodi * d_theta, axis[1]: -prodi * d_phi})


def bending_force_cart(Xi, r, dist, p="p", inv=None):
    """``bending_force_fast`` with the angular gradient left in CARTESIAN
    form -- the hot-loop shape for the lattice kernels.

    Returns ``(fx, fy, fz, gx, gy, gz)``: the positional force and the
    pair's contribution to ``G_i = sum_j (-prod_i) * r_hat`` .  The caller
    accumulates g as aux channels and converts once per cell after the
    pair pass (``bending_post_pair``): both theta- and phi-gradients of
    the bending potential are LINEAR in r_hat (polarity.cuh:72-94 via the
    spherical basis e_theta / e_phi), so the basis contraction commutes
    with the pair sum -- identical physics up to f32 reassociation.

    vs ``bending_force_fast`` this drops the four per-point trig channels
    (pcf/psf/pst/psg -- use the compact ``polarity_precompute3``) and ~4
    ops per candidate pair; the per-cell conversion does the trig
    once per point instead of carrying it through the pair pass.
    """
    pxi, pyi, pzi = (getattr(Xi, p + f) for f in ("x", "y", "z"))
    rpx = getattr(r, p + "x")
    rpy = getattr(r, p + "y")
    rpz = getattr(r, p + "z")
    if inv is None:
        inv = 1.0 / dist
    prodi = (pxi * r.x + pyi * r.y + pzi * r.z) * inv
    prodj = prodi - (rpx * r.x + rpy * r.y + rpz * r.z) * inv
    ai = prodi * inv
    aj = prodj * inv
    s1 = ai + aj
    s2 = ai * ai + aj * aj
    fx = s2 * r.x - s1 * pxi + aj * rpx
    fy = s2 * r.y - s1 * pyi + aj * rpy
    fz = s2 * r.z - s1 * pzi + aj * rpz
    t = -prodi * inv
    return fx, fy, fz, t * r.x, t * r.y, t * r.z


def bending_post_pair(F, aux, X, axis=DEFAULT_AXIS,
                      keys=("pg_x", "pg_y", "pg_z")):
    """Per-cell conversion of the accumulated Cartesian angular gradient
    ``G = (aux[pg_x], aux[pg_y], aux[pg_z])`` (from ``bending_force_cart``)
    into the spherical (theta, phi) force components, added onto F:

        F_theta = e_theta . G           e_theta = (ct cf, ct sf, -st)
        F_phi   = (e_phi . G) / sin t   e_phi   = (-sf, cf, 0)

    with the reference's |sin theta| > 1e-10 gimbal guard as a zero
    (polarity.cuh:56-58).  Consumes the three aux channels.  Use as (or
    inside) a force's ``post_pair`` hook; every engine applies it after
    the pair reduction with its own per-point layout.
    """
    aux = dict(aux)
    Gx, Gy, Gz = (aux.pop(k) for k in keys)
    th = getattr(X, axis[0])
    ph = getattr(X, axis[1])
    ct, st = jnp.cos(th), jnp.sin(th)
    cf, sf = jnp.cos(ph), jnp.sin(ph)
    safe = jnp.abs(st) > 1e-10
    inv_st = jnp.where(safe, 1.0 / jnp.where(safe, st, 1.0), 0.0)
    dth = ct * (cf * Gx + sf * Gy) - st * Gz
    dph = (cf * Gy - sf * Gx) * inv_st
    return (F.replace(**{axis[0]: getattr(F, axis[0]) + dth,
                         axis[1]: getattr(F, axis[1]) + dph}), aux)


def apical_constriction_force_fast(Xi, r, dist, pref_angle,
                                   axis=DEFAULT_AXIS, p="p", inv=None):
    """``apical_constriction_force`` on precomputed polarity trig
    (see ``polarity_precompute``); identical physics, no per-pair trig,
    division-free given ``inv`` = 1/dist."""
    cos_pref = jnp.cos(pref_angle)
    pxi, pyi, pzi = (getattr(Xi, p + f) for f in ("x", "y", "z"))
    rpx = getattr(r, p + "x")
    rpy = getattr(r, p + "y")
    rpz = getattr(r, p + "z")
    if inv is None:
        inv = 1.0 / dist
    st, cf, sf, inv_st = _trig_of(Xi, p)

    # same p_j-eliminated form as bending_force_fast, with the preferred-
    # angle offsets folded into the two products
    prodi = (pxi * r.x + pyi * r.y + pzi * r.z) * inv + cos_pref
    prodj = prodi - (rpx * r.x + rpy * r.y + rpz * r.z) * inv \
        - (cos_pref + cos_pref)
    d_theta, d_phi = _unidir_from_vec(pzi, st, cf, sf, inv_st,
                                      r.x, r.y, r.z, inv)
    ai = prodi * inv
    aj = prodj * inv
    s1 = ai + aj
    s2 = ai * ai + aj * aj
    fx = s2 * r.x - s1 * pxi + aj * rpx
    fy = s2 * r.y - s1 * pyi + aj * rpy
    fz = s2 * r.z - s1 * pzi + aj * rpz

    dF = pt_zeros_like(Xi)
    return dF.replace(x=fx, y=fy, z=fz,
                      **{axis[0]: -prodi * d_theta, axis[1]: -prodi * d_phi})


def migration_force_fast(Xi, r, dist, axis=DEFAULT_AXIS, p="p", inv=None):
    """``migration_force`` on precomputed polarity vectors (see
    ``polarity_precompute``): identical physics, no per-pair trig --
    p_i rides the {p}x/{p}y/{p}z channels and p_j arrives as their r-diffs;
    the +-0.15 dot-product gates (ref polarity.cuh:138, 154) become plain
    arithmetic on the unit vectors.  Division-free given ``inv`` = 1/dist
    (``orthonormal`` keeps its one guarded rsqrt)."""
    th, ph = _angles(Xi, axis)
    rth, rph = _angles(r, axis)
    if inv is None:
        pos = dist > 0
        inv = jnp.where(pos, 1.0 / jnp.where(pos, dist, 1.0), 0.0)
    pxi, pyi, pzi = (getattr(Xi, p + f) for f in ("x", "y", "z"))
    pxj = pxi - getattr(r, p + "x")
    pyj = pyi - getattr(r, p + "y")
    pzj = pzi - getattr(r, p + "z")

    # Pulling around j (only for cells with a set polarity)
    rdot_i = (pxi * r.x + pyi * r.y + pzi * r.z) * inv
    pull = ((ph != 0) | (th != 0)) & (rdot_i <= -0.15)
    pi_T = orthonormal(r, Float3(pxi, pyi, pzi))
    fx = jnp.where(pull, 0.6 * pxi + 0.8 * pi_T.x, 0.0)
    fy = jnp.where(pull, 0.6 * pyi + 0.8 * pi_T.y, 0.0)
    fz = jnp.where(pull, 0.6 * pzi + 0.8 * pi_T.z, 0.0)

    # Getting pushed aside by j; Xj angles = Xi - r
    rdot_j = (pxj * r.x + pyj * r.y + pzj * r.z) * inv
    push = (((ph - rph > 1e-10) | (th - rth > 1e-10))
            & (rdot_j >= 0.15))
    pj_T = orthonormal(Float3(-r.x, -r.y, -r.z), Float3(pxj, pyj, pzj))
    fx = fx - jnp.where(push, 0.6 * pxj + 0.8 * pj_T.x, 0.0)
    fy = fy - jnp.where(push, 0.6 * pyj + 0.8 * pj_T.y, 0.0)
    fz = fz - jnp.where(push, 0.6 * pzj + 0.8 * pj_T.z, 0.0)

    dF = pt_zeros_like(Xi)
    return dF.replace(x=fx, y=fy, z=fz)


def orthonormal(r, p):
    """Unit vector in the r-plane orthogonal to unit p
    (ref polarity.cuh:125-131).

    Guarded at norm == 0 (r exactly parallel to p, or r == 0): returns the
    zero vector instead of NaN.  The reference never evaluates such pairs
    (its functors early-return on i == j / beyond-cutoff); our engines
    evaluate every candidate lane and mask afterwards, so the degenerate
    lanes must stay finite or NaN * 0 poisons the per-cell sums."""
    rp = r.x * p.x + r.y * p.y + r.z * p.z
    nx, ny, nz = r.x - rp * p.x, r.y - rp * p.y, r.z - rp * p.z
    n2 = nx * nx + ny * ny + nz * nz
    pos = n2 > 0
    inv = jnp.where(pos, jax.lax.rsqrt(jnp.where(pos, n2, 1.0)), 0.0)
    return Float3(x=nx * inv, y=ny * inv, z=nz * inv)


def migration_force(Xi, r, dist, axis=DEFAULT_AXIS):
    """Mono-polar migration: crawl around the cell in front, get pushed
    aside by the one behind (ref polarity.cuh:123-164, after
    https://doi.org/10.1016/B978-0-12-405926-9.00016-2)."""
    th, ph = _angles(Xi, axis)
    r_hat = pt_to_pol(r, dist)

    # Pulling around j (only for cells with a set polarity)
    pull = (((ph != 0) | (th != 0))
            & (pol_dot_product(Xi, r_hat, axis=axis) <= -0.15))
    pi = pol_to_float3(Xi, axis)
    pi_T = orthonormal(r, pi)
    fx = jnp.where(pull, 0.6 * pi.x + 0.8 * pi_T.x, 0.0)
    fy = jnp.where(pull, 0.6 * pi.y + 0.8 * pi_T.y, 0.0)
    fz = jnp.where(pull, 0.6 * pi.z + 0.8 * pi_T.z, 0.0)

    # Getting pushed aside by j; Xj angles = Xi - r
    rth, rph = _angles(r, axis)
    Xj = Polarity(th - rth, ph - rph)
    push = (((Xj.phi > 1e-10) | (Xj.theta > 1e-10))
            & (pol_dot_product(Xj, r_hat) >= 0.15))
    pj = pol_to_float3(Xj)
    pj_T = orthonormal(-1.0 * Float3(r.x, r.y, r.z), pj)
    fx = fx - jnp.where(push, 0.6 * pj.x + 0.8 * pj_T.x, 0.0)
    fy = fy - jnp.where(push, 0.6 * pj.y + 0.8 * pj_T.y, 0.0)
    fz = fz - jnp.where(push, 0.6 * pj.z + 0.8 * pj_T.z, 0.0)

    dF = pt_zeros_like(Xi)
    return dF.replace(x=fx, y=fy, z=fz)
