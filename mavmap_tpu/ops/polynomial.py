"""Batched polynomial evaluation and root finding.

Counterpart of reference src/util/math.{h,cc} (`poly_eval`,
`poly_solve` — a Durand-Kerner complex root solver, math.cc:52-87). The
rebuild keeps the Durand-Kerner scheme because it is branch-free, has a
fixed iteration count, and batches perfectly — unlike companion-matrix
eigendecomposition, which XLA supports for nonsymmetric matrices only on
the CPU.

Complex arithmetic is implemented explicitly on (re, im) float pairs: the
hand-rolled form keeps everything in vectorizable f32 lanes.

Coefficient convention: **ascending** — ``p(z) = sum_k coeffs[..., k] z^k``.
"""

import jax
import jax.numpy as jnp


def poly_eval(coeffs, x):
    """Evaluate p(x) by Horner. coeffs: (..., D+1) ascending; x: (...)."""
    D = coeffs.shape[-1] - 1
    acc = coeffs[..., D]
    for k in range(D - 1, -1, -1):
        acc = acc * x + coeffs[..., k]
    return acc


# --- explicit complex arithmetic on (re, im) pairs --------------------------


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi, eps=1e-30):
    d = br * br + bi * bi
    d = jnp.maximum(d, eps)
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def roots_durand_kerner(coeffs, num_iters=60):
    """All complex roots of a batch of degree-D polynomials.

    coeffs: (..., D+1) ascending real coefficients; the leading coefficient
    must be nonzero (callers normalize — RANSAC hypothesis batches guarantee
    this via masking). Returns (roots_re, roots_im), each (..., D).

    The Weierstrass/Durand-Kerner iteration:
        z_i <- z_i - p(z_i) / prod_{j != i} (z_i - z_j)
    with initial guesses on a spiral scaled by the Cauchy root bound.
    Fixed `num_iters` iterations — no convergence test, so the whole solve
    is a static fori_loop (reference math.cc:52-87 iterates to a tolerance
    instead).
    """
    dtype = coeffs.dtype
    D = coeffs.shape[-1] - 1
    lead = coeffs[..., -1:]
    lead = jnp.where(jnp.abs(lead) < 1e-30, 1e-30, lead)
    monic = coeffs / lead  # ascending, monic

    # Fujiwara root bound: 2 * max_k |c_{D-k}|^{1/k} (much tighter than the
    # Cauchy bound when the leading coefficient is small). Substitute
    # u = z / radius so every root of the u-polynomial lies in |u| <= 1 —
    # this keeps all intermediate magnitudes O(1), which both makes the
    # iteration float32-safe (naive DK overflows f32 when a loose bound
    # pushes |z|^D and squared denominators past 3e38) and keeps the roots
    # well separated relative to the initial-guess ring.
    kk = jnp.arange(1, D + 1).astype(dtype)
    mags = jnp.abs(monic[..., :-1][..., ::-1])  # |c_{D-1}|, ..., |c_0|
    radius = 2.0 * jnp.max(jnp.maximum(mags, 1e-30) ** (1.0 / kk), axis=-1)
    radius = jnp.maximum(radius, 1e-6)
    powers = radius[..., None] ** jnp.arange(-D, 1).astype(dtype)  # r^(k-D)
    monic = monic * powers  # coefficients of the monic u-polynomial

    k = jnp.arange(D, dtype=dtype)
    # Spiral of initial guesses: distinct moduli & phases avoid symmetric
    # stalls; arg(0.4 + 0.9i) phase progression, graded moduli in (0.5, 1].
    ang0 = jnp.arctan2(0.9, 0.4)
    ang = ang0 * (k + 1.0)
    mod = 0.5 + 0.5 * (k + 1.0) / D
    zr0 = jnp.broadcast_to(mod * jnp.cos(ang), radius.shape + (D,))
    zi0 = jnp.broadcast_to(mod * jnp.sin(ang), radius.shape + (D,))

    def p_of(zr, zi):
        # Horner on monic ascending coeffs, batched over the roots axis.
        ar = jnp.zeros_like(zr)
        ai = jnp.zeros_like(zi)
        for i in range(D, -1, -1):
            ar, ai = _cmul(ar, ai, zr, zi)
            ar = ar + monic[..., i][..., None]
        return ar, ai

    eye = jnp.eye(D, dtype=dtype)

    def body(_, z):
        zr, zi = z
        pr, pi = p_of(zr, zi)
        dr = zr[..., :, None] - zr[..., None, :] + eye  # (..., D, D)
        di = zi[..., :, None] - zi[..., None, :]
        # prod over last axis of complex (dr, di)
        def prod_body(carry, x):
            cr, ci = carry
            xr, xi = x
            return _cmul(cr, ci, xr, xi), None

        # scan over the last axis: move it to front
        drm = jnp.moveaxis(dr, -1, 0)
        dim = jnp.moveaxis(di, -1, 0)
        init = (jnp.ones_like(zr), jnp.zeros_like(zi))
        (qr, qi), _ = jax.lax.scan(prod_body, init, (drm, dim))
        sr, si = _cdiv(pr, pi, qr, qi)
        # Clamp absurd steps (rare stalls with coincident guesses). All
        # magnitudes are O(1) in the scaled variable.
        smag = jnp.sqrt(sr * sr + si * si)
        max_step = 4.0
        scale = jnp.where(smag > max_step, max_step / jnp.maximum(smag, 1e-30), 1.0)
        return (zr - sr * scale, zi - si * scale)

    zr, zi = jax.lax.fori_loop(0, num_iters, body, (zr0, zi0))
    r = radius[..., None]
    return zr * r, zi * r


def solve_quartic_real(coeffs):
    """Closed-form (Ferrari) real roots of a batch of quartics.

    coeffs: (..., 5) ascending real coefficients. Returns (roots, mask),
    each (..., 4): the real roots (garbage where mask is False) of
    c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0.

    Branch-free resolvent-cubic + two-quadratics factorization — ~40
    elementwise ops total, no iteration. This replaces Durand-Kerner for
    quartic minimal solvers (P3P): DK's fixed 40-iteration fori_loop is a
    long chain of tiny sequential ops, pure launch latency, while this
    is one fused elementwise block. Callers that need tighter roots polish
    with Newton on their original constraint system (ops/p3p.py does).
    """
    dtype = coeffs.dtype
    lead = coeffs[..., 4:5]
    lead = jnp.where(jnp.abs(lead) < 1e-30, 1e-30, lead)
    monic = coeffs / lead

    # Fujiwara scaling x = R u keeps intermediates O(1) in f32 (same
    # rationale as roots_durand_kerner above).
    kk = jnp.arange(1, 5).astype(dtype)
    mags = jnp.abs(monic[..., :-1][..., ::-1])
    R = 2.0 * jnp.max(jnp.maximum(mags, 1e-30) ** (1.0 / kk), axis=-1)
    R = jnp.maximum(R, 1e-6)
    powers = R[..., None] ** jnp.arange(-4, 1).astype(dtype)
    u = monic * powers  # monic quartic in u

    a, b, c, d = u[..., 3], u[..., 2], u[..., 1], u[..., 0]
    # Depressed quartic y^4 + p y^2 + q y + r, x = y - a/4.
    a2 = a * a
    p = b - 0.375 * a2
    q = c - 0.5 * a * b + 0.125 * a2 * a
    r = d - 0.25 * a * c + 0.0625 * a2 * b - (3.0 / 256.0) * a2 * a2

    # Resolvent cubic m^3 + e2 m^2 + e1 m + e0 = 0; its largest real root
    # is >= 0 (value at 0 is -q^2/8 <= 0, +inf at +inf).
    e2 = p
    e1 = 0.25 * p * p - r
    e0 = -0.125 * q * q
    # Cardano: m = t - e2/3, t^3 + P t + Q = 0.
    P = e1 - e2 * e2 / 3.0
    Q = 2.0 * e2 * e2 * e2 / 27.0 - e2 * e1 / 3.0 + e0
    half_q = 0.5 * Q
    disc = half_q * half_q + (P / 3.0) ** 3

    # disc >= 0: single real root via cbrt.
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    cbrt = lambda x: jnp.sign(x) * jnp.abs(x) ** (1.0 / 3.0)
    t_single = cbrt(-half_q + sq) + cbrt(-half_q - sq)
    # disc < 0: three real roots; the largest is 2 sqrt(-P/3) cos(phi/3).
    mp3 = jnp.maximum(-P / 3.0, 1e-30)
    smp3 = jnp.sqrt(mp3)
    cosphi = jnp.clip(-half_q / jnp.maximum(smp3 ** 3, 1e-30), -1.0, 1.0)
    t_triple = 2.0 * smp3 * jnp.cos(jnp.arccos(cosphi) / 3.0)
    t = jnp.where(disc >= 0, t_single, t_triple)
    m = jnp.maximum(t - e2 / 3.0, 0.0)

    s = jnp.sqrt(2.0 * m)
    qs = jnp.where(s > 1e-12, q / jnp.maximum(2.0 * s, 1e-30), 0.0)
    B1 = 0.5 * p + m - qs  # factor y^2 + s y + B1
    B2 = 0.5 * p + m + qs  # factor y^2 - s y + B2

    d1 = s * s - 4.0 * B1
    d2 = s * s - 4.0 * B2
    sd1 = jnp.sqrt(jnp.maximum(d1, 0.0))
    sd2 = jnp.sqrt(jnp.maximum(d2, 0.0))
    y = jnp.stack([
        0.5 * (-s + sd1), 0.5 * (-s - sd1),
        0.5 * (s + sd2), 0.5 * (s - sd2),
    ], axis=-1)
    mask = jnp.stack([d1, d1, d2, d2], axis=-1) >= 0
    roots = (y - 0.25 * a[..., None]) * R[..., None]
    return roots, mask


def real_roots_mask(roots_re, roots_im, imag_tol=1e-4):
    """Mask of roots that are (numerically) real, relative to their magnitude."""
    mag = jnp.sqrt(roots_re * roots_re + roots_im * roots_im)
    return jnp.abs(roots_im) <= imag_tol * jnp.maximum(mag, 1.0)
