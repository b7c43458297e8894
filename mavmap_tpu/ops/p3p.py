"""Batched perspective-3-point (P3P) absolute pose solver.

Counterpart of reference src/base3d/p3p.{h,cc} (Gao et al.
analytic P3P). This rebuild uses the classical Grunert law-of-cosines
reduction (cf. Haralick et al. 1994 review): unknown depths s1, s2 = u s1,
s3 = v s1 satisfy two quadratics in u with v-dependent coefficients; their
resultant is a quartic in v, solved in closed form (Ferrari, branch-free).
Each real root yields camera-frame points and a rigid Umeyama fit gives the
pose. All 4 candidates are returned with a validity mask; RANSAC scoring
over all observations performs the disambiguation the reference does with
a 4th sample point (p3p.cc:144-159).

Sample contract (matching the reference's 4-point minimal sample,
p3p.h:35): solve_p3p consumes the FIRST 3 correspondences of the sample to
build the quartic; extra rows are ignored (they still vote in scoring).
"""

import jax
import jax.numpy as jnp

from .polynomial import solve_quartic_real
from .projection import calc_reproj_errors


def _conv(p, q):
    return jnp.convolve(p, q)


def solve_p3p(points2D, points3D):
    """P3P minimal solver.

    points2D: (S>=3, 2) normalized image coords; points3D: (S>=3, 3) world
    points. Returns (models (4, 3, 4) [R|t] world->cam, mask (4,)).
    """
    dtype = points2D.dtype
    P = points3D[:3]
    # Unit bearing rays.
    f = jnp.concatenate([points2D[:3], jnp.ones_like(points2D[:3, :1])], axis=-1)
    f = f / jnp.linalg.norm(f, axis=-1, keepdims=True)

    # Squared distances between world points; cosines between rays.
    a = jnp.sum((P[1] - P[2]) ** 2)  # opposite P1
    b = jnp.sum((P[0] - P[2]) ** 2)  # opposite P2
    c = jnp.sum((P[0] - P[1]) ** 2)  # opposite P3
    cos_alpha = jnp.dot(f[1], f[2])
    cos_beta = jnp.dot(f[0], f[2])
    cos_gamma = jnp.dot(f[0], f[1])

    b_safe = jnp.maximum(b, 1e-20)
    cb = c / b_safe
    ab = a / b_safe

    one = jnp.ones((), dtype)
    zero = jnp.zeros((), dtype)

    # Quadratic 1 (from c/b ratio): u^2 + p1 u + q1(v) = 0
    #   p1 = -2 cos(gamma); q1(v) = 1 - cb (1 + v^2 - 2 v cos(beta))
    p1 = jnp.stack([-2.0 * cos_gamma])  # constant (deg 0 in v)
    q1 = jnp.stack([1.0 - cb, 2.0 * cb * cos_beta, -cb])  # ascending in v

    # Quadratic 2 (from a/b ratio): u^2 + p2(v) u + q2(v) = 0
    #   p2(v) = -2 v cos(alpha); q2(v) = v^2 - ab (1 + v^2 - 2 v cos(beta))
    p2 = jnp.stack([zero, -2.0 * cos_alpha])  # deg 1
    q2 = jnp.stack([-ab, 2.0 * ab * cos_beta, 1.0 - ab])  # deg 2

    # Resultant of the two monic quadratics:
    #   R(v) = dq^2 - p1 dq dp + q1 dp^2, with dp = p1 - p2, dq = q1 - q2.
    dp = jnp.stack([p1[0], 2.0 * cos_alpha])  # p1 - p2, deg 1
    dq = q1 - q2  # deg 2
    quartic = (
        jnp.pad(_conv(dq, dq), (0, 0))  # deg 4 (5 coeffs)
        - jnp.pad(_conv(jnp.stack([p1[0]]), _conv(dq, dp)), (0, 1))[:5]
        + jnp.pad(_conv(q1, _conv(dp, dp)), (0, 0))[:5]
    )

    # Closed-form Ferrari quartic: one fused elementwise block instead of
    # 40 sequential Durand-Kerner steps (pure launch latency); the
    # Newton polish below supplies the final accuracy either way.
    v, real_mask = solve_quartic_real(quartic)  # (4,) roots in v

    # u via the linear elimination u = -dq(v) / dp(v).
    dq_v = dq[0] + dq[1] * v + dq[2] * v * v
    dp_v = dp[0] + dp[1] * v
    u = -dq_v / jnp.where(jnp.abs(dp_v) < 1e-12, 1e-12, dp_v)

    # Newton polish of (u, v) on the two original quadratics — recovers the
    # ~1e-7 accuracy of the constraint coefficients that the f32 quartic
    # resultant (root error ~1e-4) loses.
    def newton_step(_, uv):
        u, v = uv
        Q1 = u * u + p1[0] * u + (q1[0] + q1[1] * v + q1[2] * v * v)
        Q2 = u * u + (-2.0 * cos_alpha * v) * u + (q2[0] + q2[1] * v + q2[2] * v * v)
        J11 = 2.0 * u + p1[0]
        J12 = q1[1] + 2.0 * q1[2] * v
        J21 = 2.0 * u - 2.0 * cos_alpha * v
        J22 = -2.0 * cos_alpha * u + q2[1] + 2.0 * q2[2] * v
        det = J11 * J22 - J12 * J21
        det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        du = (Q1 * J22 - Q2 * J12) / det
        dv = (Q2 * J11 - Q1 * J21) / det
        return (u - du, v - dv)

    u, v = jax.lax.fori_loop(0, 3, newton_step, (u, v))

    # Depths.
    denom = 1.0 + v * v - 2.0 * v * cos_beta
    s1_sq = b / jnp.maximum(denom, 1e-20)
    valid = real_mask & (s1_sq > 0) & (denom > 1e-12)
    s1 = jnp.sqrt(jnp.maximum(s1_sq, 0.0))
    s2 = u * s1
    s3 = v * s1
    valid = valid & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # Camera-frame points and rigid alignment world -> camera.
    Xc = jnp.stack([s1, s2, s3], axis=-1)[..., None] * f[None, :, :]  # (4, 3, 3)

    def triad(Q):
        """Orthonormal frame from 3 points, columns of a 3x3 basis."""
        e1 = Q[1] - Q[0]
        e1 = e1 / jnp.maximum(jnp.linalg.norm(e1), 1e-12)
        u = Q[2] - Q[0]
        e2 = u - jnp.dot(u, e1) * e1
        e2 = e2 / jnp.maximum(jnp.linalg.norm(e2), 1e-12)
        e3 = jnp.cross(e1, e2)
        return jnp.stack([e1, e2, e3], axis=-1)

    # Rigid alignment of EXACTLY 3 corresponding points is closed-form:
    # map the world triad onto the camera triad (no SVD — batched 3x3 SVD
    # Umeyama was the latency hot spot of the whole P3P RANSAC; the
    # reference uses Eigen's umeyama, p3p.cc:127-142, which is fine on CPU).
    Bw = triad(P)

    def fit(Xc_i):
        R = triad(Xc_i) @ Bw.T
        t = jnp.mean(Xc_i, axis=0) - R @ jnp.mean(P, axis=0)
        return jnp.concatenate([R, t[:, None]], axis=-1)

    models = jax.vmap(fit)(Xc)  # (4, 3, 4)
    valid = valid & jnp.isfinite(models).all(axis=(1, 2))
    return models, valid


def solve_p3p_best(points2D, points3D):
    """P3P minimal solver returning ONE disambiguated model.

    Consumes a 4-row sample like the reference (p3p.h:35): the first 3
    correspondences build the quartic; the remaining sample rows
    disambiguate among the up-to-4 candidate poses by total reprojection
    error (reference p3p.cc:144-159 uses the 4th point alone; summing over
    the whole sample is the same decision in the exact case and strictly
    more robust under noise). Returns (models (1, 3, 4), mask (1,)).

    Under RANSAC this quarters the residual-scoring work: the dominant
    (T*M, N) reprojection matrix shrinks from 4 candidate models per trial
    to 1 — the reference also scores a single model per trial
    (sequential_mapper.cc:640-659 at 500 trials).
    """
    models, valid = solve_p3p(points2D, points3D)
    errs = jax.vmap(lambda m: calc_reproj_errors(points2D, points3D, m))(
        models)  # (4, S)
    tot = jnp.sum(jnp.minimum(jnp.nan_to_num(errs, nan=1e6, posinf=1e6),
                              1e6), axis=1)
    tot = jnp.where(valid, tot, jnp.inf)
    best = jnp.argmin(tot)
    return models[best][None], valid[best][None]


def p3p_residuals(points2D, points3D, model):
    """Reprojection error in normalized coords per correspondence (N,).

    Matches reference p3p.cc:172-199.
    """
    return calc_reproj_errors(points2D, points3D, model)
