"""Batched DLT triangulation + triangulation angles.

Counterpart of reference src/base3d/triangulation.{h,cc}. The
reference loops over points with OpenMP (triangulation.cc:53-98); here the
whole batch is one SVD of shape (N, 4, 4) that XLA maps across the chip.

Inputs are *normalized* image coordinates (after `models.image2world`).
"""

import jax.numpy as jnp


def _det3(M):
    """Batched 3x3 determinant, M: (..., 3, 3)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _cross4(M):
    """4-D generalized cross product of 3 row vectors, M: (..., 3, 4).

    Returns (..., 4) n with M @ n = 0 exactly (cofactor expansion)."""
    cols = []
    sign = 1.0
    for j in range(4):
        keep = [k for k in range(4) if k != j]
        cols.append(sign * _det3(M[..., :, keep]))
        sign = -sign
    return jnp.stack(cols, axis=-1)


def nullvec4(A):
    """Approximate null vector of a near-rank-3 4x4 system, (..., 4, 4) ->
    (..., 4). Closed form: the cofactor cross product of each row triple is
    exactly orthogonal to those 3 rows; the max-norm candidate is the best
    conditioned one. ~200 flops/point, fully fused elementwise — batched
    4x4 SVD is an iterative Jacobi sweep, far slower per point. (Not eigh
    of A^T A either: squaring the condition number is
    fatal in f32 for small-parallax pairs.)"""
    triples = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
    cands = jnp.stack(
        [_cross4(A[..., t, :]) for t in triples], axis=-2
    )  # (..., 4cand, 4)
    norms = jnp.sum(cands * cands, axis=-1)
    best = jnp.argmax(norms, axis=-1)
    return jnp.take_along_axis(
        cands, best[..., None, None].astype(jnp.int32), axis=-2
    )[..., 0, :]


def triangulate_points(proj1, proj2, points1, points2):
    """Two-view DLT triangulation (Hartley-Zisserman).

    proj1, proj2: (..., 3, 4); points1, points2: (..., N, 2) normalized coords.
    Returns (..., N, 3) world points.

    Builds the 4x4 homogeneous system [u*P3 - P1; v*P3 - P2] per view
    (reference triangulation.cc:12-50 builds the equivalent 6x4
    cross-product system) and takes its nullspace in closed form
    (`nullvec4`).
    """
    rows = []
    for proj, pts in ((proj1, points1), (proj2, points2)):
        P1 = proj[..., None, 0, :]  # (..., 1, 4)
        P2 = proj[..., None, 1, :]
        P3 = proj[..., None, 2, :]
        u = pts[..., 0:1]
        v = pts[..., 1:2]
        rows.append(u * P3 - P1)  # (..., N, 4)
        rows.append(v * P3 - P2)
    A = jnp.stack(rows, axis=-2)  # (..., N, 4, 4)
    X = nullvec4(A)
    w = X[..., 3:4]
    safe_w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / safe_w


def triangulate_points_multiview(projs, points2D, mask):
    """N-view DLT for one track, masked.

    projs: (V, 3, 4); points2D: (V, 2) normalized; mask: (V,) bool of valid
    observations. Returns (3,) world point. Invalid rows are zeroed out of
    the design matrix so the solve stays static-shape.
    """
    P1, P2, P3 = projs[:, 0, :], projs[:, 1, :], projs[:, 2, :]
    u = points2D[:, 0:1]
    v = points2D[:, 1:2]
    rows = jnp.concatenate([u * P3 - P1, v * P3 - P2], axis=0)  # (2V, 4)
    m = jnp.concatenate([mask, mask], axis=0)[:, None].astype(rows.dtype)
    rows = rows * m
    _, _, Vt = jnp.linalg.svd(rows, full_matrices=False)
    X = Vt[-1, :]
    w = X[3]
    safe_w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return X[:3] / safe_w


def calc_tri_angles(proj1, proj2, points3D):
    """Angle at each 3-D point between the rays to the two camera centers.

    Reference triangulation.cc:101-147 (law of cosines). points3D: (..., N, 3)
    -> (..., N) angles in radians.
    """
    R1 = proj1[..., :3, :3]
    t1 = proj1[..., :3, 3]
    R2 = proj2[..., :3, :3]
    t2 = proj2[..., :3, 3]
    c1 = -(jnp.swapaxes(R1, -1, -2) @ t1[..., :, None])[..., 0]
    c2 = -(jnp.swapaxes(R2, -1, -2) @ t2[..., :, None])[..., 0]

    baseline2 = jnp.sum((c1 - c2) ** 2, axis=-1)[..., None]
    ray1 = points3D - c1[..., None, :]
    ray2 = points3D - c2[..., None, :]
    d1_2 = jnp.sum(ray1 * ray1, axis=-1)
    d2_2 = jnp.sum(ray2 * ray2, axis=-1)
    d1 = jnp.sqrt(jnp.maximum(d1_2, 1e-20))
    d2 = jnp.sqrt(jnp.maximum(d2_2, 1e-20))
    cos_angle = (d1_2 + d2_2 - baseline2) / jnp.maximum(2.0 * d1 * d2, 1e-20)
    return jnp.arccos(jnp.clip(cos_angle, -1.0, 1.0))
