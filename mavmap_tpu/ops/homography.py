"""4-point DLT homography estimation (degeneracy gate for view pairs).

Counterpart of reference src/base3d/projective_transform.{h,cc}.
Used only to reject image pairs with too little viewpoint change: if too
many matches fit a homography the pair is near-degenerate for two-view
geometry (reference sfm/sequential_mapper.cc:116-158).
"""

import jax.numpy as jnp


def solve_homography(src, dst):
    """Minimal/overdetermined DLT from (S, 2) <-> (S, 2) normalized points.

    Returns ((1, 3, 3) models, (1,) mask) — the RANSAC estimator contract
    (one candidate per sample). Reference projective_transform.cc:12-45.
    """
    S = src.shape[0]
    u, v = src[:, 0], src[:, 1]
    x, y = dst[:, 0], dst[:, 1]
    zero = jnp.zeros_like(u)
    one = jnp.ones_like(u)
    rows1 = jnp.stack([u, v, one, zero, zero, zero, -u * x, -v * x, -x], axis=-1)
    rows2 = jnp.stack([zero, zero, zero, u, v, one, -u * y, -v * y, -y], axis=-1)
    A = jnp.concatenate([rows1, rows2], axis=0)  # (2S, 9)
    # Fix h33 = 1 and solve the 8x8 normal equations directly — a batched
    # LU solve instead of a 9x9 eigendecomposition (iterative, and far
    # slower batched). The h33 = 0 configurations this excludes (plane
    # through the camera center) cannot pass the gate's inlier test anyway;
    # a singular sample yields non-finite H and is masked out.
    AtA = A.T @ A
    h8 = jnp.linalg.solve(AtA[:8, :8], -AtA[:8, 8])
    H = jnp.concatenate([h8, jnp.ones((1,), h8.dtype)]).reshape(3, 3)
    ok = jnp.isfinite(H).all()
    return H[None], ok[None]


def homography_residuals(src, dst, H):
    """Transfer error ||proj(H src) - dst|| per point, (N,)."""
    ones = jnp.ones_like(src[:, :1])
    ph = jnp.concatenate([src, ones], axis=-1) @ H.T
    w = ph[:, 2:3]
    safe_w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    proj = ph[:, :2] / safe_w
    return jnp.linalg.norm(proj - dst, axis=-1)
