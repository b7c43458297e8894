"""7-DoF similarity transform (Umeyama) + pose/point transforms.

Counterpart of reference src/base3d/similarity_transform.{h,cc}:
used for sub-map merging and GCP geo-registration. The minimal solver is
closed-form Umeyama over (S >= 3) 3-D point pairs; the wrapper transforms
points and remaps (rvec, tvec) world->cam poses under the similarity.
"""

import jax.numpy as jnp

from .rotation import rotmat_from_rvec, rvec_from_rotmat


def solve_umeyama(src, dst, with_scale=True):
    """Least-squares s,R,t with dst ~ s R src + t.

    src, dst: (S, 3). Returns (3, 4) matrix [sR | t].
    Classic Umeyama (1991) closed form, batched-SVD friendly.
    """
    dtype = src.dtype
    mu_s = jnp.mean(src, axis=0)
    mu_d = jnp.mean(dst, axis=0)
    cs = src - mu_s
    cd = dst - mu_d
    S = cs.shape[0]
    cov = (cd.T @ cs) / S  # (3, 3)
    U, D, Vt = jnp.linalg.svd(cov)
    det_sign = jnp.sign(jnp.linalg.det(U) * jnp.linalg.det(Vt))
    sgn = jnp.ones((3,), dtype).at[2].set(det_sign)
    R = (U * sgn[None, :]) @ Vt
    var_s = jnp.mean(jnp.sum(cs * cs, axis=1))
    if with_scale:
        scale = jnp.sum(D * sgn) / jnp.maximum(var_s, 1e-20)
    else:
        scale = jnp.asarray(1.0, dtype)
    t = mu_d - scale * (R @ mu_s)
    return jnp.concatenate([scale * R, t[:, None]], axis=-1)


def solve_similarity(src, dst):
    """RANSAC estimator contract: ((1, 3, 4), (1,)) from a (S, 3) sample pair."""
    T = solve_umeyama(src, dst)
    ok = jnp.isfinite(T).all()
    return T[None], ok[None]


def similarity_residuals(src, dst, T):
    """||T(src) - dst|| per point."""
    return jnp.linalg.norm(transform_points(T, src) - dst, axis=-1)


def transform_points(T, points):
    """Apply (3, 4) [sR|t] to (..., 3) points."""
    return points @ T[:3, :3].T + T[:3, 3]


def similarity_scale(T):
    """Isotropic scale s of [sR|t] (reference similarity_transform.cc:125-130)."""
    return jnp.linalg.det(T[:3, :3]) ** (1.0 / 3.0)


def similarity_rvec(T):
    s = similarity_scale(T)
    return rvec_from_rotmat(T[:3, :3] / s)


def transform_pose(T, rvec, tvec):
    """Remap a world->cam pose under a world similarity x' = sR x + t.

    If x_cam = R_c x + t_c and the world is remapped by (s, R, t), the new
    pose is R_c' = R_c R^T, t_c' = s t_c - R_c' t  (up to the global scale s
    applied to translations so reprojection is preserved). Matches the pose
    re-mapping math of reference similarity_transform.cc:95-122.
    """
    s = similarity_scale(T)
    R = T[:3, :3] / s
    t = T[:3, 3]
    Rc = rotmat_from_rvec(rvec)
    Rc_new = Rc @ R.T
    t_new = s * tvec - Rc_new @ t
    return rvec_from_rotmat(Rc_new), t_new
