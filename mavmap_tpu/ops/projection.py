"""Projection-matrix utilities, reprojection errors, depths.

Counterpart of reference src/base3d/projection.{h,cc}. A pose is
the pair ``(rvec, tvec)`` mapping world -> camera: ``x_cam = R x_w + t``.
``proj`` denotes the (..., 3, 4) matrix ``[R | t]``.

Everything is batched: functions accept arbitrary leading batch dims on the
pose and a points axis N, returning per-point values.
"""

import jax.numpy as jnp

from .rotation import rotmat_from_rvec, rvec_from_rotmat


def compose_proj_matrix(rvec, tvec):
    """(..., 3), (..., 3) -> (..., 3, 4) = [R(rvec) | tvec].

    Reference: src/base3d/projection.cc:58-76.
    """
    R = rotmat_from_rvec(rvec)
    return jnp.concatenate([R, tvec[..., :, None]], axis=-1)


def invert_proj_matrix(proj):
    """Invert [R|t] -> [R^T | -R^T t]. Reference: src/base3d/projection.cc:79-87."""
    R = proj[..., :3, :3]
    t = proj[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    t_inv = -(Rt @ t[..., :, None])
    return jnp.concatenate([Rt, t_inv], axis=-1)


def invert_pose(rvec, tvec):
    """World->cam pose to cam->world pose (and vice versa)."""
    R = rotmat_from_rvec(rvec)
    Rt = jnp.swapaxes(R, -1, -2)
    return rvec_from_rotmat(Rt), -(Rt @ tvec[..., :, None])[..., 0]


def camera_center(rvec, tvec):
    """World coordinates of the camera center: C = -R^T t."""
    R = rotmat_from_rvec(rvec)
    return -(jnp.swapaxes(R, -1, -2) @ tvec[..., :, None])[..., 0]


def world_pose_from_proj(proj):
    """Extract cam->world (rvec, tvec) from a world->cam [R|t] for output.

    Reference: src/base3d/projection.cc:90-104.
    """
    inv = invert_proj_matrix(proj)
    return rvec_from_rotmat(inv[..., :3, :3]), inv[..., :3, 3]


def transform_points(proj, points3D):
    """Apply [R|t] to (..., N, 3) world points -> camera-frame points."""
    R = proj[..., :3, :3]
    t = proj[..., :3, 3]
    return points3D @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def project_normalized(proj, points3D, eps=1e-12):
    """World points -> normalized image coords (x/z, y/z). (..., N, 3) -> (..., N, 2)."""
    pc = transform_points(proj, points3D)
    z = pc[..., 2:3]
    safe_z = jnp.where(jnp.abs(z) < eps, jnp.where(z < 0, -eps, eps), z)
    return pc[..., :2] / safe_z


def calc_depth(proj, points3D):
    """Signed depth of world points w.r.t. camera. Reference projection.cc:133-149.

    Depth is the z-coordinate in the camera frame, scaled so that it is
    invariant to the (unit) determinant of R — for a proper rotation this is
    simply z_cam.
    """
    pc = transform_points(proj, points3D)
    return pc[..., 2]


def calc_reproj_errors(points2D, points3D, proj, eps=1e-12):
    """Euclidean reprojection error in normalized coords per point.

    points2D: (..., N, 2) observed normalized coords; points3D: (..., N, 3);
    proj: (..., 3, 4). Returns (..., N). Points behind the camera get a large
    error (matching the reference's policy of treating them as outliers;
    reference projection.cc:107-130).
    """
    pc = transform_points(proj, points3D)
    z = pc[..., 2]
    safe_z = jnp.where(jnp.abs(z) < eps, eps, z)
    proj2D = pc[..., :2] / safe_z[..., None]
    err = jnp.linalg.norm(proj2D - points2D, axis=-1)
    return jnp.where(z > 0, err, jnp.full_like(err, 1e6))
