"""Rotation utilities: angle-axis (rvec) <-> matrix, Euler <-> matrix.

Counterpart of the reference's rotation helpers
(reference: src/base3d/projection.cc:12-55). Conventions match the
reference exactly:

- ``rvec`` is an angle-axis vector (angle = ||rvec||, axis = rvec/||rvec||).
- Euler convention: ``R = Rz(rz) @ Ry(ry) @ Rx(rx)`` (ZYX), with the IMU
  prior built as euler(roll, pitch, yaw) (reference: src/base2d/image.cc:33-37,
  README.md:126-127).

All functions are shape-polymorphic over leading batch dims via plain
broadcasting and are jit/vmap-safe (no data-dependent control flow).
"""

import jax.numpy as jnp


def rotmat_from_rvec(rvec):
    """Angle-axis -> rotation matrix (Rodrigues). rvec: (..., 3) -> (..., 3, 3).

    Uses the numerically stable small-angle form: for theta -> 0 the
    sin(theta)/theta and (1-cos)/theta^2 factors are replaced by their Taylor
    limits, so gradients are clean at the identity.
    """
    theta2 = jnp.sum(rvec * rvec, axis=-1)[..., None, None]
    theta = jnp.sqrt(theta2)
    # Guarded factors a = sin(t)/t, b = (1 - cos(t))/t^2.
    small = theta2 < 1e-12
    safe_theta = jnp.where(small, jnp.ones_like(theta), theta)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(safe_theta) / safe_theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(safe_theta)) / jnp.where(small, 1.0, theta2))
    K = skew(rvec)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=rvec.dtype), K.shape)
    return eye + a * K + b * (K @ K)


def rvec_from_rotmat(R):
    """Rotation matrix -> angle-axis. R: (..., 3, 3) -> (..., 3).

    Robust across the full angle range incl. theta ~ pi, using the
    quaternion route (stable for all cases, branch-free via jnp.where).
    """
    q = quat_from_rotmat(R)
    return rvec_from_quat(q)


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    rows = [
        jnp.stack([zero, -z, y], axis=-1),
        jnp.stack([z, zero, -x], axis=-1),
        jnp.stack([-y, x, zero], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def quat_from_rotmat(R):
    """(..., 3, 3) -> unit quaternion (..., 4) as (w, x, y, z).

    Branch-free Shepperd's method: compute all four candidate constructions
    and select the one with the largest pivot (best conditioning).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates, each scaled by 4*component^2 (>= 0).
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 0.0))

    # Candidate quaternions (unnormalized) built from each pivot.
    sw = safe_sqrt(qw2)
    cand_w = jnp.stack([sw * sw, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    sx = safe_sqrt(qx2)
    cand_x = jnp.stack([m21 - m12, sx * sx, m01 + m10, m02 + m20], axis=-1)
    sy = safe_sqrt(qy2)
    cand_y = jnp.stack([m02 - m20, m01 + m10, sy * sy, m12 + m21], axis=-1)
    sz = safe_sqrt(qz2)
    cand_z = jnp.stack([m10 - m01, m02 + m20, m12 + m21, sz * sz], axis=-1)

    pivots = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)
    best = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([cand_w, cand_x, cand_y, cand_z], axis=-2)  # (..., 4, 4)
    q = jnp.take_along_axis(cands, best[..., None, None].astype(jnp.int32), axis=-2)[..., 0, :]
    norm = jnp.linalg.norm(q, axis=-1, keepdims=True)
    q = q / jnp.maximum(norm, 1e-20)
    # Canonicalize to w >= 0.
    q = jnp.where(q[..., 0:1] < 0, -q, q)
    return q


def rvec_from_quat(q):
    """Unit quaternion (w,x,y,z) -> angle-axis (..., 3)."""
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    sin_half = jnp.linalg.norm(v, axis=-1)
    angle = 2.0 * jnp.arctan2(sin_half, w)
    small = sin_half < 1e-12
    scale = jnp.where(small, 2.0, angle / jnp.where(small, 1.0, sin_half))
    return v * scale[..., None]


def rotmat_from_euler(rx, ry, rz):
    """Euler angles -> R = Rz(rz) @ Ry(ry) @ Rx(rx). Scalars or broadcastable arrays.

    Matches reference src/base3d/projection.cc:39-55.
    """
    rx, ry, rz = jnp.asarray(rx), jnp.asarray(ry), jnp.asarray(rz)
    cx, sx = jnp.cos(rx), jnp.sin(rx)
    cy, sy = jnp.cos(ry), jnp.sin(ry)
    cz, sz = jnp.cos(rz), jnp.sin(rz)
    r00 = cz * cy
    r01 = cz * sy * sx - sz * cx
    r02 = cz * sy * cx + sz * sx
    r10 = sz * cy
    r11 = sz * sy * sx + cz * cx
    r12 = sz * sy * cx - cz * sx
    r20 = -sy
    r21 = cy * sx
    r22 = cy * cx
    rows = [
        jnp.stack([r00, r01, r02], axis=-1),
        jnp.stack([r10, r11, r12], axis=-1),
        jnp.stack([r20, r21, r22], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def euler_from_rotmat(R):
    """R -> (rx, ry, rz) under R = Rz Ry Rx. Matches reference projection.cc:26-37."""
    rx = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    ry = jnp.arctan2(
        -R[..., 2, 0], jnp.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2)
    )
    rz = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return rx, ry, rz


def rvec_from_euler(roll, pitch, yaw):
    """IMU (roll, pitch, yaw) -> angle-axis rvec (reference src/base2d/image.cc:33-37)."""
    return rvec_from_rotmat(rotmat_from_euler(roll, pitch, yaw))


def rotate_points(rvec, points):
    """Rotate (..., N, 3) points by (..., 3) angle-axis: R @ p."""
    R = rotmat_from_rvec(rvec)
    return points @ jnp.swapaxes(R, -1, -2)
