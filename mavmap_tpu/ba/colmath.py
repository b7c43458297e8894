"""Column-arithmetic residuals, Jacobians, and block products for BA.

Layout note: the straightforward formulation of per-observation
Jacobians — vmap(jacfwd(residual)) producing (O, 2, 6) tensors and
einsum("oki,okj->oij") products — forces XLA into tiny-minor-dimension
layouts. This module computes the same quantities as pure elementwise
arithmetic over (O,) COLUMNS, which XLA fuses into a handful of
bandwidth-bound kernels:

  - the rotation is expanded to its 9 Rodrigues component columns;
  - d(xc)/d(rvec) and the projection Jacobian come from jax.jvp with basis
    tangents over elementwise functions (exact, still autodiff — works for
    all three camera models incl. distortion without hand-derived math);
  - all small matrix products (J^T W J blocks, couplings, matvec pieces)
    are unrolled Python loops over columns, stacked once at the end into
    flat (O, K) arrays for the segment reductions.

Matches the cost model of reference bundle_adjustment.cc:289-387 (autodiff
BACostFunction) exactly; regression-tested against the jacfwd path.
"""

import jax
import jax.numpy as jnp

from ..models import camera as cam


def rodrigues_cols(r1, r2, r3, eps=1e-12):
    """Rotation matrix entries as 9 columns from rvec columns.

    R = cos(t) I + sinc(t) [r]_x + (1-cos t)/t^2 rr^T with Taylor guards.
    """
    t2 = r1 * r1 + r2 * r2 + r3 * r3
    t = jnp.sqrt(jnp.maximum(t2, eps * eps))
    small = t2 < 1e-8
    a = jnp.cos(t)
    b = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(t) / t)         # sinc
    c = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - a) / jnp.maximum(t2, eps))
    R00 = a + c * r1 * r1
    R01 = c * r1 * r2 - b * r3
    R02 = c * r1 * r3 + b * r2
    R10 = c * r1 * r2 + b * r3
    R11 = a + c * r2 * r2
    R12 = c * r2 * r3 - b * r1
    R20 = c * r1 * r3 - b * r2
    R21 = c * r2 * r3 + b * r1
    R22 = a + c * r3 * r3
    return [R00, R01, R02, R10, R11, R12, R20, R21, R22]


def _rotate_cols(rvec3, X3):
    """xc columns = R(rvec) X as elementwise column arithmetic."""
    R = rodrigues_cols(rvec3[0], rvec3[1], rvec3[2])
    x = R[0] * X3[0] + R[1] * X3[1] + R[2] * X3[2]
    y = R[3] * X3[0] + R[4] * X3[1] + R[5] * X3[2]
    z = R[6] * X3[0] + R[7] * X3[1] + R[8] * X3[2]
    return [x, y, z], R


def _world2image_multicode(xc, codes, params, eps=1e-12):
    """world2image with PER-OBSERVATION model codes: evaluate the three
    (elementwise) models on columns and select — cheap, keeps everything
    fusable. Matches models/camera.py world2image per model exactly.

    xc: (O, 3); codes: (O,) int32; params: (O, 9). Returns (O, 2)."""
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    fx, fy = params[:, 0], params[:, 1]
    cx, cy = params[:, 2], params[:, 3]
    k1, k2 = params[:, 4], params[:, 5]
    p1, p2 = params[:, 6], params[:, 7]
    xi = params[:, 8]

    def safe(d):
        return jnp.where(jnp.abs(d) < eps, eps, d)

    # PINHOLE / OPENCV share the z-plane normalization.
    zs = safe(z)
    u0, v0 = x / zs, y / zs

    def distort(u, v):
        r2 = u * u + v * v
        radial = k1 * r2 + k2 * r2 * r2
        du = u * radial + 2.0 * p1 * u * v + p2 * (r2 + 2.0 * u * u)
        dv = v * radial + 2.0 * p2 * u * v + p1 * (r2 + 2.0 * v * v)
        return u + du, v + dv

    u_cv, v_cv = distort(u0, v0)

    # CATA: mirror-offset normalization then the same distortion.
    nrm = jnp.sqrt(x * x + y * y + z * z)
    zz = safe(z + xi * nrm)
    u_ca, v_ca = distort(x / zz, y / zz)

    pin = codes == cam.PINHOLE
    ocv = codes == cam.OPENCV
    u = jnp.where(pin, u0, jnp.where(ocv, u_cv, u_ca))
    v = jnp.where(pin, v0, jnp.where(ocv, v_cv, v_ca))
    return jnp.stack([fx * u + cx, fy * v + cy], axis=-1)


def _project(xc_cols, codes, params):
    """Projection as a function of xc columns (for jvp)."""
    xc = jnp.stack(xc_cols, axis=-1)
    return _world2image_multicode(xc, codes, params)


def residual_cols(poses_o, X_o, cams_o, codes_o, uv_o):
    """Residual columns only (primal, no Jacobians) — for cost evaluation."""
    rv = [poses_o[:, 0], poses_o[:, 1], poses_o[:, 2]]
    X3 = [X_o[:, 0], X_o[:, 1], X_o[:, 2]]
    xcR, _ = _rotate_cols(rv, X3)
    xc = [xcR[i] + poses_o[:, 3 + i] for i in range(3)]
    uv_pred = _project(xc, codes_o, cams_o)
    return [uv_pred[:, 0] - uv_o[:, 0], uv_pred[:, 1] - uv_o[:, 1]]


def residual_jacobian_cols(poses_o, X_o, cams_o, codes_o, uv_o,
                           with_intrinsics=False):
    """Per-observation residual + Jacobian columns.

    poses_o (O,6), X_o (O,3), cams_o (O,9), codes_o (O,), uv_o (O,2) — all
    pre-gathered. Returns (r2, Jc, Jp[, Jk]):
      r2: [ru, rv] columns;
      Jc: 2x6 list-of-lists of columns (rows u,v; cols rvec+tvec);
      Jp: 2x3 list-of-lists (cols X);
      Jk: 2x9 list-of-lists (cols intrinsics), only if with_intrinsics.
    """
    rv = [poses_o[:, 0], poses_o[:, 1], poses_o[:, 2]]
    tv = [poses_o[:, 3], poses_o[:, 4], poses_o[:, 5]]
    X3 = [X_o[:, 0], X_o[:, 1], X_o[:, 2]]
    O = poses_o.shape[0]

    xcR, R = _rotate_cols(rv, X3)
    xc = [xcR[i] + tv[i] for i in range(3)]

    # d(R X)/d(rvec): three jvps of the elementwise rotate (exact fwd-mode).
    ones = jnp.ones((O,), poses_o.dtype)
    zeros = jnp.zeros((O,), poses_o.dtype)
    A = [[None] * 3 for _ in range(3)]  # A[i][j] = d xc_i / d rvec_j
    for j in range(3):
        tan = [zeros, zeros, zeros]
        tan[j] = ones
        _, dxc = jax.jvp(lambda r3: _rotate_cols(r3, X3)[0], (rv,), (tan,))
        for i in range(3):
            A[i][j] = dxc[i]

    # Projection value + Jacobian wrt xc: three jvps of the elementwise
    # multi-model projection.
    uv_pred, _ = jax.jvp(lambda c: _project(c, codes_o, cams_o),
                         (xc,), ([zeros, zeros, zeros],))
    Jproj = [[None] * 3 for _ in range(2)]  # (2, 3)
    for j in range(3):
        tan = [zeros, zeros, zeros]
        tan[j] = ones
        _, duv = jax.jvp(lambda c: _project(c, codes_o, cams_o), (xc,), (tan,))
        Jproj[0][j] = duv[:, 0]
        Jproj[1][j] = duv[:, 1]

    r2 = [uv_pred[:, 0] - uv_o[:, 0], uv_pred[:, 1] - uv_o[:, 1]]

    # Jc = [Jproj @ A | Jproj]  (2 x 6); Jp = Jproj @ R  (2 x 3).
    Jc = [[None] * 6 for _ in range(2)]
    Jp = [[None] * 3 for _ in range(2)]
    for k in range(2):
        for j in range(3):
            Jc[k][j] = (Jproj[k][0] * A[0][j] + Jproj[k][1] * A[1][j]
                        + Jproj[k][2] * A[2][j])
            Jc[k][3 + j] = Jproj[k][j]
            Jp[k][j] = (Jproj[k][0] * R[3 * 0 + j] + Jproj[k][1] * R[3 * 1 + j]
                        + Jproj[k][2] * R[3 * 2 + j])

    if not with_intrinsics:
        return r2, Jc, Jp

    # Jk: nine jvps of the projection wrt the 9 intrinsics columns.
    xcs = jnp.stack(xc, axis=-1)
    Jk = [[None] * 9 for _ in range(2)]
    Z = jnp.zeros_like(cams_o)
    for j in range(9):
        tan = Z.at[:, j].set(1.0)
        _, duv = jax.jvp(lambda kp: _world2image_multicode(xcs, codes_o, kp),
                         (cams_o,), (tan,))
        Jk[0][j] = duv[:, 0]
        Jk[1][j] = duv[:, 1]
    return r2, Jc, Jp, Jk


# --------------------------------------------------------- block products


def stack_cols(cols):
    """List of (O,) columns -> (O, K) array (for SMALL K in fused loops)."""
    return jnp.stack(cols, axis=-1)


def stack_cols_wide(cols):
    """List of (O,) columns -> (O, K) for WIDE K (the big per-observation
    contribution blocks).

    Stacks along axis 0 then transposes: concatenating many (O, 1) pieces
    can make XLA materialize each as a padded (O, 1) temp; the transpose
    is a single relayout. For the small in-loop stacks (K=3/6) the
    axis=-1 form fuses better — use stack_cols there."""
    return jnp.stack(cols, axis=0).T


def jtwj_cols(J1, J2, w):
    """Columns of J1^T diag(w) J2 summed over the 2 residual rows.

    J1: 2 x m, J2: 2 x n lists of columns -> m*n columns (row-major)."""
    m, n = len(J1[0]), len(J2[0])
    out = []
    for i in range(m):
        for j in range(n):
            out.append(w * (J1[0][i] * J2[0][j] + J1[1][i] * J2[1][j]))
    return out


def jtwr_cols(J, r2, w):
    """Columns of J^T diag(w) r (m entries)."""
    return [w * (J[0][i] * r2[0] + J[1][i] * r2[1]) for i in range(len(J[0]))]


def matmul_cols(Aflat, Bflat, m, k, n):
    """Row-major flat column lists: (m,k) @ (k,n) -> (m,n) flat columns."""
    out = []
    for i in range(m):
        for j in range(n):
            acc = Aflat[i * k + 0] * Bflat[0 * n + j]
            for kk in range(1, k):
                acc = acc + Aflat[i * k + kk] * Bflat[kk * n + j]
            out.append(acc)
    return out


def matvec_cols(Aflat, x, m, k):
    """(m,k) flat columns @ (k,) column list -> m columns."""
    return [sum(Aflat[i * k + kk] * x[kk] for kk in range(k))
            for i in range(m)]


def matTvec_cols(Aflat, x, m, k):
    """(m,k)^T flat columns @ (m,) columns -> k columns."""
    return [sum(Aflat[i * k + kk] * x[i] for i in range(m))
            for kk in range(k)]


def abt_cols(Aflat, Bflat, m, k, n):
    """(m,k) @ (n,k)^T -> (m,n) flat columns."""
    out = []
    for i in range(m):
        for j in range(n):
            acc = Aflat[i * k + 0] * Bflat[j * k + 0]
            for kk in range(1, k):
                acc = acc + Aflat[i * k + kk] * Bflat[j * k + kk]
            out.append(acc)
    return out


def cols_of(arr):
    """(O, K) array -> list of K columns."""
    return [arr[:, i] for i in range(arr.shape[1])]


def inv3x3_cols(Vflat):
    """Closed-form inverse of flat 3x3 columns (list of 9 -> list of 9)."""
    a, b, c, d, e, f, g, h, i = Vflat
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    return [A * inv_det, B * inv_det, C * inv_det,
            D * inv_det, E * inv_det, F * inv_det,
            G * inv_det, H * inv_det, I * inv_det]
