"""Batched camera models: PINHOLE (code 1), OPENCV (2), CATA (3).

Counterpart of reference src/base3d/camera_models.{h,cc}. The
reference implements each model as a C++ template dispatched by a runtime
switch (camera_models.h:375-423); here each model is a pure jnp function
over an (N, 2)/(N, 3) batch of points, dispatched with `jax.lax.switch` on a
traced model code so a mixed-model rig can still live under one jit.

Parameter vectors are fixed-width (MAX_CAM_PARAMS = 9), zero-padded, with
ordering matching the reference exactly:

- PINHOLE: fx, fy, cx, cy                      (camera_models.h:104-147)
- OPENCV:  fx, fy, cx, cy, k1, k2, p1, p2      (camera_models.h:163-244)
- CATA:    fx, fy, cx, cy, k1, k2, p1, p2, xi  (camera_models.h:270-359)

`image2world` returns points on the normalized plane (z=1) for PINHOLE and
OPENCV and on the unit-sphere lift for CATA, exactly like the reference, so
downstream geometry (epipolar / triangulation) can divide by z to obtain
normalized coords.

All functions are differentiable (jax autodiff replaces Ceres autodiff for
bundle adjustment) — the iterative undistortion uses a fixed 10-iteration
`fori_loop`, matching the reference's fixed-point scheme.
"""

import jax
import jax.numpy as jnp

PINHOLE = 1
OPENCV = 2
CATA = 3

MAX_CAM_PARAMS = 9

CAMERA_MODEL_CODES = {"PINHOLE": PINHOLE, "OPENCV": OPENCV, "CATA": CATA}
CAMERA_MODEL_NAMES = {v: k for k, v in CAMERA_MODEL_CODES.items()}
CAMERA_MODEL_NUM_PARAMS = {PINHOLE: 4, OPENCV: 8, CATA: 9}


def camera_model_code(name: str) -> int:
    """Model name (or numeric code string) -> integer code
    (reference camera_models.cc:12-21). Numeric codes are accepted so
    imagedataout.txt (which stores codes, like the reference's writer)
    round-trips through the reader."""
    name = name.strip()
    if name.lstrip("+-").isdigit():
        code = int(name)
        if code not in CAMERA_MODEL_NAMES:
            raise KeyError(f"unknown camera model code {code}")
        return code
    return CAMERA_MODEL_CODES[name.upper()]


def camera_model_name(code: int) -> str:
    return CAMERA_MODEL_NAMES[int(code)]


def pad_params(params, dtype=jnp.float32):
    """Pad a parameter list/array to MAX_CAM_PARAMS with zeros."""
    p = jnp.zeros((MAX_CAM_PARAMS,), dtype=dtype)
    params = jnp.asarray(params, dtype=dtype)
    return p.at[: params.shape[0]].set(params)


def _distortion(uv, params):
    """Radial (k1,k2) + tangential (p1,p2) distortion delta for normalized uv.

    Shared by OPENCV and CATA (reference camera_models.h:222-243, 341-358).
    uv: (..., 2) -> (..., 2).
    """
    k1, k2, p1, p2 = params[4], params[5], params[6], params[7]
    u, v = uv[..., 0], uv[..., 1]
    u2 = u * u
    v2 = v * v
    uvp = u * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    du = u * radial + 2.0 * p1 * uvp + p2 * (r2 + 2.0 * u2)
    dv = v * radial + 2.0 * p2 * uvp + p1 * (r2 + 2.0 * v2)
    return jnp.stack([du, dv], axis=-1)


def _undistort(uv, params, num_iterations=10):
    """Fixed-point inverse of `_distortion` (reference camera_models.h:205-218)."""

    def body(_, xx):
        return uv - _distortion(xx, params)

    return jax.lax.fori_loop(0, num_iterations, body, uv)


def _to_pixels(uv, params):
    f = params[:2]
    c = params[2:4]
    return uv * f + c


def _from_pixels(uv_px, params):
    f = params[:2]
    c = params[2:4]
    return (uv_px - c) / f


# --- per-model world2image: points (..., 3) camera-frame -> (..., 2) pixels ---


def _pinhole_world2image(points, params, eps):
    z = points[..., 2:3]
    safe_z = jnp.where(jnp.abs(z) < eps, eps, z)
    uv = points[..., :2] / safe_z
    return _to_pixels(uv, params)


def _opencv_world2image(points, params, eps):
    z = points[..., 2:3]
    safe_z = jnp.where(jnp.abs(z) < eps, eps, z)
    uv = points[..., :2] / safe_z
    uv = uv + _distortion(uv, params)
    return _to_pixels(uv, params)


def _cata_world2image(points, params, eps):
    xi = params[8]
    norm = jnp.linalg.norm(points, axis=-1, keepdims=True)
    zz = points[..., 2:3] + xi * norm
    safe_zz = jnp.where(jnp.abs(zz) < eps, eps, zz)
    uv = points[..., :2] / safe_zz
    uv = uv + _distortion(uv, params)
    return _to_pixels(uv, params)


# --- per-model image2world: pixels (..., 2) -> (..., 3) ray points ---


def _pinhole_image2world(uv_px, params):
    uv = _from_pixels(uv_px, params)
    return jnp.concatenate([uv, jnp.ones_like(uv[..., :1])], axis=-1)


def _opencv_image2world(uv_px, params):
    uv = _undistort(_from_pixels(uv_px, params), params)
    return jnp.concatenate([uv, jnp.ones_like(uv[..., :1])], axis=-1)


def _cata_image2world(uv_px, params):
    xi = params[8]
    uv = _undistort(_from_pixels(uv_px, params), params)
    r2 = jnp.sum(uv * uv, axis=-1, keepdims=True)
    # Sphere lift (reference camera_models.h:330-338); the xi == 1 branch of
    # the reference is the analytic limit of the general formula — use the
    # general one with a guard so it stays branch-free and differentiable.
    denom = xi + jnp.sqrt(jnp.maximum(1.0 + (1.0 - xi * xi) * r2, 0.0))
    z = jnp.where(
        jnp.abs(denom) < 1e-12,
        (1.0 - r2) / 2.0,
        1.0 - xi * (r2 + 1.0) / jnp.where(jnp.abs(denom) < 1e-12, 1.0, denom),
    )
    return jnp.concatenate([uv, z], axis=-1)


def world2image(points, model_code, params, eps=1e-12):
    """Camera-frame points -> pixel coords under the given model.

    points: (..., 3); model_code: python int or traced int32 scalar;
    params: (MAX_CAM_PARAMS,). Returns (..., 2).
    """
    if isinstance(model_code, int):
        fn = {
            PINHOLE: _pinhole_world2image,
            OPENCV: _opencv_world2image,
            CATA: _cata_world2image,
        }[model_code]
        return fn(points, params, eps)
    return jax.lax.switch(
        jnp.asarray(model_code, jnp.int32) - 1,
        [
            lambda p: _pinhole_world2image(p, params, eps),
            lambda p: _opencv_world2image(p, params, eps),
            lambda p: _cata_world2image(p, params, eps),
        ],
        points,
    )


def image2world(uv_px, model_code, params):
    """Pixel coords -> ray points in the camera frame (z=1 plane or sphere lift).

    uv_px: (..., 2); params: (MAX_CAM_PARAMS,). Returns (..., 3).
    """
    if isinstance(model_code, int):
        fn = {
            PINHOLE: _pinhole_image2world,
            OPENCV: _opencv_image2world,
            CATA: _cata_image2world,
        }[model_code]
        return fn(uv_px, params)
    return jax.lax.switch(
        jnp.asarray(model_code, jnp.int32) - 1,
        [
            lambda p: _pinhole_image2world(p, params),
            lambda p: _opencv_image2world(p, params),
            lambda p: _cata_image2world(p, params),
        ],
        uv_px,
    )


def image2normalized(uv_px, model_code, params, eps=1e-12):
    """Pixel coords -> normalized plane coords (x/z, y/z)."""
    xyz = image2world(uv_px, model_code, params)
    z = xyz[..., 2:3]
    safe_z = jnp.where(jnp.abs(z) < eps, eps, z)
    return xyz[..., :2] / safe_z


def image2normalized_np(uv_px, model_code, params, eps=1e-12):
    """Host (numpy) mirror of `image2normalized` for per-frame bookkeeping.

    A device round trip (dispatch + pull) for this tiny per-image op
    costs more than the computation; the sequential mapper normalizes
    keypoints on host instead.
    """
    import numpy as np

    uv_px = np.asarray(uv_px, np.float32)
    params = np.asarray(params, np.float32)
    f, c = params[:2], params[2:4]
    uv = (uv_px - c) / f
    model_code = int(model_code)
    if model_code == PINHOLE:
        return uv

    def distortion(xx):
        k1, k2, p1, p2 = params[4], params[5], params[6], params[7]
        u, v = xx[..., 0], xx[..., 1]
        r2 = u * u + v * v
        radial = k1 * r2 + k2 * r2 * r2
        du = u * radial + 2.0 * p1 * u * v + p2 * (r2 + 2.0 * u * u)
        dv = v * radial + 2.0 * p2 * u * v + p1 * (r2 + 2.0 * v * v)
        return np.stack([du, dv], axis=-1)

    xx = uv.copy()
    for _ in range(10):
        xx = uv - distortion(xx)
    uv = xx
    if model_code == OPENCV:
        return uv
    # CATA: sphere lift then projective division.
    xi = params[8]
    r2 = np.sum(uv * uv, axis=-1, keepdims=True)
    denom = xi + np.sqrt(np.maximum(1.0 + (1.0 - xi * xi) * r2, 0.0))
    z = np.where(
        np.abs(denom) < 1e-12,
        (1.0 - r2) / 2.0,
        1.0 - xi * (r2 + 1.0) / np.where(np.abs(denom) < 1e-12, 1.0, denom),
    )
    safe_z = np.where(np.abs(z) < eps, eps, z)
    return uv / safe_z


def normalize_threshold(threshold, params):
    """Pixel threshold -> normalized-coordinate threshold: t / mean(fx, fy).

    Reference: camera_models.cc:47-52.
    """
    return threshold / ((params[0] + params[1]) / 2.0)
