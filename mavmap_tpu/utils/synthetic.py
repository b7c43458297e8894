"""Synthetic UAV-style scenes for tests and benchmarks.

The reference has no dataset in-repo; its tests use synthetic forward-model
fixtures (SURVEY §4). This module scales that pattern to full sequences: a
terrain point cloud with per-point descriptors, a serpentine aerial camera
trajectory, and projected per-image features with configurable pixel noise,
descriptor noise, clutter features, and dropout — enough to drive the whole
mapper end-to-end and score ATE against ground truth.
"""

from dataclasses import dataclass, field

import numpy as np

from ..models import camera as cam
from ..ops.rotation import rotmat_from_euler  # noqa: F401  (convention ref)


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _rvec_from_R(R):
    from ..ops.rotation import rvec_from_rotmat
    import jax.numpy as jnp

    return np.asarray(rvec_from_rotmat(jnp.asarray(R, jnp.float32)))


@dataclass
class SyntheticScene:
    points3D: np.ndarray          # (M, 3) terrain points
    descriptors: np.ndarray       # (M, D) unit-norm per-point descriptors
    rvecs: np.ndarray             # (I, 3) world->cam ground truth
    tvecs: np.ndarray             # (I, 3)
    cam_params: np.ndarray        # (C, 9)
    cam_models: np.ndarray        # (C,)
    image_cameras: np.ndarray     # (I,)
    image_size: tuple             # (width, height)

    def camera_centers(self):
        import jax.numpy as jnp
        from ..ops.rotation import rotmat_from_rvec

        R = np.asarray(rotmat_from_rvec(jnp.asarray(self.rvecs, np.float32)))
        return -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), self.tvecs)


def make_uav_scene(
    num_images=20,
    num_points=2000,
    descriptor_dim=128,
    image_size=(800, 600),
    focal=700.0,
    altitude=30.0,
    extent=60.0,
    overlap_step=2.5,
    rows=2,
    relief=8.0,
    cam_model=cam.PINHOLE,
    distortion=None,
    seed=0,
):
    """Serpentine aerial survey over a terrain patch.

    extent=None sizes the terrain point field to the FLIGHT PLAN (plus one
    frustum margin) so every frame sees points regardless of num_images /
    rows — with a fixed extent, long surveys fly off the textured area and
    registration collapses.
    """
    rng = np.random.default_rng(seed)
    w, h = image_size

    per_row = int(np.ceil(num_images / rows))
    # Row spacing sized for cross-row frustum overlap: at nadir the frustum
    # half-height is ~altitude * (h/2)/focal; step a fraction of that.
    row_step = 0.8 * altitude * (image_size[1] / 2.0) / focal
    half_w = altitude * (w / 2.0) / focal
    half_h = altitude * (h / 2.0) / focal
    if extent is None:
        x_lo, x_hi = -half_w, (per_row - 1) * overlap_step + half_w
        y_lo, y_hi = -half_h, (rows - 1) * row_step + half_h
    else:
        x_lo, x_hi = -extent * 0.2, extent * 1.2
        y_lo, y_hi = -extent * 0.2, extent * 0.7

    pts = np.stack(
        [
            rng.uniform(x_lo, x_hi, num_points),
            rng.uniform(y_lo, y_hi, num_points),
            rng.uniform(0.0, relief, num_points),
        ],
        axis=-1,
    )
    desc = rng.normal(size=(num_points, descriptor_dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    rvecs, tvecs = [], []
    for i in range(num_images):
        r, k = divmod(i, per_row)
        x = k * overlap_step if r % 2 == 0 else (per_row - 1 - k) * overlap_step
        y = r * row_step
        C = np.array([x, y, altitude]) + rng.normal(size=3) * 0.3
        # Nadir-looking camera with small attitude perturbations.
        R = (
            _rot_z(rng.normal() * 0.05)
            @ _rot_x(np.pi + rng.normal() * 0.05)
        )
        t = -R @ C
        rvecs.append(_rvec_from_R(R))
        tvecs.append(t)

    params = np.zeros((1, 9), np.float32)
    params[0, :4] = [focal, focal, w / 2, h / 2]
    if distortion is not None:
        params[0, 4 : 4 + len(distortion)] = distortion
        cam_model = cam.OPENCV

    return SyntheticScene(
        points3D=pts,
        descriptors=desc,
        rvecs=np.array(rvecs, np.float32),
        tvecs=np.array(tvecs, np.float32),
        cam_params=params,
        cam_models=np.array([cam_model], np.int32),
        image_cameras=np.zeros(num_images, np.int32),
        image_size=image_size,
    )


def make_multi_camera_scene(num_images=12, seed=0, **kwargs):
    """Mixed CAM_IDX sequence (BASELINE config: 'multi-camera rig with
    OPENCV distortion model'): odd frames use a second, distorted camera
    with different intrinsics."""
    scene = make_uav_scene(num_images=num_images, seed=seed, **kwargs)
    w, h = scene.image_size
    cam2 = np.zeros((1, 9), np.float32)
    cam2[0, :8] = [620.0, 620.0, w / 2 + 6, h / 2 - 4, -0.15, 0.03, 0.0005, -0.0005]
    scene.cam_params = np.concatenate([scene.cam_params, cam2], axis=0)
    scene.cam_models = np.append(scene.cam_models, np.int32(cam.OPENCV))
    scene.image_cameras = (np.arange(num_images) % 2).astype(np.int32)
    return scene


def make_ba_scene(num_images, num_points, obs_per_image, pixel_noise=0.3,
                  seed=0):
    """Synthetic global-BA problem at a chosen scale: `num_images` PINHOLE
    cameras along a strip, each observing `obs_per_image` points drawn at
    random from a `num_points` cloud (track length ~ num_images *
    obs_per_image / num_points). Returns (poses (I, 6) world->cam, points
    (P, 3), cam_params (1, 9), obs_image, obs_point, obs_uv, pose_states),
    ground truth without perturbation."""
    import jax.numpy as jnp
    from ..ops.rotation import rotmat_from_rvec

    rng = np.random.default_rng(seed)
    I, P = num_images, num_points
    K = np.zeros((1, 9), np.float32)
    K[0, :4] = [700.0, 700.0, 400.0, 300.0]
    X = (rng.normal(size=(P, 3)) * np.array([40, 40, 4])
         + np.array([0, 0, 30])).astype(np.float32)
    i = np.arange(I)
    poses = np.concatenate(
        [rng.normal(size=(I, 3)) * 0.05,
         np.stack([i * 0.4, (i % 7) * 0.5, np.zeros(I)], axis=1)],
        axis=1).astype(np.float32)
    obs_image = np.repeat(i, obs_per_image).astype(np.int32)
    obs_point = np.concatenate(
        [rng.choice(P, obs_per_image, replace=False) for _ in range(I)]
    ).astype(np.int32)
    R = np.asarray(rotmat_from_rvec(jnp.asarray(poses[:, :3])))
    Xc = (np.einsum("oij,oj->oi", R[obs_image], X[obs_point])
          + poses[obs_image, 3:])
    uv = np.asarray(cam.world2image(jnp.asarray(Xc, jnp.float32),
                                    cam.PINHOLE, jnp.asarray(K[0])))
    uv = (uv + rng.normal(size=uv.shape) * pixel_noise).astype(np.float32)
    states = [1, 2] + [0] * (I - 2)  # BA_POSE_FIXED, BA_POSE_FIXED_X, free
    return poses, X, K, obs_image, obs_point, uv, states


def imu_priors(scene: SyntheticScene, noise=0.01, seed=0):
    """Per-image IMU rotation priors: GT rvecs + noise (the 'roll/pitch/yaw
    from imagedata.txt' pathway of the reference)."""
    rng = np.random.default_rng(seed + 7)
    return {
        i: scene.rvecs[i] + rng.normal(size=3).astype(np.float32) * noise
        for i in range(len(scene.rvecs))
    }


def render_features(
    scene: SyntheticScene,
    pixel_noise=0.3,
    descriptor_noise=0.05,
    clutter=50,
    dropout=0.05,
    max_features=None,
    seed=0,
):
    """Project the scene into every image -> list of (keypoints, descriptors).

    Per image: visible points (in frustum + in bounds), pixel noise on
    keypoints, descriptor noise (keeps matchability), `clutter` random
    non-matchable features, and random dropout. Returns (feats_list,
    gt_point_ids_list) where gt ids map each feature row to its source 3-D
    point (-1 for clutter) — used by tests to score match correctness.
    """
    import jax.numpy as jnp
    from ..ops.rotation import rotmat_from_rvec

    rng = np.random.default_rng(seed + 1)
    w, h = scene.image_size
    feats, gt_ids = [], []
    for i in range(len(scene.rvecs)):
        R = np.asarray(rotmat_from_rvec(jnp.asarray(scene.rvecs[i])))
        Xc = scene.points3D @ R.T + scene.tvecs[i]
        ci = scene.image_cameras[i]
        uv = np.asarray(
            cam.world2image(
                jnp.asarray(Xc, jnp.float32),
                int(scene.cam_models[ci]),
                jnp.asarray(scene.cam_params[ci]),
            )
        )
        vis = (
            (Xc[:, 2] > 1.0)
            & (uv[:, 0] >= 0)
            & (uv[:, 0] < w)
            & (uv[:, 1] >= 0)
            & (uv[:, 1] < h)
        )
        idx = np.where(vis)[0]
        if dropout:
            keep = rng.random(len(idx)) > dropout
            idx = idx[keep]
        kp = uv[idx] + rng.normal(size=(len(idx), 2)) * pixel_noise
        de = scene.descriptors[idx] + rng.normal(
            size=(len(idx), scene.descriptors.shape[1])
        ).astype(np.float32) * descriptor_noise
        de /= np.maximum(np.linalg.norm(de, axis=-1, keepdims=True), 1e-12)
        ids = idx.astype(np.int64)

        if clutter:
            ckp = np.stack(
                [rng.uniform(0, w, clutter), rng.uniform(0, h, clutter)], axis=-1
            )
            cde = rng.normal(size=(clutter, scene.descriptors.shape[1])).astype(
                np.float32
            )
            cde /= np.linalg.norm(cde, axis=-1, keepdims=True)
            kp = np.concatenate([kp, ckp], axis=0)
            de = np.concatenate([de, cde], axis=0)
            ids = np.concatenate([ids, np.full(clutter, -1, np.int64)])

        perm = rng.permutation(len(kp))
        kp, de, ids = kp[perm], de[perm], ids[perm]
        if max_features is not None and len(kp) > max_features:
            kp, de, ids = kp[:max_features], de[:max_features], ids[:max_features]
        feats.append((kp.astype(np.float32), de))
        gt_ids.append(ids)
    return feats, gt_ids


def mapper_ate(mapper, scene):
    """ATE RMSE of a mapper's registered camera centers vs scene ground
    truth (similarity-aligned) — the snippet every benchmark needs."""
    import jax.numpy as jnp
    from ..ops.rotation import rotmat_from_rvec

    reg_ids = [iid for iid in range(mapper.store.num_images)
               if mapper.store.image_registered[iid]]
    if len(reg_ids) < 3:
        return np.inf
    idxs = [mapper.image_id_to_idx[iid] for iid in reg_ids]
    R = np.asarray(rotmat_from_rvec(
        jnp.asarray(mapper.store.image_rvecs[reg_ids], jnp.float32)))
    est = -np.einsum("nij,nj->ni", R.transpose(0, 2, 1),
                     mapper.store.image_tvecs[reg_ids])
    return ate_rmse(est, scene.camera_centers()[idxs])


def mapper_ate_profile(mapper, scene, block=100):
    """Per-block ATE profile: ONE global similarity alignment over every
    registered frame, then the RMSE of each contiguous `block` of image
    indices under that alignment — shows WHERE along the survey the global
    error accumulates (uniform ≈ noise-limited; ramping ≈ drift the loop
    closures did not remove). Returns [(start_idx, n_frames, rmse_m)]."""
    import jax.numpy as jnp
    from ..ops.rotation import rotmat_from_rvec
    from ..ops.similarity import solve_umeyama, transform_points

    reg_ids = [iid for iid in range(mapper.store.num_images)
               if mapper.store.image_registered[iid]]
    if len(reg_ids) < 3:
        return []
    idxs = np.array([mapper.image_id_to_idx[iid] for iid in reg_ids])
    R = np.asarray(rotmat_from_rvec(
        jnp.asarray(mapper.store.image_rvecs[reg_ids], jnp.float32)))
    est = -np.einsum("nij,nj->ni", R.transpose(0, 2, 1),
                     mapper.store.image_tvecs[reg_ids])
    gt = scene.camera_centers()[idxs]
    T = solve_umeyama(jnp.asarray(est, jnp.float32),
                      jnp.asarray(gt, jnp.float32))
    aligned = np.asarray(transform_points(T, jnp.asarray(est, jnp.float32)))
    err2 = np.sum((aligned - gt) ** 2, axis=-1)
    out = []
    for s in range(0, int(idxs.max()) + 1, block):
        sel = (idxs >= s) & (idxs < s + block)
        if sel.sum():
            out.append((s, int(sel.sum()), float(np.sqrt(err2[sel].mean()))))
    return out


def ate_rmse(est_centers, gt_centers, mask=None):
    """Absolute trajectory error after similarity alignment (Umeyama)."""
    import jax.numpy as jnp
    from ..ops.similarity import solve_umeyama, transform_points

    if mask is not None:
        est_centers = est_centers[mask]
        gt_centers = gt_centers[mask]
    if len(est_centers) < 3:
        return np.inf
    T = solve_umeyama(
        jnp.asarray(est_centers, jnp.float32), jnp.asarray(gt_centers, jnp.float32)
    )
    aligned = np.asarray(transform_points(T, jnp.asarray(est_centers, jnp.float32)))
    return float(np.sqrt(np.mean(np.sum((aligned - gt_centers) ** 2, axis=-1))))


def render_images(scene: SyntheticScene, texture_size=2048,
                  texture_contrast=1.0, seed=0):
    """Render grayscale IMAGES of a textured flat ground plane (z=0) for
    every camera — lets tests drive the on-device detector + full pipeline
    from pixels, which feature-table fixtures cannot.

    The ground texture is smoothed random noise (blob-rich, so the DoH
    detector finds repeatable features). Each image pixel is inverse-warped
    to the plane (exact for flat terrain) and bilinearly sampled; the
    scene's 3-D points are additionally painted as consistent-intensity
    Gaussian splats at their true projections, so the imaged structure is
    NOT purely planar (a perfectly planar scene trips the homography
    degeneracy gate, exactly as it would in the reference).
    Returns a list of (H, W) uint8 arrays.
    """
    import jax.numpy as jnp
    from ..ops.rotation import rotmat_from_rvec

    rng = np.random.default_rng(seed + 3)
    w, h = scene.image_size

    # Smooth random texture: low-res noise, bicubic-ish upsample by FFT pad.
    base = rng.normal(size=(texture_size // 8, texture_size // 8))
    # Separable box smoothing + nearest upsample + second smoothing.
    k = np.ones(5) / 5.0
    for axis in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), axis, base)
    tex = np.kron(base, np.ones((8, 8)))
    for axis in (0, 1):
        tex = np.apply_along_axis(
            lambda m: np.convolve(m, np.ones(9) / 9.0, mode="same"), axis, tex)
    tex -= tex.min()
    tex = (tex / max(tex.max(), 1e-9) * 255.0).astype(np.float32)
    # Low contrast keeps the (planar) ground texture below the detector's
    # response threshold relative to the off-plane point splats.
    tex = 127.5 + (tex - 127.5) * texture_contrast

    # Texture covers the flight-plan ground footprint with margin.
    C = scene.camera_centers()
    half = 1.2 * np.max(C[:, 2]) * max(w, h) / 2.0 / float(scene.cam_params[0][0])
    x0, x1 = C[:, 0].min() - half, C[:, 0].max() + half
    y0, y1 = C[:, 1].min() - half, C[:, 1].max() + half

    def sample(gx, gy):
        u = (gx - x0) / (x1 - x0) * (tex.shape[1] - 2)
        v = (gy - y0) / (y1 - y0) * (tex.shape[0] - 2)
        u = np.clip(u, 0, tex.shape[1] - 2)
        v = np.clip(v, 0, tex.shape[0] - 2)
        ui, vi = u.astype(int), v.astype(int)
        fu, fv = u - ui, v - vi
        return (
            tex[vi, ui] * (1 - fu) * (1 - fv)
            + tex[vi, ui + 1] * fu * (1 - fv)
            + tex[vi + 1, ui] * (1 - fu) * fv
            + tex[vi + 1, ui + 1] * fu * fv
        )

    fx, fy, cx, cy = (float(v) for v in scene.cam_params[0][:4])
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    rays = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)

    # Per-point splat appearance (consistent across views): 3 offset lobes
    # per point make each splat locally DISTINCTIVE — radially symmetric
    # blobs all look alike and die in the matcher's ratio test.
    n_pts = len(scene.points3D)
    n_lobes = 3
    splat_amp = (rng.uniform(50, 110, (n_pts, n_lobes))
                 * rng.choice([-1, 1], (n_pts, n_lobes)))
    splat_sig = rng.uniform(1.2, 2.6, (n_pts, n_lobes))
    splat_off = rng.uniform(-4.0, 4.0, (n_pts, n_lobes, 2))
    splat_off[:, 0] = 0.0  # first lobe centered (keypoint stays on-point)

    images = []
    yy, xx = np.mgrid[-7:8, -7:8]
    for i in range(len(scene.rvecs)):
        R = np.asarray(rotmat_from_rvec(jnp.asarray(scene.rvecs[i])))
        Ci = -R.T @ scene.tvecs[i]
        d = rays @ R  # world-frame ray directions (R^T applied rowwise)
        tplane = -Ci[2] / d[..., 2]
        gx = Ci[0] + tplane * d[..., 0]
        gy = Ci[1] + tplane * d[..., 1]
        img = sample(gx, gy)

        # Paint off-plane 3-D points as Gaussian splats.
        Xc = scene.points3D @ R.T + scene.tvecs[i]
        vis = Xc[:, 2] > 1.0
        u = fx * Xc[:, 0] / np.maximum(Xc[:, 2], 1e-6) + cx
        v = fy * Xc[:, 1] / np.maximum(Xc[:, 2], 1e-6) + cy
        vis &= (u >= 8) & (u < w - 8) & (v >= 8) & (v < h - 8)
        for pid in np.where(vis)[0]:
            ui, vi = int(round(u[pid])), int(round(v[pid]))
            for l in range(n_lobes):
                du = u[pid] + splat_off[pid, l, 0]
                dv = v[pid] + splat_off[pid, l, 1]
                g = splat_amp[pid, l] * np.exp(
                    -((xx + ui - du) ** 2 + (yy + vi - dv) ** 2)
                    / (2 * splat_sig[pid, l] ** 2)
                )
                img[vi - 7 : vi + 8, ui - 7 : ui + 8] += g
        images.append(np.clip(img, 0, 255).astype(np.uint8))
    return images


def sample_photo_paths():
    """Real photographs bundled with installed packages (zero-egress
    container): sklearn's china/flower and matplotlib's grace_hopper."""
    import glob
    import os

    cands = []
    try:
        import sklearn

        root = os.path.dirname(sklearn.__file__)
        cands += glob.glob(os.path.join(root, "datasets", "images", "*.jpg"))
    except Exception:
        pass
    try:
        import matplotlib

        root = os.path.join(os.path.dirname(matplotlib.__file__),
                            "mpl-data", "sample_data")
        cands += glob.glob(os.path.join(root, "grace_hopper.jpg"))
    except Exception:
        pass
    return sorted(p for p in cands if os.path.getsize(p) > 30_000)


def render_photo_survey(scene: SyntheticScene, relief_amp=4.0, seed=0):
    """Render the survey over REAL photographic terrain texture.

    Unlike render_images (synthetic blob texture + painted splats), the
    ground here is a mirror-tiled collage of real photographs draped over a
    smooth HEIGHT FIELD; every feature the detector finds is real image
    content, and the parallax from the relief keeps the scene off the
    homography degeneracy gate. Per-pixel ray/terrain intersection runs a
    short fixed-point iteration (relief << altitude so it converges fast).
    Returns a list of (H, W) uint8 images; poses are the scene's ground
    truth. Addresses the 'no real imagery through the detector->pose path'
    gap as far as a zero-egress container allows (real photo content,
    synthetic geometry).
    """
    import jax.numpy as jnp
    from PIL import Image
    from ..ops.rotation import rotmat_from_rvec

    paths = sample_photo_paths()
    if not paths:
        raise RuntimeError("no bundled sample photographs found")
    photos = [np.asarray(Image.open(p).convert("L"), np.float32)
              for p in paths]
    # Equal-height collage strip, then mirror-tile into a big square.
    hmin = min(p.shape[0] for p in photos)
    strip = np.concatenate(
        [p[:hmin] for p in photos] + [p[:hmin, ::-1] for p in photos],
        axis=1)
    rows = [strip if k % 2 == 0 else strip[::-1] for k in range(6)]
    tex = np.concatenate(rows, axis=0)  # (~2.5k, ~5k)

    w, h = scene.image_size
    C = scene.camera_centers()
    half = 1.2 * np.max(C[:, 2]) * max(w, h) / 2.0 / float(scene.cam_params[0][0])
    x0, x1 = C[:, 0].min() - half, C[:, 0].max() + half
    y0, y1 = C[:, 1].min() - half, C[:, 1].max() + half

    def height(gx, gy):
        return relief_amp * (
            np.sin(0.37 * gx) * np.cos(0.41 * gy)
            + 0.6 * np.sin(0.73 * gx + 1.3) * np.sin(0.53 * gy + 0.7)
        )

    def sample(gx, gy):
        u = (gx - x0) / (x1 - x0) * (tex.shape[1] - 2)
        v = (gy - y0) / (y1 - y0) * (tex.shape[0] - 2)
        u = np.clip(u, 0, tex.shape[1] - 2)
        v = np.clip(v, 0, tex.shape[0] - 2)
        ui, vi = u.astype(int), v.astype(int)
        fu, fv = u - ui, v - vi
        val = (
            tex[vi, ui] * (1 - fu) * (1 - fv)
            + tex[vi, ui + 1] * fu * (1 - fv)
            + tex[vi + 1, ui] * (1 - fu) * fv
            + tex[vi + 1, ui + 1] * fu * fv
        )
        # Slow world-anchored brightness modulation breaks the tiling
        # periodicity (mirror-tiled repeats would otherwise die in the
        # matcher's ratio test as ambiguous).
        return val * (0.82 + 0.18 * np.sin(0.11 * gx + 0.07 * gy))

    fx, fy, cx, cy = (float(v) for v in scene.cam_params[0][:4])
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    rays = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)

    images = []
    for i in range(len(scene.rvecs)):
        R = np.asarray(rotmat_from_rvec(jnp.asarray(scene.rvecs[i])))
        Ci = -R.T @ scene.tvecs[i]
        d = rays @ R
        dz = np.where(np.abs(d[..., 2]) < 1e-6, 1e-6, d[..., 2])
        t = -Ci[2] / dz  # flat-ground init
        for _ in range(4):  # fixed point on the height field
            gx = Ci[0] + t * d[..., 0]
            gy = Ci[1] + t * d[..., 1]
            t = (height(gx, gy) - Ci[2]) / dz
        gx = Ci[0] + t * d[..., 0]
        gy = Ci[1] + t * d[..., 1]
        images.append(np.clip(sample(gx, gy), 0, 255).astype(np.uint8))
    return images
