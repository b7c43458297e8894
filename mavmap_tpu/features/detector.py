"""On-device SURF-style feature detection + description in pure JAX.

Counterpart of reference src/base2d/feature.{h,cc}
(AdaptiveSURF). The reference uses OpenCV's integral-image box-filter SURF
with a per-cell adaptive Hessian threshold (feature.cc:180-309). Integral-
image tricks are a CPU optimization; on an accelerator the idiomatic
formulation is:

  - scale space via separable Gaussian(-derivative) convolutions (banded
    matmuls, fused by XLA);
  - determinant-of-Hessian response det = Lxx Lyy - (0.9 Lxy)^2 per scale
    (the classic SURF response, Bay et al.);
  - 3x3x3 non-max suppression entirely as tensor ops;
  - per-cell top-K selection over a fixed grid replacing the reference's
    iterative per-cell threshold adaptation (same goal — spatially uniform
    feature coverage — without the data-dependent loop);
  - SURF-128 descriptor: 4x4 spatial cells x (sum dx, sum |dx|, sum dy,
    sum |dy|) split by gradient sign = 128 dims, sampled on a 20s x 20s
    window with bilinear interpolation;
  - orientation assignment (matching OpenCV SURF's default, which the
    reference uses): dominant gradient direction from sigma-spaced
    gradient samples in a 6s radius, Gaussian-weighted, sliding pi/3
    angular window — the descriptor grid and the sampled gradients are
    rotated into the local frame. `upright=True` gives U-SURF (cheaper,
    fine for nadir-only imagery).

Everything below is jit-compiled with static shapes; keypoint counts are
fixed-capacity with validity masks.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp


def _gaussian_kernel1d_np(sigma, radius):
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float64)


def _band_matrix(kern, n):
    """(n, n) banded matrix B with out = img @ B == 1-D correlation of each
    row of img with `kern` under edge-REPLICATE padding (boundary taps fold
    onto the edge columns). Built in numpy at TRACE time (kernels are
    static), embedded as a jit constant.

    Why a matmul and not lax.conv: the matmul unit takes the dense (n, n)
    banded product at full rate, where a single-channel conv lowers to
    sliding windows. Whether separable lax.conv_general_dilated beats it
    on the GPU is ROADMAP S8."""
    r = (len(kern) - 1) // 2
    B = np.zeros((n, n), np.float64)
    cols = np.arange(n)
    for k, kv in enumerate(kern):
        rows = np.clip(cols + k - r, 0, n - 1)
        np.add.at(B, (rows, cols), kv)
    return B


def _hessian_response(img, sigma):
    """Determinant-of-Hessian response at scale sigma (scale-normalized).

    All six separable passes ride TWO matmuls: the three y-direction
    kernels (g, g1, g2) stack into one (3H, H) left operand and the three
    x-direction kernels into one (W, 3W) right operand; Lxx/Lyy/Lxy are
    slices of the (3H, 3W) product's blocks. Edge-replicate padding is
    folded into the band matrices (zero padding would fabricate step
    edges at the border: a constant image must yield zero derivatives —
    phantom responses at coarse octaves reached ~4*sigma*2^o full-res px
    inside, far past the 8-px border suppression)."""
    H, W = img.shape
    radius = max(int(3.0 * sigma + 0.5), 1)
    g = _gaussian_kernel1d_np(sigma, radius)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g1 = -(x / (sigma**2)) * g
    g2 = ((x**2 - sigma**2) / (sigma**4)) * g
    # DC correction: the continuous operator has integral 0, but sampling +
    # tail truncation leave sum(g2) ~ 1e-3 — which turns CONSTANT image
    # regions into DoH responses ~1e-5, above the adaptive floor
    # (hessian/1.5^10), so textureless cells would emit rank-admitted junk.
    # Subtracting the residual times the normalized smoothing kernel keeps
    # the kernel shape and makes flat responses exactly ~0.
    g2 = g2 - g2.sum() * g

    # Left block-stack: rows of [g; g1; g2] bands over H. Right: cols over W.
    By = np.concatenate(
        [_band_matrix(k, H).T for k in (g, g1, g2)], axis=0)  # (3H, H)
    Bx = np.concatenate(
        [_band_matrix(k, W) for k in (g, g1, g2)], axis=1)    # (W, 3W)
    prod = jnp.asarray(By, jnp.float32) @ img @ jnp.asarray(Bx, jnp.float32)
    blk = prod.reshape(3, H, 3, W)
    Lxx = blk[0, :, 2]   # y: g,  x: g2
    Lyy = blk[2, :, 0]   # y: g2, x: g
    Lxy = blk[1, :, 1]   # y: g1, x: g1
    det = Lxx * Lyy - (0.9 * Lxy) ** 2
    return det * sigma**4  # scale normalization


@partial(
    jax.jit,
    static_argnames=(
        "num_octaves", "num_octave_layers", "max_features", "grid_size",
        "upright", "min_per_cell", "adapt_levels",
    ),
)
def detect_and_describe(
    img,
    hessian_threshold=100.0,
    num_octaves=4,
    num_octave_layers=3,
    max_features=2048,
    grid_size=3,
    upright=False,
    cell_thresholds=None,
    min_per_cell=0,
    adapt_levels=10,
):
    """(H, W) grayscale [0, 255] -> (keypoints (K, 2), scales (K,),
    descriptors (K, 128), mask (K,), cell_counts (rows*cols,)).

    K = max_features. Spatial-uniformity: the response map is divided into
    a rows x cols grid (grid_size: int for square, or (rows, cols)) and
    each cell receives an equal share of the keypoint budget (counterpart
    of the reference's adaptive per-cell thresholds, feature.h:24-31,
    surf-adaptive-cell-rows/cols CLI flags).

    Adaptive per-cell thresholds (reference AdaptiveSURF,
    feature.cc:198-309): `cell_thresholds` is an optional (rows*cols,)
    TRACED array of per-cell Hessian thresholds (same units as
    hessian_threshold) — the cross-frame memory lives on host in
    AdaptiveDetector, so every frame reuses one compiled executable. With
    `min_per_cell` > 0 the strongest min_per_cell maxima of a cell are
    admitted even below the cell threshold (the closed-form equivalent of
    the reference's iterative /1.5 threshold lowering — the full response
    map is already computed, so "lower and re-detect" collapses to
    rank-based admission), but never below the QUALITY FLOOR
    hessian_threshold / 1.5^adapt_levels — textureless cells emit nothing
    rather than noise maxima. cell_counts reports per-cell above-threshold
    counts for the host-side adaptation rule.
    """
    H, W = img.shape
    img = img.astype(jnp.float32) / 255.0
    grid_rows, grid_cols = (
        (grid_size, grid_size) if isinstance(grid_size, int) else grid_size
    )

    # Octave-DOWNSAMPLED pyramid: octave o runs at H/2^o x W/2^o with the
    # small base sigmas (1.6..2.5 -> kernels <= ~17 taps), and
    # det * sigma_rel^4 at octave resolution IS the scale-normalized
    # full-resolution response (second derivatives pick up (2^o)^2 each
    # from the coordinate change, so det gains 16^o — exactly the missing
    # (2^o)^4 of the effective sigma's normalization). A full-resolution
    # pyramid needs 123-tap kernels at the top octave, which wastes
    # compute.
    base_sigmas = [1.6 * (2.0 ** (l / num_octave_layers))
                   for l in range(num_octave_layers)]
    sigmas = []          # effective full-res sigma per scale index
    scale_factor = []    # 2^o per scale index
    resp_full = []       # sparse full-res suppressed score maps, one/scale
    dense_full = []      # dense upsampled response maps (sub-pixel fit)
    img_o = img
    for o in range(num_octaves):
        f = 2**o
        Ho, Wo = img_o.shape
        layers = [
            _hessian_response(img_o, s) * 1.0 for s in base_sigmas
        ]  # _hessian_response already applies the sigma^4 normalization
        st = jnp.stack(layers)  # (L, Ho, Wo)
        # 3x3x3 non-max suppression WITHIN the octave (like OpenCV SURF).
        is_max = jnp.ones_like(st, dtype=bool)
        for ds in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if ds == 0 and dy == 0 and dx == 0:
                        continue
                    is_max = is_max & (
                        st >= jnp.roll(st, (ds, dy, dx), axis=(0, 1, 2)))
        # Border suppression at octave resolution (8 full-res px minimum).
        b = max(8 // f, 2)
        yy = jnp.arange(Ho)
        xx = jnp.arange(Wo)
        bm = ((yy[:, None] >= b) & (yy[:, None] < Ho - b)
              & (xx[None, :] >= b) & (xx[None, :] < Wo - b))
        dense = st
        st = jnp.where(is_max & bm[None], st, -jnp.inf)
        # Scatter the surviving maxima onto the full-res grid (strided
        # placement; everything else -inf) — each maximum lands on exactly
        # ONE full-res pixel, so the shared per-cell top-k sees no
        # upsampling plateaus. The DENSE maps ride along nearest-upsampled
        # for the sub-pixel quadratic fit (suppressed maps have -inf
        # neighbors by construction).
        for l in range(num_octave_layers):
            up = jnp.full((H, W), -jnp.inf, jnp.float32)
            up = up.at[: Ho * f : f, : Wo * f : f].set(st[l])
            resp_full.append(up)
            d = jnp.repeat(jnp.repeat(dense[l], f, axis=0), f, axis=1)
            d = d[:H, :W]
            d = jnp.pad(d, ((0, H - d.shape[0]), (0, W - d.shape[1])))
            dense_full.append(d)
            sigmas.append(base_sigmas[l] * f)
            scale_factor.append(f)
        if o + 1 < num_octaves:
            he, we = (Ho // 2) * 2, (Wo // 2) * 2
            a = img_o[:he, :we]
            img_o = 0.25 * (a[::2, ::2] + a[1::2, ::2]
                            + a[::2, 1::2] + a[1::2, 1::2])

    responses = jnp.stack(resp_full)  # (S, H, W) sparse suppressed scores
    responses_dense = jnp.stack(dense_full)
    thr = hessian_threshold * 1e-6
    # Quality floor: the deepest threshold the reference's /1.5 adaptation
    # could reach — maxima below it are noise, never admitted.
    floor = thr * float(1.5 ** (-adapt_levels)) if min_per_cell > 0 else thr
    responses = jnp.where(responses > floor, responses, -jnp.inf)
    score_flat = jnp.max(responses, axis=0)  # best scale per pixel
    best_scale = jnp.argmax(responses, axis=0)

    if cell_thresholds is None:
        cell_thr = jnp.full((grid_rows * grid_cols,), thr, jnp.float32)
    else:
        cell_thr = jnp.asarray(cell_thresholds, jnp.float32) * 1e-6

    # Per-cell top-k.
    per_cell = max_features // (grid_rows * grid_cols)
    cell_h = H // grid_rows
    cell_w = W // grid_cols
    kps, scs, mask_out, counts_out = [], [], [], []
    rank = jnp.arange(per_cell)
    # Fixed-size cells: the H%grid_rows / W%grid_cols remainder strip is
    # not scanned (it lies inside the 8-px suppressed border for realistic
    # grids).
    for cy in range(grid_rows):
        for cx in range(grid_cols):
            y0, x0 = cy * cell_h, cx * cell_w
            cell = jax.lax.dynamic_slice(score_flat, (y0, x0), (cell_h, cell_w))
            cell_scale = jax.lax.dynamic_slice(best_scale, (y0, x0), (cell_h, cell_w))
            flat = cell.reshape(-1)
            vals, idx = jax.lax.top_k(flat, per_cell)
            py = idx // cell_w + y0
            px = idx % cell_w + x0
            kps.append(jnp.stack([px, py], axis=-1))
            scs.append(cell_scale.reshape(-1)[idx])
            ct = cell_thr[cy * grid_cols + cx]
            above = jnp.isfinite(vals) & (vals > ct)
            counts_out.append(jnp.sum(above, dtype=jnp.int32))
            keep = above
            if min_per_cell > 0:
                keep = keep | (jnp.isfinite(vals) & (rank < min_per_cell))
            mask_out.append(keep)
    keypoints = jnp.concatenate(kps).astype(jnp.float32)  # (K', 2) as (x, y)
    scale_idx = jnp.concatenate(scs)
    mask = jnp.concatenate(mask_out)
    cell_counts = jnp.stack(counts_out)

    sigmas_arr = jnp.asarray(sigmas, jnp.float32)
    kp_sigma = sigmas_arr[scale_idx]
    fac_arr = jnp.asarray(scale_factor, jnp.float32)
    kp_fac = fac_arr[scale_idx]

    # Coarse-octave centering: a maximum at octave pixel (x_o, y_o) sits at
    # full-res (x_o + 0.5) * f - 0.5 = grid position + (f - 1) / 2.
    keypoints = keypoints + ((kp_fac - 1.0) * 0.5)[:, None]

    # Sub-pixel localization: 1-D quadratic fits on the sparse response map
    # at the OCTAVE grid stride (neighbors on the same scale sit f apart;
    # non-maxima are -inf, so the fit only engages where both neighbors
    # survived suppression — offsets clamp to +-0.5 octave px).
    fi = kp_fac.astype(jnp.int32)
    ky = jnp.clip(keypoints[:, 1].astype(jnp.int32), 1, H - 2)
    kx = jnp.clip(keypoints[:, 0].astype(jnp.int32), 1, W - 2)
    ky0 = (ky // jnp.maximum(fi, 1)) * jnp.maximum(fi, 1)
    kx0 = (kx // jnp.maximum(fi, 1)) * jnp.maximum(fi, 1)
    r0 = responses_dense[scale_idx, ky0, kx0]
    rxm = responses_dense[scale_idx, ky0, jnp.clip(kx0 - fi, 0, W - 1)]
    rxp = responses_dense[scale_idx, ky0, jnp.clip(kx0 + fi, 0, W - 1)]
    rym = responses_dense[scale_idx, jnp.clip(ky0 - fi, 0, H - 1), kx0]
    ryp = responses_dense[scale_idx, jnp.clip(ky0 + fi, 0, H - 1), kx0]
    dxx = rxm - 2.0 * r0 + rxp
    dyy = rym - 2.0 * r0 + ryp
    okx = jnp.isfinite(rxm) & jnp.isfinite(rxp) & (jnp.abs(dxx) > 1e-12)
    oky = jnp.isfinite(rym) & jnp.isfinite(ryp) & (jnp.abs(dyy) > 1e-12)
    offx = jnp.where(okx, 0.5 * (rxm - rxp) / dxx, 0.0)
    offy = jnp.where(oky, 0.5 * (rym - ryp) / dyy, 0.0)
    offx = jnp.clip(offx, -0.5, 0.5) * kp_fac
    offy = jnp.clip(offy, -0.5, 0.5) * kp_fac
    keypoints = keypoints + jnp.stack([offx, offy], axis=-1)

    desc = _describe(img, keypoints, kp_sigma, upright=upright)
    K = keypoints.shape[0]
    if K < max_features:
        pad = max_features - K
        keypoints = jnp.concatenate([keypoints, jnp.zeros((pad, 2), jnp.float32)])
        kp_sigma = jnp.concatenate([kp_sigma, jnp.ones((pad,), jnp.float32)])
        desc = jnp.concatenate([desc, jnp.zeros((pad, 128), jnp.float32)])
        mask = jnp.concatenate([mask, jnp.zeros((pad,), bool)])
    return keypoints, kp_sigma, desc, mask, cell_counts


def _grad_sampler(gx, gy):
    """Bilinear sampler of BOTH gradient images at shared float coords.

    Packing the 4 bilinear corners of both gradient images into one
    (H*W, 8) table turns 8 scalar takes per sample batch into ONE row
    take — same bytes, 1/8 the indices (a gather's cost grows with its
    index count)."""
    H, W = gx.shape
    f1, f2 = gx.reshape(-1), gy.reshape(-1)
    # Row i: [gx(i), gx(i+1), gy(i), gy(i+1), gx(i+W), gx(i+W+1),
    #         gy(i+W), gy(i+W+1)] — the 2x2 corner stencil at flat index i.
    # Base indices are clamped to y<=H-2, x<=W-2, so the rolled wrap-around
    # rows are never addressed.
    T = jnp.stack([f1, jnp.roll(f1, -1), f2, jnp.roll(f2, -1),
                   jnp.roll(f1, -W), jnp.roll(f1, -(W + 1)),
                   jnp.roll(f2, -W), jnp.roll(f2, -(W + 1))], axis=-1)

    def sample(ys, xs):
        """(gx, gy) sampled at float coords; preserves input shape."""
        shape = ys.shape
        ys, xs = ys.reshape(-1), xs.reshape(-1)
        y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, H - 2)
        x0 = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, W - 2)
        fy = jnp.clip(ys - y0, 0.0, 1.0)
        fx = jnp.clip(xs - x0, 0.0, 1.0)
        v = jnp.take(T, y0 * W + x0, axis=0)  # (N, 8)
        w00 = (1 - fy) * (1 - fx)
        w01 = (1 - fy) * fx
        w10 = fy * (1 - fx)
        w11 = fy * fx
        gxs = v[:, 0] * w00 + v[:, 1] * w01 + v[:, 4] * w10 + v[:, 5] * w11
        gys = v[:, 2] * w00 + v[:, 3] * w01 + v[:, 6] * w10 + v[:, 7] * w11
        return gxs.reshape(shape), gys.reshape(shape)

    return sample


def _orientations(gx, gy, keypoints, sigmas, num_bins=42):
    """Dominant orientation per keypoint (K,) radians — SURF-style.

    Gradient samples on a sigma-spaced 13x13 grid within radius 6*sigma,
    Gaussian-weighted (2.5*sigma); responses binned by angle; a circular
    sliding window of pi/3 sums the response vectors and the window with
    the largest magnitude gives the orientation (Bay et al.; OpenCV SURF
    upright=false — the reference's default configuration).
    """
    sample = _grad_sampler(gx, gy)
    r = jnp.arange(-6, 7, dtype=jnp.float32)  # 13 offsets, units of sigma
    YO, XO = jnp.meshgrid(r, r, indexing="ij")
    disk = (YO**2 + XO**2) <= 36.0 + 1e-6
    wgt = jnp.exp(-(YO**2 + XO**2) / (2.0 * 2.5**2)) * disk  # (13,13)

    win = max(int(round(num_bins / 6.0)), 1)  # pi/3 window in bins
    # Circular sliding-window sum as a fixed (num_bins, num_bins) circulant
    # matmul, and angle binning as a one-hot matmul: per-keypoint
    # segment_sum (scatter) and convolve lower to scatter-adds under vmap;
    # the matmul forms run as dense products instead.
    ii = jnp.arange(num_bins)
    circ = (((ii[None, :] - ii[:, None]) % num_bins) < win).astype(jnp.float32)

    def one(kp, sigma):
        ys = kp[1] + YO * sigma
        xs = kp[0] + XO * sigma
        sgx, sgy = sample(ys, xs)
        dx = (sgx * wgt).reshape(-1)
        dy = (sgy * wgt).reshape(-1)
        theta = jnp.arctan2(dy, dx)  # [-pi, pi]
        b = jnp.floor((theta + jnp.pi) / (2.0 * jnp.pi) * num_bins)
        b = jnp.clip(b, 0, num_bins - 1)
        onehot = (b[:, None] == ii[None, :]).astype(jnp.float32)  # (169, B)
        hx = dx @ onehot
        hy = dy @ onehot
        sx = circ @ hx
        sy = circ @ hy
        best = jnp.argmax(sx * sx + sy * sy)
        return jnp.arctan2(sy[best], sx[best])

    return jax.vmap(one)(keypoints, sigmas)


def _describe(img, keypoints, sigmas, cells=4, samples_per_cell=5,
              upright=False):
    """SURF-128 descriptors via bilinear gradient sampling; with
    orientation assignment unless `upright`."""
    H, W = img.shape
    # Precompute image gradients once.
    gx = (jnp.roll(img, -1, axis=1) - jnp.roll(img, 1, axis=1)) * 0.5
    gy = (jnp.roll(img, -1, axis=0) - jnp.roll(img, 1, axis=0)) * 0.5

    n = cells * samples_per_cell  # 20 samples across the window
    # Sample offsets in units of sigma: window = 20 sigma.
    offs = (jnp.arange(n, dtype=jnp.float32) - (n - 1) / 2.0)  # -9.5..9.5

    sample = _grad_sampler(gx, gy)

    if upright:
        angles = jnp.zeros((keypoints.shape[0],), jnp.float32)
    else:
        angles = _orientations(gx, gy, keypoints, sigmas)

    # Gaussian weighting over the window.
    wy = jnp.exp(-0.5 * (offs / (n / 4.0)) ** 2)
    weight = wy[:, None] * wy[None, :]

    def one(kp, sigma, ang):
        step = sigma  # sample spacing = sigma
        ca = jnp.cos(ang)
        sa = jnp.sin(ang)
        # Rotate the sampling grid into the keypoint's local frame.
        U = jnp.broadcast_to(offs[None, :], (n, n)) * step  # local x
        V = jnp.broadcast_to(offs[:, None], (n, n)) * step  # local y
        X = kp[0] + ca * U - sa * V
        Y = kp[1] + sa * U + ca * V
        dxi, dyi = sample(Y, X)
        # Rotate gradients into the local frame.
        dx = (ca * dxi + sa * dyi) * weight
        dy = (-sa * dxi + ca * dyi) * weight
        # 4x4 cells, each (samples_per_cell x samples_per_cell).
        dx_c = dx.reshape(cells, samples_per_cell, cells, samples_per_cell)
        dy_c = dy.reshape(cells, samples_per_cell, cells, samples_per_cell)
        feats = []
        for pos_mask_src in (dy_c >= 0, dy_c < 0):
            # SURF-128: statistics of dx split by sign of dy, and vice versa.
            m = pos_mask_src.astype(jnp.float32)
            feats.append(jnp.sum(dx_c * m, axis=(1, 3)))
            feats.append(jnp.sum(jnp.abs(dx_c) * m, axis=(1, 3)))
        for pos_mask_src in (dx_c >= 0, dx_c < 0):
            m = pos_mask_src.astype(jnp.float32)
            feats.append(jnp.sum(dy_c * m, axis=(1, 3)))
            feats.append(jnp.sum(jnp.abs(dy_c) * m, axis=(1, 3)))
        d = jnp.stack(feats, axis=-1).reshape(-1)  # (4*4*8 = 128,)
        return d / jnp.maximum(jnp.linalg.norm(d), 1e-8)

    return jax.vmap(one)(keypoints, sigmas, angles)


def detect_image(img_array, hessian_threshold=100.0, num_octaves=4,
                 num_octave_layers=3, max_features=2048, upright=False,
                 grid_size=3, cell_thresholds=None, min_per_cell=0):
    """Numpy grayscale/RGB image -> (keypoints (N, 2), descriptors (N, 128))."""
    img = np.asarray(img_array)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    kp, sig, desc, mask, _ = detect_and_describe(
        jnp.asarray(img, jnp.float32),
        hessian_threshold=hessian_threshold,
        num_octaves=num_octaves,
        num_octave_layers=num_octave_layers,
        max_features=max_features,
        upright=upright,
        grid_size=grid_size if isinstance(grid_size, int) else tuple(grid_size),
        cell_thresholds=cell_thresholds,
        min_per_cell=min_per_cell,
    )
    m = np.asarray(mask)
    return np.asarray(kp)[m], np.asarray(desc)[m]


class AdaptiveDetector:
    """Cross-frame adaptive per-cell thresholds — the stateful counterpart
    of the reference's AdaptiveSURF (feature.cc:198-309): each grid cell
    remembers its own Hessian threshold across frames, lowering it (/1.5)
    when the cell yields fewer than `min_per_cell` above-threshold maxima
    and raising it (*1.5) when the cell saturates its budget, clamped to
    [hessian/1.5^adapt_levels, hessian*1.5^adapt_levels]. Within a frame
    the kernel's rank-based admission (detect_and_describe) already
    guarantees min_per_cell wherever the quality floor allows, so the
    remembered thresholds only tune WHICH maxima count as above-threshold
    — no per-cell re-detection loops, one compiled executable for every
    frame.

    CLI: --surf-adaptive-min-per-cell > 0 activates this wrapper
    (reference mapper.cc:707-712)."""

    def __init__(self, hessian_threshold=100.0, min_per_cell=100,
                 num_octaves=4, num_octave_layers=3, max_features=2048,
                 grid_size=3, upright=False, adapt_levels=10):
        rows, cols = ((grid_size, grid_size) if isinstance(grid_size, int)
                      else grid_size)
        self.grid = (rows, cols)
        self.hessian_threshold = float(hessian_threshold)
        self.min_per_cell = int(min_per_cell)
        self.max_per_cell = max_features // (rows * cols)
        self.adapt_levels = int(adapt_levels)
        self.kw = dict(num_octaves=num_octaves,
                       num_octave_layers=num_octave_layers,
                       max_features=max_features,
                       grid_size=(rows, cols), upright=upright)
        self.cell_thr = np.full((rows * cols,), self.hessian_threshold,
                                np.float32)

    def detect(self, img_array):
        """(keypoints (N, 2), descriptors (N, 128)) + threshold update."""
        img = np.asarray(img_array)
        if img.ndim == 3:
            img = img.mean(axis=-1)
        kp, sig, desc, mask, counts = detect_and_describe(
            jnp.asarray(img, jnp.float32),
            hessian_threshold=self.hessian_threshold,
            cell_thresholds=jnp.asarray(self.cell_thr),
            min_per_cell=self.min_per_cell,
            adapt_levels=self.adapt_levels,
            **self.kw,
        )
        counts = np.asarray(counts)
        lo = self.hessian_threshold * 1.5 ** (-self.adapt_levels)
        hi = self.hessian_threshold * 1.5 ** (self.adapt_levels)
        thr = self.cell_thr
        thr = np.where(counts < self.min_per_cell, thr / 1.5,
                       np.where(counts >= self.max_per_cell, thr * 1.5, thr))
        self.cell_thr = np.clip(thr, lo, hi).astype(np.float32)
        m = np.asarray(mask)
        return np.asarray(kp)[m], np.asarray(desc)[m]


def detect_image_file(path, detector=None, **kwargs):
    """(keypoints, descriptors, (rows, cols)) — dims ride along so the
    feature cache can answer query_dimensions without re-decoding.
    `detector`: optional stateful AdaptiveDetector to use instead of the
    stateless path."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding image files needs Pillow (PIL), which is not "
            "installed; install it, or map from cached features "
            "(--cache-path / --reference-cache-path)") from e

    img = np.asarray(Image.open(path).convert("L"), np.float32)
    if detector is not None:
        kp, desc = detector.detect(img)
    else:
        kp, desc = detect_image(img, **kwargs)
    return kp, desc, img.shape
