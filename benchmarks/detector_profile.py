"""Stage-level timing of the on-device detector.

Times, per 752x480 frame at steady state (warm executables):
  detect-only     pyramid + NMS + per-cell top-k + sub-pixel (no desc)
  orientations    _orientations alone (K keypoints)
  describe-upright  _describe with upright=True (no orientation pass)
  describe-full   _describe with orientation assignment
  end-to-end      detect_and_describe as shipped

Usage: python benchmarks/detector_profile.py [frames]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from mavmap_tpu.features.detector import (
    detect_and_describe, _describe, _orientations)
from mavmap_tpu.utils.synthetic import make_uav_scene, render_images

REPS = int(sys.argv[1]) if len(sys.argv) > 1 else 8
H, W = 480, 752
scene = make_uav_scene(num_images=REPS + 1, num_points=3000, relief=10.0,
                       rows=1, seed=3)
imgs = render_images(scene, texture_size=1024, seed=3)
imgs = [jnp.asarray(np.asarray(i, np.float32)[:H, :W]) for i in imgs]

KW = dict(hessian_threshold=100.0, num_octaves=4, num_octave_layers=3,
          max_features=1024, grid_size=3)


def timed(label, fn, args_list):
    fn(*args_list[0])  # warm
    jax.block_until_ready(fn(*args_list[0]))
    t0 = time.time()
    out = None
    for a in args_list:
        out = fn(*a)
    jax.block_until_ready(out)
    dt = (time.time() - t0) / len(args_list)
    print(f"{label:18s} {dt*1000:8.1f} ms/frame", flush=True)
    return out


full = jax.jit(lambda im: detect_and_describe(im, **KW))
up = jax.jit(lambda im: detect_and_describe(im, upright=True, **KW))

# Detect-only: reuse the shipped kernel but stop before _describe by
# timing the difference (upright end-to-end minus describe-upright below).
args = [(im,) for im in imgs[:REPS]]
timed("end-to-end", full, args)
timed("end-to-end-upright", up, args)

kp, sig, desc, mask, counts = jax.block_until_ready(full(imgs[0]))
K = kp.shape[0]
print(f"K={K} valid={int(np.asarray(mask).sum())}")

img0 = imgs[0].astype(jnp.float32) / 255.0
gx = (jnp.roll(img0, -1, axis=1) - jnp.roll(img0, 1, axis=1)) * 0.5
gy = (jnp.roll(img0, -1, axis=0) - jnp.roll(img0, 1, axis=0)) * 0.5

ori = jax.jit(_orientations)
timed("orientations", ori, [(gx, gy, kp, sig)] * REPS)

dsc_up = jax.jit(lambda im, k, s: _describe(im, k, s, upright=True))
timed("describe-upright", dsc_up, [(img0, kp, sig)] * REPS)
dsc = jax.jit(lambda im, k, s: _describe(im, k, s, upright=False))
timed("describe-full", dsc, [(img0, kp, sig)] * REPS)
print(f"device={jax.devices()[0].device_kind}")
