"""A/B the chain-registration anchor-freshness fix on the bench scene.

Runs the bench.py measured loop under several configurations and seeds,
printing fps + ATE per cell:
  - chain=4 with fresh-anchor feeding (production)
  - chain=4 with the fresh-anchor gather disabled (stale host anchors)
  - chain=1 (per-frame path, deferred BA)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

from mavmap_tpu.ba import BAOptions
from mavmap_tpu.features import ArrayFeatureProvider
from mavmap_tpu.sfm import SequentialMapper, SequentialMapperOptions
from mavmap_tpu.utils.synthetic import make_uav_scene, render_features, mapper_ate

NUM_IMAGES = 30
scene = make_uav_scene(num_images=NUM_IMAGES, num_points=4000, relief=10.0,
                       rows=2, seed=11)
feats, _ = render_features(scene, pixel_noise=0.3, clutter=64, seed=11)
cap = 1024
feats = [(k[:cap], d[:cap]) for k, d in feats]
prov = ArrayFeatureProvider(feats, capacity=cap)

opts = SequentialMapperOptions(
    tri_min_angle=1.0, final_cost_threshold=2.0,
    essential_ransac_trials=512, p3p_ransac_trials=512,
)
init_opts = SequentialMapperOptions(
    tri_min_angle=4.0, final_cost_threshold=2.0,
    essential_ransac_trials=512, p3p_ransac_trials=512,
)
BA_ITERS = int(os.environ.get("AB_BA_ITERS", "10"))
ba_opts = BAOptions(max_num_iterations=BA_ITERS, refine_camera_params=True)

def run(seed, chain, fresh, win=8):
    m = SequentialMapper(scene.image_cameras, scene.cam_models,
                         scene.cam_params, prov, seed=seed)
    m.fresh_anchor = fresh  # stale = anchor on host-staged (pre-BA) state
    assert m.process_initial(0, 1, init_opts)
    last = 1

    def local_ba():
        reg = sorted(m.image_idx_to_id.keys())
        window = reg[-win:]
        if len(window) > 2:
            m.adjust_bundle(window[2:], window[:2], ba_options=ba_opts,
                            async_=True, defer=True)

    i = 2
    while i < NUM_IMAGES:
        ch = [j for j in range(i, min(i + max(chain, 1), NUM_IMAGES))
              if not m.is_image_processed(j)]
        if chain >= 2 and len(ch) >= 2 and ch == list(range(ch[0], ch[-1] + 1)):
            oks = m.process_chain_k(ch, last, opts, pad_to=chain)
            committed = sum(oks)
            if committed:
                last = ch[committed - 1]
                local_ba()
                i = last + 1
                continue
        if m.process(i, last, opts):
            last = i
            local_ba()
        i += 1
    m.flush_ba()
    return m


def cell(seed, chain, fresh, win=8, warm=False):
    t0 = time.time()
    m = run(seed, chain, fresh, win)
    dt = time.time() - t0
    ate = mapper_ate(m, scene)
    # Reference-parity finish: the driver always runs a global BA per
    # mapper at the end (mapper.cc:1188-1191).
    t1 = time.time()
    m.adjust_global_bundle(BAOptions(max_num_iterations=30,
                                     refine_camera_params=True))
    dt_gba = time.time() - t1
    ate_gba = mapper_ate(m, scene)
    n = m.num_proc_images
    tag = "warm" if warm else "meas"
    print(f"[{tag}] chain={chain} win={win} ba_iters={BA_ITERS} "
          f"fresh={int(fresh)} seed={seed}: "
          f"{n}/{NUM_IMAGES} in {dt:.2f}s ({n/dt:.1f} fps) ATE {ate:.4f} m"
          f" | +GBA {dt_gba:.2f}s ATE {ate_gba:.4f} m",
          flush=True)


# Warmup compiles for each config shape, then sweep chain length x window.
SWEEP = ((6, 10), (8, 12))
for chain, win in SWEEP:
    cell(0, chain, True, win, warm=True)
for seed in (1, 2, 3):
    for chain, win in SWEEP:
        cell(seed, chain, True, win)
