"""Measure segment-parallel mapping throughput on the bench scene.

Runs the FULL production pipeline (chained registration, deferred window
BA, back-fill, merge, final global BA) at parallel_segments in {1,2,3,4}
and prints fps + ATE per cell. The parallel cells overlap each segment's
pull round-trip and host commit with the other segments' device work.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

from mavmap_tpu.features import ArrayFeatureProvider
from mavmap_tpu.sfm.pipeline import PipelineOptions, run_pipeline
from mavmap_tpu.utils.synthetic import make_uav_scene, render_features, mapper_ate

NUM_IMAGES = int(os.environ.get("BENCH_IMAGES", "30"))
scene = make_uav_scene(num_images=NUM_IMAGES, num_points=4000, relief=10.0,
                       rows=2, seed=11)
feats, _ = render_features(scene, pixel_noise=0.3, clutter=64, seed=11)
cap = 1024
feats = [(k[:cap], d[:cap]) for k, d in feats]
prov = ArrayFeatureProvider(feats, capacity=cap)


def cell(segments, warm=False):
    opts = PipelineOptions(
        verbose=False, tri_min_angle=1.0, init_tri_min_angle=4.0,
        essential_ransac_trials=512, p3p_ransac_trials=512,
        loop_detection=False, final_closure_sweeps=0,
        ba_local_max_iters=10, ba_global_max_iters=30,
        parallel_segments=segments,
    )
    t0 = time.time()
    res = run_pipeline(scene.image_cameras, scene.cam_models,
                       scene.cam_params, prov, opts)
    dt = time.time() - t0
    m = res.main_mapper
    n = m.num_proc_images
    ate = mapper_ate(m, scene)
    tag = "warm" if warm else "meas"
    print(f"[{tag}] segments={segments}: {n}/{NUM_IMAGES} maps="
          f"{len(res.mappers)} in {dt:.2f}s ({n/dt:.1f} fps) "
          f"ATE {ate:.4f} m | stages "
          + " ".join(f"{k}={v:.2f}s" for k, v in res.timings.items()),
          flush=True)


SEGS = tuple(int(x) for x in os.environ.get("BENCH_SEGS", "1,2,3,4").split(","))
for s in SEGS:
    cell(s, warm=True)
for s in SEGS:
    cell(s)
