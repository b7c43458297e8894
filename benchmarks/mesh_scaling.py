"""Distributed product-path scaling: 1 vs N virtual devices (CPU mesh).

Measures, through the PIPELINE-LEVEL entry points (not bespoke problems):
  - dist global BA wall time and ms/LM-iteration via
    mapper.adjust_global_bundle on a mapped survey,
  - the back-fill fan-out (batch_register_pairs) via
    process_remaining_images with half the frames skipped.

Real scaling needs real cards (chip_smoke.py --mesh4 runs the mesh on
four); the virtual CPU mesh validates the sharding/collective layout only.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python benchmarks/mesh_scaling.py [num_images]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

from mavmap_tpu.ba import BAOptions
from mavmap_tpu.features import ArrayFeatureProvider
from mavmap_tpu.sfm.pipeline import PipelineOptions, run_pipeline, \
    process_remaining_images
from mavmap_tpu.utils.synthetic import make_uav_scene, render_features, \
    mapper_ate

N = int(sys.argv[1]) if len(sys.argv) > 1 else 40
scene = make_uav_scene(num_images=N, num_points=100 * N, relief=10.0,
                       rows=2, extent=None, seed=17)
feats, _ = render_features(scene, pixel_noise=0.3, clutter=16, seed=17)
feats = [(k[:1024], d[:1024]) for k, d in feats]
prov = ArrayFeatureProvider(feats, capacity=1024)


def run(mesh_devices):
    """One pipeline + timed global BA + timed back-fill at `mesh_devices`.

    N < ba.core.DENSE_SOLVER_MAX_CAMERAS (64) exercises the DENSE Schur
    path (materialized camera system, psum-reduced); N >= 64 the
    matrix-free Schur-CG path — run with several N to map the
    small-problem crossover where collective overhead eats the gain."""
    opts = PipelineOptions(verbose=False, tri_min_angle=1.0,
                           init_tri_min_angle=4.0, min_track_len=2,
                           loop_detection=False, mesh_devices=mesh_devices)
    res = run_pipeline(scene.image_cameras, scene.cam_models,
                       scene.cam_params, prov, opts)
    m = res.main_mapper

    # Global BA timing through the mapper entry (warm + timed).
    ba_opts = BAOptions(max_num_iterations=20, refine_camera_params=False)
    m.adjust_global_bundle(ba_opts)
    t0 = time.time()
    info = m.adjust_global_bundle(ba_opts) or {}
    ba_s = time.time() - t0
    iters = max(int(info.get("iterations", 1)), 1)

    # Back-fill fan-out timing: forget half the frames, re-register them
    # through the (mesh-sharded) batched pair kernel. First pass warms the
    # executable; the second is the steady-state number.
    def drop_half():
        reg = sorted(m.image_idx_to_id.keys())
        drop = reg[1::2][2:]
        for idx in drop:
            iid = m.image_idx_to_id.pop(idx)
            del m.image_id_to_idx[iid]
            m.store.image_registered[iid] = False
            m.num_proc_images -= 1
        m.pair_graph = {p for p in m.pair_graph
                        if p[0] not in drop and p[1] not in drop}

    drop_half()
    process_remaining_images(m, 0, N - 1, opts)  # warm
    drop_half()
    t0 = time.time()
    n = process_remaining_images(m, 0, N - 1, opts)
    bf_s = time.time() - t0
    ate = mapper_ate(m, scene)
    return ba_s, ba_s / iters * 1000, bf_s, n, ate, info.get("distributed")


for nd in (1, 8):
    ba_s, ba_ms_iter, bf_s, n, ate, dist = run(nd)
    print(f"mesh={nd}: global BA {ba_s:.2f}s ({ba_ms_iter:.1f} ms/iter, "
          f"distributed={dist}), back-fill {n} frames in {bf_s:.2f}s, "
          f"ATE {ate:.4f} m", flush=True)
