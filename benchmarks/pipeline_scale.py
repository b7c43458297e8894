"""Long-survey end-to-end benchmark on one GPU.

Usage: python benchmarks/pipeline_scale.py [num_images] [rows] [sweeps]
Defaults: 500 10 1. Prints registration rate, fps, sub-map count, points,
and ATE vs the synthetic ground truth.
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np
from mavmap_tpu.features import ArrayFeatureProvider
from mavmap_tpu.loop import train_voc_tree
from mavmap_tpu.sfm.pipeline import PipelineOptions, run_pipeline
from mavmap_tpu.utils.synthetic import make_uav_scene, render_features, mapper_ate

N = int(sys.argv[1]) if len(sys.argv) > 1 else 500
ROWS = int(sys.argv[2]) if len(sys.argv) > 2 else 10
SWEEPS = int(sys.argv[3]) if len(sys.argv) > 3 else 1

t0 = time.time()
scene = make_uav_scene(num_images=N, num_points=120 * N, relief=10.0,
                       rows=ROWS, extent=None, seed=13)
# Feature tables are deterministic in (N, ROWS, seed) and cost ~200 s to
# render at N=1000 — cache them so benchmark iterations measure the
# pipeline, not the fixture.
cap = 1024
_fc = os.path.join(tempfile.gettempdir(),
                   f"pipeline_scale_feats_{N}_{ROWS}_13.npz")
if os.path.exists(_fc):
    with np.load(_fc) as d:
        feats = [(d[f"k{i}"], d[f"d{i}"]) for i in range(N)]
else:
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=32, seed=13)
    feats = [(k[:cap], d[:cap]) for k, d in feats]
    np.savez(_fc, **{f"k{i}": k for i, (k, _) in enumerate(feats)},
             **{f"d{i}": d for i, (_, d) in enumerate(feats)})
prov = ArrayFeatureProvider(feats, capacity=cap)
desc = np.concatenate([d for _, d in feats[::10]])
rng = np.random.default_rng(0)
tree = train_voc_tree(desc[rng.permutation(len(desc))[:8000]], branching=8,
                      depth=2, iters=3)
print(f"scene+features in {time.time()-t0:.0f}s", flush=True)
opts = PipelineOptions(verbose=False, tri_min_angle=1.0, init_tri_min_angle=4.0,
                       min_track_len=2, loop_detection_period=20,
                       final_closure_sweeps=SWEEPS,
                       final_closure_step=int(os.environ.get(
                           "MAVMAP_SCALE_STEP", "2")),
                       ba_function_tolerance=float(os.environ.get(
                           "MAVMAP_SCALE_TOL", "1e-4")),
                       # Diagnostics: selfcal off (hold ground-truth
                       # intrinsics) isolates how much of the long-survey
                       # dome is selfcal bias.
                       refine_camera_params=os.environ.get(
                           "MAVMAP_SCALE_REFINE", "1") == "1",
                       local_ba_refine_camera_params=os.environ.get(
                           "MAVMAP_SCALE_REFINE", "1") == "1",
                       chain_len=int(os.environ.get("MAVMAP_SCALE_CHAIN",
                                                    "4")),
                       ba_local_max_iters=int(os.environ.get(
                           "MAVMAP_SCALE_LBA_ITERS", "15")),
                       pipeline_chains=os.environ.get(
                           "MAVMAP_PIPELINE_CHAINS", "0") == "1")
t0 = time.time()
res = run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                   prov, opts, voc_tree=tree)
el = time.time() - t0
m = res.main_mapper
ate = mapper_ate(m, scene)
npts = int(m.store.point3D_valid.sum())
print(f"N={N} sweeps={SWEEPS}: {m.num_proc_images}/{N} in {el:.1f}s "
      f"({m.num_proc_images/el:.2f} fps), maps={len(res.mappers)}, "
      f"points={npts}, ATE={ate:.4f} m", flush=True)
try:
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", 0)
    if peak:
        print(f"device memory peak: {peak / 2**30:.2f} GiB", flush=True)
except Exception:
    pass
if res.timings:
    print("stages: " + " | ".join(f"{k} {v:.1f}s"
                                  for k, v in res.timings.items()), flush=True)
# Drift profile: per-100-frame RMSE under ONE global alignment + closure
# commit counters — shows where along the survey the error accumulates and
# how much closure machinery fired.
from mavmap_tpu.utils.synthetic import mapper_ate_profile

prof = mapper_ate_profile(m, scene, block=100)
print("ate profile: " + " ".join(f"[{s}:+{n}]={e:.4f}" for s, n, e in prof),
      flush=True)
print("counters: " + " ".join(f"{k}={v}" for k, v in sorted(m.counters.items())),
      flush=True)
# Self-calibration check: a residual focal error bends a nadir survey into
# the classic photogrammetric dome (high ATE at both survey ends).
est_k = m.store.camera_params[0][:4]
true_k = scene.cam_params[0][:4]
print("selfcal: est fx,fy,cx,cy = "
      + " ".join(f"{v:.2f}" for v in est_k)
      + " | true = " + " ".join(f"{v:.2f}" for v in true_k), flush=True)
