"""Benchmark: 100-image serpentine survey end-to-end on one GPU."""
import time
import numpy as np
import jax.numpy as jnp
from mavmap_tpu.features import ArrayFeatureProvider
from mavmap_tpu.loop import train_voc_tree
from mavmap_tpu.sfm.pipeline import PipelineOptions, run_pipeline
from mavmap_tpu.utils.synthetic import ate_rmse, make_uav_scene, render_features
from mavmap_tpu.ops.rotation import rotmat_from_rvec

scene = make_uav_scene(num_images=100, num_points=12000, relief=10.0, rows=4, seed=7)
feats, _ = render_features(scene, pixel_noise=0.3, clutter=32, seed=7)
cap = 1024
feats = [(k[:cap], d[:cap]) for k, d in feats]
prov = ArrayFeatureProvider(feats, capacity=cap)
desc = np.concatenate([d for _, d in feats])
rng = np.random.default_rng(0)
tree = train_voc_tree(desc[rng.permutation(len(desc))[:8000]], branching=8, depth=2, iters=3)
opts = PipelineOptions(verbose=False, tri_min_angle=1.0, init_tri_min_angle=4.0,
                       min_track_len=2, loop_detection_period=20)
t0 = time.time()
res = run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                   prov, opts, voc_tree=tree)
el = time.time() - t0
m = res.main_mapper
reg_ids = [iid for iid in range(m.store.num_images) if m.store.image_registered[iid]]
idxs = [m.image_id_to_idx[iid] for iid in reg_ids]
R = np.asarray(rotmat_from_rvec(jnp.asarray(m.store.image_rvecs[reg_ids], jnp.float32)))
est = -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), m.store.image_tvecs[reg_ids])
ate = ate_rmse(est, scene.camera_centers()[idxs])
npts = int(m.store.point3D_valid.sum())
print(f"registered {m.num_proc_images}/100 in {el:.1f}s "
      f"({m.num_proc_images/el:.2f} fps), mappers={len(res.mappers)}, "
      f"points={npts}, ATE={ate:.4f} m")
