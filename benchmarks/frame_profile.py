"""Breakdown of per-chain wall time in the sequential mapping loop.

Wraps chain_dispatch / chain_complete / adjust_bundle(defer) with timers to
split host dispatch work, pull+commit, and BA problem building — the guide
for what to batch/fuse next.
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
from mavmap_tpu.sfm.mapper import SequentialMapper as SM
from mavmap_tpu.utils.synthetic import make_uav_scene, render_features, mapper_ate

NUM_IMAGES = 30
CHAIN = int(os.environ.get("PROF_CHAIN", "6"))
WIN = int(os.environ.get("PROF_WIN", "10"))
scene = make_uav_scene(num_images=NUM_IMAGES, num_points=4000, relief=10.0,
                       rows=2, seed=11)
feats, _ = render_features(scene, pixel_noise=0.3, clutter=64, seed=11)
cap = 1024
feats = [(k[:cap], d[:cap]) for k, d in feats]
prov = ArrayFeatureProvider(feats, capacity=cap)

opts = SequentialMapperOptions(
    tri_min_angle=1.0, final_cost_threshold=2.0,
    essential_ransac_trials=512, p3p_ransac_trials=512)
init_opts = SequentialMapperOptions(
    tri_min_angle=4.0, final_cost_threshold=2.0,
    essential_ransac_trials=512, p3p_ransac_trials=512)
ba_opts = BAOptions(max_num_iterations=10, refine_camera_params=True)

T = {}
N = {}


def timed(name, fn):
    def wrap(*a, **k):
        t0 = time.perf_counter()
        r = fn(*a, **k)
        T[name] = T.get(name, 0.0) + (time.perf_counter() - t0)
        N[name] = N.get(name, 0) + 1
        return r
    return wrap


SM.chain_dispatch = timed("chain_dispatch", SM.chain_dispatch)
SM.chain_complete = timed("chain_complete", SM.chain_complete)
SM.adjust_bundle = timed("adjust_bundle(defer)", SM.adjust_bundle)
SM._register_commit = timed("register_commit", SM._register_commit)
SM._prev_track_state = timed("prev_track_state", SM._prev_track_state)
SM._pull_with_pending = timed("pull_with_pending", SM._pull_with_pending)
SM._device_features = timed("device_features", SM._device_features)
SM._dispatch_deferred_ba = timed("dispatch_deferred_ba",
                                 SM._dispatch_deferred_ba)
if os.environ.get("PROF_NO_COPY_ASYNC") == "1":
    SM._copy_async = staticmethod(lambda tree: None)
from mavmap_tpu.ba import core as _bacore
_orig_async = _bacore.bundle_adjust_async
def _timed_async(*a, **k):
    t0 = time.perf_counter()
    r = _orig_async(*a, **k)
    T["ba_async_inner"] = T.get("ba_async_inner", 0.0) + (
        time.perf_counter() - t0)
    N["ba_async_inner"] = N.get("ba_async_inner", 0) + 1
    return r
import mavmap_tpu.sfm.mapper as _mapmod
_bacore.bundle_adjust_async = _timed_async
# mapper imports it lazily via `from ..ba import bundle_adjust_async`
import mavmap_tpu.ba as _bapkg
_bapkg.bundle_adjust_async = _timed_async


def run(seed):
    m = SequentialMapper(scene.image_cameras, scene.cam_models,
                         scene.cam_params, prov, seed=seed)
    assert m.process_initial(0, 1, init_opts)
    last = 1

    def local_ba():
        reg = sorted(m.image_idx_to_id.keys())
        window = reg[-WIN:]
        if len(window) > 2:
            m.adjust_bundle(window[2:], window[:2], ba_options=ba_opts,
                            async_=True, defer=True)

    i = 2
    while i < NUM_IMAGES:
        ch = [j for j in range(i, min(i + CHAIN, NUM_IMAGES))
              if not m.is_image_processed(j)]
        if len(ch) >= 2 and ch == list(range(ch[0], ch[-1] + 1)):
            oks = m.process_chain_k(ch, last, opts, pad_to=CHAIN)
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


run(0)  # warm
T.clear()
N.clear()
t0 = time.time()
m = run(1)
dt = time.time() - t0
print(f"total {dt:.3f}s  {m.num_proc_images}/{NUM_IMAGES} "
      f"({m.num_proc_images/dt:.1f} fps)  ATE {mapper_ate(m, scene):.4f}")
other = dt - sum(
    v for k, v in T.items()
    if k in ("chain_dispatch", "chain_complete", "adjust_bundle(defer)"))
for k in sorted(T, key=lambda k: -T[k]):
    print(f"  {k:22s} {T[k]*1000:8.1f} ms total  x{N[k]:3d}  "
          f"{T[k]/max(N[k],1)*1000:6.1f} ms/call")
print(f"  {'(unattributed)':22s} {other*1000:8.1f} ms total")
