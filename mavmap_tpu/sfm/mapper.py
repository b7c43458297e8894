"""SequentialMapper — incremental SfM engine.

Counterpart of reference src/sfm/sequential_mapper.{h,cc}. The
class owns the MapStore (FeatureManager equivalent), idx<->id maps, the
processed-pair graph, and a per-image feature store; each `process*` call
dispatches ONE fused device kernel (sfm/kernels.py) and applies the
reference's failure gates host-side on returned scalars:

  process_initial: disparity -> homography -> 5pt inliers -> forward-motion
  -> mean tri angle (sequential_mapper.cc:46-386);
  process: disparity -> homography -> #stable 2D-3D -> P3P inliers ->
  refinement final cost, then track continuation + new triangulations
  (sequential_mapper.cc:389-934).

All thresholds given in pixels are converted to normalized-coordinate units
with threshold / mean(fx, fy), exactly like the reference
(camera_models.cc:47-52).
"""

import time as _time
from collections import OrderedDict

import numpy as np

import jax
import jax.numpy as jnp

from ..fm import MapStore
from ..models import camera as cam
from ..utils.mathx import rel2abs_threshold
from .kernels import (
    two_view_init,
    register_view,
    unpack_two_view,
    unpack_register,
)
from .options import SequentialMapperOptions


@jax.jit
def _match_counts_jit(dq, mq, dstack, mstack, ratio):
    """2-NN match counts of one query against a stacked candidate batch.

    Module-level jit (ratio traced): defining this closure inside
    _batch_match_counts re-traced + re-lowered it on EVERY loop-detection
    period (~tens of ms each over a mapping run)."""
    from ..ops.matching import match_brute_force

    def one(d2, m2):
        _, ok = match_brute_force(dq, d2, mq, m2, ratio=ratio)
        return jnp.sum(ok)

    return jax.vmap(one)(dstack, mstack)


class _LRUCache(OrderedDict):
    """Bounded per-image cache: evicts least-recently-used beyond capacity.

    The reference holds only a 2-image in-RAM feature window
    (sequential_mapper.cc:2036-2076); this mapper keeps a window large
    enough for the local-BA window + batched loop-closure / back-fill
    candidates, re-fetching evicted images from the provider/disk cache on
    miss. Without a bound, host features + device descriptors accumulate
    ~0.5 MB+/image forever (HBM leak on long surveys)."""

    def __init__(self, capacity):
        super().__init__()
        self.capacity = capacity

    def get_or(self, key, make):
        if key in self:
            self.move_to_end(key)
            return self[key]
        val = make()
        self[key] = val
        if len(self) > self.capacity:
            self.popitem(last=False)
        return val


class SequentialMapper:
    def __init__(
        self,
        image_cameras,
        cam_models,
        cam_params,
        feature_provider,
        loop_detector=None,
        seed=0,
        store_backend="auto",
        cache_capacity=128,
        mesh=None,
    ):
        """image_cameras: (num_images,) camera index per dataset image;
        cam_models/cam_params: per-camera model codes and padded params;
        feature_provider: FeatureProvider with fixed capacity;
        store_backend: 'python' | 'native' | 'auto' (C++ track core);
        cache_capacity: max images kept in the host/device feature caches;
        mesh: optional jax.sharding.Mesh (1-D) — when it has >1 device the
        batched fan-outs (back-fill pairs, closure candidates, match
        pre-gates) shard over it and the global BA runs distributed
        (parallel/dist_ba.py) instead of single-device."""
        self.mesh = mesh if (mesh is not None and mesh.devices.size > 1) \
            else None
        self.image_cameras = np.asarray(image_cameras, np.int32)
        self.cam_models = np.asarray(cam_models, np.int32)
        # Own copy: self-calibration adopts refined intrinsics in place, and
        # np.asarray aliases a caller array of matching dtype — without the
        # copy, a pipeline run silently mutates the CALLER's cam_params
        # (observed: a benchmark's ground-truth intrinsics overwritten by
        # the selfcal result).
        self.cam_params = np.array(cam_params, np.float32)
        self.provider = feature_provider
        self.loop_detector = loop_detector

        from ..fm.native_map_store import create_map_store

        self.store = create_map_store(store_backend)
        self._store_cam_ids = {}
        self.image_idx_to_id = {}
        self.image_id_to_idx = {}
        self.pair_graph = set()
        self.num_proc_images = 0
        self.min_image_idx = None
        self.max_image_idx = None
        self._key = jax.random.PRNGKey(seed)
        # Bounded LRU caches. Device descriptors (intrinsics-independent)
        # and normalized coords (intrinsics-DEPENDENT) are cached
        # separately so self-calibration only invalidates the latter —
        # refined intrinsics must not force descriptor re-uploads over the
        # slow host->device link.
        self._feat_cache = _LRUCache(cache_capacity)
        self._norm_cache = _LRUCache(cache_capacity)
        self._dev_feat_cache = _LRUCache(cache_capacity)
        self._dev_norm_cache = _LRUCache(cache_capacity)
        # Optional DebugDumper (sfm/debug.py) — when set, debug=True calls
        # write the reference's per-pair/per-step artifacts.
        self.debug_dumper = None
        # Lightweight event counters (closure commits etc.) for the scale
        # benchmarks' drift profiling; free-form keys, never load-bearing.
        self.counters = {}

    def _count(self, name, n=1):
        if n:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def _count_time(self, name, seconds):
        self.counters[name] = round(self.counters.get(name, 0.0)
                                    + float(seconds), 2)

    # ------------------------------------------------------------- helpers

    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    def _features(self, image_idx):
        return self._feat_cache.get_or(
            image_idx, lambda: self.provider.get(image_idx)
        )

    def _device_features(self, image_idx):
        """Per-image feature arrays resident on device (uploaded once).

        Re-shipping descriptors over the host->device link every frame
        would repeat a transfer per use; caching the jnp arrays makes
        repeat uses free.
        """

        def make_feat():
            f = self._features(image_idx)
            return (
                jnp.asarray(f.keypoints),
                jnp.asarray(f.descriptors),
                jnp.asarray(f.mask),
            )

        kp, desc, mask = self._dev_feat_cache.get_or(image_idx, make_feat)
        n = self._dev_norm_cache.get_or(
            image_idx, lambda: jnp.asarray(self._normalized(image_idx))
        )
        return kp, desc, mask, n

    def _normalized(self, image_idx):
        """Normalized coords of an image's (padded) keypoints."""

        def make():
            f = self._features(image_idx)
            ci = self.image_cameras[image_idx]
            # Host numpy: a device round trip for this tiny op costs more
            # than the op.
            return cam.image2normalized_np(
                f.keypoints, int(self.cam_models[ci]), self.cam_params[ci]
            ).astype(np.float32)

        return self._norm_cache.get_or(image_idx, make)

    def _norm_threshold(self, px, image_idx):
        ci = self.image_cameras[image_idx]
        p = self.cam_params[ci]
        return float(px) / float((p[0] + p[1]) / 2.0)

    def _abs_disparity(self, min_disparity, image_idx):
        """Relative (<1) min-disparity thresholds scale by the frame
        diagonal, like the reference (sequential_mapper.cc:425-436 via
        rel2abs_threshold + FeatureCache::query_dimensions). Falls back to
        2 * principal point (~image diagonal) when the provider has no
        dimension metadata."""
        if min_disparity >= 1 or min_disparity <= 0:
            return min_disparity
        diag = 0.0
        if hasattr(self.provider, "dimensions"):
            dims = self.provider.dimensions(image_idx)
            if dims is not None:
                diag = float(dims[2])
        if diag <= 0:
            ci = self.image_cameras[image_idx]
            cx, cy = self.cam_params[ci][2], self.cam_params[ci][3]
            diag = 2.0 * float(np.hypot(cx, cy))
        return min_disparity * diag

    def _store_camera(self, cam_idx):
        if cam_idx not in self._store_cam_ids:
            self._store_cam_ids[cam_idx] = self.store.add_camera(
                int(self.cam_models[cam_idx]), self.cam_params[cam_idx]
            )
        return self._store_cam_ids[cam_idx]

    def _add_image_to_store(self, image_idx):
        f = self._features(image_idx)
        n = self._normalized(image_idx)
        cid = self._store_camera(int(self.image_cameras[image_idx]))
        image_id, p2d = self.store.add_image(cid, f.keypoints, n)
        self.image_idx_to_id[image_idx] = image_id
        self.image_id_to_idx[image_id] = image_idx
        if self.loop_detector is not None:
            dev = self._dev_feat_cache.get(image_idx)
            self.loop_detector.add_image(
                image_idx, f,
                device_descriptors=dev[1] if dev else None,
                device_mask=dev[2] if dev else None,
            )
        self._track_minmax(image_idx)
        self.num_proc_images += 1
        return image_id

    def _track_minmax(self, image_idx):
        if self.min_image_idx is None or image_idx < self.min_image_idx:
            self.min_image_idx = image_idx
        if self.max_image_idx is None or image_idx > self.max_image_idx:
            self.max_image_idx = image_idx

    def is_image_processed(self, image_idx):
        return image_idx in self.image_idx_to_id

    def is_pair_processed(self, idx1, idx2):
        return (min(idx1, idx2), max(idx1, idx2)) in self.pair_graph

    def get_pose(self, image_idx):
        return self.store.get_pose(self.image_idx_to_id[image_idx])

    def _prev_track_state(self, prev_image_idx, options):
        """Per prev-row track info for registration, capacity-padded:
        (prev_p2d ids, has_tri (F,), stable (F,), xyz (F,3), rvec, tvec,
        track_len (F,))."""
        prev_id = self.image_idx_to_id[prev_image_idx]
        prev_p2d = self.store.point2D_ids_of_image(prev_id)
        F = self.provider.capacity
        self.store.sync()
        p3d = self.store.point2D_point3D[prev_p2d]
        pids = np.maximum(p3d, 0)
        linked = (p3d >= 0) & self.store.point3D_valid[pids]
        has_tri_rows = linked & self.store.point3D_tri[pids]
        lens_rows = np.where(
            has_tri_rows, self.store.point3D_track_len[pids], 0
        ).astype(np.int32)
        stable_rows = has_tri_rows & (lens_rows >= options.min_track_len)
        has_tri = np.zeros(F, bool)
        stable = np.zeros(F, bool)
        lens = np.zeros(F, np.int32)
        xyz = np.zeros((F, 3), np.float32)
        has_tri[: len(prev_p2d)] = has_tri_rows
        stable[: len(prev_p2d)] = stable_rows
        lens[: len(prev_p2d)] = lens_rows
        xyz[: len(prev_p2d)][has_tri_rows] = self.store.point3D_xyz[
            pids[has_tri_rows]
        ]
        prev_rvec, prev_tvec = self.store.get_pose(prev_id)
        return prev_p2d, has_tri, stable, xyz, prev_rvec, prev_tvec, lens

    # ------------------------------------------------------ process_initial

    def process_initial(self, first_idx, second_idx,
                        options: SequentialMapperOptions = None, debug=False):
        """Two-view initialization (reference sequential_mapper.cc:46-386)."""
        options = options or SequentialMapperOptions()
        if self.num_proc_images > 0:
            raise ValueError("initial processing can only be called once")
        if first_idx == second_idx:
            raise ValueError("initial pair must be distinct images")

        kp1, d1, m1, n1 = self._device_features(first_idx)
        kp2, d2, m2, n2 = self._device_features(second_idx)
        nt = self._norm_threshold(options.ransac_max_reproj_error, first_idx)

        rows, scalars = two_view_init(
            self._next_key(),
            kp1, d1, m1, n1,
            kp2, d2, m2, n2,
            jnp.float32(options.match_max_ratio),
            jnp.float32(options.match_max_distance if options.match_max_distance > 0 else 1e9),
            jnp.float32(nt),
            essential_trials=options.essential_ransac_trials,
            max_depth=options.max_depth,
        )
        # Two packed buffers -> two transfers (vs one RTT per output array).
        r = unpack_two_view(*jax.device_get((rows, scalars)))

        return self._two_view_gates_and_commit(first_idx, second_idx, r,
                                               options, debug=debug)

    def _two_view_gates_and_commit(self, first_idx, second_idx, r, options,
                                   debug=False):
        """Host-side gates + commit of a two-view init result (reference
        sequential_mapper.cc:100-386)."""
        num_matches = int(r.num_matches)
        if debug and self.debug_dumper is not None:
            # Reference dumps matches before/after RANSAC
            # (sequential_mapper.cc:82-97, 234-254).
            f1k = self._features(first_idx).keypoints
            f2k = self._features(second_idx).keypoints
            self.debug_dumper.dump_matches(
                self.num_proc_images, first_idx, second_idx, f1k, f2k,
                r.matches, r.match_valid, tag="matches-all")
            self.debug_dumper.dump_matches(
                self.num_proc_images, first_idx, second_idx, f1k, f2k,
                r.matches, r.match_valid, inlier=r.e_inlier,
                tag="matches-inlier")
        if num_matches < 5:
            return False
        # Gate 1: disparity (px; relative values scale by frame diagonal).
        if options.min_disparity > 0 and float(r.med_disparity) < \
                self._abs_disparity(options.min_disparity, second_idx):
            return False
        # Gate 2: homography inlier ratio.
        max_hom = rel2abs_threshold(options.max_homography_inliers, num_matches)
        if int(r.num_hom_inliers) > max_hom:
            return False
        # Gate 3: essential inliers.
        min_inl = rel2abs_threshold(options.ransac_min_inlier_threshold, num_matches)
        if int(r.num_e_inliers) < min_inl:
            return False
        # Gate 4: forward motion.
        if float(r.z_component) > 0.99:
            return False
        # Gate 5: mean triangulation angle (degrees).
        if float(r.mean_tri_angle) < options.tri_min_angle:
            return False

        # Commit to store: first pose = identity (reference :269-271).
        first_id = self._add_image_to_store(first_idx)
        second_id = self._add_image_to_store(second_idx)
        self.store.set_pose(first_id, np.zeros(3), np.zeros(3))
        self.store.set_pose(second_id, np.asarray(r.rvec2), np.asarray(r.tvec2))

        matches = np.asarray(r.matches)
        inlier = np.asarray(r.e_inlier)
        X = np.asarray(r.points3D)
        d1 = np.asarray(r.depth1)
        p2d_first = self.store.point2D_ids_of_image(first_id)
        p2d_second = self.store.point2D_ids_of_image(second_id)
        sel = np.where(inlier & (d1 > 0))[0]
        pids = self.store.add_correspondences_bulk(
            p2d_first[sel], p2d_second[matches[sel]]
        )
        for k, pid in enumerate(pids):
            self.store.set_point3D(pid, X[sel[k]])

        self.pair_graph.add((min(first_idx, second_idx), max(first_idx, second_idx)))
        return True

    def process_initial_batch(self, first_idx, candidate_idxs,
                              options: SequentialMapperOptions = None,
                              debug=False):
        """Try two-view initialization of `first_idx` against MANY candidate
        second images in ONE vmapped device call; commit the first candidate
        (in the given order) that passes all gates. Returns the committed
        second index or -1.

        The reference pays a full sequential process_initial per candidate
        (mapper.cc:1027-1036)."""
        from .kernels import two_view_init_batch

        options = options or SequentialMapperOptions()
        if self.num_proc_images > 0:
            raise ValueError("initial processing can only be called once")
        if not len(candidate_idxs):
            return -1

        # Bucket to power-of-two batch for jit cache reuse.
        B = 1
        while B < len(candidate_idxs):
            B *= 2
        padded = list(candidate_idxs) + [candidate_idxs[0]] * (B - len(candidate_idxs))

        kp1, d1, m1, n1 = self._device_features(first_idx)
        feats = [self._device_features(j) for j in padded]
        nts = [self._norm_threshold(options.ransac_max_reproj_error, j)
               for j in padded]
        keys = jax.random.split(self._next_key(), B)
        rows, scalars = two_view_init_batch(
            keys, kp1, d1, m1, n1,
            jnp.stack([f[0] for f in feats]),
            jnp.stack([f[1] for f in feats]),
            jnp.stack([f[2] for f in feats]),
            jnp.stack([f[3] for f in feats]),
            jnp.float32(options.match_max_ratio),
            jnp.float32(options.match_max_distance
                        if options.match_max_distance > 0 else 1e9),
            jnp.asarray(nts, jnp.float32),
            essential_trials=options.essential_ransac_trials,
            max_depth=options.max_depth,
        )
        rows, scalars = jax.device_get((rows, scalars))
        from .kernels import unpack_two_view

        for k, j in enumerate(candidate_idxs):
            r = unpack_two_view(rows[k], scalars[k])
            if self._two_view_gates_and_commit(first_idx, j, r, options,
                                               debug=debug):
                return j
        return -1

    # --------------------------------------------------------------- process

    def process(self, image_idx, prev_image_idx,
                options: SequentialMapperOptions = None, debug=False):
        """Register `image_idx` against processed `prev_image_idx`
        (reference sequential_mapper.cc:389-934)."""
        options = options or SequentialMapperOptions()
        if image_idx == prev_image_idx:
            return False
        # Swap so prev is processed (reference :400-406).
        if not self.is_image_processed(prev_image_idx):
            if not self.is_image_processed(image_idx):
                raise ValueError("neither image of the pair is processed")
            image_idx, prev_image_idx = prev_image_idx, image_idx
        if self.is_pair_processed(image_idx, prev_image_idx):
            return True

        kpp, dp_, mp_, npn = self._device_features(prev_image_idx)
        kpc, dc_, mc_, ncn = self._device_features(image_idx)
        nt = self._norm_threshold(options.ransac_max_reproj_error, image_idx)
        tri_nt = self._norm_threshold(options.tri_max_reproj_error, image_idx)

        prev_p2d, has_tri, stable, xyz, prev_rvec, prev_tvec, _ = (
            self._prev_track_state(prev_image_idx, options)
        )
        n_prev_feats = len(prev_p2d)
        ci = self.image_cameras[image_idx]

        r = register_view(
            self._next_key(),
            kpp, dp_, mp_, npn,
            kpc, dc_, mc_, ncn,
            jnp.asarray(xyz), jnp.asarray(has_tri), jnp.asarray(stable),
            jnp.asarray(prev_rvec, jnp.float32), jnp.asarray(prev_tvec, jnp.float32),
            jnp.asarray(self.cam_params[ci]), jnp.asarray(self.cam_models[ci]),
            jnp.float32(options.match_max_ratio),
            jnp.float32(options.match_max_distance if options.match_max_distance > 0 else 1e9),
            jnp.float32(nt),
            p3p_trials=options.p3p_ransac_trials,
        )
        # Overlap scheduling on the in-order device stream (transfers
        # included): (1) enqueue the device->host copy of the register
        # outputs IMMEDIATELY after the kernel — before anything else gets
        # on the stream; (2) dispatch the DEFERRED local BA of the previous
        # frame behind it, so the solve runs during the result's return
        # trip and the host commit, and its values are pulled with the NEXT
        # frame's kernel. Any already-pending solve was dispatched (and
        # async-copied) one frame ago, so pulling it here costs nothing.
        self._copy_async(r)
        r = unpack_register(*self._pull_with_pending(r))

        if not self._register_gates(image_idx, prev_image_idx, r, options,
                                    debug=debug):
            return False
        return self._register_commit(image_idx, prev_image_idx, r, options,
                                     prev_p2d, has_tri, tri_nt, debug=debug)

    def process_chain(self, idxA, idxB, prev_image_idx,
                      options: SequentialMapperOptions = None, debug=False):
        """Register TWO consecutive frames in one device call.

        Returns (okA, okB). okB is None when frame A failed its gates (B
        was registered against a rejected anchor — the caller must process
        B through the normal path instead)."""
        oks = self.process_chain_k([idxA, idxB], prev_image_idx, options,
                                   debug=debug)
        if not oks[0]:
            return False, None
        return True, len(oks) > 1 and oks[1]

    def process_chain_k(self, idxs, prev_image_idx,
                        options: SequentialMapperOptions = None, debug=False,
                        pad_to=None):
        """Register K consecutive frames in ONE device call
        (kernels.register_chain): frame k anchors on track state derived
        on device from frame k-1's results; the pull round trip is paid
        once per K frames.

        Returns a list of per-frame commit results, truncated at the
        first failure: [True]*n means the first n frames committed; a
        trailing False means that frame failed its gates and the frames
        after it were NOT attempted (their device registrations anchored
        on a rejected pose — the caller re-processes them through the
        normal path).

        pad_to: pad the chain to this fixed length by repeating the last
        frame (its results are discarded) — every call with the same
        pad_to hits the SAME compiled executable; tail/short chains would
        otherwise each pay a fresh XLA compile."""
        token = self.chain_dispatch(idxs, prev_image_idx, options,
                                    pad_to=pad_to)
        return self.chain_complete(token, debug=debug)

    def chain_dispatch(self, idxs, prev_image_idx,
                       options: SequentialMapperOptions = None,
                       pad_to=None):
        """Dispatch HALF of process_chain_k: enqueue the chain kernel (and
        this mapper's deferred window BA ahead of it) on the device stream
        and return a token for `chain_complete`, WITHOUT pulling results.

        Segment-parallel mapping interleaves dispatch/complete across
        several mappers so one mapper's pull round-trip and host commit
        overlap the device work of the others (the reference is strictly
        one-frame-at-a-time, mapper.cc:1014-1148).

        Dispatch cost note: every dispatched op / host buffer is one more
        launch or transfer, so this method makes exactly ONE jitted call with two small packed host arrays
        (plus the deferred-BA solve dispatch); features are passed as
        cached device buffers and stacked inside the program; per-chain
        PRNG keys derive in-program from (base_key, counter)."""
        from .kernels import register_chain, register_chain_fresh

        options = options or SequentialMapperOptions()
        if not self.is_image_processed(prev_image_idx):
            raise ValueError("chain needs a processed previous image")
        for i in idxs:
            if self.is_image_processed(i):
                raise ValueError("chain frames must be unprocessed")

        n_real = len(idxs)
        K = max(pad_to or n_real, n_real)
        idxs = list(idxs) + [idxs[-1]] * (K - n_real)
        kpp, dp_, mp_, npn = self._device_features(prev_image_idx)
        feats = tuple(self._device_features(i) for i in idxs)

        prev_p2d, has_tri, stable, xyz, prev_rvec, prev_tvec, lens = (
            self._prev_track_state(prev_image_idx, options)
        )
        cis = [self.image_cameras[i] for i in idxs]

        # Chained scheduling differs from process(): the previous chain's
        # deferred window solves go on the stream BEFORE this chain kernel
        # and are pulled WITH it — one chain of anchor staleness instead
        # of two (measured 2x ATE drift with the extra chain). They had
        # the previous pull's return trip + commit window to run, so the
        # wait here is small.
        handles = self._dispatch_deferred_ba()
        self._pending_ba = ((getattr(self, "_pending_ba", None) or [])
                            + handles)

        F = self.provider.capacity
        track_state = np.zeros((F, 7), np.float32)
        track_state[:, :3] = xyz
        track_state[:, 3] = has_tri
        track_state[:, 4] = stable
        track_state[:, 5] = lens
        track_state[:, 6] = -1.0

        tri_nts = [self._norm_threshold(options.tri_max_reproj_error, i)
                   for i in idxs]
        scal = np.zeros(12 + 12 * K, np.float32)
        scal[0:3] = prev_rvec
        scal[3:6] = prev_tvec
        scal[6] = options.match_max_ratio
        scal[7] = (options.match_max_distance
                   if options.match_max_distance > 0 else 1e9)
        scal[8] = options.tri_min_angle * np.pi / 180.0
        scal[9] = options.min_track_len
        self._chain_counter = getattr(self, "_chain_counter", 0) + 1
        scal[10] = self._chain_counter
        scal[11] = -1.0  # anchor_row
        per = scal[12:].reshape(K, 12)
        per[:, 0] = [self._norm_threshold(options.ransac_max_reproj_error, i)
                     for i in idxs]
        per[:, 1] = tri_nts
        per[:, 2] = self.cam_models[cis]
        per[:, 3:12] = self.cam_params[cis]

        # Anchor freshness: the solve just enqueued refines the anchor's
        # pose and most of its 3-D points, but its results only reach the
        # host store AFTER this chain's pull. The fresh variant reads the
        # anchor pose from the solve's device buffers and gathers each
        # row's 3-D point through track_state[:, 6] — the staged values
        # above are one window solve stale otherwise.
        ba_args = None
        if handles and getattr(self, "fresh_anchor", True):
            sel_ids_h, pids_h, h = handles[-1]
            prev_id = self.image_idx_to_id[prev_image_idx]
            anchor_row = (sel_ids_h.index(prev_id)
                          if prev_id in sel_ids_h else -1)
            if anchor_row >= 0 and len(pids_h):
                p3d = self.store.point2D_point3D[prev_p2d]
                loc = np.searchsorted(pids_h, np.maximum(p3d, 0))
                loc = np.minimum(loc, len(pids_h) - 1)
                ok = has_tri[: len(prev_p2d)] & (p3d >= 0) & (
                    pids_h[loc] == p3d)
                track_state[: len(prev_p2d), 6][ok] = loc[ok]
                scal[11] = anchor_row
                ba_args = (h.fut[0], h.fut[1])

        if not hasattr(self, "_base_key"):
            self._base_key = self._next_key()
        common = dict(p3p_trials=options.p3p_ransac_trials)
        if ba_args is not None:
            out = register_chain_fresh(
                self._base_key, kpp, dp_, mp_, npn, feats,
                track_state, scal, ba_args[0], ba_args[1], **common)
        else:
            out = register_chain(
                self._base_key, kpp, dp_, mp_, npn, feats,
                track_state, scal, **common)
        # Same overlap scheduling as process(): d2h first, deferred BA
        # behind it, pull everything (+ pending BA) in one device_get.
        self._copy_async(out)
        return (out, idxs, n_real, prev_image_idx, prev_p2d, has_tri,
                tri_nts, options)

    def chain_dispatch_cont(self, idxs, prev_token,
                            options: SequentialMapperOptions = None,
                            pad_to=None):
        """SPECULATIVE chain dispatch: anchor on the IN-FLIGHT previous
        chain's device-resident end state (kernels.register_chain_cont)
        WITHOUT waiting for its pull — the previous chain's pull and
        host commit overlap this chain's device work on the happy path.

        The speculation assumes the previous chain commits ALL its frames
        (the common case); if it doesn't, this chain anchored on a pose
        that never committed — the caller must `chain_abandon` the token
        and fall back to a host-anchored dispatch from the committed
        frontier. Any deferred window-BA problems stashed since the last
        dispatch enter the stream ahead of this kernel, so solves keep
        flowing every chain (they refine the STORE; cont anchors
        themselves ride the device-derived state)."""
        from .kernels import register_chain_cont

        options = options or SequentialMapperOptions()
        (p_out, p_idxs, p_n_real, *_rest) = prev_token
        if p_n_real != len(p_idxs):
            # A padded previous chain re-registers its last frame against
            # itself for the padding steps, so its end_state no longer
            # describes the last REAL frame.
            raise ValueError("cont chains require a full (unpadded) "
                             "previous chain")
        anchor_idx = p_idxs[p_n_real - 1]
        for i in idxs:
            if self.is_image_processed(i):
                raise ValueError("chain frames must be unprocessed")

        n_real = len(idxs)
        K = max(pad_to or n_real, n_real)
        idxs = list(idxs) + [idxs[-1]] * (K - n_real)
        kp_a, d_a, m_a, n_a = self._device_features(anchor_idx)
        feats = tuple(self._device_features(i) for i in idxs)
        cis = [self.image_cameras[i] for i in idxs]

        handles = self._dispatch_deferred_ba()
        self._pending_ba = ((getattr(self, "_pending_ba", None) or [])
                            + handles)

        tri_nts = [self._norm_threshold(options.tri_max_reproj_error, i)
                   for i in idxs]
        scal = np.zeros(12 + 12 * K, np.float32)
        scal[6] = options.match_max_ratio
        scal[7] = (options.match_max_distance
                   if options.match_max_distance > 0 else 1e9)
        scal[8] = options.tri_min_angle * np.pi / 180.0
        scal[9] = options.min_track_len
        self._chain_counter = getattr(self, "_chain_counter", 0) + 1
        scal[10] = self._chain_counter
        scal[11] = -1.0
        per = scal[12:].reshape(K, 12)
        per[:, 0] = [self._norm_threshold(options.ransac_max_reproj_error, i)
                     for i in idxs]
        per[:, 1] = tri_nts
        per[:, 2] = self.cam_models[cis]
        per[:, 3:12] = self.cam_params[cis]

        if not hasattr(self, "_base_key"):
            self._base_key = self._next_key()
        end_state, end_pose = p_out[3], p_out[4]
        out = register_chain_cont(
            self._base_key, kp_a, d_a, m_a, n_a, feats,
            end_state, end_pose, scal,
            p3p_trials=options.p3p_ransac_trials)
        self._copy_async(out)
        # prev_p2d/has_tri are None: resolved at complete time from the
        # store (the anchor has committed by then) + the pulled
        # has_tri_in[0] (the state the device actually anchored on).
        return (out, idxs, n_real, anchor_idx, None, None, tri_nts,
                options)

    @staticmethod
    def _delete_buffers(tree):
        """Explicitly free device buffers (PJRT defers the free until any
        in-flight consumer completes, so this is safe even when a cont
        chain still reads the end-state buffers). Relying on Python GC
        alone lets ~350 KB of outputs per chain pile up on the remote
        worker over long pipelined surveys."""
        for b in jax.tree_util.tree_leaves(tree):
            try:
                b.delete()
            except Exception:
                pass

    def chain_abandon(self, token):
        """Discard a speculative chain whose anchor never committed: pull
        its buffers (applying any pending BA results that were batched
        into the same stream) and drop the registration outputs."""
        self._pull_with_pending(token[0][:3])
        self._delete_buffers(token[0])

    def chain_complete(self, token, debug=False):
        """Complete HALF of process_chain_k: pull the dispatched chain's
        results (with any pending BA), run the host gates, and commit each
        frame. Returns the per-frame oks list (see process_chain_k)."""
        (out, idxs, n_real, prev_image_idx, prev_p2d, has_tri, tri_nts,
         options) = token
        rows_all, scalars_all, has_tri_in = self._pull_with_pending(
            out[:3])
        self._delete_buffers(out)
        if prev_p2d is None:
            # Continuation chain: the anchor must have committed by now
            # (the caller abandons the token otherwise).
            if not self.is_image_processed(prev_image_idx):
                raise ValueError(
                    "cont chain completed before its anchor committed — "
                    "use chain_abandon when the previous chain fails")
            prev_p2d = self.store.point2D_ids_of_image(
                self.image_idx_to_id[prev_image_idx])
            has_tri = has_tri_in[0] > 0.5

        oks = []
        anchor_idx = prev_image_idx
        anchor_p2d, anchor_has_tri = prev_p2d, has_tri
        for k, idx in enumerate(idxs[:n_real]):
            r = unpack_register(rows_all[k], scalars_all[k])
            ok = self._register_gates(idx, anchor_idx, r, options,
                                      debug=debug)
            if ok:
                # Commit classifies rows with the SAME derived has_tri the
                # device used; the anchor's p2d ids exist (it committed).
                ok = self._register_commit(idx, anchor_idx, r, options,
                                           anchor_p2d, anchor_has_tri,
                                           tri_nts[k], debug=debug)
            oks.append(bool(ok))
            if not ok:
                break
            if k + 1 < n_real:
                anchor_idx = idx
                anchor_p2d = self.store.point2D_ids_of_image(
                    self.image_idx_to_id[idx])
                anchor_has_tri = has_tri_in[k + 1] > 0.5
        return oks

    def _register_gates(self, image_idx, prev_image_idx, r, options,
                        debug=False):
        """Host-side failure gates on the pulled register_view scalars
        (reference sequential_mapper.cc:389-732)."""
        num_matches = int(r.num_matches)
        num_stable = int(r.num_stable)
        min_inl = rel2abs_threshold(options.ransac_min_inlier_threshold, num_stable)
        max_hom = rel2abs_threshold(options.max_homography_inliers, num_matches)
        if debug:
            print(
                f"DEBUG process({image_idx},{prev_image_idx}): "
                f"matches={num_matches} disp={float(r.med_disparity):.1f} "
                f"hom={int(r.num_hom_inliers)}/{max_hom} stable={num_stable} "
                f"p3p={int(r.num_p3p_inliers)}/{min_inl} "
                f"cost={float(r.final_cost):.2f}/{options.final_cost_threshold}"
            )
        if debug and self.debug_dumper is not None:
            kpp_h = self._features(prev_image_idx).keypoints
            kpc_h = self._features(image_idx).keypoints
            self.debug_dumper.dump_matches(
                self.num_proc_images, prev_image_idx, image_idx, kpp_h, kpc_h,
                r.matches, r.match_valid, tag="matches-all")
            self.debug_dumper.dump_matches(
                self.num_proc_images, prev_image_idx, image_idx, kpp_h, kpc_h,
                r.matches, r.match_valid, inlier=r.p3p_inlier,
                tag="matches-inlier")
        if num_matches == 0:
            return False
        if options.min_disparity > 0 and float(r.med_disparity) < \
                self._abs_disparity(options.min_disparity, image_idx):
            return False
        if int(r.num_hom_inliers) > max_hom:
            return False
        if num_stable < max(min_inl, 4):
            return False
        if not bool(r.p3p_success):
            return False
        if int(r.num_p3p_inliers) < min_inl:
            return False
        if float(r.final_cost) > options.final_cost_threshold:
            return False
        return True

    def _register_commit(self, image_idx, prev_image_idx, r, options,
                         prev_p2d, has_tri, tri_nt, debug=False):
        """Commit a successful registration: pose, track continuations, new
        triangulations, pair graph (reference :743-934)."""
        n_prev_feats = len(prev_p2d)
        # Commit pose.
        already = self.is_image_processed(image_idx)
        if already:
            curr_id = self.image_idx_to_id[image_idx]
        else:
            curr_id = self._add_image_to_store(image_idx)
            self.store.set_pose(curr_id, np.asarray(r.rvec), np.asarray(r.tvec))

        curr_p2d = self.store.point2D_ids_of_image(curr_id)
        matches = np.asarray(r.matches)
        valid = np.asarray(r.match_valid)
        track_err = np.asarray(r.track_reproj)
        Xnew = np.asarray(r.new_points3D)
        ep = np.asarray(r.new_reproj_prev)
        ec = np.asarray(r.new_reproj_curr)
        ang = np.asarray(r.new_tri_angle)
        dp = np.asarray(r.new_depth_prev)
        dc = np.asarray(r.new_depth_curr)
        min_ang = options.tri_min_angle * np.pi / 180.0

        # Vectorized commit (one native batch call per class of rows, not
        # a per-row Python/ctypes loop).
        rows = np.where(valid[:n_prev_feats])[0]
        jrows = matches[rows]
        # Continue track if reprojection in the new view is small
        # (reference :764-777).
        cont = has_tri[rows] & (track_err[rows] < tri_nt)
        # New triangulation gates (reference :784-810).
        angf = np.minimum(ang[rows], np.pi - ang[rows])
        new = (
            ~has_tri[rows]
            & (ep[rows] < tri_nt)
            & (ec[rows] < tri_nt)
            & (angf >= min_ang)
            & (dp[rows] > 0)
            & (dc[rows] > 0)
        )
        if cont.any():
            self.store.add_correspondences_bulk(
                prev_p2d[rows[cont]], curr_p2d[jrows[cont]]
            )
        if new.any():
            new_rows = rows[new]
            pids = self.store.add_correspondences_bulk(
                prev_p2d[new_rows], curr_p2d[jrows[new]]
            )
            self.store.sync()
            fresh = (
                self.store.point3D_valid[pids]
                & ~self.store.point3D_tri[pids]
            )
            for k in np.where(fresh)[0]:
                self.store.set_point3D(pids[k], Xnew[new_rows[k]])

        self.pair_graph.add(
            (min(image_idx, prev_image_idx), max(image_idx, prev_image_idx))
        )
        if debug and self.debug_dumper is not None:
            # Per-step track-length log + colored VRML scene of the current
            # image's points (reference sequential_mapper.cc:817-911).
            self.debug_dumper.dump_track_lengths(
                self.num_proc_images, image_idx, prev_image_idx,
                self.store, curr_id)
            self.debug_dumper.dump_scene_vrml(
                self.num_proc_images, image_idx, prev_image_idx,
                self.store, curr_id, min_track_len=options.min_track_len)
        return True

    # --------------------------------------------------------- loop closure

    def find_similar_images(self, image_idx, num_images=30):
        """Most similar processed images via the loop detector
        (reference sequential_mapper.cc:2086-2103)."""
        if self.loop_detector is None:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        f = self._features(image_idx)
        return self.loop_detector.query(f, num_images=num_images,
                                        image_idx=image_idx)

    def _batch_match_counts(self, image_idx, cand_idxs, options):
        """Match counts of image_idx against many candidates in ONE batched
        device call (pre-gate for loop closure — a full process() per
        candidate costs a whole register kernel; most candidates die at the
        match gate)."""
        if not len(cand_idxs):
            return np.zeros(0, np.int64)
        kpq, dq, mq, _ = self._device_features(image_idx)
        # Fixed batch of 32 (loop-detection queries return <= ~30): ONE
        # compiled executable instead of one per batch-size bucket. With a
        # mesh, 32 stays divisible by any power-of-two mesh; round up
        # otherwise so the candidate axis shards evenly.
        B = int(np.ceil(len(cand_idxs) / 32)) * 32
        if self.mesh is not None:
            S = self.mesh.devices.size
            B = int(np.ceil(B / S)) * S
        rows = list(cand_idxs) + [cand_idxs[0]] * (B - len(cand_idxs))
        dstack = jnp.stack([self._device_features(i)[1] for i in rows])
        mstack = jnp.stack([self._device_features(i)[2] for i in rows])

        if self.mesh is not None:
            from ..parallel.dist_register import dist_match_counts

            c = np.asarray(dist_match_counts(
                self.mesh, dq, mq, dstack, mstack,
                jnp.float32(options.match_max_ratio)))
            return c[: len(cand_idxs)]

        c = np.asarray(_match_counts_jit(
            dq, mq, dstack, mstack, jnp.float32(options.match_max_ratio)))
        return c[: len(cand_idxs)]

    def detect_loop(self, image_idx, num_images=30, num_nh_images=15,
                    nh_distance=30, options=None, verbose=False):
        """Try to close loops against the most similar processed images.

        Mirrors reference detect_loop (sequential_mapper.cc:1161-1215):
        candidates within `nh_distance` frames count against the
        `num_nh_images` neighborhood quota. Returns #successful closures.
        A batched matching pre-gate skips candidates that cannot pass the
        min-inlier threshold (beyond the reference, which pays a full
        process() per candidate).
        """
        if self.loop_detector is None:
            return 0
        options = options or SequentialMapperOptions()
        _t0 = _time.perf_counter()
        idxs, scores = self.find_similar_images(image_idx, num_images)
        self._count_time("detect_query_s", _time.perf_counter() - _t0)
        # Pre-gate: one batched matcher call over all candidates.
        _t0 = _time.perf_counter()
        cand = [int(i) for i in idxs]
        match_counts = self._batch_match_counts(image_idx, cand, options)
        self._count_time("detect_pregate_s", _time.perf_counter() - _t0)
        # Absolute min-inlier thresholds bound matches from below; relative
        # ones cannot be applied before matching, so only require a minimal
        # P3P sample then.
        t = options.ransac_min_inlier_threshold
        min_needed = max(4, int(t)) if t >= 1 else 4
        idxs = [i for i, c in zip(cand, match_counts) if c >= min_needed]

        # Pre-filter to candidates that could actually run, then register
        # the current image against ALL of them in ONE batched device call
        # (vs the reference's full process() per candidate); commits stay
        # sequential so track merging matches the sequential semantics.
        runnable = []
        for other in idxs:
            other = int(other)
            if other == image_idx or self.is_pair_processed(image_idx, other):
                continue
            # The batched kernel registers current against PROCESSED prevs;
            # the current image itself may be unregistered (rescue path) —
            # the first successful commit sets its pose, exactly like a
            # sequential process() would.
            if not self.is_image_processed(other):
                continue
            runnable.append(other)

        num_successes = 0
        num_nh = 0
        if runnable:
            _t0 = _time.perf_counter()
            results = self._batch_register_candidates(image_idx, runnable,
                                                      options)
            self._count_time("detect_register_s",
                             _time.perf_counter() - _t0)
            self._count("detect_runnable", len(runnable))
            for other, (r, prev_p2d, has_tri, tri_nt) in zip(runnable, results):
                distance = abs(other - image_idx)
                if not (num_nh < num_nh_images or distance > nh_distance):
                    continue
                if not self._register_gates(image_idx, other, r, options,
                                            debug=False):
                    continue
                if self._register_commit(image_idx, other, r, options,
                                         prev_p2d, has_tri, tri_nt):
                    if verbose:
                        print(f"Closed loop to image #{other}")
                    num_successes += 1
                    if distance <= nh_distance:
                        num_nh += 1
        self._count("loop_closures", num_successes)
        return num_successes

    def _batch_register_candidates(self, image_idx, cand_idxs, options):
        """Register `image_idx` against many processed candidates in one
        vmapped device call. Returns [(RegisterResult, prev_p2d, has_tri,
        tri_nt)] aligned with cand_idxs. The track states are snapshot at
        call time (commits between candidates only affect shared tracks,
        which the per-candidate add_correspondence merge handles)."""
        from .kernels import register_view_batch

        self.flush_ba()  # registration anchors on post-BA poses/points
        # Three fixed batch sizes {8, 16, 32}, smallest that fits: each
        # slot runs a FULL register kernel (2-NN match + P3P RANSAC +
        # refine), so padding a 5-candidate rescue call to 32 wastes 6x
        # the device work — while dynamic power-of-two buckets per exact
        # count paid a fresh XLA compile per new size. 32 covers the
        # default loop-detection candidate set (num_images=30) in ONE
        # device round-trip. With a mesh, sizes round up to a mesh
        # multiple and shard over devices.
        n = len(cand_idxs)
        CH = 8 if n <= 8 else (16 if n <= 16 else 32)
        if self.mesh is not None:
            S = self.mesh.devices.size
            CH = int(np.ceil(CH / S)) * S
        if n > CH:
            out = []
            for k in range(0, n, CH):
                out.extend(self._batch_register_candidates(
                    image_idx, cand_idxs[k:k + CH], options))
            return out
        B = CH
        padded = list(cand_idxs) + [cand_idxs[0]] * (B - n)

        states = [self._prev_track_state(i, options) for i in padded]
        feats = [self._device_features(i) for i in padded]
        kpc, dc_, mc_, ncn = self._device_features(image_idx)
        nt = self._norm_threshold(options.ransac_max_reproj_error, image_idx)
        tri_nt = self._norm_threshold(options.tri_max_reproj_error, image_idx)
        ci = self.image_cameras[image_idx]

        keys = jax.random.split(self._next_key(), B)
        args = (
            keys,
            jnp.stack([f[0] for f in feats]),
            jnp.stack([f[1] for f in feats]),
            jnp.stack([f[2] for f in feats]),
            jnp.stack([f[3] for f in feats]),
            kpc, dc_, mc_, ncn,
            jnp.asarray(np.stack([s[3] for s in states])),
            jnp.asarray(np.stack([s[1] for s in states])),
            jnp.asarray(np.stack([s[2] for s in states])),
            jnp.asarray(np.stack([s[4] for s in states]), jnp.float32),
            jnp.asarray(np.stack([s[5] for s in states]), jnp.float32),
            jnp.asarray(self.cam_params[ci]), jnp.asarray(self.cam_models[ci]),
            jnp.float32(options.match_max_ratio),
            jnp.float32(options.match_max_distance
                        if options.match_max_distance > 0 else 1e9),
            jnp.float32(nt),
        )
        if self.mesh is not None:
            from ..parallel.dist_register import dist_register_view_batch

            rows, scalars = dist_register_view_batch(
                self.mesh, *args,
                p3p_trials=options.p3p_ransac_trials,
            )
        else:
            rows, scalars = register_view_batch(
                *args,
                p3p_trials=options.p3p_ransac_trials,
            )
        rows, scalars = jax.device_get((rows, scalars))
        out = []
        for k in range(len(cand_idxs)):
            r = unpack_register(rows[k], scalars[k])
            out.append((r, states[k][0], states[k][1], tri_nt))
        return out

    def batch_register_pairs(self, pairs, options, closure=False):
        """Register many (curr_idx, prev_idx) pairs — distinct current
        images — in ONE device call (register_view_pairs); commits run
        sequentially with the usual gates. prev of every pair must be
        processed. Returns the per-pair success list.

        Used by the back-fill pass: the reference pays a full sequential
        process() per (skipped frame, neighbor) pair (mapper.cc:221-299).

        closure=True: the currents are ALREADY-REGISTERED images and each
        commit adds loop-closure correspondences (the batched final-sweep
        path) instead of treating a processed current as already done.
        """
        from .kernels import register_view_pairs

        if not pairs:
            return []
        # Pending async local-BA results must land first: registration
        # anchors on store poses/points (process() flushes on every pull;
        # this path must uphold the same invariant).
        self.flush_ba()
        # Three fixed chunk sizes {8, 16, 32}, smallest that fits (each
        # slot is a full register kernel — padding small back-fill calls
        # to 32 wastes device work; dynamic exact sizes each paid an XLA
        # compile). 32-wide chunks bound device memory too: 32 x ~8 MB of
        # 2-NN score intermediates at F=1024, and the 1000-image closure
        # sweep pays 4x fewer pull round trips than a fixed 8. With a mesh,
        # sizes round up to a mesh multiple: each device holds only its
        # B/S slice.
        n_real = len(pairs)
        MAX_B = 8 if n_real <= 8 else (16 if n_real <= 16 else 32)
        if self.mesh is not None:
            S = self.mesh.devices.size
            MAX_B = int(np.ceil(MAX_B / S)) * S
        if n_real > MAX_B:
            out = []
            for k in range(0, n_real, MAX_B):
                out.extend(self.batch_register_pairs(pairs[k:k + MAX_B],
                                                     options,
                                                     closure=closure))
            return out
        B = MAX_B
        # Host work only for the REAL pairs; pad the stacked arrays by
        # repeating row 0 (discarded at commit).
        padded = list(pairs) + [pairs[0]] * (B - n_real)

        states = [self._prev_track_state(p, options) for _, p in pairs]
        pf = [self._device_features(p) for _, p in pairs]
        cf = [self._device_features(c) for c, _ in pairs]
        nts = [self._norm_threshold(options.ransac_max_reproj_error, c)
               for c, _ in pairs]
        tri_nts = [self._norm_threshold(options.tri_max_reproj_error, c)
                   for c, _ in pairs]
        cis = [self.image_cameras[c] for c, _ in pairs]
        for _ in range(B - n_real):
            states.append(states[0])
            pf.append(pf[0])
            cf.append(cf[0])
            nts.append(nts[0])
            cis.append(cis[0])

        keys = jax.random.split(self._next_key(), B)
        args = (
            keys,
            jnp.stack([f[0] for f in pf]), jnp.stack([f[1] for f in pf]),
            jnp.stack([f[2] for f in pf]), jnp.stack([f[3] for f in pf]),
            jnp.stack([f[0] for f in cf]), jnp.stack([f[1] for f in cf]),
            jnp.stack([f[2] for f in cf]), jnp.stack([f[3] for f in cf]),
            jnp.asarray(np.stack([st[3] for st in states])),
            jnp.asarray(np.stack([st[1] for st in states])),
            jnp.asarray(np.stack([st[2] for st in states])),
            jnp.asarray(np.stack([st[4] for st in states]), jnp.float32),
            jnp.asarray(np.stack([st[5] for st in states]), jnp.float32),
            jnp.asarray(self.cam_params[cis]),
            jnp.asarray(self.cam_models[cis]),
            jnp.float32(options.match_max_ratio),
            jnp.float32(options.match_max_distance
                        if options.match_max_distance > 0 else 1e9),
            jnp.asarray(nts, jnp.float32),
        )
        if self.mesh is not None:
            from ..parallel.dist_register import dist_register_view_pairs

            rows, scalars = dist_register_view_pairs(
                self.mesh, *args,
                p3p_trials=options.p3p_ransac_trials,
            )
        else:
            rows, scalars = register_view_pairs(
                *args,
                p3p_trials=options.p3p_ransac_trials,
            )
        rows, scalars = jax.device_get((rows, scalars))
        out = []
        for k, (curr, prev) in enumerate(pairs):
            # Back-fill: every pair was built while `curr` was
            # unregistered; if an earlier pair (or chunk) registered it,
            # committing this one would inject 3-D points triangulated
            # with a pose that never got committed — match the
            # reference's break-on-first-success. (Closure mode registers
            # ALREADY-processed currents by design.)
            if not closure and self.is_image_processed(curr):
                out.append(True)
                continue
            if self.is_pair_processed(curr, prev):
                out.append(not closure)
                continue
            r = unpack_register(rows[k], scalars[k])
            ok = self._register_gates(curr, prev, r, options)
            if ok:
                ok = self._register_commit(curr, prev, r, options,
                                           states[k][0], states[k][1],
                                           tri_nts[k])
            out.append(bool(ok))
        return out

    def _batch_match_counts_pairs(self, pairs, options):
        """Match counts for MANY (a, b) image pairs in ONE device call.

        The per-query `_batch_match_counts` stacks the candidates' device
        descriptors per call (~250 calls x 32 stack dispatches for a
        1000-image sweep). Here ALL unique images' features
        upload as one (U, F, D) host-built stack and a single vmapped
        program gathers each pair's rows — the whole sweep's pre-gate
        becomes one round-trip. Shapes bucket (U to 64, P to 512) so
        repeat sweeps reuse the executable."""
        from ..ops.matching import match_brute_force

        if not pairs:
            return np.zeros(0, np.int64)
        imgs = sorted({i for p in pairs for i in p})
        row = {i: k for k, i in enumerate(imgs)}
        F = self.provider.capacity
        U = -(-len(imgs) // 64) * 64
        feats0 = self._features(imgs[0])
        D = feats0.descriptors.shape[1]
        dstack = np.zeros((U, F, D), np.float32)
        mstack = np.zeros((U, F), bool)
        for k, i in enumerate(imgs):
            f = self._features(i)
            dstack[k] = f.descriptors
            mstack[k] = f.mask
        P = -(-len(pairs) // 512) * 512
        ai = np.zeros(P, np.int32)
        bi = np.zeros(P, np.int32)
        ai[: len(pairs)] = [row[a] for a, b in pairs]
        bi[: len(pairs)] = [row[b] for a, b in pairs]

        @jax.jit
        def counts_fn(dstack, mstack, ai, bi, ratio):
            def one(p):
                a, b = p
                _, ok = match_brute_force(
                    dstack[a], dstack[b], mstack[a], mstack[b], ratio=ratio)
                return jnp.sum(ok)

            # lax.map with a bounded batch: a flat vmap over thousands of
            # pairs materializes (P, F, D) gathered operands at survey
            # scale; 64-pair chunks keep
            # the working set ~tens of MB with one compiled body.
            return jax.lax.map(one, (ai, bi), batch_size=64)

        c = np.asarray(counts_fn(
            jnp.asarray(dstack), jnp.asarray(mstack), jnp.asarray(ai),
            jnp.asarray(bi), jnp.float32(options.match_max_ratio)))
        return c[: len(pairs)]

    def batch_detect_closures(self, query_idxs, num_images=30,
                              nh_distance=30, options=None, verbose=False):
        """Cross-survey loop closures for MANY query images in batched
        device calls (the final-closure-sweep path): per query, voc-tree
        retrieval + one batched match-count pre-gate select the
        non-neighborhood candidates that can pass the inlier threshold;
        ALL surviving (query, candidate) pairs then register through the
        chunked register_view_pairs kernel with closure commits. The
        per-query sequential detect_loop costs one device round-trip per
        candidate set PER QUERY — at survey scale (250+ queries) that was
        the dominant post-pass cost. Returns #closures committed."""
        if self.loop_detector is None:
            return 0
        options = options or SequentialMapperOptions()
        t = options.ransac_min_inlier_threshold
        min_needed = max(4, int(t)) if t >= 1 else 4

        _t0 = _time.perf_counter()
        cand_pairs = []
        for q in query_idxs:
            if not self.is_image_processed(q):
                continue
            idxs, _ = self.find_similar_images(q, num_images)
            cand_pairs += [
                (q, int(c)) for c in idxs
                if int(c) != q
                and abs(int(c) - q) > nh_distance
                and self.is_image_processed(int(c))
                and not self.is_pair_processed(q, int(c))
            ]
        self._count_time("sweep_retrieval_s", _time.perf_counter() - _t0)
        if not cand_pairs:
            return 0
        _t0 = _time.perf_counter()
        counts = self._batch_match_counts_pairs(cand_pairs, options)
        jobs = [p for p, n in zip(cand_pairs, counts) if n >= min_needed]
        self._count_time("sweep_pregate_s", _time.perf_counter() - _t0)
        if not jobs:
            return 0
        _t0 = _time.perf_counter()
        got = self.batch_register_pairs(jobs, options, closure=True)
        self._count_time("sweep_register_s", _time.perf_counter() - _t0)
        self._count("sweep_jobs", len(jobs))
        self._count("sweep_cands", len(cand_pairs))
        n = 0
        for (q, c), ok in zip(jobs, got):
            if ok:
                n += 1
                if verbose:
                    print(f"Closed loop #{q} -> #{c}")
        self._count("sweep_closures", n)
        return n

    # ---------------------------------------------------------------- merge

    def merge(self, other, num_similar_images=15, num_skip_images=5,
              options=None, verbose=False):
        """Merge `other` into this mapper via cross-sequence loop closures +
        similarity alignment (reference sequential_mapper.cc:1218-1481).

        Returns True on success; on failure this mapper keeps extra loop
        closures but no cloned state.
        """
        import jax.numpy as jnp
        from ..ops.rotation import rotmat_from_rvec
        from ..ops.similarity import solve_umeyama, transform_points, transform_pose

        options = options or SequentialMapperOptions()
        self.flush_ba()
        other.flush_ba()
        before_common = [
            idx for idx in other.image_idx_to_id if self.is_image_processed(idx)
        ]

        # Try to close cross-loops on every num_skip_images-th other image —
        # all candidates of one query image registered in ONE batched device
        # call (the reference runs a full process() per candidate).
        other_idxs = sorted(other.image_idx_to_id.keys())
        for k, idx in enumerate(other_idxs):
            if num_skip_images and k % num_skip_images != 0:
                continue
            sim_idxs, _ = self.find_similar_images(idx, num_similar_images)
            cands = [
                int(c) for c in sim_idxs
                if int(c) != idx
                and not self.is_pair_processed(idx, int(c))
                and self.is_image_processed(int(c))
            ]
            if not cands:
                continue
            results = self._batch_register_candidates(idx, cands, options)
            for cand, (r, prev_p2d, has_tri, tri_nt) in zip(cands, results):
                if self._register_gates(idx, cand, r, options):
                    self._register_commit(idx, cand, r, options,
                                          prev_p2d, has_tri, tri_nt)

        # Images now processed in both mappers anchor the alignment.
        common = [
            idx for idx in other.image_idx_to_id if self.is_image_processed(idx)
        ]
        if len(common) < 3:
            # Fallback (beyond reference sequential_mapper.cc:1311-1315,
            # which just fails): widen the overlap retroactively via
            # SEQUENCE ADJACENCY — register frames that `other` processed
            # near this mapper's boundary directly into this map (exactly
            # the back-fill mechanism), so they become common anchors.
            # Covers --no-loop-detection runs and segments whose shared
            # overlap was eaten by a mid-overlap sub-map restart.
            mine = sorted(self.image_idx_to_id.keys())
            cand_pairs = []
            for idx in sorted(other.image_idx_to_id.keys()):
                if self.is_image_processed(idx):
                    continue
                below = [p for p in mine if p < idx]
                above = [p for p in mine if p > idx]
                if below:
                    cand_pairs.append((abs(idx - below[-1]), idx, below[-1]))
                if above:
                    cand_pairs.append((abs(idx - above[0]), idx, above[0]))
            cand_pairs.sort()
            pairs = [(c, p) for _, c, p in cand_pairs[:16]]
            if pairs:
                self.batch_register_pairs(pairs, options)
                common = [idx for idx in other.image_idx_to_id
                          if self.is_image_processed(idx)]
                if verbose and len(common) >= 3:
                    print(f"Merge overlap widened to {len(common)} common "
                          f"images via adjacency registration")
        if len(common) < 3:
            return False

        # Similarity transform other -> this from common camera centers.
        def centers(mapper, idxs):
            ids = [mapper.image_idx_to_id[i] for i in idxs]
            rv = mapper.store.image_rvecs[ids]
            tv = mapper.store.image_tvecs[ids]
            R = np.asarray(rotmat_from_rvec(jnp.asarray(rv, jnp.float32)))
            return -np.einsum("nij,nj->ni", R.transpose(0, 2, 1), tv)

        src = centers(other, common)
        dst = centers(self, common)
        T = solve_umeyama(jnp.asarray(src, jnp.float32), jnp.asarray(dst, jnp.float32))

        # Clone other's images with transformed poses.
        for idx in other_idxs:
            if self.is_image_processed(idx):
                continue
            oid = other.image_idx_to_id[idx]
            rv, tv = other.store.get_pose(oid)
            nrv, ntv = transform_pose(
                T, jnp.asarray(rv, jnp.float32), jnp.asarray(tv, jnp.float32)
            )
            new_id = self._add_image_to_store(idx)
            self.store.set_pose(new_id, np.asarray(nrv), np.asarray(ntv))

        # Clone other's tracks (transformed points) in BULK: one p2d-id
        # translation table (other store rows -> this store rows; both
        # mappers share the feature provider, so row r of an image is the
        # same keypoint in both), then every track's consecutive-pair
        # chain in ONE native add_correspondences call — the per-
        # observation Python/ctypes loop cost seconds when merging large
        # sub-maps.
        xyz_all = np.asarray(
            transform_points(T, jnp.asarray(other.store.point3D_xyz, jnp.float32))
        )
        other.store.sync()
        trans = np.full(other.store.num_points2D, -1, np.int64)
        for idx in other_idxs:
            oid = other.image_idx_to_id[idx]
            my_id = self.image_idx_to_id[idx]
            trans[other.store.point2D_ids_of_image(oid)] = (
                self.store.point2D_ids_of_image(my_id)
            )
        pairs_a, pairs_b, track_pids = [], [], []
        for pid, track in other.store.tracks.items():
            if not other.store.point3D_valid[pid] or len(track) < 2:
                continue
            arr = trans[np.asarray(track, np.int64)]
            pairs_a.append(arr[:-1])
            pairs_b.append(arr[1:])
            track_pids.append(pid)
        if pairs_a:
            new_pids = self.store.add_correspondences_bulk(
                np.concatenate(pairs_a), np.concatenate(pairs_b)
            )
            # Surviving pid of each cloned track = its LAST pair's result.
            last = np.cumsum([len(x) for x in pairs_a]) - 1
            self.store.sync()
            for pid, k in zip(track_pids, last):
                if not other.store.point3D_tri[pid]:
                    continue
                new_pid = int(new_pids[k])
                valid, tri = self.store.point3D_status(new_pid)
                if valid and not tri:
                    self.store.set_point3D(new_pid, xyz_all[pid])

        self.pair_graph |= other.pair_graph
        if verbose:
            print(
                f"Merged mappers with {len(common)} common images "
                f"({len(before_common)} before closure)"
            )
        return True

    # ------------------------------------------------------------- BA bridge

    def _apply_ba(self, pending, prefetched=None):
        """Pull + apply one async BA handle (sel_ids, pids, finalize)."""
        sel_ids, pids, finalize = pending
        new_poses, new_points, info = finalize(prefetched)
        self.apply_ba_result(
            sel_ids, np.asarray(new_poses), pids, np.asarray(new_points),
            point_errors=np.asarray(info["point_errors"])
            if "point_errors" in info else None,
        )
        if "cam_params" in info:
            self._adopt_cam_params(np.asarray(info["cam_params"]))
        return info

    @staticmethod
    def _copy_async(tree):
        """Enqueue non-blocking device->host copies of a pytree's buffers.

        On the in-order device stream a d2h copy executes behind every
        program enqueued before the copy — issuing it eagerly keeps later
        programs (the deferred BA solve) off the pull's critical path."""
        for buf in jax.tree_util.tree_leaves(tree):
            try:
                buf.copy_to_host_async()
            except AttributeError:
                pass

    def _dispatch_deferred_ba(self):
        """Dispatch ALL deferred local-BA problems (stashed by
        adjust_bundle with defer=True), in order; returns their async
        handles (possibly empty)."""
        deferred = getattr(self, "_deferred_ba", None) or []
        self._deferred_ba = []
        from ..ba import bundle_adjust_async

        handles = []
        for sel_ids, pids, prob, ba_options, n_obs in deferred:
            h = bundle_adjust_async(prob, ba_options, num_obs=n_obs)
            self._copy_async(h.fut)
            handles.append((sel_ids, pids, h))
        return handles

    def _pull_with_pending(self, out):
        """device_get `out` together with all pending BA futures (one
        round-trip), apply the BA results in dispatch order, and promote
        freshly dispatched deferred solves to pending."""
        newly = self._dispatch_deferred_ba()
        pending = getattr(self, "_pending_ba", None) or []
        if pending:
            vals, ba_vals = jax.device_get(
                (out, [p[2].fut for p in pending]))
            self._pending_ba = []
            for p, v in zip(pending, ba_vals):
                self._apply_ba(p, prefetched=v)
        else:
            vals = jax.device_get(out)
        self._pending_ba = (getattr(self, "_pending_ba", None) or []) + newly
        return vals

    def flush_ba(self, prefetched=None):
        """Make every in-flight/deferred BA result land in the store.

        prefetched: host values of the (single) PENDING solve's `fut` when
        the caller already pulled them in a batched device_get.
        """
        info = None
        pending = getattr(self, "_pending_ba", None) or []
        self._pending_ba = []
        for k, p in enumerate(pending):
            info = self._apply_ba(
                p, prefetched if (prefetched is not None and len(pending) == 1
                                  and k == 0) else None)
        for h in self._dispatch_deferred_ba():
            info = self._apply_ba(h)
        return info

    def _adopt_cam_params(self, new_k):
        """Self-calibration: adopt refined intrinsics (store + mapper) and
        drop cached normalized coordinates computed with the old ones."""
        new_k = new_k[: self.store.num_cameras]
        if np.allclose(new_k, self.store.camera_params, rtol=0, atol=0):
            return
        self.store.camera_params[:] = new_k
        for cam_idx, store_id in self._store_cam_ids.items():
            self.cam_params[cam_idx] = new_k[store_id]
        # Only normalized coordinates depend on intrinsics; device
        # descriptors stay cached.
        self._norm_cache.clear()
        self._dev_norm_cache.clear()

    def _align_model_to_rot_prior(self, fixed_image_idx, prior_rvec):
        """Rotate all poses + points into the rotation-prior frame.

        Counterpart of the reference's model re-alignment before adding
        rotation constraints (bundle_adjustment.cc:390-446): from the first
        fixed image's estimated rotation R_est and prior rotation R_pri
        (both world->cam; priors live in the IMU world frame), the frame
        rotation is A = R_pri^T @ R_est (x_imu = A x_model). Points map as
        X' = A X and poses as R' = R A^T with t unchanged, so after the
        alignment the fixed image's rotation equals its prior exactly and
        the free images' w*(R - R0) residuals compare in the priors' frame.
        """
        import jax.numpy as jnp
        from ..ops.rotation import rotmat_from_rvec, rvec_from_rotmat

        iid = self.image_idx_to_id[fixed_image_idx]
        R_est = np.asarray(rotmat_from_rvec(
            jnp.asarray(self.store.image_rvecs[iid], jnp.float32)))
        R_pri = np.asarray(rotmat_from_rvec(
            jnp.asarray(np.asarray(prior_rvec, np.float32))))
        A = R_pri.T @ R_est
        if np.abs(A - np.eye(3, dtype=A.dtype)).max() < 1e-7:
            return
        reg = np.where(self.store.image_registered[: self.store.num_images])[0]
        R = np.asarray(rotmat_from_rvec(
            jnp.asarray(self.store.image_rvecs[reg], jnp.float32)))
        self.store.image_rvecs[reg] = np.asarray(
            rvec_from_rotmat(jnp.asarray(R @ A.T)))
        valid = self.store.point3D_valid
        self.store.point3D_xyz[valid] = (
            self.store.point3D_xyz[valid] @ A.T.astype(np.float32))

    def adjust_bundle(
        self,
        free_image_idxs,
        fixed_image_idxs,
        fixed_x_image_idxs=(),
        ba_options=None,
        rot_priors=None,
        rot_prior_weight=0.0,
        gcp_point_ids=(),
        async_=False,
        defer=False,
    ):
        """Bundle-adjust a subset of images (reference adjust_bundle,
        sequential_mapper.cc:1030-1158). Returns the BA info dict.

        rot_priors: optional {image_idx: rvec prior} for IMU constraints.
        gcp_point_ids: store point3D ids to pin.
        defer (with async_): build the problem now but dispatch it only
        after the NEXT frame's register kernel (process() does this), so
        the register pull never waits behind the solve on the in-order
        device stream. The solve then starts from store state that is one
        local-BA flush staler — the windowed LM re-converges either way.
        """
        from ..ba import BAOptions, build_problem, bundle_adjust
        from ..ba import bundle_adjust_async
        from ..ba import BA_POSE_FIXED, BA_POSE_FIXED_X

        align = bool(rot_priors) and rot_prior_weight > 0
        if async_ and defer and not align:
            # Don't block on in-flight solves; deferred problems queue (a
            # chained frame run defers one window BA per frame). Bound the
            # queue: past 8 stashed problems something is wrong upstream —
            # land them before snapshotting state.
            if len(getattr(self, "_deferred_ba", None) or []) >= 8:
                self.flush_ba()
        else:
            self.flush_ba()  # results of a previous async solve land first
        if align:
            # IMU-frame pre-alignment (reference
            # bundle_adjustment.cc:390-446): rotate the ENTIRE model into
            # the constraint frame, computed from the first fixed image's
            # estimated vs prior rotation, BEFORE adding the per-image
            # rotation residuals. Without this the priors pull toward an
            # arbitrary SfM gauge frame. The flush above guarantees no
            # in-flight solve was built in the pre-alignment frame.
            for fi in list(fixed_image_idxs) + list(fixed_x_image_idxs):
                if fi in rot_priors and fi in self.image_idx_to_id:
                    self._align_model_to_rot_prior(fi, rot_priors[fi])
                    break
        ba_options = ba_options or BAOptions()
        sel_idxs = list(free_image_idxs) + list(fixed_image_idxs) + list(fixed_x_image_idxs)
        sel_ids = [self.image_idx_to_id[i] for i in sel_idxs]
        id_set = set(sel_ids)
        id_to_row = {iid: k for k, iid in enumerate(sel_ids)}
        states = (
            [0] * len(free_image_idxs)
            + [BA_POSE_FIXED] * len(fixed_image_idxs)
            + [BA_POSE_FIXED_X] * len(fixed_x_image_idxs)
        )
        poses = np.concatenate(
            [self.store.image_rvecs[sel_ids], self.store.image_tvecs[sel_ids]],
            axis=1,
        ).astype(np.float32)

        obs_img_raw, obs_pt_raw, obs_xy, _ = self.store.observation_table(
            min_track_len=ba_options.min_track_len, image_ids=sel_ids
        )
        row_of_id = np.full(self.store.num_images, -1, np.int32)
        for k, iid in enumerate(sel_ids):
            row_of_id[iid] = k
        obs_rows = row_of_id[obs_img_raw]
        keep = obs_rows >= 0
        if keep.sum() < 1:
            return None
        obs_img_raw = obs_img_raw[keep]
        obs_pt_raw = obs_pt_raw[keep]
        obs_xy = obs_xy[keep]
        obs_image = obs_rows[keep]
        # Points need >= 2 observations inside the problem to be solvable;
        # single-obs points are held fixed.
        pids, obs_point, counts = np.unique(
            obs_pt_raw, return_inverse=True, return_counts=True
        )
        obs_point = obs_point.astype(np.int32)
        points = self.store.point3D_xyz[pids].astype(np.float32)
        point_fixed = counts < 2
        if len(gcp_point_ids):
            point_fixed |= np.isin(pids, np.asarray(list(gcp_point_ids)))
        obs_cam = self.store.image_cameras[obs_img_raw].astype(np.int32)

        rp = np.zeros((len(sel_ids), 3), np.float32)
        rw = np.zeros((len(sel_ids),), np.float32)
        if rot_priors:
            for k, idx in enumerate(sel_idxs):
                if idx in rot_priors:
                    rp[k] = rot_priors[idx]
                    rw[k] = rot_prior_weight

        if (ba_options.refine_camera_params and not async_
                and len(obs_xy) > ba_options.selfcal_max_obs):
            # Two-stage self-calibration (see BAOptions.selfcal_max_obs):
            # stage 1 refines the shared intrinsics on an observation
            # subsample, stage 2 below runs the FULL problem with the
            # refined intrinsics held fixed.
            from dataclasses import replace as _dc_replace

            stride = int(np.ceil(len(obs_xy) / ba_options.selfcal_max_obs))
            sub = np.arange(0, len(obs_xy), stride)
            pids_s, obs_point_s, counts_s = np.unique(
                obs_pt_raw[sub], return_inverse=True, return_counts=True)
            point_fixed_s = counts_s < 2
            if len(gcp_point_ids):
                point_fixed_s |= np.isin(pids_s,
                                         np.asarray(list(gcp_point_ids)))
            prob_s = build_problem(
                poses, self.store.point3D_xyz[pids_s].astype(np.float32),
                self.store.camera_params.astype(np.float32),
                self.store.camera_models, obs_image[sub],
                obs_point_s.astype(np.int32), obs_cam[sub], obs_xy[sub],
                pose_states=states, point_fixed=point_fixed_s,
                rot_prior=rp, rot_prior_weight=rw, bucket=True, host=True,
            )
            _t0 = _time.perf_counter()
            _, _, info_s = bundle_adjust(
                prob_s,
                _dc_replace(ba_options, update_point3D_errors=False),
                num_obs=len(sub))
            self._count_time("ba_selfcal_s", _time.perf_counter() - _t0)
            self._count("ba_selfcal_iters", int(info_s.get("iterations", 0)))
            self._adopt_cam_params(np.asarray(info_s["cam_params"]))
            ba_options = _dc_replace(ba_options, refine_camera_params=False)

        prob = build_problem(
            poses, points, self.store.camera_params.astype(np.float32),
            self.store.camera_models, obs_image, obs_point, obs_cam, obs_xy,
            pose_states=states, point_fixed=point_fixed,
            rot_prior=rp, rot_prior_weight=rw, bucket=True, host=True,
            # Solver choice (exact dense Schur below
            # DENSE_SOLVER_MAX_CAMERAS, matrix-free CG above) happens in
            # _resolve_solver from the camera count.
        )
        n_obs = len(obs_xy)
        if async_ and defer:
            if not getattr(self, "_deferred_ba", None):
                self._deferred_ba = []
            self._deferred_ba.append((sel_ids, pids, prob, ba_options, n_obs))
            return None
        if async_:
            handle = bundle_adjust_async(prob, ba_options, num_obs=n_obs)
            self._copy_async(handle.fut)
            self._pending_ba = (getattr(self, "_pending_ba", None) or []) + [
                (sel_ids, pids, handle)]
            return None
        _t0 = _time.perf_counter()
        new_poses, new_points, info = bundle_adjust(prob, ba_options,
                                                    num_obs=n_obs)
        self._count_time("ba_solve_s", _time.perf_counter() - _t0)
        self.apply_ba_result(
            sel_ids, np.asarray(new_poses), pids, np.asarray(new_points),
            point_errors=np.asarray(info["point_errors"])
            if "point_errors" in info else None,
        )
        if "cam_params" in info:
            self._adopt_cam_params(np.asarray(info["cam_params"]))
        return info

    def adjust_global_bundle(self, ba_options=None, rot_priors=None,
                             rot_prior_weight=0.0, gcp_point_ids=()):
        """Global BA: first processed pose fixed, second's x-translation
        fixed (reference sequential_mapper.cc:1092-1158). With a mesh
        attached, the solve runs distributed (points/observations sharded,
        camera system psum-reduced — parallel/dist_ba.py) instead of
        single-device; results are identical up to collective reduction
        order (tests/test_parallel.py pipeline equality test)."""
        reg = [iid for iid in range(self.store.num_images)
               if self.store.image_registered[iid]]
        if len(reg) < 2:
            return None
        idxs = [self.image_id_to_idx[iid] for iid in reg]
        if self.mesh is not None:
            return self._adjust_global_bundle_dist(
                idxs, ba_options=ba_options, rot_priors=rot_priors,
                rot_prior_weight=rot_prior_weight,
                gcp_point_ids=gcp_point_ids)
        return self.adjust_bundle(
            idxs[2:], [idxs[0]], [idxs[1]], ba_options=ba_options,
            rot_priors=rot_priors, rot_prior_weight=rot_prior_weight,
            gcp_point_ids=gcp_point_ids,
        )

    def _adjust_global_bundle_dist(self, idxs, ba_options=None,
                                   rot_priors=None, rot_prior_weight=0.0,
                                   gcp_point_ids=()):
        """Distributed global BA over `self.mesh` — the product path for
        the solve the reference hands to Ceres SPARSE_SCHUR threading
        (bundle_adjustment.cc:554-569): 3-D points and their observations
        shard across devices (point-disjoint, so point-block elimination
        and back-substitution stay shard-local), poses replicate, and the
        reduced camera system is psum-reduced per LM iteration.

        Self-calibration runs as the usual two-stage split: stage 1
        refines the shared intrinsics on an observation subsample on ONE
        device (intrinsics are a handful of scalars — no reason to
        distribute), stage 2 solves the full problem on the mesh with the
        refined intrinsics held fixed.
        """
        from ..ba import BAOptions, build_problem, bundle_adjust
        from ..ba import BA_POSE_FIXED, BA_POSE_FIXED_X
        from ..ba.core import point_mean_errors
        from ..parallel.dist_ba import dist_bundle_adjust, partition_problem

        ba_options = ba_options or BAOptions()
        align = bool(rot_priors) and rot_prior_weight > 0
        if align:
            for fi in idxs[:2]:
                if fi in rot_priors:
                    self._align_model_to_rot_prior(fi, rot_priors[fi])
                    break

        (image_ids, poses, pids, points, obs_image, obs_point, obs_cam,
         obs_xy) = self.ba_problem_arrays(
            min_track_len=ba_options.min_track_len)
        if len(obs_xy) == 0:
            return None
        states = [0] * len(image_ids)
        states[0] = BA_POSE_FIXED
        if len(states) > 1:
            states[1] = BA_POSE_FIXED_X
        counts = np.bincount(obs_point, minlength=len(points))
        point_fixed = counts < 2
        if len(gcp_point_ids):
            point_fixed |= np.isin(pids, np.asarray(list(gcp_point_ids)))

        rp = np.zeros((len(image_ids), 3), np.float32)
        rw = np.zeros((len(image_ids),), np.float32)
        if rot_priors:
            for k, iid in enumerate(image_ids):
                idx = self.image_id_to_idx[iid]
                if idx in rot_priors:
                    rp[k] = rot_priors[idx]
                    rw[k] = rot_prior_weight

        if ba_options.refine_camera_params:
            # Stage 1: selfcal on a single-device subsample.
            from dataclasses import replace as _dc_replace

            stride = max(int(np.ceil(len(obs_xy) /
                                     ba_options.selfcal_max_obs)), 1)
            sub = np.arange(0, len(obs_xy), stride)
            pids_s, obs_point_s, counts_s = np.unique(
                obs_point[sub], return_inverse=True, return_counts=True)
            point_fixed_s = counts_s < 2
            prob_s = build_problem(
                poses, points[pids_s],
                self.store.camera_params.astype(np.float32),
                self.store.camera_models, obs_image[sub],
                obs_point_s.astype(np.int32), obs_cam[sub], obs_xy[sub],
                pose_states=states, point_fixed=point_fixed_s,
                rot_prior=rp, rot_prior_weight=rw, bucket=True, host=True,
            )
            _, _, info_s = bundle_adjust(
                prob_s,
                _dc_replace(ba_options, update_point3D_errors=False),
                num_obs=len(sub))
            self._adopt_cam_params(np.asarray(info_s["cam_params"]))

        S = self.mesh.devices.size
        stacked, new_index, per_shard = partition_problem(
            poses, points, self.store.camera_params.astype(np.float32),
            self.store.camera_models, obs_image, obs_point, obs_cam, obs_xy,
            num_shards=S, pose_states=states, point_fixed=point_fixed,
            rot_prior=rp, rot_prior_weight=rw, with_pairs=False,
            bucket=True,
        )
        new_poses, new_points_perm, cost, init_cost, iters = (
            dist_bundle_adjust(
                self.mesh, stacked,
                scale=ba_options.loss_scale_factor,
                lambda_init=ba_options.lambda_init,
                max_iters=ba_options.max_num_iterations,
                axis=self.mesh.axis_names[0],
                solver="auto", per_shard=per_shard,
            ))
        new_poses = np.asarray(new_poses)[: len(image_ids)]
        new_points = np.asarray(new_points_perm)[new_index]

        point_errors = None
        if ba_options.update_point3D_errors:
            # Per-point mean residuals on one device (read-only pass).
            prob_e = build_problem(
                new_poses, new_points,
                self.store.camera_params.astype(np.float32),
                self.store.camera_models, obs_image, obs_point, obs_cam,
                obs_xy, pose_states=states, point_fixed=point_fixed,
                bucket=True, host=True,
            )
            prob_e = jax.tree.map(jnp.asarray, prob_e)
            point_errors = np.asarray(point_mean_errors(
                prob_e, prob_e.poses, prob_e.points))[: len(points)]

        self.apply_ba_result(image_ids, new_poses, pids, new_points,
                             point_errors=point_errors)
        return {
            "iterations": int(iters),
            "initial_cost": float(init_cost),
            "final_cost": float(cost),
            "distributed": S,
        }

    def ba_problem_arrays(self, min_track_len=2):
        """Arrays for bundle adjustment over the current map.

        Returns (image_ids, poses, point_ids, points, obs arrays, cam arrays)
        with image/point rows indexed densely in the returned order.
        """
        self.flush_ba()
        image_ids = [iid for iid in range(self.store.num_images)
                     if self.store.image_registered[iid]]
        poses = np.concatenate(
            [self.store.image_rvecs[image_ids], self.store.image_tvecs[image_ids]],
            axis=1,
        ).astype(np.float32)

        obs_img_raw, obs_pt_raw, obs_xy, _ = self.store.observation_table(
            min_track_len=min_track_len
        )
        pids = np.unique(obs_pt_raw)
        points = self.store.point3D_xyz[pids].astype(np.float32)

        # Dense row maps via searchsorted over the sorted id arrays — the
        # previous per-observation dict lookups were interpreter-bound at
        # the 344k-obs scale.
        image_ids_arr = np.asarray(image_ids, np.int64)
        obs_image = np.searchsorted(image_ids_arr, obs_img_raw).astype(np.int32)
        obs_point = np.searchsorted(pids, obs_pt_raw).astype(np.int32)
        obs_cam = self.store.image_cameras[obs_img_raw].astype(np.int32)
        return (
            image_ids,
            poses,
            pids,
            points,
            obs_image,
            obs_point,
            obs_cam,
            obs_xy.astype(np.float32),
        )

    def apply_ba_result(self, image_ids, poses, point_ids, points,
                        point_errors=None):
        ids = np.asarray(image_ids, np.int64)
        self.store.image_rvecs[ids] = poses[: len(ids), :3]
        self.store.image_tvecs[ids] = poses[: len(ids), 3:]
        pids = np.asarray(point_ids, np.int64)
        self.store.point3D_xyz[pids] = points[: len(pids)]
        if point_errors is not None:
            self.store.point3D_error[pids] = point_errors[: len(pids)]
