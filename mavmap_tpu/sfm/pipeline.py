"""End-to-end mapping pipeline — counterpart of reference src/mapper.cc.

Implements the orchestration loop (mapper.cc:563-1257): initial-pair
search, sequential processing with frame skipping, loop-detection rescue,
sliding-window local BA, periodic loop detection, sub-map restart on
unrecoverable failure, post-pass back-fill of skipped frames, global BA per
sub-map, greedy pairwise merging, ground-control-point geo-registration,
point-cloud filtering, and output writing.
"""

from dataclasses import dataclass, field

import numpy as np

from ..ba import BAOptions
from ..utils.mathx import rel2abs_threshold
from .mapper import SequentialMapper
from .options import SequentialMapperOptions


@dataclass
class PipelineOptions:
    """CLI-level options (names mirror mapper.cc flags, SURVEY §5.6)."""

    start_image_idx: int = 0
    end_image_idx: int = -1
    first_image_idx: int = -1   # initial pair: first image (default start)
    second_image_idx: int = -1  # initial pair: second image (default auto)
    max_subsequent_trials: int = 30
    failure_skip_images: int = 1      # restart offset for a new sub-map
    failure_max_image_dist: int = 10  # accepted for parity; unused in the
                                      # reference too (declared, never read)
    local_ba_window_size: int = 8
    loop_detection: bool = True
    loop_detection_period: int = 20
    loop_detection_num_images: int = 30
    loop_detection_num_nh_images: int = 15
    loop_detection_nh_dist: int = 30
    merge: bool = True
    merge_num_skip_images: int = 5
    min_track_len: int = 3
    final_cost_threshold: float = 2.0
    init_max_homography_inliers: float = 0.7
    max_homography_inliers: float = 0.8
    init_min_disparity: float = 0.0
    min_disparity: float = 0.0
    match_max_ratio: float = 0.9
    match_max_distance: float = -1.0
    ransac_min_inlier_threshold: float = 30
    ransac_min_inlier_stop: float = 0.6  # parity; fixed-trial RANSAC ignores
    ransac_max_reproj_error: float = 4.0
    tri_max_reproj_error: float = 4.0
    init_tri_min_angle: float = 10.0
    tri_min_angle: float = 1.0
    loss_scale_factor: float = 1.0
    essential_ransac_trials: int = 512
    p3p_ransac_trials: int = 512
    constrain_rotation: bool = False
    constrain_rotation_weight: float = 0.0
    use_control_points: bool = False
    filter_max_error: float = 0.0
    process_prev_prev: bool = False
    ba_local_max_iters: int = 15
    ba_global_max_iters: int = 50
    # LM relative-cost-decrease stop for the GLOBAL solves (Ceres
    # function_tolerance analog; local windows keep the BAOptions default).
    ba_function_tolerance: float = 1e-4
    verbose: bool = True
    # The reference refines intrinsics in EVERY bundle adjustment by
    # default (mapper.cc:878-885) — both flags default true; the initial
    # two-view bundle keeps refine off (mapper.cc:1059).
    refine_camera_params: bool = True
    local_ba_refine_camera_params: bool = True
    # Register `chain_len` consecutive frames per device program (frame k
    # anchors on device-derived track state from frame k-1): one pull
    # round-trip per CHAIN. Host gates still veto each frame; failures
    # fall back to the sequential path. Local BA runs once per committed
    # frame (deferred onto the device stream behind the next chain).
    chain_frames: bool = True
    chain_len: int = 4
    # Speculative chain pipelining: dispatch chain k+1 anchored on chain
    # k's device-resident end state BEFORE pulling chain k, so the pull
    # round-trip + host commit overlap the next chain's device work
    # (mapper.chain_dispatch_cont). A mid-chain failure abandons the
    # speculation and falls back to a host-anchored dispatch. Disabled
    # automatically under constrain_rotation (the IMU pre-alignment
    # rotates the model frame between chains, which would orphan a chain
    # anchored on pre-rotation device state).
    #
    # Default OFF everywhere, INCLUDING the recorded bench (bench.py
    # measures this product configuration); it has no measurement on the
    # GPU yet (ROADMAP D1). Opt-in via --pipeline-chains.
    pipeline_chains: bool = False
    # Segment-parallel mapping (beyond the reference, which is strictly
    # one-frame-at-a-time): partition [start, end] into `parallel_segments`
    # contiguous segments, map each with its own SequentialMapper, and
    # interleave their chain dispatch/complete so one segment's pull
    # round-trip + host commit overlap the device work of the others.
    # Adjacent segments share `segment_overlap` frames so the post-pass
    # merge aligns sub-maps on common images even without a voc tree.
    parallel_segments: int = 1
    segment_overlap: int = 4  # merge needs >= 3 common images
    # Post-pass closure sweeps (beyond the reference): after the first
    # global BA, query every `final_closure_step`-th registered image for
    # NON-neighborhood loop closures (batched candidate registration) and
    # re-run global BA; repeat up to `final_closure_sweeps` rounds or until
    # a sweep adds nothing. Attacks long-survey drift: the in-sequence
    # periodic detection only closes loops at the moment a row is revisited
    # with still-drifted poses, while this sweep matches against the
    # globally-adjusted map.
    final_closure_sweeps: int = 1
    # Query every 2nd registered frame: A/B'd at 1000 images vs step 4 —
    # 560 vs 293 committed closures and ATE 0.0286 vs 0.0310 (the batched
    # pre-gate amortizes the extra queries; its time on the H100 is not
    # measured).
    final_closure_step: int = 2
    # Device mesh (beyond the reference, which is single-process): 1 =
    # single-device, 0 = all visible devices, N > 1 = first N devices.
    # With >1 device the global BA runs distributed (points/observations
    # sharded, camera system psum-reduced) and the batched fan-outs
    # (back-fill pairs, closure candidates, match pre-gates) shard over
    # the mesh. Results match single-device up to collective reduction
    # order (tests/test_parallel.py).
    mesh_devices: int = 1
    # Periodic map checkpointing (beyond the reference, §5.4 mandate):
    # every `checkpoint_period` committed frames the main mapper's full
    # state (map + loop-retrieval DB) is written to `checkpoint_path`;
    # run_pipeline(resume_from=...) continues the sequential loop from the
    # last checkpointed frame.
    checkpoint_period: int = 0
    checkpoint_path: str = ""
    debug: bool = False
    debug_path: str = ""


def _mapper_options(opts: PipelineOptions, initial=False, num_proc=1000000):
    # Bootstrap ramp: the reference drops min_track_len to 2 until more than
    # 2 * min_track_len images are processed (mapper.cc:195,236,765-770) —
    # otherwise the 3rd image could never find 'stable' tracks.
    mtl = 2 if (initial or num_proc <= 2 * opts.min_track_len) else opts.min_track_len
    return SequentialMapperOptions(
        final_cost_threshold=opts.final_cost_threshold,
        tri_min_angle=opts.init_tri_min_angle if initial else opts.tri_min_angle,
        max_homography_inliers=(opts.init_max_homography_inliers if initial
                                else opts.max_homography_inliers),
        min_disparity=opts.init_min_disparity if initial else opts.min_disparity,
        match_max_ratio=opts.match_max_ratio,
        match_max_distance=opts.match_max_distance,
        ransac_min_inlier_threshold=opts.ransac_min_inlier_threshold,
        ransac_min_inlier_stop=opts.ransac_min_inlier_stop,
        ransac_max_reproj_error=opts.ransac_max_reproj_error,
        tri_max_reproj_error=opts.tri_max_reproj_error,
        essential_ransac_trials=opts.essential_ransac_trials,
        p3p_ransac_trials=opts.p3p_ransac_trials,
        loop_detection_num_images=opts.loop_detection_num_images,
        min_track_len=mtl,
    )


@dataclass
class PipelineResult:
    mappers: list
    records: list = None
    control_point_results: list = None
    timings: dict = None  # per-stage wall seconds

    @property
    def main_mapper(self):
        return max(self.mappers, key=lambda m: m.num_proc_images)

    def num_registered(self):
        return sum(m.num_proc_images for m in self.mappers)


def _local_ba(mapper, opts: PipelineOptions, rot_priors=None, drop_last=0):
    reg = sorted(mapper.image_idx_to_id.keys(),
                 key=lambda i: mapper.image_idx_to_id[i])
    if drop_last:
        reg = reg[:-drop_last]
    window = reg[-opts.local_ba_window_size:]
    if len(window) <= 2:
        return
    mapper.adjust_bundle(
        window[2:], window[:2],
        ba_options=BAOptions(max_num_iterations=opts.ba_local_max_iters,
                             min_track_len=opts.min_track_len,
                             loss_scale_factor=opts.loss_scale_factor,
                             refine_camera_params=opts.local_ba_refine_camera_params),
        rot_priors=rot_priors if opts.constrain_rotation else None,
        rot_prior_weight=opts.constrain_rotation_weight,
        async_=True,  # selfcal dispatches async too (bundle_adjust_async)
        # Deferred dispatch: the solve enters the device stream only after
        # the NEXT frame's register kernel, so the per-frame pull waits for
        # the register program alone (solve results land one frame later).
        defer=True,
    )


def _final_closure_sweeps(mapper, opts: PipelineOptions, rot_priors=None):
    """Post-global-BA closure densification (see PipelineOptions fields).

    Returns the total number of closures added across rounds."""
    if mapper.loop_detector is None or mapper.num_proc_images < 3:
        return 0
    total = 0
    for _ in range(opts.final_closure_sweeps):
        seq = _mapper_options(opts, num_proc=mapper.num_proc_images)
        reg = sorted(mapper.image_idx_to_id.keys())
        # Batched across ALL query images of the sweep: retrieval +
        # match-count pre-gates select candidate pairs, then one chunked
        # register_view_pairs pass commits the closures — the per-query
        # sequential detect_loop was the dominant post-pass cost at
        # survey scale.
        added = mapper.batch_detect_closures(
            reg[:: max(opts.final_closure_step, 1)],
            num_images=opts.loop_detection_num_images,
            nh_distance=opts.loop_detection_nh_dist,
            options=seq, verbose=False)
        if added == 0:
            break
        if opts.verbose:
            print(f"Closure sweep added {added} closures; re-running "
                  f"global BA")
        # Re-BA with intrinsics HELD at the pre-sweep solution: the global
        # BA that preceded this sweep already converged self-calibration on
        # >99% of these observations, and closure commits only add
        # correspondences / merge tracks — re-running the two-stage selfcal
        # was A/B'd at 1000 images (ATE 0.0266 vs 0.0263, focal unchanged
        # at +0.09%) and only cost time.
        _global_ba(mapper, opts, rot_priors, refine_cams=False)
        total += added
    return total


def _global_ba(mapper, opts: PipelineOptions, rot_priors=None,
               update_errors=False, gcp_point_ids=(), max_iters=None,
               refine_cams=None):
    info = mapper.adjust_global_bundle(
        BAOptions(max_num_iterations=(max_iters if max_iters is not None
                                      else opts.ba_global_max_iters),
                  function_tolerance=opts.ba_function_tolerance,
                  min_track_len=opts.min_track_len,
                  loss_scale_factor=opts.loss_scale_factor,
                  refine_camera_params=(opts.refine_camera_params
                                        if refine_cams is None
                                        else refine_cams),
                  update_point3D_errors=update_errors),
        rot_priors=rot_priors if opts.constrain_rotation else None,
        rot_prior_weight=opts.constrain_rotation_weight,
        gcp_point_ids=gcp_point_ids,
    )
    mapper._count("global_ba_runs")
    if info:
        mapper._count("global_ba_iters", int(info.get("iterations", 0)))
    return info


def process_remaining_images(mapper, start_idx, end_idx, opts: PipelineOptions):
    """Back-fill skipped frames against their nearest processed neighbors
    (reference mapper.cc:221-299). All (skipped frame, neighbor) pairs of a
    sweep register in ONE batched device call; sweeps repeat while frames
    keep landing (a newly filled frame becomes a neighbor for the next
    sweep, like the reference's incremental 'processed' update)."""
    seq_opts = _mapper_options(opts)
    num = 0
    max_sweeps = max(end_idx - start_idx + 1, 1)  # chained gaps: one frame
    for _ in range(max_sweeps):                   # per sweep worst-case
        processed = sorted(mapper.image_idx_to_id.keys())
        if not processed:
            return num
        pairs = []
        for idx in range(start_idx, end_idx + 1):
            if mapper.is_image_processed(idx):
                continue
            below = [p for p in processed if p < idx]
            above = [p for p in processed if p > idx]
            if below:
                pairs.append((idx, below[-1]))
            if above:
                pairs.append((idx, above[0]))
        if not pairs:
            break
        got = mapper.batch_register_pairs(pairs, seq_opts)
        for (idx, cand), ok in zip(pairs, got):
            if ok and opts.verbose:
                print(f"Processed remaining image #{idx} against #{cand}")
        # A frame may appear in two pairs (below+above); count frames once.
        filled = {idx for (idx, _), ok in zip(pairs, got) if ok}
        num += len(filled)
        if not filled:
            break
    return num


def merge_mappers(mappers, opts: PipelineOptions):
    """Greedy pairwise merge, always smaller into larger
    (reference mapper.cc:302-379)."""
    seq_opts = _mapper_options(opts)
    mappers = list(mappers)
    merged = True
    while merged and len(mappers) > 1:
        merged = False
        mappers.sort(key=lambda m: -m.num_proc_images)
        for i in range(len(mappers)):
            for j in range(len(mappers) - 1, i, -1):
                big, small = mappers[i], mappers[j]
                if big.merge(small, num_similar_images=opts.loop_detection_num_images,
                             num_skip_images=opts.merge_num_skip_images,
                             options=seq_opts, verbose=opts.verbose):
                    del mappers[j]
                    merged = True
            if merged:
                break
    return mappers


def filter_point_cloud(mapper, max_error):
    """Delete 3-D points with mean reprojection error above threshold
    (reference mapper.cc:382-402). Requires point errors from a prior BA
    with update_point3D_errors."""
    doomed = [
        pid
        for pid in list(mapper.store.tracks.keys())
        if mapper.store.point3D_valid[pid]
        and mapper.store.point3D_error[pid] > max_error
    ]
    for pid in doomed:
        mapper.store.delete_point3D(pid)
    return len(doomed)


def apply_control_points(mapper, control_points, opts: PipelineOptions):
    """Geo-registration with ground control points
    (reference mapper.cc:405-560).

    1. Triangulate each control point from its observations in processed
       images (multiview DLT with current poses).
    2. Umeyama model->GCP-frame similarity from the FIXED control points.
    3. Transform all poses and points.
    4. Global BA with fixed GCPs pinned (their observations as extra
       residual blocks).
    Returns [(cp, est_xyz, track_len, mean_residual)].
    """
    import jax.numpy as jnp
    from ..ba import build_problem, bundle_adjust, BAOptions as BAO
    from ..ba import BA_POSE_FIXED
    from ..models import camera as cam
    from ..ops.projection import compose_proj_matrix, calc_reproj_errors
    from ..ops.similarity import solve_umeyama, transform_points, transform_pose
    from ..ops.triangulation import triangulate_points_multiview

    # --- triangulate control points from current model
    estimates = []
    for cp in control_points:
        projs, obs_n, obs_px, imgs = [], [], [], []
        for (image_idx, x, y) in cp.points2D:
            if not mapper.is_image_processed(image_idx):
                continue
            iid = mapper.image_idx_to_id[image_idx]
            rv, tv = mapper.store.get_pose(iid)
            projs.append(
                np.asarray(
                    compose_proj_matrix(
                        jnp.asarray(rv, jnp.float32), jnp.asarray(tv, jnp.float32)
                    )
                )
            )
            ci = mapper.image_cameras[image_idx]
            n = cam.image2normalized_np(
                np.asarray([x, y], np.float32),
                int(mapper.cam_models[ci]),
                mapper.cam_params[ci],
            )
            obs_n.append(np.asarray(n))
            obs_px.append((x, y))
            imgs.append(image_idx)
        if len(projs) < 2:
            estimates.append(None)
            continue
        X = triangulate_points_multiview(
            jnp.asarray(np.stack(projs), jnp.float32),
            jnp.asarray(np.stack(obs_n), jnp.float32),
            jnp.ones(len(projs), bool),
        )
        estimates.append((np.asarray(X), imgs, obs_px, obs_n))

    fixed_src, fixed_dst = [], []
    for cp, est in zip(control_points, estimates):
        if cp.fixed and est is not None:
            fixed_src.append(est[0])
            fixed_dst.append(cp.xyz)
    if len(fixed_src) >= 3:
        T = solve_umeyama(
            jnp.asarray(np.stack(fixed_src), jnp.float32),
            jnp.asarray(np.stack(fixed_dst), jnp.float32),
        )
        # Transform the whole model.
        reg_ids = [iid for iid in range(mapper.store.num_images)
                   if mapper.store.image_registered[iid]]
        for iid in reg_ids:
            rv, tv = mapper.store.get_pose(iid)
            nrv, ntv = transform_pose(
                T, jnp.asarray(rv, jnp.float32), jnp.asarray(tv, jnp.float32)
            )
            mapper.store.image_rvecs[iid] = np.asarray(nrv)
            mapper.store.image_tvecs[iid] = np.asarray(ntv)
        valid = mapper.store.point3D_valid
        mapper.store.point3D_xyz[valid] = np.asarray(
            transform_points(
                T, jnp.asarray(mapper.store.point3D_xyz[valid], jnp.float32)
            )
        )
        # Re-triangulate estimates in the new frame.
        for k, est in enumerate(estimates):
            if est is not None:
                X, imgs, obs_px, obs_n = est
                X = np.asarray(
                    transform_points(T, jnp.asarray(X, jnp.float32))
                )
                estimates[k] = (X, imgs, obs_px, obs_n)

    # --- global BA with GCP residuals appended
    (image_ids, poses, point_ids, points, obs_image, obs_point, obs_cam,
     obs_xy) = mapper.ba_problem_arrays(min_track_len=opts.min_track_len)
    id_to_row = {iid: k for k, iid in enumerate(image_ids)}
    n_pts = len(points)
    extra_pts, extra_fixed = [], []
    extra_obs_img, extra_obs_pt, extra_obs_cam, extra_obs_xy = [], [], [], []
    gcp_rows = []
    for cp, est in zip(control_points, estimates):
        if est is None:
            gcp_rows.append(None)
            continue
        X, imgs, obs_px, _ = est
        row = n_pts + len(extra_pts)
        gcp_rows.append(row)
        extra_pts.append(cp.xyz if cp.fixed else X)
        extra_fixed.append(cp.fixed)
        for image_idx, (x, y) in zip(imgs, obs_px):
            iid = mapper.image_idx_to_id[image_idx]
            extra_obs_img.append(id_to_row[iid])
            extra_obs_pt.append(row)
            extra_obs_cam.append(
                mapper._store_cam_ids[int(mapper.image_cameras[image_idx])]
            )
            extra_obs_xy.append((x, y))

    if extra_pts:
        points = np.concatenate([points, np.asarray(extra_pts, np.float32)])
        obs_image = np.concatenate([obs_image, np.asarray(extra_obs_img, np.int32)])
        obs_point = np.concatenate([obs_point, np.asarray(extra_obs_pt, np.int32)])
        obs_cam = np.concatenate([obs_cam, np.asarray(extra_obs_cam, np.int32)])
        obs_xy = np.concatenate([obs_xy, np.asarray(extra_obs_xy, np.float32)])

    point_fixed = np.zeros(len(points), bool)
    for row, fx in zip(range(n_pts, len(points)), extra_fixed):
        point_fixed[row] = fx
    # Gauge is provided by the pinned GCPs when >= 3 fixed ones exist;
    # otherwise fix the first two poses as usual.
    n_fixed_gcp = int(sum(extra_fixed))
    if n_fixed_gcp >= 3:
        states = [0] * len(image_ids)
    else:
        states = [BA_POSE_FIXED if k < 1 else 0 for k in range(len(image_ids))]
        if len(states) > 1:
            from ..ba import BA_POSE_FIXED_X
            states[1] = BA_POSE_FIXED_X

    prob = build_problem(
        poses, points, mapper.store.camera_params.astype(np.float32),
        mapper.store.camera_models, obs_image, obs_point, obs_cam, obs_xy,
        pose_states=states, point_fixed=point_fixed, bucket=True, host=True,
    )
    new_poses, new_points, info = bundle_adjust(
        prob, BAO(max_num_iterations=opts.ba_global_max_iters,
                  update_point3D_errors=True,
                  min_track_len=2)
    )
    new_points = np.asarray(new_points)
    errors = np.asarray(info["point_errors"])
    mapper.apply_ba_result(image_ids, np.asarray(new_poses), point_ids,
                           new_points[:n_pts], errors[:n_pts])

    results = []
    for cp, row in zip(control_points, gcp_rows):
        if row is None:
            results.append((cp, None, 0, -1.0))
        else:
            results.append(
                (cp, new_points[row], int((obs_point == row).sum()),
                 float(errors[row]))
            )
    return results


class _Segment:
    """Cursor state of one segment in segment-parallel mapping."""

    def __init__(self, mapper, lo, hi):
        self.mapper = mapper
        self.lo = lo
        self.hi = hi
        self.first = lo
        self.idx = lo
        self.prev = None
        self.init_j = lo + 1
        self.init_chunk = 2
        self.num_skipped = 0
        self.count_since_loop = 0
        self.phase = "init"  # init | seq | done
        self.token = None


def _run_segments_parallel(new_mapper, start, end, opts: PipelineOptions,
                           rot_priors):
    """Segment-parallel mapping loop (see PipelineOptions.parallel_segments).

    Partitions [start, end] into S overlapping segments, one mapper each,
    and round-robins chain dispatch/complete across them: while segment A's
    chain results return and commit on host, the device is already running
    segments B..S's chain kernels and window solves. The per-chain pull
    round trip overlaps other segments' device work instead of stalling
    it. Per-segment failure handling mirrors the sequential loop:
    gates -> skip -> rescue -> in-segment sub-map restart.

    Returns the list of mappers (one or more per segment); each carries
    `_segment_range` so the pre-merge back-fill stays within its segment.
    """
    S = opts.parallel_segments
    n = end - start + 1
    step = int(np.ceil(n / S))
    # The boundary merge aligns sub-maps on common images and needs >= 3
    # of them (mapper.merge, reference sequential_mapper.cc:1311-1315);
    # a smaller overlap would silently produce sub-maps that cannot merge.
    overlap = max(opts.segment_overlap, 3)
    if opts.segment_overlap < 3 and opts.verbose:
        print(f"segment-overlap {opts.segment_overlap} raised to 3 "
              f"(merge needs >= 3 common images)")
    mappers = []
    segs = []
    for s in range(S):
        lo = start + s * step
        if lo > end:
            break
        hi = min(start + (s + 1) * step - 1, end)
        lo_eff = max(start, lo - overlap) if s > 0 else lo
        if hi - lo_eff < 1:
            continue
        m = new_mapper(s)
        m._segment_range = (lo_eff, hi)
        mappers.append(m)
        segs.append(_Segment(m, lo_eff, hi))

    init_opts = _mapper_options(opts, initial=True)

    def restart_submap(seg):
        # In-segment sub-map restart (mapper.cc:1150-1173).
        if opts.verbose:
            print(f"Starting new sub-map at image #{seg.idx}")
        m = new_mapper(len(mappers))
        m._segment_range = (seg.lo, seg.hi)
        mappers.append(m)
        seg.mapper = m
        seg.idx += max(opts.failure_skip_images - 1, 0)
        seg.first = seg.idx
        seg.init_j = seg.first + 1
        seg.init_chunk = 2
        seg.num_skipped = 0
        seg.prev = None
        seg.phase = "init" if seg.first < seg.hi else "done"

    def advance_init(seg):
        # One batched initial-pair attempt per visit (mapper.cc:1027-1062).
        if seg.init_j > seg.hi:
            seg.first += 1
            if seg.first >= seg.hi:
                seg.phase = "done"
                return
            seg.init_j = seg.first + 1
            seg.init_chunk = 2
            return
        cands = list(range(seg.init_j, min(seg.init_j + seg.init_chunk,
                                           seg.hi + 1)))
        sec = seg.mapper.process_initial_batch(seg.first, cands, init_opts)
        if sec >= 0:
            if opts.verbose:
                print(f"Initialized with pair (#{seg.first}, #{sec})")
            seg.mapper.adjust_bundle(
                [], [seg.first], [sec],
                ba_options=BAOptions(
                    max_num_iterations=opts.ba_local_max_iters,
                    min_track_len=2),
            )
            seg.prev = sec
            seg.idx = sec + 1
            seg.phase = "seq" if seg.idx <= seg.hi else "done"
        else:
            seg.init_j += len(cands)
            seg.init_chunk = 8

    def after_commit(seg, committed_last, n_committed, seq_opts):
        seg.count_since_loop += n_committed
        seg.prev = committed_last
        seg.num_skipped = 0
        seg.idx = committed_last + 1
        _local_ba(seg.mapper, opts, rot_priors)
        if opts.loop_detection and \
                seg.count_since_loop >= opts.loop_detection_period:
            seg.mapper.detect_loop(
                seg.prev, num_images=opts.loop_detection_num_images,
                num_nh_images=opts.loop_detection_num_nh_images,
                nh_distance=opts.loop_detection_nh_dist,
                options=seq_opts, verbose=opts.verbose)
            seg.count_since_loop = 0
        if seg.idx > seg.hi:
            seg.phase = "done"

    def sync_step(seg, seq_opts):
        # Sequential fallback for one frame: process -> rescue -> skip ->
        # sub-map restart (mapper.cc:1088-1173).
        m = seg.mapper
        success = m.process(seg.idx, seg.prev, seq_opts)
        if not success and opts.loop_detection:
            success = m.detect_loop(
                seg.idx, num_images=opts.loop_detection_num_images,
                num_nh_images=1, nh_distance=1 << 30,
                options=seq_opts) > 0
        if success:
            if opts.verbose:
                print(f"Processed image #{seg.idx} "
                      f"(points3D={m.store.num_points3D})")
            after_commit(seg, seg.idx, 1, seq_opts)
        else:
            seg.num_skipped += 1
            if seg.num_skipped >= opts.max_subsequent_trials:
                restart_submap(seg)
            else:
                seg.idx += 1
                if seg.idx > seg.hi:
                    seg.phase = "done"

    def try_dispatch(seg):
        m = seg.mapper
        seq_opts = _mapper_options(opts, num_proc=m.num_proc_images)
        if (opts.chain_frames and not opts.process_prev_prev
                and opts.chain_len >= 2
                and m.num_proc_images >= 2
                and seg.prev is not None
                and m.is_image_processed(seg.prev)):
            chain = []
            for j in range(seg.idx, min(seg.idx + opts.chain_len,
                                        seg.hi + 1)):
                if m.is_image_processed(j):
                    break
                chain.append(j)
            if len(chain) >= 2:
                seg.token = (m.chain_dispatch(chain, seg.prev, seq_opts,
                                              pad_to=opts.chain_len),
                             chain, seq_opts)
                return
        # Not chainable: take one synchronous step now.
        sync_step(seg, seq_opts)

    live = list(segs)
    while live:
        for seg in list(live):
            if seg.token is not None:
                token, chain, seq_opts = seg.token
                seg.token = None
                oks = seg.mapper.chain_complete(token)
                committed = sum(oks)
                if committed:
                    if opts.verbose:
                        for j in chain[:committed]:
                            print(f"Processed image #{j} (points3D="
                                  f"{seg.mapper.store.num_points3D})")
                    after_commit(seg, chain[committed - 1], committed,
                                 seq_opts)
                else:
                    sync_step(seg, seq_opts)
            if seg.phase == "init":
                advance_init(seg)
            if seg.phase == "seq":
                try_dispatch(seg)
            if seg.phase == "done" and seg.token is None:
                seg.mapper.flush_ba()
                live.remove(seg)
    return mappers


def run_pipeline(
    image_cameras,
    cam_models,
    cam_params,
    provider,
    opts: PipelineOptions = None,
    voc_tree=None,
    rot_priors=None,
    control_points=None,
    resume_from=None,
):
    """The full mapping run (reference mapper.cc main loop, :1014-1245).

    resume_from: path of a map checkpoint (utils/checkpoint.save_map) —
    restores the map + loop-retrieval DB into the first mapper and
    CONTINUES sequential mapping from the frame after the last processed
    one (periodic loop detection and local-BA windows run as usual), then
    the normal post-pass. A checkpoint at the final frame degenerates to
    back-fill + global BA + outputs."""
    from ..loop import LoopDetector

    opts = opts or PipelineOptions()
    num_images = len(image_cameras)
    start = opts.start_image_idx
    end = opts.end_image_idx if opts.end_image_idx >= 0 else num_images - 1
    seq_opts = _mapper_options(opts)
    init_opts = _mapper_options(opts, initial=True)

    dumper = None
    if opts.debug and opts.debug_path:
        from .debug import DebugDumper

        dumper = DebugDumper(opts.debug_path,
                             image_reader=getattr(provider, "image", None))

    mesh = None
    nd = opts.mesh_devices
    if nd == 0 or nd > 1:
        import jax
        from jax.sharding import Mesh

        devs = jax.devices()
        if nd > len(devs):
            raise ValueError(
                f"mesh_devices={nd} but the {devs[0].platform} backend has "
                f"only {len(devs)} device(s)")
        nd = len(devs) if nd == 0 else nd
        if nd > 1:
            mesh = Mesh(np.array(devs[:nd]), ("sfm",))
            if opts.verbose:
                print(f"Mesh: {nd} devices (distributed global BA + "
                      f"sharded fan-outs)")

    def new_mapper(seed):
        det = LoopDetector(voc_tree) if (voc_tree is not None and opts.loop_detection) else None
        m = SequentialMapper(image_cameras, cam_models, cam_params,
                             provider, loop_detector=det, seed=seed,
                             mesh=mesh)
        m.debug_dumper = dumper
        return m

    mappers = [new_mapper(0)]
    mapper = mappers[0]

    image_idx = opts.first_image_idx if opts.first_image_idx >= 0 else start
    first_idx = image_idx
    prev_idx = None
    num_skipped = 0
    count_since_loop = 0

    if resume_from:
        from ..utils.checkpoint import load_map

        load_map(mapper, resume_from)
        processed = sorted(mapper.image_idx_to_id.keys())
        if processed:
            first_idx = processed[0]
            prev_idx = processed[-1]
            image_idx = prev_idx + 1
            if opts.verbose:
                print(f"Resumed {len(processed)} registered images from "
                      f"{resume_from}; continuing at #{image_idx}")

    # Periodic checkpointing: save after every `checkpoint_period` newly
    # committed frames (counted against the CURRENT mapper).
    ckpt_last = [mapper.num_proc_images]

    def _maybe_checkpoint(m):
        if opts.checkpoint_period <= 0 or not opts.checkpoint_path:
            return
        if m.num_proc_images - ckpt_last[0] >= opts.checkpoint_period:
            from ..utils.checkpoint import save_map

            save_map(m, opts.checkpoint_path)
            ckpt_last[0] = m.num_proc_images

    # Per-stage wall clocks (reference prints per-frame + total timings,
    # mapper.cc:1181,1252-1257); returned in PipelineResult.timings.
    import time as _time

    timings = {}

    def _stage(name):
        class _T:
            def __enter__(self):
                self.t0 = _time.perf_counter()

            def __exit__(self, *a):
                timings[name] = timings.get(name, 0.0) + (
                    _time.perf_counter() - self.t0)

        return _T()

    t_seq0 = _time.perf_counter()
    idx = image_idx
    if resume_from and opts.parallel_segments > 1 and opts.verbose:
        print("Resume continues sequentially (segment-parallel mapping "
              "restarts segments from scratch)")
    if opts.parallel_segments > 1 and not resume_from:
        # Segment-parallel mapping replaces the sequential loop entirely;
        # the shared post-pass below (back-fill, global BA, merge, closure
        # sweeps) stitches the per-segment sub-maps into one model.
        mappers = _run_segments_parallel(new_mapper, start, end, opts,
                                         rot_priors)
        idx = end + 1  # skip the sequential loop
    while idx <= end:
        if mapper.num_proc_images == 0:
            # Initial-pair search (mapper.cc:1027-1062).
            second = opts.second_image_idx if (
                opts.second_image_idx >= 0 and len(mappers) == 1
            ) else -1
            success = False
            if second >= 0:
                success = mapper.process_initial(first_idx, second, init_opts, debug=opts.debug)
                idx = max(first_idx, second)
            else:
                # Batched sweeps: K candidate seconds per device call
                # (reference tries one sequential process_initial per
                # candidate, mapper.cc:1027-1036).
                j = first_idx + 1
                chunk = 2  # almost always succeeds immediately; escalate
                while j <= end:
                    cands = list(range(j, min(j + chunk, end + 1)))
                    sec = mapper.process_initial_batch(
                        first_idx, cands, init_opts, debug=opts.debug)
                    if sec >= 0:
                        success = True
                        idx = sec
                        break
                    j += len(cands)
                    chunk = 8
            if not success:
                if opts.verbose:
                    print(f"Failed to find initial pair from #{first_idx}")
                # The restart frame itself may be bad — advance it and retry
                # (goes beyond reference mapper.cc, which pins the first
                # image of a sub-map).
                first_idx += 1
                idx = first_idx + 1
                if first_idx >= end:
                    break
                continue
            if opts.verbose:
                print(f"Initialized with pair (#{first_idx}, #{idx})")
            # Initial bundle (mapper.cc:1050-1062).
            mapper.adjust_bundle(
                [], [first_idx], [idx],
                ba_options=BAOptions(max_num_iterations=opts.ba_local_max_iters,
                                     min_track_len=2),
            )
            prev_idx = idx
            idx += 1
            continue

        # Sequential step (mapper.cc:1088-1148).
        seq_opts = _mapper_options(opts, num_proc=mapper.num_proc_images)
        chain = []
        # Chain gate `num_proc_images >= 2` (not the min_track_len maturity
        # ramp): intentional — _mapper_options already applies the
        # bootstrap min_track_len=2 ramp to seq_opts, the per-frame host
        # gates veto immature chains frame by frame, and the segment loop's
        # try_dispatch uses the same condition (A/B'd by
        # test_chained_registration_matches_sequential).
        if (opts.chain_frames and not opts.process_prev_prev
                and opts.chain_len >= 2
                and mapper.num_proc_images >= 2
                and prev_idx is not None
                and mapper.is_image_processed(prev_idx)):
            for j in range(idx, min(idx + opts.chain_len, end + 1)):
                if mapper.is_image_processed(j):
                    break
                chain.append(j)
        if len(chain) >= 2:
            def after_chain_commit(committed_chain, n_committed):
                nonlocal count_since_loop, prev_idx, num_skipped, idx
                for j in committed_chain[:n_committed]:
                    if opts.verbose:
                        print(f"Processed image #{j} "
                              f"(points3D={mapper.store.num_points3D})")
                count_since_loop += n_committed
                prev_idx = committed_chain[n_committed - 1]
                num_skipped = 0
                idx = prev_idx + 1
                # One window solve per chain (deferred onto the device
                # stream behind the next register program): the window
                # problem covers every frame the chain added; per-frame
                # cadence would run `committed` nested-subset solves for
                # the same final window at 4x the device-BA cost.
                _tl0 = _time.perf_counter()
                _local_ba(mapper, opts, rot_priors)
                mapper._count_time("seq_localba_s",
                                   _time.perf_counter() - _tl0)
                if opts.loop_detection and \
                        count_since_loop >= opts.loop_detection_period:
                    _tl0 = _time.perf_counter()
                    mapper.detect_loop(
                        prev_idx, num_images=opts.loop_detection_num_images,
                        num_nh_images=opts.loop_detection_num_nh_images,
                        nh_distance=opts.loop_detection_nh_dist,
                        options=seq_opts, verbose=opts.verbose)
                    mapper._count_time("seq_detect_s",
                                       _time.perf_counter() - _tl0)
                    count_since_loop = 0
                _maybe_checkpoint(mapper)

            pipelined = (opts.pipeline_chains and not opts.debug
                         and not opts.constrain_rotation
                         and len(chain) == opts.chain_len)
            if pipelined:
                # Speculative pipelining (see PipelineOptions.pipeline_
                # chains): keep one cont chain in flight.
                tok = mapper.chain_dispatch(chain, prev_idx, seq_opts,
                                            pad_to=opts.chain_len)
                tok_chain = chain
                committed = 0
                while tok is not None:
                    nstart = tok_chain[-1] + 1
                    nxt = [j for j in range(nstart,
                                            min(nstart + opts.chain_len,
                                                end + 1))
                           if not mapper.is_image_processed(j)]
                    contiguous = nxt == list(range(nstart,
                                                   nstart + len(nxt)))
                    tok_nxt = None
                    if (len(tok_chain) == opts.chain_len and len(nxt) >= 2
                            and contiguous):
                        # Maturity ramp follows the committed count (the
                        # in-flight chain's frames count optimistically).
                        spec_opts = _mapper_options(
                            opts, num_proc=mapper.num_proc_images
                            + len(tok_chain))
                        tok_nxt = mapper.chain_dispatch_cont(
                            nxt, tok, spec_opts, pad_to=opts.chain_len)
                    oks = mapper.chain_complete(tok)
                    committed = sum(oks)
                    failed_at = tok_chain[committed] if committed < len(
                        tok_chain) else None
                    if committed:
                        after_chain_commit(tok_chain, committed)
                    if committed == len(tok_chain) and tok_nxt is not None:
                        tok, tok_chain = tok_nxt, nxt
                    else:
                        if tok_nxt is not None:
                            mapper.chain_abandon(tok_nxt)
                        tok = None
                if committed:
                    continue
                # The last in-flight chain failed outright: fall through
                # to the sequential rescue path at ITS first frame (any
                # earlier chains of this pipeline run already committed
                # and advanced prev_idx).
                idx = tok_chain[0]
            else:
                _tc0 = _time.perf_counter()
                oks = mapper.process_chain_k(chain, prev_idx, seq_opts,
                                             debug=opts.debug,
                                             pad_to=opts.chain_len)
                mapper._count_time("seq_chain_s",
                                   _time.perf_counter() - _tc0)
                committed = sum(oks)
                if committed:
                    after_chain_commit(chain, committed)
                    continue
            # The chain's first frame failed its gates: fall through to
            # the sequential path (rescue / skip / sub-map logic below).
        success = mapper.process(idx, prev_idx, seq_opts, debug=opts.debug)
        if not success and opts.loop_detection:
            # Rescue via loop detection: stop after ONE successful closure,
            # every candidate counts as neighborhood
            # (mapper.cc:1107-1108: detect_loop(idx, 30, 1, SIZE_MAX)).
            success = mapper.detect_loop(
                idx, num_images=opts.loop_detection_num_images,
                num_nh_images=1, nh_distance=1 << 30,
                options=seq_opts) > 0
        if success:
            if opts.verbose:
                print(f"Processed image #{idx} "
                      f"(points3D={mapper.store.num_points3D})")
            if opts.process_prev_prev and prev_idx is not None:
                prev_reg = sorted(mapper.image_idx_to_id.keys())
                if len(prev_reg) >= 3:
                    # Reference disables the homography gate for the
                    # prev-prev pair (mapper.cc:1114-1117).
                    from dataclasses import replace as _replace

                    pp_opts = _replace(seq_opts, max_homography_inliers=1.0)
                    mapper.process(idx, prev_reg[-3], pp_opts)
            _local_ba(mapper, opts, rot_priors)
            count_since_loop += 1
            if opts.loop_detection and count_since_loop >= opts.loop_detection_period:
                mapper.detect_loop(idx, num_images=opts.loop_detection_num_images,
                                   num_nh_images=opts.loop_detection_num_nh_images,
                                   nh_distance=opts.loop_detection_nh_dist,
                                   options=seq_opts, verbose=opts.verbose)
                count_since_loop = 0
            _maybe_checkpoint(mapper)
            prev_idx = idx
            num_skipped = 0
            idx += 1
        else:
            num_skipped += 1
            if num_skipped >= opts.max_subsequent_trials:
                # Start a new sub-map (mapper.cc:1150-1173).
                if opts.verbose:
                    print(f"Starting new sub-map at image #{idx}")
                mapper = new_mapper(len(mappers))
                mappers.append(mapper)
                ckpt_last[0] = 0
                # Restart offset (reference mapper.cc:1157).
                idx += max(opts.failure_skip_images - 1, 0)
                first_idx = idx
                num_skipped = 0
            else:
                idx += 1

    timings["sequential_loop"] = _time.perf_counter() - t_seq0

    # Post-pass (mapper.cc:1188-1209). Pre-merge back-fill stays within
    # each mapper's own segment in parallel mode (a segment mapper has no
    # business registering frames of other segments before the merge; the
    # post-merge back-fill below covers the full range).
    with _stage("backfill"):
        for m in mappers:
            if m.num_proc_images == 0:
                continue
            lo, hi = getattr(m, "_segment_range", (start, end))
            process_remaining_images(m, lo, hi, opts)
    import os as _os

    if _os.environ.get("MAVMAP_CLEAR_BEFORE_GLOBAL_BA") == "1":
        # Diagnostic hook: drop all jit caches (frees the sequential
        # loop's compiled executables on the device) before the heavy
        # global solves — isolates worker program/memory exhaustion.
        import jax as _jax

        _jax.clear_caches()
    with _stage("global_ba"):
        for m in mappers:
            if m.num_proc_images:
                _global_ba(m, opts, rot_priors)

    mappers = [m for m in mappers if m.num_proc_images > 0]
    merged = False
    if len(mappers) > 1 and opts.merge:
        with _stage("merge"):
            mappers = merge_mappers(mappers, opts)
            merged = True
    # Full-range back-fill + re-BA (reference mapper.cc:1201-1209) — also
    # when the merge was SKIPPED but some mapper's pre-merge back-fill was
    # clamped to its own segment range (parallel-segments mode with a
    # single surviving mapper, or --no-merge): sequential mode would have
    # attempted those frames, so parallel mode must too.
    clamped = any(
        getattr(m, "_segment_range", (start, end)) != (start, end)
        for m in mappers
    )
    if merged or clamped:
        with _stage("merge" if merged else "backfill"):
            for m in mappers:
                process_remaining_images(m, start, end, opts)
                _global_ba(m, opts, rot_priors)

    if opts.loop_detection and opts.final_closure_sweeps > 0:
        with _stage("closure_sweeps"):
            for m in mappers:
                _final_closure_sweeps(m, opts, rot_priors)

    cp_results = None
    main = max(mappers, key=lambda m: m.num_proc_images) if mappers else None
    if opts.use_control_points and control_points and main is not None:
        with _stage("control_points"):
            cp_results = apply_control_points(main, control_points, opts)

    if opts.filter_max_error > 0 and main is not None:
        with _stage("filter"):
            _global_ba(main, opts, rot_priors, update_errors=True)
            n = filter_point_cloud(main, opts.filter_max_error)
            if opts.verbose:
                print(f"Filtered {n} points with error > "
                      f"{opts.filter_max_error}")
            _global_ba(main, opts, rot_priors)

    if opts.verbose:
        stages = " | ".join(f"{k} {v:.1f}s" for k, v in timings.items())
        print(f"Pipeline stages: {stages}")
    return PipelineResult(mappers=mappers, control_point_results=cp_results,
                          timings=timings)
