"""Fused device kernels for the sequential mapper.

Each mapper step is ONE jitted program over fixed-capacity arrays, so a
frame costs two device round-trips (two-view geometry / view registration)
instead of the reference's dozens of sequential stages. All gates return
scalars; the host applies the accept/reject logic (data-dependent control
flow stays off-device, SURVEY §7).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import essential, homography, p3p, matching, triangulation, projection
from ..ops.ransac import ransac
from ..ops.rotation import rvec_from_rotmat, rotmat_from_rvec
from ..ba.core import _pose_refine_loop


class TwoViewResult(NamedTuple):
    matches: jnp.ndarray        # (F,) int32 into image2, -1 invalid
    match_valid: jnp.ndarray    # (F,)
    num_matches: jnp.ndarray
    med_disparity: jnp.ndarray
    num_hom_inliers: jnp.ndarray
    E: jnp.ndarray              # (3, 3)
    e_inlier: jnp.ndarray       # (F,) bool, aligned with image-1 rows
    num_e_inliers: jnp.ndarray
    rvec2: jnp.ndarray          # (3,) second pose (first = identity)
    tvec2: jnp.ndarray
    z_component: jnp.ndarray    # |z| of inverted second pose (forward-motion gate)
    points3D: jnp.ndarray       # (F, 3) triangulated per match row
    tri_angle: jnp.ndarray      # (F,) radians
    mean_tri_angle: jnp.ndarray  # degrees, folded at 90
    depth1: jnp.ndarray         # (F,)
    depth2: jnp.ndarray


@partial(jax.jit, static_argnames=("essential_trials", "hom_trials"))
def two_view_init(
    key,
    kp1, desc1, mask1, n1,
    kp2, desc2, mask2, n2,
    ratio, max_distance,
    norm_threshold,
    essential_trials: int = 512,
    hom_trials: int = 128,
    max_depth: float = 100.0,
):
    """Fused: match + disparity + homography + 5pt-RANSAC + pose + triangulate.

    Implements the device side of reference process_initial
    (sequential_mapper.cc:46-386). kp/desc/mask are capacity-F padded;
    n1/n2 are normalized coords of the same rows.
    """
    F = kp1.shape[0]
    matches, valid = matching.match_brute_force(
        desc1, desc2, mask1, mask2, kp1, kp2, ratio=ratio,
        max_distance=max_distance,
    )
    num_matches = jnp.sum(valid)
    med_disp = matching.median_feature_disparity(kp1, kp2, matches, valid)

    # Matched coordinate arrays aligned to image-1 rows.
    j = jnp.maximum(matches, 0)
    x1 = n1
    x2 = n2[j]

    key_h, key_e = jax.random.split(key)
    hom = ransac(
        key_h, x1, x2, homography.solve_homography, homography.homography_residuals,
        sample_size=4, num_trials=hom_trials, threshold=norm_threshold,
        valid_mask=valid,
    )
    eres = ransac(
        key_e, x1, x2, essential.solve_essential_5pt,
        essential.abs_sampson_residuals,
        sample_size=5, num_trials=essential_trials, threshold=norm_threshold,
        valid_mask=valid,
    )
    # Non-minimal refit on all inliers: masked 8-point + projection onto the
    # essential manifold. Averages out minimal-sample noise; keep whichever
    # of {RANSAC model, refit} has more inliers (the refit can regress in
    # near-degenerate configurations).
    E_refit, _ = essential.solve_essential_8pt(
        x1, x2, weights=eres.inlier_mask.astype(x1.dtype)
    )
    E_refit = E_refit[0]
    refit_res = essential.abs_sampson_residuals(x1, x2, E_refit)
    refit_inl = (refit_res <= norm_threshold) & valid
    use_refit = jnp.sum(refit_inl) >= eres.num_inliers
    E_best = jnp.where(use_refit, E_refit, eres.model)
    inlier_best = jnp.where(use_refit, refit_inl, eres.inlier_mask)
    num_inl_best = jnp.maximum(jnp.sum(refit_inl), eres.num_inliers)

    R, t, _ = essential.pose_from_essential_matrix(
        E_best, x1, x2, inlier_best, max_depth=max_depth
    )
    rvec2 = rvec_from_rotmat(R)

    proj1 = jnp.concatenate([jnp.eye(3, dtype=x1.dtype), jnp.zeros((3, 1), x1.dtype)], axis=1)
    proj2 = jnp.concatenate([R, t[:, None]], axis=1)
    z_comp = jnp.abs(projection.invert_proj_matrix(proj2)[2, 3])

    X = triangulation.triangulate_points(proj1, proj2, x1, x2)
    ang = triangulation.calc_tri_angles(proj1, proj2, X)
    ang_folded = jnp.minimum(ang, jnp.pi - ang)
    mean_angle = jnp.sum(jnp.where(inlier_best, ang_folded, 0.0)) / jnp.maximum(
        num_inl_best, 1
    )
    d1 = projection.calc_depth(proj1, X)
    d2 = projection.calc_depth(proj2, X)

    # Packed outputs (see register_view: one transfer per buffer).
    f32 = jnp.float32
    rows = jnp.stack(
        [matches.astype(f32), valid.astype(f32), inlier_best.astype(f32),
         ang, d1, d2],
        axis=-1,
    )
    rows = jnp.concatenate([rows, X], axis=-1)  # (F, 9)
    scalars = jnp.concatenate(
        [
            jnp.stack([
                num_matches.astype(f32), med_disp,
                hom.num_inliers.astype(f32), num_inl_best.astype(f32),
                z_comp, mean_angle * (180.0 / jnp.pi),
            ]),
            rvec2, t, E_best.reshape(9),
        ]
    )  # (21,)
    return rows, scalars


@partial(jax.jit, static_argnames=("essential_trials",))
def two_view_init_batch(
    keys,
    kp1, desc1, mask1, n1,
    kp2s, desc2s, mask2s, n2s,
    ratio, max_distance, norm_thresholds,
    essential_trials: int = 512,
    max_depth: float = 100.0,
):
    """two_view_init vmapped over K candidate second images: the first
    image is shared, candidates carry a leading batch dim. One device call
    evaluates a whole sweep of the initial-pair search (the reference runs
    a full sequential process_initial per candidate, mapper.cc:1027-1036).
    """

    def one(key, kp2, d2, m2, n2, nt):
        return two_view_init(
            key, kp1, desc1, mask1, n1, kp2, d2, m2, n2,
            ratio, max_distance, nt,
            essential_trials=essential_trials, max_depth=max_depth,
        )

    return jax.vmap(one)(keys, kp2s, desc2s, mask2s, n2s, norm_thresholds)


def unpack_two_view(rows, scalars) -> TwoViewResult:
    """Host-side unpacking of two_view_init's packed outputs (numpy in)."""
    import numpy as np

    return TwoViewResult(
        matches=rows[:, 0].astype(np.int32),
        match_valid=rows[:, 1] > 0.5,
        num_matches=int(scalars[0]),
        med_disparity=float(scalars[1]),
        num_hom_inliers=int(scalars[2]),
        E=scalars[12:21].reshape(3, 3),
        e_inlier=rows[:, 2] > 0.5,
        num_e_inliers=int(scalars[3]),
        rvec2=scalars[6:9],
        tvec2=scalars[9:12],
        z_component=float(scalars[4]),
        points3D=rows[:, 6:9],
        tri_angle=rows[:, 3],
        mean_tri_angle=float(scalars[5]),
        depth1=rows[:, 4],
        depth2=rows[:, 5],
    )


class RegisterResult(NamedTuple):
    matches: jnp.ndarray         # (F,) prev-row -> curr-row
    match_valid: jnp.ndarray
    num_matches: jnp.ndarray
    med_disparity: jnp.ndarray
    num_hom_inliers: jnp.ndarray
    num_stable: jnp.ndarray
    p3p_inlier: jnp.ndarray      # (F,) over prev rows (stable subset)
    num_p3p_inliers: jnp.ndarray
    p3p_success: jnp.ndarray
    rvec: jnp.ndarray            # refined pose of current image
    tvec: jnp.ndarray
    final_cost: jnp.ndarray      # RMS px over stable inliers
    track_reproj: jnp.ndarray    # (F,) px error of existing 3D pts in new view
    new_points3D: jnp.ndarray    # (F, 3) triangulations for new matches
    new_reproj_prev: jnp.ndarray  # (F,) normalized reproj error in prev view
    new_reproj_curr: jnp.ndarray
    new_tri_angle: jnp.ndarray   # (F,) radians
    new_depth_prev: jnp.ndarray
    new_depth_curr: jnp.ndarray


@partial(jax.jit, static_argnames=("p3p_trials", "hom_trials", "refine_iters"))
def register_view(
    key,
    kp_prev, desc_prev, mask_prev, n_prev,
    kp_curr, desc_curr, mask_curr, n_curr,
    prev_p3d_xyz,      # (F, 3) 3-D point of prev row's track (garbage if none)
    prev_has_tri,      # (F,) bool: row has triangulated 3-D point
    prev_stable,       # (F,) bool: track_len >= min_track_len
    prev_rvec, prev_tvec,
    cam_params, cam_model,
    ratio, max_distance,
    norm_threshold,
    p3p_trials: int = 512,
    hom_trials: int = 128,
    refine_iters: int = 30,
):
    """Fused: match + gates + P3P RANSAC + LM pose refinement + track
    continuation checks + new-point triangulation.

    Device side of reference `process` (sequential_mapper.cc:389-934).
    """
    F = kp_prev.shape[0]
    matches, valid = matching.match_brute_force(
        desc_prev, desc_curr, mask_prev, mask_curr, kp_prev, kp_curr,
        ratio=ratio, max_distance=max_distance,
    )
    num_matches = jnp.sum(valid)
    med_disp = matching.median_feature_disparity(kp_prev, kp_curr, matches, valid)

    j = jnp.maximum(matches, 0)
    x_prev = n_prev
    x_curr = n_curr[j]
    kp_curr_m = kp_curr[j]

    key_h, key_p = jax.random.split(key)
    hom = ransac(
        key_h, x_prev, x_curr, homography.solve_homography,
        homography.homography_residuals,
        sample_size=4, num_trials=hom_trials, threshold=norm_threshold,
        valid_mask=valid,
    )

    # 2D-3D: stable, matched rows.
    stable = valid & prev_stable & prev_has_tri
    num_stable = jnp.sum(stable)
    pres = ransac(
        key_p, x_curr, prev_p3d_xyz, p3p.solve_p3p_best, p3p.p3p_residuals,
        sample_size=4, num_trials=p3p_trials, threshold=norm_threshold,
        valid_mask=stable,
    )
    rvec0 = rvec_from_rotmat(pres.model[:3, :3])
    tvec0 = pres.model[:3, 3]

    # LM pose refinement in pixel space on the P3P inliers.
    pose0 = jnp.concatenate([rvec0, tvec0])
    pose, cost = _pose_refine_loop(
        pose0, prev_p3d_xyz, kp_curr_m, pres.inlier_mask,
        cam_params, cam_model, jnp.float32(1.0), refine_iters,
    )
    # RMS px over refined residuals, matching reference
    # sqrt(summary.final_cost / num_residuals) (bundle_adjustment.cc:222).
    final_cost = jnp.sqrt(cost / jnp.maximum(pres.num_inliers * 2, 1))

    rvec, tvec = pose[:3], pose[3:]
    proj_curr = projection.compose_proj_matrix(rvec, tvec)
    proj_prev = projection.compose_proj_matrix(prev_rvec, prev_tvec)

    # Track continuation: pixel reproj error of existing 3-D points in the
    # new view (normalized error * mean focal ~ px; use normalized coords
    # with the px threshold scaled upstream).
    track_err = projection.calc_reproj_errors(x_curr, prev_p3d_xyz, proj_curr)

    # New-point triangulation for all matches (host filters by has_tri).
    Xnew = triangulation.triangulate_points(proj_prev, proj_curr, x_prev, x_curr)
    err_prev = projection.calc_reproj_errors(x_prev, Xnew, proj_prev)
    err_curr = projection.calc_reproj_errors(x_curr, Xnew, proj_curr)
    ang = triangulation.calc_tri_angles(proj_prev, proj_curr, Xnew)
    dp = projection.calc_depth(proj_prev, Xnew)
    dc = projection.calc_depth(proj_curr, Xnew)

    # Pack into TWO arrays: one transfer each on device_get instead of 19
    # small ones (unpacked host-side by `unpack_register`). Whether this
    # still pays on a local card is ROADMAP D2.
    f32 = jnp.float32
    rows = jnp.stack(
        [
            matches.astype(f32), valid.astype(f32), pres.inlier_mask.astype(f32),
            track_err, err_prev, err_curr, ang, dp, dc,
        ],
        axis=-1,
    )  # (F, 9)
    rows = jnp.concatenate([rows, Xnew], axis=-1)  # (F, 12)
    scalars = jnp.concatenate(
        [
            jnp.stack([
                num_matches.astype(f32), med_disp,
                hom.num_inliers.astype(f32), num_stable.astype(f32),
                pres.num_inliers.astype(f32), pres.success.astype(f32),
                final_cost,
            ]),
            rvec, tvec,
        ]
    )  # (13,)
    return rows, scalars


def unpack_register(rows, scalars) -> RegisterResult:
    """Host-side unpacking of register_view's packed outputs (numpy in)."""
    import numpy as np

    return RegisterResult(
        matches=rows[:, 0].astype(np.int32),
        match_valid=rows[:, 1] > 0.5,
        num_matches=int(scalars[0]),
        med_disparity=float(scalars[1]),
        num_hom_inliers=int(scalars[2]),
        num_stable=int(scalars[3]),
        p3p_inlier=rows[:, 2] > 0.5,
        num_p3p_inliers=int(scalars[4]),
        p3p_success=bool(scalars[5] > 0.5),
        rvec=scalars[7:10],
        tvec=scalars[10:13],
        final_cost=float(scalars[6]),
        track_reproj=rows[:, 3],
        new_points3D=rows[:, 9:12],
        new_reproj_prev=rows[:, 4],
        new_reproj_curr=rows[:, 5],
        new_tri_angle=rows[:, 6],
        new_depth_prev=rows[:, 7],
        new_depth_curr=rows[:, 8],
    )


def _derive_chain_state(rows, scalars, prev_xyz, prev_has_tri, prev_len,
                        tri_nt, min_tri_angle, min_track_len):
    """Device replica of the commit's track rules (mapper._register_commit):
    derive the NEXT frame's anchor state from a register_view result —
    continue a track if the existing 3-D point reprojects well in the new
    frame; else a new triangulation must pass both reprojection gates, the
    folded angle, and positive depths.

    Returns (xyz, has_tri, stable, lens, rvec, tvec) in the new frame's
    row space."""
    F = prev_xyz.shape[0]
    matches = rows[:, 0].astype(jnp.int32)
    valid = rows[:, 1] > 0.5
    track_err = rows[:, 3]
    ep, ec = rows[:, 4], rows[:, 5]
    ang = rows[:, 6]
    dpv, dcv = rows[:, 7], rows[:, 8]
    Xnew = rows[:, 9:12]
    rvec, tvec = scalars[7:10], scalars[10:13]

    angf = jnp.minimum(ang, jnp.pi - ang)
    cont = valid & prev_has_tri & (track_err < tri_nt)
    new = (valid & ~prev_has_tri & (ep < tri_nt) & (ec < tri_nt)
           & (angf >= min_tri_angle) & (dpv > 0) & (dcv > 0))
    got = cont | new
    src_xyz = jnp.where(cont[:, None], prev_xyz, Xnew)
    src_len = jnp.where(cont, prev_len + 1, 2)

    # Scatter prev-row state into new-frame row space (matches are
    # injective on valid rows — mutual cross-check); invalid rows scatter
    # out of range and drop.
    tgt = jnp.where(valid, matches, F)
    xyz = jnp.zeros((F, 3), prev_xyz.dtype).at[tgt].set(
        jnp.where(got[:, None], src_xyz, 0.0), mode="drop")
    has_tri = jnp.zeros(F, bool).at[tgt].set(got, mode="drop")
    lens = jnp.zeros(F, jnp.int32).at[tgt].set(
        jnp.where(got, src_len, 0), mode="drop")
    stable = has_tri & (lens >= min_track_len)
    return xyz, has_tri, stable, lens, rvec, tvec


def _register_chain_impl(base_key, kp_p, d_p, m_p, n_p, feats_k,
                         track_state, scal, ba_poses, ba_points,
                         use_fresh, p3p_trials, hom_trials, refine_iters,
                         cont_state=None, cont_pose=None):
    """K consecutive frame registrations in ONE device program: frame k
    anchors on track state DERIVED ON DEVICE from frame k-1's results
    (`_derive_chain_state`), so the sequential loop pulls once per K
    frames instead of once per frame.

    The derived state only steers each frame's registration (which 2D-3D
    pairs feed P3P/refinement); the committed map still comes from the
    host's own bookkeeping, so a derivation mismatch can only degrade a
    pose estimate, never corrupt the map. Host gates still veto each
    frame, and a mid-chain gate failure sends the remaining frames back
    through the normal path.

    PACKED CALLING CONVENTION — every dispatched op and every host
    buffer is one more launch or transfer, so the host passes:
      feats_k: tuple of K (kp, desc, mask, norm) device-cached tuples —
        stacking happens INSIDE the program instead of as 4 separate
        device ops;
      track_state (F, 7) f32: [xyz(3) | has_tri | stable | track_len |
        ba_row] — ONE upload for the anchor's track state, where ba_row
        maps the row to the in-flight window-BA solve's point rows
        (-1 = keep the staged xyz);
      scal (12 + 12K,) f32: [prev_rvec(3) | prev_tvec(3) | ratio |
        max_dist | min_tri_angle | min_track_len | key_counter |
        anchor_row] + per-frame [nt | tri_nt | cam_model | cam_params(9)]
        — ONE upload for every scalar/threshold/intrinsic;
      base_key + key_counter: per-chain PRNG keys derive in-program via
        fold_in instead of host-side split dispatches;
      ba_poses/ba_points (use_fresh=True): the deferred window-BA LM
      loop's output buffers, already on the stream AHEAD of this kernel —
      the anchor pose and 3-D points come from the solve directly, with
      no host round-trip (anchoring on the one-solve-stale staged values
      instead costs ~3x ATE drift at chain length 4).

    The K register_view bodies run as one lax.scan (one compile of the
    body regardless of K). Returns (rows (K,F,12), scalars (K,13),
    has_tri_in (K,F)) where has_tri_in[k] is the anchor has_tri state
    frame k registered against.
    """
    K = len(feats_k)
    prev_rvec, prev_tvec = scal[0:3], scal[3:6]
    ratio, max_distance = scal[6], scal[7]
    min_tri_angle = scal[8]
    min_track_len = scal[9].astype(jnp.int32)
    counter = scal[10].astype(jnp.int32)
    per = scal[12:].reshape(K, 12)
    nts, tri_nts = per[:, 0], per[:, 1]
    cam_models = per[:, 2].astype(jnp.int32)
    cam_params = per[:, 3:12]

    if cont_state is not None:
        # Continuation chain: anchor state comes from the PREVIOUS chain's
        # device-resident end_state/end_pose (speculative pipelining) —
        # track_state/scal[0:6] are ignored.
        xyz = cont_state[:, :3]
        has_tri = cont_state[:, 3] > 0.5
        stable = cont_state[:, 4] > 0.5
        lens = cont_state[:, 5].astype(jnp.int32)
        prev_rvec, prev_tvec = cont_pose[:3], cont_pose[3:]
    else:
        xyz = track_state[:, :3]
        has_tri = track_state[:, 3] > 0.5
        stable = track_state[:, 4] > 0.5
        lens = track_state[:, 5].astype(jnp.int32)
    if use_fresh:
        anchor_row = scal[11].astype(jnp.int32)
        xyz_rows = track_state[:, 6].astype(jnp.int32)
        fresh = anchor_row >= 0
        ar = jnp.maximum(anchor_row, 0)
        prev_rvec = jnp.where(fresh, ba_poses[ar, :3], prev_rvec)
        prev_tvec = jnp.where(fresh, ba_poses[ar, 3:], prev_tvec)
        xr = jnp.maximum(xyz_rows, 0)
        xyz = jnp.where((xyz_rows >= 0)[:, None], ba_points[xr], xyz)

    keys = jax.random.split(jax.random.fold_in(base_key, counter), K)
    kps = jnp.stack([f[0] for f in feats_k])
    ds = jnp.stack([f[1] for f in feats_k])
    ms = jnp.stack([f[2] for f in feats_k])
    ns = jnp.stack([f[3] for f in feats_k])

    def step(carry, xs):
        kp0, d0, m0, n0, xyz, has_tri, stable, lens, rvec, tvec = carry
        key, kp1, d1, m1, n1, cp, cm, nt, tri_nt = xs
        rows, scalars = register_view(
            key, kp0, d0, m0, n0, kp1, d1, m1, n1,
            xyz, has_tri, stable, rvec, tvec, cp, cm,
            ratio, max_distance, nt,
            p3p_trials=p3p_trials, hom_trials=hom_trials,
            refine_iters=refine_iters,
        )
        nxyz, nht, nst, nlen, nrv, ntv = _derive_chain_state(
            rows, scalars, xyz, has_tri, lens, tri_nt, min_tri_angle,
            min_track_len,
        )
        return ((kp1, d1, m1, n1, nxyz, nht, nst, nlen, nrv, ntv),
                (rows, scalars, has_tri))

    carry0 = (kp_p, d_p, m_p, n_p, xyz, has_tri, stable, lens,
              prev_rvec, prev_tvec)
    carry_end, (rows_all, scalars_all, has_tri_in) = jax.lax.scan(
        step, carry0,
        (keys, kps, ds, ms, ns, cam_params, cam_models, nts, tri_nts),
    )
    # End-state for SPECULATIVE chain pipelining: the final frame's derived
    # track state + pose, packed so the NEXT chain can anchor on these
    # DEVICE buffers before this chain's results ever reach the host
    # (mapper.chain_dispatch_cont).
    (_, _, _, _, exyz, eht, est, elens, erv, etv) = carry_end
    end_state = jnp.concatenate(
        [exyz, eht[:, None].astype(jnp.float32),
         est[:, None].astype(jnp.float32),
         elens[:, None].astype(jnp.float32)], axis=1)  # (F, 6)
    end_pose = jnp.concatenate([erv, etv])  # (6,)
    return rows_all, scalars_all, has_tri_in, end_state, end_pose


@partial(jax.jit, static_argnames=("p3p_trials", "hom_trials",
                                   "refine_iters"))
def register_chain_fresh(base_key, kp_p, d_p, m_p, n_p, feats_k,
                         track_state, scal, ba_poses, ba_points,
                         p3p_trials: int = 512, hom_trials: int = 128,
                         refine_iters: int = 30):
    """Chain registration anchored on the in-flight window-BA solution
    (see _register_chain_impl's packed calling convention)."""
    return _register_chain_impl(
        base_key, kp_p, d_p, m_p, n_p, feats_k, track_state, scal,
        ba_poses, ba_points, True, p3p_trials, hom_trials, refine_iters)


@partial(jax.jit, static_argnames=("p3p_trials", "hom_trials",
                                   "refine_iters"))
def register_chain(base_key, kp_p, d_p, m_p, n_p, feats_k,
                   track_state, scal,
                   p3p_trials: int = 512, hom_trials: int = 128,
                   refine_iters: int = 30):
    """Chain registration from host-staged anchor state (no window BA in
    flight; see _register_chain_impl's packed calling convention)."""
    return _register_chain_impl(
        base_key, kp_p, d_p, m_p, n_p, feats_k, track_state, scal,
        None, None, False, p3p_trials, hom_trials, refine_iters)


@partial(jax.jit, static_argnames=("p3p_trials", "hom_trials",
                                   "refine_iters"))
def register_chain_cont(base_key, kp_a, d_a, m_a, n_a, feats_k,
                        cont_state, cont_pose, scal,
                        p3p_trials: int = 512, hom_trials: int = 128,
                        refine_iters: int = 30):
    """Chain registration anchored on the PREVIOUS chain's device-resident
    end state (speculative pipelining): cont_state (F, 6) and cont_pose
    (6,) are the end_state/end_pose outputs of the in-flight chain, and
    kp_a/d_a/m_a/n_a are that chain's LAST frame's features. The host
    dispatches this WITHOUT waiting for the previous chain's pull — the
    pull and host commit overlap this chain's device work.
    scal[0:6] (anchor pose) is ignored."""
    return _register_chain_impl(
        base_key, kp_a, d_a, m_a, n_a, feats_k, None, scal,
        None, None, False, p3p_trials, hom_trials, refine_iters,
        cont_state=cont_state, cont_pose=cont_pose)


@partial(jax.jit, static_argnames=("p3p_trials",))
def register_view_batch(
    keys,
    kpp, desc_p, mask_p, np_,
    kp_curr, desc_c, mask_c, nc_,
    xyz, has_tri, stable,
    prev_rvec, prev_tvec,
    kparams, model_code,
    ratio, max_distance, norm_threshold,
    p3p_trials: int = 500,
):
    """register_view vmapped over a candidate axis: the per-candidate
    inputs (previous image's features/track state/pose, PRNG key) carry a
    leading batch dim; the current image's features and camera are shared.
    One device call registers the current image against K loop-closure
    candidates at once (the reference runs a full sequential process() per
    candidate, sequential_mapper.cc:1182-1211)."""

    def one(key, kpp1, dp1, mp1, np1, xyz1, ht1, st1, rv1, tv1):
        return register_view(
            key, kpp1, dp1, mp1, np1,
            kp_curr, desc_c, mask_c, nc_,
            xyz1, ht1, st1, rv1, tv1,
            kparams, model_code, ratio, max_distance, norm_threshold,
            p3p_trials=p3p_trials,
        )

    return jax.vmap(one)(
        keys, kpp, desc_p, mask_p, np_, xyz, has_tri, stable,
        prev_rvec, prev_tvec,
    )


@partial(jax.jit, static_argnames=("p3p_trials",))
def register_view_pairs(
    keys,
    kpp, desc_p, mask_p, np_,
    kpc, desc_c, mask_c, nc_,
    xyz, has_tri, stable,
    prev_rvec, prev_tvec,
    kparams, model_code,
    ratio, max_distance, norm_threshold,
    p3p_trials: int = 500,
):
    """register_view vmapped over FULL pairs: BOTH sides carry a leading
    batch dim (unlike register_view_batch, which shares one current image).
    Used by the back-fill pass to try many (skipped frame, neighbor) pairs
    in one device call — the reference's process_remaining_images runs a
    full sequential process() per pair (mapper.cc:221-299)."""

    def one(key, kpp1, dp1, mp1, np1, kpc1, dc1, mc1, nc1, xyz1, ht1, st1,
            rv1, tv1, kp_, code, nt):
        return register_view(
            key, kpp1, dp1, mp1, np1,
            kpc1, dc1, mc1, nc1,
            xyz1, ht1, st1, rv1, tv1,
            kp_, code, ratio, max_distance, nt,
            p3p_trials=p3p_trials,
        )

    return jax.vmap(one)(
        keys, kpp, desc_p, mask_p, np_, kpc, desc_c, mask_c, nc_,
        xyz, has_tri, stable, prev_rvec, prev_tvec,
        kparams, model_code, norm_threshold,
    )
