"""Robust Levenberg-Marquardt bundle adjustment with Schur complement.

Counterpart of reference src/base3d/bundle_adjustment.{h,cc}.
The reference builds a Ceres problem with one autodiff residual block per
observation and solves SPARSE_SCHUR on CPU threads
(bundle_adjustment.cc:449-569). This rebuild is a from-scratch LM:

  - residuals r_o = world2image(R_i X_p + t_i; cam) - uv_o in PIXELS, with
    jax.jacfwd replacing Ceres autodiff (same cost model: Cauchy robust
    loss with `loss_scale_factor`, reference :148-149);
  - per-observation Jacobians are one vmap'd jacfwd — a single batched
    tensor op over all observations;
  - normal equations in camera-block / point-block Schur form: point
    blocks are 3x3 (closed-form batched inverse), the reduced camera
    system (6 per pose [+ 9 per camera when refine_camera_params]) is
    assembled by segment_sum over a host-precomputed track-pair list and
    solved densely (Cholesky) — exact, no sparsity heuristics;
  - gauge fixing by masking parameter rows: BA_POSE_FREE / FIXED /
    FIXED_X states exactly as the reference (FIXED_X pins the x-translation
    of the second initial pose to fix scale, bundle_adjustment.h:33-35);
  - IMU rotation priors as extra residuals: weighted Frobenius distance
    between R(rvec) and the prior rotation, matching
    BARotationConstraintCostFunction (bundle_adjustment.cc:57-111);
  - GCP pinning: fixed 3-D points are masked out of the point update
    (reference :545-549);
  - optional per-point mean reprojection errors with the robust loss
    switched off, matching the reference's `update_point3D_errors`
    recomputation (:575-598).

Everything on-device is static-shape; the dynamic problem structure
(which image/point/camera each observation touches, track co-observation
pairs) is precomputed on host in `build_problem`.
"""

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..models import camera as cam
from ..ops.rotation import rotmat_from_rvec
from ..ops.segment import segment_sum_sorted

BA_POSE_FREE = 0
BA_POSE_FIXED = 1
BA_POSE_FIXED_X = 2


# Camera-count cutoff between the exact dense Schur solve (materialized
# (6I, 6I) system + pair list) and matrix-free Schur-CG. Single source of
# truth for adjust_bundle / the pipeline's global BA / dist_bundle_adjust.
DENSE_SOLVER_MAX_CAMERAS = 64


@dataclass(frozen=True)
class BAOptions:
    max_num_iterations: int = 50
    function_tolerance: float = 1e-4
    loss_scale_factor: float = 1.0  # Cauchy scale, pixels
    constrain_rotation: bool = False
    constrain_rotation_weight: float = 0.0
    refine_camera_params: bool = False
    update_point3D_errors: bool = False
    min_track_len: int = 2
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.5
    # Reduced-camera-system solver: "dense" (exact Cholesky over the
    # materialized (6I,6I) Schur matrix — needs the co-observation pair
    # list), "cg" (matrix-free preconditioned CG — no pair list, scales to
    # thousands of cameras), or "auto" (cg when the problem has no pair
    # list or many cameras).
    solver: str = "auto"
    # Above this observation count, self-calibration runs as TWO stages
    # (intrinsics refined on an observation subsample, then the full
    # problem with intrinsics fixed): the joint selfcal CG carries ~90
    # per-observation Jacobian columns through its inner loop and XLA's
    # remat layouts blow past one chip's HBM around ~300k observations.
    # Intrinsics are overdetermined thousands-fold, so the subsample loses
    # nothing (mapper.adjust_bundle implements the split).
    selfcal_max_obs: int = 150_000
    cg_max_iters: int = 100
    cg_tol: float = 1e-3


class BAProblem(NamedTuple):
    """Static-shape device arrays describing one BA problem instance.

    Point bookkeeping runs in a DENSE id space: `obs_point_dense` renames
    the points that actually carry observations to gapless sorted ids
    0..Pd-1 (`point_rows` maps dense row -> row in `points`). All per-point
    solver state (V blocks, gradients, updates) lives in dense space — the
    LM loops gather `points[point_rows]` once on entry and scatter the
    result back once on exit. Gaplessness is what lets the sorted Pallas
    segment kernel bound every observation tile to a TILE-wide id band.
    """

    poses: jnp.ndarray         # (I, 6) rvec+tvec
    points: jnp.ndarray        # (P, 3)
    cam_params: jnp.ndarray    # (C, 9)
    cam_models: jnp.ndarray    # (C,) int32 model codes
    obs_image: jnp.ndarray     # (O,) int32
    obs_point: jnp.ndarray     # (O,) int32 into points (full id space)
    obs_cam: jnp.ndarray       # (O,) int32
    obs_uv: jnp.ndarray        # (O, 2) pixel observations
    obs_mask: jnp.ndarray      # (O,) bool
    pose_free: jnp.ndarray     # (I, 6) f32 1=free 0=fixed (per component)
    point_free: jnp.ndarray    # (P,) f32
    pair_a: jnp.ndarray        # (Q,) int32 obs index (track co-observation pairs)
    pair_b: jnp.ndarray        # (Q,) int32
    pair_mask: jnp.ndarray     # (Q,) bool
    rot_prior: jnp.ndarray     # (I, 3) prior rvec
    rot_prior_weight: jnp.ndarray  # (I,) f32, 0 disables
    img_order: jnp.ndarray     # (O,) int32 permutation sorting obs by image
    obs_image_sorted: jnp.ndarray  # (O,) int32 = obs_image[img_order]
    obs_point_dense: jnp.ndarray   # (O,) int32 sorted gapless dense point ids
    point_rows: jnp.ndarray        # (Pd,) int32 dense row -> full point row
                                   #   (pads hold P: dropped on scatter-back)
    point_free_dense: jnp.ndarray  # (Pd,) f32


def build_problem(
    poses,
    points,
    cam_params,
    cam_models,
    obs_image,
    obs_point,
    obs_cam,
    obs_uv,
    pose_states=None,
    point_fixed=None,
    rot_prior=None,
    rot_prior_weight=None,
    obs_capacity=None,
    pair_capacity=None,
    bucket=False,
    with_pairs=True,
    host=False,
):
    """Host-side problem construction (numpy in, BAProblem of jnp arrays out).

    Capacities allow bucketing to avoid recompilation across calls;
    `bucket=True` rounds every dynamic dimension (images, points,
    observations) up to coarse quanta so repeated solves hit the jit cache
    — without it the LM loop recompiles every call and compilation
    dominates wall-clock (the padding rows are fixed/masked and contribute
    nothing). `with_pairs`/`pair_capacity` are accepted for API
    compatibility and ignored: the dense Schur off-diagonal now comes from
    per-(point, image) aggregation (see _ptblk_agg), not an explicit
    co-observation pair list.
    """
    obs_image = np.asarray(obs_image, np.int32)
    obs_point = np.asarray(obs_point, np.int32)
    obs_cam = np.asarray(obs_cam, np.int32)
    obs_uv = np.asarray(obs_uv, np.float32)
    O = len(obs_image)

    # Sort observations by (3-D point, image): the large segment_sums
    # (per-point blocks, CG matvec reductions — P segments vs only I for
    # images) AND the dense-Schur per-(point, image) aggregation ids then
    # run with indices_are_sorted=True, which XLA lowers far better than a
    # random scatter-add.
    if O:
        order0 = np.lexsort((obs_image, obs_point))
        obs_image = obs_image[order0]
        obs_point = obs_point[order0]
        obs_cam = obs_cam[order0]
        obs_uv = obs_uv[order0]

    # Dense point ids: rank the points that actually carry observations in
    # sorted order (gapless 0..Pd0-1). All per-point solver state runs in
    # this space; `rows0` maps dense row -> full point row.
    order = np.arange(O)
    sorted_pts = obs_point
    if O:
        new_group = np.empty(O, bool)
        new_group[0] = True
        new_group[1:] = sorted_pts[1:] != sorted_pts[:-1]
        group_id = (np.cumsum(new_group) - 1).astype(np.int32)  # (O,) dense
        starts = np.where(new_group)[0]                # (Pd0,)
        counts = np.diff(np.append(starts, O))         # (Pd0,) track sizes k
        rows0 = sorted_pts[starts].astype(np.int32)    # dense -> full row
    else:
        group_id = np.zeros(0, np.int32)
        starts = np.zeros(0, np.int64)
        counts = np.zeros(0, np.int64)
        rows0 = np.zeros(0, np.int32)
    Pd0 = len(rows0)

    # The dense Schur off-diagonal is computed from per-(point, block)
    # AGGREGATES (S_off[i,j] = sum_p That_p[i] Ghat_p[j]^T) — the explicit
    # O(sum track_len^2) co-observation pair list that earlier revisions
    # enumerated here is gone entirely (it dominated host build time and
    # HBM on dense problems). `with_pairs` is accepted for API
    # compatibility and ignored; the pair fields stay empty.
    del with_pairs
    pair_a = np.zeros(0, np.int64)
    pair_b = np.zeros(0, np.int64)
    Q = len(pair_a)
    pair_capacity = 0

    def round_up(n, q):
        return max(((n + q - 1) // q) * q, q)

    if obs_capacity is None:
        obs_capacity = round_up(O, 4096) if bucket else O
    assert obs_capacity >= O

    def pad(arr, n, fill=0):
        out = np.full((n,) + arr.shape[1:], fill, arr.dtype)
        out[: len(arr)] = arr
        return out

    obs_mask = pad(np.ones(O, bool), obs_capacity, False)
    pair_mask = pad(np.ones(Q, bool), pair_capacity, False)

    # By-image permutation: image-keyed reductions gather through it and
    # run as SORTED segment sums (same trick as the by-point main order).
    img_order = np.argsort(obs_image, kind="stable") if O else np.zeros(0, np.int64)
    obs_image_sorted = obs_image[img_order] if O else np.zeros(0, np.int32)
    # Padding: img_order must gather the padded rows THEMSELVES (their
    # values are masked zeros) — gathering any real row would double-count
    # it into the normal equations. obs_image_sorted pads with the last
    # image index to keep the sorted invariant.
    img_order_p = np.concatenate([
        img_order.astype(np.int32),
        np.arange(O, obs_capacity, dtype=np.int32),
    ])
    obs_image_sorted_p = pad(obs_image_sorted, obs_capacity,
                             fill=int(obs_image_sorted[-1]) if O else 0)

    I0 = len(poses)
    P0 = len(points)
    I = round_up(I0, 8) if bucket else I0
    P = round_up(P0, 1024) if bucket else P0
    poses = pad(np.asarray(poses, np.float32), I)
    points = pad(np.asarray(points, np.float32), P)

    pose_free = np.ones((I, 6), np.float32)
    pose_free[I0:] = 0.0  # bucketing padding: fully fixed dummy poses
    if pose_states is not None:
        for i, s in enumerate(pose_states):
            if s == BA_POSE_FIXED:
                pose_free[i] = 0.0
            elif s == BA_POSE_FIXED_X:
                pose_free[i, 3] = 0.0  # x-translation pinned
    point_free = np.ones((P,), np.float32)
    point_free[P0:] = 0.0  # padding points pinned
    if point_fixed is not None:
        point_free[:P0][np.asarray(point_fixed, bool)] = 0.0

    # Dense point-space padding: pad rows point AT P (out of range) so the
    # final scatter-back drops them; their gathered value clamps to the
    # last point row and never changes (free=0, no observations).
    Pd = round_up(Pd0, 1024) if bucket else max(Pd0, 1)
    point_rows = np.full(Pd, P, np.int32)
    point_rows[:Pd0] = rows0
    point_free_dense = np.zeros(Pd, np.float32)
    point_free_dense[:Pd0] = point_free[rows0]

    if rot_prior is None:
        rot_prior = np.zeros((I, 3), np.float32)
    else:
        rot_prior = pad(np.asarray(rot_prior, np.float32), I)
    if rot_prior_weight is None:
        rot_prior_weight = np.zeros((I,), np.float32)
    else:
        rot_prior_weight = pad(np.asarray(rot_prior_weight, np.float32), I)

    prob_np = BAProblem(
        poses=np.asarray(poses, np.float32),
        points=np.asarray(points, np.float32),
        cam_params=np.asarray(cam_params, np.float32),
        cam_models=np.asarray(cam_models, np.int32),
        # Padding keeps the LAST image index so the combined
        # (point, image) aggregation ids stay sorted.
        obs_image=pad(obs_image, obs_capacity,
                      fill=int(obs_image[-1]) if O else 0),
        # Padding rows keep the LAST point index so obs_point stays sorted
        # (indices_are_sorted=True in the point-keyed segment sums; masked
        # rows contribute zeros wherever they land).
        obs_point=pad(obs_point, obs_capacity,
                      fill=int(obs_point[-1]) if O else 0),
        obs_cam=pad(obs_cam, obs_capacity),
        obs_uv=pad(obs_uv, obs_capacity),
        obs_mask=obs_mask,
        pose_free=pose_free,
        point_free=point_free,
        pair_a=pad(pair_a.astype(np.int32), pair_capacity),
        pair_b=pad(pair_b.astype(np.int32), pair_capacity),
        pair_mask=pair_mask,
        rot_prior=np.asarray(rot_prior, np.float32),
        rot_prior_weight=np.asarray(rot_prior_weight, np.float32),
        img_order=img_order_p,
        obs_image_sorted=obs_image_sorted_p,
        # Padding keeps the LAST dense id (sorted invariant; masked rows
        # contribute zeros wherever they land).
        obs_point_dense=pad(group_id, obs_capacity,
                            fill=int(group_id[-1]) if O else 0),
        point_rows=point_rows,
        point_free_dense=point_free_dense,
    )
    if host:
        return prob_np
    return jax.tree.map(jnp.asarray, prob_np)


def pack_problem(prob: BAProblem):
    """Pack a HOST (numpy) BAProblem into 6 consolidated buffers.

    Every argument buffer of a jitted call is one more host->device
    transfer at dispatch; the packed entry points (_lm_loop_packed and the
    selfcal variant) ship these 6 arrays instead of 21 and rebuild the
    BAProblem INSIDE the program, where slicing is free. Whether this
    still pays on a local card is ROADMAP D2.
    """
    obs_i = np.stack([
        prob.obs_image, prob.obs_point, prob.obs_cam,
        np.asarray(prob.img_order, np.int32), prob.obs_image_sorted,
        prob.obs_point_dense,
    ], axis=1).astype(np.int32)                      # (O, 6)
    obs_f = np.concatenate([
        prob.obs_uv, prob.obs_mask[:, None].astype(np.float32)
    ], axis=1).astype(np.float32)                    # (O, 3)
    img_f = np.concatenate([
        prob.poses, prob.pose_free, prob.rot_prior,
        prob.rot_prior_weight[:, None],
    ], axis=1).astype(np.float32)                    # (I, 16)
    pt_f = np.concatenate([
        prob.points, prob.point_free[:, None]
    ], axis=1).astype(np.float32)                    # (P, 4)
    ptd_i = np.stack([
        prob.point_rows,
        prob.point_free_dense.astype(np.int32),      # 0/1 exact
    ], axis=1).astype(np.int32)                      # (Pd, 2)
    cams = np.concatenate([
        prob.cam_params, prob.cam_models[:, None].astype(np.float32)
    ], axis=1).astype(np.float32)                    # (C, 10)
    return obs_i, obs_f, img_f, pt_f, ptd_i, cams


def _unpack_problem(obs_i, obs_f, img_f, pt_f, ptd_i, cams) -> BAProblem:
    """Rebuild the BAProblem from pack_problem's buffers (inside jit)."""
    Q = 0
    return BAProblem(
        poses=img_f[:, :6],
        points=pt_f[:, :3],
        cam_params=cams[:, :9],
        cam_models=cams[:, 9].astype(jnp.int32),
        obs_image=obs_i[:, 0],
        obs_point=obs_i[:, 1],
        obs_cam=obs_i[:, 2],
        obs_uv=obs_f[:, :2],
        obs_mask=obs_f[:, 2] > 0.5,
        pose_free=img_f[:, 6:12],
        point_free=pt_f[:, 3],
        pair_a=jnp.zeros(Q, jnp.int32),
        pair_b=jnp.zeros(Q, jnp.int32),
        pair_mask=jnp.zeros(Q, bool),
        rot_prior=img_f[:, 12:15],
        rot_prior_weight=img_f[:, 15],
        img_order=obs_i[:, 3],
        obs_image_sorted=obs_i[:, 4],
        obs_point_dense=obs_i[:, 5],
        point_rows=ptd_i[:, 0],
        point_free_dense=ptd_i[:, 1].astype(jnp.float32),
    )


# ---------------------------------------------------------------- residuals


def _obs_residual(pose, point, kparams, model_code, uv):
    """Pixel-space reprojection residual for one observation (2,)."""
    R = rotmat_from_rvec(pose[:3])
    xc = R @ point + pose[3:]
    uvp = cam.world2image(xc, model_code, kparams)
    return uvp - uv


def _all_residuals(prob: BAProblem, poses, points_d):
    """(O, 2) residuals for all observations. points_d is DENSE (Pd, 3)."""

    def one(img, pt, cm, uv):
        return _obs_residual(
            poses[img], points_d[pt], prob.cam_params[cm],
            prob.cam_models[cm], uv
        )

    return jax.vmap(one)(prob.obs_image, prob.obs_point_dense, prob.obs_cam,
                         prob.obs_uv)


def _gather_dense_points(prob: BAProblem, points):
    """(P, 3) full points -> (Pd, 3) dense rows (pads clamp to the last)."""
    return points[jnp.minimum(prob.point_rows, points.shape[0] - 1)]


def _scatter_dense_points(prob: BAProblem, points, points_d):
    """Write dense rows back into the full array (pad rows dropped)."""
    return points.at[prob.point_rows].set(points_d, mode="drop")


def _rot_residuals(prob: BAProblem, poses):
    """(I, 9) weighted Frobenius rotation-prior residuals.

    Matches BARotationConstraintCostFunction (reference
    bundle_adjustment.cc:57-111): w * (R(rvec) - R(prior)) flattened.
    """
    R = rotmat_from_rvec(poses[:, :3])
    R0 = rotmat_from_rvec(prob.rot_prior)
    w = prob.rot_prior_weight[:, None, None]
    return (w * (R - R0)).reshape(poses.shape[0], 9)


def _cauchy_weight(res_sq_norm, scale):
    """IRLS weight rho'(s) for the Cauchy loss rho(s) = c^2 log(1 + s/c^2)."""
    return 1.0 / (1.0 + res_sq_norm / (scale * scale))


def _total_cost_d(prob: BAProblem, poses, points_d, scale):
    """Robust total cost over DENSE points (column arithmetic)."""
    from . import colmath as cm

    r2 = cm.residual_cols(
        poses[prob.obs_image], points_d[prob.obs_point_dense],
        prob.cam_params[prob.obs_cam], prob.cam_models[prob.obs_cam],
        prob.obs_uv,
    )
    s = r2[0] * r2[0] + r2[1] * r2[1]
    c2 = scale * scale
    rho = c2 * jnp.log1p(s / c2)
    cost = 0.5 * jnp.sum(jnp.where(prob.obs_mask, rho, 0.0))
    rr = _rot_residuals(prob, poses)
    cost = cost + 0.5 * jnp.sum(rr * rr)
    return cost


def total_cost(prob: BAProblem, poses, points, scale):
    """Robust total cost (0.5 sum rho(||r||^2)), matching Ceres' objective.

    Takes the FULL (P, 3) points array (public API)."""
    return _total_cost_d(prob, poses, _gather_dense_points(prob, points),
                         scale)


# ------------------------------------------------------------ normal eqs


def _obs_jacobians(prob: BAProblem, poses, points_d):
    """Batched residuals + Jacobians: r (O,2), Jc (O,2,6), Jp (O,2,3)."""

    def one(img, pt, cm, uv):
        def f(pose, point):
            return _obs_residual(
                pose, point, prob.cam_params[cm], prob.cam_models[cm], uv
            )

        r = f(poses[img], points_d[pt])
        Jc, Jp = jax.jacfwd(f, argnums=(0, 1))(poses[img], points_d[pt])
        return r, Jc, Jp

    return jax.vmap(one)(prob.obs_image, prob.obs_point_dense, prob.obs_cam,
                         prob.obs_uv)


def _rot_prior_blocks(prob: BAProblem, poses):
    """Per-pose (6x6 JᵀJ, 6 Jᵀr) contributions of the IMU rotation priors
    (BARotationConstraintCostFunction, reference bundle_adjustment.cc:57-111)."""

    def rot_one(pose, prior, wgt, free):
        def f(p):
            R = rotmat_from_rvec(p[:3])
            R0 = rotmat_from_rvec(prior)
            return (wgt * (R - R0)).reshape(9)

        rr = f(pose)
        Jr = jax.jacfwd(f)(pose) * free[None, :]
        return Jr.T @ Jr, Jr.T @ rr

    return jax.vmap(rot_one)(poses, prob.rot_prior, prob.rot_prior_weight,
                             prob.pose_free)


def _seg_img(prob: BAProblem, vals, I):
    """Image-keyed reduction (any trailing shape): gather by the
    precomputed by-image permutation, then a sorted segment sum — the
    Pallas/Triton kernel on CUDA devices (ops/segment.py): long runs of
    one image are where XLA's scatter-add lost to it inside the CG solver
    (57 -> 30 ms per LM iteration at 1000 cameras, PERF.md)."""
    return segment_sum_sorted(vals[prob.img_order], prob.obs_image_sorted, I)


def _seg_ids(ids, vals, S):
    """Reduction keyed by arbitrary (unsorted) ids into S segments."""
    return jax.ops.segment_sum(vals, ids, num_segments=S)


def _seg_pt(prob: BAProblem, vals):
    """Dense-point-keyed reduction (sorted gapless ids, short runs): XLA's
    sorted scatter-add, which beat the kernel at this site on the H100."""
    return jax.ops.segment_sum(vals, prob.obs_point_dense,
                               num_segments=prob.point_rows.shape[0],
                               indices_are_sorted=True)


def _inv3x3(M):
    """Closed-form batched 3x3 inverse (adjugate / det) — elementwise ops
    only; far faster than batched LU for the (P, 3, 3) point blocks."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    adj = jnp.stack([
        jnp.stack([A, B, C], axis=-1),
        jnp.stack([D, E, F], axis=-1),
        jnp.stack([G, H, I], axis=-1),
    ], axis=-2)
    return adj * inv_det[..., None, None]


def _assemble_blocks(prob: BAProblem, poses, points_d, lam, scale,
                     psum_axis=None):
    """Shared normal-equation block assembly for both Schur solvers.

    points_d is DENSE (Pd, 3); all per-point outputs are dense too.
    Everything per-observation runs in COLUMN ARITHMETIC (ba/colmath.py) —
    flat (O, K) arrays, no tiny-minor-dim einsum layouts.
    Returns (U, Vinv, bp, G, T, g_red):
      U     (I,6,6)  damped per-image blocks incl. rotation priors,
      Vinv  (Pd,9)   FLAT inverse damped point blocks (row-major 3x3),
      bp    (Pd,3)   point gradients,
      G     (O,18)   FLAT camera-point coupling Jc^T W Jp (row-major 6x3),
      T     (O,18)   FLAT G V^-1,
      g_red (I,6)    reduced gradient bc - sum_o T_o bp[pt_o].

    With `psum_axis` (inside shard_map, point-disjoint observation
    sharding), U/g_red are psum-reduced over the mesh axis; V/bp/G/T stay
    shard-local because every observation of a point lives on one shard.
    """
    from . import colmath as cm

    I = poses.shape[0]

    poses_o = poses[prob.obs_image]
    X_o = points_d[prob.obs_point_dense]
    cams_o = prob.cam_params[prob.obs_cam]
    codes_o = prob.cam_models[prob.obs_cam]
    r2, Jc, Jp = cm.residual_jacobian_cols(poses_o, X_o, cams_o, codes_o,
                                           prob.obs_uv)
    w = _cauchy_weight(r2[0] * r2[0] + r2[1] * r2[1], scale)
    w = jnp.where(prob.obs_mask, w, 0.0)

    # Apply gauge masks directly to the Jacobian columns (fixed params
    # contribute nothing and receive no update).
    pf_o = prob.pose_free[prob.obs_image]            # (O, 6)
    pfd_o = prob.point_free_dense[prob.obs_point_dense]  # (O,)
    for k in range(2):
        for i in range(6):
            Jc[k][i] = Jc[k][i] * pf_o[:, i]
        for i in range(3):
            Jp[k][i] = Jp[k][i] * pfd_o

    # Per-image 6x6 blocks + gradient: one (O, 42) reduction.
    Ubc = cm.stack_cols_wide(cm.jtwj_cols(Jc, Jc, w) + cm.jtwr_cols(Jc, r2, w))
    UB = _seg_img(prob, Ubc, I)
    U = UB[:, :36].reshape(I, 6, 6)
    bc = UB[:, 36:]
    if psum_axis is not None:
        U = jax.lax.psum(U, psum_axis)
        bc = jax.lax.psum(bc, psum_axis)
    # Per-point 3x3 blocks + gradient: one (O, 12) dense reduction.
    Vbp = _seg_pt(
        prob,
        cm.stack_cols_wide(cm.jtwj_cols(Jp, Jp, w) + cm.jtwr_cols(Jp, r2, w)),
    )
    Vf = Vbp[:, :9]    # (Pd, 9) flat
    bp = Vbp[:, 9:]

    # Rotation-prior residuals add to the pose diagonal (rvec part only).
    # Replicated data in the sharded case: added once, after the psum.
    Ur, br = _rot_prior_blocks(prob, poses)
    U = U + Ur
    bc = bc + br

    # Marquardt damping: lambda * diag(H) (+ small floor) — scales the step
    # correctly across wildly different parameter magnitudes (radians vs
    # focal lengths), unlike lambda * I.
    d = jnp.diagonal(U, axis1=-2, axis2=-1)
    U = U + (lam * (d + 1e-6))[..., None] * jnp.eye(6)
    Vcols = cm.cols_of(Vf)
    dampf = lam  # same Marquardt rule, column form
    pin = 1.0 - prob.point_free_dense
    for di in (0, 4, 8):
        Vcols[di] = Vcols[di] + dampf * (Vcols[di] + 1e-6) + pin

    Vinv = cm.stack_cols(cm.inv3x3_cols(Vcols))  # (Pd, 9) flat

    # Per-observation camera-point coupling G_o = Jc^T W Jp (6x3 flat) and
    # T = G V^-1.
    Gcols = cm.jtwj_cols(Jc, Jp, w)                         # 18 columns
    Vinv_o = Vinv[prob.obs_point_dense]                     # (O, 9)
    Tcols = cm.matmul_cols(Gcols, cm.cols_of(Vinv_o), 6, 3, 3)
    # NOT wide: G/T are consumed column-wise inside the CG loop — the
    # transposed construction materializes worse there.
    G = cm.stack_cols(Gcols)
    T = cm.stack_cols(Tcols)

    # Reduced gradient: g = bc - sum_o T_o bp[pt_o] scattered to img_o.
    bp_o = cm.cols_of(bp[prob.obs_point_dense])
    g_local = _seg_img(
        prob, cm.stack_cols(cm.matvec_cols(Tcols, bp_o, 6, 3)), I
    )
    if psum_axis is not None:
        g_local = jax.lax.psum(g_local, psum_axis)
    g_red = bc - g_local
    return U, Vinv, bp, G, T, g_red


def _backsub_points(prob: BAProblem, Vinv, bp, G, dc):
    """dp_p = -V^-1 (bp_p + sum_{o in p} G_o^T dc[img_o]) — DENSE (Pd, 3).

    Vinv (Pd,9) and G (O,18) are FLAT row-major blocks."""
    from . import colmath as cm

    dc_o = cm.cols_of(dc[prob.obs_image])
    Gt_dc = _seg_pt(
        prob,
        cm.stack_cols(cm.matTvec_cols(cm.cols_of(G), dc_o, 6, 3)),
    )
    rhs = cm.cols_of(bp + Gt_dc)
    dp = cm.stack_cols(cm.matvec_cols(cm.cols_of(Vinv), rhs, 3, 3))
    return -dp * prob.point_free_dense[:, None]


def _ptblk_agg(prob: BAProblem, vals, nblk, blk_ids, sorted_ids=True):
    """Per-(point, block) aggregation: (O, K) values -> (Pd, nblk, K).

    The Schur off-diagonal is sum_p That_p[i] Ghat_p[j]^T — aggregating the
    couplings per (point, block) FIRST replaces the O(sum track_len^2)
    explicit pair enumeration with one sorted segment sum over
    observations plus one batched matmul (observations are sorted by
    (point, image) at build time; padding keeps ids monotone)."""
    Pd = prob.point_rows.shape[0]
    ids = prob.obs_point_dense * nblk + blk_ids
    out = jax.ops.segment_sum(vals, ids, num_segments=Pd * nblk,
                              indices_are_sorted=sorted_ids)
    return out.reshape(Pd, nblk, vals.shape[1] // 3, 3)


def _lm_step(prob: BAProblem, poses, points_d, lam, scale):
    """One damped LM solve (exact dense Schur): returns (dposes, dpoints_d)."""
    I = poses.shape[0]
    U, Vinv, bp, G, T, g_red = _assemble_blocks(prob, poses, points_d, lam,
                                                scale)

    # Schur: S = U - sum_p That_p[i] Ghat_p[j]^T via per-(point, image)
    # aggregation (G/T rows carry the w factor, so masked rows are zero).
    That = _ptblk_agg(prob, T, I, prob.obs_image)  # (Pd, I, 6, 3)
    Ghat = _ptblk_agg(prob, G, I, prob.obs_image)
    S_off = jnp.einsum("pbij,pckj->bcik", That, Ghat)
    S = jnp.zeros((I, I, 6, 6)).at[jnp.arange(I), jnp.arange(I)].set(U)
    S = S - S_off

    # Dense solve over (6I, 6I) with fixed rows/cols pinned to identity.
    Sd = S.transpose(0, 2, 1, 3).reshape(I * 6, I * 6)
    free = prob.pose_free.reshape(I * 6)
    Sd = Sd * free[:, None] * free[None, :] + jnp.diag(1.0 - free)
    gd = g_red.reshape(I * 6) * free

    dc = -jnp.linalg.solve(Sd, gd).reshape(I, 6)
    dc = dc * prob.pose_free

    dp = _backsub_points(prob, Vinv, bp, G, dc)
    return dc, dp


def _lm_step_cg(prob: BAProblem, poses, points_d, lam, scale,
                cg_iters: int, cg_tol, psum_axis=None):
    """One damped LM solve via MATRIX-FREE preconditioned CG on the reduced
    camera system — the analog of Ceres' ITERATIVE_SCHUR +
    SCHUR_JACOBI (the reference uses SPARSE_SCHUR,
    bundle_adjustment.cc:554-569; CG is what scales past ~1k cameras).

    The Schur matvec S x = U x - G V^-1 (G^T x) needs NO co-observation
    pair enumeration: two segment-sums over observations (gather x by
    image, reduce by point, scale by V^-1, scatter back by image) — O(obs)
    per CG iteration instead of O(sum track_len^2) pair scatter.

    Preconditioner: block-Jacobi over the 6x6 diagonal blocks of S
    (D_i = U_i - sum_{o: img_o = i} T_o G_o^T — per-observation, exact).
    With `psum_axis` the matvec and the preconditioner blocks are
    psum-reduced across the mesh (observations sharded point-disjointly,
    poses replicated): one (I,6) psum per CG iteration.
    """
    I = poses.shape[0]
    U, Vinv, bp, G, T, g_red = _assemble_blocks(
        prob, poses, points_d, lam, scale, psum_axis=psum_axis,
    )
    from . import colmath as cm

    free = prob.pose_free  # (I, 6)
    Gcols = cm.cols_of(G)
    Tcols = cm.cols_of(T)

    # Block-Jacobi preconditioner: exact diagonal blocks of S.
    D_local = _seg_img(
        prob, cm.stack_cols(cm.abt_cols(Tcols, Gcols, 6, 3, 6)), I
    ).reshape(I, 6, 6)
    if psum_axis is not None:
        D_local = jax.lax.psum(D_local, psum_axis)
    D = U - D_local
    # Pin fixed components so the blocks stay invertible.
    D = D * free[:, :, None] * free[:, None, :]
    D = D + jax.vmap(jnp.diag)(1.0 - free)
    Minv = jnp.linalg.inv(D)  # (I, 6, 6)

    def matvec(x):  # x (I, 6), free-masked
        y = jnp.einsum("iab,ib->ia", U, x)
        x_o = cm.cols_of(x[prob.obs_image])
        t = cm.stack_cols(cm.matTvec_cols(Gcols, x_o, 6, 3))  # (O, 3)
        tp = _seg_pt(prob, t)
        s = cm.stack_cols(
            cm.matvec_cols(cm.cols_of(Vinv), cm.cols_of(tp), 3, 3)
        )
        s_o = cm.cols_of(s[prob.obs_point_dense])
        y2 = _seg_img(
            prob, cm.stack_cols(cm.matvec_cols(Gcols, s_o, 6, 3)), I,
        )
        if psum_axis is not None:
            y2 = jax.lax.psum(y2, psum_axis)
        return (y - y2) * free

    b = -g_red * free
    r0n = jnp.sqrt(jnp.sum(b * b))
    x = jnp.zeros_like(b)
    r = b
    z = jnp.einsum("iab,ib->ia", Minv, r) * free
    p = z
    rz = jnp.sum(r * z)

    # Early-exit while_loop: every quantity in the predicate is identical
    # across shards (psum-reduced), so the loop stays collective-consistent
    # under shard_map without a static trip count.
    def cg_cond(state):
        _, r, _, _, it = state
        return (it < cg_iters) & (jnp.sqrt(jnp.sum(r * r)) > cg_tol * r0n)

    def cg_body(state):
        x, r, p, rz, it = state
        Sp = matvec(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Sp), 1e-30)
        x = x + alpha * p
        r = r - alpha * Sp
        z = jnp.einsum("iab,ib->ia", Minv, r) * free
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return x, r, p, rz_new, it + 1

    x, _, _, _, _ = jax.lax.while_loop(cg_cond, cg_body, (x, r, p, rz, 0))
    dc = x * free
    dp = _backsub_points(prob, Vinv, bp, G, dc)
    return dc, dp


def _obs_jacobians_full(prob: BAProblem, poses, points_d, cam_params):
    """Batched residuals + Jacobians incl. intrinsics: r (O,2), Jc (O,2,6),
    Jp (O,2,3), Jk (O,2,9) — for refine_camera_params."""

    def one(img, pt, cm, uv):
        def f(pose, point, kp):
            return _obs_residual(pose, point, kp, prob.cam_models[cm], uv)

        r = f(poses[img], points_d[pt], cam_params[cm])
        Jc, Jp, Jk = jax.jacfwd(f, argnums=(0, 1, 2))(
            poses[img], points_d[pt], cam_params[cm]
        )
        return r, Jc, Jp, Jk

    return jax.vmap(one)(prob.obs_image, prob.obs_point_dense, prob.obs_cam,
                         prob.obs_uv)


def _assemble_selfcal_blocks(prob: BAProblem, poses, points_d, cam_params,
                             cam_free, lam, scale):
    """Shared assembly for both self-calibration solvers.

    Returns (E, blk, w, Vinv, bp, G, T, g, g_red, Ddiag, Ur9): per-
    observation entry Jacobians E (O,2,2,9) with entry 0 = pose block
    (9-padded) and entry 1 = shared-intrinsics block, their block ids blk
    (O,2), robust weights, damped point blocks, couplings G/T, gradient and
    reduced gradient over the B=I+C blocks, the direct DIAGONAL blocks
    Ddiag (incl. rotation priors, undamped), and the pose-row prior blocks
    Ur9. points_d / all per-point outputs are DENSE.

    Column-arithmetic layout (ba/colmath.py): Ecols[a] is the 2x9
    column-list Jacobian of entry a (0 = pose block 9-padded, 1 = shared
    intrinsics); Gcols[a]/Tcols[a] are 27 flat columns (9x3 row-major);
    Vinv is (Pd, 9) flat."""
    from . import colmath as cm

    I = poses.shape[0]
    C = cam_params.shape[0]
    B = I + C
    O = prob.obs_uv.shape[0]

    poses_o = poses[prob.obs_image]
    X_o = points_d[prob.obs_point_dense]
    cams_o = cam_params[prob.obs_cam]
    codes_o = prob.cam_models[prob.obs_cam]
    r2, Jc, Jp, Jk = cm.residual_jacobian_cols(
        poses_o, X_o, cams_o, codes_o, prob.obs_uv, with_intrinsics=True
    )
    w = _cauchy_weight(r2[0] * r2[0] + r2[1] * r2[1], scale)
    w = jnp.where(prob.obs_mask, w, 0.0)

    pf_o = prob.pose_free[prob.obs_image]
    pfd_o = prob.point_free_dense[prob.obs_point_dense]
    cf_o = cam_free[prob.obs_cam]
    zero = jnp.zeros((O,), poses_o.dtype)
    for k in range(2):
        for i in range(6):
            Jc[k][i] = Jc[k][i] * pf_o[:, i]
        for i in range(3):
            Jp[k][i] = Jp[k][i] * pfd_o
        for i in range(9):
            Jk[k][i] = Jk[k][i] * cf_o[:, i]
    Ecols = [
        [[Jc[0][i] if i < 6 else zero for i in range(9)],
         [Jc[1][i] if i < 6 else zero for i in range(9)]],
        Jk,
    ]
    blk = jnp.stack([prob.obs_image, I + prob.obs_cam], axis=1)  # (O, 2)

    g = jnp.zeros((B, 9))
    Ddiag = jnp.zeros((B, 9, 9))
    for a in range(2):
        g = g + _seg_ids(
            blk[:, a], cm.stack_cols_wide(cm.jtwr_cols(Ecols[a], r2, w)),
            B,
        )
        Ddiag = Ddiag + _seg_ids(
            blk[:, a],
            cm.stack_cols_wide(cm.jtwj_cols(Ecols[a], Ecols[a], w)),
            B,
        ).reshape(B, 9, 9)

    Vbp = _seg_pt(
        prob,
        cm.stack_cols_wide(cm.jtwj_cols(Jp, Jp, w) + cm.jtwr_cols(Jp, r2, w)),
    )
    Vcols = cm.cols_of(Vbp[:, :9])
    bp = Vbp[:, 9:]
    pin = 1.0 - prob.point_free_dense
    for di in (0, 4, 8):
        Vcols[di] = Vcols[di] + lam * (Vcols[di] + 1e-6) + pin
    Vinv = cm.stack_cols_wide(cm.inv3x3_cols(Vcols))  # (Pd, 9) flat

    Ur, br = _rot_prior_blocks(prob, poses)
    Ur9 = jnp.zeros((I, 9, 9)).at[:, :6, :6].set(Ur)
    Ddiag = Ddiag.at[jnp.arange(I)].add(Ur9)
    g = g.at[:I, :6].add(br)

    Vinv_o = cm.cols_of(Vinv[prob.obs_point_dense])
    Gcols = [cm.jtwj_cols(Ecols[a], Jp, w) for a in range(2)]   # 27 each
    Tcols = [cm.matmul_cols(Gcols[a], Vinv_o, 9, 3, 3) for a in range(2)]

    bp_o = cm.cols_of(bp[prob.obs_point_dense])
    g_red = g - sum(
        _seg_ids(
            blk[:, a],
            cm.stack_cols_wide(cm.matvec_cols(Tcols[a], bp_o, 9, 3)),
            B,
        )
        for a in range(2)
    )
    return Ecols, blk, w, Vinv, bp, Gcols, Tcols, g, g_red, Ddiag, Ur9


def _selfcal_backsub(prob: BAProblem, Vinv, bp, Gcols, blk, dx):
    from . import colmath as cm

    Gt_dx = sum(
        _seg_pt(
            prob,
            cm.stack_cols(
                cm.matTvec_cols(Gcols[a], cm.cols_of(dx[blk[:, a]]), 9, 3)
            ),
        )
        for a in range(2)
    )
    rhs = cm.cols_of(bp + Gt_dx)
    dp = cm.stack_cols(cm.matvec_cols(cm.cols_of(Vinv), rhs, 3, 3))
    return -dp * prob.point_free_dense[:, None]


def _lm_step_selfcal(prob: BAProblem, poses, points_d, cam_params, cam_free,
                     lam, scale):
    """One damped LM solve with SHARED per-camera intrinsics as additional
    unknowns in the reduced camera system (reference refine_camera_params,
    bundle_adjustment.cc:370-376: the camera_params block is variable and
    shared by every image using that camera).

    The reduced system has I pose blocks (9-padded from 6) followed by C
    intrinsics blocks (9): dimension 9*(I + C). Every observation carries
    TWO camera-side entries — its pose block and its camera block — and the
    Schur pair sum runs over the 4 entry combinations per co-observation
    pair. Returns (dposes, dpoints, dcams).
    """
    from . import colmath as cm

    I = poses.shape[0]
    C = cam_params.shape[0]
    B = I + C

    (Ecols, blk, w, Vinv, bp, Gcols, Tcols, g, g_red, Ddiag,
     Ur9) = _assemble_selfcal_blocks(
        prob, poses, points_d, cam_params, cam_free, lam, scale,
    )

    # Full direct Hessian: all entry pairs within one observation — the 4
    # entry combinations fused into ONE one-hot reduction (4O rows).
    h_ids = []
    h_vals = []
    for a in range(2):
        for b in range(2):
            h_vals.append(cm.stack_cols_wide(
                cm.jtwj_cols(Ecols[a], Ecols[b], w)
            ).reshape(-1, 9, 9))
            h_ids.append(blk[:, a] * B + blk[:, b])
    H = _seg_ids(jnp.concatenate(h_ids), jnp.concatenate(h_vals), B * B)
    H = H.reshape(B, B, 9, 9)
    H = H.at[jnp.arange(I), jnp.arange(I)].add(Ur9)

    # Schur off-diagonal via per-(point, block) aggregation over BOTH
    # entries (pose block + shared-intrinsics block): S_off[b, c] =
    # sum_p That_p[b] Ghat_p[c]^T — covers all 4 entry combinations of
    # every co-observation pair with two sorted segment sums and one
    # batched matmul, no pair enumeration. Entry 1's ids (camera blocks)
    # are only near-sorted within a point for multi-camera rigs.
    G2 = [cm.stack_cols_wide(Gcols[a]) for a in range(2)]  # (O, 27)
    T2 = [cm.stack_cols_wide(Tcols[a]) for a in range(2)]
    That = (_ptblk_agg(prob, T2[0], B, blk[:, 0])
            + _ptblk_agg(prob, T2[1], B, blk[:, 1], sorted_ids=False))
    Ghat = (_ptblk_agg(prob, G2[0], B, blk[:, 0])
            + _ptblk_agg(prob, G2[1], B, blk[:, 1], sorted_ids=False))
    S_off = jnp.einsum("pbij,pckj->bcik", That, Ghat)

    S = H - S_off
    # Marquardt damping on the diagonal blocks (diag of the UNDAMPED H).
    dH = jnp.diagonal(Ddiag, axis1=-2, axis2=-1)
    S = S.at[jnp.arange(B), jnp.arange(B)].add(
        (lam * (dH + 1e-6))[..., None] * jnp.eye(9)
    )

    # Free mask over the 9B flat system: poses use 6 of 9; cams use cam_free.
    pose_free9 = jnp.concatenate(
        [prob.pose_free, jnp.zeros((I, 3))], axis=1
    )
    free = jnp.concatenate([pose_free9, cam_free], axis=0).reshape(B * 9)
    Sd = S.transpose(0, 2, 1, 3).reshape(B * 9, B * 9)
    Sd = Sd * free[:, None] * free[None, :] + jnp.diag(1.0 - free)
    gd = g_red.reshape(B * 9) * free  # REDUCED gradient (g alone is wrong)
    dx = -jnp.linalg.solve(Sd, gd).reshape(B, 9)
    dc = dx[:I, :6] * prob.pose_free
    dk = dx[I:] * cam_free

    dp = _selfcal_backsub(prob, Vinv, bp, Gcols, blk, dx)
    return dc, dp, dk


def _lm_step_selfcal_cg(prob: BAProblem, poses, points_d, cam_params,
                        cam_free, lam, scale, cg_iters: int, cg_tol):
    """Matrix-free preconditioned CG version of _lm_step_selfcal: the
    reduced system over 9*(I + C) variables is never materialized (the
    dense path's (B, B, 9, 9) Schur tensor and pair enumeration are the
    memory hogs past a few hundred cameras)."""
    from . import colmath as cm

    I = poses.shape[0]
    C = cam_params.shape[0]
    B = I + C

    (Ecols, blk, w, Vinv, bp, Gcols, Tcols, g, g_red, Ddiag,
     Ur9) = _assemble_selfcal_blocks(
        prob, poses, points_d, cam_params, cam_free, lam, scale,
    )

    # Marquardt damping from the undamped direct diagonal.
    dH = jnp.diagonal(Ddiag, axis1=-2, axis2=-1)
    damp = lam * (dH + 1e-6)

    pose_free9 = jnp.concatenate([prob.pose_free, jnp.zeros((I, 3))], axis=1)
    free = jnp.concatenate([pose_free9, cam_free], axis=0)  # (B, 9)

    # Block-Jacobi preconditioner from per-observation SELF-pairs. For pose
    # blocks this equals the exact Schur diagonal (one observation per
    # point per image); for shared-intrinsics blocks it omits the
    # cross-observation pair terms — still SPD, CG just takes a few more
    # iterations on the 9 intrinsics dims.
    D_schur = sum(
        _seg_ids(
            blk[:, a],
            cm.stack_cols_wide(cm.abt_cols(Tcols[a], Gcols[a], 9, 3, 9)),
            B,
        ).reshape(B, 9, 9)
        for a in range(2)
    )
    D = Ddiag + jax.vmap(jnp.diag)(damp) - D_schur
    D = D * free[:, :, None] * free[:, None, :]
    D = D + jax.vmap(jnp.diag)(1.0 - free)
    Minv = jnp.linalg.inv(D)

    # Stack the per-observation Jacobian columns into 2-D arrays BEFORE the
    # CG loop: ~140 separate (O,) columns carried as while-loop invariants
    # would each materialize as a padded temp. The matvec slices columns
    # back out transiently; XLA fuses the slices.
    E2 = [cm.stack_cols_wide(Ecols[a][0] + Ecols[a][1]) for a in range(2)]
    G2 = [cm.stack_cols_wide(Gcols[a]) for a in range(2)]  # (O, 27)

    def matvec(x):  # x (B, 9), free-masked
        xa = [cm.cols_of(x[blk[:, a]]) for a in range(2)]   # 2 x 9 cols
        # u_k = w * sum_a sum_j E[a][k][j] xa[a][j]  (the 2 residual rows)
        u = [
            w * sum(
                sum(E2[a][:, k * 9 + j] * xa[a][j] for j in range(9))
                for a in range(2)
            )
            for k in range(2)
        ]
        y = jnp.zeros((B, 9))
        for a in range(2):
            contrib = cm.stack_cols(
                [E2[a][:, i] * u[0] + E2[a][:, 9 + i] * u[1]
                 for i in range(9)]
            )
            y = y + _seg_ids(blk[:, a], contrib, B)
        # Rotation prior + damping on the diagonal.
        y = y.at[:I].add(jnp.einsum("iab,ib->ia", Ur9, x[:I]))
        y = y + damp * x
        # Schur term (G carries the w factor already).
        t = [
            sum(
                sum(G2[a][:, i * 3 + j] * xa[a][i] for i in range(9))
                for a in range(2)
            )
            for j in range(3)
        ]
        tp = _seg_pt(prob, cm.stack_cols(t))
        sv = cm.stack_cols(
            cm.matvec_cols(cm.cols_of(Vinv), cm.cols_of(tp), 3, 3)
        )
        sv_o = sv[prob.obs_point_dense]  # (O, 3)
        for a in range(2):
            contrib = cm.stack_cols([
                sum(G2[a][:, i * 3 + j] * sv_o[:, j] for j in range(3))
                for i in range(9)
            ])
            y = y - _seg_ids(blk[:, a], contrib, B)
        return y * free

    b = -g_red * free
    r0n = jnp.sqrt(jnp.sum(b * b))
    x = jnp.zeros_like(b)
    res = b
    z = jnp.einsum("iab,ib->ia", Minv, res) * free
    p = z
    rz = jnp.sum(res * z)

    def cg_cond(state):
        _, rr_, _, _, it = state
        return (it < cg_iters) & (jnp.sqrt(jnp.sum(rr_ * rr_)) > cg_tol * r0n)

    def cg_body(state):
        x, rr_, p, rz, it = state
        Sp = matvec(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Sp), 1e-30)
        x = x + alpha * p
        rr_ = rr_ - alpha * Sp
        z = jnp.einsum("iab,ib->ia", Minv, rr_) * free
        rz_new = jnp.sum(rr_ * z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return x, rr_, p, rz_new, it + 1

    x, _, _, _, _ = jax.lax.while_loop(cg_cond, cg_body, (x, res, p, rz, 0))
    dx = x * free
    dc = dx[:I, :6] * prob.pose_free
    dk = dx[I:] * cam_free
    dp = _selfcal_backsub(prob, Vinv, bp, Gcols, blk, dx)
    return dc, dp, dk


def _total_cost_selfcal_d(prob: BAProblem, poses, points_d, cam_params,
                          scale):
    from . import colmath as cm

    r2 = cm.residual_cols(
        poses[prob.obs_image], points_d[prob.obs_point_dense],
        cam_params[prob.obs_cam], prob.cam_models[prob.obs_cam], prob.obs_uv,
    )
    s = r2[0] * r2[0] + r2[1] * r2[1]
    c2 = scale * scale
    rho = c2 * jnp.log1p(s / c2)
    cost = 0.5 * jnp.sum(jnp.where(prob.obs_mask, rho, 0.0))
    rr = _rot_residuals(prob, poses)
    return cost + 0.5 * jnp.sum(rr * rr)


def total_cost_selfcal(prob: BAProblem, poses, points, cam_params, scale):
    """Robust total cost with explicit intrinsics (FULL points array)."""
    return _total_cost_selfcal_d(
        prob, poses, _gather_dense_points(prob, points), cam_params, scale
    )


@partial(jax.jit, static_argnames=("max_iters", "solver", "cg_max_iters"))
def _lm_loop_selfcal(prob: BAProblem, cam_free, scale, lambda_init, lambda_up,
                     lambda_down, function_tolerance, max_iters: int,
                     solver: str = "dense", cg_max_iters: int = 100,
                     cg_tol: float = 1e-3):
    def cond(state):
        _, _, _, _, it, done, _, _ = state
        return (it < max_iters) & (~done)

    def body(state):
        poses, points_d, cams, lam, it, done, cost, rel_prev = state
        if solver == "cg":
            # Same inexact-Newton forcing as _lm_loop.
            cg_tol_eff = jnp.where(
                cg_tol < 1e-4,  # strict request (equality tests): honor it
                cg_tol,
                jnp.clip(jnp.sqrt(rel_prev) * 0.3, cg_tol,
                         jnp.float32(3e-2)))
            dc, dp, dk = _lm_step_selfcal_cg(prob, poses, points_d, cams,
                                             cam_free, lam, scale,
                                             cg_max_iters, cg_tol_eff)
        else:
            dc, dp, dk = _lm_step_selfcal(prob, poses, points_d, cams,
                                          cam_free, lam, scale)
        new_poses = poses + dc
        new_points = points_d + dp
        new_cams = cams + dk
        new_cost = _total_cost_selfcal_d(prob, new_poses, new_points,
                                         new_cams, scale)
        accept = new_cost < cost
        poses = jnp.where(accept, new_poses, poses)
        points_d = jnp.where(accept, new_points, points_d)
        cams = jnp.where(accept, new_cams, cams)
        lam = jnp.clip(jnp.where(accept, lam * lambda_down, lam * lambda_up),
                       1e-10, 1e8)
        rel = (cost - new_cost) / jnp.maximum(cost, 1e-20)
        done = accept & (rel < function_tolerance)
        cost = jnp.where(accept, new_cost, cost)
        rel_prev = jnp.where(accept, jnp.maximum(rel, 1e-20), rel_prev)
        return (poses, points_d, cams, lam, it + 1, done, cost, rel_prev)

    points_d0 = _gather_dense_points(prob, prob.points)
    init_cost = _total_cost_selfcal_d(prob, prob.poses, points_d0,
                                      prob.cam_params, scale)
    state = (prob.poses, points_d0, prob.cam_params,
             jnp.float32(lambda_init), 0, False, init_cost,
             jnp.float32(1.0))
    poses, points_d, cams, lam, it, done, cost, _ = jax.lax.while_loop(
        cond, body, state
    )
    points = _scatter_dense_points(prob, prob.points, points_d)
    return poses, points, cams, cost, init_cost, it


@partial(jax.jit, static_argnames=("max_iters", "solver", "cg_max_iters"))
def _lm_loop(prob: BAProblem, scale, lambda_init, lambda_up, lambda_down,
             function_tolerance, max_iters: int, solver: str = "dense",
             cg_max_iters: int = 100, cg_tol: float = 1e-3):
    def cond(state):
        _, _, _, it, done, _, _ = state
        return (it < max_iters) & (~done)

    def body(state):
        poses, points_d, lam, it, done, cost, rel_prev = state
        if solver == "cg":
            # Inexact-Newton forcing (Eisenstat-Walker flavored): while LM
            # is still making large relative cost reductions, a sloppy CG
            # solve steers just as well — the inner loop's linear
            # convergence means tol 3e-2 vs 1e-3 is ~2-3x fewer matvecs,
            # and at global-BA scale the matvec is most of the solve.
            # As rel_prev decays toward
            # function_tolerance the forcing clamps back to cg_tol.
            cg_tol_eff = jnp.where(
                cg_tol < 1e-4,  # strict request (equality tests): honor it
                cg_tol,
                jnp.clip(jnp.sqrt(rel_prev) * 0.3, cg_tol,
                         jnp.float32(3e-2)))
            dc, dp = _lm_step_cg(prob, poses, points_d, lam, scale,
                                 cg_max_iters, cg_tol_eff)
        else:
            dc, dp = _lm_step(prob, poses, points_d, lam, scale)
        new_poses = poses + dc
        new_points = points_d + dp
        new_cost = _total_cost_d(prob, new_poses, new_points, scale)
        accept = new_cost < cost
        poses = jnp.where(accept, new_poses, poses)
        points_d = jnp.where(accept, new_points, points_d)
        lam = jnp.where(accept, lam * lambda_down, lam * lambda_up)
        lam = jnp.clip(lam, 1e-10, 1e8)
        rel_impr = (cost - new_cost) / jnp.maximum(cost, 1e-20)
        done = accept & (rel_impr < function_tolerance)
        cost = jnp.where(accept, new_cost, cost)
        # A rejected step keeps the forcing term where it was; an accepted
        # one tracks the observed progress.
        rel_prev = jnp.where(accept, jnp.maximum(rel_impr, 1e-20), rel_prev)
        return (poses, points_d, lam, it + 1, done, cost, rel_prev)

    points_d0 = _gather_dense_points(prob, prob.points)
    init_cost = _total_cost_d(prob, prob.poses, points_d0, scale)
    state = (prob.poses, points_d0, jnp.float32(lambda_init), 0, False,
             init_cost, jnp.float32(1.0))
    poses, points_d, lam, it, done, cost, _ = jax.lax.while_loop(cond, body,
                                                                 state)
    points = _scatter_dense_points(prob, prob.points, points_d)
    return poses, points, cost, init_cost, it


# Packed-transport LM entries: a BAProblem shipped field-by-field costs one
# host->device transfer PER BUFFER at dispatch (see pack_problem). These
# wrappers take pack_problem's 6 consolidated buffers and rebuild the
# problem inside the program.

_NUM_PARAMS_TABLE = None


def _cam_free_in_jit(cam_models):
    """Per-camera free mask over the 9 padded intrinsics slots, computed
    in-program (replaces the host-side _selfcal_cam_free buffer)."""
    global _NUM_PARAMS_TABLE
    if _NUM_PARAMS_TABLE is None:
        from ..models.camera import CAMERA_MODEL_NUM_PARAMS

        _NUM_PARAMS_TABLE = np.array(
            [CAMERA_MODEL_NUM_PARAMS.get(i, 0) for i in range(16)], np.int32
        )
    n = jnp.asarray(_NUM_PARAMS_TABLE)[jnp.clip(cam_models, 0, 15)]
    return (jnp.arange(9)[None, :] < n[:, None]).astype(jnp.float32)


@partial(jax.jit, static_argnames=(
    "max_iters", "solver", "cg_max_iters", "selfcal"))
def _lm_loop_packed(obs_i, obs_f, img_f, pt_f, ptd_i, cams, *,
                    scale, lambda_init, lambda_up, lambda_down,
                    function_tolerance, max_iters, solver, cg_max_iters,
                    cg_tol, selfcal):
    """Packed-transport LM entry: 6 consolidated buffers in, packed out.

    The float hyper-parameters (scale, lambda_*, function_tolerance,
    cg_tol) are TRACED scalars: a caller sweeping BAOptions floats (or a
    pipeline mixing loss scales) reuses one compiled executable per
    (shape-bucket, max_iters, solver) combination instead of paying an
    XLA compile per float combination. Structural knobs stay static
    (they change the program)."""
    prob = _unpack_problem(obs_i, obs_f, img_f, pt_f, ptd_i, cams)
    args = (jnp.float32(scale), jnp.float32(lambda_init),
            jnp.float32(lambda_up), jnp.float32(lambda_down),
            jnp.float32(function_tolerance))
    kw = dict(max_iters=max_iters, solver=solver,
              cg_max_iters=cg_max_iters, cg_tol=jnp.float32(cg_tol))
    if selfcal:
        return _lm_loop_selfcal(prob, _cam_free_in_jit(prob.cam_models),
                                *args, **kw)
    return _lm_loop(prob, *args, **kw)


def point_mean_errors(prob: BAProblem, poses, points):
    """Per-point mean UNROBUSTIFIED reprojection error in pixels (P,).

    Matches the reference's update_point3D_errors recomputation with the
    loss swapped to trivial (bundle_adjustment.cc:575-598).
    """
    if isinstance(prob.poses, np.ndarray):
        # Host (packed-transport) problem: vmap over numpy index arrays
        # would hand tracers to numpy __getitem__.
        prob = jax.tree.map(jnp.asarray, prob)
    poses = jnp.asarray(poses)
    points = jnp.asarray(points)
    r = _all_residuals(prob, poses, _gather_dense_points(prob, points))
    nrm = jnp.linalg.norm(r, axis=-1)
    nrm = jnp.where(prob.obs_mask, nrm, 0.0)
    P = points.shape[0]
    s = jax.ops.segment_sum(nrm, prob.obs_point, num_segments=P)
    n = jax.ops.segment_sum(
        prob.obs_mask.astype(jnp.float32), prob.obs_point, num_segments=P
    )
    return jnp.where(n > 0, s / jnp.maximum(n, 1.0), -1.0)


def _resolve_solver(prob: BAProblem, options: BAOptions) -> str:
    """Pick the reduced-camera-system solver.

    "auto": the exact dense solve below DENSE_SOLVER_MAX_CAMERAS (the
    (I, I, 6, 6) Schur tensor and its Cholesky stay cheap), matrix-free
    preconditioned CG above it. Both work on any problem — the dense
    Schur off-diagonal comes from per-(point, image) aggregation, no
    pair list exists anymore.
    """
    if options.solver == "auto":
        I = int(prob.poses.shape[0])
        return "dense" if I < DENSE_SOLVER_MAX_CAMERAS else "cg"
    return options.solver


def _selfcal_cam_free(prob: BAProblem):
    """Per-camera free mask over the 9 padded intrinsics slots."""
    from ..models.camera import CAMERA_MODEL_NUM_PARAMS

    cam_free = np.zeros(prob.cam_params.shape, np.float32)
    models = np.asarray(prob.cam_models)
    for c in range(len(models)):
        cam_free[c, : CAMERA_MODEL_NUM_PARAMS[int(models[c])]] = 1.0
    return jnp.asarray(cam_free)


def bundle_adjust_async(prob: BAProblem, options: BAOptions = BAOptions(),
                        num_obs=None):
    """Dispatch the LM loop without blocking; returns a finalize() callable.

    The sequential mapper dispatches each local BA async and applies the
    results lazily just before the next solve, so the blocking pull of
    results overlaps other work (one frame of pose staleness, corrected by
    the next refinement + BA). With
    options.refine_camera_params the self-calibration loop is dispatched
    and info carries "cam_params" (the reference refines intrinsics in
    every BA by default, mapper.cc:878-885).
    """
    common = dict(
        solver=_resolve_solver(prob, options),
        cg_max_iters=options.cg_max_iters,
        cg_tol=options.cg_tol,
    )
    selfcal = options.refine_camera_params
    if isinstance(prob.poses, np.ndarray):
        # Host problem (build_problem(host=True)): packed transport — 6
        # argument buffers instead of 21, float hyper-params static.
        fut = _lm_loop_packed(
            *pack_problem(prob),
            scale=float(options.loss_scale_factor),
            lambda_init=float(options.lambda_init),
            lambda_up=float(options.lambda_up),
            lambda_down=float(options.lambda_down),
            function_tolerance=float(options.function_tolerance),
            max_iters=options.max_num_iterations,
            selfcal=selfcal, **common,
        )
    else:
        lm_args = (
            jnp.float32(options.loss_scale_factor),
            options.lambda_init,
            options.lambda_up,
            options.lambda_down,
            options.function_tolerance,
            options.max_num_iterations,
        )
        if selfcal:
            fut = _lm_loop_selfcal(prob, _selfcal_cam_free(prob), *lm_args,
                                   **common)
        else:
            fut = _lm_loop(prob, *lm_args, **common)

    def finalize(prefetched=None):
        """prefetched: host values of `finalize.fut` if the caller already
        pulled them (batched into another device_get — saves one RTT)."""
        vals = prefetched if prefetched is not None else jax.device_get(fut)
        if selfcal:
            poses, points, cams, cost, init_cost, iters = vals
        else:
            poses, points, cost, init_cost, iters = vals
        info = {
            "initial_cost": init_cost,
            "final_cost": cost,
            "iterations": iters,
            # num_obs hint avoids a device sync that would queue behind the
            # LM loop (int() of a device scalar forces a blocking reduce).
            "num_residuals": 2 * (num_obs if num_obs is not None
                                  else int(prob.obs_mask.sum())),
        }
        if selfcal:
            info["cam_params"] = np.asarray(cams)
        if options.update_point3D_errors:
            info["point_errors"] = point_mean_errors(
                prob._replace(cam_params=jnp.asarray(cams)) if selfcal
                else prob, poses, points)
        return poses, points, info

    finalize.fut = fut
    return finalize


def bundle_adjust(prob: BAProblem, options: BAOptions = BAOptions(),
                  num_obs=None):
    """Run LM to convergence. Returns (poses, points, info dict).

    With options.refine_camera_params the shared per-camera intrinsics are
    refined too (self-calibration) and returned in info["cam_params"].
    """
    if isinstance(prob.poses, np.ndarray):
        # Host problem: packed transport (see bundle_adjust_async).
        return bundle_adjust_async(prob, options, num_obs=num_obs)()
    if options.refine_camera_params:
        poses, points, cams, cost, init_cost, iters = jax.device_get(
            _lm_loop_selfcal(
                prob,
                _selfcal_cam_free(prob),
                jnp.float32(options.loss_scale_factor),
                options.lambda_init,
                options.lambda_up,
                options.lambda_down,
                options.function_tolerance,
                options.max_num_iterations,
                solver=_resolve_solver(prob, options),
                cg_max_iters=options.cg_max_iters,
                cg_tol=options.cg_tol,
            )
        )
        prob = prob._replace(cam_params=jnp.asarray(cams))
    else:
        poses, points, cost, init_cost, iters = jax.device_get(
            _lm_loop(
                prob,
                jnp.float32(options.loss_scale_factor),
                options.lambda_init,
                options.lambda_up,
                options.lambda_down,
                options.function_tolerance,
                options.max_num_iterations,
                solver=_resolve_solver(prob, options),
                cg_max_iters=options.cg_max_iters,
                cg_tol=options.cg_tol,
            )
        )
    info = {
        "initial_cost": init_cost,
        "final_cost": cost,
        "iterations": iters,
        "num_residuals": 2 * (num_obs if num_obs is not None
                              else int(prob.obs_mask.sum())),
    }
    if options.refine_camera_params:
        info["cam_params"] = np.asarray(prob.cam_params)
    if options.update_point3D_errors:
        info["point_errors"] = point_mean_errors(prob, poses, points)
    return poses, points, info


# --------------------------------------------------------- pose refinement


@partial(jax.jit, static_argnames=("max_iters",))
def _pose_refine_loop(pose, points, uv, mask, kparams, model_code, scale, max_iters: int):
    def residual(p):
        def one(pt, uv_o):
            return _obs_residual(p, pt, kparams, model_code, uv_o)

        return jax.vmap(one)(points, uv)

    def cost_of(p):
        r = residual(p)
        s = jnp.sum(r * r, axis=-1)
        c2 = scale * scale
        return 0.5 * jnp.sum(jnp.where(mask, c2 * jnp.log1p(s / c2), 0.0))

    def body(state):
        p, lam, it, done, cost = state
        r = residual(p)
        J = jax.vmap(lambda pt, uv_o: jax.jacfwd(
            lambda pp: _obs_residual(pp, pt, kparams, model_code, uv_o)
        )(p))(points, uv)  # (N, 2, 6)
        w = _cauchy_weight(jnp.sum(r * r, axis=-1), scale)
        w = jnp.where(mask, w, 0.0)
        wJ = w[:, None, None] * J
        H = jnp.einsum("oki,okj->ij", wJ, J) + lam * jnp.eye(6)
        g = jnp.einsum("oki,ok->i", wJ, r)
        dp = -jnp.linalg.solve(H, g)
        new_p = p + dp
        new_cost = cost_of(new_p)
        accept = new_cost < cost
        p = jnp.where(accept, new_p, p)
        lam = jnp.clip(jnp.where(accept, lam * 0.3, lam * 10.0), 1e-10, 1e8)
        rel = (cost - new_cost) / jnp.maximum(cost, 1e-20)
        done = accept & (rel < 1e-6)
        cost = jnp.where(accept, new_cost, cost)
        return (p, lam, it + 1, done, cost)

    def cond(state):
        _, _, it, done, _ = state
        return (it < max_iters) & (~done)

    state = (pose, jnp.float32(1e-3), 0, False, cost_of(pose))
    p, lam, it, done, cost = jax.lax.while_loop(cond, body, state)
    return p, cost


def pose_refinement(
    rvec,
    tvec,
    points3D,
    points2D_px,
    mask,
    cam_params,
    cam_model,
    loss_scale=1.0,
    max_iters=30,
):
    """Single-pose robust refinement, 3-D points and intrinsics constant.

    Counterpart of reference `pose_refinement` (bundle_adjustment.cc:139-225,
    DENSE_QR + Cauchy). Returns (rvec, tvec, final_cost).
    """
    pose = jnp.concatenate([jnp.asarray(rvec, jnp.float32), jnp.asarray(tvec, jnp.float32)])
    p, cost = _pose_refine_loop(
        pose,
        jnp.asarray(points3D, jnp.float32),
        jnp.asarray(points2D_px, jnp.float32),
        jnp.asarray(mask),
        jnp.asarray(cam_params, jnp.float32),
        jnp.asarray(cam_model, jnp.int32),
        jnp.float32(loss_scale),
        max_iters,
    )
    return p[:3], p[3:], cost
