"""End-to-end smoke run of the mapper on one NVIDIA GPU.

Runs the main path once, in this one process, through the entry points a
user calls, and checks each result by the repo's own means:

  kernels  the descriptor matcher and the BA segment reductions at full
           width on the card, each against a plain float64 numpy reference;
           the Pallas/Triton image-keyed segment sum beside XLA's, alone
           and inside one Schur-CG LM iteration; memory analysis of the
           register program and the global-BA program.
  survey   run_pipeline on a 200-image, 4-row synthetic nadir survey with
           2048-feature capacity, 512 RANSAC trials, loop detection on a
           voc tree trained here, one closure sweep and a self-calibrating
           global BA; checks the registered share and ATE.
  cli      mavmap_tpu.cli.main on a 30-image cached-feature dataset; checks
           the written model.
  pixels   the on-device detector on 20 rendered 800x600 frames of one
           strip, fed into run_pipeline; checks that every frame registers.

Usage:
    python chip_smoke.py             # one GPU, every phase above
    python chip_smoke.py --mesh4     # four GPUs: the mesh path only
    python chip_smoke.py --rehearse  # every phase at tiny sizes on the CPU

It exits non-zero, without printing a result, when JAX finds no GPU (unless
--rehearse) or when any phase fails. The last line of standard output is
one JSON object naming the device JAX ran on.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

# Loose sanity bound on the survey's ATE at its 30 m altitude (about a
# tenth of the 0.3 px feature noise projected to the ground, times a margin
# for drift along 200 frames); a mapping fault gives metres, not centimetres.
SURVEY_MAX_ATE_M = 0.05
SURVEY_MIN_REGISTERED = 0.95


@dataclass
class Sizes:
    match_n: tuple = (1024, 2048)
    match_batch: int = 8
    ba_images: int = 1000
    ba_points: int = 250_000
    ba_obs_per_image: int = 1000
    survey_images: int = 200
    survey_rows: int = 4
    survey_points: int = 24_000
    capacity: int = 2048
    min_mean_features: int = 1500
    trials: int = 512
    cli_images: int = 30
    cli_points: int = 6000
    pixel_frames: int = 20
    pixel_points: int = 1000
    mesh_ba_images: int = 128
    mesh_ba_points: int = 20_000
    mesh_ba_obs_per_image: int = 500


REHEARSAL = Sizes(match_n=(200, 256), match_batch=2, ba_images=12,
                  ba_points=3000, ba_obs_per_image=300, survey_images=24,
                  survey_rows=2, survey_points=2400, capacity=512,
                  min_mean_features=300, trials=128, cli_images=8,
                  cli_points=1500, pixel_frames=5, pixel_points=500,
                  mesh_ba_images=12, mesh_ba_points=2000,
                  mesh_ba_obs_per_image=200)


def log(msg):
    print(msg, flush=True)


def card_name_and_power():
    """nvidia-smi's name and power limit, read by a child that does not
    import JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


class CompileClock:
    """Sums JAX's lowering and XLA-compile durations, so each phase's
    first-compile time is reported apart from its wall time (tracing is
    left out: nested jits report it more than once)."""

    EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


def run_phase(name, fn, clock, timings):
    log(f"== phase {name}")
    c0, t0 = clock.total, time.perf_counter()
    fn()
    wall = time.perf_counter() - t0
    comp = clock.total - c0
    timings[name] = (wall, comp)
    log(f"== phase {name}: wall {wall:.2f} s, of which compile "
        f"{comp:.2f} s")


def time_device(fn, *args, reps=10):
    """Median wall ms of fn(*args) to block_until_ready, after a warm-up."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


# ------------------------------------------------------------------ kernels


def np_match(d1, d2, m1, m2, kp1=None, kp2=None, max_distance=None,
             ratio=0.9):
    """Plain float64 2-NN + Lowe ratio + cross-check with the optional
    pixel-distance prefilter (reference feature.cc:23-133 semantics)."""
    d1 = d1.astype(np.float64)
    d2 = d2.astype(np.float64)
    D = np.maximum((d1 * d1).sum(1)[:, None] + (d2 * d2).sum(1)[None, :]
                   - 2.0 * d1 @ d2.T, 0.0)
    D[~np.asarray(m1, bool)] = np.inf
    D[:, ~np.asarray(m2, bool)] = np.inf
    if max_distance is not None:
        sep = ((np.asarray(kp1, np.float64)[:, None, :]
                - np.asarray(kp2, np.float64)[None, :, :]) ** 2).sum(-1)
        D[sep > max_distance ** 2] = np.inf
    rows, cols = np.arange(len(d1)), np.arange(len(d2))
    jb = D.argmin(1)
    db = D[rows, jb]
    D2 = D.copy()
    D2[rows, jb] = np.inf
    ib = D.argmin(0)
    cb = D[ib, cols]
    D3 = D.copy()
    D3[ib, cols] = np.inf
    r2 = ratio * ratio
    ok = (db < r2 * D2.min(1)) & np.isfinite(db)
    ok &= (ib[jb] == rows) & (cb < r2 * D3.min(0))[jb]
    return np.where(ok, jb, -1), ok


def descriptor_pair(rng, n, d=128, noise=0.05):
    d1 = rng.normal(size=(n, d)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = d1[rng.permutation(n)] + rng.normal(size=(n, d)).astype(
        np.float32) * noise
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return d1, d2, rng.random(n) > 0.05, rng.random(n) > 0.05


def check_matcher(sz):
    import jax
    import jax.numpy as jnp

    from mavmap_tpu.ops.matching import match_brute_force

    rng = np.random.default_rng(5)
    for n in sz.match_n:
        pair = descriptor_pair(rng, n)
        ref_m, ref_ok = np_match(*pair)
        args = [jnp.asarray(a) for a in pair]
        mt, ok = (np.asarray(x) for x in match_brute_force(*args))
        if not ((mt == ref_m).all() and (ok == ref_ok).all()):
            raise AssertionError(f"matcher N={n} differs from the float64 "
                                 f"reference in {(mt != ref_m).sum()} rows")
        ms = time_device(match_brute_force, *args)
        log(f"matcher N1=N2={n} D=128: {int(ok.sum())} matches, identical "
            f"match set and validity to the float64 reference (exact, f32 "
            f"at 'highest'); XLA {ms:.4f} ms")
    B, n = sz.match_batch, sz.match_n[-1]
    pairs = [descriptor_pair(rng, n) for _ in range(B)]
    args = [jnp.asarray(np.stack([p[k] for p in pairs])) for k in range(4)]
    vm = jax.jit(jax.vmap(match_brute_force))
    mt, ok = (np.asarray(x) for x in vm(*args))
    for b, p in enumerate(pairs):
        ref_m, ref_ok = np_match(*p)
        if not ((mt[b] == ref_m).all() and (ok[b] == ref_ok).all()):
            raise AssertionError(f"vmapped matcher pair {b} differs")
    log(f"matcher vmapped B={B} N={n}: identical to the float64 reference; "
        f"XLA {time_device(vm, *args):.4f} ms")


def check_segment_sums(sz):
    """The BA normal-equation reductions, as the solver calls them, on a
    global-BA problem of sz.ba_images cameras, against np.add.at in
    float64. Tolerance: relative 1e-5 of the largest |sum| (f32 sums of
    ~1e3 terms at 'highest' precision, no TF32). The image-keyed sums run
    the Pallas/Triton kernel on the card; each is also checked against,
    and timed beside, XLA's plain segment_sum."""
    import jax
    import jax.numpy as jnp

    import mavmap_tpu.ba.core as core
    from mavmap_tpu.ba import build_problem
    from mavmap_tpu.ops.segment import segment_sum_sorted_xla
    from mavmap_tpu.utils.synthetic import make_ba_scene

    t0 = time.perf_counter()
    poses, X, K, oi, op, uv, states = make_ba_scene(
        sz.ba_images, sz.ba_points, sz.ba_obs_per_image, seed=0)
    rng = np.random.default_rng(1)
    poses[2:] += rng.normal(size=poses[2:].shape).astype(np.float32) * 0.005
    X = X + rng.normal(size=X.shape).astype(np.float32) * 0.05
    prob = jax.device_put(build_problem(
        poses, X, K, [1], oi, op, np.zeros_like(oi), uv, pose_states=states,
        with_pairs=False, bucket=True))
    O = int(prob.obs_mask.shape[0])
    I = int(prob.poses.shape[0])
    Pd = int(prob.point_rows.shape[0])
    log(f"global-BA problem: {sz.ba_images} cameras, {len(oi)} observations "
        f"({O} slots), {Pd} points; built in {time.perf_counter() - t0:.1f} s")

    def img_xla(v):
        return segment_sum_sorted_xla(v[prob.img_order],
                                      prob.obs_image_sorted, I)

    cases = (
        ("point", 3, lambda v: core._seg_pt(prob, v), None,
         prob.obs_point_dense, Pd),
        ("point", 12, lambda v: core._seg_pt(prob, v), None,
         prob.obs_point_dense, Pd),
        ("image", 6, lambda v: core._seg_img(prob, v, I), img_xla,
         prob.obs_image, I),
        ("image", 42, lambda v: core._seg_img(prob, v, I), img_xla,
         prob.obs_image, I),
    )
    valid = np.asarray(prob.obs_mask)
    for kind, width, fn, xla_fn, ids, S in cases:
        # Padding slots carry zeros, as the solver's masked rows do.
        v = rng.normal(size=(O, width)).astype(np.float32) * valid[:, None]
        ref = np.zeros((S, width))
        np.add.at(ref, np.asarray(ids), v.astype(np.float64))
        vj = jnp.asarray(v)
        impls = [("solver", jax.jit(fn))]
        if xla_fn is not None:
            impls.append(("XLA reference", jax.jit(xla_fn)))
        for name, f in impls:
            got = np.asarray(f(vj), np.float64)
            err = np.abs(got - ref).max() / np.abs(ref).max()
            if not err <= 1e-5:
                raise AssertionError(f"{kind} segment sum K={width} ({name}):"
                                     f" relative error {err:.2e} > 1e-5")
            log(f"segment sum by {kind}, O={O} K={width} S={S}, {name}: "
                f"relative error {err:.2e} <= 1e-5 vs float64; "
                f"{time_device(f, vj):.4f} ms")

    # One Schur-CG LM iteration as the solver runs it, then with the
    # image-keyed sums on XLA's segment_sum for comparison.
    def lm_program():
        return jax.jit(lambda p: core._lm_loop.__wrapped__(
            p, jnp.float32(1.0), 1e-4, 10.0, 0.5, 0.0, max_iters=1,
            solver="cg", cg_max_iters=30, cg_tol=1e-6))

    compiled = lm_program().lower(prob).compile()
    log(f"global-BA program (1 LM iteration, 30 CG iterations) memory: "
        f"{compiled.memory_analysis()}")
    ms = time_device(compiled, prob, reps=5)
    cost = float(np.asarray(compiled(prob)[2]))
    solver_seg = core.segment_sum_sorted
    core.segment_sum_sorted = segment_sum_sorted_xla
    try:
        compiled_x = lm_program().lower(prob).compile()
    finally:
        core.segment_sum_sorted = solver_seg
    ms_x = time_device(compiled_x, prob, reps=5)
    cost_x = float(np.asarray(compiled_x(prob)[2]))
    rel = abs(cost - cost_x) / abs(cost_x)
    log(f"global BA: one Schur-CG LM iteration with 30 CG iterations "
        f"{ms:.3f} ms as run (cost {cost:.6e}); with XLA image sums "
        f"{ms_x:.3f} ms (cost {cost_x:.6e}); relative cost difference "
        f"{rel:.2e}")
    if not (np.isfinite(cost) and rel <= 1e-3):
        raise AssertionError("global BA cost disagrees with the XLA run")


def register_program_memory(sz):
    import jax
    import jax.numpy as jnp

    from mavmap_tpu.sfm.kernels import register_view

    F = sz.capacity
    f32 = jax.ShapeDtypeStruct
    args = (jax.random.PRNGKey(0),
            f32((F, 2), jnp.float32), f32((F, 128), jnp.float32),
            f32((F,), bool), f32((F, 2), jnp.float32),
            f32((F, 2), jnp.float32), f32((F, 128), jnp.float32),
            f32((F,), bool), f32((F, 2), jnp.float32),
            f32((F, 3), jnp.float32), f32((F,), bool), f32((F,), bool),
            f32((3,), jnp.float32), f32((3,), jnp.float32),
            f32((9,), jnp.float32), f32((), jnp.int32),
            f32((), jnp.float32), f32((), jnp.float32), f32((), jnp.float32))
    compiled = register_view.lower(
        *args, p3p_trials=sz.trials, hom_trials=128).compile()
    log(f"register program (F={F}, {sz.trials} P3P trials) memory: "
        f"{compiled.memory_analysis()}")


def phase_kernels(sz):
    check_matcher(sz)
    check_segment_sums(sz)
    register_program_memory(sz)


# ------------------------------------------------------------------ survey


def survey_scene(sz, seed=13):
    from mavmap_tpu.features import ArrayFeatureProvider
    from mavmap_tpu.loop import train_voc_tree
    from mavmap_tpu.utils.synthetic import make_uav_scene, render_features

    scene = make_uav_scene(num_images=sz.survey_images,
                           num_points=sz.survey_points, relief=10.0,
                           rows=sz.survey_rows, extent=None, seed=seed)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=64, seed=seed)
    feats = [(k[:sz.capacity], d[:sz.capacity]) for k, d in feats]
    mean_feats = float(np.mean([len(k) for k, _ in feats]))
    log(f"survey: {sz.survey_images} images in {sz.survey_rows} rows, "
        f"mean {mean_feats:.1f} features per frame (capacity "
        f"{sz.capacity})")
    if mean_feats < sz.min_mean_features:
        raise AssertionError(f"mean features {mean_feats:.1f} < "
                             f"{sz.min_mean_features}")
    desc = np.concatenate([d for _, d in feats[::5]])
    rng = np.random.default_rng(0)
    tree = train_voc_tree(desc[rng.permutation(len(desc))[:8000]],
                          branching=8, depth=2, iters=3)
    return scene, ArrayFeatureProvider(feats, capacity=sz.capacity), tree


def survey_options(sz, mesh_devices=1):
    from mavmap_tpu.sfm.pipeline import PipelineOptions

    return PipelineOptions(
        verbose=False, tri_min_angle=1.0, init_tri_min_angle=4.0,
        min_track_len=2, loop_detection_period=20, final_closure_sweeps=1,
        essential_ransac_trials=sz.trials, p3p_ransac_trials=sz.trials,
        refine_camera_params=True, mesh_devices=mesh_devices)


def phase_survey(sz):
    from mavmap_tpu.sfm.pipeline import run_pipeline
    from mavmap_tpu.utils.synthetic import mapper_ate

    scene, prov, tree = survey_scene(sz)
    res = run_pipeline(scene.image_cameras, scene.cam_models,
                       scene.cam_params, prov, survey_options(sz),
                       voc_tree=tree)
    m = res.main_mapper
    ate = mapper_ate(m, scene)
    share = m.num_proc_images / sz.survey_images
    log(f"survey: registered {m.num_proc_images}/{sz.survey_images} in "
        f"{len(res.mappers)} map(s), ATE {ate:.4f} m; stages "
        + " | ".join(f"{k} {v:.2f}s" for k, v in (res.timings or {}).items()))
    if share < SURVEY_MIN_REGISTERED or not ate <= SURVEY_MAX_ATE_M:
        raise AssertionError(f"survey: registered share {share:.3f} "
                             f"(need >= {SURVEY_MIN_REGISTERED}), ATE "
                             f"{ate:.4f} m (need <= {SURVEY_MAX_ATE_M})")


# --------------------------------------------------------------------- cli


def write_cached_dataset(root, feats, capacity):
    """imagedata.txt plus a feature cache written through FeatureCache, with
    the CLI's default detector fingerprint, so no image is decoded."""
    from mavmap_tpu.features import FeatureCache

    data = os.path.join(root, "data")
    cache = os.path.join(root, "cache")
    os.makedirs(data)
    os.makedirs(cache)
    lines = ["# imagedata"]
    for i in range(len(feats)):
        cam_def = ", 1, PINHOLE, 700.0, 700.0, 400.0, 300.0" if i == 0 else ""
        lines.append(f"img{i}, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0{cam_def}")
    with open(os.path.join(data, "imagedata.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    params = {"hessian_threshold": 1000.0, "num_octaves": 4,
              "num_octave_layers": 3, "upright": False,
              "grid_size": (3, 3), "max_features": capacity}
    fc = FeatureCache(cache, params, detector=lambda i: feats[i],
                      capacity=capacity)
    for i in range(len(feats)):
        fc.query(i, f"img{i}")
    return data, cache


def phase_cli(sz):
    from mavmap_tpu.cli import main as cli_main
    from mavmap_tpu.utils.synthetic import make_uav_scene, render_features

    n = sz.cli_images
    scene = make_uav_scene(num_images=n, num_points=sz.cli_points,
                           relief=10.0, rows=2, extent=None, seed=11)
    feats, _ = render_features(scene, pixel_noise=0.3, clutter=64, seed=11)
    feats = [(k[:sz.capacity], d[:sz.capacity]) for k, d in feats]
    with tempfile.TemporaryDirectory() as root:
        data, cache = write_cached_dataset(root, feats, sz.capacity)
        out = os.path.join(root, "out")
        rc = cli_main([
            "--input-path", data, "--output-path", out, "--cache-path",
            cache, "--max-features", str(sz.capacity), "--min-track-len",
            "2", "--tri-min-angle", "1.0", "--init-tri-min-angle", "4.0",
            "--quiet"])
        if rc != 0:
            raise AssertionError(f"cli returned {rc}")
        with open(os.path.join(out, "imagedataout.txt")) as f:
            rows = [l for l in f.read().splitlines() if not l.startswith("#")]
        with open(os.path.join(out, "points3D.txt")) as f:
            n_pts = sum(1 for l in f if l.strip() and not l.startswith("#"))
    log(f"cli: {len(rows)}/{n} poses written, {n_pts} points in points3D.txt")
    if len(rows) != n or n_pts == 0:
        raise AssertionError(f"cli: {len(rows)}/{n} poses, {n_pts} points")


# ------------------------------------------------------------------ pixels


def phase_pixels(sz):
    from mavmap_tpu.features import ArrayFeatureProvider
    from mavmap_tpu.features.detector import detect_image
    from mavmap_tpu.sfm.pipeline import PipelineOptions, run_pipeline
    from mavmap_tpu.utils.synthetic import (make_uav_scene, mapper_ate,
                                            render_images)

    n = sz.pixel_frames
    scene = make_uav_scene(num_images=n, num_points=sz.pixel_points,
                           relief=10.0, rows=1, extent=None, seed=21)
    imgs = render_images(scene, texture_contrast=0.25, seed=21)
    t0 = time.perf_counter()
    feats = [detect_image(im, hessian_threshold=1000.0,
                          max_features=sz.capacity) for im in imgs]
    det_s = time.perf_counter() - t0
    log(f"pixels: detected {np.mean([len(k) for k, _ in feats]):.1f} "
        f"features per {imgs[0].shape[1]}x{imgs[0].shape[0]} frame "
        f"({det_s:.2f} s for {n} frames, first compile included)")
    opts = PipelineOptions(verbose=False, tri_min_angle=1.0,
                           init_tri_min_angle=2.0, min_track_len=2,
                           ransac_min_inlier_threshold=15,
                           loop_detection=False,
                           essential_ransac_trials=sz.trials,
                           p3p_ransac_trials=sz.trials)
    res = run_pipeline(scene.image_cameras, scene.cam_models,
                       scene.cam_params,
                       ArrayFeatureProvider(feats, capacity=sz.capacity),
                       opts)
    m = res.main_mapper
    log(f"pixels: registered {m.num_proc_images}/{n}, ATE "
        f"{mapper_ate(m, scene):.4f} m")
    if m.num_proc_images != n:
        raise AssertionError(f"pixels: {m.num_proc_images}/{n} registered")


# -------------------------------------------------------------------- mesh


def phase_mesh(sz, n_dev=4):
    """run_pipeline with mesh_devices=n_dev against mesh_devices=1 on the
    survey scene, and dist_bundle_adjust against bundle_adjust."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from mavmap_tpu.ba import BAOptions, build_problem, bundle_adjust
    from mavmap_tpu.parallel import dist_bundle_adjust, partition_problem
    from mavmap_tpu.sfm.pipeline import run_pipeline
    from mavmap_tpu.utils.synthetic import make_ba_scene, mapper_ate

    devs = jax.devices()
    if len(devs) < n_dev:
        raise AssertionError(f"--mesh4 needs {n_dev} devices, JAX has "
                             f"{len(devs)}")

    # Distributed BA against the single-device solve.
    poses, X, K, oi, op, uv, states = make_ba_scene(
        sz.mesh_ba_images, sz.mesh_ba_points, sz.mesh_ba_obs_per_image,
        seed=3)
    rng = np.random.default_rng(4)
    poses[2:] += rng.normal(size=poses[2:].shape).astype(np.float32) * 0.005
    X = X + rng.normal(size=X.shape).astype(np.float32) * 0.05
    # Bucketed shapes, as the pipeline's global BA builds them (shards then
    # share their padded dense-point counts).
    kw = dict(pose_states=states, with_pairs=False, bucket=True)
    prob = build_problem(poses, X, K, [1], oi, op, np.zeros_like(oi), uv, **kw)
    _, _, info = bundle_adjust(prob, BAOptions(
        max_num_iterations=20, solver="cg", cg_tol=1e-6))
    mesh = Mesh(np.array(devs[:n_dev]), ("obs",))
    stacked, _, per_shard = partition_problem(
        poses, X, K, np.array([1], np.int32), oi, op, np.zeros_like(oi), uv,
        num_shards=n_dev, **kw)
    placed = jax.device_put(stacked.obs_uv,
                            NamedSharding(mesh, PartitionSpec("obs")))
    homes = {s.device for s in placed.addressable_shards}
    if len(homes) != n_dev:
        raise AssertionError(f"observation shards land on {len(homes)} "
                             f"devices, not {n_dev}")
    _, _, cost, init_cost, iters = dist_bundle_adjust(
        mesh, stacked, max_iters=20, solver="cg", cg_tol=1e-6,
        per_shard=per_shard)
    c1, c4 = float(info["final_cost"]), float(cost)
    rel = abs(c4 - c1) / max(abs(c1), 1e-30)
    log(f"mesh BA: {sz.mesh_ba_images} cameras, {len(oi)} observations; "
        f"single-device cost {float(info['initial_cost']):.4e} -> {c1:.6e}, "
        f"{n_dev}-device {float(init_cost):.4e} -> {c4:.6e} "
        f"({int(iters)} iterations), relative difference {rel:.2e}")
    if not rel <= 1e-3:
        raise AssertionError(f"mesh BA final cost differs by {rel:.2e}")

    # The survey through run_pipeline, with and without the mesh.
    scene, prov, tree = survey_scene(sz)
    models = {}
    for nd in (1, n_dev):
        t0 = time.perf_counter()
        res = run_pipeline(scene.image_cameras, scene.cam_models,
                           scene.cam_params, prov, survey_options(sz, nd),
                           voc_tree=tree)
        m = res.main_mapper
        models[nd] = m
        log(f"mesh survey mesh_devices={nd}: registered "
            f"{m.num_proc_images}/{sz.survey_images}, ATE "
            f"{mapper_ate(m, scene):.4f} m, {time.perf_counter() - t0:.2f} s")
    m1, m4 = models[1], models[n_dev]
    if m4.mesh is None or m4.mesh.devices.size != n_dev:
        raise AssertionError("mesh run did not build a mesh")
    common = sorted(set(m1.image_idx_to_id) & set(m4.image_idx_to_id))
    c1 = np.stack([camera_center(m1, i) for i in common])
    c4 = np.stack([camera_center(m4, i) for i in common])
    span = np.linalg.norm(c1.max(0) - c1.min(0))
    diff = np.abs(c1 - c4).max()
    log(f"mesh survey: {len(common)} common frames, max center difference "
        f"{diff:.4f} m of span {span:.1f} m (bound 1% of span)")
    if len(common) < SURVEY_MIN_REGISTERED * sz.survey_images \
            or not diff < 0.01 * span:
        raise AssertionError("mesh survey differs from the single-device run")
    stats = [d.memory_stats() for d in devs[:n_dev]]
    if all(stats):  # the CPU backend keeps no memory statistics
        peaks = [st.get("peak_bytes_in_use", 0) for st in stats]
        log("mesh peak bytes in use per device: "
            + ", ".join(map(str, peaks)))
        if min(peaks) <= 0:
            raise AssertionError("a mesh device held no buffers")


def camera_center(mapper, image_idx):
    import jax.numpy as jnp

    from mavmap_tpu.ops.rotation import rotmat_from_rvec

    iid = mapper.image_idx_to_id[image_idx]
    R = np.asarray(rotmat_from_rvec(
        jnp.asarray(mapper.store.image_rvecs[iid], jnp.float32)))
    return -R.T @ mapper.store.image_tvecs[iid]


# -------------------------------------------------------------------- main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the four-device mesh path and its "
                         "single-device comparison")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU (never claims a GPU)")
    args = ap.parse_args(argv)
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=4")

    import jax

    import mavmap_tpu  # noqa: F401  (precision + compile cache settings)

    dev = jax.devices()[0]
    if not args.rehearse and dev.platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (platform {dev.platform!r}); "
                 f"refusing to run on the CPU without --rehearse")
    sz = REHEARSAL if args.rehearse else Sizes()

    from mavmap_tpu.fm.native_map_store import create_map_store

    log(f"card: {card_name_and_power()}")
    log(f"device_kind: {dev.device_kind}; jax {jax.__version__}; "
        f"{len(jax.devices())} device(s)")
    log(f"map store backend: {type(create_map_store()).__name__}")

    clock = CompileClock()
    timings = {}
    if args.mesh4:
        run_phase("mesh4", lambda: phase_mesh(sz), clock, timings)
        count = 4
    else:
        for name, fn in (("kernels", phase_kernels), ("survey", phase_survey),
                         ("cli", phase_cli), ("pixels", phase_pixels)):
            run_phase(name, lambda fn=fn: fn(sz), clock, timings)
        count = len(jax.devices())
    for name, (wall, comp) in timings.items():
        log(f"timing {name}: wall {wall:.2f} s, compile {comp:.2f} s")
    stats = dev.memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'n/a')}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))


if __name__ == "__main__":
    main()
