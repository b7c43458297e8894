"""BA segment reductions against a float64 np.add.at reference.

The sorted-segment sum is XLA's segment_sum on the CPU and the Pallas/Triton
kernel (ops/pallas/segment_sum.py) on CUDA devices. Here both run against
the same references: XLA as compiled for the CPU, the kernel in Pallas
interpret mode. The kernel as compiled for the card is checked by
`test_kernel_on_gpu` (skipped without a GPU) and by chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mavmap_tpu.ops.pallas.segment_sum import BO
from mavmap_tpu.ops.pallas.segment_sum import (
    segment_sum_sorted as kernel_segment_sum,
)
from mavmap_tpu.ops.segment import segment_sum_sorted, segment_sum_sorted_xla


def _ref(vals, ids, S):
    out = np.zeros((S,) + vals.shape[1:])
    np.add.at(out, ids, vals.astype(np.float64))
    return out


def _close(got, ref):
    """f32 sums against float64: relative 1e-5 of the largest |sum|."""
    err = np.abs(np.asarray(got, np.float64) - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


def _case(name, rng):
    """(vals, sorted ids, num_segments) for one reduction shape."""
    if name == "track_lengths":       # point-keyed: tracks of 1..8
        ids = np.repeat(np.arange(2300), rng.integers(1, 9, size=2300))
        S, K = 2320, 12               # 20 trailing empty segments
    elif name == "empty_segments":    # gaps inside the id range
        ids = np.sort(rng.choice(np.arange(0, 400, 3), size=900))
        S, K = 400, 3
    elif name == "many_segments":     # beyond 2048 segments
        ids = np.sort(rng.integers(0, 5003, size=9000))
        S, K = 5003, 6
    elif name == "straddles_blocks":  # one segment across several blocks
        ids = np.concatenate([np.zeros(5 * BO + 7, np.int64),
                              np.repeat(np.arange(1, 50), 7)])
        S, K = 50, 42
    elif name == "image_keyed":       # few segments, long runs
        ids = np.repeat(np.arange(10), rng.integers(200, 900, size=10))
        S, K = 10, 42
    else:
        raise ValueError(name)
    vals = rng.normal(size=(len(ids), K)).astype(np.float32)
    return vals, ids.astype(np.int32), S


CASES = ("track_lengths", "empty_segments", "many_segments",
         "straddles_blocks", "image_keyed")


@pytest.mark.parametrize("impl", ["xla", "kernel_interpret"])
@pytest.mark.parametrize("case", CASES)
def test_segment_sum_matches_add_at(case, impl):
    rng = np.random.default_rng(CASES.index(case))
    vals, ids, S = _case(case, rng)
    if impl == "xla":
        got = segment_sum_sorted_xla(jnp.asarray(vals), jnp.asarray(ids), S)
    else:
        got = kernel_segment_sum(jnp.asarray(vals), jnp.asarray(ids), S,
                                 interpret=True)
    ref = _ref(vals, ids, S)
    assert got.shape == (S, vals.shape[1])
    _close(got, ref)
    empty = np.bincount(ids, minlength=S) == 0
    assert np.all(np.asarray(got)[empty] == 0.0)


def test_kernel_keeps_trailing_dims():
    rng = np.random.default_rng(3)
    ids = np.repeat(np.arange(30), 5).astype(np.int32)
    vals = rng.normal(size=(150, 6, 6)).astype(np.float32)
    got = kernel_segment_sum(jnp.asarray(vals), jnp.asarray(ids), 31,
                             interpret=True)
    assert got.shape == (31, 6, 6)
    _close(got, _ref(vals, ids, 31))


def test_platform_choice_lowers_plain_scatter_off_gpu():
    """Off CUDA the dispatcher lowers XLA's scatter and no kernel call."""
    vals = jnp.ones((64, 3), jnp.float32)
    ids = jnp.repeat(jnp.arange(8, dtype=jnp.int32), 8)
    text = jax.jit(lambda v, i: segment_sum_sorted(v, i, 8)).lower(
        vals, ids).as_text()
    assert "scatter" in text
    assert "triton" not in text.lower()
    np.testing.assert_allclose(
        np.asarray(segment_sum_sorted(vals, ids, 8)), np.full((8, 3), 8.0))


def _ba_problem(I=8, P=600, per=150, seed=0):
    from mavmap_tpu.ba import build_problem
    from mavmap_tpu.utils.synthetic import make_ba_scene

    poses, X, K, oi, op, uv, states = make_ba_scene(I, P, per, seed=seed)
    rng = np.random.default_rng(seed + 1)
    poses[2:] += rng.normal(size=poses[2:].shape).astype(np.float32) * 0.005
    X = X + rng.normal(size=X.shape).astype(np.float32) * 0.05
    return build_problem(poses, X, K, [1], oi, op, np.zeros_like(oi), uv,
                         pose_states=states, with_pairs=False, bucket=True)


@pytest.mark.parametrize("site", ["image", "point", "ids"])
def test_ba_reduction_sites_match_add_at(site):
    """_seg_img / _seg_pt / _seg_ids as the solver calls them (padding rows
    carry zeros, as masked observations do)."""
    from mavmap_tpu.ba.core import _seg_ids, _seg_img, _seg_pt

    prob = _ba_problem()
    rng = np.random.default_rng(7)
    O = prob.obs_mask.shape[0]
    vals = (rng.normal(size=(O, 6)).astype(np.float32)
            * np.asarray(prob.obs_mask)[:, None])
    v = jnp.asarray(vals)
    if site == "image":
        I = prob.poses.shape[0]
        got, ref = _seg_img(prob, v, I), _ref(vals, np.asarray(prob.obs_image), I)
    elif site == "point":
        Pd = prob.point_rows.shape[0]
        got = _seg_pt(prob, v)
        ref = _ref(vals, np.asarray(prob.obs_point_dense), Pd)
    else:
        ids = rng.integers(0, 11, size=O).astype(np.int32)  # unsorted
        got, ref = _seg_ids(jnp.asarray(ids), v, 11), _ref(vals, ids, 11)
    _close(got, ref)


def test_cg_step_with_kernel_matches_xla(monkeypatch):
    """One Schur-CG LM step with the image-keyed reductions routed through
    the kernel (interpret mode), as on the card, equals the XLA step."""
    import mavmap_tpu.ba.core as core
    from mavmap_tpu.ba.core import _gather_dense_points, _lm_step_cg

    prob = jax.tree.map(jnp.asarray, _ba_problem())
    points_d = _gather_dense_points(prob, prob.points)
    lam, scale = jnp.float32(1e-3), jnp.float32(1.0)
    dc_x, dp_x = _lm_step_cg(prob, prob.poses, points_d, lam, scale, 10, 1e-6)
    monkeypatch.setattr(
        core, "segment_sum_sorted",
        lambda v, i, S: kernel_segment_sum(v, i, S, interpret=True))
    dc_k, dp_k = _lm_step_cg(prob, prob.poses, points_d, lam, scale, 10, 1e-6)
    # f32 summation-order noise carried through 10 CG iterations: compare
    # normwise (the updates agree to ~2e-4 and ~4e-4 relative).
    for got, ref in ((dc_k, dc_x), (dp_k, dp_x)):
        got, ref = np.asarray(got), np.asarray(ref)
        assert np.linalg.norm(got - ref) <= 1e-3 * np.linalg.norm(ref)


@pytest.mark.gpu
def test_kernel_on_gpu(gpu_device):
    """The kernel as compiled for the card against XLA and float64."""
    rng = np.random.default_rng(11)
    for case in CASES:
        vals, ids, S = _case(case, rng)
        v = jax.device_put(jnp.asarray(vals), gpu_device)
        i = jax.device_put(jnp.asarray(ids), gpu_device)
        ref = _ref(vals, ids, S)
        _close(kernel_segment_sum(v, i, S), ref)
        _close(segment_sum_sorted_xla(v, i, S), ref)
