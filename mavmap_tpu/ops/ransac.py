"""Batched RANSAC harness — all hypotheses solved and scored at once.

Counterpart of reference src/util/estimation.{h,cc}. The
reference runs sequential OpenMP-parallel trials with adaptive early
termination (estimation.cc:24-141); on an accelerator the idiomatic design
is a fixed, generous trial count T where every minimal solve, every
residual, and the best-model selection are one batched computation:

    sample  -> (T, S) indices via per-trial top-S of masked uniforms
    solve   -> vmap over trials, each yielding M candidate models + mask
    score   -> residual matrix (T*M, N) in one shot, threshold, count
    select  -> argmax over (num_inliers, -inlier_residual_sum) lexicographic

Determinism: explicit PRNG key threading replaces the reference's global
seed counter (estimation.cc:12). Failure (`std::domain_error` in the
reference) becomes a `success` flag = num_inliers >= min_inliers.

An estimator is a pair of pure functions:
  solve_fn(sx, sy) -> (models (M, ...), model_mask (M,))
  residual_fn(x, y, model) -> (N,) nonnegative residuals
Both must be jit/vmap-safe with static shapes.
"""

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class RansacResult(NamedTuple):
    model: jnp.ndarray          # best model parameters
    inlier_mask: jnp.ndarray    # (N,) bool
    num_inliers: jnp.ndarray    # scalar int32
    success: jnp.ndarray        # scalar bool
    best_trial: jnp.ndarray     # scalar int32 (flat trial*M + candidate index)
    residuals: jnp.ndarray      # (N,) residuals of the best model


def sample_indices(key, num_trials, sample_size, num_points, valid_mask=None):
    """(T, S) indices sampled without replacement per trial, valid-only.

    Implemented as per-trial top-S over iid uniforms with invalid entries at
    -inf — one (T, N) tensor op instead of T sequential draws.
    """
    u = jax.random.uniform(key, (num_trials, num_points))
    if valid_mask is not None:
        u = jnp.where(valid_mask[None, :], u, -jnp.inf)
    _, idx = jax.lax.top_k(u, sample_size)
    return idx


@partial(
    jax.jit,
    static_argnames=(
        "solve_fn",
        "residual_fn",
        "sample_size",
        "num_trials",
        "min_inliers",
    ),
)
def ransac(
    key,
    x,
    y,
    solve_fn: Callable,
    residual_fn: Callable,
    sample_size: int,
    num_trials: int,
    threshold,
    min_inliers: int = 0,
    valid_mask=None,
):
    """Run batched RANSAC.

    x: (N, dx); y: (N, dy) (or None for one-set estimators — pass x twice);
    threshold: scalar residual threshold (same units as residual_fn);
    valid_mask: optional (N,) bool marking real rows in a fixed-capacity
    buffer. Returns RansacResult.
    """
    N = x.shape[0]
    idx = sample_indices(key, num_trials, sample_size, N, valid_mask)
    sx = x[idx]  # (T, S, dx)
    sy = y[idx]

    models, model_mask = jax.vmap(solve_fn)(sx, sy)  # (T, M, ...), (T, M)
    M = model_mask.shape[1]
    flat_models = jax.tree.map(lambda m: m.reshape((num_trials * M,) + m.shape[2:]), models)
    flat_mask = model_mask.reshape(num_trials * M)

    res = jax.vmap(lambda m: residual_fn(x, y, m))(flat_models)  # (T*M, N)
    res = jnp.nan_to_num(res, nan=jnp.inf, posinf=jnp.inf, neginf=jnp.inf)

    point_valid = (
        jnp.ones((N,), bool) if valid_mask is None else valid_mask
    )
    inlier = (res <= threshold) & point_valid[None, :] & flat_mask[:, None]
    num_in = jnp.sum(inlier, axis=1)
    # Lexicographic (num_inliers desc, inlier residual sum asc) — matches the
    # reference's best-model rule (estimation.cc:120-128).
    res_sum = jnp.sum(jnp.where(inlier, res, 0.0), axis=1)
    norm_sum = res_sum / jnp.maximum(num_in, 1) / jnp.maximum(threshold, 1e-20)
    score = num_in.astype(jnp.float32) - jnp.clip(norm_sum, 0.0, 0.999)
    score = jnp.where(flat_mask, score, -jnp.inf)

    best = jnp.argmax(score)
    best_model = jax.tree.map(lambda m: m[best], flat_models)
    best_inliers = inlier[best]
    best_num = num_in[best]
    ok = flat_mask[best] & (best_num >= jnp.maximum(min_inliers, sample_size))
    return RansacResult(
        model=best_model,
        inlier_mask=best_inliers,
        num_inliers=best_num.astype(jnp.int32),
        success=ok,
        best_trial=best.astype(jnp.int32),
        residuals=res[best],
    )
