"""Global-BA per-LM-iteration timing, dense Schur vs matrix-free CG."""
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from mavmap_tpu.ba import build_problem
from mavmap_tpu.ba.core import _lm_loop
from mavmap_tpu.utils.synthetic import make_ba_scene


def bench(prob, solver, iters=10, reps=3, cg_iters=100):
    args = (jnp.float32(1.0), 1e-4, 10.0, 0.5, 0.0)
    prob = jax.device_put(prob)
    r = _lm_loop(prob, *args, max_iters=iters, solver=solver, cg_max_iters=cg_iters)
    jax.block_until_ready(r)
    t0 = time.time()
    for _ in range(reps):
        r = _lm_loop(prob, *args, max_iters=iters, solver=solver, cg_max_iters=cg_iters)
    jax.block_until_ready(r)
    ms = (time.time() - t0) / reps / iters * 1000
    return ms, float(r[2]), float(r[3])


if __name__ == "__main__":
    I, P, OPI = 200, 50000, 1000
    poses, X, K, oi, op, uv, states = make_ba_scene(I, P, OPI)
    poses0 = poses.copy()
    poses0[2:] += np.random.default_rng(1).normal(size=poses0[2:].shape) * 0.005
    X0 = X + np.random.default_rng(2).normal(size=X.shape).astype(np.float32) * 0.05

    t0 = time.time()
    prob_pairs = build_problem(poses0, X0, K, [1], oi, op, np.zeros_like(oi),
                               uv, pose_states=states)
    t_pairs = time.time() - t0
    t0 = time.time()
    prob_nopairs = build_problem(poses0, X0, K, [1], oi, op,
                                 np.zeros_like(oi), uv, pose_states=states,
                                 with_pairs=False)
    t_nopairs = time.time() - t0
    print(f"build: pairs {t_pairs:.2f}s (Q={prob_pairs.pair_a.shape[0]}), "
          f"no-pairs {t_nopairs:.2f}s", file=sys.stderr)

    for solver, prob, cgi in [("dense", prob_pairs, 0),
                              ("cg", prob_nopairs, 100),
                              ("cg", prob_nopairs, 30)]:
        try:
            ms, fc, ic = bench(prob, solver, cg_iters=max(cgi, 1))
            print(f"{solver}(cg_iters={cgi}): {ms:.1f} ms/LM-iter  "
                  f"cost {ic:.1f} -> {fc:.1f}")
        except Exception as e:
            print(f"{solver}: FAILED {type(e).__name__}: {e}")
