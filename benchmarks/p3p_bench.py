"""P3P RANSAC micro-benchmark on the chip vs the CPU baseline row.

Matches BASELINE.md's CPU stand-in exactly: 1024 2D-3D pairs, 20% gross
outliers, 0.5 px noise, 512 trials (cv2.solvePnPRansac at 500 trials
measured 1.0 ms on this container's CPU). Times the SAME entry the
register kernel uses: ops.ransac.ransac with p3p.solve_p3p_best (one
disambiguated model per trial) + p3p_residuals scoring.

Usage: python benchmarks/p3p_bench.py [reps]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
from functools import partial

from mavmap_tpu.ops import p3p
from mavmap_tpu.ops.ransac import ransac
from mavmap_tpu.ops.rotation import rotmat_from_rvec

REPS = int(sys.argv[1]) if len(sys.argv) > 1 else 50
F = 1024
rng = np.random.default_rng(0)
X = rng.normal(size=(F, 3)) * np.array([4, 4, 2]) + np.array([0, 0, 12])
rvec_t = rng.normal(size=3) * 0.05
R = np.asarray(rotmat_from_rvec(jnp.asarray(rvec_t, jnp.float32)))
tvec_t = np.array([0.5, 0.1, 0.2])
Xc = X @ R.T + tvec_t
x = Xc[:, :2] / Xc[:, 2:3] + rng.normal(size=(F, 2)) * (0.5 / 700.0)
x[: F // 5] += 50 / 700.0  # 20% gross outliers (50 px at f=700)


@partial(jax.jit, static_argnames=("trials", "reps"))
def run_many(key, x2d, X3d, trials, reps):
    """`reps` independent full RANSAC solves in ONE dispatched program
    (lax.map over fresh PRNG keys): in production P3P runs FUSED inside
    the register kernel, so per-call dispatch is not part of its cost."""
    keys = jax.random.split(key, reps)

    def one(k):
        r = ransac(k, x2d, X3d, p3p.solve_p3p_best, p3p.p3p_residuals,
                   sample_size=4, num_trials=trials, threshold=4.0 / 700.0)
        return r.num_inliers

    return jax.lax.map(one, keys)


key = jax.random.PRNGKey(0)
x2d = jnp.asarray(x, jnp.float32)
X3d = jnp.asarray(X, jnp.float32)
out = jax.block_until_ready(run_many(key, x2d, X3d, 512, REPS))
t0 = time.perf_counter()
out = jax.block_until_ready(run_many(jax.random.PRNGKey(1), x2d, X3d,
                                     512, REPS))
ms = (time.perf_counter() - t0) / REPS * 1e3
n_inl = int(np.asarray(out).max())
print(f"P3P RANSAC {F} pairs, 512 trials: {ms:.3f} ms/solve "
      f"({n_inl}/{F} inliers) on {jax.devices()[0].device_kind} "
      f"| CPU baseline (cv2, 500 trials): 1.0 ms -> ratio {1.0/ms:.2f}x")
