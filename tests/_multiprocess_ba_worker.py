"""Worker for the TRUE multi-process jax.distributed BA test.

Launched twice (process_id 0/1) by tests/test_multiprocess.py. Each process
exposes 4 virtual CPU devices (8 global), initializes jax.distributed,
builds the SAME BA problem from a fixed seed, feeds ONLY its local shard
block through `host_local_to_global`, runs `dist_bundle_adjust` over the
global 8-device mesh, and asserts the replicated result matches a locally
computed single-process dense solve. Exit code 0 == pass.

Usage: python tests/_multiprocess_ba_worker.py <coordinator> <pid> <nprocs>
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
)

import numpy as np  # noqa: E402
import jax  # noqa: E402

# The parent drops JAX_PLATFORMS from the environment; pin the CPU backend
# before any backend is instantiated.
jax.config.update("jax_platforms", "cpu")


def main():
    coordinator, pid, nprocs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    # distributed.initialize must run BEFORE anything touches a backend
    # (importing mavmap_tpu modules is fine — touching jax.devices is not).
    from mavmap_tpu.parallel import init_multihost

    p_idx, p_cnt = init_multihost(coordinator_address=coordinator,
                                  num_processes=nprocs, process_id=pid)

    from mavmap_tpu.parallel import (
        dist_bundle_adjust, global_mesh, host_local_to_global,
        partition_problem, process_shard_bounds,
    )
    from mavmap_tpu.ba import (BAOptions, BA_POSE_FIXED, BA_POSE_FIXED_X,
                               build_problem, bundle_adjust)
    from mavmap_tpu.models import camera as cam
    from mavmap_tpu.ops.rotation import rotmat_from_rvec
    import jax.numpy as jnp

    assert p_idx == pid and p_cnt == nprocs, (p_idx, p_cnt)
    assert len(jax.devices()) == 4 * nprocs, len(jax.devices())

    # Identical problem in every process (fixed seed).
    rng = np.random.default_rng(42)
    I, P = 6, 200
    K = np.zeros((1, 9), np.float32)
    K[0, :4] = [700.0, 700.0, 400.0, 300.0]
    X = rng.normal(size=(P, 3)) * np.array([4, 4, 2]) + np.array([0, 0, 12])
    poses = np.stack([
        np.concatenate([rng.normal(size=3) * 0.05,
                        [i * 0.8, 0, 0] + rng.normal(size=3) * 0.05])
        for i in range(I)
    ]).astype(np.float32)
    obs_img, obs_pt, obs_uv = [], [], []
    for i in range(I):
        R = np.asarray(rotmat_from_rvec(jnp.asarray(poses[i, :3])))
        Xc = X @ R.T + poses[i, 3:]
        uv = np.asarray(cam.world2image(jnp.asarray(Xc, jnp.float32),
                                        cam.PINHOLE, jnp.asarray(K[0])))
        obs_img += [i] * P
        obs_pt += list(range(P))
        obs_uv += list(uv)
    obs_uv = np.asarray(obs_uv) + rng.normal(size=(len(obs_img), 2)) * 0.3
    states = [BA_POSE_FIXED, BA_POSE_FIXED_X] + [0] * (I - 2)
    poses0 = poses.copy()
    poses0[2:] += rng.normal(size=poses0[2:].shape) * 0.01
    X0 = (X + rng.normal(size=X.shape) * 0.05).astype(np.float32)
    obs_img = np.array(obs_img)
    obs_pt = np.array(obs_pt)

    n_shards = 4 * nprocs
    stacked, new_index, per_shard = partition_problem(
        poses0, X0, K, np.array([1], np.int32), obs_img, obs_pt,
        np.zeros_like(obs_img), obs_uv, num_shards=n_shards,
        pose_states=states)

    mesh = global_mesh("obs")
    lo, hi = process_shard_bounds(n_shards, mesh)
    assert hi - lo == 4, (lo, hi)
    # Feed ONLY this process's shard block; jax assembles the global array.
    gprob = jax.tree.map(
        lambda leaf: host_local_to_global(mesh, np.asarray(leaf)[lo:hi]),
        stacked)

    p2, x2, cost, init_cost, iters = dist_bundle_adjust(mesh, gprob,
                                                        max_iters=15)
    assert float(cost) < float(init_cost)

    # Local single-process oracle (plain numpy/jax on this process alone).
    prob = build_problem(poses0, X0, K, [1], obs_img, obs_pt,
                         np.zeros_like(obs_img), obs_uv, pose_states=states)
    p1, x1, info = bundle_adjust(prob, BAOptions(max_num_iterations=15))

    dp = np.abs(np.asarray(p2) - np.asarray(p1)).max()
    dx = np.abs(np.asarray(x2)[new_index] - np.asarray(x1)).max()
    assert dp < 1e-4, dp
    assert dx < 1e-3, dx

    # Sharded MATCHING over the same global mesh: each process feeds only
    # its local block of the pair batch; every local result shard must
    # equal the single-process vmapped matcher (the other half of the
    # dryrun's claim — dist BA alone was covered before).
    from mavmap_tpu.ops.matching import match_brute_force
    from mavmap_tpu.parallel import dist_match_pairs

    B, F, D = n_shards * 2, 64, 32
    rngm = np.random.default_rng(7)
    d1 = rngm.normal(size=(B, F, D)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = d1[:, rngm.permutation(F)] + \
        rngm.normal(size=(B, F, D)).astype(np.float32) * 0.02
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    m1 = np.ones((B, F), bool)
    m2 = np.ones((B, F), bool)
    m2[:, -5:] = False

    per_proc = B // nprocs
    blo, bhi = pid * per_proc, (pid + 1) * per_proc
    gd1, gd2, gm1, gm2 = (
        host_local_to_global(mesh, a[blo:bhi]) for a in (d1, d2, m1, m2)
    )
    matches, valid = dist_match_pairs(mesh, gd1, gd2, gm1, gm2)

    ref_m, ref_ok = jax.vmap(
        lambda a, b, ma, mb: match_brute_force(a, b, ma, mb)
    )(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2))
    ref_m, ref_ok = np.asarray(ref_m), np.asarray(ref_ok)
    n_checked = 0
    for shard in matches.addressable_shards:
        b0 = shard.index[0].start or 0
        got = np.asarray(shard.data)
        np.testing.assert_array_equal(got, ref_m[b0:b0 + got.shape[0]])
        n_checked += got.shape[0]
    assert n_checked == per_proc, n_checked
    assert ref_ok.sum() > 0.8 * B * (F - 5)

    print(f"proc {pid}: OK dp={dp:.2e} dx={dx:.2e} iters={int(iters)} "
          f"match_shards={n_checked}",
          flush=True)


if __name__ == "__main__":
    main()
