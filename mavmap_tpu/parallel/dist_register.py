"""Mesh-sharded registration/matching fan-outs — the PIPELINE's
distribution path (not just a library facility).

The sequential critical path of SfM cannot be parallelized away, but every
batched fan-out the mapper already runs in one device call is data-parallel
over jobs: back-fill (skipped frame, neighbor) pairs, loop-closure
candidate registration, and loop-candidate match-count pre-gates. With a
`jax.sharding.Mesh` attached to the mapper these fan-outs shard their
leading batch axis across the mesh via `shard_map`; each device runs the
same fused register/match kernel on its slice and results gather back
replicated. The reference has no analog — it pays a full sequential
process() per pair (mapper.cc:221-299, sequential_mapper.cc:1182-1211).

All wrappers are cached per (mesh, static config) so repeat fan-outs reuse
one compiled executable; scalars ride as replicated traced args, never as
baked-in constants.
"""

from functools import lru_cache

import jax
from jax.sharding import PartitionSpec as P


@lru_cache(maxsize=64)
def _pairs_fn(mesh, p3p_trials):
    from ..sfm.kernels import register_view_pairs

    ax = mesh.axis_names[0]

    def fn(keys, kpp, dp, mp, npn, kpc, dc, mc, ncn, xyz, ht, st, rv, tv,
           kparams, codes, ratio, maxd, nts):
        return register_view_pairs(
            keys, kpp, dp, mp, npn, kpc, dc, mc, ncn, xyz, ht, st, rv, tv,
            kparams, codes, ratio, maxd, nts,
            p3p_trials=p3p_trials,
        )

    # check_vma off: the register kernels carry replicated scalars through
    # internal while_loops (RANSAC, LM refinement), which trips the
    # varying-manual-axes typing; every lane computes independently here.
    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(ax),) * 16 + (P(), P(), P(ax)),
        out_specs=(P(ax), P(ax)), check_vma=False,
    ))


def dist_register_view_pairs(mesh, keys, kpp, dp, mp, npn, kpc, dc, mc, ncn,
                             xyz, ht, st, rv, tv, kparams, codes,
                             ratio, maxd, nts, *, p3p_trials):
    """register_view_pairs with the pair axis sharded over `mesh`.

    All leading-B arrays split across devices; `ratio`/`maxd` replicate.
    B must be divisible by the mesh size — callers pad to a multiple.
    """
    return _pairs_fn(mesh, p3p_trials)(
        keys, kpp, dp, mp, npn, kpc, dc, mc, ncn, xyz, ht, st, rv, tv,
        kparams, codes, ratio, maxd, nts)


@lru_cache(maxsize=64)
def _batch_fn(mesh, p3p_trials):
    from ..sfm.kernels import register_view_batch

    ax = mesh.axis_names[0]

    def fn(keys, kpp, dp, mp, npn, kpc, dc, mc, ncn, xyz, ht, st, rv, tv,
           kparams, codes, ratio, maxd, nt):
        return register_view_batch(
            keys, kpp, dp, mp, npn, kpc, dc, mc, ncn, xyz, ht, st, rv, tv,
            kparams, codes, ratio, maxd, nt,
            p3p_trials=p3p_trials,
        )

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(ax),) * 5 + (P(),) * 4 + (P(ax),) * 5 + (P(),) * 5,
        out_specs=(P(ax), P(ax)), check_vma=False,
    ))


def dist_register_view_batch(mesh, keys, kpp, dp, mp, npn, kpc, dc, mc, ncn,
                             xyz, ht, st, rv, tv, kparams, codes,
                             ratio, maxd, nt, *, p3p_trials):
    """register_view_batch (shared current image) with the candidate axis
    sharded over `mesh`; the current image's features replicate."""
    return _batch_fn(mesh, p3p_trials)(
        keys, kpp, dp, mp, npn, kpc, dc, mc, ncn, xyz, ht, st, rv, tv,
        kparams, codes, ratio, maxd, nt)


@lru_cache(maxsize=64)
def _counts_fn(mesh):
    import jax.numpy as jnp

    from ..ops.matching import match_brute_force

    ax = mesh.axis_names[0]

    def fn(dq, mq, dstack, mstack, ratio):
        def one(d2, m2):
            _, ok = match_brute_force(dq, d2, mq, m2, ratio=ratio)
            return jnp.sum(ok)

        return jax.vmap(one)(dstack, mstack)

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(), P(), P(ax), P(ax), P()), out_specs=P(ax),
        check_vma=False,
    ))


def dist_match_counts(mesh, dq, mq, dstack, mstack, ratio):
    """Loop-closure pre-gate match counts with the candidate axis sharded
    over `mesh` (query descriptors replicate)."""
    return _counts_fn(mesh)(dq, mq, dstack, mstack, ratio)
