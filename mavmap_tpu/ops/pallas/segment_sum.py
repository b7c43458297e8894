"""Sorted-segment sum as a Pallas kernel through Triton (CUDA devices).

out[s] = sum of vals[o] over the rows o with ids[o] == s, for ids sorted
ascending. Each block reduces BO consecutive rows inside the block: an
exact 0/1 same-segment mask times the rows (a true-f32 `pl.dot`) gives
every row its segment's in-block sum, and only the LAST row of each
segment in the block adds that sum to the output with an atomic. A
segment that straddles two blocks is completed by the second atomic; no
other address is touched twice, so atomics stay one per (segment, block)
instead of one per row as in a scatter-add. ops/segment.py picks it on
CUDA devices; tests run it in interpret mode.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BO = 64


def _kernel(ids_ref, nxt_ref, vals_ref, out_in_ref, out_ref, *, K, S,
            interpret):
    del out_in_ref  # aliased with out_ref
    ids = ids_ref[...]                                   # (BO,)
    nxt = nxt_ref[...]
    vals = vals_ref[...]                                 # (BO, Kp)
    same = (ids[:, None] == ids[None, :]).astype(jnp.float32)
    sums = pl.dot(same, vals, precision=jax.lax.Precision.HIGHEST)
    # A row ends its segment's run in this block if the next row starts
    # another segment or lies in the next block.
    last = (ids != nxt) | (jax.lax.broadcasted_iota(jnp.int32, (BO,), 0)
                           == BO - 1)
    Kp = vals.shape[1]
    cols = jax.lax.broadcasted_iota(jnp.int32, (BO, Kp), 1)
    rows = jnp.where(last, ids, S)                       # S = spill row
    mask = last[:, None] & (cols < K)
    # The interpreter implements no masked atomics; it sends the masked-off
    # rows to the spill row instead (distinct real ids per block keep the
    # interpreted scatter exact).
    plgpu.atomic_add(out_ref, (rows[:, None], cols), sums,
                     mask=None if interpret else mask)


@partial(jax.jit, static_argnames=("num_segments", "interpret"))
def segment_sum_sorted(vals, ids, num_segments, interpret=False):
    """vals (O, K) f32, ids (O,) int32 sorted ascending in
    [0, num_segments) -> (num_segments, K). Trailing dims of `vals` are
    flattened into K and restored."""
    shape = vals.shape
    O = shape[0]
    vals = vals.reshape(O, -1).astype(jnp.float32)
    K = vals.shape[1]
    Kp = max(pl.next_power_of_2(K), 16)
    Op = max(-(-O // BO) * BO, BO)
    S = num_segments
    ids = ids.astype(jnp.int32)
    # Pad rows carry the spill id S with zero values; `nxt` is each row's
    # successor id (the spill id past the end), which marks segment ends.
    ids_p = jnp.pad(ids, (0, Op - O), constant_values=S)
    nxt = jnp.concatenate([ids_p[1:], jnp.full((1,), S + 1, jnp.int32)])
    vals_p = jnp.pad(vals, ((0, Op - O), (0, Kp - K)))
    out0 = jnp.zeros((S + 1, Kp), jnp.float32)
    out = pl.pallas_call(
        partial(_kernel, K=K, S=S, interpret=interpret),
        grid=(Op // BO,),
        in_specs=[pl.BlockSpec((BO,), lambda b: (b,)),
                  pl.BlockSpec((BO,), lambda b: (b,)),
                  pl.BlockSpec((BO, Kp), lambda b: (b, 0)),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct((S + 1, Kp), jnp.float32),
        input_output_aliases={3: 0},
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        name="segment_sum_sorted",
        interpret=interpret,
    )(ids_p, nxt, vals_p, out0)
    return out[:S, :K].reshape((S,) + shape[1:])
