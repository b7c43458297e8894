"""Sorted-segment sum for the image-keyed BA reductions.

On CUDA devices it is the Pallas/Triton kernel of ops/pallas/segment_sum.py,
which beat XLA's scatter-add on the long per-image runs inside the
Schur-CG solver on the H100 (PERF.md); on every other platform it is XLA's
segment_sum, which is also the plain reference the kernel is tested
against. The choice is made per platform when the program is lowered.
"""

import jax

from .pallas.segment_sum import segment_sum_sorted as _triton_segment_sum


def segment_sum_sorted_xla(vals, ids, num_segments):
    """Plain XLA reference: scatter-add over ids sorted ascending."""
    return jax.ops.segment_sum(vals, ids, num_segments=num_segments,
                               indices_are_sorted=True)


def segment_sum_sorted(vals, ids, num_segments):
    """out[s] = sum of vals[o] over rows with ids[o] == s; `ids` (O,) int32
    sorted ascending in [0, num_segments), `vals` (O, ...) float32."""
    return jax.lax.platform_dependent(
        vals, ids,
        cuda=lambda v, i: _triton_segment_sum(v, i, num_segments),
        default=lambda v, i: segment_sum_sorted_xla(v, i, num_segments))
