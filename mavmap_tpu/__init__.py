"""mavmap_tpu — a sequential structure-from-motion framework in JAX.

A ground-up JAX/XLA redesign (NOT a port) with the capabilities of the
mavmap reference system: feature detection + matching, PINHOLE/OPENCV/CATA
camera models, batched essential-matrix (5-point) and P3P RANSAC, DLT
triangulation, incremental sequential mapping with sub-map restart/merge,
vocabulary-tree loop detection, and robust Levenberg-Marquardt bundle
adjustment via Schur-complement reduction — extended with IMU rotation
priors and ground-control-point geo-registration, and scaled over device
meshes with jax.sharding collectives.

Design stance (see SURVEY.md §7): struct-of-arrays + fixed capacities +
masks; every estimator batched (vmap over RANSAC hypotheses); matching and
BA assembly as matmuls and segment reductions; explicit PRNG keys.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Where the persistent compilation cache lives when JAX_COMPILATION_CACHE_DIR
# does not say: a fixed directory of the checkout (listed in .gitignore).
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")

# Geometry (minimal solvers, triangulation, BA) needs true f32 matmuls;
# on the GPU the default precision runs float32 products in TF32 (about
# three decimal digits), which costs relative-pose accuracy.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the mapper's programs are stable across
# processes, so a later run skips their compilation. JAX reads
# JAX_COMPILATION_CACHE_DIR itself; only without it is a directory set.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
