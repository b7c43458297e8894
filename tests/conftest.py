"""Test configuration: run everything on a virtual 8-device CPU mesh.

Unit tests use the CPU backend (f32, same code paths) with 8 virtual
devices so multi-device sharding tests run anywhere; the GPU path is
exercised by chip_smoke.py on the card.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
# A compile cache of this machine's own CPU executables: an executable
# compiled for another host's CPU features can crash when loaded here.
# mavmap_tpu sets no cache directory of its own when this variable is set.
os.environ["JAX_COMPILATION_CACHE_DIR"] = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache_tests")

import jax  # noqa: E402

# CPU unless JAX_PLATFORMS names more (on the card: JAX_PLATFORMS=cuda,cpu
# for the `gpu`-marked tests).
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_default_device", jax.devices("cpu")[0])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _mmap_guard():
    """Keep the process under vm.max_map_count (65530 default).

    Compiled XLA:CPU executables accumulate memory mappings; a full-suite
    run crosses the kernel limit around test ~135, the next mmap fails,
    and XLA segfaults (measured: maps grow ~15k -> 65k, SIGSEGV exactly
    at the limit). Dropping the jit caches unmaps retired executables;
    the persistent compile cache makes the re-compiles cheap."""
    yield
    try:
        with open("/proc/self/maps") as f:
            n = sum(1 for _ in f)
    except OSError:
        return
    if n > 40000:
        jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a CUDA device (on the card: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/)")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def cpu_devices():
    return jax.devices("cpu")


def write_cached_cli_dataset(tmp_path, feats, n_images,
                             cam_def=", 1, PINHOLE, 700.0, 700.0, 400.0, 300.0"):
    """Shared CLI fixture: imagedata.txt + pre-populated feature cache.

    Uses FeatureCache itself to write entries so the fingerprint always
    matches the CLI's detector_params (hand-rolled hashes silently fall
    back to extract-on-miss whenever a new detector param is added).
    """
    import numpy as np
    from mavmap_tpu.features import FeatureCache

    data = tmp_path / "data"
    cache = tmp_path / "cache"
    data.mkdir(exist_ok=True), cache.mkdir(exist_ok=True)
    lines = ["# imagedata"]
    for i in range(n_images):
        suffix = cam_def if i == 0 else ""
        lines.append(f"img{i}, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0{suffix}")
    (data / "imagedata.txt").write_text("\n".join(lines) + "\n")

    # Mirror cli.py's detector_params exactly: min_per_cell only enters the
    # fingerprint when the adaptive mode is ON (the flag default must not
    # invalidate caches written before the flag existed).
    params = {"hessian_threshold": 1000.0, "num_octaves": 4,
              "num_octave_layers": 3, "upright": False,
              "grid_size": (3, 3), "max_features": 1024}
    fc = FeatureCache(str(cache), params,
                      detector=lambda i: feats[i], capacity=1024)
    for i in range(n_images):
        fc.query(i, f"img{i}")
    return data, cache
