"""Bring-up guards: no silent move to the CPU, compile-cache placement, and
a rehearsal phase of chip_smoke.py."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_the_cpu(capsys):
    """Without --rehearse the smoke run exits non-zero on a CPU backend and
    prints no result line."""
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_kernels_phase_rehearsal():
    """The kernels phase end to end at rehearsal sizes, in this process."""
    import chip_smoke

    chip_smoke.phase_kernels(chip_smoke.REHEARSAL)


@pytest.mark.parametrize("entry", ["run_pipeline", "dryrun_multichip"])
def test_mesh_request_beyond_devices_raises(entry):
    """Asking for more devices than the backend has is an error, never a
    quiet move to other devices."""
    too_many = len(jax.devices()) + 1
    if entry == "dryrun_multichip":
        import __graft_entry__ as ge

        with pytest.raises(RuntimeError, match="devices"):
            ge.dryrun_multichip(too_many)
        return
    from mavmap_tpu.features import ArrayFeatureProvider
    from mavmap_tpu.sfm.pipeline import PipelineOptions, run_pipeline
    from mavmap_tpu.utils.synthetic import make_uav_scene, render_features

    scene = make_uav_scene(num_images=3, num_points=300, seed=1)
    feats, _ = render_features(scene, seed=1)
    with pytest.raises(ValueError, match="mesh_devices"):
        run_pipeline(scene.image_cameras, scene.cam_models, scene.cam_params,
                     ArrayFeatureProvider(feats, capacity=256),
                     PipelineOptions(verbose=False, mesh_devices=too_many))


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_placement(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set the cache goes only there;
    without it, only to <checkout>/.jax_cache. A copy of the package
    stands in for the checkout; HOME must stay empty either way."""
    checkout = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "mavmap_tpu"), checkout / "mavmap_tpu",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    home = tmp_path / "home"
    home.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", HOME=str(home),
               PYTHONPATH=str(checkout),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    cache = checkout / ".jax_cache"
    if env_dir:
        cache = tmp_path / "cache"
        env["JAX_COMPILATION_CACHE_DIR"] = str(cache)
    code = ("import jax, jax.numpy as jnp, mavmap_tpu\n"
            "x = jnp.ones((64, 64))\n"
            "jax.jit(lambda x: jnp.sin(x) @ x.T)(x).block_until_ready()\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(cache)
    assert cache.is_dir() and any(cache.iterdir())
    if env_dir:
        assert not (checkout / ".jax_cache").exists()
    assert not any(home.rglob("*"))
