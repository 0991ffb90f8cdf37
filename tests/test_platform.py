"""The platform policy table (liquid_dsp_tpu/platform.py) and the
compile-cache helper."""
import os
import pathlib
import subprocess
import sys

import jax
import pytest

from liquid_dsp_tpu import platform as plat

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", sorted(plat.POLICY))
@pytest.mark.parametrize("where", ["cpu", "gpu"])
def test_every_entry_has_both_platforms(name, where):
    assert plat.policy(name, where) == plat.POLICY[name][where]


def test_running_platform_is_cpu():
    assert plat.platform() == "cpu"
    assert plat.policy("chain_kernel") is False


def test_unknown_platform_raises(monkeypatch):
    with pytest.raises(ValueError):
        plat.policy("chain_kernel", "rocm")
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError):
        plat.platform()
    with pytest.raises(KeyError):
        plat.policy("no_such_entry", "cpu")


def test_gpu_takes_the_kernels():
    assert plat.policy("chain_kernel", "gpu") is True
    assert plat.policy("codebook_kernel_min_k", "gpu") is not None
    assert plat.policy("codebook_kernel_min_k", "cpu") is None


def test_scan_unroll():
    assert plat.scan_unroll(16, "cpu") == 1
    assert plat.scan_unroll(16, "gpu") == 16


def _cache_dir_in_child(env):
    code = ("import jax; from liquid_dsp_tpu.platform import "
            "enable_compile_cache as e; p = e(); "
            "print(p); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split("\n")
    return out[0], out[1]


def test_compile_cache_follows_environment(tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    got, cfg = _cache_dir_in_child(env)
    assert got == str(tmp_path) and cfg == str(tmp_path)


def test_compile_cache_default_is_in_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    got, cfg = _cache_dir_in_child(env)
    assert got == cfg == str(REPO / ".jax_cache")
