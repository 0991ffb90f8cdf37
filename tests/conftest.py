"""Test configuration: run the suite on CPU with 8 virtual devices.

The reference has no multi-device tests (it is single-threaded C); we add
them following the plan in SURVEY.md §4 — sharded run ≡ single-device run ≡
golden vectors.  Multi-device correctness runs on a virtual CPU mesh so no
accelerator is needed.  Env vars must be set before jax initializes.

What only the GPU can check (compiled kernels, on-card precision) runs in
chip_smoke.py, one process on the card; tests that need a card carry the
`gpu` marker and skip here.
"""
import os
import pathlib
import sys

# Force CPU for the test suite (benchmarks use the card, tests use the
# 8-device virtual CPU mesh).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# float64 off; keep tests honest about f32 accumulation.
os.environ.setdefault("JAX_ENABLE_X64", "0")
# Silence XLA:CPU AOT-loader feature-mismatch log spam from the persistent
# compilation cache (cosmetic: +prefer-no-scatter/-gather pseudo-features);
# JAX errors still surface as Python exceptions.
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

from liquid_dsp_tpu.platform import enable_compile_cache  # noqa: E402

# Persistent compilation cache: the suite compiles the same receivers and
# chains in many tests (and in every xdist worker); caching identical HLO
# cuts repeat compiles from seconds to ~0.5s.
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"


def pytest_addoption(parser):
    parser.addoption("--slow", action="store_true", default=False,
                     help="also run the long loopback/interop sweeps")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long sweep kept out of the default green signal "
        "(reference autotest analog: every property still has at least one "
        "fast representative); run with --slow")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on the CPU (the card's "
        "checks run in chip_smoke.py)")


def pytest_collection_modifyitems(config, items):
    slow = pytest.mark.skip(reason="slow sweep; run with --slow")
    gpu = pytest.mark.skip(reason="needs an NVIDIA GPU (compiled kernel)")
    for item in items:
        if "slow" in item.keywords and not config.getoption("--slow"):
            item.add_marker(slow)
        if "gpu" in item.keywords and jax.default_backend() != "gpu":
            item.add_marker(gpu)

# Reference autotest tolerance: tol = 0.001 absolute per sample
# (reference src/filter/tests/firfilt_runtest.c:40).
TOL = 1e-3


@pytest.fixture(scope="session")
def golden():
    """Loader for extracted reference golden vectors."""

    def load(stem: str) -> dict:
        path = GOLDEN_DIR / f"{stem}.npz"
        if not path.exists():
            pytest.skip(f"golden data {stem} not extracted (run tools/extract_golden.py)")
        d = np.load(path)
        # strip the long common prefix: firfilt_crcf_data_h13x32_h -> h
        out = {}
        for k in d.files:
            short = k[len(stem) + 1:] if k.startswith(stem + "_") else k
            out[short] = d[k]
        return out

    return load


def assert_close(actual, desired, tol=TOL, msg=""):
    actual = np.asarray(actual)
    desired = np.asarray(desired)
    assert actual.shape == desired.shape, f"{msg} shape {actual.shape} != {desired.shape}"
    err = np.max(np.abs(actual - desired)) if actual.size else 0.0
    assert err <= tol, f"{msg} max |err| = {err:.3e} > tol {tol:.0e}"
