"""Every decision the library takes by platform, in one table.

The library runs on two backends: the host CPU (tests, small jobs) and
an NVIDIA GPU (the accelerator it is benchmarked on).  Each entry of
`POLICY` names one formulation choice and gives its value per platform;
`policy(name)` reads it for the backend JAX is running on.  Any other
backend raises, so a new accelerator cannot fall silently to one side of
a branch.

The main-path entries were set by an H100 timing of the alternatives;
the others take the accelerator side of the earlier CPU/accelerator
split and are marked "not measured on H100" (PERF.md).
"""
from __future__ import annotations

import os
import pathlib

import jax

__all__ = ["POLICY", "platform", "policy", "scan_unroll",
           "enable_compile_cache"]

# name: {"cpu": value, "gpu": value}.  The first six GPU values were set
# by H100 timings (tools/bench_policy.py, tools/bench_kernels.py,
# chip_smoke.py; PERF.md "Platform policy"); the rest take the
# accelerator side and are not measured on the H100.
POLICY = {
    # firfilt/firdecim/fused LTI stages: banded-tap matmul (True) or
    # XLA's convolution (False)
    "fir_banded_matmul": {"cpu": False, "gpu": True},
    # fftfilt: smallest overlap-save FFT length
    "fftfilt_nfft_floor": {"cpu": 512, "gpu": 4096},
    # firinterp: one banded matmul for all phases (True) or k convs
    "firinterp_banded": {"cpu": False, "gpu": True},
    # rational resampler: banded matmul (True) or per-class convs
    "resamp_banded": {"cpu": False, "gpu": True},
    # block-code decode: smallest codebook (2^k) that takes the fused
    # matmul+argmax kernel; None keeps the einsum+argmax everywhere
    "codebook_kernel_min_k": {"cpu": None, "gpu": 1024},
    # kernel_fuse: the fused mix+FIR+decimation kernel (True) or the
    # unchanged XLA chain
    "chain_kernel": {"cpu": False, "gpu": True},
    # --- not measured on the H100 ---
    # iirfilt backend='auto': block state-space (True) or scan
    "iir_block": {"cpu": False, "gpu": True},
    # symsync: matched filters hoisted out of the timing scan
    "symsync_hoist": {"cpu": False, "gpu": True},
    # symsync scan body: filter-bank branch by one-hot matmul (True) or
    # by gather
    "symsync_onehot_select": {"cpu": False, "gpu": True},
    # symtrack: PLL+LMS fused into the symsync scan
    "symtrack_fused": {"cpu": False, "gpu": True},
    # analog FM demod output: trig of the quantized phase (True) or the
    # complex table gather
    "analog_trig": {"cpu": False, "gpu": True},
    # linear modulate: one-hot matmul (True) or table gather
    "modulate_onehot": {"cpu": False, "gpu": True},
    # sequential recurrence scans: unroll by the caller's factor
    "scan_unroll": {"cpu": False, "gpu": True},
}


def platform() -> str:
    """The backend JAX runs on: "cpu" or "gpu".  Raises on any other."""
    p = jax.default_backend()
    if p not in ("cpu", "gpu"):
        raise RuntimeError(
            f"unsupported JAX backend {p!r}: this library has formulations "
            "for 'cpu' and 'gpu' only (liquid_dsp_tpu/platform.py)")
    return p


def policy(name: str, plat: str | None = None):
    """Value of policy entry `name` on `plat` (default: the running
    backend).  Unknown names and platforms raise."""
    plat = platform() if plat is None else plat
    if plat not in ("cpu", "gpu"):
        raise ValueError(f"unknown platform {plat!r}")
    return POLICY[name][plat]


def scan_unroll(n: int, plat: str | None = None) -> int:
    """Unroll factor for sequential time-recurrence scans: `n` where the
    policy unrolls, else 1 (unrolled bodies multiply compile time)."""
    return n if policy("scan_unroll", plat) else 1


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    else is set.  Otherwise the cache lives at a fixed `.jax_cache` in the
    checkout (a fixed path, so later runs in the same checkout hit it)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(pathlib.Path(__file__).resolve().parent.parent / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
