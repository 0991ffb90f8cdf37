#!/usr/bin/env python
"""Per-op throughput benchmark suite on the current JAX backend.

Mirrors the reference's bench/ methodology (trials auto-sized into a
50-500 ms window, reference bench/bench.c:85) across the hot ops, and
prints Msamples/s plus the speedup against the reference C library's
single-thread numbers measured by tools/bench_reference.py.
"""
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def bench(step, params, carry, x, min_t=0.3):
    """Calibrated timing with a hard on-device data dependency: every
    trial feeds the previous trial's carry AND folds a checksum of the
    output into the next input, so no stage can be elided or overlapped
    past the final host readback."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def step_chk(params, c, x, chk):
        y, c2 = step(params, c, x)
        # cheap scalar fold; complex-safe
        s = jnp.sum(jnp.real(jnp.ravel(y)[:16]))
        return y, c2, chk + s

    y, c, chk = step_chk(params, carry, x, jnp.float32(0))
    float(np.asarray(chk))  # value readback: proves completion (warmup)

    def run_trials(n):
        t0 = time.perf_counter()
        c = carry
        chk = jnp.float32(0)
        for _ in range(n):
            y, c, chk = step_chk(params, c, x, chk)
        float(np.asarray(chk))  # value readback: proves completion
        return time.perf_counter() - t0

    import importlib.util, pathlib as _pl
    spec = importlib.util.spec_from_file_location(
        "benchmod", _pl.Path(__file__).resolve().parent.parent / "bench.py")
    bm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bm)
    return bm.timed_throughput(run_trials, x.size) / 1e6


def main():
    import jax
    import jax.numpy as jnp
    from liquid_dsp_tpu.design.firdes import firdes_kaiser
    from liquid_dsp_tpu.ops.fir import firfilt, firdecim
    from liquid_dsp_tpu.ops.fftfilt import fftfilt
    from liquid_dsp_tpu.ops.nco import nco
    from liquid_dsp_tpu.ops.resample import msresamp, resamp
    from liquid_dsp_tpu.ops.agc import agc
    from liquid_dsp_tpu.ops.iir import iirfilt_sos
    from liquid_dsp_tpu.design.iirdes import iirdes_sos
    from liquid_dsp_tpu.multichannel import firpfbch2_analyzer
    from liquid_dsp_tpu.modem import modem_demodulator

    print(f"backend: {jax.devices()[0].platform} {jax.devices()[0]}",
          file=sys.stderr)
    rng = np.random.default_rng(0)
    batch, T = 16, 1 << 17

    def x():
        # assemble complex on device from float planes
        re = rng.standard_normal((batch, T)).astype(np.float32)
        im = rng.standard_normal((batch, T)).astype(np.float32)
        if jax.default_backend() == "cpu":
            return jnp.asarray(re + 1j * im)
        return jax.jit(jax.lax.complex)(jnp.asarray(re), jnp.asarray(im))

    cases = {}

    def add(name, make_proc, make_xin=None):
        # each case is fully constructed inside the try, so one case
        # that fails to build is reported and the sweep goes on
        try:
            proc = make_proc()
            xin = make_xin() if make_xin is not None else x()
            carry = jax.jit(
                lambda p=proc, s=xin.shape[:-1]: p.init(batch_shape=s))()
            params = jax.jit(lambda p=proc: p.params)()
            step = jax.jit(proc.apply)
            cases[name] = bench(step, params, carry, xin)
        except Exception as e:
            cases[name] = None
            import traceback
            tb = traceback.extract_tb(e.__traceback__)
            loc = next((f"{fr.filename.split('/')[-1]}:{fr.lineno}"
                        for fr in reversed(tb)
                        if "liquid_dsp_tpu" in fr.filename or
                        "bench_suite" in fr.filename), "?")
            print(f"{name}: FAILED at {loc} "
                  f"({type(e).__name__}: {str(e)[:120]})", file=sys.stderr)

    # real-valued cases first
    xr = lambda: jnp.asarray(rng.standard_normal((batch, T))
                             .astype(np.float32))
    add("firfilt64_real", lambda: firfilt(firdes_kaiser(64, 0.2, 60.0)),
        xr)
    add("firfilt64_matmul_real",
        lambda: firfilt(firdes_kaiser(64, 0.2, 60.0), backend="matmul"),
        xr)
    add("agc_real", lambda: agc(), xr)

    def _iir7():
        B, A = iirdes_sos("butter", 7, 0.2)
        return iirfilt_sos(B, A)

    add("iirfilt_sos7_real", _iir7, xr)

    import os
    if os.environ.get("LIQUID_SUITE_REAL_ONLY"):
        # reduced sweep: real-plane cases only
        _print_results(cases)
        return 0

    add("firfilt64", lambda: firfilt(firdes_kaiser(64, 0.2, 60.0)))
    add("firfilt257", lambda: firfilt(firdes_kaiser(257, 0.1, 80.0)))
    add("fftfilt57", lambda: fftfilt(firdes_kaiser(57, 0.3, 60.0)))
    add("nco_mix", lambda: nco(0.125))
    add("firdecim4", lambda: firdecim(4, firdes_kaiser(48, 0.1, 60.0)))
    add("resamp_3_2", lambda: resamp((3, 2)))
    add("msresamp_0.5", lambda: msresamp(0.5))
    add("agc", lambda: agc())
    add("iirfilt_sos7", _iir7)
    add("firpfbch2_64", lambda: firpfbch2_analyzer(64, 4))
    add("qam16_demod", lambda: modem_demodulator("qam16"))

    # bench-parity rows for the remaining reference benchmark families
    # (firinterp/firhilb/resamp2/modulate/freqmod/freqdem sweeps in
    # reference src/*/bench/)
    from liquid_dsp_tpu.ops.fir import firinterp, firhilb
    from liquid_dsp_tpu.ops.resample import resamp2_decim
    from liquid_dsp_tpu.modem.linear import modem_modulator
    from liquid_dsp_tpu.modem.analog import (freq_modulator,
                                             freq_demodulator)
    add("firinterp4", lambda: firinterp(4, firdes_kaiser(48, 0.1, 60.0)))
    add("firhilb_decim", lambda: firhilb(5), xr)
    add("resamp2_decim", lambda: resamp2_decim(7))
    add("qam16_mod",
        lambda: modem_modulator("qam16"),
        lambda: jnp.asarray(rng.integers(0, 16, (batch, T))
                            .astype(np.int32)))
    add("freqmod", lambda: freq_modulator(0.1), xr)
    add("freqdem", lambda: freq_demodulator(0.1))

    # r5 bench-parity rows: the remaining reference bench families
    # (gmskmodem / fskmod / fskdem / iirdecim / iirinterp / demodsoft
    # benchmarks in reference src/{modem,filter}/bench/); unit matches
    # the C row in tests/baseline_perop.json (input elements per call)
    from liquid_dsp_tpu.modem.cpm import (gmsk_modulator,
                                          gmsk_demodulator,
                                          fsk_modulator, fsk_demodulator)
    from liquid_dsp_tpu.ops.misc_filters import iirdecim, iirinterp
    add("gmskmod_bits", lambda: gmsk_modulator(2, 3, 0.3),
        lambda: jnp.asarray(rng.integers(0, 2, (batch, T))
                            .astype(np.int32)))
    add("gmskdem_samps", lambda: gmsk_demodulator(2, 3, 0.3))
    add("fskmod4_syms", lambda: fsk_modulator(2, 8, 0.25),
        lambda: jnp.asarray(rng.integers(0, 4, (batch, T // 8))
                            .astype(np.int32)))
    add("fskdem4_samps", lambda: fsk_demodulator(2, 8, 0.25))
    add("iirdecim4", lambda: iirdecim(4))
    add("iirinterp4", lambda: iirinterp(4),
        lambda: x()[..., : T // 4])

    from liquid_dsp_tpu.modem.linear import demodulate_soft

    class _SoftProc:
        params = ()
        def init(self, batch_shape=(), dtype=jnp.complex64):
            return ()
        def apply(self, params, carry, y):
            tab = np.asarray(constellation_tab, np.complex64)
            return demodulate_soft(jnp.asarray(tab), y), ()

    from liquid_dsp_tpu.modem.linear import constellation as _const
    constellation_tab = _const("qam16")
    add("qam16_demodsoft", lambda: _SoftProc())

    _print_results(cases)
    return 0


def _print_results(cases):
    # reference-C denominators: the r5 per-op baseline table first
    # (tools/bench_reference_perop.py), the r2 chain file as fallback
    root = pathlib.Path(__file__).parent.parent
    perop_path = root / "tests/baseline_perop.json"
    perop = json.loads(perop_path.read_text()) if perop_path.exists() \
        else {}
    base_path = root / "tests/baseline_measured.json"
    base = json.loads(base_path.read_text()) if base_path.exists() else {}
    ref = {"firfilt64": base.get("firfilt64_msps_cpu"),
           "fftfilt57": base.get("fftfilt57_msps_cpu"),
           "firpfbch2_64": base.get("firpfbch2_64_msps_cpu")}
    alias = {"msresamp_0.5": "msresamp_0.5", "resamp_3_2": "resamp_3_2"}
    for name, msps in cases.items():
        if msps is None:
            print(f"{name:16s} {'n/a':>12s}")
            continue
        r = perop.get(alias.get(name, name)) or ref.get(name)
        extra = f"  ({msps / r:8.0f}x reference C)" if r else ""
        print(f"{name:16s} {msps:12.1f} Msamples/s{extra}")


if __name__ == "__main__":
    sys.exit(main())
