"""Raw OFDM frame: generate S0/S1 preamble + data symbols, synchronize
through a channel (reference ofdmframegen_example.c /
ofdmframesync_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.multichannel.ofdm import (ofdm_params,
                                              ofdm_generate_frame,
                                              ofdm_frame_sync)

params = ofdm_params(M=64, cp_len=16)
n_syms = 6
rng = np.random.default_rng(15)
s2 = np.sqrt(0.5)
data = ((rng.integers(0, 2, (n_syms, params.M_data)) * 2 - 1) * s2 +
        1j * (rng.integers(0, 2, (n_syms, params.M_data)) * 2 - 1) * s2
        ).astype(np.complex64)
frame = ofdm_generate_frame(params, data)
print(f"M=64 (null/pilot/data {params.M_null}/{params.M_pilot}/"
      f"{params.M_data}), {n_syms} symbols -> {len(frame)} samples")

# channel: delay + CFO + phase + noise
x = np.concatenate([np.zeros(60, np.complex64), frame,
                    np.zeros(80, np.complex64)])
t = np.arange(len(x))
x = (x * np.exp(1j * (0.002 * t + 0.5))).astype(np.complex64)
x += (0.01 * (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
      ).astype(np.complex64)

res = ofdm_frame_sync(params, x, n_syms)
evm = 20 * np.log10(np.sqrt(np.mean(np.abs(
    np.asarray(res.data_syms) - data) ** 2)))
print(f"detected={res.detected}, cfo {res.cfo_hat:+.4f} (true +0.0020)")
print(f"payload EVM {evm:.1f} dB; pilot EVM {res.evm_db:.1f} dB")
assert res.detected and evm < -20
