"""Preamble detection under CFO/delay/noise with qdetector
(reference qdetector_cccf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.framing.detector import make_template, qdetector_detect
from liquid_dsp_tpu.ops.fir import firinterp
from liquid_dsp_tpu.design.firdes import firdes_arkaiser

rng = np.random.default_rng(0)
# 64-symbol QPSK preamble, pulse-shaped at 2 samples/symbol
syms = ((rng.integers(0, 2, 64) * 2 - 1) +
        1j * (rng.integers(0, 2, 64) * 2 - 1)).astype(np.complex64) / np.sqrt(2)
q = firinterp(2, firdes_arkaiser(2, 7, 0.3))
s = make_template(syms, q)

delay, dphi = 237, 0.02
x = np.zeros(1024, np.complex64)
x[delay:delay + len(s)] = s * np.exp(1j * (dphi * np.arange(len(s)) + 0.7))
x += (0.05 * (rng.standard_normal(1024) + 1j * rng.standard_normal(1024))
      ).astype(np.complex64)

det = qdetector_detect(x, s, threshold=0.5)
print(f"detected={det.detected}  rxy={det.rxy:.3f}")
print(f"sample index: {det.sample_index} (true {delay})")
print(f"cfo estimate: {det.dphi_hat:+.4f} rad/sample (true {dphi:+.4f})")
print(f"gain estimate: {det.gamma_hat:.3f} (true 1.0)")
assert det.detected and abs(det.sample_index - delay) <= 2
