"""Second-order PLL loop-filter design locks onto a frequency offset
(reference pll_example.c / iirdes_pll_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.design.iirdes import iirdes_pll_active_pi
from liquid_dsp_tpu.ops.nco import pll_step

# design the loop filter (active PI, bandwidth 0.01, zeta 0.707, K 1000)
b, a = iirdes_pll_active_pi(0.01, 1 / np.sqrt(2), 1000.0)
print("loop filter b:", np.round(b / a[0], 6))
print("loop filter a:", np.round(a / a[0], 6))

# track a carrier with frequency + phase offset using the pll step
dphi_true, phi_true = 0.02, 1.5
n = 800
x = np.exp(1j * (dphi_true * np.arange(n) + phi_true)).astype(np.complex64)
theta, dphi = 0.0, 0.0
err_trace = []
for t in range(n):
    e = float(np.angle(x[t] * np.exp(-1j * theta)))   # phase detector
    theta, dphi = pll_step(theta, dphi, e, bandwidth=0.05)
    theta, dphi = float(theta) + float(dphi), float(dphi)  # nco step
    err_trace.append(abs(e))
print(f"phase error: first 20 samples {np.mean(err_trace[:20]):.3f} rad -> "
      f"last 100 samples {np.mean(err_trace[-100:]):.5f} rad")
print(f"frequency estimate {dphi:+.5f} rad/sample (true {dphi_true:+.5f})")
assert np.mean(err_trace[-100:]) < 1e-2
