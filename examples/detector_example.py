"""Burst detection: time-domain correlator and the CFO-robust
pre-demod correlator (reference detector_cccf_example.c /
bpresync_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.framing.bpacket import (detector_cccf_detect,
                                            bpresync_detect)

rng = np.random.default_rng(16)
n, delay = 2000, 421
s = (rng.standard_normal(64) + 1j * rng.standard_normal(64)
     ).astype(np.complex64)
s /= np.abs(s).max()

x = np.zeros(n, np.complex64)
x[delay:delay + 64] = s
x += (0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
      ).astype(np.complex64)

found, idx, rxy = detector_cccf_detect(x, s, threshold=0.5)
print(f"plain correlator, no CFO : found={found} index={idx} "
      f"(true {delay}) rxy={rxy:.2f}")

# with CFO the plain correlator degrades; bpresync sweeps hypotheses
dphi = 0.015
xc = (x * np.exp(1j * dphi * np.arange(n))).astype(np.complex64)
f0, i0, r0 = detector_cccf_detect(xc, s, threshold=0.5)
f1, i1, dphi_hat, r1 = bpresync_detect(xc, s, dphi_range=0.02, n_dphi=9,
                                       threshold=0.5)
print(f"plain correlator, CFO    : found={f0} rxy={r0:.2f}")
print(f"bpresync (9 hypotheses)  : found={f1} index={i1} "
      f"dphi={dphi_hat:+.4f} (true {dphi:+.4f}) rxy={r1:.2f}")
assert found and f1 and abs(i1 - delay) <= 1
