"""Pilot-assisted recovery of gain/phase/CFO on a QPSK packet
(reference qpilotsync_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.framing.qpacket import qpilotgen, qpilotsync

rng = np.random.default_rng(2)
n, spacing = 400, 20
s2 = np.sqrt(0.5)
syms = ((rng.integers(0, 2, n) * 2 - 1) * s2 +
        1j * (rng.integers(0, 2, n) * 2 - 1) * s2).astype(np.complex64)
frame = np.asarray(qpilotgen(syms, spacing))
print(f"{n} payload symbols + pilots -> {len(frame)} frame symbols")

gain, dphi, phi = 0.3, 0.01, 1.2
t = np.arange(len(frame))
rx = (gain * frame * np.exp(1j * (dphi * t + phi))).astype(np.complex64)
out, dphi_hat, phi_hat, g_hat = qpilotsync(rx, n, spacing)
evm = 20 * np.log10(np.sqrt(np.mean(np.abs(np.asarray(out) - syms) ** 2)))
print(f"estimates: gain {g_hat:.3f} (true {gain}), "
      f"dphi {dphi_hat:+.4f} (true {dphi:+.4f}), "
      f"phi {phi_hat:+.3f} (true {phi:+.3f})")
print(f"recovered EVM: {evm:.1f} dB")
assert evm < -35
