"""Full frame64 TX/RX loopback with channel impairments
(reference framesync64_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.framing import framegen64, framesync64

rng = np.random.default_rng(0)
header = rng.integers(0, 256, 8).astype(np.uint8)
payload = rng.integers(0, 256, 64).astype(np.uint8)
frame = framegen64(header, payload)
# channel: delay, gain, carrier offset, phase, AWGN at 15 dB SNR
x = np.concatenate([np.zeros(133, np.complex64), frame,
                    np.zeros(200, np.complex64)])
t = np.arange(len(x))
x = 0.2 * x * np.exp(1j * (0.007 * t + 1.2))
x = (x + 0.2 * 10 ** (-15 / 20) / np.sqrt(2) *
     (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
     ).astype(np.complex64)
r = framesync64(x)
print(f"detected={r.detected} crc_ok={r.crc_ok} evm={r.evm_db:.1f} dB "
      f"rssi={r.rssi_db:.1f} dB cfo={r.cfo:+.4f} rad/sample")
print("payload intact:", np.array_equal(r.payload, payload))
