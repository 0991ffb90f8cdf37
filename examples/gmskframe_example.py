"""GMSK frame TX/RX loopback with CFO and noise
(reference gmskframesync_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.framing.gmskframe import gmskframegen, gmskframesync

rng = np.random.default_rng(0)
header = rng.integers(0, 256, 8).astype(np.uint8)
payload = rng.integers(0, 256, 40).astype(np.uint8)
frame = gmskframegen(header, payload, fec0="hamming74")  # fec in header
x = np.concatenate([np.zeros(97, np.complex64), frame,
                    np.zeros(150, np.complex64)])
t = np.arange(len(x))
x = x * np.exp(1j * (0.001 * t + 0.3))
x = (x + 0.05 / np.sqrt(2) * (rng.standard_normal(len(x)) +
                              1j * rng.standard_normal(len(x)))
     ).astype(np.complex64)
r = gmskframesync(x)
print(f"detected={r.detected} header_ok={r.header_ok} "
      f"crc_ok={r.crc_ok}")
print("payload intact:", np.array_equal(r.payload, payload))
