"""OFDM flexible frame with runtime mod/FEC
(reference ofdmflexframesync_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.framing import ofdmflexframegen, ofdmflexframesync

rng = np.random.default_rng(1)
header = rng.integers(0, 256, 8).astype(np.uint8)
payload = rng.integers(0, 256, 120).astype(np.uint8)
f = ofdmflexframegen(header, payload, ms="qam16", fec1="golay2412")
x = np.concatenate([np.zeros(100, np.complex64), f,
                    np.zeros(100, np.complex64)])
t = np.arange(len(x))
x = (0.5 * x * np.exp(1j * 0.003 * t)).astype(np.complex64)
r = ofdmflexframesync(x)
print(f"header_ok={r.header_ok} crc_ok={r.crc_ok} "
      f"ms={r.ms} len={r.payload_len}")
print("payload intact:", np.array_equal(r.payload, payload))
