"""Packet encode/decode through the qpacketmodem with injected noise
(reference qpacketmodem_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.framing.qpacket import (qpacketmodem_encode,
                                            qpacketmodem_decode,
                                            qpacketmodem_frame_len)

rng = np.random.default_rng(1)
payload = rng.integers(0, 256, 80).astype(np.uint8)
crc, fec0, fec1, ms = "crc32", "hamming128", "none", "qpsk"
syms = np.asarray(qpacketmodem_encode(payload, crc, fec0, fec1, ms))
n = qpacketmodem_frame_len(80, crc, fec0, fec1, ms)
print(f"80-byte payload -> {n} {ms} symbols ({crc}+{fec0})")

for snr_db in (30.0, 10.0, 6.0):
    sigma = 10 ** (-snr_db / 20) / np.sqrt(2)
    rx = syms + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    dec, ok = qpacketmodem_decode(rx.astype(np.complex64), 80,
                                  crc, fec0, fec1, ms)
    print(f"SNR {snr_db:4.1f} dB: crc pass={bool(ok)}, "
          f"payload intact={np.array_equal(dec, payload)}")
