"""Packet error rate of qpacketmodem vs SNR
(reference qpacketmodem_performance_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.framing.qpacket import (qpacketmodem_encode,
                                            qpacketmodem_decode)

payload_len, crc, fec0, fec1, ms = 50, "crc16", "none", "golay2412", "qpsk"
trials = 40
rng = np.random.default_rng(23)
print(f"{payload_len}-byte payload, {crc}+{fec1}, {ms}: PER vs SNR")
print("  SNR(dB)   PER")
pers = []
for snr_db in (2.0, 6.0, 10.0):
    nstd = 10 ** (-snr_db / 20)
    errs = 0
    for _ in range(trials):
        payload = rng.integers(0, 256, payload_len).astype(np.uint8)
        sym = np.asarray(qpacketmodem_encode(payload, crc, fec0, fec1, ms))
        noise = nstd / np.sqrt(2) * (rng.standard_normal(sym.shape)
                                     + 1j * rng.standard_normal(sym.shape))
        dec, ok = qpacketmodem_decode(sym + noise.astype(np.complex64),
                                      payload_len, crc, fec0, fec1, ms)
        if not (ok and np.array_equal(dec, payload)):
            errs += 1
    per = errs / trials
    pers.append(per)
    print(f"  {snr_db:6.1f}   {per:.3f}")
# monotone improvement and clean decode at high SNR
assert pers[-1] == 0.0 and pers[0] >= pers[-1]
