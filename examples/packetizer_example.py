"""Two-stage packetizer (CRC + FEC0 + interleave + FEC1) round trip
(reference packetizer_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.fec.packetizer import (packetizer_encode,
                                           packetizer_decode,
                                           packetizer_compute_enc_msg_len)

rng = np.random.default_rng(1)
n = 48
msg = rng.integers(0, 256, n).astype(np.uint8)
crc, fec0, fec1 = "crc32", "hamming128", "golay2412"
pkt = packetizer_encode(msg, crc, fec0, fec1)
print(f"packet: {n} -> {len(pkt)} bytes "
      f"({packetizer_compute_enc_msg_len(n, crc, fec0, fec1)} expected)")
# corrupt a few bits
bits = np.unpackbits(pkt)
bits[[40, 200, 411]] ^= 1
dec, ok = packetizer_decode(np.packbits(bits)[: len(pkt)], n, crc,
                            fec0, fec1)
print(f"3 bit errors injected; crc_ok={ok}, "
      f"payload intact={np.array_equal(dec, msg)}")
