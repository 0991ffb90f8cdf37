"""Byte-oriented packet TX/RX at arbitrary bit offsets with error
correction (reference bpacketsync_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.framing.bpacket import bpacketgen, bpacketsync

rng = np.random.default_rng(0)
payload = rng.integers(0, 256, 64).astype(np.uint8)
pkt = bpacketgen(payload, "crc32", "none", "golay2412")
print(f"packet: {len(payload)} payload -> {len(pkt)} bytes on the wire")

# embed at a 5-bit offset in random noise bits, flip two bits
bits = np.concatenate([rng.integers(0, 2, 5),
                       np.unpackbits(pkt),
                       rng.integers(0, 2, 64)]).astype(np.uint8)
bits[100] ^= 1
bits[300] ^= 1
r = bpacketsync(np.packbits(bits))
print(f"found={r.found} at bit offset {r.bit_offset} (true 5), "
      f"crc_ok={r.crc_ok}")
print("payload intact:", np.array_equal(r.payload, payload))
