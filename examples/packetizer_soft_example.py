"""Soft-decision packetizer decoding survives errors hard decoding misses
(reference packetizer_soft_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.fec.packetizer import (packetizer_encode,
                                           packetizer_decode,
                                           packetizer_decode_soft)
from liquid_dsp_tpu.fec.block import unpack_bits

msg_len, crc, fec0, fec1 = 40, "crc32", "v27", "none"
rng = np.random.default_rng(17)
msg = rng.integers(0, 256, msg_len).astype(np.uint8)
pkt = packetizer_encode(msg, crc, fec0, fec1)
print(f"{msg_len}-byte message -> {len(pkt)}-byte packet ({crc}+{fec0})")

# BPSK-like channel: bipolar symbols + strong noise -> per-bit LLRs
bits = unpack_bits(pkt).astype(np.float32)
x = 1.0 - 2.0 * bits
y = x + 0.8 * rng.standard_normal(x.size).astype(np.float32)
hard_bits = (y < 0).astype(np.uint8)
nerr = int(np.sum(hard_bits != bits))
llr = -2.0 * y       # positive = bit 1, matching packetizer_decode_soft

hard_pkt = np.packbits(hard_bits)
_, ok_hard = packetizer_decode(hard_pkt, msg_len, crc, fec0, fec1)
dec_soft, ok_soft = packetizer_decode_soft(llr, msg_len, crc, fec0, fec1)
print(f"channel flipped {nerr}/{bits.size} hard bits")
print(f"hard decode crc_ok={bool(ok_hard)}   soft decode "
      f"crc_ok={bool(ok_soft)}")
assert ok_soft and np.array_equal(dec_soft, msg)
