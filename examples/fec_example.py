"""FEC round trip with bit errors across schemes
(reference fec_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.fec.dispatch import (fec_encode, fec_decode,
                                         fec_get_enc_msg_length)

rng = np.random.default_rng(0)
n = 64
msg = rng.integers(0, 256, n).astype(np.uint8)
for scheme in ("rep3", "hamming74", "hamming128", "golay2412",
               "secded7264", "v27", "v39", "rs8"):
    enc = fec_encode(scheme, msg)
    assert len(enc) == fec_get_enc_msg_length(scheme, n)
    # flip one bit per 8 encoded bytes
    bits = np.unpackbits(enc)
    for k in range(0, len(bits) - 128, 128):
        bits[k + int(rng.integers(0, 8))] ^= 1
    dec = fec_decode(scheme, np.packbits(bits)[: len(enc)], n)
    ok = np.array_equal(dec, msg)
    print(f"{scheme:10s} rate {n}/{len(enc)}  "
          f"recovered={'yes' if ok else 'NO'}")
