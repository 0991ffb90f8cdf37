"""Data integrity checks: the five CRC/checksum schemes catch injected
errors (reference crc_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.fec.crc import (CRC_SCHEMES, crc_generate_key,
                                    crc_sizeof_key, crc_validate_message)

rng = np.random.default_rng(26)
msg = rng.integers(0, 256, 64).astype(np.uint8)
for scheme in CRC_SCHEMES:
    if scheme == "none":
        continue
    key = crc_generate_key(scheme, msg)
    ok = crc_validate_message(scheme, msg, key)
    bad = msg.copy()
    bad[10] ^= 0x04                      # single bit flip
    caught = not crc_validate_message(scheme, bad, key)
    print(f"{scheme:10s}: {8 * crc_sizeof_key(scheme)}-bit key "
          f"0x{key:0{2 * crc_sizeof_key(scheme)}x}  valid={ok}  "
          f"1-bit error caught={caught}")
    assert ok and caught
