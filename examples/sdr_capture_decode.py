"""End-to-end SDR capture decode: raw cs16 IQ file -> flexframe payload.

A transmitter assembles a flexframe (wire-compatible with the reference
C library — a capture of a reference transmitter decodes identically),
the samples are written as an int16 IQ capture file like an SDR records,
then the receive side streams the file in fixed blocks, detects the
frame, and decodes header + payload.

Run: python examples/sdr_capture_decode.py
"""
import pathlib
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from liquid_dsp_tpu.framing.flexframe import (flexframegen, flexframesync,
                                              FLEXFRAME_H_USER)
from liquid_dsp_tpu import io as lio


def main():
    rng = np.random.default_rng(7)
    header = rng.integers(0, 256, FLEXFRAME_H_USER).astype(np.uint8)
    payload = np.frombuffer(b"hello from the gpu-native flexframe!",
                            np.uint8)

    # --- transmit: assemble the frame, impair lightly, record to disk ---
    y = flexframegen(header, payload, crc="crc32", fec0="none",
                     fec1="golay2412", ms="qpsk")
    x = np.concatenate([np.zeros(400, np.complex64), 0.3 * y,
                        np.zeros(400, np.complex64)])
    x = x + 0.001 * (rng.standard_normal(len(x)) +
                     1j * rng.standard_normal(len(x)))
    cap = pathlib.Path(tempfile.mkdtemp()) / "capture.cs16"
    lio.write_iq(cap, x, "cs16")
    print(f"wrote {cap} ({cap.stat().st_size} bytes, "
          f"{len(x)} samples cs16)")

    # --- receive: stream fixed blocks, accumulate, sync ---
    blocks = list(lio.iq_stream(cap, "cs16", block=1024))
    capture = np.concatenate(blocks)
    print(f"read {len(blocks)} blocks of 1024 samples")

    res = flexframesync(capture)
    print(f"detected={res.detected} header_ok={res.header_ok} "
          f"crc_ok={res.crc_ok} ms={res.ms} len={res.payload_len}")
    assert res.crc_ok and np.array_equal(res.header, header)
    print("payload:", bytes(res.payload).decode())


if __name__ == "__main__":
    main()
