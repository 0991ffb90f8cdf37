"""Streaming multi-frame flexframe reception with the callback contract:
three frames with different payload schemes in one noisy capture
(reference flexframesync_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.framing.flexframe import flexframegen, FlexFrameSync

rng = np.random.default_rng(0)
cap = np.zeros(40000, np.complex64)
sent = []
for s0, (ms, fec0, n) in zip(
        (2000, 14000, 26000),
        (("qpsk", "none", 64), ("qam16", "hamming74", 200),
         ("psk8", "golay2412", 31))):
    header = rng.integers(0, 256, 14).astype(np.uint8)
    payload = rng.integers(0, 256, n).astype(np.uint8)
    f = flexframegen(header, payload, fec0=fec0, ms=ms)
    cap[s0:s0 + len(f)] += f
    sent.append(payload)
cap += (0.02 / np.sqrt(2) * (rng.standard_normal(len(cap)) +
                             1j * rng.standard_normal(len(cap)))
        ).astype(np.complex64)


def on_frame(header, header_ok, payload, payload_ok, stats):
    print(f"  frame @ {stats['sample_index']:6d}: {stats['ms']:6s} "
          f"{len(payload):3d} bytes  payload_ok={payload_ok}  "
          f"evm={stats['evm_db']:.1f} dB")


sync = FlexFrameSync(callback=on_frame, block_len=4096)
# feed in arbitrary chunks, as an SDR driver would
for i in range(0, len(cap), 7000):
    sync.execute(cap[i:i + 7000])
sync.flush()
ok = all(np.array_equal(fr[2], p) for fr, p in zip(sync.frames, sent))
print(f"{len(sync.frames)}/3 frames decoded, all payloads intact: {ok}")
