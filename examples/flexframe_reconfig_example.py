"""One flexframe receiver decodes frames whose modulation/FEC change
per frame — the header carries the configuration
(reference flexframesync_reconfig_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.framing.flexframe import flexframegen, FlexFrameSync

rng = np.random.default_rng(27)
configs = [("qpsk", "none", "hamming74", 40),
           ("qam16", "crc16", "golay2412", 64),
           ("bpsk", "crc32", "none", 25)]
stream = [np.zeros(500, np.complex64)]
payloads = []
for ms, crc, fec0, n in configs:
    header = rng.integers(0, 256, 14).astype(np.uint8)
    payload = rng.integers(0, 256, n).astype(np.uint8)
    payloads.append(payload)
    f = flexframegen(header, payload, ms=ms, crc=crc, fec0=fec0)
    stream.extend([f, np.zeros(700, np.complex64)])
x = np.concatenate(stream)

got = []
fs = FlexFrameSync(callback=lambda h, hok, p, pok, st: got.append(
    (p.copy(), pok, st)))
fs.execute(x)
fs.flush()
for i, (p, ok, st) in enumerate(got):
    ms, crc, fec0, n = configs[i]
    print(f"frame {i}: {ms}/{fec0}, {len(p)} bytes, payload ok={ok}, "
          f"intact={np.array_equal(p, payloads[i])}, "
          f"evm {st.get('evm_db', float('nan')):.1f} dB")
assert len(got) == 3 and all(ok for _, ok, _ in got)
