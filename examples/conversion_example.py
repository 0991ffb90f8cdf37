"""SDR IQ wire formats: cu8/cs8/cs16/cf32 round trips and planar ingest
(reference conversion_example.c; the planar planes are this framework's
native device format — see liquid_dsp_tpu/io.py)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.io import (complex_to_iq, iq_to_complex, iq_to_planes,
                               IQ_FORMATS)

rng = np.random.default_rng(18)
x = (0.25 * (rng.standard_normal(4096) + 1j * rng.standard_normal(4096))
     ).clip(-0.999, 0.999).astype(np.complex64)

for fmt in IQ_FORMATS:
    raw = complex_to_iq(x, fmt)
    y = iq_to_complex(raw, fmt)
    snr = 10 * np.log10(np.mean(np.abs(x) ** 2) /
                        (np.mean(np.abs(x - y) ** 2) + 1e-20))
    r, i = iq_to_planes(raw, fmt)
    print(f"{fmt:5s}: {raw.nbytes:6d} bytes on the wire, round-trip SNR "
          f"{min(snr, 200):6.1f} dB, planes {r.dtype} x2")
