"""ADC/DAC quantization and mu-law companding
(reference quantize_example.c / compand_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.utils.quantization import (quantize_adc, quantize_dac,
                                               compress_mulaw, expand_mulaw)

x = np.linspace(-1, 1, 2001).astype(np.float32) * 0.99
for bits in (4, 8, 12):
    q = np.asarray(quantize_adc(x, bits))
    y = np.asarray(quantize_dac(q, bits))
    snr = 10 * np.log10(np.mean(x ** 2) / np.mean((x - y) ** 2))
    print(f"uniform {bits:2d}-bit quantization: SNR {snr:5.1f} dB "
          f"(~6.02/bit = {6.02 * bits:.0f})")

# companding concentrates resolution near zero (speech-shaped signals)
rng = np.random.default_rng(8)
s = (0.2 * rng.standard_normal(20000)).clip(-1, 1).astype(np.float32)
lin = np.asarray(quantize_dac(np.asarray(quantize_adc(s, 6)), 6))
comp = np.asarray(expand_mulaw(
    quantize_dac(np.asarray(quantize_adc(np.asarray(compress_mulaw(s)), 6)), 6)))
snr_lin = 10 * np.log10(np.mean(s ** 2) / np.mean((s - lin) ** 2))
snr_cmp = 10 * np.log10(np.mean(s ** 2) / np.mean((s - comp) ** 2))
print(f"6-bit on low-level gaussian: linear {snr_lin:.1f} dB, "
      f"mu-law companded {snr_cmp:.1f} dB")
