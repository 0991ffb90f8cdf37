"""Arbitrary-rate resampling of a tone; spectral peak stays put
(reference resamp_crcf_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.resample import resamp, as_rational

rate = 0.7113             # output/input rate
num, den = as_rational(rate)
print(f"rate {rate} -> {num}/{den}")
n = (1 << 14) // den * den
fc = 0.061
x = np.exp(2j * np.pi * fc * np.arange(n)).astype(np.complex64)
q = resamp((num, den))
y, _ = q(jnp.asarray(x), batch_shape=())
y = np.asarray(y)
print(f"{n} samples in -> {len(y)} out (expect {n*num//den})")
f_out = np.argmax(np.abs(np.fft.fft(y))) / len(y)
print(f"tone at {fc} cycles/sample in -> {f_out:.4f} out "
      f"(expect {fc * den / num:.4f})")
