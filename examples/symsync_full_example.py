"""Full symbol-synchronizer scenario: timing phase offset AND a clock
rate mismatch applied with the library's own polyphase resampler, plus
channel noise — the synchronizer tracks both while the matched filter
rejects the noise (reference symsync_crcf_full_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.design.firdes import firdes_prototype
from liquid_dsp_tpu.ops.fir import firinterp
from liquid_dsp_tpu.ops.resample import resamp
from liquid_dsp_tpu.ops.symsync import symsync
from liquid_dsp_tpu.ops.channel import channel
from liquid_dsp_tpu.modem import constellation, modulate

rng = np.random.default_rng(5)
k, m, beta, n_sym = 2, 5, 0.3, 3000
table = constellation("qpsk")
syms = np.asarray(modulate(table, jnp.asarray(
    rng.integers(0, 4, n_sym).astype(np.int32))))

# TX: root-Nyquist interpolation
h = firdes_prototype("arkaiser", k, m, beta)
x, _ = firinterp(k, h)(jnp.asarray(syms.astype(np.complex64)),
                       batch_shape=())
x = np.asarray(x)

# clock mismatch ~300 ppm via the polyphase arbitrary resampler
num, den = 3333, 3334
pad = (-len(x)) % den
xp = np.concatenate([x, np.zeros(pad, np.complex64)])
xr, _ = resamp((num, den), m=9, fc=0.45, as_db=80.0)(
    jnp.asarray(xp), batch_shape=())

# timing phase offset + AWGN
tau = 0.45
xr = np.asarray(xr)
X = np.fft.fft(xr)
f = np.fft.fftfreq(len(xr))
xd = np.fft.ifft(X * np.exp(-2j * np.pi * f * tau)).astype(np.complex64)
y_ch, _ = channel(snr_db=30.0, seed=2)(jnp.asarray(xd), batch_shape=())
# the channel op scales the signal by gamma = 10^((floor+SNR)/20)
# (reference channel.c _add_awgn semantics); undo it exactly — in a
# real receiver the AGC does this
gamma = 10.0 ** ((-60.0 + 30.0) / 20.0)
y_ch = (np.asarray(y_ch) / gamma).astype(np.complex64)

# RX: matched-filter polyphase symbol synchronizer
q = symsync("arkaiser", k, m, beta, bw=0.02)
(sy, sv), _ = q(jnp.asarray(y_ch), batch_shape=())
y = np.asarray(sy)[np.asarray(sv)]

# the zero-pad added for the resampler trails the real data; measure a
# converged window that is still inside the transmitted symbols
tail = y[n_sym - 800:n_sym - 100]
d = np.abs(tail[:, None] - np.asarray(table)[None, :]).min(axis=1)
print(f"symsync full: ~300 ppm clock skew + tau={tau} + 30 dB SNR")
print(f"  {len(y)} symbols out ({n_sym} sent + resampler zero-pad)")
print(f"  post-convergence RMS symbol error: {np.sqrt(np.mean(d**2)):.4f}")
