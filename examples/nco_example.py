"""NCO basics: tone synthesis, table vs exact oscillator, mixing
(reference nco_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax.numpy as jnp
from liquid_dsp_tpu.ops.nco import nco

dphi, n = 0.3, 1024
ones = jnp.ones(n, jnp.complex64)

# mixing a DC signal up synthesizes the oscillator itself
q = nco(dphi, theta0=0.0, direction="up")
tone, _ = q(ones, batch_shape=())
tone = np.asarray(tone)
ref = np.exp(1j * dphi * np.arange(n))
print(f"VCO mode (exact sincos): max error vs e^(j dphi t) = "
      f"{np.abs(tone - ref).max():.2e}")
assert np.abs(tone - ref).max() < 1e-4  # float32 phase accumulation

# table=True reproduces the reference 256-entry LIQUID_NCO quantization
qt = nco(dphi, table=True, direction="up")
tone_t, _ = qt(ones, batch_shape=())
err_t = np.abs(np.asarray(tone_t) - ref).max()
print(f"NCO mode (256-entry table): max error {err_t:.4f} "
      f"(quantized to 2pi/256 phase steps)")
assert 1e-5 < err_t < 0.03

# down-mix undoes up-mix; carry continues the phase across blocks
qd = nco(dphi, direction="down")
half = n // 2
y1, c = qd(jnp.asarray(ref[:half].astype(np.complex64)), batch_shape=())
y2, _ = qd(jnp.asarray(ref[half:].astype(np.complex64)), carry=c)
y = np.concatenate([np.asarray(y1), np.asarray(y2)])
print(f"block-streamed down-mix flattens the tone: "
      f"std {np.abs(y - 1).max():.2e}")
assert np.abs(y - 1).max() < 1e-4
