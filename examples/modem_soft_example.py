"""Soft-decision demodulation: exact max-log LLRs vs hard decisions
(reference modem_soft_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
import jax
import jax.numpy as jnp
from liquid_dsp_tpu.modem.linear import (constellation, modulate,
                                         demodulate, demodulate_soft,
                                         soft_to_hard, bits_per_symbol)
from liquid_dsp_tpu.utils.random import jax_crandn

scheme = "qam16"
table = constellation(scheme)
bps = bits_per_symbol(scheme)
rng = np.random.default_rng(1)
syms = rng.integers(0, 1 << bps, 10000)
x = modulate(table, jnp.asarray(syms))

snr_db = 12.0
nstd = 10 ** (-snr_db / 20)
y = x + nstd * jax_crandn(jax.random.PRNGKey(4), x.shape)

# soft LLRs agree with the hard slicer at their signs
llr = demodulate_soft(table, y, noise_var=nstd ** 2)
s_soft = np.asarray(soft_to_hard(llr))
s_hard = np.asarray(demodulate(table, y))
agree = float(np.mean(s_soft == s_hard))
ser = float(np.mean(s_hard != syms))
print(f"{scheme} @ {snr_db:.0f} dB: SER {ser:.4f}, "
      f"soft/hard agreement {agree:.4f}")

# LLR magnitude is confidence: erroneous symbols carry weaker bits
llr_np = np.asarray(llr).reshape(-1, bps)
conf = np.abs(llr_np).min(axis=1)
wrong = s_hard != syms
print(f"mean min-|LLR|: correct symbols {conf[~wrong].mean():.2f}, "
      f"errored symbols {conf[wrong].mean():.2f}")
assert agree == 1.0 and conf[wrong].mean() < conf[~wrong].mean()
