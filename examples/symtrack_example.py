"""Blind symbol recovery with symtrack: AGC -> timing -> carrier PLL ->
decision-directed equalizer, no training data
(reference symtrack_cccf_example.c).

A QPSK stream is RRC-shaped, passed through a channel with gain error,
carrier offset, and noise; symtrack recovers a clean constellation.

Run: python examples/symtrack_example.py
"""
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax.numpy as jnp

from liquid_dsp_tpu.framing.symtrack import symtrack
from liquid_dsp_tpu.ops.fir import firinterp
from liquid_dsp_tpu.design.firdes import firdes_prototype
from liquid_dsp_tpu.modem import constellation, modulate


def main():
    rng = np.random.default_rng(42)
    n_sym, k, m, beta = 4000, 2, 7, 0.3

    # --- transmit: QPSK through an RRC interpolator ---
    syms = rng.integers(0, 4, n_sym)
    tx_sym = np.asarray(modulate(constellation("qpsk"), jnp.asarray(syms)))
    interp = firinterp(k, firdes_prototype("rrcos", k, m, beta))
    x, _ = interp(jnp.asarray(tx_sym.astype(np.complex64)), batch_shape=())
    x = np.asarray(x)

    # --- channel: gain error + carrier offset + noise ---
    t = np.arange(len(x))
    y = 0.25 * x * np.exp(1j * (0.02 * t + 0.7))
    y += 0.005 * (rng.standard_normal(len(y)) +
                  1j * rng.standard_normal(len(y)))

    # --- blind recovery ---
    out = symtrack(jnp.asarray(y.astype(np.complex64)), ms="qpsk",
                   ftype="rrcos", k=k, m=m, beta=beta)
    v = np.asarray(out.symbols)[-1000:]  # post-convergence symbols

    # EVM vs nearest QPSK point
    table = np.asarray(constellation("qpsk"))
    d = np.abs(v[:, None] - table[None, :]).min(axis=1)
    evm_db = 20 * np.log10(np.sqrt(np.mean(d ** 2)) + 1e-12)
    print(f"recovered {len(v)} symbols; EVM {evm_db:.1f} dB")
    assert evm_db < -15, "symtrack failed to converge"
    print("constellation recovered (blind): OK")


if __name__ == "__main__":
    main()
