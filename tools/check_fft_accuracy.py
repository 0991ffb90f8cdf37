#!/usr/bin/env python
"""On-backend FFT accuracy spot-check for the non-pow2 method chooser.

The matmul-DFT / four-step-CT paths run einsums whose DEFAULT
precision on a GPU may be TF32 (~2^-11 relative) — below the
float32-tolerance contract of an FFT and the 1e-3 golden tolerance.
ops/fft.py pins `precision=lax.Precision.HIGHEST`; THIS tool verifies
the claim on whatever backend is live (the CPU suite cannot see the
card's matmul precision), printing max relative error vs a float64
numpy reference for each method-chooser family.

Run: python tools/check_fft_accuracy.py
Pass criterion: max relative L_inf error < 1e-4 per size (float32
round-trip territory; the reference golden tolerance is 1e-3 abs).
"""
import sys
import pathlib

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    import jax
    import jax.numpy as jnp
    from liquid_dsp_tpu.ops.fft import fft, ifft

    rng = np.random.default_rng(7)
    # one size per method-chooser family + the large-odd edge cases
    sizes = [1024,          # radix-2 (XLA native)
             96, 384, 1200, 1536000,  # composite -> four-step CT
             127, 509, 1021, 2043,    # odd/prime -> matmul DFT
             4099, 9973]              # large prime -> Bluestein
    print(f"# backend={jax.default_backend()}  "
          "(max |y - y64| / max|y64|, forward + inverse)")
    worst = 0.0
    for n in sizes:
        batch = max(1, (1 << 18) // n)
        xr = rng.standard_normal((batch, n)).astype(np.float32)
        xi = rng.standard_normal((batch, n)).astype(np.float32)
        x64 = xr.astype(np.float64) + 1j * xi.astype(np.float64)
        y64 = np.fft.fft(x64)
        z64 = np.fft.ifft(x64) * n   # reference convention: unnormalized

        @jax.jit
        def both(r, i):
            x = jax.lax.complex(r, i)
            y = fft(x)
            z = ifft(x)
            return (jnp.real(y), jnp.imag(y), jnp.real(z), jnp.imag(z))

        yr, yi, zr, zi = (np.asarray(a, dtype=np.float64)
                          for a in both(jnp.asarray(xr), jnp.asarray(xi)))
        scale_f = np.abs(y64).max()
        scale_b = np.abs(z64).max()
        ef = np.abs((yr + 1j * yi) - y64).max() / scale_f
        eb = np.abs((zr + 1j * zi) - z64).max() / scale_b
        err = max(ef, eb)
        worst = max(worst, err)
        kind = ("radix-2" if n & (n - 1) == 0 else
                "bluestein" if (n % 2 == 1 and n > 2048) else
                "matmul-dft" if n % 2 == 1 else "4-step-ct")
        flag = "" if err < 1e-4 else "  <-- FAIL (>1e-4)"
        print(f"fft n={n:7d} [{kind:10s}] batch={batch:5d}: "
              f"rel_err={err:.3e}{flag}")
    ok = worst < 1e-4
    print(f"# worst={worst:.3e}  {'PASS' if ok else 'FAIL'} "
          "(criterion 1e-4; golden tolerance 1e-3)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
