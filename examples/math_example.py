"""Special math functions: gamma/Bessel/sinc/Q and integer utilities
(reference math_lngamma_example.c / math_primitive_root_example.c)."""
import pathlib, sys
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np
from liquid_dsp_tpu.design.special import (lngamma, gamma, besseli0, besselj0,
                                           sinc, qfunction, is_prime, factor,
                                           totient, nextpow2)

print("z, lngamma(z), gamma(z):")
for z in (0.5, 1.0, 2.5, 6.0):
    print(f"  {z:4.1f}  {float(lngamma(z)):+9.4f}  {float(gamma(z)):10.4f}")
print(f"gamma(0.5)^2 = {float(gamma(0.5)) ** 2:.5f} (pi = {np.pi:.5f})")

print(f"besseli0(1.5) = {float(besseli0(1.5)):.5f}, "
      f"besselj0(2.4048) = {float(besselj0(2.4048)):+.5f} (first root)")
print(f"sinc(0) = {float(sinc(0.0)):.3f}, sinc(1) = {float(sinc(1.0)):.3e}")
print(f"Q(0) = {float(qfunction(0.0)):.3f}, Q(3) = {float(qfunction(3.0)):.5f}")

n = 280
print(f"{n}: prime={is_prime(n)}, factors={factor(n)}, "
      f"totient={totient(n)}, nextpow2={nextpow2(n)}")
