"""Special math functions used by filter design (host-side NumPy, float64).

Behavioral parity targets: reference src/math/src/math.bessel.c (Bessel
functions), src/math/src/math.c (Q-function, sinc, gamma helpers).  The
implementations here are standard series/identities in float64 — the
reference computes in float32; all conformance tests are tolerance-based
(tol=1e-3), so higher precision here is strictly better.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = [
    "lngamma", "gamma", "lnbesseli", "besseli", "besseli0", "besselj",
    "besselj0", "sinc", "qfunction", "nextpow2", "is_prime", "factor",
    "unique_factor", "totient", "gcd", "modpow", "primitive_root_prime",
    "factorial", "lnlowergamma", "lowergamma", "lnuppergamma",
    "uppergamma", "nchoosek", "marcumq1",
]


def lngamma(z):
    return np.vectorize(math.lgamma)(np.asarray(z, dtype=np.float64))


def gamma(z):
    return np.vectorize(math.gamma)(np.asarray(z, dtype=np.float64))


def lnlowergamma(z, alpha):
    """log of the lower incomplete gamma function ln(gamma(z, alpha))
    (reference src/math/src/math.gamma.c liquid_lnlowergammaf): series
    gamma(z,a) = a^z Gamma(z) e^-a sum_k a^k / Gamma(z+k+1)."""
    z = np.asarray(z, dtype=np.float64)
    alpha = np.asarray(alpha, dtype=np.float64)

    def _one(zz, aa):
        if aa <= 0.0:
            return -np.inf
        la = math.log(aa)
        # accumulate the series in LOG space (running logsumexp): the
        # terms reach exp(~aa), which overflows linear float64 for
        # alpha >~ 710 well inside the CDF callers' domains
        ls = -np.inf
        tmax = -np.inf
        tprev = -np.inf
        for k in range(4096):
            t = k * la - math.lgamma(zz + k + 1.0)
            if ls == -np.inf:
                ls = t
            elif t > ls:
                ls = t + math.log1p(math.exp(ls - t))
            else:
                ls = ls + math.log1p(math.exp(t - ls))
            tmax = max(tmax, t)
            if k > 50 and tprev > t and (tmax - t) > 40.0:
                break
            tprev = t
        return zz * la + math.lgamma(zz) - aa + ls

    return np.vectorize(_one)(z, alpha)


def lowergamma(z, alpha):
    """gamma(z, alpha), lower incomplete (reference liquid_lowergammaf)."""
    return np.exp(lnlowergamma(z, alpha))


def lnuppergamma(z, alpha):
    """log Gamma(z, alpha), upper incomplete (liquid_lnuppergammaf)."""
    return np.log(np.maximum(gamma(z) - lowergamma(z, alpha), 1e-300))


def uppergamma(z, alpha):
    """Gamma(z, alpha), upper incomplete (liquid_uppergammaf)."""
    return np.exp(lnuppergamma(z, alpha))


def nchoosek(n: int, k: int) -> float:
    """Binomial coefficient (reference liquid_nchoosek, math.c).  The
    reference switches to a rounded-lgamma identity for n > 12, which
    is off by one ULP-of-exp for many (n, k) (e.g. C(48,23)); python's
    exact math.comb has no such failure, so it is used throughout —
    tolerance-based parity, strictly more accurate."""
    if k > n:
        raise ValueError("k cannot exceed n")
    return float(math.comb(n, k))


def marcumq1(alpha, beta, iterations: int | None = None):
    """Marcum Q_1(alpha, beta) via the Bessel series
    Q_1(a,b) = exp(-(a^2+b^2)/2) sum_k (a/b)^k I_k(ab)
    (reference liquid_MarcumQ1f, src/math/src/math.c:95-123)."""
    alpha = np.asarray(alpha, dtype=np.float64)
    beta = np.asarray(beta, dtype=np.float64)
    # series in LOG space: term_k = k*ln(a/b) + ln I_k(ab); the
    # reference accumulates linearly in float32 (math.c:95-123), which
    # overflows for a >> b — the log form is the same sum, stable
    t0 = -0.5 * (alpha * alpha + beta * beta)
    beta_safe = np.where(beta > 0, beta, 1.0)
    with np.errstate(divide="ignore"):
        ln_ab_ratio = np.log(alpha) - np.log(beta_safe)
    a_mul_b = alpha * beta_safe
    if iterations is None:
        # I_k(ab) stays significant up to order k ~ ab; a fixed 64-term
        # cut gave percent-level CDF error for ab > ~400
        ab_max = float(np.max(a_mul_b)) if a_mul_b.size else 0.0
        iterations = max(64, int(ab_max + 10.0 * math.sqrt(ab_max + 1.0)) + 1)
    # ln I_k over ALL orders k with ONE shared log-factorial table:
    # calling lnbesseli per order rebuilds its own lgamma table per
    # call, which makes the host cost O((ab)^2) lgamma evaluations
    # (3.3 s at ab ~ 3500); the shared-table form is the identical sum.
    half = 0.5 * (float(np.max(a_mul_b)) if a_mul_b.size else 0.0)
    J = max(64, int(half + 9.0 * math.sqrt(half + 1.0)) + 8)
    # lgamma(n + 1) for n = 0 .. iterations + J via cumulative log sums
    lgt = np.concatenate([[0.0], np.cumsum(
        np.log(np.arange(1.0, iterations + J + 1.0)))])
    ab_safe = np.where(a_mul_b > 0, a_mul_b, 1.0)
    zl = np.log(0.5 * ab_safe).reshape(-1)          # [Z]
    js = np.arange(J, dtype=np.float64)[:, None]    # [J, 1]
    lnI = np.empty((iterations,) + zl.shape, np.float64)
    for k in range(iterations):
        t = (2.0 * js + k) * zl[None, :] - lgt[:J, None] \
            - lgt[k: k + J, None]
        tm = np.max(t, axis=0)
        lnI[k] = tm + np.log(np.sum(np.exp(t - tm), axis=0))
    lnI = lnI.reshape((iterations,) + a_mul_b.shape)
    lnI = np.where((a_mul_b == 0)[None],
                   np.where(np.arange(iterations).reshape(
                       (-1,) + (1,) * a_mul_b.ndim) == 0, 0.0, -np.inf),
                   lnI)                              # I_0(0)=1, I_k(0)=0
    ks_col = np.arange(iterations, dtype=np.float64).reshape(
        (-1,) + (1,) * ln_ab_ratio.ndim)
    with np.errstate(invalid="ignore"):
        kterm = np.where(ks_col == 0, 0.0, ks_col * ln_ab_ratio[None])
    terms = kterm + lnI
    terms = np.where(np.isnan(terms), -np.inf, terms)
    tmax = np.max(terms, axis=0)
    y = np.exp(tmax + np.log(np.sum(np.exp(terms - tmax), axis=0)) + t0)
    # Q1(a, 0) = 1 exactly (integral over an empty lower tail)
    return np.where(beta <= 0, 1.0, np.clip(y, 0.0, 1.0))


def lnbesseli(nu: float, z, iterations: int | None = None):
    """log I_nu(z) via the ascending series (reference math.bessel.c:41).
    Term count scales with the argument: the series' largest term sits
    near k ~ z/2, so a fixed cut silently truncates for large z."""
    z = np.asarray(z, dtype=np.float64)
    out = np.zeros_like(z)
    nz = z != 0
    if iterations is None:
        zmax = float(np.max(np.abs(z))) if z.size else 0.0
        half = 0.5 * zmax
        iterations = max(64, int(half + 9.0 * math.sqrt(half + 1.0)) + 8)
    zl = np.log(0.5 * np.where(nz, z, 1.0))
    # log-sum-exp over the series: linear accumulation of exp(t)
    # underflows for large order (every term < e^-745 -> 0) and
    # overflows for z > ~1400 — both silent and badly wrong
    ks = np.arange(iterations, dtype=np.float64)
    lg = np.array([math.lgamma(k + 1.0) + math.lgamma(nu + k + 1.0)
                   for k in range(iterations)])
    t = (2.0 * ks[:, None] * zl.reshape(1, -1)
         - lg[:, None])                       # [iterations, z.size]
    tmax = np.max(t, axis=0)
    lse = tmax + np.log(np.sum(np.exp(t - tmax), axis=0))
    out = np.where(nz, nu * zl + lse.reshape(z.shape), 0.0)
    if nu == 0.0:
        out = np.where(nz, out, 0.0)  # ln I_0(0) = 0
    return out


def besseli(nu: float, z):
    return np.exp(lnbesseli(nu, z))


def besseli0(z):
    """I_0(z), modified Bessel first kind order 0 (math.bessel.c:86)."""
    return besseli(0.0, z)


def besselj(nu: float, z, iterations: int = 128):
    """J_nu(z), Bessel function of the first kind (alternating series)."""
    z = np.asarray(z, dtype=np.float64)
    y = np.zeros_like(z)
    half = 0.5 * np.abs(z)
    with np.errstate(divide="ignore"):
        lh = np.where(half > 0, np.log(np.where(half > 0, half, 1.0)), -np.inf)
    for k in range(iterations):
        ln_t = (nu + 2 * k) * lh - math.lgamma(k + 1) - math.lgamma(nu + k + 1)
        y += (-1.0) ** k * np.exp(ln_t)
    return np.where(z == 0, 1.0 if nu == 0 else 0.0, y)


def besselj0(z):
    return besselj(0.0, z)


def sinc(x):
    """Normalized sinc sin(pi x)/(pi x) (matches reference sincf)."""
    return np.sinc(np.asarray(x, dtype=np.float64))


def qfunction(x):
    """Gaussian tail Q(x) = 0.5 erfc(x/sqrt 2) (reference math.c)."""
    return 0.5 * np.vectorize(math.erfc)(np.asarray(x, dtype=np.float64) / math.sqrt(2))


def nextpow2(n: int) -> int:
    """Smallest k with 2**k >= n."""
    if n < 1:
        raise ValueError("nextpow2 requires n >= 1")
    return int(math.ceil(math.log2(n)))


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    f = 3
    while f * f <= n:
        if n % f == 0:
            return False
        f += 2
    return True


def factor(n: int) -> list:
    """Prime factorization (with multiplicity), ascending."""
    if n < 1:
        raise ValueError("factor requires n >= 1")
    out, f = [], 2
    while n > 1:
        while n % f == 0:
            out.append(f)
            n //= f
        f += 1 if f == 2 else 2
        if f * f > n and n > 1:
            out.append(n)
            break
    return out


def totient(n: int) -> int:
    """Euler totient (reference src/math/src/modular_arithmetic.c)."""
    result, p = n, 2
    m = n
    while p * p <= m:
        if m % p == 0:
            while m % p == 0:
                m //= p
            result -= result // p
        p += 1
    if m > 1:
        result -= result // m
    return result


def gcd(a: int, b: int) -> int:
    return math.gcd(a, b)


def unique_factor(n: int) -> list:
    """Distinct prime factors, ascending (reference liquid_unique_factor,
    src/math/src/modular_arithmetic.c)."""
    return sorted(set(factor(n)))


def modpow(base: int, exp: int, n: int) -> int:
    """base**exp mod n (reference liquid_modpow,
    src/math/src/modular_arithmetic.c)."""
    return pow(int(base), int(exp), int(n))


def primitive_root_prime(n: int) -> int:
    """Smallest primitive root of prime n (reference
    liquid_primitive_root_prime, src/math/src/modular_arithmetic.c).
    Used by Rader-style prime-length FFT reasoning; checks g**((n-1)/p)
    != 1 for every distinct prime p | n-1."""
    if not is_prime(n):
        raise ValueError("primitive_root_prime requires a prime n")
    if n == 2:
        return 1
    probes = [(n - 1) // p for p in unique_factor(n - 1)]
    for g in range(2, n):
        if all(pow(g, e, n) != 1 for e in probes):
            return g
    raise ValueError(f"no primitive root found for {n}")  # unreachable


def factorial(n: int) -> float:
    """n! as float (reference liquid_factorialf uses gamma for large n)."""
    return math.gamma(float(n) + 1.0)
