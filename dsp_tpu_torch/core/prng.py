"""PRNG / TPDF noise (reference: util.h:127-178).

Host side reproduces the reference's Park-Miller (Lehmer) generators exactly
(A=48271 for pm_rand1, A=16807 for pm_rand2, modulus 2^31-1) for deterministic
tests. TPDF noise is the difference of the two generators scaled by
``tpdf_dither_get_mult(prec)``.

The port's offline CLI draws its app-level dither on the host with these
generators (OutputWriter). A device noise source comes with the noise and
dither effects, which are not ported yet.
"""

import numpy as np

PM_RAND_MAX = 0x7FFFFFFF


class PmRand:
    """Park-Miller MINSTD generator: s' = (s * A) mod (2^31 - 1)."""

    def __init__(self, a, seed=1):
        self.a = a
        self.s = np.uint64(seed)

    def next(self):
        p = int(self.s) * self.a
        r = (p & 0x7FFFFFFF) + (p >> 31)
        r = (r & 0x7FFFFFFF) + (r >> 31)
        self.s = np.uint64(r)
        return r

    _pow_cache = {}  # (a, n) -> A^(j+1) mod M table

    def block(self, n):
        """Generate n values as an int64 array (host-side), vectorized via
        modular jump-ahead: out[j] = s0 * A^(j+1) mod M. Both factors are
        < 2^31, so the int64 products (< 2^62) are exact — the 53-bit
        mantissa limitation applies only to float64. The A^j table is built
        once per (a, n) and cached; this runs on the output dither hot path
        (OutputWriter.write) for every block."""
        key = (self.a, n)
        tbl = PmRand._pow_cache.get(key)
        if tbl is None:
            tbl = np.empty(n, dtype=np.int64)
            p = 1
            for i in range(n):
                p = (p * self.a) % 0x7FFFFFFF
                tbl[i] = p
            PmRand._pow_cache[key] = tbl
        out = (int(self.s) * tbl) % 0x7FFFFFFF
        self.s = np.uint64(out[-1]) if n else self.s
        return out


def pm_rand1(seed=1):
    return PmRand(48271, seed)


def pm_rand2(seed=1):
    return PmRand(16807, seed)


def tpdf_dither_get_mult(prec):
    """Scale for TPDF dither at a precision of ``prec`` bits (util.h:157-163)."""
    if prec < 1 or prec > 32:
        return 0.0
    d = 1 << (prec - 1)
    return 1.0 / (float(PM_RAND_MAX) * d)


class TpdfNoise:
    """Host-side TPDF noise source: (pm_rand1 - pm_rand2) * mult (util.h:165-178)."""

    def __init__(self, seed1=1, seed2=1):
        self.g1 = pm_rand1(seed1)
        self.g2 = pm_rand2(seed2)

    def block(self, n, mult):
        return (self.g1.block(n) - self.g2.block(n)).astype(np.float64) * mult
