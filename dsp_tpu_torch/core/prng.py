"""PRNG / TPDF noise (reference: util.h:127-178), and jax's threefry keys.

Host side reproduces the reference's Park-Miller (Lehmer) generators exactly
(A=48271 for pm_rand1, A=16807 for pm_rand2, modulus 2^31-1) for deterministic
tests. TPDF noise is the difference of the two generators scaled by
``tpdf_dither_get_mult(prec)``. The port's offline CLI draws its app-level
dither on the host with these generators (OutputWriter).

The device noise of the noise, dither and modulated-delay effects is
dsp_tpu's: ``jax.random.split`` and ``jax.random.uniform`` over a threefry
key, with jax's partitionable counters (the default,
``jax_threefry_partitionable``). Both come down to one threefry2x32 call per
element, keyed by the key and fed the element's flat index split into
(hi, lo) words, so each element's bits stand alone:

* ``split(key, n)[i] = threefry2x32(key, (0, i))``;
* ``uniform(key, shape, float64, maxval)`` takes the 64 bits
  ``(x0 << 32) | x1`` of flat element i, keeps the top 52 as the mantissa
  of a float in [1, 2), subtracts 1 and scales by maxval;
* ``uniform(key, shape, float32, maxval)`` takes the 32 bits ``x0 ^ x1``,
  keeps the top 23 as the mantissa, subtracts 1 and scales by
  ``float32(maxval)``, all in float32. The two dtypes draw different
  numbers from one key, so a float32 chain's noise is not its float64
  chain's noise rounded.

The functions below are that arithmetic on int64 tensors masked to 32 bits
(the plain version; ``csrc/threefry.cuh`` is the kernels' copy). Keys are
``torch.uint32`` tensors of shape [2], jax's raw key layout, so a key in a
dsp_tpu checkpoint continues the same stream here.
"""

import numpy as np
import torch

PM_RAND_MAX = 0x7FFFFFFF
MASK32 = 0xFFFFFFFF


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


# --- jax's threefry2x32 (plain version) -------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed):
    """jax.random.PRNGKey(seed): uint32 [seed >> 32, seed & 0xFFFFFFFF]."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32], dtype=torch.uint32)


def threefry2x32(k0, k1, x0, x1):
    """jax's threefry2x32 block cipher: 20 rounds in 5 groups of 4, key
    injections k0, k1, k2 = k0 ^ k1 ^ 0x1BD11BDA with + (i + 1) on the
    second word. Every argument is an int64 tensor (or int) holding 32-bit
    values; the result is two int64 tensors of 32-bit values."""
    k0 = torch.as_tensor(k0, dtype=torch.int64)
    k1 = torch.as_tensor(k1, dtype=torch.int64)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (torch.as_tensor(x0, dtype=torch.int64) + ks[0]) & MASK32
    x1 = (torch.as_tensor(x1, dtype=torch.int64) + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) & MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _key_words(key):
    key = key.to(torch.int64)
    return key[0], key[1]


def split(key, n=2):
    """jax.random.split(key, n) with partitionable counters: [n, 2] uint32,
    row i = threefry2x32(key, (0, i))."""
    k0, k1 = _key_words(key)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
    return torch.stack([b0, b1], dim=1).to(torch.uint32)


def uniform_f64(key, shape, maxval):
    """jax.random.uniform(key, shape, float64, minval=0, maxval=maxval): the
    top 52 of element i's 64 bits threefry2x32(key, (i >> 32, i & mask)) as
    a mantissa, (1.m - 1) * maxval."""
    n = int(np.prod(shape, dtype=np.int64))
    return uniform_f64_at(key, torch.arange(n, dtype=torch.int64, device=key.device),
                          maxval).reshape(shape)


def uniform_f64_at(key, i, maxval):
    """Elements i (an int64 tensor of counters) of uniform_f64's draws. The
    mantissa is built as (x0 << 20) | (x1 >> 12), since int64 shifts right
    arithmetically."""
    k0, k1 = _key_words(key)
    x0, x1 = threefry2x32(k0, k1, i >> 32, i & MASK32)
    mant = (x0 << 20) | (x1 >> 12)  # < 2^52: exact in float64
    u = mant.to(torch.float64) * 2.0**-52  # exact: (1.m - 1)
    return u * float(maxval)


def uniform_f32(key, shape, maxval):
    """jax.random.uniform(key, shape, float32, minval=0, maxval=maxval): the
    top 23 of element i's 32 bits x0 ^ x1 of threefry2x32(key, (i >> 32,
    i & mask)) as a mantissa, (1.m - 1) · float32(maxval) in float32."""
    n = int(np.prod(shape, dtype=np.int64))
    return uniform_f32_at(key, torch.arange(n, dtype=torch.int64, device=key.device),
                          maxval).reshape(shape)


def uniform_f32_at(key, i, maxval):
    """Elements i (an int64 tensor of counters) of uniform_f32's draws."""
    k0, k1 = _key_words(key)
    x0, x1 = threefry2x32(k0, k1, i >> 32, i & MASK32)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000  # 1.m, below 2^31: fits int32
    u = bits.to(torch.int32).view(torch.float32) - 1.0  # exact
    return u * torch.tensor(maxval, dtype=torch.float32, device=key.device)
