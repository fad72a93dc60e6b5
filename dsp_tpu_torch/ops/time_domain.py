"""The time-domain kernels of slices C and J4, their wrappers and plain
versions.

* K18-noise ``tpdf_noise`` (dsp_tpu/effects/noise.py:51): x + TPDF noise.
* K15 ``tpdf_dither`` (dsp_tpu/effects/dither.py:107): TPDF dither, flat or
  with 9-tap error feedback.
* K16 ``stats_step`` (dsp_tpu/effects/stats.py:159, :197, :266): the stats
  accumulators, plain or with the gated true-peak estimator (``-i``).
* K17 ``levels_step`` (dsp_tpu/effects/levels.py:62): the RMS and peak meters.
* K14 ``mod_delay`` (dsp_tpu/effects/delay.py:292, :337): the modulator and
  the interpolated read of the modulated delay line.

Each takes float64 tensors and hands float32 ones to its float32 entry,
``<name>_f32`` (slice J4), which refuses float64, as the float64 entry
refuses a float32 leaf among float64 ones, on every device. Each entry
dispatches on the tensor's device only: a CPU tensor runs the plain version
``<name>_ref`` / ``<name>_f32_ref`` (``stats_step_ref`` serves both), a
CUDA tensor launches the kernel in
``dsp_tpu_torch/csrc/`` (tpdf.cu, stats.cu, levels.cu, mod_delay.cu) or
raises. Each counts its launches in ``<entry>.launches``. Noise comes from
jax's threefry (core/prng.py), so both paths draw dsp_tpu's numbers: its
float64 uniform in float64, its float32 uniform (other bits) in float32.

dsp_tpu runs these steps through XLA, whose CPU backend contracts a + b·c
into one fused multiply-add wherever a product feeds a sum in one fusion
(measured: the flat dither's x + (u1 - u2)·n_mult, noise's x + (u1 -
u2)·mult when every channel is selected, the -i estimator's M + x·H,
M[k] + c_k·x and yq = y - dy·p4), but not across a select (noise on some
channels, x + where(sel, ·, 0)) nor in the float64 error-feedback dot. The
plain versions and the kernels take an FMA exactly there (``torch.addcmul``,
``_fma``, ``_fma32``, ``__fma_rn``) and round every other product and sum
on its own, so the noise, the dither's output and every stats decision
equal dsp_tpu's, in both dtypes.

The float32 forms: each value follows one of two routes.

* float32 arithmetic, each operation rounded as dsp_tpu float32 rounds it,
  wherever a value feeds a draw or a decision: the noise; the dither's
  quantizer and its error feedback; stats' comparisons (min, max, peak,
  the peak count and frame) and the whole -i estimator (its gate, buffer,
  fits and vertex); the modulator (knots, B-spline, the read position's
  integer part and polyphase phase). Where XLA:CPU's own float32 choices
  change with the fusion around them, the port keeps one order, so some
  values differ from dsp_tpu float32's in their last bits (measured): the
  multi-tap feedback dot (an FMA chain for lipshitz at B = 2048, in order
  at B = 1000; the port sums in order, each product rounded), and the
  modulator's knot sums and B-spline (FMAs that differ between the
  effect's own jit and a copy of it; the port takes none): its z within
  2 ulps of dsp_tpu float32's.
* read float32, carry float64, store float32 (PR 6's route) where nothing
  is decided: stats' sums and sums of squares, levels' meters (its scan
  in float64 with g unrounded), and the modulated delay's interpolating
  read (Hermite or polyphase taps and their B-spline).

The serial recurrences (the shaped dither, ``stats -i``) have plain versions
that loop over samples on the host (Python floats for float64, numpy
float32 scalars for float32); they take tensors on any device and return
them on the input's device.

The stream axis (batched processing): each entry takes x [S, B, C] (stats
and levels: xs [S, B, n]) with every state leaf led by S (the noise key
[S, 2], stats' samples and limit [S], the delay's phase [S]) and returns
the new state the same way; the effect's constants (selectors, gains,
taps, tables) stay one for all streams. A CUDA tensor runs the S streams
in the one launch of a one-stream call, each stream with that call's
bits, from the same one pass of checks, one allocation of the outputs and
one ctypes call; a CPU tensor runs the plain version a stream at a time
(fft_conv.each_stream), so each stream is a one-stream call bit for bit.
"""

import functools
import math
import struct

import numpy as np
import torch

from dsp_tpu_torch import kernels
from dsp_tpu_torch.core import prng
from dsp_tpu_torch.core.prng import PM_RAND_MAX
from dsp_tpu_torch.ops.fft_conv import (_check_cuda, _check_dtypes, _check_shape, _launch_ptrs,
                                        each_stream)
from dsp_tpu_torch.ops.m4_engine import fma_ref

# tpdf_dither modes: flat (no feedback), shaped (9-tap error feedback on
# TPDF noise), sloped2 (error feedback on first-difference noise)
DITHER_FLAT, DITHER_SHAPED, DITHER_SLOPED2 = 0, 1, 2
DITHER_TAPS = 9

STATS_INTERP_DELAY = 18  # stats.c:76
NO_LIMIT = 1 << 62

MOD_NOISE_N = 6  # uniform pairs summed per knot (delay.c:505-543)
MOD_MAXVAL = float(0x7FFFFFFF)


def _fma(a, b, c):
    """a·b + c rounded once (IEEE fused multiply-add) on Python floats:
    exact integer arithmetic, then Python's correctly rounded int / int."""
    na, da = a.as_integer_ratio()
    nb, db = b.as_integer_ratio()
    nc, dc = c.as_integer_ratio()
    r = (na * nb * dc + nc * da * db) / (da * db * dc)
    return r if r != 0.0 else a * b + c  # an exact zero takes IEEE's sign


def _rint(v):
    """jnp.round / CUDA rint on a Python float: ties to even, sign kept."""
    return math.copysign(float(round(v)), v) if math.isfinite(v) else v


def _fma32(a, b, c):
    """a·b + c rounded once to float32 (CUDA's __fmaf_rn) on float32
    tensors: the product is exact in float64, and the float64 sum is
    rounded to odd (TwoSum's error moves an even result one ulp toward the
    exact sum), so its one rounding to float32 is the correct one."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    odd = torch.nextafter(s, torch.copysign(torch.full_like(s, math.inf), err))
    return torch.where((err != 0) & ((s.view(torch.int64) & 1) == 0), odd, s).to(torch.float32)


def _fma32_np(a, b, c):
    """_fma32 on numpy float32 arrays (the -i estimator's 64-slot buffer, a
    sample at a time)."""
    p = a.astype(np.float64) * b
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    fix = (err != 0) & ((s.view(np.int64) & 1) == 0)
    if fix.any():
        s = np.where(fix, np.nextafter(s, np.copysign(np.inf, err)), s)
    return s.astype(np.float32)


def _fma32s(a, b, c):
    """_fma32 on numpy float32 scalars."""
    a, b, c = float(a), float(b), float(c)
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    if err != 0 and not struct.unpack("<q", struct.pack("<d", s))[0] & 1:
        s = math.nextafter(s, math.copysign(math.inf, err))
    return np.float32(s)


# --- K18-noise: x + (u1 - u2)·mult -----------------------------------------


def tpdf_noise(key, x, mult, sel=None):
    """key' and x + where(sel, (u1 - u2)·mult, 0): key, k1, k2 = split(key,
    3), u1 and u2 uniform in [0, PM_RAND_MAX] over x's [B, C] (counter
    b·C + c). key: uint32 [2]; x: float64 [B, C] (float32: tpdf_noise_f32),
    or key [S, 2] and x [S, B, C] for S streams, each drawn from its key;
    sel: bool [C], or None for every channel, where the sum is one FMA,
    x + (u1 - u2)·mult, as XLA:CPU folds dsp_tpu's all-true select away and
    fuses it. CPU tensors run tpdf_noise_ref; CUDA tensors launch
    csrc/tpdf.cu."""
    if x.dtype == torch.float32:
        return tpdf_noise_f32(key, x, mult, sel)
    return _tpdf_noise(tpdf_noise, tpdf_noise_ref, torch.float64, key, x, mult, sel)


tpdf_noise.launches = 0


def tpdf_noise_f32(key, x, mult, sel=None):
    """tpdf_noise on float32 x: dsp_tpu float32's draws (prng.uniform_f32)
    and float32 arithmetic, mult rounded to float32. CPU tensors run
    tpdf_noise_f32_ref; CUDA tensors launch csrc/tpdf.cu."""
    return _tpdf_noise(tpdf_noise_f32, tpdf_noise_f32_ref, torch.float32, key, x, mult, sel)


tpdf_noise_f32.launches = 0


def _tpdf_noise(entry, ref, dt, key, x, mult, sel):
    """The checks in one pass, y and key' in one buffer, one ctypes call."""
    if not x.is_cuda:
        _check_dtypes(entry.__name__, (x, dt), (key, torch.uint32), (sel, torch.bool))
        if x.device.type == "cpu":
            return ref(key, x, mult, sel)
        raise ValueError(f"{entry.__name__}: no kernel for device {x.device}")
    if x.dim() not in (2, 3):
        raise ValueError(f"{entry.__name__}: x {tuple(x.shape)}, expected [B, C] or [S, B, C]")
    *lead, B, C = x.shape
    S = lead[0] if lead else 1
    specs = ((dt, x.shape), (torch.uint32, (*lead, 2)))
    named = (("x", x), ("key", key))
    if sel is not None:
        specs, named = specs + ((torch.bool, (C,)),), named + (("sel", sel),)
    ptrs = _launch_ptrs(entry.__name__, x, named, specs)
    # y [S, B, C], then key' (uint32 [S, 2], the 8·S bytes after it)
    n = S * B * C
    buf = x.new_empty(n + (S if dt is torch.float64 else 2 * S))
    y, key_out = buf[:n].view(x.shape), buf[n:].view(torch.uint32).view(*lead, 2)
    kernels.launch_tpdf_noise(ptrs, key_out, y, float(mult), B, C, S)
    entry.launches += 1
    return key_out, y


def tpdf_noise_ref(key, x, mult, sel=None):
    """Plain version of tpdf_noise: dsp_tpu's noise step on torch tensors
    (x [S, B, C] and key [S, 2] a stream at a time)."""
    if x.dim() == 3:
        return each_stream(lambda k, xs: tpdf_noise_ref(k, xs, mult, sel), key, x)
    keys = prng.split(key, 3)
    u1 = prng.uniform_f64(keys[1], x.shape, PM_RAND_MAX)
    u2 = prng.uniform_f64(keys[2], x.shape, PM_RAND_MAX)
    if sel is None:
        return keys[0], torch.addcmul(x, u1 - u2, torch.tensor(mult, dtype=x.dtype))
    noise = (u1 - u2) * mult
    return keys[0], x + torch.where(sel, noise, torch.zeros_like(noise))


def tpdf_noise_f32_ref(key, x, mult, sel=None):
    """Plain version of tpdf_noise_f32: dsp_tpu float32's noise step (a
    stream at a time)."""
    if x.dim() == 3:
        return each_stream(lambda k, xs: tpdf_noise_f32_ref(k, xs, mult, sel), key, x)
    keys = prng.split(key, 3)
    u1 = prng.uniform_f32(keys[1], x.shape, PM_RAND_MAX)
    u2 = prng.uniform_f32(keys[2], x.shape, PM_RAND_MAX)
    m = torch.tensor(mult, dtype=torch.float32, device=x.device)
    if sel is None:
        return keys[0], _fma32(u1 - u2, m, x)
    noise = (u1 - u2) * m
    return keys[0], x + torch.where(sel, noise, torch.zeros_like(noise))


# --- K15: TPDF dither with error feedback ----------------------------------


def tpdf_dither(key, x, ehist, nprev, n_mult, q0, q1, enabled, fir, mode):
    """One block of dsp_tpu's dither step. key: uint32 [2]; x: [B, C];
    ehist: [9, C] error history (newest first); nprev: [C] the sloped
    noise's carried uniform; n_mult, q0, q1: [C]; enabled: bool [C]; fir:
    [9] feedback taps; mode: DITHER_FLAT, DITHER_SHAPED or DITHER_SLOPED2.
    For S streams x, key, ehist and nprev are led by S. The floats are
    float64 (float32: tpdf_dither_f32). Returns (key', ehist', nprev', y).
    CPU tensors run tpdf_dither_ref; CUDA tensors launch csrc/tpdf.cu."""
    if x.dtype == torch.float32:
        return tpdf_dither_f32(key, x, ehist, nprev, n_mult, q0, q1, enabled, fir, mode)
    return _tpdf_dither(tpdf_dither, tpdf_dither_ref, torch.float64, key, x, ehist, nprev,
                        n_mult, q0, q1, enabled, fir, mode)


tpdf_dither.launches = 0


def tpdf_dither_f32(key, x, ehist, nprev, n_mult, q0, q1, enabled, fir, mode):
    """tpdf_dither with every float float32: dsp_tpu float32's draws and
    its float32 quantizer and feedback. CPU tensors run
    tpdf_dither_f32_ref; CUDA tensors launch csrc/tpdf.cu."""
    return _tpdf_dither(tpdf_dither_f32, tpdf_dither_f32_ref, torch.float32, key, x, ehist,
                        nprev, n_mult, q0, q1, enabled, fir, mode)


tpdf_dither_f32.launches = 0


def _tpdf_dither(entry, ref, dt, key, x, ehist, nprev, n_mult, q0, q1, enabled, fir, mode):
    name = entry.__name__
    checks = [(x, dt), (key, torch.uint32), (ehist, dt), (nprev, dt), (n_mult, dt), (q0, dt),
              (q1, dt), (enabled, torch.bool), (fir, dt)]
    _check_dtypes(name, *checks)
    if x.device.type == "cpu":
        return ref(key, x, ehist, nprev, n_mult, q0, q1, enabled, fir, mode)
    _check_cuda(name, x, *checks, align=1)
    if x.dim() not in (2, 3):
        raise ValueError(f"{name}: x {tuple(x.shape)}, expected [B, C] or [S, B, C]")
    *lead, B, C = x.shape
    for what, t, shape in (("key", key, (*lead, 2)), ("ehist", ehist, (*lead, DITHER_TAPS, C)),
                           ("nprev", nprev, (*lead, C)), ("n_mult", n_mult, (C,)),
                           ("q0", q0, (C,)), ("q1", q1, (C,)), ("enabled", enabled, (C,)),
                           ("fir", fir, (DITHER_TAPS,))):
        _check_shape(name, what, t, shape)
    if mode not in (DITHER_FLAT, DITHER_SHAPED, DITHER_SLOPED2):
        raise ValueError(f"{name}: mode {mode}")
    key_out = torch.empty_like(key)
    ehist_out = torch.empty_like(ehist)
    nprev_out = torch.empty_like(nprev)
    y = torch.empty_like(x)
    kernels.launch_tpdf_dither(key, key_out, x, y, ehist, ehist_out, nprev, nprev_out, n_mult,
                               q0, q1, enabled, fir, mode)
    entry.launches += 1
    return key_out, ehist_out, nprev_out, y


def tpdf_dither_ref(key, x, ehist, nprev, n_mult, q0, q1, enabled, fir, mode):
    """Plain version of tpdf_dither: the noise and the flat quantizer as
    torch ops, the error-feedback loop over samples in Python floats (the
    taps summed in order, each product and sum rounded on its own, as
    dsp_tpu's scan does); x [S, B, C] and the states a stream at a time."""
    if x.dim() == 3:
        return each_stream(lambda st, xs: tpdf_dither_ref(st[0], xs, st[1], st[2], n_mult, q0,
                                                          q1, enabled, fir, mode),
                           (key, ehist, nprev), x)
    B, C = x.shape
    keys = prng.split(key, 3)
    u1 = prng.uniform_f64(keys[1], (B, C), PM_RAND_MAX)
    u2 = prng.uniform_f64(keys[2], (B, C), PM_RAND_MAX)
    if mode == DITHER_SLOPED2:
        prev = torch.cat([nprev[None].to(x.dtype), u1[:-1]])
        noise = (u1 - prev) * n_mult
        nprev_out = u1[-1]
    else:
        noise = (u1 - u2) * n_mult
        nprev_out = nprev
    if mode == DITHER_FLAT:
        # x + (u1 - u2)·n_mult as one FMA, as XLA:CPU fuses it
        y = q1 * torch.round(q0 * torch.addcmul(x, u1 - u2, n_mult))
        return keys[0], ehist, nprev_out, torch.where(enabled, y, x)
    xs, ns = x.tolist(), noise.tolist()
    taps = fir.tolist()
    qa, qb, en = q0.tolist(), q1.tolist(), enabled.tolist()
    eh = ehist.t().tolist()  # [C][9]
    out = [[0.0] * C for _ in range(B)]
    for c in range(C):
        e = eh[c]
        for b in range(B):
            fb = 0.0
            for t in range(DITHER_TAPS):
                fb = fb + taps[t] * e[t]
            xn = xs[b][c]
            p0 = xn - fb
            p1 = qb[c] * _rint(qa[c] * (p0 + ns[b][c]))
            e = [p1 - p0] + e[:-1]
            out[b][c] = p1 if en[c] else xn
        eh[c] = e
    ehist_out = torch.tensor(eh, dtype=x.dtype).t().contiguous().to(x.device)
    return keys[0], ehist_out, nprev_out, torch.tensor(out, dtype=x.dtype, device=x.device)


def tpdf_dither_f32_ref(key, x, ehist, nprev, n_mult, q0, q1, enabled, fir, mode):
    """Plain version of tpdf_dither_f32: the noise and the flat quantizer as
    float32 torch ops, the error-feedback loop over samples on numpy
    float32 scalars (the taps summed in order, each product and sum
    rounded to float32 on its own, as dsp_tpu float32's scan does); a stream
    at a time."""
    if x.dim() == 3:
        return each_stream(lambda st, xs: tpdf_dither_f32_ref(st[0], xs, st[1], st[2], n_mult, q0,
                                                              q1, enabled, fir, mode),
                           (key, ehist, nprev), x)
    B, C = x.shape
    keys = prng.split(key, 3)
    u1 = prng.uniform_f32(keys[1], (B, C), PM_RAND_MAX)
    u2 = prng.uniform_f32(keys[2], (B, C), PM_RAND_MAX)
    if mode == DITHER_SLOPED2:
        noise = (u1 - torch.cat([nprev[None], u1[:-1]])) * n_mult
        nprev_out = u1[-1]
    else:
        noise = (u1 - u2) * n_mult
        nprev_out = nprev
    if mode == DITHER_FLAT:
        y = q1 * torch.round(q0 * _fma32(u1 - u2, n_mult, x))
        return keys[0], ehist, nprev_out, torch.where(enabled, y, x)
    xs, ns = x.cpu().numpy(), noise.cpu().numpy()
    taps = list(fir.cpu().numpy())
    qa, qb, en = q0.cpu().numpy(), q1.cpu().numpy(), enabled.tolist()
    eh = ehist.cpu().numpy().copy()
    out = xs.copy()
    zero = np.float32(0.0)
    for c in range(C):
        e = list(eh[:, c])
        for b, (xn, nn) in enumerate(zip(xs[:, c], ns[:, c])):
            fb = zero
            for t in range(DITHER_TAPS):
                fb = fb + taps[t] * e[t]
            p0 = xn - fb
            p1 = qb[c] * np.rint(qa[c] * (p0 + nn))
            e = [p1 - p0] + e[:-1]
            if en[c]:
                out[b, c] = p1
        eh[:, c] = e
    dev = x.device
    return keys[0], torch.from_numpy(eh).to(dev), nprev_out, torch.from_numpy(out).to(dev)


# --- K17: levels meters ----------------------------------------------------


def levels_step(avg, peak, block_peak, xs, g):
    """One block of the levels meters on xs [B, n] (the selected channels):
    avg' = EWMA of x² (weight g), peak' = the set-min EWMA
    m' = max(x², (1 - g)·m + g·x²), block_peak' = max(block_peak, every m of
    the block). Returns (avg', peak', block_peak'), each [n], float64
    (float32: levels_step_f32); for S streams xs [S, B, n] and the meters
    [S, n]. CPU tensors run levels_step_ref; CUDA tensors launch
    csrc/levels.cu."""
    if xs.dtype == torch.float32:
        return levels_step_f32(avg, peak, block_peak, xs, g)
    return _levels_step(levels_step, levels_step_ref, torch.float64, avg, peak, block_peak, xs, g)


levels_step.launches = 0


def levels_step_f32(avg, peak, block_peak, xs, g):
    """levels_step on float32 samples and meters: each read as float64, the
    scan run in float64 with g unrounded, each meter rounded to float32 once
    when stored. CPU tensors run levels_step_f32_ref; CUDA tensors launch
    csrc/levels.cu."""
    return _levels_step(levels_step_f32, levels_step_f32_ref, torch.float32, avg, peak,
                        block_peak, xs, g)


levels_step_f32.launches = 0


def _levels_step(entry, ref, dt, avg, peak, block_peak, xs, g):
    name = entry.__name__
    if xs.device.type == "cpu":
        _check_dtypes(name, (xs, dt), (avg, dt), (peak, dt), (block_peak, dt))
        return ref(avg, peak, block_peak, xs, g)
    if xs.dim() not in (2, 3):
        raise ValueError(f"{name}: xs {tuple(xs.shape)}, expected [B, n] or [S, B, n]")
    *lead, B, n = xs.shape
    lead = tuple(lead)
    ptrs = _launch_ptrs(name, xs, (("xs", xs), ("avg", avg), ("peak", peak),
                                   ("block_peak", block_peak)), _levels_specs(dt, lead, B, n))
    # the new meters as the rows of one buffer
    out = torch.empty((3, *lead, n), dtype=dt, device=xs.device)
    kernels.launch_levels(ptrs[1:], out, xs, float(g), B, n, lead[0] if lead else 1)
    entry.launches += 1
    return out.unbind(0)


@functools.lru_cache(maxsize=64)
def _levels_specs(dt, lead, B, n):
    return ((dt, (*lead, B, n)), (dt, (*lead, n)), (dt, (*lead, n)), (dt, (*lead, n)))


def levels_step_ref(avg, peak, block_peak, xs, g):
    """Plain version of levels_step: dsp_tpu's associative scan of
    (a, b, c) = (1 - g, g·x², x²) triples under m -> max(c, a·m + b), as a
    Hillis-Steele doubling scan over the block; xs [S, B, n] and the meters
    [S, n] a stream at a time."""
    if xs.dim() == 3:
        return each_stream(lambda st, x: levels_step_ref(*st, x, g), (avg, peak, block_peak), xs)
    s2 = xs * xs
    B = s2.shape[0]
    a = torch.full_like(s2, 1.0 - g)
    b = g * s2
    c = s2
    d = 1
    while d < B:
        a1, b1, c1 = a[:-d], b[:-d], c[:-d]
        a2, b2, c2 = a[d:], b[d:], c[d:]
        a = torch.cat([a[:d], a2 * a1])
        b = torch.cat([b[:d], a2 * b1 + b2])
        c = torch.cat([c[:d], torch.maximum(c2, a2 * c1 + b2)])
        d *= 2
    avg_new = a[-1] * avg + b[-1]
    peaks = torch.maximum(c, a * peak + b)
    return avg_new, peaks[-1], torch.maximum(block_peak, peaks.max(dim=0).values)


def levels_step_f32_ref(avg, peak, block_peak, xs, g):
    """Plain version of levels_step_f32: levels_step_ref in float64 on the
    upcast leaves, rounded to float32 (a stream at a time)."""
    f64 = torch.float64
    outs = levels_step_ref(avg.to(f64), peak.to(f64), block_peak.to(f64), xs.to(f64), g)
    return tuple(t.to(torch.float32) for t in outs)


# --- K16: stats ------------------------------------------------------------

# the state leaves of both modes; the -i estimator adds the last six
STATS_KEYS = ("sum", "sum_sq", "min", "max", "peak", "peak_count", "peak_frame", "samples")
STATS_INTERP_KEYS = ("m", "y", "z", "nctr", "tmin", "tmax")


def stats_step(s, xs, insert_h=None):
    """One block of dsp_tpu's stats step on xs [B, n] (the selected
    channels). s: the state dict (float64 [n] sums, min, max and peak, int64
    [n] peak_count and peak_frame, int64 0-d samples and limit; with -i
    also m [64, n], y [6, n], z [9, n], int32 nctr [n], tmin, tmax [n]).
    insert_h: None for plain stats, or the -i estimator's float64 [67]
    table (the 64-slot insert template, then the three direct taps). Float
    leaves and xs float32: stats_step_f32. For S streams xs is [S, B, n]
    and every leaf led by S (samples and limit [S]). Returns the new state
    dict; nothing is read back to the host. CPU tensors run stats_step_ref;
    CUDA tensors launch csrc/stats.cu."""
    if xs.dtype == torch.float32:
        return stats_step_f32(s, xs, insert_h)
    return _stats_step(stats_step, torch.float64, s, xs, insert_h)


class _ModeLaunches:
    """The launches of one mode of a wrapper that serves two: stats_step's
    plain mode (csrc/stats.cu's tiles), apart from its -i walk."""

    def __init__(self):
        self.launches = 0


stats_step.launches = 0
stats_step.plain = _ModeLaunches()


def stats_step_f32(s, xs, insert_h=None):
    """stats_step with float32 samples, float leaves and table: every
    comparison and the -i estimator's arithmetic in float32, as dsp_tpu
    float32's; the block's sums in float64, added to the float32 sums and
    rounded once. CPU tensors run stats_step_ref; CUDA tensors launch
    csrc/stats.cu."""
    return _stats_step(stats_step_f32, torch.float32, s, xs, insert_h)


stats_step_f32.launches = 0
stats_step_f32.plain = _ModeLaunches()


def _stats_step(entry, dt, s, xs, insert_h):
    name = entry.__name__
    interp = insert_h is not None
    if xs.device.type == "cpu":
        keys = STATS_KEYS + (STATS_INTERP_KEYS if interp else ())
        spec = dict(_stats_specs(dt, (), 1, 1, interp)[1:])
        checks = [(xs, dt), (s["limit"], torch.int64)] + [(s[k], spec[k][0]) for k in keys]
        if interp:
            checks.append((insert_h, dt))
        _check_dtypes(name, *checks)
        return stats_step_ref(s, xs, insert_h)
    if xs.dim() not in (2, 3):
        raise ValueError(f"{name}: xs {tuple(xs.shape)}, expected [B, n] or [S, B, n]")
    *lead, B, n = xs.shape
    lead = tuple(lead)
    S = lead[0] if lead else 1
    specs = _stats_specs(dt, lead, B, n, interp)
    named = [("xs", xs)] + [(k, s[k]) for k, _ in specs[1:]]
    if interp:
        named.append(("insert_h", insert_h))
    ptrs = _launch_ptrs(name, xs, named, [sp for _, sp in specs] + ([(dt, (67,))] if interp else []))
    # the new state: its float leaves the rows of one buffer (sum, sum_sq,
    # min, max, peak; -i: tmin, tmax, each [S, n], then m, y, z, each led by
    # S), its int64 leaves views of a second (peak_count, peak_frame, then
    # samples [S]) and -i's nctr a third
    sn = S * n
    fout = torch.empty((86 if interp else 5) * sn, dtype=dt, device=xs.device)
    iout = torch.empty(2 * sn + S, dtype=torch.int64, device=xs.device)
    new = dict(s)
    rows = fout[:(7 if interp else 5) * sn].view(-1, *lead, n)
    new["sum"], new["sum_sq"], new["min"], new["max"], new["peak"], *rest = rows.unbind(0)
    new["peak_count"], new["peak_frame"], samples = iout.split((sn, sn, S))
    new["peak_count"], new["peak_frame"] = (new["peak_count"].view(*lead, n),
                                            new["peak_frame"].view(*lead, n))
    new["samples"] = samples.view(lead)
    nctr = None
    if interp:
        new["tmin"], new["tmax"] = rest
        m, y, z = fout[7 * sn:].split((64 * sn, 6 * sn, 9 * sn))
        new["m"], new["y"], new["z"] = (m.view(*lead, 64, n), y.view(*lead, 6, n),
                                        z.view(*lead, 9, n))
        new["nctr"] = nctr = torch.empty((*lead, n), dtype=torch.int32, device=xs.device)
        in_ptrs = ptrs[1:9] + [ptrs[k] for k in (10, 11, 12, 13, 14, 15)]
    else:
        in_ptrs = ptrs[1:9] + [None] * 6
    kernels.launch_stats(in_ptrs, fout, iout, nctr, ptrs[9], xs, insert_h, B, n, S)
    entry.launches += 1
    if not interp:
        entry.plain.launches += 1
    return new


@functools.lru_cache(maxsize=64)
def _stats_specs(dt, lead, B, n, interp):
    """((leaf, (dtype, shape)), ...) of the tensors stats_step's kernel
    reads, xs first, in the C entry's order: the plain leaves, limit, then
    (-i) m, y, z, nctr, tmin, tmax; each led by `lead`, () or (S,)."""
    i64 = torch.int64
    v = (*lead, n)
    specs = [("xs", (dt, (*lead, B, n))), ("sum", (dt, v)), ("sum_sq", (dt, v)),
             ("min", (dt, v)), ("max", (dt, v)), ("peak", (dt, v)),
             ("peak_count", (i64, v)), ("peak_frame", (i64, v)), ("samples", (i64, lead)),
             ("limit", (i64, lead))]
    if interp:
        specs += [("m", (dt, (*lead, 64, n))), ("y", (dt, (*lead, 6, n))),
                  ("z", (dt, (*lead, 9, n))), ("nctr", (torch.int32, v)), ("tmin", (dt, v)),
                  ("tmax", (dt, v))]
    return tuple(specs)



def _jmin(a, b):
    """jnp.minimum on tensors: -0.0 orders below +0.0."""
    return torch.where((a < b) | ((a == b) & torch.signbit(a)), a, b)


def _jmax(a, b):
    """jnp.maximum on tensors: +0.0 orders above -0.0."""
    return torch.where((a > b) | ((a == b) & ~torch.signbit(a)), a, b)


def stats_step_ref(s, xs, insert_h=None):
    """Plain version of stats_step and stats_step_f32: the sums in float64
    (for float32 samples, rounded to float32 once they are added to the
    carried sums); dsp_tpu's vectorized plain mode (cummin/cummax, exact
    comparisons) as torch ops; or the -i estimator over samples, in Python
    floats (float64) or numpy float32 scalars (float32). xs [S, B, n] and
    the state's leaves led by S a stream at a time (gated_samples then the
    streams' sum)."""
    if xs.dim() == 3:
        gated = 0

        def one(st, x):
            nonlocal gated
            new = stats_step_ref(st, x, insert_h)
            gated += stats_step_ref.gated_samples
            return new

        stats_step_ref.gated_samples = 0
        new = each_stream(one, s, xs)
        stats_step_ref.gated_samples = gated
        return new
    stats_step_ref.gated_samples = 0
    f64 = torch.float64
    B = xs.shape[0]
    idx = s["samples"] + torch.arange(B, dtype=torch.int64, device=xs.device)
    active = idx < s["limit"]
    new = dict(s)
    xz = torch.where(active[:, None], xs, torch.zeros_like(xs)).to(f64)
    new["sum"] = (s["sum"].to(f64) + xz.sum(dim=0)).to(xs.dtype)
    new["sum_sq"] = (s["sum_sq"].to(f64) + (xz * xz).sum(dim=0)).to(xs.dtype)
    if insert_h is None:
        new.update(_stats_plain_ref(s, xs, idx, active))
    elif xs.dtype == torch.float32:
        new.update(_stats_interp_f32_ref(s, xs, insert_h))
    else:
        new.update(_stats_interp_ref(s, xs, insert_h))
    new["samples"] = torch.minimum(s["samples"] + B, s["limit"])
    return new


# samples the -i gate opened in the last stats_step_ref call, summed over
# channels: the data-dependent operation count of a roofline bound
stats_step_ref.gated_samples = 0


def _stats_plain_ref(s, xs, idx, active):
    inf = torch.full_like(xs, math.inf)
    x_min = torch.where(active[:, None], xs, inf)
    x_max = torch.where(active[:, None], xs, -inf)
    # exclusive running min/max including the carried state (compared only,
    # so the sign of a zero does not matter here)
    cmin = torch.cummin(x_min, dim=0).values
    cmax = torch.cummax(x_max, dim=0).values
    runmin_x = torch.cat([s["min"][None], torch.minimum(s["min"][None], cmin[:-1])])
    runmax_x = torch.cat([s["max"][None], torch.maximum(s["max"][None], cmax[:-1])])
    pk_min = active[:, None] & (xs <= runmin_x)
    pk_max = active[:, None] & ~pk_min & (xs >= runmax_x)
    pk = pk_min | pk_max
    # the block's min and max in jnp.minimum's order, where -0.0 < +0.0
    zero = x_min == 0
    bmin = torch.where(cmin[-1] == 0, torch.where((zero & torch.signbit(x_min)).any(dim=0),
                                                  -0.0, 0.0).to(xs.dtype), cmin[-1])
    zero = x_max == 0
    bmax = torch.where(cmax[-1] == 0, torch.where((zero & ~torch.signbit(x_max)).any(dim=0),
                                                  0.0, -0.0).to(xs.dtype), cmax[-1])
    a = xs.abs()
    a_pk = torch.where(pk, a, torch.zeros_like(a))
    peak_new = torch.maximum(s["peak"], a_pk.max(dim=0).values)
    eq = pk & (a == peak_new[None, :]) & (a > 0)
    cnt = eq.sum(dim=0)
    first = torch.where(eq, idx[:, None], torch.full_like(idx[:, None], NO_LIMIT)).min(dim=0).values
    higher = peak_new > s["peak"]
    return {
        "min": _jmin(s["min"], bmin),
        "max": _jmax(s["max"], bmax),
        "peak": peak_new,
        "peak_count": torch.where(higher, cnt, s["peak_count"] + cnt),
        "peak_frame": torch.where(higher, first, s["peak_frame"]),
    }


def _stats_interp_ref(s, xs, insert_h):
    """dsp_tpu's _step_interp, sample by sample: the 64-slot shift buffer as
    one fused multiply-add a sample (torch.addcmul on the host), the rest
    in Python floats with the three FMAs dsp_tpu's XLA takes."""
    dev = xs.device
    h = insert_h.to("cpu")
    H = h[:64]
    c0, c1, c2 = h[64:].tolist()
    zeros4 = torch.zeros(4, dtype=torch.float64)
    samples, limit = int(s["samples"]), int(s["limit"])
    B, n = xs.shape
    x_l = xs.tolist()
    # per channel: the [6, n] and [9, n] leaves as rows, the [n] ones as values
    cols = {k: s[k].to("cpu").t().tolist() if s[k].dim() == 2 else s[k].tolist()
            for k in ("y", "z", "nctr", "tmin", "tmax", "min", "max", "peak", "peak_count",
                      "peak_frame")}
    m_all = s["m"].to("cpu")
    out = {k: [] for k in cols}
    m_out = []
    n_act = max(0, min(B, limit - samples))  # active samples: index < limit
    gated = 0
    for c in range(n):
        M = m_all[:, c].clone()
        y, z = cols["y"][c], cols["z"][c]
        nc, tmin, tmax = cols["nctr"][c], cols["tmin"][c], cols["tmax"][c]
        mn, mx, pk = cols["min"][c], cols["max"][c], cols["peak"][c]
        cnt, frm = cols["peak_count"][c], cols["peak_frame"][c]
        for b in range(n_act):
            t = samples + b
            sv = x_l[b][c]
            if sv < tmin or sv > tmax:
                nc = STATS_INTERP_DELAY
            if nc > 0:
                gated += 1
                x = z[0]
                m0, m1, m2, m3 = M[:4].tolist()
                y = [y[4], y[5], _fma(c0, x, m0), _fma(c1, x, m1), _fma(c2, x, m2), m3]
                M = torch.addcmul(torch.cat([M[4:], zeros4]), H,
                                  torch.tensor(x, dtype=torch.float64))
                r = 0
                for i in range(1, 5):
                    d0 = y[i] - y[i - 1]
                    d1 = y[i] - y[i + 1]
                    if (d0 > 0 and d1 < 0) or (d0 < 0 and d1 > 0) or (d0 == 0 and d1 == 0):
                        continue
                    dy = y[i - 1] - y[i + 1]
                    den = y[i - 1] - 2.0 * y[i] + y[i + 1]
                    p4 = dy / (8.0 * (1.0 if den == 0 else den))
                    yq = _fma(-dy, p4, y[i])
                    if yq <= mn:
                        mn, tmin = yq, 0.5 * yq
                    elif yq >= mx:
                        mx, tmax = yq, 0.5 * yq
                    else:
                        continue
                    ayq = abs(yq)
                    if ayq > pk:
                        pk, r = ayq, 2
                    elif ayq > 0 and ayq == pk:
                        r = 1
                if r == 2:
                    frm, cnt = t - (STATS_INTERP_DELAY - 1), 1
                elif r == 1:
                    cnt += 1
                nc -= 1
            z = z[1:] + [sv]
        m_out.append(M)
        for k, v in (("y", y), ("z", z), ("nctr", nc), ("tmin", tmin), ("tmax", tmax),
                     ("min", mn), ("max", mx), ("peak", pk), ("peak_count", cnt),
                     ("peak_frame", frm)):
            out[k].append(v)
    new = {}
    for k, v in out.items():
        t = torch.tensor(v, dtype=s[k].dtype).reshape(tuple(s[k].shape)[::-1])
        new[k] = t.t().contiguous().to(dev)  # rows back to [6, n] / [9, n]
    new["m"] = torch.stack(m_out, dim=1).to(dev) if m_out else s["m"].clone()
    stats_step_ref.gated_samples = gated
    return new


def _stats_interp_f32_ref(s, xs, insert_h):
    """dsp_tpu float32's _step_interp, sample by sample: the 64-slot shift
    buffer as one fused multiply-add a sample (_fma32_np), the rest on numpy
    float32 scalars with the three FMAs dsp_tpu's XLA takes (_fma32s)."""
    f = np.float32
    dev = xs.device
    h = insert_h.cpu().numpy()
    H = h[:64]
    c0, c1, c2 = (f(v) for v in h[64:])
    zeros4 = np.zeros(4, dtype=np.float32)
    two, eight, half, one, zero = f(2.0), f(8.0), f(0.5), f(1.0), f(0.0)
    samples, limit = int(s["samples"]), int(s["limit"])
    B, n = xs.shape
    x_np = xs.cpu().numpy()
    st = {k: s[k].cpu().numpy() for k in ("y", "z", "nctr", "tmin", "tmax", "min", "max",
                                          "peak", "peak_count", "peak_frame")}
    m_all = s["m"].cpu().numpy()
    out = {k: [] for k in st}
    m_out = []
    n_act = max(0, min(B, limit - samples))  # active samples: index < limit
    gated = 0
    for c in range(n):
        M = m_all[:, c].copy()
        y, z = list(st["y"][:, c]), list(st["z"][:, c])
        nc = int(st["nctr"][c])
        tmin, tmax = st["tmin"][c], st["tmax"][c]
        mn, mx, pk = st["min"][c], st["max"][c], st["peak"][c]
        cnt, frm = int(st["peak_count"][c]), int(st["peak_frame"][c])
        for b in range(n_act):
            sv = x_np[b, c]
            if sv < tmin or sv > tmax:
                nc = STATS_INTERP_DELAY
            if nc > 0:
                gated += 1
                x = z[0]
                m0, m1, m2, m3 = M[:4]
                y = [y[4], y[5], _fma32s(c0, x, m0), _fma32s(c1, x, m1), _fma32s(c2, x, m2), m3]
                M = _fma32_np(H, x, np.concatenate([M[4:], zeros4]))
                r = 0
                for i in range(1, 5):
                    d0 = y[i] - y[i - 1]
                    d1 = y[i] - y[i + 1]
                    if (d0 > 0 and d1 < 0) or (d0 < 0 and d1 > 0) or (d0 == 0 and d1 == 0):
                        continue
                    dy = y[i - 1] - y[i + 1]
                    den = y[i - 1] - two * y[i] + y[i + 1]
                    p4 = dy / (eight * (one if den == 0 else den))
                    yq = _fma32s(-dy, p4, y[i])
                    if yq <= mn:
                        mn, tmin = yq, half * yq
                    elif yq >= mx:
                        mx, tmax = yq, half * yq
                    else:
                        continue
                    ayq = abs(yq)
                    if ayq > pk:
                        pk, r = ayq, 2
                    elif ayq > zero and ayq == pk:
                        r = 1
                if r == 2:
                    frm, cnt = samples + b - (STATS_INTERP_DELAY - 1), 1
                elif r == 1:
                    cnt += 1
                nc -= 1
            z = z[1:] + [sv]
        m_out.append(M)
        for k, v in (("y", y), ("z", z), ("nctr", nc), ("tmin", tmin), ("tmax", tmax),
                     ("min", mn), ("max", mx), ("peak", pk), ("peak_count", cnt),
                     ("peak_frame", frm)):
            out[k].append(v)
    new = {}
    for k, v in out.items():
        t = torch.tensor(np.array(v, dtype=st[k].dtype)).reshape(tuple(s[k].shape)[::-1])
        new[k] = t.t().contiguous().to(dev)  # rows back to [6, n] / [9, n]
    new["m"] = torch.from_numpy(np.stack(m_out, axis=1)).to(dev) if m_out else s["m"].clone()
    stats_step_ref.gated_samples = gated
    return new


# --- K14: the modulated delay ----------------------------------------------


def mod_delay(key, yk, t, buf, x, sel, table, depth, step, n_taps, qual):
    """One block of dsp_tpu's modulated delay step. key: uint32 [2]; yk:
    the knot window [4, lanes] (lanes 1 for -M, else C); t: 0-d phase;
    buf: [H, C] the line before this block; x: [B, C]; sel: bool [C];
    table: [n_phases, taps] polyphase filters for q1/q2, or None for q0
    (Hermite). The floats are float64 (float32: mod_delay_f32). Returns
    (key', yk', t', y [B, C], buf' [H, C]: the last H rows of [buf | x], a
    new tensor). For S streams x is [S, B, C] and key, yk, t, buf and the
    results are led by S (t [S]); sel and table stay one for all. CPU
    tensors run mod_delay_ref; CUDA tensors launch csrc/mod_delay.cu (one
    launch: the knots, the read and the line)."""
    if x.dtype == torch.float32:
        return mod_delay_f32(key, yk, t, buf, x, sel, table, depth, step, n_taps, qual)
    return _mod_delay(mod_delay, mod_delay_ref, torch.float64, key, yk, t, buf, x, sel, table,
                      depth, step, n_taps, qual)


mod_delay.launches = 0


def mod_delay_f32(key, yk, t, buf, x, sel, table, depth, step, n_taps, qual):
    """mod_delay with every float float32: jax's float32 draws; the knots,
    the B-spline and each read position's integer and phase in float32,
    each operation rounded on its own in dsp_tpu's order; the interpolating
    read in float64 from the float32 line, rounded to float32 once. CPU
    tensors run mod_delay_f32_ref; CUDA tensors launch csrc/mod_delay.cu."""
    return _mod_delay(mod_delay_f32, mod_delay_f32_ref, torch.float32, key, yk, t, buf, x, sel,
                      table, depth, step, n_taps, qual)


mod_delay_f32.launches = 0


def _mod_delay(entry, ref, dt, key, yk, t, buf, x, sel, table, depth, step, n_taps, qual):
    name = entry.__name__
    checks = [(x, dt), (key, torch.uint32), (yk, dt), (t, dt), (buf, dt), (sel, torch.bool)]
    if table is not None:
        checks.append((table, dt))
    _check_dtypes(name, *checks)
    if x.device.type == "cpu":
        return ref(key, yk, t, buf, x, sel, table, depth, step, n_taps, qual)
    _check_cuda(name, x, *checks, align=1)
    if x.dim() not in (2, 3):
        raise ValueError(f"{name}: x {tuple(x.shape)}, expected [B, C] or [S, B, C]")
    *lead, B, C = x.shape
    S = lead[0] if lead else 1
    lanes = yk.shape[-1] if yk.dim() == len(lead) + 2 else -1
    H = buf.shape[-2] if buf.dim() >= 2 else -1
    _check_shape(name, "key", key, (*lead, 2))
    _check_shape(name, "t", t, lead)
    _check_shape(name, "buf", buf, (*lead, H, C))
    _check_shape(name, "sel", sel, (C,))
    if lanes not in (1, C) or tuple(yk.shape[:-1]) != (*lead, 4):
        raise ValueError(f"{name}: knot window {tuple(yk.shape)} for {C} channels")
    if (qual == 0) != (table is None) or (table is not None and table.shape[1] != n_taps):
        raise ValueError(f"{name}: quality {qual} with table "
                         f"{None if table is None else tuple(table.shape)}")
    # the lowest row the read reaches (H - depth - taps, or - 3 for Hermite)
    # must lie in the line
    n_phases = 0 if table is None else table.shape[0]
    if H - int(math.floor(depth)) - (n_taps if qual else 3) < 0:
        raise ValueError(f"{name}: a line of {H} rows is short for depth {depth}")
    n_new = int(np.ceil(B * step)) + 1
    key_out, y, buf_out = torch.empty_like(key), torch.empty_like(x), torch.empty_like(buf)
    # the knot windows and the phases in one allocation
    yt = yk.new_empty(S * (4 * lanes + 1))
    yk_out, t_out = yt[:S * 4 * lanes].view(*lead, 4, lanes), yt[S * 4 * lanes:].view(lead)
    kernels.launch_mod_delay(key, key_out, yk, yk_out, t, t_out, buf, x, y, buf_out, sel, table,
                             n_new, n_phases, n_taps, float(depth), float(step),
                             float(step * B))
    entry.launches += 1
    return key_out, yk_out, t_out, y, buf_out


def mod_knots_ref(key, rows, lanes, dtype=torch.float64):
    """New knots `rows` (an int64 tensor of indices i into a block's new
    knots) drawn from key (the block key's second split), [len(rows),
    lanes]: each the sum over j < 6 of (u[i, j, 0] - u[i, j, 1]) times
    0.77/6/MOD_MAXVAL, u the uniform draw of counter ((i·6 + j)·2 + s)·lanes
    + l, so that any rows can be drawn alone. float64: the sum in order from
    0, one FMA a term, as dsp_tpu's XLA:CPU reduces it; float32 (jax's
    float32 draws): each operation rounded on its own, summed in order from
    0."""
    j = torch.arange(MOD_NOISE_N, device=rows.device)[:, None, None]
    s = torch.arange(2, device=rows.device)[:, None]
    ctr = ((rows[:, None, None, None] * MOD_NOISE_N + j) * 2 + s) * lanes + torch.arange(
        lanes, device=rows.device)  # [rows, 6, 2, lanes]
    if dtype == torch.float64:
        u = prng.uniform_f64_at(key, ctr, MOD_MAXVAL)
        d = u[:, :, 0] - u[:, :, 1]
        acc = torch.zeros_like(d[:, 0])
        for jj in range(MOD_NOISE_N):  # one FMA a term, in order from 0
            acc = fma_ref(d[:, jj], 0.77 / MOD_NOISE_N / MOD_MAXVAL, acc)
        return acc
    u = prng.uniform_f32_at(key, ctr, MOD_MAXVAL)
    d = (u[:, :, 0] - u[:, :, 1]) * _f32c(0.77 / MOD_NOISE_N / MOD_MAXVAL, rows.device)
    acc = torch.zeros_like(d[:, 0])
    for jj in range(MOD_NOISE_N):  # summed in order from 0
        acc = acc + d[:, jj]
    return acc


def mod_delay_ref(key, yk, t, buf, x, sel, table, depth, step, n_taps, qual):
    """Plain version of mod_delay: dsp_tpu's _mod_noise_block and step on
    torch tensors (gathers from the concatenated line), each float64 FMA
    that dsp_tpu's XLA:CPU takes in the chain's scan written out (the
    knots' sums, the B-splines and the Hermite read; the phase t0 + step·n
    rounds twice there: its product is hoisted out of the loop). x [S, B,
    C] and key, yk, t, buf led by S a stream at a time."""
    if x.dim() == 3:
        return each_stream(lambda st, xs: mod_delay_ref(*st, xs, sel, table, depth, step, n_taps,
                                                        qual), (key, yk, t, buf), x)
    B, C = x.shape
    lanes = yk.shape[1]
    dev, dt = x.device, x.dtype
    tev = t + step * torch.arange(B, dtype=dt, device=dev)  # two roundings, as in the chain
    kidx = torch.floor(tev).to(torch.int64)
    frac = tev - torch.floor(tev)
    n_new = int(np.ceil(B * step)) + 1
    keys = prng.split(key, 2)
    new = mod_knots_ref(keys[1], torch.arange(n_new, device=dev), lanes)
    knots = torch.cat([yk.to(dt), new])
    z0, z1, z2, z3 = (knots[kidx + k] for k in range(4))
    z = torch.clamp(_bspline(z0, z1, z2, z3, frac[:, None], 0.5), 0.0, 1.0)
    n_consumed = int(np.floor(float(t) + step * B))
    yk_next = knots[n_consumed:n_consumed + 4]
    t_next = t + step * B - n_consumed
    mod = z.expand(B, C) * depth
    d_int = mod.to(torch.int64)  # truncation, like (ssize_t) mod
    d_frac = mod - d_int.to(dt)
    t_os = None if table is None else d_frac * table.shape[0]
    y = _mod_read(buf, x, d_int, d_frac, t_os, table, n_taps)
    return keys[0], yk_next, t_next, torch.where(sel, y, x), _carried_line(buf, x)


def _bspline(z0, z1, z2, z3, tc, offset=None):
    """dsp_tpu's cubic B-spline of z0..z3 at tc (plus offset, the
    modulator's 0.5) in float64, with the FMAs its XLA:CPU takes in the
    chain's scan: c0 = fma(2/3, z1, a/6), then fma(c3, t, c2), a rounded
    product and sum, and fma(·, t, c0)."""
    a = z0 + z2
    c0 = fma_ref(2.0 / 3.0, z1, (1.0 / 6.0) * a)
    if offset is not None:
        c0 = c0 + offset
    c1 = 0.5 * (z2 - z0)
    c2 = 0.5 * a - z1
    c3 = 0.5 * (z1 - z2) + (1.0 / 6.0) * (z3 - z0)
    return fma_ref(fma_ref(c3, tc, c2) * tc + c1, tc, c0)


def _carried_line(buf, x):
    """The line after a block: the last H rows of [buf | x]."""
    return torch.cat([buf, x])[x.shape[0]:]


def _mod_read(buf, x, d_int, d_frac, t_os, table, n_taps):
    """The modulated delay's read at each sample's integer delay d_int and
    fraction d_frac (t_os = d_frac·n_phases for the polyphase filters, or
    None for the Hermite read), in float64 on the line [buf | x]: the
    Hermite cubic with dsp_tpu's FMAs, or each filter's taps summed in order
    from tap 0, one FMA a tap, and the B-spline join (_bspline)."""
    f64 = torch.float64
    B = x.shape[0]
    H = buf.shape[0]
    line = torch.cat([buf, x]).to(f64)  # [H + B, C]
    base = H + torch.arange(B, device=x.device)[:, None] - d_int
    if table is None:
        ym3, ym2, ym1, y0 = (torch.gather(line, 0, base + off) for off in (-3, -2, -1, 0))
        h1 = 0.5 * (ym2 - y0)
        h2 = fma_ref(-2.5, ym1, y0) + 2.0 * ym2 - 0.5 * ym3
        h3 = 0.5 * (ym3 - y0) + 1.5 * (ym1 - ym2)
        td = d_frac.to(f64)
        return fma_ref(fma_ref(h3, td, h2) * td + h1, td, ym1)
    nph = table.shape[0]
    ph0 = t_os.to(torch.int64)
    offs = torch.arange(n_taps, device=x.device)
    tab = table.to(f64)
    zs = []
    for i in range(4):
        phi = ph0 + i
        idx = (base - phi // nph)[..., None] - offs  # [B, C, taps]
        vals = torch.gather(line[:, :, None].expand(-1, -1, n_taps), 0, idx)
        flt = tab[phi % nph]  # [B, C, taps]
        acc = torch.zeros_like(vals[..., 0])
        for j in range(n_taps):
            acc = fma_ref(vals[..., j], flt[..., j], acc)
        zs.append(acc)
    td = (t_os - ph0.to(t_os.dtype)).to(f64)  # exact
    return _bspline(*zs, td)


def mod_delay_f32_ref(key, yk, t, buf, x, sel, table, depth, step, n_taps, qual):
    """Plain version of mod_delay_f32: the float32 modulator and read
    positions (mod_noise_f32_ref), the read in float64 on the float32 line
    and table; a stream at a time."""
    if x.dim() == 3:
        return each_stream(lambda st, xs: mod_delay_f32_ref(*st, xs, sel, table, depth, step,
                                                            n_taps, qual), (key, yk, t, buf), x)
    B, C = x.shape
    dev, f32 = x.device, torch.float32
    key_next, yk_next, t_next, z = mod_noise_f32_ref(key, yk, t, B, step)
    mod = z.expand(B, C) * _f32c(depth, dev)
    d_int = mod.to(torch.int64)  # truncation, like (ssize_t) mod
    d_frac = mod - d_int.to(f32)  # exact
    # the polyphase phase in float32: its integer part picks the filters
    t_os = None if table is None else d_frac * _f32c(table.shape[0], dev)
    y = _mod_read(buf, x, d_int, d_frac, t_os, table, n_taps)
    return key_next, yk_next, t_next, torch.where(sel, y.to(f32), x), _carried_line(buf, x)


def mod_noise_f32_ref(key, yk, t, B, step):
    """dsp_tpu float32's _mod_noise_block: (key', yk', t', z [B, lanes]),
    the modulation in [0, 1] of each sample of a block of B, in float32:
    the draws, the phases and the carried phase as dsp_tpu float32 rounds
    them; the knots' six-term sums and the B-spline with every operation
    rounded on its own, in order (where dsp_tpu's XLA:CPU takes FMAs and
    orders of its own; see _mod_bspline_f32)."""
    dev, f32 = yk.device, torch.float32
    lanes = yk.shape[1]
    # step·n is a float64 product in dsp_tpu too (jnp.arange is int64),
    # rounded to float32 where it meets the float32 phase
    tev = t + (step * torch.arange(B, dtype=torch.float64, device=dev)).to(f32)
    kidx = torch.floor(tev).to(torch.int64)
    frac = tev - torch.floor(tev)
    n_new = int(np.ceil(B * step)) + 1
    keys = prng.split(key, 2)
    knots = torch.cat([yk, mod_knots_ref(keys[1], torch.arange(n_new, device=dev), lanes, f32)])
    z = _mod_bspline_f32(*(knots[kidx + k] for k in range(4)), frac[:, None])
    tb = t + _f32c(step * B, dev)
    n_consumed = int(torch.floor(tb))
    return keys[0], knots[n_consumed:n_consumed + 4], tb - float(n_consumed), torch.clamp(z, 0.0, 1.0)


def _mod_bspline_f32(z0, z1, z2, z3, tc):
    """The modulator's B-spline at phase tc in float32, each product and sum
    rounded on its own, in dsp_tpu's order. dsp_tpu float32's XLA:CPU
    contracts some of them into FMAs, and which ones changes with the
    fusion around them (measured: a copy of _mod_noise_block jitted alone
    rounds 37 of 4096 values otherwise than the effect's own step), so no
    choice of FMAs reproduces it everywhere."""
    dev = z0.device
    sixth, two3, half = (_f32c(v, dev) for v in (1.0 / 6.0, 2.0 / 3.0, 0.5))
    a = z0 + z2
    c0 = sixth * a + two3 * z1 + half
    c1 = half * (z2 - z0)
    c2 = half * a - z1
    c3 = half * (z1 - z2) + sixth * (z3 - z0)
    return ((c3 * tc + c2) * tc + c1) * tc + c0


def _f32c(v, device):
    """A Python number as a float32 0-d tensor: jax's weak-typed constant
    in a float32 expression."""
    return torch.tensor(v, dtype=torch.float32, device=device)
