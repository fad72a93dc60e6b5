"""Rational-ratio spectral resampler (reference: resample.c), ported from
dsp_tpu.ops.resample_ops.

Windowed-sinc prototype (Albrecht 9-term window, -220 dB stopband, up to 2x
oversampled) applied by frequency-domain convolution: each inner block
consumes in_len = d*L input frames and produces out_len = n*L output frames.
Rate conversion happens in the spectral multiply: the input spectrum is
conjugate-mirrored (periodized) across the lcm-rate band while the product is
aliased (folded) back into the output band — the index walk of
resample.c:116-131 — with 50% overlap-add.

The plan and the index walk's tables are host numpy, computed exactly as
dsp_tpu computes them. One step (K8, ``SpectralResampler.block``) runs all
inner blocks of a chain block at once, the inner blocks (times channels) as
columns, through ``resample_step`` (``resample_step_f32`` on float32
samples), by one of two routes that the resampler fixes when it is built
(``SpectralResampler.route``):

* "one launch" (csrc/resample.cu ``dsp_resample_step``), wherever both
  transforms are one pass of ``fft_plan`` and fit one thread block's shared
  memory, which covers every rate pair the repo uses: a thread block a
  column runs the forward transform at 2·in_len on the inner block read in
  place, the fold from shared memory into the inverse's load, the inverse
  at 2·out_len, the scale and the overlap-add with the column before
  (handed on within a thread-block cluster), the spectra never in device
  memory;
* "three launches" otherwise (a transform above 8192 points or with a
  prime pass, e.g. ``resample 44101``): ``rfft_pack`` (ops/fft_conv.py,
  csrc/fft_conv.cu) at 2·in_len, reading the inner blocks in place;
  ``resample_fold`` (csrc/resample.cu: the gather by ``tab_j``, the conj
  masks, the product with ``tab_s`` and the segment sum into out_len+1
  bins); ``irfft_ola`` (csrc/fft_conv.cu), the inverse at 2·out_len whose
  last store does the scale and the 50% overlap-add.

Both give the bits of the parent route, rfft_pack, the fold, irfft_crop and
then the scale and the shifted add as torch ops, as dsp_tpu orders them:
the same passes, twiddles and products, each product and sum rounded on its
own.

Under float32 (dsp_tpu's ``_block_df``, K8-df, whose transforms are the
two-float32 DFTs of dsp_tpu/ops/dfx_fft.py) the step reads float32 and
stores float32 around the same float64 transforms and fold: each block's
tail rounded to float32, as the carried overlap is, and y rounded once
(``irfft_ola_f32``, or the one-launch kernel's float32 form).

The stream axis (split and batched processing): the step takes x as
[S, n·in_len, C] and the carried overlap as [S, out_len, C], S streams of
n inner blocks each, and returns [S, out_len, C] and [S, n·out_len, C].
One launch runs the S·C·n columns (a thread block's inner blocks and its
cluster never cross a stream: the first inner block of stream s adds
stream s's carried overlap); the route of three launches takes the S·n
inner blocks as columns, its overlap-add told where each stream starts.
The plain versions loop over the streams.
"""

import ctypes
import math
from math import gcd

import numpy as np
import torch

from dsp_tpu_torch import kernels
from dsp_tpu_torch.ops.fft_conv import (
    SMEM_LIMIT,
    _check_cuda,
    _check_dtypes,
    _launch_ptrs,
    _tables_on,
    each_stream,
    fft_plan,
    irfft_crop_ref,
    lane_points,
    next_fast_len,
    rfft_pack,
    rfft_pack_f32,
    rfft_pack_f32_ref,
    rfft_pack_ref,
)

M_FACT = 17.7822
_ALBRECHT9 = np.array(
    [
        2.318028013590306028393e-1, 3.932575471789488615081e-1, 2.385434764970747429454e-1,
        1.014370437785239811268e-1, 2.911516061918003918645e-2, 5.280988177252078698806e-3,
        5.382909093381945363528e-4, 2.442086527507867730168e-5, 2.706153764205043532817e-7,
    ]
)
SINC_MAX_OVERSAMPLE = 2
ONE_LAUNCH, THREE_LAUNCHES = "one launch", "three launches"


def step_route(in_len, out_len):
    """The route of a resampler's step: ONE_LAUNCH where the forward
    transform at 2·in_len and the inverse at 2·out_len are one block pass
    each and a column's two lanes and its tail (float64) fit a thread
    block's shared memory (csrc/resample.cu), else THREE_LAUNCHES."""
    plans = fft_plan(2 * in_len, 1), fft_plan(2 * out_len, 1)
    smem = 16 * (lane_points(2 * in_len) + lane_points(2 * out_len)) + 8 * out_len
    if all(len(p.passes) == 1 and p.passes[0].kind == "block" for p in plans) and smem <= SMEM_LIMIT:
        return ONE_LAUNCH
    return THREE_LAUNCHES


def _window(x):
    if x >= 1.0 or x <= 0.0:
        return 0.0
    i = np.arange(len(_ALBRECHT9))
    c = np.where(i % 2 == 1, -_ALBRECHT9, _ALBRECHT9)
    return float(np.sum(c * np.cos(2 * i * np.pi * x)))


def _norm_sinc(x, fc):
    if abs(x) < 1e-9:
        return fc
    return np.sin(np.pi * fc * x) / (np.pi * x)


class SpectralResampler:
    """Plan + tables for one (in_fs, out_fs, bandwidth) conversion."""

    def __init__(self, in_fs, out_fs, bw=0.939):
        self.in_fs, self.out_fs = in_fs, out_fs
        g = gcd(in_fs, out_fs)
        self.n = out_fs // g
        self.d = in_fs // g
        max_rate, min_rate = max(in_fs, out_fs), min(in_fs, out_fs)
        max_factor, min_factor = max(self.n, self.d), min(self.n, self.d)

        # lround (half-away-from-zero), NOT Python round (banker's):
        # ties like 60.5 must round to 61 as in the C build
        m = int(math.floor(2.0 * M_FACT * max_rate / (min_rate * (1.0 - bw)) + 0.5))
        width = M_FACT * max_rate / m
        fc = (min_rate - width) / max_rate
        sinc_os = min(min_factor, SINC_MAX_OVERSAMPLE)
        fc_os = fc / sinc_os
        m_os = (m + 1) * sinc_os - 1
        m1 = m
        len_mult = -(-(m1 + 1) // max_factor)
        if len_mult > 16:
            fast = next_fast_len(len_mult)
            if fast != len_mult and (
                self.n <= 16
                or self.d <= 16
                or next_fast_len(self.n) == self.n
                or next_fast_len(self.d) == self.d
            ):
                len_mult = fast
        sinc_len = max_factor * len_mult * sinc_os
        self.in_len = self.d * len_mult
        self.out_len = self.n * len_mult
        self.sinc_fr_len = sinc_len + 1
        if out_fs == max_rate:
            self.out_delay = m1 // 2
        else:
            self.out_delay = int(math.floor(m1 // 2 * (self.n / self.d) + 0.5))  # lround
        self.filter_len = m1 + 1
        self.width = width
        self.fc = fc
        self.sinc_os = sinc_os

        # windowed sinc prototype and its spectrum
        sinc = np.zeros(sinc_len * 2, dtype=np.float64)
        for i in range(1, m_os):
            sinc[i] = _norm_sinc((i * 2 - m_os) / 2.0, fc_os) * _window(i / m_os)
        self.sinc_fr = np.fft.rfft(sinc)[: self.sinc_fr_len]

        self._build_tables()
        self.route = step_route(self.in_len, self.out_len)
        self._step_cfgs = {}

    def step_cfg(self, index):
        """The address of this resampler's kernels.ResampleStepCfg on CUDA
        device `index`: its plans, its transforms' and fold's tables there
        and the ratio, made once a device."""
        got = self._step_cfgs.get(index)
        if got is None:
            Nf, Ni = 2 * self.in_len, 2 * self.out_len
            plans = fft_plan(Nf, 1), fft_plan(Ni, 1)
            tables = _tables_on(Nf, index), _tables_on(Ni, index)
            fold = self.fold.on(torch.device("cuda", index))[:4]
            cfg = kernels.ResampleStepCfg(
                plans[0].c_plan, plans[1].c_plan, *(t.data_ptr() for t in tables + fold),
                self.out_len / self.in_len, self.in_len, self.out_len)
            got = self._step_cfgs[index] = (ctypes.addressof(cfg), cfg, plans, tables, fold)
        return got[0]

    def _build_tables(self):
        """Simulate the spectral index walk (resample.c:116-131) into COO
        tables: for each contribution: input bin j, filter bin k, output bin
        l, conj flags."""
        in_len, out_len = self.in_len, self.out_len
        ks, js, ls, c1s, c2s = [0], [0], [0], [False], [False]
        k, j, l, d1, d2 = 1, 1, 1, 1, 1
        while True:
            ks.append(k)
            js.append(j)
            ls.append(l)
            c1s.append(d1 != 1)
            c2s.append(d2 != 1)
            if k + 1 == self.sinc_fr_len:
                break
            if l == out_len:
                ks.append(k); js.append(j); ls.append(l)
                c1s.append(d1 != 1); c2s.append(False)
            elif l == 0:
                ks.append(k); js.append(j); ls.append(l)
                c1s.append(d1 != 1); c2s.append(True)
            j += d1
            l += d2
            if j == 0:
                d1 = 1
            elif j == in_len:
                d1 = -1
            if l == 0:
                d2 = 1
            elif l == out_len:
                d2 = -1
            k += 1
        self.tab_k = np.array(ks, dtype=np.int32)
        self.tab_j = np.array(js, dtype=np.int32)
        self.tab_l = np.array(ls, dtype=np.int32)
        self.tab_c1 = np.array(c1s, dtype=bool)
        self.tab_c2 = np.array(c2s, dtype=bool)
        # sign convention folded into precomputed complex filter weights:
        # value = conj^c2( conj^c1(X[j]) * S[k] )
        self.tab_s = self.sinc_fr[self.tab_k]
        self.fold = FoldTables(self.tab_j, self.tab_l, self.tab_c1, self.tab_c2, self.tab_s,
                               in_len + 1, out_len + 1)

    def state0(self, channels):
        """Overlap-add carry [out_len, C] (blocks are exact-length)."""
        return np.zeros((self.out_len, channels), dtype=np.float64)

    def block(self, overlap, x):
        """Every inner block of x at once: x [n·in_len, C] -> (overlap'
        [out_len, C], y [n·out_len, C]), by resample_step (x [S, n·in_len,
        C] and overlap [S, out_len, C]: S streams). Inner block i is column
        block i of each transform; its overlap-add takes the second half of
        inner block i-1's inverse (the carried overlap for i = 0)."""
        return resample_step(self, overlap, x.contiguous())


def _inner_blocks(rs, x):
    """The inner blocks a stream of x [n·in_len, C] or [S, n·in_len, C]."""
    if x.dim() not in (2, 3):
        raise ValueError(f"resample: x must be [B, C] or [S, B, C], got {tuple(x.shape)}")
    B = x.shape[-2]
    n = B // rs.in_len
    if n * rs.in_len != B or n < 1:
        raise ValueError(f"resample: block of {B} frames is not a multiple of {rs.in_len}")
    return n


# --- K8: the step -------------------------------------------------------------


def resample_step(rs, overlap, x):
    """The step of SpectralResampler rs on x [n·in_len, C] float64 with the
    carried overlap [out_len, C]: (overlap' [out_len, C], y [n·out_len, C]);
    with a stream axis x [S, n·in_len, C] and overlap [S, out_len, C]; on
    float32 x, resample_step_f32. CPU tensors run resample_step_ref;
    CUDA tensors take rs.route: one launch of csrc/resample.cu (counted in
    resample_step.launches and kernels.resample_launches()), or rfft_pack,
    resample_fold and irfft_ola."""
    if x.dtype == torch.float32:
        return resample_step_f32(rs, overlap, x)
    return _resample_step(resample_step, resample_step_ref, torch.float64, rs, overlap, x)


resample_step.launches = 0


def resample_step_f32(rs, overlap, x):
    """resample_step on float32 x and overlap: read float32, the transforms
    and the fold in float64, each tail rounded to float32 and y rounded
    once. CPU tensors run resample_step_f32_ref."""
    return _resample_step(resample_step_f32, resample_step_f32_ref, torch.float32, rs, overlap,
                          x)


resample_step_f32.launches = 0


def _resample_step(entry, ref, dt, rs, overlap, x):
    """The overlap's dtype is settled here for every route: the float64
    step converts it, as dsp_tpu's block does; the float32 step takes
    float32 only."""
    n = _inner_blocks(rs, x)
    if overlap.dtype != dt:
        if dt == torch.float32:
            raise TypeError(f"{entry.__name__}: the kernel takes {dt}, got {overlap.dtype}")
        overlap = overlap.to(dt)
    if x.is_cpu:
        _check_dtypes(entry.__name__, (x, dt))
        return ref(rs, overlap, x)
    if rs.route == ONE_LAUNCH:
        return _launch_step(entry, dt, rs, overlap, x, n)
    ratio = rs.out_len / rs.in_len
    # the S streams' inner blocks as S·n column blocks of each transform
    S = x.shape[0] if x.dim() == 3 else 1
    x = x.reshape(-1, x.shape[-1])
    if dt == torch.float32:
        X = rfft_pack_f32(x, 2 * rs.in_len, blocks=S * n)
        return irfft_ola_f32(resample_fold(X, rs.fold), 2 * rs.out_len, overlap, ratio)
    X = rfft_pack(x[:0], x, 2 * rs.in_len, blocks=S * n)
    return irfft_ola(resample_fold(X, rs.fold), 2 * rs.out_len, overlap, ratio)


def _launch_step(entry, dt, rs, overlap, x, n):
    """The checks in one pass, y and overlap' as views of one buffer, one
    ctypes call."""
    lead, C = tuple(x.shape[:-2]), x.shape[-1]
    ptrs = _launch_ptrs(entry.__name__, x, (("x", x), ("overlap", overlap)),
                        ((dt, x.shape), (dt, (*lead, rs.out_len, C))))
    S = lead[0] if lead else 1
    rows = n * rs.out_len
    buf = torch.empty(S * (rows + rs.out_len) * C, dtype=dt, device=x.device)
    y = buf[: S * rows * C].view(*lead, rows, C)
    ov = buf[S * rows * C:].view(*lead, rs.out_len, C)
    index = x.get_device()
    kernels.launch_resample_step(rs.step_cfg(index), ptrs[0], y, ov, ptrs[1], n, C, S,
                                 dt == torch.float32, index)
    entry.launches += 1
    return ov, y


def resample_step_ref(rs, overlap, x):
    """Plain version of resample_step: rfft_pack_ref of the inner blocks,
    resample_fold_ref and irfft_ola_ref, dsp_tpu's step with the inner
    blocks as columns; x [S, n·in_len, C] and overlap [S, out_len, C] a
    stream at a time."""
    n = _inner_blocks(rs, x)
    if x.dim() == 3:
        return each_stream(lambda ov, xs: resample_step_ref(rs, ov, xs), overlap, x)
    X = rfft_pack_ref(x[:0], x, 2 * rs.in_len, blocks=n)
    return irfft_ola_ref(resample_fold_ref(X, rs.fold), 2 * rs.out_len, overlap.to(x.dtype),
                         rs.out_len / rs.in_len)


def resample_step_f32_ref(rs, overlap, x):
    """Plain version of resample_step_f32: rfft_pack_f32_ref,
    resample_fold_ref and irfft_ola_f32_ref; x [S, n·in_len, C] and
    overlap [S, out_len, C] a stream at a time."""
    n = _inner_blocks(rs, x)
    if x.dim() == 3:
        return each_stream(lambda ov, xs: resample_step_f32_ref(rs, ov, xs), overlap, x)
    X = rfft_pack_f32_ref(x, 2 * rs.in_len, blocks=n)
    return irfft_ola_f32_ref(resample_fold_ref(X, rs.fold), 2 * rs.out_len, overlap,
                             rs.out_len / rs.in_len)


# --- the inverse with the overlap-add, for the route of three launches --------


def irfft_ola(Y, N, overlap, ratio):
    """The float64 resampler's inverse and overlap-add. Y [N//2+1, n·C]:
    the half spectra of n inner blocks (block-major columns); overlap
    [N//2, C] float64, the tail carried in. y2 = irfft(Y, n=N)·ratio; each
    block's tail (rows N//2..N) is added to the next block's head (rows
    0..N//2), the carried overlap to the first block's, each product and sum
    rounded on its own. Returns (overlap' [N//2, C], the last block's tail,
    and y [n·N//2, C]). With a stream axis, overlap [S, N//2, C]: Y's
    columns are S streams of n blocks each, stream s's first block takes
    overlap[s], and the results are [S, N//2, C] and [S, n·N//2, C]. CPU
    tensors run irfft_ola_ref; CUDA tensors launch csrc/fft_conv.cu."""
    return _irfft_ola(irfft_ola, irfft_ola_ref, torch.float64, Y, N, overlap, ratio)


irfft_ola.launches = 0


def irfft_ola_f32(Y, N, overlap, ratio):
    """irfft_ola with a float32 overlap and y: each block's tail rounded to
    float32, as the carried overlap is, and added to the next block's head
    in float64, y rounded once. CPU tensors run irfft_ola_f32_ref; CUDA
    tensors launch csrc/fft_conv.cu."""
    return _irfft_ola(irfft_ola_f32, irfft_ola_f32_ref, torch.float32, Y, N, overlap, ratio)


irfft_ola_f32.launches = 0


def _irfft_ola(entry, ref, dt, Y, N, overlap, ratio):
    name = entry.__name__
    if overlap.dtype != dt:
        raise TypeError(f"{name}: the kernel takes {dt}, got {overlap.dtype}")
    if Y.is_cpu:
        return ref(Y, N, overlap, ratio)
    _check_cuda(name, Y, (Y, torch.complex128), (overlap, dt))
    half, C = N // 2, overlap.shape[-1]
    S = overlap.shape[0] if overlap.dim() == 3 else 1
    if (Y.dim() != 2 or N % 2 or Y.shape[0] != half + 1 or Y.shape[1] % (S * C)
            or overlap.dim() not in (2, 3) or tuple(overlap.shape[-2:]) != (half, C)):
        raise ValueError(f"{name}: Y {tuple(Y.shape)}, overlap {tuple(overlap.shape)} "
                         f"at N = {N}")
    plan = fft_plan(N, Y.shape[1], ola=True)
    n = Y.shape[1] // (S * C)  # inner blocks a stream
    y = overlap.new_empty((*overlap.shape[:-2], n * half, C))
    ov = torch.empty_like(overlap)
    kernels.launch_irfft_ola(plan, _tables_on(N, Y.get_device()), Y, plan.work(Y), y, ov,
                             overlap, ratio, n)
    entry.launches += 1
    return ov, y


def irfft_ola_ref(Y, N, overlap, ratio):
    """Plain PyTorch version of irfft_ola: irfft_crop_ref, the scale, then
    the shifted add, as dsp_tpu's step orders them; overlap [S, N//2, C] a
    stream at a time."""
    if overlap.dim() == 3:
        return _ola_streams(irfft_ola_ref, Y, N, overlap, ratio)
    half, C = N // 2, overlap.shape[1]
    n = Y.shape[1] // C
    y2 = (irfft_crop_ref(Y, N, 0, N) * ratio).reshape(2, half, n, C)
    head, tail = y2[0], y2[1]
    prev = torch.cat([overlap[:, None], tail[:, :-1]], dim=1)
    y = (head + prev).permute(1, 0, 2).reshape(n * half, C)
    return tail[:, -1].contiguous(), y


def irfft_ola_f32_ref(Y, N, overlap, ratio):
    """Plain PyTorch version of irfft_ola_f32: the float64 step's inverse,
    scale and overlap-add, with the tails rounded to float32 and y rounded
    once; overlap [S, N//2, C] a stream at a time."""
    if overlap.dim() == 3:
        return _ola_streams(irfft_ola_f32_ref, Y, N, overlap, ratio)
    half, C = N // 2, overlap.shape[1]
    n = Y.shape[1] // C
    y2 = (irfft_crop_ref(Y, N, 0, N) * ratio).reshape(2, half, n, C)
    head, tail = y2[0], y2[1].float()
    prev = torch.cat([overlap[:, None], tail[:, :-1]], dim=1).double()
    y = (head + prev).float().permute(1, 0, 2).reshape(n * half, C)
    return tail[:, -1].contiguous(), y


def _ola_streams(ref, Y, N, overlap, ratio):
    """ref on each stream's columns of Y (S equal shares, in order) with its
    overlap[s], stacked."""
    w = Y.shape[1] // overlap.shape[0]
    return each_stream(lambda ov, Ys: ref(Ys, N, ov, ratio), overlap,
                       Y.reshape(Y.shape[0], -1, w).transpose(0, 1))


class FoldTables:
    """The index walk's contributions grouped by output bin (CSR), in table
    order within a bin: bin l sums entries ptr[l] .. ptr[l+1]-1. Per entry:
    the input bin ``j``, ``flags`` (1: conj the input, 2: conj the product)
    and the filter weight ``s``. Uploaded once per device."""

    def __init__(self, tab_j, tab_l, tab_c1, tab_c2, tab_s, n_in, n_out):
        order = np.argsort(tab_l, kind="stable")
        self.n_in, self.n_out = n_in, n_out
        self.ptr = np.concatenate([[0], np.cumsum(np.bincount(tab_l, minlength=n_out))]).astype(np.int32)
        self.j = np.ascontiguousarray(tab_j[order], dtype=np.int32)
        self.flags = (tab_c1[order].astype(np.int32) | (tab_c2[order].astype(np.int32) << 1))
        self.s = np.ascontiguousarray(tab_s[order], dtype=np.complex128)
        # the plain version's padded form: slot k of bin l is entry
        # ptr[l] + k where that is below ptr[l+1]
        counts = np.diff(self.ptr)
        self.width = int(counts.max())
        slot = self.ptr[:-1, None] + np.arange(self.width)[None, :]
        self.pad_mask = slot < self.ptr[1:, None]
        self.pad_idx = np.where(self.pad_mask, slot, 0).astype(np.int64)
        self._device = {}

    def on(self, device):
        """(ptr, j, flags, s, pad_idx, pad_mask) as tensors on `device`."""
        device = torch.device(device)
        t = self._device.get(device)
        if t is None:
            t = self._device[device] = tuple(
                torch.as_tensor(np.ascontiguousarray(a), device=device)
                for a in (self.ptr, self.j, self.flags, self.s, self.pad_idx, self.pad_mask))
        return t


# --- K8: the spectral fold, for the route of three launches -------------------


def resample_fold(X, fold):
    """Y[l, c] = sum over bin l's entries e, in table order, of
    conj^c2(conj^c1(X[j_e, c]) · s_e): X [n_in, ncol] complex128 ->
    Y [n_out, ncol]. CPU tensors run resample_fold_ref; CUDA tensors launch
    csrc/resample.cu."""
    if X.device.type == "cpu":
        return resample_fold_ref(X, fold)
    from dsp_tpu_torch import kernels

    _check_cuda("resample_fold", X, (X, torch.complex128))
    if X.dim() != 2 or X.shape[0] != fold.n_in:
        raise ValueError(f"resample_fold: X {tuple(X.shape)}, expected [{fold.n_in}, ncol]")
    ptr, j, flags, s, _, _ = fold.on(X.device)
    Y = torch.empty((fold.n_out, X.shape[1]), dtype=torch.complex128, device=X.device)
    kernels.launch_resample_fold(X, Y, ptr, j, flags, s)
    resample_fold.launches += 1
    return Y


resample_fold.launches = 0


def resample_fold_ref(X, fold):
    """Plain PyTorch version of resample_fold: the gather, the conj masks
    and the product, then each bin's entries added in table order (slot by
    slot of the padded CSR: an empty slot adds nothing), as dsp_tpu's
    segment_sum adds them. The product is written out on the real and
    imaginary parts, (ac - bd) + (ad + bc)i, each product and sum rounded on
    its own, as the kernel computes it: torch's complex product takes FMAs
    on some of its CPU paths and not on others."""
    _, j, flags, s, pad_idx, pad_mask = fold.on(X.device)
    g = X[j.long()]
    gr, gi = g.real, torch.where((flags & 1).bool()[:, None], -g.imag, g.imag)
    sr, si = s.real[:, None], s.imag[:, None]
    vr = gr * sr - gi * si
    vi = gr * si + gi * sr
    vi = torch.where((flags & 2).bool()[:, None], -vi, vi)
    Yr = torch.zeros((fold.n_out, X.shape[1]), dtype=vr.dtype, device=X.device)
    Yi = torch.zeros_like(Yr)
    for k in range(fold.width):
        m, idx = pad_mask[:, k, None], pad_idx[:, k]
        Yr = torch.where(m, Yr + vr[idx], Yr)
        Yi = torch.where(m, Yi + vi[idx], Yi)
    return torch.complex(Yr, Yi)
