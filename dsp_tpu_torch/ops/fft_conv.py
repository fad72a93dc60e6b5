"""FFT convolution engines (reference: fir.c, fir_p.c, zita_convolver.cpp),
ported from dsp_tpu.ops.fft_conv.

The three engines, their host tables and their state layouts are dsp_tpu's:

* ``OlsConv`` (K5): zero-latency single-FFT overlap-save over the chain
  block. One rfft over [history | block | 0] at N = next_fast_len(B+F-1),
  a product with the filter spectrum, one irfft; keep the last B samples.
* ``UpolsConv`` (K6): uniform partitioned overlap-save with a
  frequency-domain delay line (FDL). One rfft of [prev | block] (2B), the
  FDL shifted by one slot with the new spectrum in front, a
  multiply-accumulate against the partition spectra, one irfft.
* ``NupolsConv`` (K7): a head UpolsConv at partition B over taps [0, P) and
  a tail at partition P = m*B over [P, F), fired on the last block of every
  super-block of m blocks. Its output for super-block s is the taps>=P part
  of super-block s+1, so the schedule adds no latency.

The host tables are numpy float64, computed exactly as dsp_tpu computes
them, so both packages build bit-identical filter spectra from the same
taps. A step is three wrappers (the Nupols step a fourth), each a
hand-written kernel on a CUDA tensor and its plain PyTorch version
(``*_ref``) on a CPU tensor:

* ``rfft_pack`` (csrc/fft_conv.cu): the spectrum of [a | x | 0] at N,
  along axis 0 of [N, C] as in dsp_tpu, because the states depend on that
  layout; the pack is the transform's first load, and the same load stores
  the carried input (the overlap-save history, the previous block) as a
  copy the engine owns, never the caller's block.
* ``fdl_mac`` (csrc/fdl_mac.cu): the FDL shift and the spectral
  multiply-accumulate.
* ``irfft_crop`` (csrc/fft_conv.cu): the kept rows of the inverse
  transform, plus the Nupols tail's contribution, in its last store.
* ``splice`` (csrc/fft_conv.cu): the Nupols stage write.

A transform runs as the passes of its ``fft_plan``: one launch up to
N = BLOCK_POINTS, two for the four-step sizes above (csrc/fft_conv.cu).

On float32 samples (dsp_tpu runs K5-K7 in complex64 under float32,
fft_conv.py:97, :144, :220) a step reads float32, transforms and
multiplies in float64 against the complex128 spectra and stores float32:
``rfft_pack_f32`` packs float32 [a | x], ``fdl_mac_f32`` reads and writes
the FDL as float32 (re, im) pairs (dsp_tpu's float32 leaf), and
``irfft_crop_f32`` and ``splice_f32`` store float32. Each float64 wrapper
forwards to its float32 form on float32 samples: ``rfft_pack`` and
``splice`` read them from x, ``fdl_mac`` and ``irfft_crop`` (whose
operands are spectra, and an overlap-save step has neither an FDL nor an
addend) take the samples' dtype as ``dtype``.

Each engine uploads its complex128 spectra once per device (``spectra``):
an upload per block would copy up to tens of MB host to device every step.
NupolsConv decides its fire on the host, from a block counter that is a CPU
int32 tensor (``cnt``, dsp_tpu's leaf), so a step never waits on the card.

The stream axis (split and batched processing): every engine's step takes
x as [S, B, C] as well as [B, C], each state leaf then with a leading S
(``prev`` [S, B, C], ``fdl`` [S, K, B+1, C, 2], ...), but for Nupols'
``cnt``, which stays one 0-dim counter for all S streams: the streams of a
split or a batch all sit at the same block index, so one counter decides
every stream's fire. The four wrappers take the same axis: rfft_pack's a
[S, La, C] and x [S, Lx, C] give X [S, N//2+1, C] and the kept rows
[S, keep, C]; fdl_mac's X and Y [S, NB, C] and FDL [S, K, NB, C, 2] run
against the one H [K, NB, C] of the filter, shared by the streams;
irfft_crop's Y [S, NB, C] and add [S, L, C] give [S, L, C]; splice's a and
x [S, ...] give [S, L, C]. A CUDA tensor runs the S streams in the one
launch of a one-stream call; each plain version loops over the streams.
"""

import ctypes
import functools
import math

import numpy as np
import torch

from dsp_tpu_torch import kernels


def _stack_tree(items):
    """Tensors, or equal tuples, lists and dicts of them, stacked item by item,
    each stream keeping an item's memory layout: torch.fft returns a
    transform along dim 0 column-major, and torch's complex product rounds
    an element by the layout it walks, so a stream of the stack must lie
    as a one-stream result lies."""
    first = items[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_tree([it[k] for it in items]) for k in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack_tree([it[k] for it in items]) for k in first}
    if first is None:
        return None
    if first.dim() == 2 and first.shape[1] > 1 and first.stride() == (1, first.shape[0]):
        return torch.stack([t.t() for t in items]).transpose(1, 2)
    return torch.stack(items)


def each_stream(fn, state, x):
    """The plain versions' stream axis: fn(state[s], x[s]) for each stream s
    of x [S, ...], its results (tensors, or tuples, lists or dicts of them)
    stacked, so that stream s is the bits of a one-stream call. state is a
    tensor led by S, or a tuple, list or dict of them (None kept), each cut
    at s."""
    return _stack_tree([fn(_stream_of(state, s), x[s]) for s in range(x.shape[0])])


def _stream_of(tree, s):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_stream_of(t, s) for t in tree)
    if isinstance(tree, dict):
        return {k: _stream_of(v, s) for k, v in tree.items()}
    return None if tree is None else tree[s]


def next_fast_len(n):
    """Smallest 2^a*3^b*5^c*7^d >= n (util.c:434-458)."""
    if n <= 1:
        return 1
    best = n * 7
    p2 = 1
    while p2 <= 2 * n:
        p3 = p2
        while p3 <= 2 * n:
            p5 = p3
            while p5 <= 2 * n:
                p7 = p5
                while p7 <= 2 * n:
                    if n <= p7 < best:
                        best = p7
                    p7 *= 7
                p5 *= 5
            p3 *= 3
        p2 *= 2
    return best


class _Spectra:
    """Per-device cache of an engine's host spectra ([K, NB, C] complex128)."""

    def spectra(self, name, like):
        """Host table `name` as a contiguous complex128 tensor on `like`'s
        device, for samples of either dtype."""
        cache = self.__dict__.setdefault("_device_spectra", {})
        key = (name, like.device)
        t = cache.get(key)
        if t is None:
            host = np.ascontiguousarray(getattr(self, name), dtype=np.complex128)
            t = cache[key] = torch.as_tensor(host, device=like.device)
        return t


class OlsConv(_Spectra):
    """Zero-latency overlap-save convolution of a fixed block size (K5).

    filters: [C, F] float64 per-channel impulse responses. state0() once;
    step(state, x) per block.
    """

    def __init__(self, filters, block_frames):
        filters = np.asarray(filters, dtype=np.float64)
        self.C, self.F = filters.shape
        self.B = block_frames
        self.N = next_fast_len(self.B + self.F - 1)
        self.H = np.fft.rfft(
            np.concatenate([filters, np.zeros((self.C, self.N - self.F))], axis=1), axis=1
        )  # [C, N//2+1]
        self.H_dev = self.H.T[None]  # [1, N//2+1, C], the layout fdl_mac takes
        self.hist = self.F - 1  # carried input history

    def state0(self):
        return np.zeros((self.hist, self.C), dtype=np.float64)

    def step(self, state, x):
        B = x.shape[-2]
        if B != self.B:
            raise ValueError(f"OlsConv: block of {B} frames, built for {self.B}")
        hist = state.to(x.dtype)
        # [hist | x] zero-padded to N; the new history, its last hist rows,
        # stored by the same launch
        X, new_hist = rfft_pack(hist, x, self.N, keep=self.hist)
        Y, _ = fdl_mac(X, self.spectra("H_dev", x), dtype=x.dtype)
        out = irfft_crop(Y, self.N, self.hist, B, dtype=x.dtype)
        return (state if self.hist == 0 else new_hist), out


class UpolsConv(_Spectra):
    """Uniform partitioned overlap-save with a frequency-domain delay line (K6).

    filters: [C, F]. Partition length = block_frames; FFT size 2*block.
    State: {"prev": [B, C], "fdl": [K, B+1, C, 2]} with the FDL's spectra as
    (re, im) pairs, newest first, as in dsp_tpu.
    """

    def __init__(self, filters, block_frames):
        filters = np.asarray(filters, dtype=np.float64)
        self.C, self.F = filters.shape
        self.B = B = block_frames
        self.K = K = max(1, -(-self.F // B))
        self.N = 2 * B
        parts = np.zeros((K, self.C, B), dtype=np.float64)
        for k in range(K):
            seg = filters[:, k * B : (k + 1) * B]
            parts[k, :, : seg.shape[1]] = seg
        self.Hf = np.fft.rfft(
            np.concatenate([parts, np.zeros((K, self.C, B))], axis=2), axis=2
        )  # [K, C, B+1]
        self.H_dev = np.transpose(self.Hf, (0, 2, 1))  # [K, B+1, C]

    def state0(self):
        return {
            "prev": np.zeros((self.B, self.C), dtype=np.float64),
            "fdl": np.zeros((self.K, self.B + 1, self.C, 2), dtype=np.float64),
        }

    def step(self, state, x, add=None):
        """One block; `add` ([B, C] or None) is added to the output (the
        Nupols tail's contribution)."""
        B = self.B
        if x.shape[-2] != B:
            raise ValueError(f"UpolsConv: block of {x.shape[-2]} frames, built for {B}")
        prev = state["prev"].to(x.dtype)
        # [B+1, C], and the engine's own copy of the block as the next prev
        X, new_prev = rfft_pack(prev, x, self.N, keep=B)
        Y, fdl = fdl_mac(X, self.spectra("H_dev", x), state["fdl"].to(x.dtype), dtype=x.dtype)
        out = irfft_crop(Y, self.N, B, B, add, dtype=x.dtype)
        return {"prev": new_prev, "fdl": fdl}, out


class NupolsConv(_Spectra):
    """Two-group non-uniform partitioned overlap-save, zero latency (K7).

    Head: UpolsConv over taps [0, P) at partition B. Tail: partition size
    P = m*B over taps [P, F), fired on the last block of each super-block of
    m chain blocks. The block index within the super-block, ``cnt``, is a
    CPU int32 tensor: the host reads it every block without waiting on the
    device, and a checkpoint keeps dsp_tpu's int32 leaf. With a stream axis
    every other leaf has a leading S and ``cnt`` stays one 0-dim counter
    for all streams.
    """

    def __init__(self, filters, block_frames, super_mult):
        filters = np.asarray(filters, dtype=np.float64)
        self.C, self.F = filters.shape
        self.B = B = block_frames
        self.m = m = int(super_mult)
        self.P = P = m * B
        if self.F <= P:
            raise ValueError("NupolsConv: filter shorter than head span; use UpolsConv")
        self.head = UpolsConv(filters[:, :P], B)
        tail = filters[:, P:]
        self.K1 = K1 = max(1, -(-tail.shape[1] // P))
        parts = np.zeros((K1, self.C, P), dtype=np.float64)
        for k in range(K1):
            seg = tail[:, k * P : (k + 1) * P]
            parts[k, :, : seg.shape[1]] = seg
        self.H1 = np.fft.rfft(
            np.concatenate([parts, np.zeros((K1, self.C, P))], axis=2), axis=2
        )  # [K1, C, P+1]
        self.H1_dev = np.transpose(self.H1, (0, 2, 1))  # [K1, P+1, C]

    def state0(self):
        P, C = self.P, self.C
        return {
            "head": self.head.state0(),
            "stage": np.zeros((P, C), dtype=np.float64),       # current super-block input
            "prev_super": np.zeros((P, C), dtype=np.float64),  # previous super-block input
            "tail_fdl": np.zeros((self.K1, P + 1, C, 2), dtype=np.float64),
            "tail_out": np.zeros((P, C), dtype=np.float64),    # taps>=P contribution, current super
            "cnt": torch.zeros((), dtype=torch.int32),         # block index within super-block (host)
        }

    def step(self, state, x):
        B, P, m = self.B, self.P, self.m
        if x.shape[-2] != B:
            raise ValueError(f"NupolsConv: block of {x.shape[-2]} frames, built for {B}")
        # a CPU tensor: no device read; one counter for every stream of x
        # [S, B, C], which all sit at the same block index
        i = int(state["cnt"])
        if not 0 <= i < m:
            raise ValueError(f"NupolsConv: block counter {i} outside [0, {m})")
        off = i * B
        tail_seg = state["tail_out"].to(x.dtype)[..., off : off + B, :]
        if x.dim() == 3:  # rows of each stream: a copy, as irfft_crop reads its addend whole
            tail_seg = tail_seg.contiguous()
        hstate, out = self.head.step(state["head"], x, add=tail_seg)  # y_head + tail_seg
        stage = splice(state["stage"].to(x.dtype), x, P, off, 0)  # x written at rows [off, off+B)
        last = i == m - 1
        if last:
            X = rfft_pack(state["prev_super"].to(x.dtype), stage, 2 * P)  # [P+1, C]
            Y, tail_fdl = fdl_mac(X, self.spectra("H1_dev", x), state["tail_fdl"].to(x.dtype),
                                  dtype=x.dtype)
            tail_out = irfft_crop(Y, 2 * P, P, P, dtype=x.dtype)
            prev_super = stage
        else:
            prev_super, tail_fdl, tail_out = (
                state[k].to(x.dtype) for k in ("prev_super", "tail_fdl", "tail_out")
            )
        new_state = {
            "head": hstate,
            "stage": stage,
            "prev_super": prev_super,
            "tail_fdl": tail_fdl,
            "tail_out": tail_out,
            "cnt": torch.tensor(0 if last else i + 1, dtype=torch.int32),
        }
        return new_state, out


# --- the transform's plan (csrc/fft_conv.cu) ---------------------------------

# A block pass holds T·P points of 16 bytes in dynamic shared memory, at
# most BLOCK_POINTS (128 KB), with up to BLOCK_THREADS threads; in a stage
# of a radix other than BUTTERFLIES a thread holds at most HELD_POINTS
# output points across the barrier. A radix above BLOCK_POINTS is a global
# pass. SMEM_LIMIT is a Hopper block's most dynamic shared memory.
# csrc/fft_conv.cu holds the same numbers and checks every plan against them.
BLOCK_POINTS = 8192
BLOCK_THREADS = 512
HELD_POINTS = 16
SMEM_LIMIT = 232448
BUTTERFLIES = (2, 3, 4, 5, 7, 8)  # radices a thread transforms in registers
_SMS = 132  # an H100's SMs: a pass's lanes a block grow until its blocks about fill them


def lane_points(P):
    """The points a lane of P takes in shared memory: a gap after every 8
    and one more after every 512 (csrc/fft_conv.cu `pad`)."""
    return (P - 1) + (P - 1) // 8 + (P - 1) // 512 + 1


class FftPass:
    """One launch of a transform: a block pass runs the P-point DFT of
    `radices` (their product P, the stages innermost first) on T
    sub-transforms a thread block, in shared memory; a global pass is one
    stage of a radix above BLOCK_POINTS (P = that radix), one thread an
    output point. nsa is the product of the earlier passes' radices."""

    def __init__(self, kind, radices, nsa, T=0, threads=256, smem_bytes=0):
        self.kind, self.radices, self.nsa = kind, tuple(radices), nsa
        self.P = math.prod(radices)
        self.T, self.threads, self.smem_bytes = T, threads, smem_bytes

    def __repr__(self):
        return (f"FftPass({self.kind}, radices={self.radices}, P={self.P}, nsa={self.nsa}, "
                f"T={self.T}, threads={self.threads}, smem={self.smem_bytes})")


class FftPlan:
    """How csrc/fft_conv.cu runs a transform of N points on C columns.

    The radices (8, 4, 2, 3, 5, 7 and larger primes) are grouped into
    passes, each one launch: one block pass when N fits a block
    (N <= BLOCK_POINTS), else the fewest block passes whose radix products
    fit (two for the four-step split N = N1·N2), with each prime above
    BLOCK_POINTS a global pass after them. `ola`: the plan of the
    resampler's inverse with its overlap-add, whose one block pass takes
    one column a block and keeps a float32 tail beside it. The twiddle
    table is W^i = exp(-2 pi i i / N), i < N, complex128
    (fft_twiddles(N)), read by every pass, and each block pass loads its
    points to the digit-reversed positions of `dit_positions`
    (fft_tables(N) holds both); `work_slots` complex128 [N, C] buffers
    carry the passes between (one more, for the scaled inverse, when an
    overlap-add plan has more than one pass)."""

    def __init__(self, N, C, ola=False):
        if N < 1 or C < 1:
            raise ValueError(f"fft_plan: N = {N}, C = {C}")
        self.N, self.C, self.ola = N, C, ola
        small, large = _radices(N)
        groups = _group(small) if small or not large else []
        passes, nsa = [], 1
        for g in groups:
            P = math.prod(g)
            lanes = N // P * C
            T = 1 if ola else max(1, min(BLOCK_POINTS // P, -(-lanes // _SMS)))
            # about 4 points a thread (at most HELD_POINTS: 512 threads)
            threads = min(BLOCK_THREADS, max(32, -(-T * P // 4 // 32) * 32))
            smem = T * lane_points(P) * 16
            if ola and len(groups) == 1 and not large:
                smem += N // 2 * 4  # the float32 tail the fused overlap-add keeps
            passes.append(FftPass("block", g, nsa, T, threads, smem))
            nsa *= P
        for R in large:
            passes.append(FftPass("global", (R,), nsa))
            nsa *= R
        self.passes = tuple(passes)
        n = len(passes)
        self.path = "one pass" if n == 1 else "two passes" if n == 2 else f"{n} passes"
        self.work_slots = min(n - 1, 2) + (1 if ola and n > 1 else 0)
        self.smem_bytes = max(p.smem_bytes for p in passes)
        words = [n]
        for p in passes:
            words += [0 if p.kind == "block" else 1, p.P, p.T, p.threads, p.smem_bytes,
                      len(p.radices), *p.radices]
        self._c_plan = (ctypes.c_int * len(words))(*words)
        self.c_plan = ctypes.addressof(self._c_plan)

    def work(self, like):
        """The plan's complex128 work slots on like's device, or None."""
        if not self.work_slots:
            return None
        return torch.empty((self.work_slots, self.N, self.C), dtype=torch.complex128,
                           device=like.device)

    def __repr__(self):
        return f"FftPlan(N={self.N}, C={self.C}, {self.path}: {list(self.passes)})"


def _radices(N):
    """(radices a block can take, primes above BLOCK_POINTS) of N: 8s, then
    a 4 or a 2, then 3, 5, 7 and the larger primes, ascending."""
    n, small, large = N, [], []
    while n % 8 == 0:
        small.append(8)
        n //= 8
    for r in (4, 2, 3, 5, 7):
        while n % r == 0:
            small.append(r)
            n //= r
    p = 11
    while n > 1:
        if p * p > n:
            p = n
        while n % p == 0:
            (small if p <= BLOCK_POINTS else large).append(p)
            n //= p
        p += 2
    return small, large


def _group(radices):
    """The fewest groups of the radices whose products are at most
    BLOCK_POINTS, as even as the greedy fill (largest first, into the
    smallest group) makes them, the largest product first. One group of
    no radix for N = 1."""
    if not radices:
        return [()]
    order = sorted(radices, reverse=True)
    n = max(1, math.ceil(math.log(math.prod(radices)) / math.log(BLOCK_POINTS) - 1e-9))
    while True:
        groups = [[] for _ in range(n)]
        prods = [1] * n
        for r in order:
            i = min(range(n), key=lambda k: prods[k])
            if prods[i] * r > BLOCK_POINTS:
                break
            groups[i].append(r)
            prods[i] *= r
        else:
            return [tuple(g) for g in sorted(groups, key=lambda g: -math.prod(g)) if g] or [()]
        n += 1


@functools.lru_cache(maxsize=256)
def fft_plan(N, C, ola=False):
    """The FftPlan of a transform of N points on C columns (cached)."""
    return FftPlan(N, C, ola)


def dit_positions(radices):
    """Where each input point of a block pass goes for its in-place
    decimation-in-time: input point sum_s d_s R_m ... R_(s+1) to position
    sum_s d_s P / (R_m ... R_s) (the digits of the input, the last stage's
    radix lowest, reversed; csrc/fft_conv.cu `load_tile`)."""
    P = math.prod(radices)
    r, pos, span = np.arange(P), np.zeros(P, dtype=np.int64), P
    for R in reversed(radices):
        r, d = np.divmod(r, R)
        span //= R
        pos += d * span
    return pos.astype(np.int32)


@functools.lru_cache(maxsize=32)
def fft_twiddles(N):
    """W^i = exp(-2 pi i i / N), i < N, complex128: computed in long double
    and rounded once; the zeros of cos and sin (at multiples of N/4) exact."""
    t = np.arange(N, dtype=np.longdouble) * (2 * np.arctan(np.longdouble(1)) * 4 / N)
    re, im = np.cos(t).astype(np.float64), -np.sin(t).astype(np.float64)
    re[np.abs(re) < 1e-15] = 0.0
    im[np.abs(im) < 1e-15] = 0.0
    w = re + 1j * im
    w.setflags(write=False)
    return w


def fft_tables(N):
    """What every plan of N points reads on the card, as bytes: the
    twiddles fft_twiddles(N), then for each block pass its dit_positions,
    int32 (the grouping of radices into passes depends on N alone)."""
    orders = [dit_positions(p.radices) for p in fft_plan(N, 1).passes if p.kind == "block"]
    return np.concatenate([fft_twiddles(N).view(np.uint8)] + [o.view(np.uint8) for o in orders])


@functools.lru_cache(maxsize=32)
def _tables_on(N, index):
    """fft_tables(N) on CUDA device `index` (cached)."""
    return torch.tensor(fft_tables(N), device=torch.device("cuda", index))


# --- K5-K7: the kernels of a step --------------------------------------------


def rfft_pack(a, x, N, keep=None, blocks=1):
    """Spectrum [N//2+1, C] of the real signal [a | x | 0] of length N along
    axis 0 (a: [La, C], may be empty; x: [Lx, C]; La + Lx <= N), float64,
    or float32 (then this is rfft_pack_f32). With `keep` (an int), returns
    (X, the last keep rows of [a | x] as a new tensor). With blocks > 1, x
    is `blocks` inner blocks [blocks·Lx, ch] (a empty) and the columns are
    block-major: C = blocks·ch. With a stream axis (a [S, La, C], x
    [S, Lx, C]; blocks 1) X is [S, N//2+1, C] and the kept rows [S, keep,
    C]. CPU tensors run rfft_pack_ref; CUDA tensors launch
    csrc/fft_conv.cu."""
    if x.dtype == torch.float32:
        return rfft_pack_f32(x, N, a, keep, blocks)
    if x.is_cpu:
        return rfft_pack_ref(a, x, N, keep, blocks)
    return _launch_rfft_pack(rfft_pack, a, x, N, keep, blocks, torch.float64)


rfft_pack.launches = 0


def _columns(x, blocks):
    """[blocks·Lx, ch] inner blocks as [Lx, blocks·ch] block-major columns."""
    if blocks == 1:
        return x
    Lx, ch = x.shape[0] // blocks, x.shape[1]
    return x.reshape(blocks, Lx, ch).permute(1, 0, 2).reshape(Lx, blocks * ch)


def _kept(a, x, keep):
    return splice_ref(a, x, keep, keep - x.shape[0], a.shape[0] + x.shape[0] - keep)


def rfft_pack_ref(a, x, N, keep=None, blocks=1):
    """Plain PyTorch version of rfft_pack: dsp_tpu's concatenate, then
    rfft; the kept rows by splice_ref; a [S, La, C] and x [S, Lx, C] a
    stream at a time (X [S, N//2+1, C], the kept rows [S, keep, C])."""
    if x.dim() == 3:
        return each_stream(lambda a_s, x_s: rfft_pack_ref(a_s, x_s, N, keep), a, x)
    xs = _columns(x, blocks) if blocks > 1 else torch.cat([a, x])
    X = torch.fft.rfft(xs, n=N, dim=0)
    return X if keep is None else (X, _kept(a, x, keep))


def rfft_pack_f32(x, N, a=None, keep=None, blocks=1):
    """The spectrum [N//2+1, C] complex128 of the float32 [a | x] (a [La, C]
    or None, x [Lx, C], La + Lx <= N) zero-padded to N, read into float64:
    the float32 FFT convolution step's and the float32 resampler's forward
    transform, in place of dsp_tpu's complex64 rfft and two-float32 DFT.
    `keep` and `blocks` as for rfft_pack (the kept rows float32). CPU
    tensors run rfft_pack_f32_ref; CUDA tensors launch csrc/fft_conv.cu."""
    a = x[..., :0, :] if a is None else a
    for t in (a, x):
        if t.dtype != torch.float32:
            raise TypeError(f"rfft_pack_f32: the kernel takes torch.float32, got {t.dtype}")
    if x.is_cpu:
        return rfft_pack_f32_ref(x, N, a, keep, blocks)
    return _launch_rfft_pack(rfft_pack_f32, a, x, N, keep, blocks, torch.float32)


rfft_pack_f32.launches = 0


def rfft_pack_f32_ref(x, N, a=None, keep=None, blocks=1):
    """Plain PyTorch version of rfft_pack_f32: the rfft of the upcast
    [a | x]; the kept rows by splice_ref; a [S, La, C] and x [S, Lx, C]
    a stream at a time."""
    if x.dim() == 3:
        a = x[:, :0] if a is None else a
        return each_stream(lambda a_s, x_s: rfft_pack_f32_ref(x_s, N, a_s, keep), a, x)
    xs = _columns(x, blocks) if a is None or blocks > 1 else torch.cat([a, x])
    X = torch.fft.rfft(xs.double(), n=N, dim=0)
    return X if keep is None else (X, _kept(x[:0] if a is None else a, x, keep))


def _launch_rfft_pack(wrapper, a, x, N, keep, blocks, dtype):
    """x [S, Lx, ch] runs as S groups of columns (the kernel's blocks, a and
    the kept rows read and written a group at a time), X stored a group at
    a time: [S, N//2+1, ch]."""
    name = wrapper.__name__
    _check_cuda(name, x, (a, dtype), (x, dtype), align=x.element_size())
    S = x.shape[0] if x.dim() == 3 else 0
    La, Lx = a.shape[-2], x.shape[-2] // max(blocks, 1)
    k = 0 if keep is None else keep
    if (x.dim() not in (2, 3) or a.dim() != x.dim() or a.shape[:-2] != x.shape[:-2]
            or a.shape[-1] != x.shape[-1] or blocks < 1 or (S and blocks > 1)
            or Lx * blocks != x.shape[-2] or La + Lx > N or not 0 <= k <= La + Lx
            or (blocks > 1 and (La or k))):
        raise ValueError(f"{name}: a {tuple(a.shape)}, x {tuple(x.shape)}, blocks {blocks}, "
                         f"keep {keep} at N = {N}")
    ch = x.shape[-1]
    groups = S or blocks
    C = ch * groups
    plan = fft_plan(N, C)
    lead = x.shape[:-2]
    X = x.new_empty((*lead, N // 2 + 1, ch if S else C), dtype=torch.complex128)
    kept = x.new_empty((*lead, k, ch)) if k else None
    kernels.launch_rfft_pack(plan, _tables_on(N, x.get_device()), a, x, Lx, groups, kept, X,
                             plan.work(x), grouped_out=bool(S))
    wrapper.launches += 1
    if keep is None:
        return X
    return X, x.new_empty((*lead, 0, ch)) if kept is None else kept


def irfft_crop(Y, N, lo, L, add=None, dtype=torch.float64):
    """Rows [lo, lo+L) of irfft(Y, n=N) along axis 0 (Y: [N//2+1, C]
    complex128), plus `add` ([L, C] float64) when given: [L, C] float64.
    With a stream axis, Y [S, N//2+1, C] and add [S, L, C] give [S, L, C].
    With dtype float32 (the samples' dtype) this is irfft_crop_f32. CPU
    tensors run irfft_crop_ref; CUDA tensors launch csrc/fft_conv.cu."""
    if dtype == torch.float32:
        return irfft_crop_f32(Y, N, lo, L, add)
    _check_dtypes("irfft_crop", (Y, torch.complex128), (add, torch.float64))
    if Y.is_cpu:
        return irfft_crop_ref(Y, N, lo, L, add)
    return _launch_irfft_crop(irfft_crop, Y, N, lo, L, add, torch.float64)


irfft_crop.launches = 0


def irfft_crop_ref(Y, N, lo, L, add=None):
    """Plain PyTorch version of irfft_crop: dsp_tpu's irfft, slice, add; Y
    [S, NB, C] and add [S, L, C] a stream at a time."""
    if Y.dim() == 3:
        if add is None:
            return _stack_tree([irfft_crop_ref(Ys, N, lo, L) for Ys in Y])
        return each_stream(lambda a_s, Y_s: irfft_crop_ref(Y_s, N, lo, L, a_s), add, Y)
    y = torch.fft.irfft(Y, n=N, dim=0)[lo : lo + L]
    return y if add is None else y + add


def irfft_crop_f32(Y, N, lo, L, add=None):
    """irfft_crop with a float32 result: the inverse of complex128 Y in
    float64, plus the float32 `add` ([L, C]) read into float64, each point
    rounded once to float32. CPU tensors run irfft_crop_f32_ref; CUDA
    tensors launch csrc/fft_conv.cu."""
    _check_dtypes("irfft_crop_f32", (Y, torch.complex128), (add, torch.float32))
    if Y.is_cpu:
        return irfft_crop_f32_ref(Y, N, lo, L, add)
    return _launch_irfft_crop(irfft_crop_f32, Y, N, lo, L, add, torch.float32)


irfft_crop_f32.launches = 0


def irfft_crop_f32_ref(Y, N, lo, L, add=None):
    """Plain PyTorch version of irfft_crop_f32: irfft_crop_ref on the
    upcast add, rounded to float32."""
    return irfft_crop_ref(Y, N, lo, L, None if add is None else add.double()).float()


def _launch_irfft_crop(wrapper, Y, N, lo, L, add, dtype):
    name = wrapper.__name__
    _check_cuda(name, Y, (Y, torch.complex128), *(() if add is None else ((add, dtype),)))
    ch, lead = Y.shape[-1], tuple(Y.shape[:-2])
    if (Y.dim() not in (2, 3) or Y.shape[-2] != N // 2 + 1
            or not (0 <= lo and L > 0 and lo + L <= N)):
        raise ValueError(f"{name}: Y {tuple(Y.shape)}, rows [{lo}, {lo + L}) at N = {N}")
    if add is not None and tuple(add.shape) != (*lead, L, ch):
        raise ValueError(f"{name}: add {tuple(add.shape)}, expected {(*lead, L, ch)}")
    # the S streams' columns as one transform of S·ch columns, each stream's
    # rows read and written a group at a time
    plan = fft_plan(N, ch * (lead[0] if lead else 1))
    out = Y.new_empty((*lead, L, ch), dtype=dtype)
    kernels.launch_irfft_crop(plan, _tables_on(N, Y.get_device()), Y, plan.work(Y), out, lo,
                              add, ch)
    wrapper.launches += 1
    return out


def splice(a, x, L, lo, shift):
    """[L, C] with out[n] = x[n - lo] for lo <= n < lo + len(x), else
    a[n + shift]: the last L rows of [a | x] (lo = L - len(x),
    shift = len(a) + len(x) - L), or a copy of a with x written at row lo
    (shift = 0). Always a new tensor, of a's and x's dtype: float64, or
    float32 (then this is splice_f32). With a stream axis (a [S, La, C], x
    [S, Lx, C]) the rows are each stream's: [S, L, C]. CPU tensors run
    splice_ref; CUDA tensors launch csrc/fft_conv.cu."""
    if x.dtype == torch.float32:
        return splice_f32(a, x, L, lo, shift)
    if x.is_cpu:
        return splice_ref(a, x, L, lo, shift)
    if x.dtype != torch.float64:
        raise TypeError(f"splice: the kernel takes torch.float64, got {x.dtype}")
    return _launch_splice(splice, a, x, L, lo, shift)


splice.launches = 0


def splice_f32(a, x, L, lo, shift):
    """splice on float32 a and x. CPU tensors run splice_ref; CUDA tensors
    launch csrc/fft_conv.cu."""
    _check_dtypes("splice_f32", (a, torch.float32), (x, torch.float32))
    if x.is_cpu:
        return splice_ref(a, x, L, lo, shift)
    return _launch_splice(splice_f32, a, x, L, lo, shift)


splice_f32.launches = 0


def _launch_splice(wrapper, a, x, L, lo, shift):
    """The checks of _check_cuda and of the rows read, written out for the
    two tensors of a call that is mostly host time."""
    if not x.is_cuda:
        raise ValueError(f"{wrapper.__name__}: no kernel for device {x.device}")
    if a.dtype != x.dtype:
        raise TypeError(f"{wrapper.__name__}: the kernel takes {x.dtype}, got {a.dtype}")
    if a.get_device() != x.get_device():
        raise ValueError(f"{wrapper.__name__}: tensors on {a.device} and {x.device}")
    if (not (a.is_contiguous() and x.is_contiguous())
            or (a.data_ptr() | x.data_ptr()) % x.element_size()):
        raise ValueError(f"{wrapper.__name__}: tensors must be contiguous and aligned")
    # out reads a at rows [0, lo_c) and [hi_c, L), each shifted by `shift`
    La, Lx = a.shape[-2], x.shape[-2]
    lo_c = 0 if lo < 0 else L if lo > L else lo
    hi_c = 0 if lo + Lx < 0 else L if lo + Lx > L else lo + Lx
    if (x.dim() not in (2, 3) or a.dim() != x.dim() or a.shape[:-2] != x.shape[:-2]
            or a.shape[-1] != x.shape[-1] or L <= 0
            or (lo_c > 0 and not (0 <= shift and lo_c + shift <= La))
            or (hi_c < L and not (0 <= hi_c + shift and L + shift <= La))):
        raise ValueError(f"{wrapper.__name__}: a {tuple(a.shape)}, x {tuple(x.shape)}, L {L}, "
                         f"lo {lo}, shift {shift}")
    out = x.new_empty((*x.shape[:-2], L, x.shape[-1]))
    kernels.launch_splice(a, x, out, L, lo, shift)
    wrapper.launches += 1
    return out


def splice_ref(a, x, L, lo, shift):
    """Plain PyTorch version of splice: slices of a and x, concatenated;
    a [S, La, C] and x [S, Lx, C] a stream at a time."""
    if x.dim() == 3:
        return torch.stack([splice_ref(a[s], x[s], L, lo, shift) for s in range(x.shape[0])])
    lo_c = min(max(lo, 0), L)
    hi_c = min(max(lo + x.shape[0], 0), L)
    return torch.cat([a[shift : shift + lo_c], x[lo_c - lo : hi_c - lo], a[hi_c + shift : L + shift]])


def fdl_mac(X, H, fdl_in=None, dtype=torch.float64):
    """The spectral multiply-accumulate of K5, K6 and K7.

        Y[f, c]    = X[f, c] H[0, f, c] + sum_{k=1..K-1} FDL_in[k-1, f, c] H[k, f, c]
        FDL_out[0] = X,  FDL_out[k] = FDL_in[k-1]   (k = 1..K-1)

    X: [NB, C] complex; H: [K, NB, C] complex; fdl_in: [K, NB, C, 2] real,
    the (re, im) pairs of dsp_tpu's state, or None when there is no delay
    line (K = 1, OlsConv). Returns (Y [NB, C], FDL_out [K, NB, C, 2] or
    None). With a stream axis X and Y are [S, NB, C] and the FDL [S, K, NB,
    C, 2], against the one H of the filter. X and H are complex128, fdl_in
    float64; with dtype float32 (the samples' dtype) this is fdl_mac_f32.
    CPU tensors run fdl_mac_ref; CUDA tensors launch csrc/fdl_mac.cu."""
    if dtype == torch.float32:
        return fdl_mac_f32(X, H, fdl_in)
    if X.is_cuda:
        return _launch_fdl_mac(fdl_mac, X, H, fdl_in, torch.float64)
    _check_dtypes("fdl_mac", (X, torch.complex128), (H, torch.complex128),
                  (fdl_in, torch.float64))
    if X.device.type == "cpu":
        return fdl_mac_ref(X, H, fdl_in)
    raise ValueError(f"fdl_mac: no kernel for device {X.device}")


fdl_mac.launches = 0


def fdl_mac_f32(X, H, fdl_in=None):
    """fdl_mac with the FDL as float32 (re, im) pairs, dsp_tpu's float32
    leaf: the slots read into complex128, the product and sum in complex128
    against the complex128 H, X stored rounded as the newest slot; Y is
    complex128. With fdl_in None (an overlap-save step) the product of
    fdl_mac. CPU tensors run fdl_mac_f32_ref; CUDA tensors launch
    csrc/fdl_mac.cu."""
    if X.is_cuda:
        return _launch_fdl_mac(fdl_mac_f32, X, H, fdl_in, torch.float32)
    _check_dtypes("fdl_mac_f32", (X, torch.complex128), (H, torch.complex128),
                  (fdl_in, torch.float32))
    if X.device.type == "cpu":
        return fdl_mac_f32_ref(X, H, fdl_in)
    raise ValueError(f"fdl_mac_f32: no kernel for device {X.device}")


fdl_mac_f32.launches = 0


def _launch_fdl_mac(wrapper, X, H, fdl_in, fdl_dtype):
    """The checks of _check_dtypes, _check_cuda (align=16: the (re, im)
    pairs are read as double2; a float32 FDL's as float2) and
    _check_fdl_mac_shapes, written out for the one call, then the launch
    into outputs made with one torch.empty_like each."""
    from dsp_tpu_torch import kernels

    c128 = torch.complex128
    if X.dtype != c128 or H.dtype != c128 or (fdl_in is not None and fdl_in.dtype != fdl_dtype):
        raise TypeError(f"{wrapper.__name__}: the kernel takes complex128 X and H and a "
                        f"{fdl_dtype} FDL, got {X.dtype}, {H.dtype}, "
                        f"{None if fdl_in is None else fdl_in.dtype}")
    dev = X.get_device()
    if H.get_device() != dev or (fdl_in is not None and fdl_in.get_device() != dev):
        raise ValueError(f"{wrapper.__name__}: tensors on more than one device")
    for t in (X, H) if fdl_in is None else (X, H, fdl_in):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{wrapper.__name__}: tensors must be contiguous and 16-byte aligned")
    _check_fdl_mac_shapes(X, H, fdl_in)
    Y = torch.empty_like(X)
    fdl_out = None if fdl_in is None else torch.empty_like(fdl_in)
    kernels.launch_fdl_mac(X, H, fdl_in, Y, fdl_out, fdl_dtype == torch.float32)
    wrapper.launches += 1
    return Y, fdl_out


def fdl_mac_f32_ref(X, H, fdl_in=None):
    """Plain PyTorch version of fdl_mac_f32: fdl_mac_ref on the upcast
    FDL, the shifted FDL rounded to float32 (X [S, NB, C] a stream at a
    time, by fdl_mac_ref)."""
    Y, fdl = fdl_mac_ref(X, H, None if fdl_in is None else fdl_in.double())
    return Y, None if fdl is None else fdl.float()


def fdl_mac_ref(X, H, fdl_in=None):
    """Plain PyTorch version of fdl_mac (any device): dsp_tpu's
    concatenate-then-sum (fft_conv.py:99, :145-151, :225-233); X [S, NB, C]
    and the FDL [S, K, NB, C, 2] a stream at a time, against the one H."""
    if X.dim() == 3:
        if fdl_in is None:
            return _stack_tree([fdl_mac_ref(Xs, H)[0] for Xs in X]), None
        return each_stream(lambda f_s, X_s: fdl_mac_ref(X_s, H, f_s), fdl_in, X)
    if fdl_in is None:
        if H.shape[0] != 1:
            raise ValueError(f"fdl_mac: no delay line given for K = {H.shape[0]}")
        return X * H[0], None
    fdl = torch.cat([X[None], torch.view_as_complex(fdl_in.contiguous())[:-1]])
    return (fdl * H).sum(dim=0), torch.view_as_real(fdl)


def _check_dtypes(name, *tensors):
    """Raise unless every (tensor, dtype) pair, the tensor not None, is of
    that dtype (the one this wrapper's kernel takes), on every device."""
    for t, dtype in tensors:
        if t is not None and t.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")


def _check_cuda(name, like, *tensors, align=8):
    """Raise unless every (tensor, dtype) pair is on `like`'s CUDA device,
    of that dtype, contiguous and aligned to its element and to `align`
    bytes."""
    if not like.is_cuda:
        raise ValueError(f"{name}: no kernel for device {like.device}")
    dev = like.get_device()
    for t, dtype in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
        if t.get_device() != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {like.device}")
        if not t.is_contiguous() or t.data_ptr() % max(t.element_size(), align):
            raise ValueError(f"{name}: tensors must be contiguous and {align}-byte aligned")


def _check_shape(name, what, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} {tuple(t.shape)}, expected {tuple(shape)}")


def _launch_ptrs(name, like, named, specs):
    """The device addresses of the tensors a kernel reads, after the checks
    that guard its launch, in one pass: each (what, tensor) of named has the
    (dtype, shape) of specs, lies on like's CUDA device, is contiguous and
    is aligned to its element. A failing check raises as _check_dtypes,
    _check_shape and _check_cuda do."""
    if not like.is_cuda:
        raise ValueError(f"{name}: no kernel for device {like.device}")
    dev = like.get_device()
    ptrs = []
    for (what, t), (dtype, shape) in zip(named, specs):
        p = t.data_ptr()
        if (t.dtype is not dtype or t.shape != shape or not t.is_contiguous()
                or t.get_device() != dev or p % t.element_size()):
            _check_dtypes(name, (t, dtype))
            _check_shape(name, what, t, shape)
            _check_cuda(name, like, (t, dtype), align=1)
        ptrs.append(p)
    return ptrs


def _check_fdl_mac_shapes(X, H, fdl_in):
    """Raise unless the shapes fit the fdl_mac kernel."""
    if X.dim() not in (2, 3) or H.dim() != 3 or tuple(H.shape[1:]) != tuple(X.shape[-2:]):
        raise ValueError(f"fdl_mac: X {tuple(X.shape)} and H {tuple(H.shape)} do not fit")
    NB, C = X.shape[-2:]
    K = H.shape[0]
    want = (*X.shape[:-2], K, NB, C, 2)
    if fdl_in is None:
        if K != 1:
            raise ValueError(f"fdl_mac: no delay line given for K = {K}")
    elif tuple(fdl_in.shape) != want:
        raise ValueError(f"fdl_mac: fdl {tuple(fdl_in.shape)}, expected {want}")
