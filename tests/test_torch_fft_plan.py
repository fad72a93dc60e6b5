"""The transform plans of dsp_tpu_torch.ops.fft_conv (csrc/fft_conv.cu).

Every N the FFT-convolution engines and the resampler build at the sizes
the tests and chip_smoke.py use gets a plan whose passes fit one thread
block's shared memory and threads, with one launch up to 8192 points and
two (the four-step split N = N1·N2) for the main path's larger sizes. A
numpy model runs a plan with the kernel's pass split, twiddle table, stage
order and index arithmetic; it equals numpy.fft's rfft and irfft. No jax:
numpy and the port's host code only.
"""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread a test process)
import dsp_tpu_torch.ops.fft_conv as fc
from dsp_tpu_torch.ops.resample_ops import SpectralResampler

RATES = (44100, 48000, 88200, 96000, 192000)
# (F, B, partitioned): the FIR lengths and blocks of tests/test_torch_fft_conv.py,
# tests/test_torch_fir.py, tests/test_torch_f32_fft.py and chip_smoke.py (fir
# 64k and fir_p 1M at 2048 and 65536, matrix4_mb's 1,306-tap FIR at blocks
# 2048 and 1056, the mixed chain's 4,096 taps, the crossover's reverse IIR)
ENGINE_CASES = (
    (300, 64, False), (1, 64, False), (1000, 64, False), (50, 64, False), (5000, 32, True),
    (150, 32, True), (256, 64, False), (257, 64, False), (9000, 128, True), (9000, 512, True),
    (9000, 128, False), (8192, 128, False), (8193, 128, False), (5000, 96, True),
    (1 << 16, 2048, False), (1 << 16, 65536, False), (1 << 20, 65536, True),
    (1 << 20, 2048, True), (1025, 2048, True), (2 * 4 ** 3 * 256, 256, True), (3000, 2048, False),
    (3000, 512, False), (3000, 16, True), (5000, 256, True), (9000, 2048, True),
    (1306, 2048, False), (1306, 1056, False), (4096, 2048, False), (4, 1000, False),
    (4096, 1000, False), (32768, 2048, False), (31, 2048, False), (300, 32, False),
)


def _engine_sizes(F, B, partitioned):
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.fir import FirEffect

    h = np.zeros((F, 1))
    h[0] = 1.0
    eng = FirEffect("fir_p" if partitioned else "fir", StreamInfo(44100, 1), [True], h,
                    partitioned=partitioned)._engine(B)
    if isinstance(eng, fc.NupolsConv):
        return {eng.head.N, 2 * eng.P}
    return {eng.N}


def _resampler_sizes():
    out = set()
    for a in RATES:
        for b in RATES:
            if a != b:
                rs = SpectralResampler(a, b)
                out |= {2 * rs.in_len, 2 * rs.out_len}
    return out


# every transform size those engines and resamplers build, and sizes with a
# prime radix a block runs as a direct sum (2·1021: `-b 1021` on Upols) or a
# global pass (2·8221, and 44.1 kHz to 44.101 kHz's 2·44101)
SIZES = sorted(set().union(*(_engine_sizes(*c) for c in ENGINE_CASES)) | _resampler_sizes()
               | {1, 2, 2042, 8209, 2 * 8221, 2 * 44101, 1 << 21})


def test_sizes_cover_the_main_path():
    for N in (4096, 131072, 1176, 1280, 5120, 2 * 8221):
        assert N in SIZES


@pytest.mark.parametrize("C", [1, 2, 8])
def test_plans_fit_a_block(C):
    for N in SIZES:
        plan = fc.fft_plan(N, C)
        assert np.prod([R for p in plan.passes for R in p.radices]) == N
        nsa = 1
        for p in plan.passes:
            assert p.nsa == nsa and p.P == np.prod(p.radices, dtype=np.int64)
            nsa *= p.P
            if p.kind == "global":
                assert p.radices == (p.P,) and p.P > fc.BLOCK_POINTS
                continue
            assert p.kind == "block" and 1 <= p.T and p.T * p.P <= fc.BLOCK_POINTS
            assert 32 <= p.threads <= fc.BLOCK_THREADS and p.threads % 32 == 0
            assert p.T * p.P <= fc.HELD_POINTS * p.threads  # a direct stage's points a thread
            assert p.smem_bytes == 16 * p.T * fc.lane_points(p.P) <= fc.SMEM_LIMIT
        assert plan.smem_bytes <= fc.SMEM_LIMIT
        assert plan.work_slots == min(len(plan.passes) - 1, 2)


def test_plan_paths():
    """One pass up to BLOCK_POINTS, two for the 7-smooth sizes above it,
    a global pass only for a prime above BLOCK_POINTS."""
    for N in SIZES:
        plan = fc.fft_plan(N, 2)
        large = [R for p in plan.passes for R in p.radices if R > fc.BLOCK_POINTS]
        if N <= fc.BLOCK_POINTS:
            assert plan.path == "one pass" and len(plan.passes) == 1
        elif not large:
            assert plan.path == "two passes"
            N1, N2 = (p.P for p in plan.passes)
            assert N1 * N2 == N and N1 >= N2
        else:
            assert [p.kind for p in plan.passes][-len(large):] == ["global"] * len(large)
    assert [p.radices for p in fc.fft_plan(4096, 2).passes] == [(8, 8, 8, 8)]
    assert [p.radices for p in fc.fft_plan(1176, 8).passes] == [(8, 7, 7, 3)]
    assert [p.radices for p in fc.fft_plan(1280, 8).passes] == [(8, 8, 5, 4)]
    assert [p.radices for p in fc.fft_plan(131072, 2).passes] == [(8, 8, 8), (8, 8, 4)]
    p1, p2 = fc.fft_plan(131072, 2).passes
    assert (p1.T, p1.threads, p2.T, p2.threads) == (4, 512, 8, 512)
    assert [(p.kind, p.radices) for p in fc.fft_plan(2 * 8221, 2).passes] == [
        ("block", (2,)), ("global", (8221,))]
    assert [p.radices for p in fc.fft_plan(2042, 2).passes] == [(1021, 2)]


@pytest.mark.parametrize("N", [1176, 1280, 4096, 5120, 8192])
def test_overlap_add_plans_take_a_column_a_block(N):
    plan = fc.fft_plan(N, 8, ola=True)
    (p,) = plan.passes
    assert p.T == 1 and p.smem_bytes == 16 * fc.lane_points(N) + 4 * (N // 2) <= fc.SMEM_LIMIT
    assert plan.work_slots == 0
    big = fc.fft_plan(2 * 8221, 8, ola=True)
    assert big.work_slots == 2  # one for the passes between, one for the scaled inverse


def test_c_plan_words():
    plan = fc.fft_plan(131072, 2)
    import ctypes

    words = list((ctypes.c_int * 19).from_address(plan.c_plan))
    p1, p2 = plan.passes
    assert words == [2, 0, 512, p1.T, p1.threads, p1.smem_bytes, 3, 8, 8, 8,
                     0, 256, p2.T, p2.threads, p2.smem_bytes, 3, 8, 8, 4]


def test_dit_positions_and_tables():
    """dit_positions is the digit reversal (the last stage's radix the
    lowest digit of the input point), and fft_tables lays the twiddles and
    each block pass's positions end to end."""
    pos = fc.dit_positions((2, 3))  # P = 6: input r = d1 + 3 d0 goes to position 3 d1 + d0
    assert list(pos) == [0, 2, 4, 1, 3, 5]
    for radices in ((8, 8, 8, 8), (8, 7, 7, 3), (1021, 2), (8, 8, 5, 4)):
        o = fc.dit_positions(radices)
        assert sorted(o) == list(range(len(o)))
    for N in (4096, 131072, 2 * 8221):
        t = fc.fft_tables(N)
        blocks = [p for p in fc.fft_plan(N, 1).passes if p.kind == "block"]
        assert len(t) == 16 * N + 4 * sum(p.P for p in blocks)
        np.testing.assert_array_equal(t[:16 * N].view(np.complex128), fc.fft_twiddles(N))
        at = 16 * N
        for p in blocks:
            np.testing.assert_array_equal(t[at:at + 4 * p.P].view(np.int32),
                                          fc.dit_positions(p.radices))
            at += 4 * p.P


def test_twiddle_table():
    for N in (4096, 1176, 131072):
        w = fc.fft_twiddles(N)
        k = np.arange(N)
        # numpy's exp rounds its argument 2 pi k / N first: ~1e-15 near k = N
        assert np.abs(w - np.exp(-2j * np.pi * k / N)).max() <= 2e-15
        assert np.abs(np.abs(w) - 1.0).max() <= 2.3e-16
        assert w[0] == 1
        if N % 4 == 0:
            assert w[N // 4] == -1j and w[N // 2] == -1
        if N % 8 == 0:
            assert w[N // 8].real == np.sqrt(0.5) and w[N // 8].imag == -np.sqrt(0.5)


# --- a numpy model of the kernel ---------------------------------------------


def _tw(N, sign):
    w = fc.fft_twiddles(N)
    return w if sign > 0 else w.conj()


def _dft4(u0, u1, u2, u3, sign):
    def rot(z):  # z times -i sign
        return sign * z.imag - 1j * sign * z.real

    a0, a1, b0, b1 = u0 + u2, u0 - u2, u1 + u3, rot(u1 - u3)
    return [a0 + b0, a1 + b1, a0 - b0, a1 - b1]


def _dft(u, R, tw, N, sign):
    """The kernel's R-point DFT (csrc/fft_conv.cu `dft`)."""
    if R == 2:
        return [u[0] + u[1], u[0] - u[1]]
    if R == 4:
        return _dft4(*u, sign)
    if R == 8:
        h = np.sqrt(0.5)
        e, o = _dft4(u[0], u[2], u[4], u[6], sign), _dft4(u[1], u[3], u[5], u[7], sign)
        o[1] = h * (o[1].real + sign * o[1].imag) + 1j * h * (o[1].imag - sign * o[1].real)
        o[2] = sign * o[2].imag - 1j * sign * o[2].real
        o[3] = h * (sign * o[3].imag - o[3].real) - 1j * h * (o[3].imag + sign * o[3].real)
        return [e[q] + o[q] for q in range(4)] + [e[q] - o[q] for q in range(4)]
    step = N // R
    return [u[0] + sum(u[r] * (tw[(r * q) % R * step] if q else 1) for r in range(1, R))
            for q in range(R)]


def _bfly(loc, R, ns, tw, N, sign):
    """An in-place DIT butterfly stage (csrc/fft_conv.cu `bfly_stage`) on
    every sub-transform (rows of loc) at once."""
    P = loc.shape[1]
    j = np.arange(P // R)
    g, k = j // ns, j % ns
    base = g * ns * R + k
    stride = N // (ns * R)
    w1 = tw[k * stride]  # the kernel's powers of W_(ns R)^k, by products
    w, u = w1, [loc[:, base]]
    for q in range(1, R):
        u.append(loc[:, base + q * ns] * w)
        w = w * w1
    v = _dft(u, R, tw, N, sign)
    out = loc.copy()
    for q in range(R):
        out[:, base + q * ns] = v[q]
    return out


def _direct(loc, R, ns, tw, N):
    """A direct-sum DIT stage (csrc/fft_conv.cu `direct_stage`): every
    output point by its R-term sum."""
    P = loc.shape[1]
    L = ns * R
    pos = np.arange(P)
    g, k = pos // L, pos % ns
    q = (pos - g * L) // ns
    first = g * L + k
    e = k * (N // L) + q * (N // R)
    acc = loc[:, first].copy()
    idx = np.zeros_like(e)
    for r in range(1, R):
        idx += e
        idx[idx >= N] -= N
        acc += loc[:, first + r * ns] * tw[idx]
    return acc


def _global(data, R, Ns, tw, N):
    """A global pass (csrc/fft_conv.cu `fft_global_kernel`): one Stockham
    stage of radix R at Ns over the whole transform, a direct sum a point."""
    d = np.arange(N)
    k, q = d % Ns, (d // Ns) % R
    j = (d // (Ns * R)) * Ns + k
    e = k * (N // (Ns * R)) + q * (N // R)
    acc = data[j].copy()
    idx = np.zeros_like(e)
    for r in range(1, R):
        idx += e
        idx[idx >= N] -= N
        acc += data[j + r * (N // R)] * tw[idx]
    return acc


def model_fft(plan, z, sign):
    """The plan's passes on one column z (complex [N]): forward (sign 1)
    or inverse without the 1/N (sign -1)."""
    N = plan.N
    tw = _tw(N, sign)
    data = np.asarray(z, dtype=np.complex128)
    for p in plan.passes:
        if p.kind == "global":
            data = _global(data, p.P, p.nsa, tw, N)
            continue
        P, nsa = p.P, p.nsa
        s = np.arange(N // P)
        r = np.arange(P)
        loc = data[s[:, None] + r[None, :] * (N // P)]
        loc = loc * tw[(r[None, :] * (s % nsa)[:, None] * (N // (nsa * P)))]  # the four-step twiddle
        placed = np.empty_like(loc)
        placed[:, fc.dit_positions(p.radices)] = loc  # input r to its digit-reversed place
        ns = 1
        for R in p.radices:
            if R in fc.BUTTERFLIES:
                placed = _bfly(placed, R, ns, tw, N, sign)
            else:
                placed = _direct(placed, R, ns, tw, N)
            ns *= R
        g = (s[:, None] // nsa) * nsa * P + s[:, None] % nsa + r[None, :] * nsa
        data = np.empty(N, dtype=np.complex128)
        data[g] = placed
    return data


def model_rfft(x, N):
    z = np.zeros(N, dtype=np.complex128)
    z[: len(x)] = x
    return model_fft(fc.fft_plan(N, 1), z, 1.0)[: N // 2 + 1]


def model_irfft(Y, N):
    NB = len(Y)
    n = np.arange(N)
    z = np.where(n < NB, Y[np.minimum(n, NB - 1)], np.conj(Y[np.minimum((N - n) % N, NB - 1)]))
    return model_fft(fc.fft_plan(N, 1), z, -1.0).real * (1.0 / N)


@pytest.mark.parametrize("N", [1176, 1280, 4096, 131072, 2042, 8209, 2 * 8221, 2 * 3 * 5 * 7 * 11])
def test_model_matches_numpy(N):
    rng = np.random.default_rng(N)
    x = rng.standard_normal(N - N // 3)
    X = np.fft.rfft(x, n=N)
    got = model_rfft(x, N)
    assert np.abs(got - X).max() <= 1e-13 * np.abs(X).max()
    Y = X * np.exp(2j * np.pi * rng.random(len(X)))
    Y[0] = Y[0].real
    if N % 2 == 0:
        Y[-1] = Y[-1].real
    y = np.fft.irfft(Y, n=N)
    assert np.abs(model_irfft(Y, N) - y).max() <= 1e-13 * np.abs(y).max()
