"""K5-K7 of dsp_tpu_torch.ops.fft_conv against dsp_tpu.ops.fft_conv.

Engine by engine on the CPU in float64: the same seeded numpy filters,
inputs and states go through dsp_tpu's jnp step and the port's step, where
fdl_mac runs its plain version fdl_mac_ref. Every output block and every
state leaf is compared.
"""

import numpy as np
import pytest
import torch

import dsp_tpu.ops.fft_conv as jfc
import dsp_tpu_torch.ops.fft_conv as tfc
from torch_parity import FS

# Both sides take the same host spectra and differ in their FFT libraries
# (pocketfft under XLA, torch's) and the order of the MAC's sum. Relative to
# max(1, peak |y|), measured at worst -290 dB on these cases; 1e-13 (-260 dB)
# keeps a margin of about 30 dB.
REL_LIMIT = 1e-13


def _err(a, b):
    return float(np.abs(np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)).max(initial=0.0))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def _to_jax(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), tree)


def _random_state(eng, rng):
    """eng.state0() with every float leaf filled with seeded noise."""
    def fill(t):
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        a = np.asarray(t)
        return rng.standard_normal(a.shape) * 0.1 if a.dtype == np.float64 else a
    return fill(eng.state0())


# (engine, F, B, m, blocks, cnt0): m and cnt0 for NupolsConv only
CASES = {
    "ols": ("ols", 300, 64, None, 12, None),
    "ols_F1": ("ols", 1, 64, None, 6, None),
    "upols": ("upols", 1000, 64, None, 20, None),
    "upols_K1": ("upols", 50, 64, None, 8, None),
    "nupols": ("nupols", 5000, 32, 4, 14, 2),  # 3+ super-blocks from cnt = 2
    "nupols_K1": ("nupols", 150, 32, 4, 10, 1),  # tail of one partition
}


def _engines(kind, filters, B, m):
    if kind == "ols":
        return jfc.OlsConv(filters, B), tfc.OlsConv(filters, B)
    if kind == "upols":
        return jfc.UpolsConv(filters, B), tfc.UpolsConv(filters, B)
    return jfc.NupolsConv(filters, B, m), tfc.NupolsConv(filters, B, m)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_dsp_tpu(case):
    import jax

    from dsp_tpu_torch.convert import flatten_states

    kind, F, B, m, n_blocks, cnt0 = CASES[case]
    rng = np.random.default_rng(F + B)
    filters = rng.standard_normal((2, F)) * 0.1
    j, t = _engines(kind, filters, B, m)
    if kind == "nupols":
        assert t.K1 == j.K1 and (t.K1 == 1) == case.endswith("K1")
    st0 = _random_state(j, rng)
    if cnt0 is not None:
        st0["cnt"] = np.int32(cnt0)
    sj, st = _to_jax(st0), _to_torch(st0)
    for _ in range(n_blocks):
        x = rng.standard_normal((B, 2))
        sj, yj = j.step(sj, jax.numpy.asarray(x))
        st, yt = t.step(st, torch.as_tensor(x))
        assert tuple(yt.shape) == (B, 2)
        assert _err(yt, yj) <= REL_LIMIT * max(1.0, float(np.abs(np.asarray(yj)).max()))
    leaves_t, treedef = flatten_states(st)
    leaves_j = jax.tree_util.tree_leaves(sj)
    assert treedef == str(jax.tree_util.tree_structure(sj))
    assert len(leaves_t) == len(leaves_j)
    for a, b in zip(leaves_t, leaves_j):
        a = a.numpy()
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _err(a, b) <= REL_LIMIT * max(1.0, float(np.abs(b).max(initial=0.0)))
    if case == "ols_F1":
        assert tuple(leaves_t[0].shape) == (0, 2)


def test_nupols_counter_stays_on_the_host():
    eng = tfc.NupolsConv(np.ones((1, 200)), 16, 4)
    st = _to_torch(eng.state0())
    st["cnt"] = torch.zeros((), dtype=torch.int32)
    for i in range(9):
        st, _ = eng.step(st, torch.zeros(16, 1, dtype=torch.float64))
        assert st["cnt"].device.type == "cpu" and st["cnt"].dtype == torch.int32
        assert int(st["cnt"]) == (i + 1) % 4
    st["cnt"] = torch.tensor(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="block counter 4"):
        eng.step(st, torch.zeros(16, 1, dtype=torch.float64))


@pytest.mark.parametrize("n", [0, 1, 2, 7, 97, 4095, 4096, 65535, 131071, 1 << 20])
def test_next_fast_len_matches_dsp_tpu(n):
    assert tfc.next_fast_len(n) == jfc.next_fast_len(n)


def _fir(pkg, F, B, partitioned):
    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.fir import FirEffect as JFir
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.fir import FirEffect

    h = np.zeros((F, 1))
    h[0] = 1.0
    name = "fir_p" if partitioned else "fir"
    if pkg == "jax":
        return JFir(name, JStream(FS, 1), [True], h, partitioned=partitioned)._engine(B)
    return FirEffect(name, StreamInfo(FS, 1), [True], h, partitioned=partitioned)._engine(B)


def _describe(eng):
    kind = type(eng).__name__
    if kind == "NupolsConv":
        return kind, eng.m, eng.P, eng.K1, eng.head.K
    if kind == "UpolsConv":
        return kind, eng.K, eng.N
    return kind, eng.N, eng.hist


def test_engine_selection():
    """Mirrors tests/test_fft_effects.py::test_engine_selection."""
    assert isinstance(_fir("torch", 9000, 128, True), tfc.NupolsConv)  # 71 parts
    assert isinstance(_fir("torch", 9000, 512, True), tfc.UpolsConv)  # 18 parts
    eng = _fir("torch", 9000, 128, True)
    assert eng.m in (4, 8, 16) and eng.P == eng.m * 128
    big = _fir("torch", 1 << 20, 2048, True)
    assert _describe(big) == ("NupolsConv", 32, 65536, 15, 32)


@pytest.mark.parametrize(
    "F, B, partitioned",
    [(300, 64, False), (256, 64, False), (257, 64, False), (9000, 128, True), (9000, 512, True),
     (9000, 128, False), (8192, 128, False), (8193, 128, False), (5000, 96, True),
     (1 << 16, 2048, False), (1 << 16, 65536, False), (1 << 20, 65536, True),
     (1025, 2048, True), (2 * 4 ** 3 * 256, 256, True)],
)
def test_engine_choice_matches_dsp_tpu(F, B, partitioned):
    """Same engine, partition counts and super-block multiple as dsp_tpu
    (the > 4B and >= 64-partition thresholds, m's round-half-up)."""
    assert _describe(_fir("torch", F, B, partitioned)) == _describe(_fir("jax", F, B, partitioned))


@pytest.mark.parametrize("K, NB, C", [(1, 9, 1), (1, 33, 2), (5, 17, 3), (32, 65, 2)])
def test_fdl_mac_ref_matches_einsum(K, NB, C):
    rng = np.random.default_rng(K * NB + C)

    def cn(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    X, H, fdl = cn(NB, C), cn(K, NB, C), rng.standard_normal((K, NB, C, 2))
    shifted = np.concatenate([X[None], (fdl[..., 0] + 1j * fdl[..., 1])[:-1]])
    want = np.einsum("kfc,kfc->fc", shifted, H)
    Y, out = tfc.fdl_mac(torch.as_tensor(X), torch.as_tensor(H), torch.as_tensor(fdl))
    assert _err(Y.numpy().real, want.real) <= 1e-12 and _err(Y.numpy().imag, want.imag) <= 1e-12
    np.testing.assert_array_equal(out.numpy()[..., 0], shifted.real)
    np.testing.assert_array_equal(out.numpy()[..., 1], shifted.imag)
    if K == 1:
        Y1, none = tfc.fdl_mac(torch.as_tensor(X), torch.as_tensor(H))
        assert none is None
        assert _err(Y1.numpy().real, want.real) <= 1e-12 and _err(Y1.numpy().imag, want.imag) <= 1e-12


@pytest.mark.parametrize("N, La, Lx", [(1, 0, 1), (12, 3, 5), (30, 0, 30), (98, 40, 40), (600, 299, 64)])
def test_rfft_pack_and_irfft_crop_refs_match_numpy(N, La, Lx):
    rng = np.random.default_rng(N + La)
    a, x = rng.standard_normal((La, 2)), rng.standard_normal((Lx, 2))
    want = np.fft.rfft(np.concatenate([a, x, np.zeros((N - La - Lx, 2))]), axis=0)
    X = tfc.rfft_pack(torch.as_tensor(a), torch.as_tensor(x), N)
    assert tuple(X.shape) == (N // 2 + 1, 2)
    assert _err(X.numpy().real, want.real) <= 1e-12 and _err(X.numpy().imag, want.imag) <= 1e-12
    lo, L = N // 3, N - N // 3
    add = rng.standard_normal((L, 2))
    y = np.fft.irfft(want, n=N, axis=0)[lo : lo + L]
    assert _err(tfc.irfft_crop(X, N, lo, L), y) <= 1e-12
    assert _err(tfc.irfft_crop(X, N, lo, L, torch.as_tensor(add)), y + add) <= 1e-12


# (La, Lx, L, lo, shift): the engines' three uses of splice
SPLICES = {
    "history_shorter_than_block": (5, 8, 5, 5 - 8, 8),  # OlsConv, hist < B
    "history_longer_than_block": (20, 8, 20, 20 - 8, 8),  # OlsConv, hist > B
    "previous_block": (8, 8, 8, 0, 8),  # UpolsConv's prev
    "stage_first": (32, 8, 32, 0, 0),  # NupolsConv's stage write
    "stage_middle": (32, 8, 32, 16, 0),
    "stage_last": (32, 8, 32, 24, 0),
}


@pytest.mark.parametrize("case", list(SPLICES))
def test_splice_ref_matches_numpy(case):
    La, Lx, L, lo, shift = SPLICES[case]
    rng = np.random.default_rng(La * Lx + lo)
    a, x = rng.standard_normal((La, 3)), rng.standard_normal((Lx, 3))
    if shift:  # the last L rows of [a | x]
        want = np.concatenate([a, x])[-L:]
    else:  # a with x written at row lo
        want = a.copy()
        want[lo : lo + Lx] = x
    at, xt = torch.as_tensor(a), torch.as_tensor(x)
    out = tfc.splice(at, xt, L, lo, shift)
    np.testing.assert_array_equal(out.numpy(), want)
    assert out.data_ptr() not in (at.data_ptr(), xt.data_ptr())  # always a copy


# (La, Lx, keep): the carried rows rfft_pack stores beside the spectrum
KEEPS = {
    "history_shorter_than_block": (5, 8, 5),  # OlsConv, hist < B
    "history_longer_than_block": (20, 8, 20),  # OlsConv, hist > B
    "previous_block": (8, 8, 8),  # UpolsConv's prev
    "all_rows": (3, 5, 8),
    "none": (4, 4, 0),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("case", list(KEEPS))
def test_rfft_pack_keeps_the_splice_rows(case, dtype):
    """rfft_pack's kept rows are splice_ref's last rows of [a | x], a new
    tensor of the samples' dtype, and the spectrum is rfft_pack's."""
    La, Lx, keep = KEEPS[case]
    rng = np.random.default_rng(La * 7 + Lx + keep)
    a = torch.as_tensor(rng.standard_normal((La, 3)), dtype=dtype)
    x = torch.as_tensor(rng.standard_normal((Lx, 3)), dtype=dtype)
    X, kept = tfc.rfft_pack(a, x, 32, keep=keep)
    want = tfc.splice_ref(a, x, keep, keep - Lx, La + Lx - keep)
    assert kept.dtype == dtype and torch.equal(kept, want)
    np.testing.assert_array_equal(kept.numpy(), np.concatenate([a.numpy(), x.numpy()])[La + Lx - keep:])
    if keep:
        assert kept.data_ptr() not in (a.data_ptr(), x.data_ptr())  # always a copy
    assert torch.equal(X, tfc.rfft_pack(a, x, 32))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_rfft_pack_reads_inner_blocks(dtype):
    """blocks = 3: x [3·Lx, ch] is three inner blocks, the spectrum's
    columns block-major (the resampler's layout)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3 * 7, 2))
    cols = x.reshape(3, 7, 2).transpose(1, 0, 2).reshape(7, 6)
    X = tfc.rfft_pack(torch.as_tensor(x[:0], dtype=dtype), torch.as_tensor(x, dtype=dtype), 16,
                      blocks=3)
    if dtype == torch.float32:
        cols = cols.astype(np.float32).astype(np.float64)
    want = np.fft.rfft(cols, n=16, axis=0)
    assert tuple(X.shape) == (9, 6) and X.dtype == torch.complex128
    assert _err(X.numpy().real, want.real) <= 1e-12 and _err(X.numpy().imag, want.imag) <= 1e-12


@pytest.mark.parametrize("kind", ["ols", "upols", "nupols"])
def test_engine_state_is_a_copy(kind):
    """The carried input the step returns (OLS history, Upols prev, the
    Nupols head's prev) is the engine's own tensor, not a view of x."""
    rng = np.random.default_rng(9)
    filters = rng.standard_normal((2, 300 if kind != "nupols" else 700)) * 0.1
    eng = {"ols": lambda: tfc.OlsConv(filters, 128), "upols": lambda: tfc.UpolsConv(filters, 64),
           "nupols": lambda: tfc.NupolsConv(filters, 64, 4)}[kind]()
    st = _to_torch(eng.state0())
    B = eng.B
    for _ in range(3):
        x = torch.as_tensor(rng.standard_normal((B, 2)))
        st, _ = eng.step(st, x)
        carried = st if kind == "ols" else st["prev"] if kind == "upols" else st["head"]["prev"]
        start, end = x.data_ptr(), x.data_ptr() + x.numel() * 8
        assert not start <= carried.data_ptr() < end
        x.zero_()  # the caller reuses its buffer
        assert carried.abs().max() > 0


def test_fdl_mac_has_no_fallback_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card gets no plain
    version: the wrapper checks for the kernel and raises."""
    X = torch.zeros((5, 2), dtype=torch.complex128, device="meta")
    H = torch.zeros((1, 5, 2), dtype=torch.complex128, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfc.fdl_mac(X, H)
    with pytest.raises(ValueError, match="no delay line"):
        tfc.fdl_mac_ref(torch.zeros(5, 2, dtype=torch.complex128),
                        torch.zeros(2, 5, 2, dtype=torch.complex128))


@pytest.mark.parametrize("wrapper", ["rfft_pack", "rfft_pack_keep", "irfft_crop", "splice"])
def test_step_kernels_have_no_fallback_off_the_cpu(wrapper):
    x = torch.zeros((8, 2), dtype=torch.float64, device="meta")
    Y = torch.zeros((9, 2), dtype=torch.complex128, device="meta")
    call = {
        "rfft_pack": lambda: tfc.rfft_pack(x, x, 16),
        "rfft_pack_keep": lambda: tfc.rfft_pack(x, x, 16, keep=8),
        "irfft_crop": lambda: tfc.irfft_crop(Y, 16, 8, 8),
        "splice": lambda: tfc.splice(x, x, 8, 0, 8),
    }[wrapper]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        call()
