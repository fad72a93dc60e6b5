"""dsp_tpu_torch's float32 FFT convolution (K5-K7 in float32) against
dsp_tpu, on the CPU.

dsp_tpu runs its FFT convolution in complex64 under float32
(dsp_tpu/ops/fft_conv.py:97, :144, :220). The port reads float32, transforms
and multiplies in float64 against the complex128 spectra, keeps the FDL as
float32 (re, im) pairs (dsp_tpu's leaf) and stores float32
(dsp_tpu_torch/ops/fft_conv.py). The six effects that run on the engines
(fir, fir_p, zita_convolver, hilbert, decorrelate, the biquads' -r) are held
against dsp_tpu float64 at BASELINE's -120 dBFS budget, each pinned about
10 dB above its measurement, at blocks whose filters pick the overlap-save
(OLS), uniform (Upols) and two-group (Nupols) engines. dsp_tpu's float64
renders run once, in a module fixture. A Nupols checkpoint crosses both
ways with dsp_tpu float32 (complex64: no two-float32 compile). The four
float32 kernels' plain versions are held against the float64 plain versions
fed the same values.
"""

import numpy as np
import pytest
import torch

from torch_parity import FS, jax_chain, stereo_signal, worst_dbfs, write_wav

BUDGET_DBFS = -120.0


def _coefs(seed, n):
    """n seeded taps of unit energy: the output keeps the input's level, so
    a float32 error is measured against a signal near full scale."""
    h = np.random.default_rng(seed).uniform(-1.0, 1.0, n)
    return ",".join(f"{v:.17g}" for v in h / np.sqrt((h * h).sum()))


# id -> (chain with a {wav} placeholder, block, the engine it picks, pin in
# dBFS against dsp_tpu float64, ~10 dB above the measurement on 0.5 s of
# torch_parity.stereo_signal)
CHAINS = {
    "fir OLS": ("fir {wav}", 2048, "OlsConv", -136.0),  # measured -146.5
    "fir Upols": ("fir {wav}", 512, "UpolsConv", -134.0),  # -144.4
    "fir_p Nupols": (f"fir_p coefs:{_coefs(4, 9000)}", 128, "NupolsConv", -133.0),  # -143.4
    "zita_convolver Upols": (f"zita_convolver 64 8192 coefs:{_coefs(5, 5000)}", 256,
                             "UpolsConv", -135.0),  # -145.6
    "hilbert OLS": ("hilbert -c 31", 2048, "OlsConv", -136.0),  # -146.2
    "decorrelate Upols": ("decorrelate -s 7", 1000, "UpolsConv", -133.0),  # -143.9
    "biquad -r Upols": ("lowpass -r 1k 0.7071 highpass -r 120 0.7071", 2048, "UpolsConv",
                        -145.0),  # -155.3
}
SECONDS = 0.5


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    """The filter file, the input and dsp_tpu float64's output of every
    chain of CHAINS, once for the module."""
    tmp = tmp_path_factory.mktemp("f32_fft")
    h = np.random.default_rng(42).standard_normal((3000, 1))
    h /= np.sqrt((h * h).sum())  # unit energy, as _coefs
    wav = tmp / "h3000.wav"
    write_wav(wav, h)
    x = stereo_signal(SECONDS, seed=71)
    out = {}
    for name, (spec, block, _, _) in CHAINS.items():
        out[name] = np.asarray(jax_chain(spec.format(wav=wav), block).process_array(x))
    return wav, x, out


def _port(spec, block, dtype=torch.float32):
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    return CompiledChain(build_chain_from_string(spec, StreamInfo(FS, 2)), block, dtype=dtype,
                         device="cpu")


def _engine(cc):
    eff = next(e for e in cc._runtime_effects if hasattr(e, "_engines"))
    return type(eff._engine(cc.block_frames)).__name__


@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_f32_matches_dsp_tpu(name, renders):
    from dsp_tpu_torch.chain.chain import expected_out_frames

    wav, x, out = renders
    spec, block, engine, pin = CHAINS[name]
    np.random.seed(0)  # decorrelate draws no numpy seed; keep the build reproducible anyway
    cc = _port(spec.format(wav=wav), block)
    assert _engine(cc) == engine
    assert all(t.dtype in (torch.float32, torch.int32) for t in _leaves(cc.states))
    y = cc.process_array(x)
    assert y.shape == out[name].shape
    assert len(y) == expected_out_frames(cc.chain, len(x)) - cc.chain.output_discard
    err = worst_dbfs(y, out[name])
    print(f"{name} -b {block}: {err:.1f} dBFS against dsp_tpu f64")
    assert err <= BUDGET_DBFS
    assert err <= pin


def _leaves(tree):
    from dsp_tpu_torch.convert import flatten_states

    return flatten_states(tree)[0]


def _jax32(spec, block):
    import jax.numpy as jnp

    from dsp_tpu.chain import CompiledChain, build_chain_from_string
    from dsp_tpu.core.types import StreamInfo

    return CompiledChain(build_chain_from_string(spec, StreamInfo(FS, 2)), block,
                         dtype=jnp.float32)


@pytest.mark.parametrize("first", ["dsp_tpu", "dsp_tpu_torch"])
def test_nupols_f32_checkpoint_crosses_packages(first, tmp_path):
    """Half a float32 fir_p stream (Nupols m = 8 with its Upols head) in one
    package, save_state mid-super-block, load_state in the other's float32
    chain, finish there: within the budget of dsp_tpu float64's
    uninterrupted pass, pinned ~10 dB above the worse crossing; dsp_tpu
    float32's complex64 transforms set it (alone, uninterrupted: -131.2
    dBFS). The checkpoint's leaves are float32 but the block counter `cnt`
    (int32), the FDLs float32 (re, im) pairs in both."""
    spec, block = f"fir_p coefs:{_coefs(6, 9000)}", 128
    x = stereo_signal(0.25, seed=72)
    whole = np.asarray(jax_chain(spec, block).process_array(x))
    alone = np.asarray(_jax32(spec, block).process_array(x), np.float64)
    half = 45 * block  # 5 super-blocks of 8, and 5 blocks into the sixth

    def make(pkg):
        return _port(spec, block) if pkg == "dsp_tpu_torch" else _jax32(spec, block)

    a = make(first)
    if first == "dsp_tpu_torch":
        eng = a._runtime_effects[0]._engine(block)
        assert (type(eng).__name__, eng.m) == ("NupolsConv", 8)
    y1 = np.asarray(a.process_array(x[:half], drain=False), np.float64)
    ckpt = tmp_path / "state.npz"
    a.save_state(str(ckpt))
    with np.load(ckpt) as z:
        dtypes = sorted({str(z[k].dtype) for k in z.files if k.startswith("leaf_")})
        assert dtypes == ["float32", "int32"]
        counters = [int(z[k]) for k in z.files if k.startswith("leaf_") and z[k].dtype == np.int32]
        assert counters == [5]
    b = make("dsp_tpu" if first == "dsp_tpu_torch" else "dsp_tpu_torch")
    b.load_state(str(ckpt))
    y2 = np.asarray(b.process_array(x[half:]), np.float64)
    y = np.concatenate([y1, y2])
    assert y.shape == whole.shape
    err = worst_dbfs(y, whole)
    print(f"{first} first: {err:.1f} dBFS; dsp_tpu float32 alone {worst_dbfs(alone, whole):.1f}")
    assert err <= BUDGET_DBFS
    assert err <= -121.0  # measured -136.1 (dsp_tpu first), -131.2 (port first)


# --- the float32 kernels' plain versions --------------------------------------


def test_float32_step_kernels_are_the_float64_ones_rounded():
    """rfft_pack_f32 with a head, fdl_mac_f32, irfft_crop_f32 with the
    Nupols addend and splice_f32 against the float64 plain versions fed the
    same values: the spectra and sums within 1e-12 relative, the float32
    outputs the float64 results rounded once (within one float32 ulp of
    their scale), the shifted FDL and the splice exact."""
    from dsp_tpu_torch.ops import fft_conv as fc

    rng = np.random.default_rng(73)

    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape) * 0.3, dtype=torch.float32)

    a, x, N = f32(700, 2), f32(1300, 2), 2400
    X32 = fc.rfft_pack(a, x, N)  # dispatches on x's dtype
    X64 = fc.rfft_pack_ref(a.double(), x.double(), N)
    assert X32.dtype == torch.complex128 and X32.shape == (N // 2 + 1, 2)
    assert float((X32 - X64).abs().max()) <= 1e-12 * float(X64.abs().max())
    np.testing.assert_array_equal(fc.rfft_pack_f32(x, N).numpy(),
                                  fc.rfft_pack_ref(x[:0].double(), x.double(), N).numpy())

    K, NB = 5, N // 2 + 1
    H = torch.as_tensor(rng.standard_normal((K, NB, 2)) + 1j * rng.standard_normal((K, NB, 2)))
    fdl = f32(K, NB, 2, 2)
    Y32, fdl32 = fc.fdl_mac_f32(X32, H, fdl)
    Y64, fdl64 = fc.fdl_mac_ref(X32, H, fdl.double())
    assert fdl32.dtype == torch.float32
    assert float((Y32 - Y64).abs().max()) <= 1e-12 * float(Y64.abs().max())
    np.testing.assert_array_equal(fdl32.numpy(), fdl64.float().numpy())
    np.testing.assert_array_equal(fdl32[1:].numpy(), fdl[:-1].numpy())
    Y1, none = fc.fdl_mac_f32(X32, H[:1])
    assert none is None and torch.equal(Y1, X32 * H[0])

    add = f32(600, 2)
    y32 = fc.irfft_crop_f32(Y32, N, 900, 600, add)
    y64 = fc.irfft_crop_ref(Y32, N, 900, 600, add.double())
    ulp = 2.0 ** (np.floor(np.log2(float(y64.abs().max()))) - 23)
    assert y32.dtype == torch.float32
    assert float((y32.double() - y64).abs().max()) <= 0.5 * ulp
    np.testing.assert_array_equal(fc.irfft_crop_f32(Y32, N, 0, 256).numpy(),
                                  fc.irfft_crop_ref(Y32, N, 0, 256).float().numpy())

    for L, lo, shift in ((700, 0, 1300), (1000, 300, 0), (1300, 0, 0)):
        got = fc.splice(a, x, L, lo, shift)  # dispatches on x's dtype
        want = fc.splice_ref(a.double(), x.double(), L, lo, shift)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.float().numpy())


def test_float32_step_kernels_refuse_the_other_dtype():
    """Each float32 form refuses float64 samples or states and the float64
    multiply-accumulate and crop refuse float32 ones, on every device (a
    CPU tensor included); rfft_pack and splice take their float32 form on
    float32 samples."""
    from dsp_tpu_torch.ops import fft_conv as fc

    f64, f32 = torch.zeros((64, 2), dtype=torch.float64), torch.zeros((64, 2))
    X = torch.zeros((65, 2), dtype=torch.complex128)
    H = torch.zeros((2, 65, 2), dtype=torch.complex128)
    calls = [
        lambda: fc.rfft_pack_f32(f32, 128, f64),
        lambda: fc.fdl_mac_f32(X, H, torch.zeros((2, 65, 2, 2), dtype=torch.float64)),
        lambda: fc.fdl_mac_f32(X.to(torch.complex64), H, torch.zeros((2, 65, 2, 2))),
        lambda: fc.irfft_crop_f32(X, 128, 0, 64, f64),
        lambda: fc.irfft_crop_f32(X.to(torch.complex64), 128, 0, 64),
        lambda: fc.splice_f32(f64, f32, 64, 0, 0),
        lambda: fc.fdl_mac(X, H, torch.zeros((2, 65, 2, 2))),
        lambda: fc.irfft_crop(X, 128, 0, 64, f32),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="the kernel takes"):
            call()
    assert fc.splice(f32, f32, 64, 0, 0).dtype == torch.float32
    assert fc.splice(f64, f64, 64, 0, 0).dtype == torch.float64
    assert fc.irfft_crop(X, 128, 0, 64).dtype == torch.float64
    assert fc.rfft_pack(f32[:0], f32, 128).dtype == torch.complex128
