"""dsp_tpu_torch's float32 mode against dsp_tpu, on the CPU.

dsp_tpu runs its float32 path as its own tests run it
(tests/test_f32_accuracy.py): two-float32 (hi, lo) arithmetic for K1 and
K3, the DfDft transforms for the resampler. The port reads float32, carries
float64 and stores float32 (dsp_tpu_torch/ops/iir.py), so its outputs are
not dsp_tpu float32's bit for bit. Every test holds the port against
dsp_tpu float64 at BASELINE's -120 dBFS budget (test_f32_accuracy.py's
1e-6) and pins it about 10 dB above its own measurement; against dsp_tpu
float32, which carries its own float32 error, it is pinned the same way.
dsp_tpu's float32 chains compile slowly on the CPU (the df scan at block
1000, the DfDft), so each runs once, on 1 s of input, in a module fixture.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import dsp_tpu.ops.iir as jiir
from dsp_tpu.effects import biquad as jbq
import dsp_tpu_torch.ops.iir as tiir
from test_f32_accuracy import CASES, _coeffs, _ref_f64
from torch_parity import FLAGSHIP, FS, dbfs, read_wav, stereo_signal, worst_dbfs, write_wav

BUDGET = 1e-6  # -120 dBFS

# worst sample against dsp_tpu float64, pinned ~10 dB above the measurement:
# (blocked K1-df, K3) per case of test_f32_accuracy.CASES; measured
# blocked -139.7 -138.9 -139.4 -172.1 -138.8 -139.3 -171.8 and K3 -140.4
# -140.8 -140.5 -173.0 -140.4 -139.6 -173.5 dBFS (dsp_tpu float32: blocked
# -139.0 -137.1 -136.6 -165.0 -136.7 -137.0 -165.0, K3 the port's to 0.1 dB)
PINS = {
    "highpass30": (-129.0, -130.0),
    "eq1k+6": (-128.0, -130.0),
    "lowshelf90": (-129.0, -130.0),
    "lowpass_1_30": (-162.0, -163.0),
    "highpass_1_20": (-128.0, -130.0),
    "lowshelf_1_60+6": (-129.0, -129.0),
    "lowpass_1p_25": (-161.0, -163.0),
}


def _f32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


@pytest.mark.parametrize("name,typ,a0,a1,gain", CASES)
def test_blocked_kernel_f32(name, typ, a0, a1, gain):
    """K1-df on one biquad at B = 65536, the twin of test_f32_accuracy's."""
    c = _coeffs(typ, a0, a1, gain)
    x = np.random.default_rng(0).standard_normal((65536, 2)) * 0.3
    ref = _ref_f64(c, x)
    plan = tiir.BiquadBlockedPlan(np.stack([c, c], axis=1))
    _, y = tiir.lti_blocked(plan, torch.zeros((2, 2, 2), dtype=torch.float32), _f32(x))
    assert y.dtype == torch.float32
    err = float(np.abs(y.double().numpy() - ref).max())
    print(f"{name}: {dbfs(err):.1f} dBFS")
    assert err < BUDGET
    assert dbfs(err) <= PINS[name][0]


@pytest.mark.parametrize("name,typ,a0,a1,gain", CASES)
def test_scan_df_fallback_f32(name, typ, a0, a1, gain):
    """K3 at B = 8192 from the coupled form, the twin of
    test_f32_accuracy's."""
    c = _coeffs(typ, a0, a1, gain)
    x = np.random.default_rng(1).standard_normal((8192, 2)) * 0.3
    ref = _ref_f64(c, x)
    A, Bv = tiir._coupled_form_ss(np.stack([c, c], axis=1))
    _, y = tiir.biquad_scan_df(torch.as_tensor(A), torch.as_tensor(Bv),
                               torch.as_tensor(np.full(2, c[0])),
                               torch.zeros((2, 2, 2), dtype=torch.float32), _f32(x))
    err = float(np.abs(y.double().numpy() - ref).max())
    print(f"{name}: {dbfs(err):.1f} dBFS")
    assert err < BUDGET
    assert dbfs(err) <= PINS[name][1]


@pytest.mark.parametrize("order", ["blocked first", "scan first"])
def test_blocked_and_fallback_states_interchangeable(order):
    """Half the signal through K1-df, half through K3 (and the other way
    round): the [2, C, 2] (hi, lo) state hands over."""
    c = _coeffs(jbq.HIGHPASS, 30.0, 0.7071, 0.0)
    x = np.random.default_rng(2).standard_normal((16384, 2)) * 0.3
    ref = _ref_f64(c, x)
    cmat = np.stack([c, c], axis=1)
    plan = tiir.BiquadBlockedPlan(cmat)
    A, Bv = tiir._coupled_form_ss(cmat)
    coef = (torch.as_tensor(A), torch.as_tensor(Bv), torch.as_tensor(np.full(2, c[0])))

    def blocked(st, xx):
        return tiir.lti_blocked(plan, st, _f32(xx))

    def scan(st, xx):
        return tiir.biquad_scan_df(*coef, st, _f32(xx))

    first, second = (blocked, scan) if order == "blocked first" else (scan, blocked)
    st1, y1 = first(torch.zeros((2, 2, 2), dtype=torch.float32), x[:8192])
    assert st1.dtype == torch.float32 and st1[1].abs().max() > 0, "the lo half carries bits"
    _, y2 = second(st1, x[8192:])
    y = np.concatenate([y1.double().numpy(), y2.double().numpy()])
    err = float(np.abs(y - ref).max())
    print(f"{order}: {dbfs(err):.1f} dBFS")
    assert err < BUDGET
    assert dbfs(err) <= -130.0  # measured -140.6 both ways


def test_fused_cascade_matches_unfused():
    """CompiledChain fuses adjacent biquads; fused equals per-effect
    execution in float64, and the float32 fused chain is within the budget
    of it, as test_f32_accuracy's twin holds dsp_tpu."""
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.biquad import FusedBiquadCascade

    spec = "eq 1k 1.0 +3 lowshelf 90 0.7071s +4 highpass 30 0.7071 lowpass 18k 0.7071"
    chain = build_chain_from_string(spec, StreamInfo(FS, 2))
    x = np.random.default_rng(0).standard_normal((65536, 2)) * 0.2
    cc = CompiledChain(chain, block_frames=2048, device="cpu")
    assert any(isinstance(e, FusedBiquadCascade) for e in cc._runtime_effects)
    y_fused = cc.process_array(x, drain=False, discard=False)
    effs = [e for e in chain.effects if not getattr(e, "runtime_noop", False)]
    states = [torch.as_tensor(e.state0()) for e in effs]
    ys = []
    for i in range(0, len(x), 2048):
        xx = torch.as_tensor(x[i:i + 2048])
        for k, e in enumerate(effs):
            states[k], xx = e.step(states[k], xx)
        ys.append(xx.numpy())
    y_ref = np.concatenate(ys)
    assert np.abs(y_fused - y_ref).max() < 1e-12
    cc32 = CompiledChain(chain, block_frames=2048, dtype=torch.float32, device="cpu")
    assert all(s.dtype == torch.float32 for s in cc32.states)
    err = float(np.abs(cc32.process_array(x, drain=False, discard=False) - y_ref).max())
    print(f"fused float32: {dbfs(err):.1f} dBFS")
    assert err < BUDGET
    assert dbfs(err) <= -135.0  # measured -145.9


def test_lti_blocked_df_bank_matches_dsp_tpu():
    """lti_blocked_df's (hi, lo) output at matrix4_mb's bank shape (26
    lanes, 40 states, L = 128), both packages on the same float32 input
    and state: the port's hi + lo carries float64's result (dsp_tpu f64 to
    1e-13 relative), dsp_tpu's df pair comes within its own two-float32
    error, and the port's hi is that sum rounded once."""
    import jax
    import jax.numpy as jnp

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.matrix4_mb import Matrix4MbEffect

    cc = CompiledChain(build_chain_from_string("matrix4_mb -6", StreamInfo(FS, 2)), 2048,
                       device="cpu")
    eff = next(e for e in cc._runtime_effects if isinstance(e, Matrix4MbEffect))
    systems = eff._band_systems()
    tplan = tiir.CascadeBlockedPlan.from_ss(tiir.ss_stack(systems), L=128)
    jplan = jiir.CascadeBlockedPlan.from_ss(jiir.ss_stack(systems), L=128)
    assert (tplan.C, tplan.n) == (26, 40)
    rng = np.random.default_rng(26)
    x = (rng.standard_normal((1024, 26)) * 0.3).astype(np.float32)
    s = rng.standard_normal((26, 40)) * 1e-2
    st = np.stack([s.astype(np.float32), (s - s.astype(np.float32)).astype(np.float32)])
    st_t, (h_t, l_t) = tiir.lti_blocked_df(tplan, torch.as_tensor(st), torch.as_tensor(x))
    # jit: one compile of the whole function beats eager op-by-op dispatch
    st_j, (h_j, l_j) = jax.jit(lambda a, b: jiir.lti_blocked_df(jplan, a, b))(
        jnp.asarray(st), jnp.asarray(x))
    st64, y64 = jax.jit(lambda a, b: jiir.lti_blocked(jplan, a, b))(
        jnp.asarray(st, jnp.float64), jnp.asarray(x, jnp.float64))
    y64 = np.asarray(y64)
    scale = np.abs(y64).max()
    sum_t = h_t.double().numpy() + l_t.double().numpy()
    sum_j = np.asarray(h_j, np.float64) + np.asarray(l_j, np.float64)
    rel_t = np.abs(sum_t - y64).max() / scale
    rel_j = np.abs(sum_j - y64).max() / scale
    s_t = st_t[0].double().numpy() + st_t[1].double().numpy()
    rel_s = np.abs(s_t - np.asarray(st64)[0]).max() / np.abs(np.asarray(st64)[0]).max()
    print(f"bank: port hi + lo {rel_t:.2e}, dsp_tpu df {rel_j:.2e}, state {rel_s:.2e} relative")
    assert rel_t <= 1e-13 and rel_s <= 1e-13
    # dsp_tpu's pair reads the carried state through float32 products
    # (iir.py:618-622): measured 9.9e-8
    assert rel_j <= 3.1e-7
    np.testing.assert_array_equal(h_t.numpy(), sum_t.astype(np.float32))


# --- chains ----------------------------------------------------------------

# (spec, block, pin against dsp_tpu f64, pin against dsp_tpu f32), on 1 s of
# torch_parity.stereo_signal, pinned ~10 dB above the measurement
# (dsp_tpu float32 against float64 on the same input: -136.6, -136.1, -141.3,
# -133.0)
CHAINS = [
    (FLAGSHIP, 2048, -126.0, -128.0),  # measured -136.9, -138.5
    (FLAGSHIP, 1000, -125.0, -128.0),  # measured -135.6, -138.5
    ("resample 48k", 2048, -131.0, -134.0),  # measured -141.4, -144.5
    # K2 in float32 (the Thiran allpass): dsp_tpu f32 gives -133.0
    ("delay -f 0.37m", 2048, -124.0, -124.0),  # measured -134.8, -134.3
]
IDS = ["flagship -b 2048", "flagship -b 1000", "resample 48k", "delay -f (K2 in float32)"]


def _jax32(spec, block):
    import jax.numpy as jnp

    from dsp_tpu.chain import CompiledChain, build_chain_from_string
    from dsp_tpu.core.types import StreamInfo

    return CompiledChain(build_chain_from_string(spec, StreamInfo(FS, 2)), block,
                         dtype=jnp.float32)


@pytest.fixture(scope="module")
def dsp_runs():
    """dsp_tpu's float64 and float32 output of each chain of CHAINS on 1 s
    of input, run once for the module."""
    from torch_parity import jax_chain

    x = stereo_signal(1.0, seed=32)
    out = {}
    for spec, block, _, _ in CHAINS:
        y64 = np.asarray(jax_chain(spec, block).process_array(x))
        out[spec, block] = (y64, np.asarray(_jax32(spec, block).process_array(x), np.float64))
    return x, out


def _port(spec, block, dtype=torch.float32):
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    return CompiledChain(build_chain_from_string(spec, StreamInfo(FS, 2)), block, dtype=dtype,
                         device="cpu")


@pytest.mark.parametrize("spec,block,pin64,pin32", CHAINS, ids=IDS)
def test_chain_f32_matches_dsp_tpu(spec, block, pin64, pin32, dsp_runs):
    from dsp_tpu_torch.chain.chain import expected_out_frames

    x, out = dsp_runs
    y64, y32 = out[spec, block]
    cc = _port(spec, block)
    names = [e.name for e in cc._runtime_effects]
    assert ("biquad(fused-cascade)" in names) == (spec == FLAGSHIP and block == 2048)
    y = cc.process_array(x)
    assert y.shape == y64.shape == y32.shape
    assert len(y) == expected_out_frames(cc.chain, len(x)) - cc.chain.output_discard
    d64, d32 = worst_dbfs(y, y64), worst_dbfs(y, y32)
    print(f"{spec} -b {block}: {d64:.1f} dBFS against dsp_tpu f64, {d32:.1f} against f32; "
          f"dsp_tpu f32 against f64 {worst_dbfs(y32, y64):.1f}")
    assert d64 <= -120.0
    assert d64 <= pin64
    assert d32 <= pin32


@pytest.mark.parametrize("first", ["dsp_tpu", "dsp_tpu_torch"])
def test_f32_checkpoint_crosses_packages(first, tmp_path):
    """Half a float32 stream in one package, save_state, load_state in the
    other's float32 chain, finish there: within the budget of dsp_tpu
    float64's uninterrupted pass. A float64 chain refuses the checkpoint."""
    from dsp_tpu_torch.chain import ChainError
    from torch_parity import jax_chain

    block = 2048
    x = stereo_signal(1.0, seed=33)
    half = 10 * block
    whole = np.asarray(jax_chain(FLAGSHIP, block).process_array(x))

    def make(pkg):
        return _port(FLAGSHIP, block) if pkg == "dsp_tpu_torch" else _jax32(FLAGSHIP, block)

    second = "dsp_tpu_torch" if first == "dsp_tpu" else "dsp_tpu"
    a = make(first)
    y1 = np.asarray(a.process_array(x[:half], drain=False), np.float64)
    ckpt = tmp_path / "state.npz"
    a.save_state(str(ckpt))
    with np.load(ckpt) as z:
        assert {z[k].dtype for k in z.files if k.startswith("leaf_")} == {np.dtype(np.float32)}
    b = make(second)
    b.load_state(str(ckpt))
    y2 = np.asarray(b.process_array(x[half:]), np.float64)
    y = np.concatenate([y1, y2])
    assert y.shape == whole.shape
    err = worst_dbfs(y, whole)
    print(f"{first} first: {err:.1f} dBFS")
    assert err <= -127.0  # measured -137.1 both ways
    with pytest.raises(ChainError, match="mismatch"):
        _port(FLAGSHIP, block, torch.float64).load_state(str(ckpt))


def test_cli_float32_writes_the_library_output(tmp_path, monkeypatch):
    """DSP_TPU_TORCH_DTYPE=float32 dsp-torch renders the file that
    CompiledChain(dtype=float32).process_array gives, sample for sample."""
    from dsp_tpu_torch.cli.main import main

    x = stereo_signal(0.5, seed=34)
    src, out = tmp_path / "in.wav", tmp_path / "out.wav"
    write_wav(src, x)
    monkeypatch.setenv("DSP_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DSP_TPU_TORCH_DTYPE", "float32")
    assert main(["-q", str(src), "-o", "-e", "double", str(out), *FLAGSHIP.split()]) == 0
    want = _port(FLAGSHIP, 2048).process_array(x)
    got = read_wav(out)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert worst_dbfs(got, _port(FLAGSHIP, 2048, torch.float64).process_array(x)) <= -120.0


def _fir_file(tmp_path):
    path = tmp_path / "h.wav"
    write_wav(path, np.random.default_rng(0).standard_normal((64, 1)) * 0.1)
    return path


# chain, the bound of its float32 render against its float64 render on the
# CLI test's input: the budget; None for matrix4_mb, whose free run from the
# stream's start flips its engines' decisions under any rounding (PARITY.md;
# tests/test_torch_f32_matrix4.py holds its float32 path by the control
# split)
J3_CLI = {
    "fir": ("gain -3 fir {h}", -120.0),
    "matrix4": ("matrix4 -6", -120.0),
    "matrix4_mb": ("matrix4_mb -6", None),
}


@pytest.mark.parametrize("name", list(J3_CLI))
def test_cli_float32_writes_the_library_output_j3(name, tmp_path, monkeypatch):
    """test_cli_float32_writes_the_library_output for the chains slice J3
    brought to float32 (the FFT convolution step, matrix4, matrix4_mb), on
    0.05 s at half the level (an upmix's front outputs must not clip in the
    CLI's writer): the CLI's file equals CompiledChain(dtype=float32)'s
    output sample for sample."""
    from dsp_tpu_torch.cli.main import main

    spec, bound = J3_CLI[name]
    spec = spec.format(h=_fir_file(tmp_path))
    x = 0.5 * stereo_signal(0.05, seed=35)
    src, out = tmp_path / "in.wav", tmp_path / "out.wav"
    write_wav(src, x)
    monkeypatch.setenv("DSP_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DSP_TPU_TORCH_DTYPE", "float32")
    assert main(["-q", str(src), "-o", "-e", "double", str(out), *spec.split()]) == 0
    want = _port(spec, 2048).process_array(x)
    got = read_wav(out)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()
    if bound is not None:
        err = worst_dbfs(got, _port(spec, 2048, torch.float64).process_array(x))
        print(f"{name}: float32 against float64 {err:.1f} dBFS")
        assert err <= bound


@pytest.mark.parametrize("spec,name,slice_", [
    ("gain -3 noise -90", "noise", "J4"),
    ("eq 1k 1.0 +3 dither", "dither", "J4"),
    ("delay -m 0.5m 10m", "delay", "J4"),
])
def test_float32_chain_refuses_unported_effect(spec, name, slice_, tmp_path, monkeypatch):
    """The chains once refused in float32 until slice J4 build there now,
    with every float state leaf float32 (keys and counters keep their
    integer dtypes), and run through dsp-torch with DSP_TPU_TORCH_DTYPE=f32:
    the CLI's file equals CompiledChain(dtype=float32)'s output sample for
    sample (numpy's global generator seeded alike before each build). The
    CLI's output writer draws its dither seeds from that generator before
    the noise effect draws its key, so the CLI's noise is another draw of
    the same level: that file is held within twice the noise's peak."""
    from dsp_tpu_torch.cli.main import main
    from dsp_tpu_torch.convert import flatten_states

    cc = _port(spec, 2048)
    assert any(e.name == name for e in cc._runtime_effects)
    leaves = flatten_states(cc.states)[0]
    assert {t.dtype for t in leaves if t.dtype.is_floating_point} <= {torch.float32}
    assert torch.uint32 in {t.dtype for t in leaves}  # the effect's threefry key
    x = 0.5 * stereo_signal(0.1)  # below full scale, so the CLI's writer clips nothing
    src, out = tmp_path / "in.wav", tmp_path / "out.wav"
    write_wav(src, x)
    monkeypatch.setenv("DSP_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DSP_TPU_TORCH_DTYPE", "f32")
    np.random.seed(7)
    assert main(["-q", "-D", str(src), "-o", "-e", "double", str(out), *spec.split()]) == 0
    np.random.seed(7)
    want = _port(spec, 2048).process_array(x)
    got = read_wav(out)
    assert got.shape == want.shape and np.isfinite(got).all()
    if name == "noise":
        assert worst_dbfs(got, want) <= -90.0 + 20 * np.log10(2.0) + 1e-9
    else:
        np.testing.assert_array_equal(got, want)
    assert slice_ == "J4"


UPMIX_EXAMPLES = sorted(p.name for p in (Path(__file__).resolve().parents[1] / "examples").iterdir()
                        if p.name.startswith("matrix4"))


@pytest.mark.parametrize("name", UPMIX_EXAMPLES)
def test_example_builds_in_float32(name):
    """Every shipped upmix example (matrix4, and matrix4_mb with its FIR,
    the direct path and 6 channels) builds in a float32 chain: none of
    their effects is refused, and every float state leaf is float32."""
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_args
    from dsp_tpu_torch.convert import flatten_states
    from dsp_tpu_torch.core.types import StreamInfo

    example = Path(__file__).resolve().parents[1] / "examples" / name
    cc = CompiledChain(build_chain_from_args([f"@{example}"], StreamInfo(FS, 2)), 2048,
                       dtype=torch.float32, device="cpu")
    dtypes = {t.dtype for t in flatten_states(cc.states)[0] if t.dtype.is_floating_point}
    assert dtypes <= {torch.float32}


@pytest.mark.parametrize("value,want", [(None, torch.float64), ("float32", torch.float32),
                                        ("F32", torch.float32), ("float64", torch.float64),
                                        ("f64", torch.float64)])
def test_resolve_dtype(value, want, monkeypatch):
    from dsp_tpu_torch import config

    if value is None:
        monkeypatch.delenv(config.DTYPE_ENV, raising=False)
    else:
        monkeypatch.setenv(config.DTYPE_ENV, value)
    assert config.resolve_dtype() == want
    assert config.resolve_dtype(torch.float32) == torch.float32
    with pytest.raises(ValueError, match="unknown sample dtype"):
        config.resolve_dtype("float16")


def test_kernel_wrappers_refuse_the_other_dtype():
    """The float64 kernels refuse float32 tensors and the float32 entry
    points refuse float64, on every device (a CPU tensor included)."""
    from dsp_tpu_torch.ops import fft_conv, resample_ops

    plan = tiir.BiquadBlockedPlan(tiir.make_identity_biquad(2))
    f64, f32 = torch.zeros((256, 2), dtype=torch.float64), torch.zeros((256, 2))
    st64, st32 = torch.zeros((2, 2, 2), dtype=torch.float64), torch.zeros((2, 2, 2))
    A, Bv, c0 = (torch.zeros(s, dtype=torch.float64) for s in ((2, 2, 2), (2, 2), (2,)))
    calls = [
        lambda: tiir.lti_blocked(plan, st32, f64),  # float64 x, float32 state
        lambda: tiir.lti_blocked_f32(plan, st64, f32),
        lambda: tiir.biquad_scan(A.float(), Bv, c0, st64[0], f64),
        lambda: tiir.biquad_scan_f32(A, Bv.float(), c0.float(), st32[0], f32),
        lambda: tiir.biquad_scan_df(A.float(), Bv, c0, st32, f32),
        lambda: tiir.biquad_scan_df(A, Bv, c0, st64, f32),
        lambda: fft_conv.rfft_pack_f32(f64, 512),
        lambda: resample_ops.irfft_ola_f32(torch.zeros((257, 2), dtype=torch.complex128), 512,
                                           torch.zeros((256, 2), dtype=torch.float64), 1.0),
    ]
    # slice J4's float32 entries, and their float64 ones given a float32 leaf
    from dsp_tpu_torch.ops import time_domain as td

    key, sel = torch.zeros(2, dtype=torch.uint32), torch.ones(2, dtype=torch.bool)
    v64, v32 = torch.zeros(2, dtype=torch.float64), torch.zeros(2)
    e64, e32 = torch.zeros((9, 2), dtype=torch.float64), torch.zeros((9, 2))
    fir64, fir32 = torch.zeros(9, dtype=torch.float64), torch.zeros(9)

    def stats_state(dt):
        s = {k: torch.zeros(2, dtype=dt) for k in ("sum", "sum_sq", "min", "max", "peak")}
        s.update(peak_count=torch.zeros(2, dtype=torch.int64),
                 peak_frame=torch.zeros(2, dtype=torch.int64),
                 samples=torch.zeros((), dtype=torch.int64),
                 limit=torch.tensor(1 << 62))
        return s

    yk64, yk32 = torch.zeros((4, 2), dtype=torch.float64), torch.zeros((4, 2))
    t64, t32 = torch.zeros((), dtype=torch.float64), torch.zeros(())
    buf64, buf32 = torch.zeros((80, 2), dtype=torch.float64), torch.zeros((80, 2))
    calls += [
        lambda: td.tpdf_noise_f32(key, f64, 1e-3),
        lambda: td.tpdf_dither_f32(key, f64, e32, v32, v32, v32, v32, sel, fir32, td.DITHER_FLAT),
        lambda: td.tpdf_dither(key, f64, e32, v64, v64, v64, v64, sel, fir64, td.DITHER_FLAT),
        lambda: td.levels_step_f32(v32, v32, v32, f64, 0.01),
        lambda: td.levels_step(v32, v64, v64, f64, 0.01),
        lambda: td.stats_step_f32(stats_state(torch.float32), f64),
        lambda: td.stats_step(stats_state(torch.float32), f64),
        lambda: td.mod_delay_f32(key, yk32, t32, buf32, f64, sel, None, 30.0, 1e-3, 3, 0),
        lambda: td.mod_delay(key, yk64, t32, buf64, f64, sel, None, 30.0, 1e-3, 3, 0),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="the kernel takes"):
            call()


# --- the float32 forms' plain versions ---------------------------------------


def test_biquad_scan_f32_ref_is_the_scan():
    """biquad_scan_f32_ref (the kernel's order of operations) computes K2:
    in float64 it equals the doubling scan to rounding, at block sizes
    that fill one warp, several and the 1024-thread cap."""
    rng = np.random.default_rng(3)
    for B in (1, 33, 1000, 20000):
        r, th = rng.uniform(0.3, 0.99, 3), rng.uniform(0.01, 3.0, 3)
        A = np.zeros((3, 2, 2))
        A[:, 0, 0], A[:, 0, 1], A[:, 1, 0] = 2 * r * np.cos(th), 1.0, -r * r
        args = [torch.as_tensor(a) for a in (A, rng.standard_normal((3, 2)),
                                             rng.standard_normal(3), rng.standard_normal((3, 2)),
                                             rng.standard_normal((B, 3)))]
        s1, y1 = tiir.biquad_scan_ref(*args)
        s2, y2 = tiir.biquad_scan_f32_ref(*args)
        assert float((y1 - y2).abs().max()) <= 1e-13 * max(1.0, float(y1.abs().max()))
        assert float((s1 - s2).abs().max()) <= 1e-13 * max(1.0, float(s1.abs().max()))


@pytest.mark.parametrize("out_fs", [48000, 192000])
def test_resample_f32_step_is_the_f64_step_rounded(out_fs):
    """The float32 resampler step (rfft_pack_f32, the fold, irfft_ola_f32)
    is the float64 step on the upcast input, with each block's tail
    rounded to float32 as the carried overlap is, and y rounded once."""
    from dsp_tpu_torch.ops.resample_ops import SpectralResampler

    rs = SpectralResampler(FS, out_fs)
    rng = np.random.default_rng(out_fs)
    n = 3
    x = _f32(rng.standard_normal((n * rs.in_len, 2)) * 0.3)
    ov = _f32(rng.standard_normal((rs.out_len, 2)) * 0.1)
    ov32, y32 = rs.block(ov, x)
    assert ov32.dtype == y32.dtype == torch.float32
    assert y32.shape == (n * rs.out_len, 2)
    ov64, ys = ov.double(), []
    for i in range(n):  # one inner block at a time through the float64 step
        ov64, y = rs.block(ov64, x[i * rs.in_len:(i + 1) * rs.in_len].double())
        ys.append(y)
        ov64 = ov64.float().double()
    ulp = float(torch.cat(ys).abs().max()) * 2.0 ** -23
    np.testing.assert_allclose(y32.numpy(), torch.cat(ys).float().numpy(), rtol=0, atol=ulp)
    np.testing.assert_allclose(ov32.numpy(), ov64.float().numpy(), rtol=0, atol=ulp)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_biquad_scan_auto_matches_dsp_tpu(dtype):
    """biquad_scan_auto from host coefficients: K3 under float32, the
    coupled form on K2 under float64, with the state as one array; against
    dsp_tpu's in float64 (the 10 Hz shelf of matrix4_mb's fshape and the
    30 Hz highpass, the near-DC poles it exists for)."""
    import jax.numpy as jnp

    c = np.stack([_coeffs(jbq.LOWSHELF, 10.0, 0.7071, -6.0),
                  _coeffs(jbq.HIGHPASS, 30.0, 0.7071, 0.0)], axis=1)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4000, 2)) * 0.3
    st = rng.standard_normal((2, 2)) * 1e-3
    s_j, y_j = jiir.biquad_scan_auto(c, jnp.asarray(st), jnp.asarray(x))
    tdt = getattr(torch, dtype)
    s_t, y_t = tiir.biquad_scan_auto(c, torch.as_tensor(st, dtype=tdt),
                                     torch.as_tensor(x, dtype=tdt))
    assert y_t.dtype == s_t.dtype == tdt
    err = max(float(np.abs(y_t.double().numpy() - np.asarray(y_j)).max()),
              float(np.abs(s_t.double().numpy() - np.asarray(s_j)).max()))
    print(f"{dtype}: {dbfs(err):.1f} dBFS")
    assert dbfs(err) <= (-135.0 if dtype == "float32" else -283.0)  # measured -145.0, -313.1
