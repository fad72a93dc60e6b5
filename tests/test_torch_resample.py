"""Slice D of dsp_tpu_torch against dsp_tpu, on the CPU in float64: the
spectral resampler (K8) and the resample effect.

The port's wrappers run their plain versions here (ops/resample_ops.py,
ops/fft_conv.py). Tolerances and why:
* the plan and its tables: equal (the same host numpy code).
* one resampler step, and every chain: -280 dBFS, the chain limit of
  torch_parity. Both packages sum the same products; the FFTs are pocketfft
  (torch) and XLA's (jax), which round differently. Measured: -302 to -306
  dBFS on 1 s of stereo noise and sines, blocks 2048 and 1000.
* the fold's plain version against numpy: equal (the same products,
  added in table order).
* the C goldens (tests/goldens/resample_*.npz): -180 dBFS, as
  test_goldens.py holds dsp_tpu to them.
* frame counts: exact.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from torch_parity import CHAIN_LIMIT_DBFS, FS, jax_chain, port_chain, read_wav, stereo_signal, worst_dbfs, write_wav

REPO = Path(__file__).resolve().parents[1]

PLANS = [
    (44100, 48000, 0.939), (48000, 44100, 0.939), (44100, 192000, 0.939),
    (44100, 22050, 0.939), (44100, 88200, 0.939), (88200, 44100, 0.939),
    (44100, 48000, 0.7), (44100, 48000, 0.999),
]


def _plans(in_fs, out_fs, bw):
    from dsp_tpu.ops.resample_ops import SpectralResampler as J
    from dsp_tpu_torch.ops.resample_ops import SpectralResampler as T

    return T(in_fs, out_fs, bw), J(in_fs, out_fs, bw)


@pytest.mark.parametrize("in_fs,out_fs,bw", PLANS)
def test_plan_and_tables_equal_dsp_tpu(in_fs, out_fs, bw):
    t, j = _plans(in_fs, out_fs, bw)
    for k in ("n", "d", "in_len", "out_len", "out_delay", "filter_len", "sinc_fr_len", "sinc_os",
              "width", "fc"):
        assert getattr(t, k) == getattr(j, k), k
    for k in ("tab_j", "tab_k", "tab_l", "tab_c1", "tab_c2", "tab_s", "sinc_fr"):
        a, b = getattr(t, k), getattr(j, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("in_fs,out_fs,bw", PLANS[:4])
def test_fold_ref_equals_numpy_segment_sum(in_fs, out_fs, bw):
    """The CSR fold's plain version against a direct numpy gather,
    multiply and segment sum (np.add.at adds in table order)."""
    from dsp_tpu_torch.ops.resample_ops import resample_fold

    t, _ = _plans(in_fs, out_fs, bw)
    rng = np.random.default_rng(in_fs + out_fs)
    X = rng.standard_normal((t.in_len + 1, 6)) + 1j * rng.standard_normal((t.in_len + 1, 6))
    g = X[t.tab_j]
    g = np.where(t.tab_c1[:, None], np.conj(g), g)
    s = t.tab_s[:, None]
    # (ac - bd) + (ad + bc)i, each product and sum rounded once: numpy's
    # own complex product fuses one product of each part into an FMA
    v = (g.real * s.real - g.imag * s.imag) + 1j * (g.real * s.imag + g.imag * s.real)
    v = np.where(t.tab_c2[:, None], np.conj(v), v)
    want = np.zeros((t.out_len + 1, 6), dtype=np.complex128)
    np.add.at(want, t.tab_l, v)
    got = resample_fold(torch.as_tensor(X), t.fold).numpy()
    np.testing.assert_array_equal(got, want)
    # every entry of the walk lands in exactly one bin, in table order
    assert t.fold.ptr[-1] == len(t.tab_l) and t.fold.pad_mask.sum() == len(t.tab_l)


@pytest.mark.parametrize("in_fs,out_fs", [(44100, 48000), (44100, 192000), (44100, 22050)])
@pytest.mark.parametrize("n_inner", [1, 4])
def test_block_matches_dsp_tpu(in_fs, out_fs, n_inner):
    """The port's batched step (inner blocks as columns) against dsp_tpu's
    block, scanned over the inner blocks, from a nonzero overlap."""
    import jax.numpy as jnp

    t, j = _plans(in_fs, out_fs, 0.939)
    rng = np.random.default_rng(n_inner)
    x = rng.standard_normal((n_inner * t.in_len, 3)) * 0.3
    ov = rng.standard_normal((t.out_len, 3)) * 0.1
    ov_t, y_t = t.block(torch.as_tensor(ov), torch.as_tensor(x))
    ov_j, ys = jnp.asarray(ov), []
    for i in range(n_inner):
        ov_j, y = j.block(ov_j, jnp.asarray(x[i * t.in_len:(i + 1) * t.in_len]))
        ys.append(np.asarray(y))
    assert y_t.shape == (n_inner * t.out_len, 3)
    assert worst_dbfs(y_t.numpy(), np.concatenate(ys)) <= CHAIN_LIMIT_DBFS
    assert worst_dbfs(ov_t.numpy(), np.asarray(ov_j)) <= CHAIN_LIMIT_DBFS


CHAINS = ["resample 48k", "resample 96000", "resample 22050", "resample 0.8 x2",
          "eq 1k 1.0 +3 resample 48k gain -1"]


@pytest.mark.parametrize("block", [2048, 1000])
@pytest.mark.parametrize("spec", CHAINS)
def test_chain_matches_dsp_tpu(spec, block):
    x = stereo_signal(1.0, seed=len(spec))[:44100 - 37]  # not a quantum multiple
    t = port_chain(spec, block)
    j = jax_chain(spec, block)
    assert t.block_frames == j.block_frames and t.out_frames == j.out_frames
    y_t = t.process_array(x)
    y_j = np.asarray(j.process_array(x))
    from dsp_tpu_torch.chain.chain import expected_out_frames

    assert y_t.shape == y_j.shape
    assert len(y_t) == expected_out_frames(t.chain, len(x)) - t.chain.output_discard
    assert worst_dbfs(y_t, y_j) <= CHAIN_LIMIT_DBFS


def test_chain_passes_match_dsp_tpu():
    """Latency, drain and discard of a rate change, in both packages."""
    from dsp_tpu.chain import build_chain_from_string as jbuild
    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    for spec in CHAINS + ["resample 192k", ":0 delay 3 resample 48k"]:
        a = build_chain_from_string(spec, StreamInfo(FS, 2))
        b = jbuild(spec, JStream(FS, 2))
        assert [e.name for e in a.effects] == [e.name for e in b.effects]
        for k in ("drain_frames", "drain_out_frames", "output_discard", "ratio"):
            assert getattr(a, k) == getattr(b, k), (spec, k)
        assert (a.ostream.fs, a.ostream.channels) == (b.ostream.fs, b.ostream.channels)


@pytest.mark.parametrize("name,spec,rate", [
    ("resample_up_96k", "sine:freq=35-16k+0.25", "96000"),
    ("resample_down_22k", "sine:freq=35-16k+0.25", "22050"),
    ("resample_48k", "sine:freq=35-16k+0.25", "48k"),
])
def test_c_goldens_through_the_port_cli(name, spec, rate, tmp_path, monkeypatch):
    """tests/goldens' renders of the C build (golden_cases.py), through
    dsp-torch: the sgen input is written by the port's CLI (its sgen codec,
    bit for bit dsp_tpu's: test_torch_codecs.py), then resampled by the
    port's CLI, raw f64 to raw f64."""
    from dsp_tpu_torch.cli.main import main as dsp_torch

    monkeypatch.setenv("DSP_TPU_TORCH_DEVICE", "cpu")
    src, out = tmp_path / "in.raw", tmp_path / "out.raw"
    assert dsp_torch(["-q", "-t", "sgen", spec, "-o", "-t", "pcm", "-e", "double", str(src)]) == 0
    assert dsp_torch(["-q", "-t", "pcm", "-e", "double", "-r", str(FS), "-c", "1", str(src),
                      "-o", "-t", "pcm", "-e", "double", str(out), "resample", rate]) == 0
    got = np.fromfile(out, dtype=np.float64)
    want = np.load(REPO / "tests" / "goldens" / f"{name}.npz")["y"]
    assert got.shape == want.shape
    assert 20 * math.log10(float(np.abs(got - want).max())) <= -180.0


@pytest.mark.parametrize("args", [
    ["resample"], ["resample", "0.9", "48k", "x"], ["resample", "abc"], ["resample", "0.5", "48k"],
    ["resample", "1.5", "48k"], ["resample", "q", "48k"], ["resample", "x0"], ["resample", "xq"],
    ["resample", "/11"], ["resample", "/0"], ["resample", "-3"], ["resample", "0k"],
])
def test_init_errors_equal_dsp_tpu(args):
    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.base import EffectError as JErr
    from dsp_tpu.effects.base import get_effect_info as jinfo
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects import EffectError, get_effect_info

    info, ji = get_effect_info("resample"), jinfo("resample")
    with pytest.raises(EffectError) as et:
        info.init(info, StreamInfo(FS, 2), np.ones(2, dtype=bool), ".", args)
    with pytest.raises(JErr) as ej:
        ji.init(ji, JStream(FS, 2), np.ones(2, dtype=bool), ".", args)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("rate", ["44100", "44.1k", "x1", "/1"])
def test_equal_rate_is_unused_as_in_dsp_tpu(rate):
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    chain = build_chain_from_string(f"gain -1 resample {rate}", StreamInfo(FS, 2))
    assert [e.name for e in chain.effects] == ["gain"]
    x = stereo_signal(0.2, seed=1)
    y_t = port_chain(f"gain -1 resample {rate}", 2048).process_array(x)
    y_j = np.asarray(jax_chain(f"gain -1 resample {rate}", 2048).process_array(x))
    np.testing.assert_array_equal(y_t, y_j)


@pytest.mark.parametrize("first", ["dsp_tpu", "dsp_tpu_torch"])
def test_overlap_checkpoint_crosses_packages(first, tmp_path):
    spec, block = "resample 48k", 2048
    x = stereo_signal(1.0, seed=4)
    t = port_chain(spec, block)
    half = 7 * t.block_frames
    whole = np.asarray(jax_chain(spec, block).process_array(x))
    make = {"dsp_tpu": jax_chain, "dsp_tpu_torch": port_chain}
    second = "dsp_tpu_torch" if first == "dsp_tpu" else "dsp_tpu"
    a = make[first](spec, block)
    y1 = np.asarray(a.process_array(x[:half], drain=False, discard=False))
    a.save_state(str(tmp_path / "s.npz"))
    b = make[second](spec, block)
    b.load_state(str(tmp_path / "s.npz"))
    y2 = np.asarray(b.process_array(x[half:], discard=False))
    y = np.concatenate([y1, y2])[t.chain.output_discard:]
    assert y.shape == whole.shape
    assert worst_dbfs(y, whole) <= CHAIN_LIMIT_DBFS


def test_both_clis_write_the_same_48k_wav(tmp_path, monkeypatch):
    from dsp_tpu.cli.main import main as dsp
    from dsp_tpu_torch.cli.main import main as dsp_torch
    from dsp_tpu_torch.codecs.base import CodecParams
    from dsp_tpu_torch.codecs.wav import WavReader

    monkeypatch.setenv("DSP_TPU_TORCH_DEVICE", "cpu")
    src = tmp_path / "in.wav"
    write_wav(src, stereo_signal(1.2, seed=8))
    for name, main in (("torch", dsp_torch), ("jax", dsp)):
        assert main(["-q", str(src), "-o", "-e", "double", str(tmp_path / f"{name}.wav"),
                     "resample", "48k"]) == 0
    for name in ("torch", "jax"):
        r = WavReader(CodecParams(path=str(tmp_path / f"{name}.wav")))
        assert (r.fs, r.channels) == (48000, 2)
        r.close()
    y_t, y_j = read_wav(tmp_path / "torch.wav"), read_wav(tmp_path / "jax.wav")
    assert y_t.shape == y_j.shape == (int(1.2 * 48000), 2)
    assert worst_dbfs(y_t, y_j) <= CHAIN_LIMIT_DBFS


def program_signal(n_channels=2, dur=4.0, fs=FS):
    """scripts/gen_bench_goldens.py's program material (crossing sweeps and
    tones), the input of bench_goldens/*.npz."""
    n = int(dur * fs)
    t = np.arange(n) / fs
    g = 10 ** (-14 / 20)
    v = np.log(16000 / 35)
    x = np.zeros((n, n_channels))
    x[:, 0] = g * (np.sin(35 / v * dur * (np.exp(v * t / dur) - 1)) + np.sin(2 * np.pi * 997 * t))
    x[:, 1] = g * (np.sin(2 * np.pi * 1497 * t)
                   + np.sin(16000 / np.log(35 / 16000) * dur * (np.exp(np.log(35 / 16000) * t / dur) - 1)))
    return x


def render_raw(cc, x, seconds_out):
    """gen_bench_goldens.render_blocks: whole zero-padded blocks from the
    initial state, the raw output (no drain, no discard), the first
    `seconds_out` at the output rate."""
    B = cc.block_frames
    n_blocks = -(-len(x) // B)
    xp = np.zeros((n_blocks * B, x.shape[1]))
    xp[: len(x)] = x
    ys = cc.run_blocks(xp.reshape(n_blocks, B, x.shape[1]))
    y = ys.reshape(-1, ys.shape[-1]).numpy()
    return y[: int(seconds_out * cc.chain.ostream.fs)]


def test_bench_golden_first_second():
    """bench_goldens/resample.npz (dsp_tpu f64, `resample 192k` at block
    65536), its first second: within -280 dBFS."""
    z = np.load(REPO / "bench_goldens" / "resample.npz")
    want = z["hi"].astype(np.float64) + z["lo"].astype(np.float64)
    cc = port_chain("resample 192k", 65536)
    got = render_raw(cc, program_signal()[: cc.block_frames], 1.0)
    assert got.shape == (192000, 2)
    assert worst_dbfs(got, want[:192000]) <= CHAIN_LIMIT_DBFS
