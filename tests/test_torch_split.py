"""Split offline processing on the CPU (CompiledChain.process_array_split and
the CLI's DSP_TPU_SPLIT), the contract of tests/test_split.py on the port:

* split against sequential: the flagship (northstar) within -150 dBFS, a
  pure-FIR chain with a delay within -250 dBFS (exact once the look-back
  covers the taps), a rate change within -150 dBFS, more splits than
  blocks, the live state neither read nor advanced;
* split-unsafe chains refused with ChainError, and the look-back growing
  with a long delay;
* dsp-torch with DSP_TPU_SPLIT against its sequential run (-150 dBFS), and
  falling back to streaming on a split-unsafe chain (stats still prints);
* the port's split against dsp_tpu's process_array_split (float64, the
  same segment layout) on the flagship, the FIR chain and the rate change;
* the float32 split against the float64 sequential run within -120 dBFS.

Inputs are a few seconds; the segments stay longer than the look-back, so
segments 1 .. S-1 start primed.
"""

import numpy as np
import pytest
import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from torch_parity import FLAGSHIP, FS, jax_chain, port_chain, worst_dbfs, write_wav
from dsp_tpu_torch.chain import ChainError

BLOCK = 4096
# the port's split against dsp_tpu's split, float64: the same segments and
# steps with sums in another order. Measured: northstar -313.1, fir -343.2,
# rate change -303.5 dBFS; each limit about 30 dB above its measurement.
# (The port's split equals its own sequential run bit for bit in all three:
# the look-back leaves the primed states within rounding of the true ones.
# The float32 split sits at -140.5 dBFS from the float64 sequential run.)
PORT_LIMITS = {"northstar": -283.0, "fir": -313.0, "rate": -273.0}


def _noise(seconds, seed):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (int(FS * seconds), 2))


@pytest.fixture(scope="module")
def fir_path(tmp_path_factory):
    """A 4,096-tap mono filter, as tests/test_split.py writes it."""
    rng = np.random.default_rng(1)
    rng.uniform(-0.5, 0.5, (FS * 8, 2))  # test_split.py draws its input first
    taps = rng.uniform(-0.1, 0.1, (4096, 1)) / 400.0
    p = tmp_path_factory.mktemp("split") / "f.wav"
    write_wav(p, taps)
    return str(p)


CASES = {
    # name: (chain, seconds, seed, splits); the flagship's look-back is
    # 53,576 frames (14 blocks), its 6 s 65 blocks in 3 segments of 22
    "northstar": (FLAGSHIP, 6, 0, 3),
    "fir": ("fir {fir} delay 10m", 4, 1, 4),
    "rate": ("lowpass 18k 0.7071 resample 96k", 4, 2, 4),
}
SELF_LIMITS = {"northstar": -150.0, "fir": -250.0, "rate": -150.0}


@pytest.fixture(scope="module")
def renders(fir_path):
    """Each case's input, the port's sequential and split renders, and
    dsp_tpu's split render."""
    out = {}
    for name, (spec, seconds, seed, splits) in CASES.items():
        spec = spec.format(fir=fir_path)
        x = _noise(seconds, seed)
        cc = port_chain(spec, BLOCK)
        seq = cc.process_array(x)
        cc.reset()
        split = cc.process_array_split(x, splits=splits)
        ref = jax_chain(spec, BLOCK).process_array_split(x, splits=splits)
        out[name] = (x, seq, split, ref, cc)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_split_matches_sequential(name, renders):
    _, seq, split, _, _ = renders[name]
    assert seq.shape == split.shape
    assert worst_dbfs(seq, split) <= SELF_LIMITS[name], worst_dbfs(seq, split)


@pytest.mark.parametrize("name", list(CASES))
def test_split_matches_dsp_tpu(name, renders):
    _, _, split, ref, _ = renders[name]
    assert split.shape == ref.shape
    assert worst_dbfs(split, ref) <= PORT_LIMITS[name], worst_dbfs(split, ref)


def test_split_segment_zero_is_exact(renders):
    """Segment 0 starts from the true zero state: its output is the
    sequential run's, bit for bit."""
    x, seq, split, _, _ = renders["northstar"]
    seg = -(-(-(-len(x) // BLOCK)) // CASES["northstar"][3]) * BLOCK
    np.testing.assert_array_equal(split[:seg], seq[:seg])


def test_more_splits_than_blocks():
    x = _noise(1, 3)  # 1 s: 6 blocks for 64 splits
    cc = port_chain("eq 1k 1.0 +3", 8192)
    seq = cc.process_array(x)
    cc.reset()
    assert worst_dbfs(seq, cc.process_array_split(x, splits=64)) <= -150.0


def test_does_not_touch_live_state():
    x = _noise(2, 4)
    cc = port_chain("eq 1k 1.0 +3", BLOCK)
    y1 = cc.process_array(x)  # advances the live state
    live = [t.clone() for t in cc.states]
    y_split = cc.process_array_split(x, splits=2)  # fresh states
    assert all(torch.equal(a, b) for a, b in zip(live, cc.states))
    np.testing.assert_allclose(y_split, port_chain("eq 1k 1.0 +3", BLOCK).process_array(x),
                               atol=1e-12)
    assert y1.shape == y_split.shape


@pytest.mark.parametrize("spec", ["stats", "noise -60", "matrix4 -6", "dither sloped"])
def test_unsafe_chains_refused(spec):
    cc = port_chain(spec, BLOCK)
    assert not cc.split_safe()
    with pytest.raises(ChainError, match="not split-safe"):
        cc.process_array_split(np.zeros((FS, 2)), splits=2)


def test_lookback_scales_with_memory():
    # a long delay must extend the look-back past the 1 s default
    assert port_chain("delay 3", BLOCK).split_lookback_frames() >= 3 * FS


def test_float32_split_against_float64_sequential(renders):
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    x, seq, _, _, _ = renders["northstar"]
    cc = CompiledChain(build_chain_from_string(FLAGSHIP, StreamInfo(FS, 2)), BLOCK,
                       dtype=torch.float32, device="cpu")
    y = cc.process_array_split(x, splits=CASES["northstar"][3])
    assert y.shape == seq.shape
    assert worst_dbfs(y, seq) <= -120.0, worst_dbfs(y, seq)


# --- the CLI ------------------------------------------------------------------


def _cli(argv, split, monkeypatch):
    from dsp_tpu_torch.cli.main import main as dsp_torch

    monkeypatch.setenv("DSP_TPU_TORCH_DEVICE", "cpu")
    if split is None:
        monkeypatch.delenv("DSP_TPU_SPLIT", raising=False)
    else:
        monkeypatch.setenv("DSP_TPU_SPLIT", str(split))
    return dsp_torch(argv)


def _raw_input(path, seconds):
    """Raw float64 stereo: sines at 500 and 1200 Hz, -6 dB, rendered by the
    port's sgen codec (a reader, so no chain runs on it) and held bit for bit
    to the same sines from numpy, so that a wrong sgen cannot weaken the
    split tests."""
    from dsp_tpu_torch.codecs import CodecParams, init_codec

    c = init_codec(CodecParams(f"sine@0:freq=500/sine@1:freq=1200+{seconds}", type="sgen",
                               fs=FS, channels=2))
    x = 0.5 * c.read(c.frames)
    t = np.arange(int(FS * seconds))[:, None] / FS
    np.testing.assert_array_equal(x, 0.5 * np.sin(2 * np.pi * np.array([500.0, 1200.0]) * t))
    x.astype("<f8").tofile(path)


RAW = ["-q", "-t", "pcm", "-e", "double", "-c", "2", "-r", "44100"]


def test_cli_split_matches_sequential(tmp_path, monkeypatch):
    from dsp_tpu_torch.chain.chain import CompiledChain

    src, a, b = (str(tmp_path / n) for n in ("in.raw", "seq.raw", "split.raw"))
    _raw_input(src, 4)  # 4 s: past 4 splits x 4 x the chain's 7,202-frame look-back
    chain = ["eq", "1k", "1.0", "+3", "highpass", "30", "0.7071"]
    out = ["-o", "-t", "pcm", "-e", "double"]
    assert _cli(RAW + [src] + out + [a] + chain, None, monkeypatch) == 0
    calls = []
    real = CompiledChain.process_array_split
    monkeypatch.setattr(CompiledChain, "process_array_split",
                        lambda self, *a_, **k: calls.append(k) or real(self, *a_, **k))
    assert _cli(RAW + [src] + out + [b] + chain, 4, monkeypatch) == 0
    assert calls and calls[0]["splits"] == 4  # the split route ran
    ya, yb = np.fromfile(a, np.float64), np.fromfile(b, np.float64)
    assert len(ya) == len(yb)
    assert worst_dbfs(ya, yb) <= -150.0


def test_cli_split_falls_back_on_unsafe_chain(tmp_path, monkeypatch, capsys):
    src, out = str(tmp_path / "in.raw"), str(tmp_path / "out.raw")
    _raw_input(src, 1)
    argv = RAW + [src, "-o", "-t", "pcm", "-e", "double", out, "stats"]
    assert _cli(argv, 4, monkeypatch) == 0
    # stats still printed its table: the streaming path ran host_finish
    assert "dBFS" in capsys.readouterr().err
