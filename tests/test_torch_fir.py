"""The FFT-convolution slice of dsp_tpu_torch against dsp_tpu, on the CPU in
float64: fir, fir_p, zita_convolver, hilbert, decorrelate, the biquads' -r
option and remix, chain by chain, through both packages' CompiledChain
(drain and discard included) and through both CLIs.
"""

from pathlib import Path

import numpy as np
import pytest

from torch_parity import FS, jax_chain, port_chain, read_wav, stereo_signal, worst_dbfs, write_wav

REPO = Path(__file__).resolve().parents[1]
CROSSOVER = REPO / "examples" / "crossover_lr4_2kHz_riir_linphase"


def _coefs(rng, n, scale=0.1):
    return ",".join(f"{v:.17g}" for v in rng.uniform(-scale, scale, n))


def _filters(tmp):
    """Seeded filter files: a mono wav of 3000 taps, and the same taps as
    big-endian float32 raw (the `-t raw -e float -B -c 1` input options)."""
    rng = np.random.default_rng(42)
    h = rng.standard_normal((3000, 1))
    h *= 0.5 / np.abs(h).sum()
    wav = tmp / "h3000.wav"
    write_wav(wav, h)
    raw = tmp / "h3000.raw"
    h.astype(">f4").tofile(raw)
    return wav, raw


# chain id -> (chain string with {wav}/{raw} placeholders, blocks, pinned
# limit in dBFS). The port and dsp_tpu take the same host tables and differ
# in their FFT libraries and the MAC's summation order. Measured worst case
# of each chain over its blocks (2 s of stereo noise and sines): fir_coefs
# -307, fir_wav -340, fir_raw -342, fir_align -299, fir_p -288, zita -291,
# hilbert -303, decorrelate -301, reverse_iir -310, crossover -305, remix
# -304. Each
# limit keeps about 30 dB of margin over its measurement, and none is looser
# than -250 dBFS.
_RNG = np.random.default_rng(7)
CHAINS = {
    "fir_coefs": ("fir coefs:0.5,0.25,-0.125,0.0625/0.3,-0.2,0.1", (2048, 1000), -275.0),
    "fir_wav": ("fir {wav}", (2048, 512, 700), -310.0),  # OLS, Upols K=6, Upols K=5
    "fir_raw": ("fir -t raw -e float -B -c 1 {raw}", (512,), -310.0),
    "fir_align": ("fir -a coefs:0.1,0.2,1.0,0.3/0.5,1.0,0.25,0.1,0.05", (2048, 1000), -270.0),
    "fir_p": (f"fir_p coefs:{_coefs(_RNG, 9000)}", (128, 2048), -255.0),  # Nupols, Upols
    "zita_convolver": (f"zita_convolver 64 8192 coefs:{_coefs(_RNG, 5000)}", (256, 96), -260.0),
    "hilbert": ("hilbert -c 31", (2048, 1000), -270.0),
    "decorrelate": ("decorrelate -s 7", (2048, 1000), -270.0),
    "reverse_iir": ("lowpass -r 1k 0.7071 highpass -r 120 0.7071", (2048, 1000), -280.0),
    "crossover": (f"@{CROSSOVER}", (2048, 1000), -275.0),
    "remix": ("remix 0,1 1 0 . :2 fir coefs:0.5,0.5", (2048, 1000), -275.0),
}


@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_matches_dsp_tpu(name, tmp_path):
    spec, blocks, limit = CHAINS[name]
    wav, raw = _filters(tmp_path)
    spec = spec.format(wav=wav, raw=raw)
    x = stereo_signal(2.0, seed=len(name))
    for block in blocks:
        y_t = port_chain(spec, block).process_array(x)
        y_j = jax_chain(spec, block).process_array(x)
        assert y_t.shape == y_j.shape, (block, y_t.shape, y_j.shape)
        assert np.isfinite(y_t).all()
        err = worst_dbfs(y_t, y_j)
        assert err <= limit, f"block {block}: {err:.1f} dBFS above {limit}"


@pytest.mark.parametrize(
    "spec, block",
    [("fir coefs:0.5,0.25,-0.125", 64),  # OLS
     (f"fir coefs:{_coefs(np.random.default_rng(3), 300)}", 32),  # Upols
     (f"fir_p coefs:{_coefs(np.random.default_rng(4), 3000)}", 16),  # Nupols
     ("decorrelate -s 7", 256)],
    ids=["ols", "upols", "nupols", "decorrelate"],
)
def test_run_block_owns_its_state(spec, block):
    """A caller that refills one input buffer between run_block calls gets
    the same output as one that passes fresh arrays: no engine keeps the
    caller's block as its state."""
    x = stereo_signal(0.1, seed=5)[: 12 * block]
    fresh, reused = port_chain(spec, block), port_chain(spec, block)
    buf = np.empty((block, 2))
    for i in range(12):
        blk = x[i * block : (i + 1) * block]
        want = fresh.run_block(blk.copy()).numpy()
        buf[:] = blk
        got = reused.run_block(buf).numpy()
        buf[:] = 0.0
        np.testing.assert_array_equal(got, want)


def test_crossover_runs_the_slice_kernels_path():
    """The shipped crossover: 2 channels in, 4 out, a remix, the forward
    biquads fused into one K1 cascade's effect and the time-reversed ones
    merged into one reverse IIR on the partitioned engine."""
    from dsp_tpu_torch.effects.reverse_iir import ReverseIirEffect
    from dsp_tpu_torch.ops.fft_conv import UpolsConv

    cc = port_chain(f"@{CROSSOVER}", 2048)
    assert cc.chain.ostream.channels == 4
    names = [e.name for e in cc._runtime_effects]
    assert names[0] == "remix"
    riir = [e for e in cc._runtime_effects if isinstance(e, ReverseIirEffect)]
    assert len(riir) == 1 and list(riir[0].sel_idx) == [0, 1, 2, 3]
    assert isinstance(riir[0]._engine(2048), UpolsConv)


def test_decorrelate_has_no_drain():
    x = stereo_signal(0.5, seed=3)
    assert port_chain("decorrelate -s 7", 1024).process_array(x).shape == x.shape


@pytest.fixture
def cpu_device(monkeypatch):
    monkeypatch.setenv("DSP_TPU_TORCH_DEVICE", "cpu")


def test_cli_fir_matches_dsp(tmp_path, cpu_device):
    from dsp_tpu.cli.main import main as dsp
    from dsp_tpu_torch.cli.main import main as dsp_torch

    wav, _ = _filters(tmp_path)
    src = tmp_path / "in.wav"
    write_wav(src, stereo_signal(1.5, seed=11)[: 66150 - 31])
    for name, main in (("torch", dsp_torch), ("jax", dsp)):
        out = tmp_path / f"{name}.wav"
        assert main(["-q", "-b", "512", str(src), "-o", "-e", "double", str(out),
                     "fir", str(wav), "gain", "-1"]) == 0
    y_t = read_wav(tmp_path / "torch.wav")
    y_j = read_wav(tmp_path / "jax.wav")
    assert y_t.shape == y_j.shape == (66150 - 31 + 2999, 2)
    assert worst_dbfs(y_t, y_j) <= -270.0


_LONG = "coefs:" + ",".join(["0.01"] * 40)
INIT_CASES = [
    "fir_p", "fir_p coefs:", f"fir_p 1 2 {_LONG}", f"fir_p 0 {_LONG}", f"fir_p 4096 {_LONG}",
    f"fir_p 100 {_LONG}", f"fir_p 16 {_LONG}", f"fir_p -64 {_LONG}", f"fir_p 12x {_LONG}",
    "fir_p 100 coefs:0.1,0.2", "fir_p 16 coefs:0.1,0.2",
    "zita_convolver", "zita_convolver 64 coefs:0.1,0.2", "zita_convolver 128 8192 coefs:0.1,0.2",
    "zita_convolver 0 0 coefs:0.1,0.2", "zita_convolver 8192 64 coefs:0.1,0.2",
    "zita_convolver 32 coefs:0.1,0.2", "zita_convolver 16384 coefs:0.1,0.2",
    "zita_convolver 100 coefs:0.1,0.2", "zita_convolver 1 2 3 coefs:0.1",
    "fir coefs:0.1,x", "fir -r 48000 coefs:0.1", "fir -c 0 coefs:0.1", "fir -q coefs:0.1",
    "fir -a1x coefs:0.1", "fir_p -r any coefs:0.1,0.2", "fir missing_filter.wav",
    "hilbert 4", "hilbert 3", "hilbert x", "hilbert -a 45 7", "hilbert -q 7",
    "decorrelate 0", "decorrelate -d 2m -D 1m", "decorrelate -s 0", "remix", "remix 0 1 2",
]


def _init(pkg, words):
    if pkg == "jax":
        from dsp_tpu.core.types import StreamInfo
        from dsp_tpu.effects import EffectError, get_effect_info
    else:
        from dsp_tpu_torch.core.types import StreamInfo
        from dsp_tpu_torch.effects import EffectError, get_effect_info
    info = get_effect_info(words[0])
    try:
        e = info.init(info, StreamInfo(FS, 2), np.ones(2, dtype=bool), str(REPO), words)
    except EffectError as err:
        return "error", str(err)
    return "ok", type(e).__name__


@pytest.mark.parametrize("spec", INIT_CASES)
def test_init_errors_match_dsp_tpu(spec):
    """Usage and validation messages (fir.py:139-199 and the other inits)
    are dsp_tpu's word for word; accepted arguments are accepted by both."""
    words = spec.split()
    assert _init("torch", words) == _init("jax", words)


def _raw_codec(pkg, path, enc, endian, mode):
    if pkg == "jax":
        from dsp_tpu.codecs import CodecParams, init_codec
    else:
        from dsp_tpu_torch.codecs import CodecParams, init_codec
    return init_codec(CodecParams(path=str(path), type="raw", enc=enc, fs=FS, channels=2,
                                  endian=endian, mode=mode))


@pytest.mark.parametrize("enc", ["s16", "s24_3", "s32", "float", "double"])
@pytest.mark.parametrize("endian", ["big", "little"])
def test_pcm_codec_matches_dsp_tpu(enc, endian, tmp_path):
    """Raw files written by either package read back the same in both."""
    from dsp_tpu_torch.codecs import CODEC_ENDIAN_BIG, CODEC_ENDIAN_LITTLE, CODEC_MODE_READ, CODEC_MODE_WRITE

    e = CODEC_ENDIAN_BIG if endian == "big" else CODEC_ENDIAN_LITTLE
    x = stereo_signal(0.05, seed=1) * 0.9
    path = tmp_path / "x.raw"
    for writer in ("torch", "jax"):
        w = _raw_codec(writer, path, enc, e, CODEC_MODE_WRITE)
        w.write(x)
        w.close()
        got = {}
        for reader in ("torch", "jax"):
            r = _raw_codec(reader, path, enc, e, CODEC_MODE_READ)
            assert r.frames == len(x)
            got[reader] = r.read(len(x))
            r.close()
        np.testing.assert_array_equal(got["torch"], got["jax"])
        assert np.abs(got["torch"] - x).max() <= 2.0 ** -15
