"""The port's codecs against dsp_tpu's:

* sgen: read and seek bit for bit on tests/test_codecs.py's sgen cases,
  and the same CodecError messages on bad paths;
* print_all_codecs prints the same text as dsp_tpu's;
* ffmpeg, mp3 and sndfile register exactly when their shim or module is
  present, in both packages alike (their decode tests skip where the shim
  is absent; test_mp3.py's two decode cases that need libmad are not
  repeated here);
* the native prefetching reader (codecs/native.py over native/dspio.cpp,
  compiled here with g++ into a temporary directory that the loader is
  pointed at) equals the Python path byte for byte through the wav and pcm
  readers, a seek included, and honours DSP_TPU_NATIVE=0; NativeWriter's
  file equals the pcm writer's byte for byte.
"""

import importlib.util
import io
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

import dsp_tpu.codecs as jax_codecs
import torch_parity  # noqa: F401  (one torch thread a test process)
from dsp_tpu.codecs.base import get_codec_info_by_type as jax_info
from dsp_tpu_torch import codecs
from dsp_tpu_torch.codecs import CODEC_MODE_READ, CODEC_MODE_WRITE, CodecError, CodecParams
from dsp_tpu_torch.codecs import native
from dsp_tpu_torch.codecs.base import get_codec_info_by_type

REPO = Path(__file__).resolve().parent.parent
FS = 44100

# (path, fs, channels, operations: ("read", n) or ("seek", pos)), the sgen
# cases of tests/test_codecs.py and a few more generator shapes
SGEN_CASES = {
    "sine tone": ("sine:freq=1k+1", 8000, 1, [("read", 100)]),
    "delta offset and selector": ("delta@1:offset=10S+100S", 8000, 2, [("read", 100)]),
    "sweep": ("sine:freq=100-1k+2", FS, 1, [("read", 2 * FS), ("read", 10)]),
    "generators sum": ("sine:freq=500/sine:freq=500", 8000, 1, [("read", 50)]),
    "seek": ("sine:freq=440", 8000, 1, [("read", 64), ("seek", 0), ("read", 64)]),
    "sweep seek": ("sine@0:freq=20-20k/delta@1:offset=0.1+1", FS, 2,
                   [("read", 5000), ("seek", 40000), ("read", 9000), ("seek", -5),
                    ("read", 300), ("seek", 10 ** 6), ("read", 10)]),
    "two sines": ("sine@0:freq=1k/sine@1:freq=3k+10", FS, 2, [("read", FS), ("read", FS)]),
}
SGEN_ERRORS = {
    "bad type": ("square:freq=1k", 8000, 1),
    "freq out of range": ("sine:freq=5k", 8000, 1),
    "zero length": ("sine:freq=1k+0", 8000, 1),
    "offset out of range": ("delta:offset=200S+100S", 8000, 1),
    "sine parameter": ("sine:offset=1", 8000, 1),
    "delta parameter": ("delta:freq=1k", 8000, 1),
    "selector": ("sine@4:freq=1k", 8000, 2),
    "bad length": ("sine:freq=1k+1x", 8000, 1),
}


def _sgen_run(pkg, path, fs, channels, ops):
    c = pkg.init_codec(pkg.CodecParams(path, type="sgen", fs=fs, channels=channels))
    out = [c.frames, c.prec, c.hints]
    for op, v in ops:
        out.append(c.read(v) if op == "read" else c.seek(v))
    return out


@pytest.mark.parametrize("case", list(SGEN_CASES))
def test_sgen_reads_and_seeks_equal_dsp_tpu(case):
    path, fs, channels, ops = SGEN_CASES[case]
    want = _sgen_run(jax_codecs, path, fs, channels, ops)
    got = _sgen_run(codecs, path, fs, channels, ops)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    assert any(isinstance(w, np.ndarray) and w.any() for w in want)


@pytest.mark.parametrize("case", list(SGEN_ERRORS))
def test_sgen_errors_equal_dsp_tpu(case):
    path, fs, channels = SGEN_ERRORS[case]
    with pytest.raises(jax_codecs.CodecError) as want:
        _sgen_run(jax_codecs, path, fs, channels, [])
    with pytest.raises(CodecError) as got:
        _sgen_run(codecs, path, fs, channels, [])
    assert str(got.value) == str(want.value)


def test_print_all_codecs_equals_dsp_tpu():
    want, got = io.StringIO(), io.StringIO()
    jax_codecs.print_all_codecs(want)
    codecs.print_all_codecs(got)
    assert got.getvalue() == want.getvalue()
    for name in ("null", "sgen", "pcm", "raw", "wavpipe", "wav"):
        assert f"\n  {name} " in got.getvalue()


def _shim_present(soname):
    return os.environ.get("DSP_TPU_NATIVE", "1") != "0" and any(
        os.path.exists(os.path.join(d, soname)) for d in native.SEARCH_DIRS)


GATED = {
    "ffmpeg": lambda: _shim_present("libdspav.so"),
    "mp3": lambda: _shim_present("libdspmad.so"),
    "sndfile": lambda: importlib.util.find_spec("soundfile") is not None,
}


@pytest.mark.parametrize("name", list(GATED))
def test_gated_codecs_register_exactly_when_present(name):
    present = GATED[name]()
    assert (get_codec_info_by_type(name) is not None) == present
    assert (jax_info(name) is not None) == present


def _wav_file(tmp_path, x, enc="s16", name="f.wav"):
    path = str(tmp_path / name)
    w = codecs.init_codec(CodecParams(path, type="wav", enc=enc, fs=FS, channels=x.shape[1],
                                      mode=CODEC_MODE_WRITE))
    w.write(x)
    w.close()
    return path


def test_ffmpeg_decodes_wav(tmp_path):
    from dsp_tpu_torch.codecs import ffmpeg

    if not ffmpeg._load():
        pytest.skip("native/libdspav.so not built")
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (20000, 2))
    path = _wav_file(tmp_path, x)
    r = codecs.init_codec(CodecParams(path, type="ffmpeg", mode=CODEC_MODE_READ))
    q = np.round(x * 32768) / 32768
    assert (r.fs, r.channels, r.frames) == (FS, 2, 20000)
    np.testing.assert_array_equal(r.read(20000), q)
    assert r.seek(5000) >= 0
    np.testing.assert_array_equal(r.read(100), q[5000:5100])
    r.close()
    with pytest.raises(CodecError):
        codecs.init_codec(CodecParams(str(tmp_path / "missing.mp3"), type="ffmpeg",
                                      mode=CODEC_MODE_READ))


def test_mad_shim_properties(tmp_path):
    from dsp_tpu_torch.codecs import mp3

    if not mp3._load():
        pytest.skip("native/libdspmad.so not built")
    from test_mp3 import encode_mp3

    t = np.arange(FS) / FS
    x = np.stack([0.5 * np.sin(2 * np.pi * 440 * t)] * 2, axis=1)
    path = encode_mp3(str(tmp_path / "tone.mp3"), x)
    c = codecs.init_codec(CodecParams(path, type="mp3", mode=CODEC_MODE_READ))
    assert c.enc == "mad_f" and c.prec == 24 and c.frames > 0
    got = c.seek(FS // 2)
    assert FS // 2 <= got <= FS // 2 + 1152
    c.close()


# --- the native reader ---------------------------------------------------

ENCODINGS = ("u8", "s8", "s16", "s24", "s24_3", "s32", "float", "double")


@pytest.fixture(scope="module")
def dspio(tmp_path_factory):
    """A directory holding libdspio.so compiled from native/dspio.cpp as
    native/Makefile compiles it."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("dspio")
    subprocess.run(["g++", "-O2", "-Wall", "-std=c++17", "-fPIC", "-shared", "-pthread",
                    "-o", str(d / "libdspio.so"), str(REPO / "native" / "dspio.cpp")],
                   check=True, capture_output=True)
    return str(d)


@pytest.fixture
def native_on(dspio, monkeypatch):
    monkeypatch.setattr(native, "SEARCH_DIRS", (dspio,))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("DSP_TPU_NATIVE", raising=False)
    assert native.available()


def _reads(codec, ops):
    out = []
    for op, v in ops:
        out.append(codec.read(v) if op == "read" else codec.seek(v))
    codec.close()
    return out


READ_OPS = [("read", 1000), ("read", 20000), ("seek", 3333), ("read", 777), ("seek", 0),
            ("read", 5), ("seek", 29990), ("read", 100), ("read", 10)]


def _both_paths(monkeypatch, open_codec):
    """The read ops through the native reader, then through Python file I/O."""
    c = open_codec()
    assert c._native is not None
    on = _reads(c, READ_OPS)
    monkeypatch.setattr(native, "_lib", False)
    c = open_codec()
    assert c._native is None
    return on, _reads(c, READ_OPS)


def _assert_same(on, off):
    for a, b in zip(on, off):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("enc", ["u8", "s16", "s24", "s24_3", "s32", "float", "double"])
def test_native_wav_reader_equals_python(enc, tmp_path, native_on, monkeypatch):
    x = np.random.default_rng(1).uniform(-1.0, 1.0, (30000, 3))
    x[:4] = [[1.0, -1.0, 0.0]] * 4  # full scale: the clamp
    path = _wav_file(tmp_path, x, enc)
    on, off = _both_paths(
        monkeypatch, lambda: codecs.init_codec(CodecParams(path, mode=CODEC_MODE_READ)))
    _assert_same(on, off)
    assert sum(len(a) for a in off if isinstance(a, np.ndarray)) == 1000 + 20000 + 777 + 5 + 10


@pytest.mark.parametrize("enc", ENCODINGS)
def test_native_pcm_reader_equals_python(enc, tmp_path, native_on, monkeypatch):
    x = np.random.default_rng(2).uniform(-1.0, 1.0, (30000, 2))
    path = str(tmp_path / "f.raw")
    w = codecs.init_codec(CodecParams(path, type="raw", enc=enc, fs=FS, channels=2,
                                      mode=CODEC_MODE_WRITE))
    w.write(x)
    w.close()
    on, off = _both_paths(monkeypatch, lambda: codecs.init_codec(
        CodecParams(path, type="raw", enc=enc, fs=FS, channels=2, mode=CODEC_MODE_READ)))
    _assert_same(on, off)


def test_native_reader_honours_the_gate(tmp_path, native_on, monkeypatch):
    path = _wav_file(tmp_path, np.zeros((10, 2)))
    monkeypatch.setenv("DSP_TPU_NATIVE", "0")
    monkeypatch.setattr(native, "_lib", None)
    c = codecs.init_codec(CodecParams(path, mode=CODEC_MODE_READ))
    assert c._native is None and not native.available()
    c.close()


@pytest.mark.parametrize("enc", ENCODINGS)
def test_native_writer_equals_pcm_writer(enc, tmp_path, native_on):
    x = np.random.default_rng(3).uniform(-1.0, 1.0, (5000, 2))
    x[:2] = [[1.0, -1.0], [0.5, -0.5]]
    py, nat = str(tmp_path / "py.raw"), str(tmp_path / "native.raw")
    w = codecs.init_codec(CodecParams(py, type="raw", enc=enc, fs=FS, channels=2,
                                      mode=CODEC_MODE_WRITE))
    w.write(x[:3000])
    w.write(x[3000:])
    w.close()
    nw = native.NativeWriter(nat, enc, 2)
    assert nw.write(x[:3000]) == 3000 and nw.write(x[3000:]) == 2000
    nw.close()
    assert Path(nat).read_bytes() == Path(py).read_bytes()
