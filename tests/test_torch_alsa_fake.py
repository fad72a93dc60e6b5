"""tests/test_alsa_fake.py's scripted fake of libasound, driving both
packages' codecs/alsa.py: every case runs against dsp_tpu's module and the
port's, each held to the case's own assertions, and the port is held to
dsp_tpu's calls, values and errors, case by case (the device codecs'
recovery logic, alsa.c:54-169, runs for real without a sound card).
"""

import os

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread a test process)

os.environ["DSP_TPU_FAKE_ALSA"] = "1"  # both modules import without libasound
import test_alsa_fake as cases  # noqa: E402  (the fake and the cases)

PACKAGES = ("dsp_tpu", "dsp_tpu_torch")
CASES = [name for name in dir(cases) if name.startswith("test_")]


def _alsa(pkg):
    return pytest.importorskip(f"{pkg}.codecs.alsa")


def _run(pkg, name, monkeypatch):
    """Case `name` against pkg's alsa module (the cases read the module and
    CodecParams from test_alsa_fake's globals); returns the fake."""
    alsa = _alsa(pkg)
    base = pytest.importorskip(f"{pkg}.codecs.base")
    fake = cases.FakeAsound()
    monkeypatch.setattr(alsa, "_a", fake)
    monkeypatch.setattr(cases, "alsa", alsa)
    monkeypatch.setattr(cases, "CodecParams", base.CodecParams)
    getattr(cases, name)(fake)
    return fake


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("name", CASES)
def test_case(name, pkg, monkeypatch):
    _run(pkg, name, monkeypatch)


@pytest.mark.parametrize("name", CASES)
def test_port_calls_equal_dsp_tpu(name, monkeypatch):
    calls = []
    for pkg in PACKAGES:
        calls.append(_run(pkg, name, monkeypatch).calls)
        monkeypatch.undo()
    assert calls[1] == calls[0] and calls[0]


def test_read_values_equal_dsp_tpu(monkeypatch):
    out = []
    for pkg in PACKAGES:
        alsa = _alsa(pkg)
        base = pytest.importorskip(f"{pkg}.codecs.base")
        fake = cases.FakeAsound()
        monkeypatch.setattr(alsa, "_a", fake)
        fake.readi_script = [-cases._EPIPE, 37, 91, 128]
        c = alsa.AlsaCodec(base.CodecParams(
            path="hw:0,0", type="alsa", enc="s16", fs=44100, channels=2,
            mode=base.CODEC_MODE_READ, block_frames=128, buf_ratio=4))
        out.append((c.read(128), c.read(128), c.hints, c.prec, c.enc))
        monkeypatch.undo()
    for a, b in zip(*out):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a)
        else:
            assert b == a
