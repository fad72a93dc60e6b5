"""tests/test_readbuf.py's cases on the port's read buffer
(dsp_tpu_torch.cli.readbuf.ReadBuffer): SEEK drops stale blocks, PAUSE
stops REALTIME capture, the reader suspends ahead of a REALTIME input
until earlier inputs are drained, SKIP abandons the current input, repeats
loop inside the reader, end positions, the unbuffered fast path, a failed
seek and a decode error. Each case runs test_readbuf's function with its
ReadBuffer and codec hints taken from the port.
"""

import pytest

import torch_parity  # noqa: F401  (one torch thread a test process)
import test_readbuf as cases
from dsp_tpu_torch.cli import readbuf
from dsp_tpu_torch.codecs import base

CASES = [name for name in dir(cases) if name.startswith("test_")]


@pytest.mark.parametrize("name", CASES)
def test_port_readbuf(name, monkeypatch):
    monkeypatch.setattr(cases, "ReadBuffer", readbuf.ReadBuffer)
    monkeypatch.setattr(cases, "CODEC_HINT_NO_BUF", base.CODEC_HINT_NO_BUF)
    monkeypatch.setattr(cases, "CODEC_HINT_REALTIME", base.CODEC_HINT_REALTIME)
    getattr(cases, name)()


def test_the_port_reads_through_its_own_codecs_hints():
    assert readbuf.CODEC_HINT_NO_BUF is base.CODEC_HINT_NO_BUF
    assert readbuf.ReadBuffer.__module__ == "dsp_tpu_torch.cli.readbuf"
