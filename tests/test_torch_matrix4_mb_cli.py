"""Slice F of dsp_tpu_torch against dsp_tpu, on the CPU in float64: the
`matrix4_mb` chain through both CLIs. Each limit is pinned ~30 dB above its
measurement; the stream's first tenths of a second carry the engine's
chaotic start (test_torch_matrix4_mb_chain.py).
"""

from pathlib import Path

import pytest

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from test_torch_matrix4 import transient_signal
from torch_parity import FS, read_wav, worst_dbfs, write_wav

REPO = Path(__file__).resolve().parents[1]


# (chain words, output channels, limit): 0.5 s of transients through both
# CLIs, -e double; measured -125.7 and -126.1 dBFS (the chaotic start)
CLI_CASES = [
    (["matrix4_mb", "-6"], 4, -95.0),
    ([f"@{REPO / 'examples' / 'matrix4_mb_2_4'}"], 6, -96.0),
]


@pytest.mark.parametrize("words,channels,limit", CLI_CASES, ids=["matrix4_mb -6", "matrix4_mb_2_4"])
def test_clis_write_the_same_upmix(words, channels, limit, tmp_path, monkeypatch):
    """`DSP_TPU_TORCH_DEVICE=cpu dsp-torch in.wav -o -e double out.wav <chain>`
    and dsp's CLI on the same file: the same frames and channels (the
    6-channel example adds the surround's delays, decorrelators and remix)."""
    from dsp_tpu.cli.main import main as dsp
    from dsp_tpu_torch.cli.main import main as dsp_torch

    monkeypatch.setenv("DSP_TPU_TORCH_DEVICE", "cpu")
    src = tmp_path / "in.wav"
    write_wav(src, transient_signal(0.5, seed=13)[:-77])
    for name, main in (("torch", dsp_torch), ("jax", dsp)):
        assert main(["-q", str(src), "-o", "-e", "double", str(tmp_path / f"{name}.wav"),
                     *words]) == 0
    y_t, y_j = read_wav(tmp_path / "torch.wav"), read_wav(tmp_path / "jax.wav")
    assert y_t.shape == y_j.shape and y_t.shape[1] == channels and len(y_t) > int(0.5 * FS) - 77
    assert worst_dbfs(y_t, y_j) <= limit
