"""dsp-torch's CLI against dsp's, file to file, in-process on the CPU."""

import numpy as np
import pytest
import torch

from torch_parity import CHAIN_LIMIT_DBFS, FLAGSHIP, read_wav, stereo_signal, worst_dbfs, write_wav


@pytest.fixture
def cpu_device(monkeypatch):
    monkeypatch.setenv("DSP_TPU_TORCH_DEVICE", "cpu")


def _run(main, args):
    return main(["-q", *args])


@pytest.mark.parametrize("opts", [[], ["-b", "1000"], ["-b", "4096"]])
def test_cli_matches_dsp(opts, tmp_path, cpu_device):
    from dsp_tpu.cli.main import main as dsp
    from dsp_tpu_torch.cli.main import main as dsp_torch

    src = tmp_path / "in.wav"
    write_wav(src, stereo_signal(2.0, seed=3)[:88200 - 77])  # not a block multiple
    for name, main in (("torch", dsp_torch), ("jax", dsp)):
        rc = _run(main, [*opts, str(src), "-o", "-e", "double", str(tmp_path / f"{name}.wav"),
                         *FLAGSHIP.split()])
        assert rc == 0
    y_t = read_wav(tmp_path / "torch.wav")
    y_j = read_wav(tmp_path / "jax.wav")
    assert y_t.shape == y_j.shape == (88200 - 77, 2)
    assert worst_dbfs(y_t, y_j) <= CHAIN_LIMIT_DBFS


def test_cli_s16_output_matches_dsp(tmp_path, cpu_device):
    """Integer output without dither: the same samples after quantizing,
    except where a value sits within rounding of a half step."""
    from dsp_tpu.cli.main import main as dsp
    from dsp_tpu_torch.cli.main import main as dsp_torch

    src = tmp_path / "in.wav"
    write_wav(src, stereo_signal(1.0, seed=4), enc="s16")
    for name, main in (("torch", dsp_torch), ("jax", dsp)):
        assert _run(main, ["-D", str(src), "-o", str(tmp_path / f"{name}.wav"), *FLAGSHIP.split()]) == 0
    y_t = read_wav(tmp_path / "torch.wav")
    y_j = read_wav(tmp_path / "jax.wav")
    assert y_t.shape == y_j.shape
    assert np.abs(y_t - y_j).max() <= 1 / 32768


@pytest.mark.parametrize("mode", [["-p"], ["-P"], ["-S"], ["-X"], ["-i"]])
def test_cli_unported_modes_exit_nonzero(mode, tmp_path, cpu_device, capsys):
    """Sequence, ABX and interactive modes exit 1 with "not yet ported".
    Plot mode (-p, -P) is ported: it exits 0 with the gnuplot program on
    stdout. No mode writes the output file."""
    from dsp_tpu_torch.cli.main import main as dsp_torch

    src = tmp_path / "in.wav"
    write_wav(src, stereo_signal(0.1))
    out = tmp_path / "out.wav"
    rc = dsp_torch([*mode, str(src), "-o", "-e", "double", str(out), "gain", "-3"])
    got = capsys.readouterr()
    if mode[0] in ("-p", "-P"):
        assert rc == 0 and got.out.endswith("pause mouse close\n") and "Ht1_mag_dB" in got.out
        assert ("axes x1y2" in got.out) == (mode[0] == "-P")
    else:
        assert rc == 1
        assert "not yet ported to dsp_tpu_torch" in got.err
    assert not out.exists()


def test_cli_cuda_without_cuda_exits_nonzero(tmp_path, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from dsp_tpu_torch.cli.main import main as dsp_torch

    monkeypatch.delenv("DSP_TPU_TORCH_DEVICE", raising=False)  # default: cuda
    src = tmp_path / "in.wav"
    write_wav(src, stereo_signal(0.1))
    assert dsp_torch([str(src), "-o", str(tmp_path / "out.wav"), "gain", "-3"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_cli_help_lists_the_same_effects(capsys):
    from dsp_tpu.cli.main import main as dsp
    from dsp_tpu_torch.cli.main import main as dsp_torch

    def effects_section(main):
        with pytest.raises(SystemExit):
            main(["-h"])
        return capsys.readouterr().out.split("\nEffects:\n")[1]

    assert effects_section(dsp_torch) == effects_section(dsp)
