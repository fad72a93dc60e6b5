"""Plot mode (-p/-P): dsp_tpu_torch.chain.plot.plot_chain against dsp_tpu's,
byte for byte, for one chain of every effect name the port builds (and the
variants whose plot differs: biquad -r, delay -f and -M), the flagship and
the examples' chains; an effect that does not plot raises PlotError with
dsp_tpu's message. Both CLIs print the same program for -p and -P, and
dsp-torch prints it with DSP_TPU_TORCH_DEVICE=cuda on a machine without
CUDA: plot mode touches no device.
"""

from pathlib import Path

import numpy as np
import pytest

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
import torch_parity  # noqa: F401  (one torch thread a test process)
from torch_parity import FLAGSHIP, FS

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
COEFS = "coefs:" + ",".join(f"{v:.6f}" for v in np.random.default_rng(2).uniform(-0.2, 0.2, 300))
# one chain a name (ladspa_host and watch, which the port refuses at init,
# aside), and the variants whose plot takes another path
EFFECTS = {
    "lowpass_1": "lowpass_1 1k",
    "highpass_1": "highpass_1 100",
    "allpass_1": "allpass_1 1k",
    "lowshelf_1": "lowshelf_1 200 +3",
    "highshelf_1": "highshelf_1 5k -2",
    "lowpass_1p": "lowpass_1p 2k",
    "lowpass": "lowpass 18k 0.7071",
    "highpass": "highpass 30 0.7071",
    "bandpass_skirt": "bandpass_skirt 1k 1.0",
    "bandpass_peak": "bandpass_peak 1k 2o",
    "notch": "notch 60 10q",
    "allpass": "allpass 1k 0.7",
    "eq": "eq 1k 1.0 +3",
    "lowshelf": "lowshelf 90 0.7071s +4",
    "highshelf": "highshelf 10k 0.7071s -2",
    "lowpass_transform": "lowpass_transform 20 0.5 10 0.707",
    "highpass_transform": "highpass_transform 20 0.5 10 0.707",
    "linkwitz_transform": "linkwitz_transform 50 0.7 30 0.6",
    "deemph": "deemph",
    "biquad": "biquad 1 0.5 0.25 1 -0.2 0.1",
    "biquad -r": "lowpass -r 1k 0.7071",
    "gain": "gain -3",
    "mult": "mult 0.5",
    "add": "add 0.1",
    "crossfeed": "crossfeed 700 4.5",
    "matrix4": "matrix4 -6",
    "matrix4_mb": "matrix4_mb -6",
    "remix": "remix 0 1 0,1",
    "st2ms": "st2ms",
    "ms2st": "ms2st",
    "delay": "delay 10m",
    "delay -f": "delay -f 0.37m",
    "delay -M": "delay -M 0.5m -q 2 10m",
    "resample": "resample 48k",
    "fir": f"fir {COEFS}",
    "fir_p": f"fir_p {COEFS}",
    "zita_convolver": f"zita_convolver {COEFS}",
    "hilbert": "hilbert 15",
    "decorrelate": "decorrelate",
    "noise": "noise -90",
    "dither": "dither",
    "stats": "stats",
    "levels": "levels",
}


def _plots(build, plot_phase):
    """(result, message) of each package's plot_chain on the chain that
    build(package) returns; numpy's generator is seeded alike before each
    build (decorrelate, noise and dither draw from it at init)."""
    from dsp_tpu.chain.plot import PlotError as JaxPlotError
    from dsp_tpu.chain.plot import plot_chain as jax_plot
    from dsp_tpu_torch.chain.plot import PlotError, plot_chain

    out = []
    for pkg, plot, err in (("dsp_tpu", jax_plot, JaxPlotError),
                           ("dsp_tpu_torch", plot_chain, PlotError)):
        np.random.seed(7)
        chain = build(pkg)
        try:
            out.append((plot(chain, plot_phase), None))
        except err as e:
            out.append((None, str(e)))
    return out


def _from_string(spec, channels=2):
    def build(pkg):
        chain_mod = __import__(f"{pkg}.chain", fromlist=["build_chain_from_string"])
        types = __import__(f"{pkg}.core.types", fromlist=["StreamInfo"])
        return chain_mod.build_chain_from_string(spec, types.StreamInfo(FS, channels))
    return build


@pytest.mark.parametrize("phase", [False, True], ids=["-p", "-P"])
@pytest.mark.parametrize("name", list(EFFECTS))
def test_effect_plot_equals_dsp_tpu(name, phase):
    jax, port = _plots(_from_string(EFFECTS[name]), phase)
    assert port == jax
    if port[0] is None:  # the effects without a plot (a NULL e->plot)
        assert port[1] == f"plot: error: effect '{EFFECTS[name].split()[0]}' does not support " \
                          f"plotting", port[1]


@pytest.mark.parametrize("phase", [False, True], ids=["-p", "-P"])
@pytest.mark.parametrize("name", ["flagship"] + sorted(p.name for p in EXAMPLES.iterdir()))
def test_chain_plot_equals_dsp_tpu(name, phase):
    if name == "flagship":
        build = _from_string(FLAGSHIP)
    else:
        def build(pkg):
            chain_mod = __import__(f"{pkg}.chain", fromlist=["build_chain_from_file"])
            types = __import__(f"{pkg}.core.types", fromlist=["StreamInfo"])
            return chain_mod.build_chain_from_file(str(EXAMPLES / name), types.StreamInfo(FS, 2))
    jax, port = _plots(build, phase)
    assert port == jax
    if name in ("flagship", "eq_demo", "crossover_lr4_2kHz"):
        assert port[0] is not None and port[0].endswith("pause mouse close\n")


@pytest.mark.parametrize("flag", ["-p", "-P"])
def test_cli_plot_equals_dsp(flag, capsys, monkeypatch):
    """Both CLIs' stdout for -p and -P; dsp-torch asked for the card where
    there is none still plots (plot mode resolves no device)."""
    from dsp_tpu.cli.main import main as jax_main
    from dsp_tpu_torch.cli.main import main as port_main

    args = [flag, "-c", "2", "-n", *FLAGSHIP.split(), "delay", "-f", "0.37m"]
    assert jax_main(list(args)) == 0
    want = capsys.readouterr().out
    monkeypatch.setenv("DSP_TPU_TORCH_DEVICE", "cuda")
    monkeypatch.setenv("DSP_TPU_TORCH_DTYPE", "float32")
    assert port_main(list(args)) == 0
    got = capsys.readouterr().out
    assert got == want and "Ht1_mag_dB" in got


def test_cli_plot_error_equals_dsp(capsys):
    from dsp_tpu.cli.main import main as jax_main
    from dsp_tpu_torch.cli.main import main as port_main

    args = ["-p", "-c", "2", "-n", "gain", "-3", "matrix4", "-6"]
    assert jax_main(list(args)) == 1
    want = capsys.readouterr()
    assert port_main(list(args)) == 1
    got = capsys.readouterr()
    assert got.out == want.out == ""
    assert "effect 'matrix4' does not support plotting" in got.err
    assert got.err.replace("dsp-torch", "dsp") == want.err
