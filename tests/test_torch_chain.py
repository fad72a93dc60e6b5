"""dsp_tpu_torch's chain against dsp_tpu's, on the CPU in float64.

The same chain string and the same seeded numpy input go through both
packages' CompiledChain.process_array (drain and discard included).
"""

import numpy as np
import pytest
import torch

from torch_parity import CHAIN_LIMIT_DBFS, FLAGSHIP, FS, jax_chain, port_chain, stereo_signal, worst_dbfs


def _both(spec, block, x):
    y_t = port_chain(spec, block).process_array(x)
    y_j = jax_chain(spec, block).process_array(x)
    return y_t, y_j


@pytest.mark.parametrize("block", [2048, 1000])
def test_flagship_matches_dsp_tpu(block):
    """Block 2048 fuses the six biquads into one K1 cascade; block 1000 is
    not a multiple of 128, so each biquad runs on K2."""
    x = stereo_signal(2.5, seed=block)
    cc = port_chain(FLAGSHIP, block)
    names = [e.name for e in cc._runtime_effects]
    if block == 2048:
        assert names == ["gain", "biquad(fused-cascade)", "crossfeed", "st2ms", "ms2st"]
    else:
        assert "biquad(fused-cascade)" not in names and len(names) == 10
    y_t = cc.process_array(x)
    y_j = jax_chain(FLAGSHIP, block).process_array(x)
    assert y_t.shape == y_j.shape
    assert worst_dbfs(y_t, y_j) <= CHAIN_LIMIT_DBFS


SINGLE = ["gain -3", "eq 1k 1.0 +3", "highpass 30 0.7071", "crossfeed 700 4.5", "st2ms ms2st"]


@pytest.mark.parametrize("block", [2048, 1000])
@pytest.mark.parametrize("spec", SINGLE)
def test_single_effect_matches_dsp_tpu(spec, block):
    x = stereo_signal(1.0, seed=len(spec))
    y_t, y_j = _both(spec, block, x)
    assert y_t.shape == y_j.shape
    assert worst_dbfs(y_t, y_j) <= CHAIN_LIMIT_DBFS


def test_selected_channels_match_dsp_tpu():
    """Channel selectors and a single biquad at block >= 256 (K1 with n=2)."""
    spec = ":0 eq 2k 2.0 -4 :1 lowpass 5k 0.7071 gain -1"
    x = stereo_signal(1.0, seed=5)
    y_t, y_j = _both(spec, 512, x)
    assert y_t.shape == y_j.shape
    assert worst_dbfs(y_t, y_j) <= CHAIN_LIMIT_DBFS


def test_align_effect_matches_dsp_tpu():
    """The alignment pass's per-channel delay (inserted after effects with
    latency, none of which is ported yet) against dsp_tpu's, over blocks."""
    import jax.numpy as jnp

    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu.effects.align import AlignEffect as JAlign
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.align import AlignEffect

    lens = [5, 0, 130]
    t = AlignEffect(StreamInfo(FS, 3), lens)
    j = JAlign(JStream(FS, 3), lens)
    st_t = torch.as_tensor(t.state0())
    st_j = jnp.asarray(j.state0())
    rng = np.random.default_rng(2)
    for B in (64, 256, 7):
        x = rng.standard_normal((B, 3))
        st_t, y_t = t.step(st_t, torch.as_tensor(x))
        st_j, y_j = j.step(st_j, jnp.asarray(x))
        np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
        np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))


def test_chain_passes_match_dsp_tpu():
    """The copied passes give the same effects, drain and discard."""
    from dsp_tpu.chain import build_chain_from_string as jbuild
    from dsp_tpu.core.types import StreamInfo as JStream
    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    for spec in (FLAGSHIP, "gain -3 gain -3 :0 eq 1k 1.0 +3 :1 eq 2k 1.0 -3"):
        a = build_chain_from_string(spec, StreamInfo(FS, 2))
        b = jbuild(spec, JStream(FS, 2))
        assert [e.name for e in a.effects] == [e.name for e in b.effects]
        assert (a.drain_frames, a.output_discard, a.ratio) == (b.drain_frames, b.output_discard, b.ratio)


def test_registry_matches_dsp_tpu():
    import dsp_tpu.effects.base as jbase
    import dsp_tpu_torch.effects.base as tbase

    assert tbase._REGISTRY_ORDER == jbase._REGISTRY_ORDER
    assert len(tbase._REGISTRY_ORDER) == 42
    for name in jbase._REGISTRY_ORDER:
        assert tbase._REGISTRY[name].usage == jbase._REGISTRY[name].usage


def _not_ported():
    from dsp_tpu_torch.effects import NOT_PORTED

    return [name for name, _ in NOT_PORTED]


@pytest.mark.parametrize("name", _not_ported())
def test_unported_effect_raises(name):
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects import EffectError, get_effect_info

    info = get_effect_info(name)
    with pytest.raises(EffectError, match=f"{name}: not yet ported to dsp_tpu_torch"):
        info.init(info, StreamInfo(FS, 2), np.ones(2, dtype=bool), ".", [name])


# the effects of slices C, D, E and F, with arguments each one takes
PORTED_LATER = {
    "delay": ["delay", "-f", "-m", "1m", "10m"],
    "noise": ["noise", "-60"],
    "dither": ["dither", "lipshitz"],
    "stats": ["stats", "-i"],
    "levels": ["levels", "-t", "0.1"],
    "resample": ["resample", "0.95", "48k"],
    "matrix4": ["matrix4", "direct_path", "-6"],
    "matrix4_mb": ["matrix4_mb", "direct_path", "-6"],
}


@pytest.mark.parametrize("name", list(PORTED_LATER))
def test_slice_c_effect_is_ported(name):
    """The effects of slice C (delay, noise, dither, stats, levels), slice D
    (resample), slice E (matrix4) and slice F (matrix4_mb, whose init makes
    its phase-linearising fir and the effect) build in the port; none is in
    NOT_PORTED."""
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects import get_effect_info

    assert name not in _not_ported()
    info = get_effect_info(name)
    made = info.init(info, StreamInfo(FS, 2), np.ones(2, dtype=bool), ".", PORTED_LATER[name])
    for e in made if isinstance(made, list) else [made]:
        assert e.name == name


def test_unported_effect_fails_the_chain():
    from dsp_tpu_torch.chain.parser import ChainParseError

    with pytest.raises(ChainParseError, match="not yet ported"):
        port_chain("gain -3 ladspa_host x.so label", 2048)
    with pytest.raises(ChainParseError, match="not yet ported"):
        port_chain("eq -r 1k 1.0 +3 watch x.dsp", 2048)


def test_cuda_device_without_cuda_raises(monkeypatch):
    """Asking for CUDA where there is none raises; nothing picks the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    chain = build_chain_from_string("gain -3", StreamInfo(FS, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompiledChain(chain, 2048, device="cuda")
    monkeypatch.setenv("DSP_TPU_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompiledChain(chain, 2048)
    monkeypatch.delenv("DSP_TPU_TORCH_DEVICE")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompiledChain(chain, 2048)  # the default device is cuda


def test_run_block_streams_like_process_array():
    """Block-by-block streaming gives the same samples as one process_array."""
    x = stereo_signal(0.5, seed=9)
    B = 1024
    n = len(x) // B * B
    whole = port_chain(FLAGSHIP, B).process_array(x[:n], drain=False)
    cc = port_chain(FLAGSHIP, B)
    parts = [cc.run_block(x[i : i + B]).numpy() for i in range(0, n, B)]
    np.testing.assert_array_equal(np.concatenate(parts), whole)
