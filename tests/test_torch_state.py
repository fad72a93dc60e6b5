"""Stream state crosses between dsp_tpu and dsp_tpu_torch, and the port
stands alone (no jax, no dsp_tpu)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_parity import CHAIN_LIMIT_DBFS, FLAGSHIP, jax_chain, port_chain, stereo_signal, worst_dbfs

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("block", [2048, 1000])
@pytest.mark.parametrize("first", ["dsp_tpu", "dsp_tpu_torch"])
def test_checkpoint_crosses_packages(first, block, tmp_path):
    """Half a stream in one package, save_state, load_state in the other,
    finish there: matches one uninterrupted dsp_tpu pass."""
    x = stereo_signal(2.0, seed=block)
    half = 40 * block  # a whole number of blocks: no zero padding mid-stream
    whole = jax_chain(FLAGSHIP, block).process_array(x)

    make = {"dsp_tpu": jax_chain, "dsp_tpu_torch": port_chain}
    second = "dsp_tpu_torch" if first == "dsp_tpu" else "dsp_tpu"
    a = make[first](FLAGSHIP, block)
    y1 = np.asarray(a.process_array(x[:half], drain=False))
    ckpt = tmp_path / "state.npz"
    a.save_state(str(ckpt))
    b = make[second](FLAGSHIP, block)
    b.load_state(str(ckpt))
    y2 = np.asarray(b.process_array(x[half:]))
    y = np.concatenate([y1, y2])
    assert y.shape == whole.shape
    assert worst_dbfs(y, whole) <= CHAIN_LIMIT_DBFS


@pytest.mark.parametrize("block", [2048, 1000])
def test_treedef_string_is_jax_s(block):
    import jax

    from dsp_tpu_torch.convert import flatten_states, states_to_numpy

    t = port_chain(FLAGSHIP, block)
    j = jax_chain(FLAGSHIP, block)
    assert flatten_states(t.states)[1] == str(jax.tree_util.tree_structure(j.states))
    leaves_t = states_to_numpy(t.states)
    leaves_j = jax.tree_util.tree_leaves(j.states)
    assert [(a.shape, a.dtype) for a in leaves_t] == [(np.shape(a), np.asarray(a).dtype) for a in leaves_j]


def test_convert_round_trip_and_nesting():
    import jax
    import torch

    from dsp_tpu_torch.convert import (
        flatten_states,
        states_from_numpy,
        states_to_numpy,
        unflatten_states,
    )

    states = [(), torch.ones(2, 3), (torch.zeros(1), torch.full((2,), 2.0)), (torch.ones(1),), None]
    like = [(), np.ones((2, 3)), (np.zeros(1), np.full(2, 2.0)), (np.ones(1),), None]
    assert flatten_states(states)[1] == str(jax.tree_util.tree_structure(like))
    leaves = states_to_numpy(states)
    back = unflatten_states(states, states_from_numpy(leaves, "cpu"))
    assert flatten_states(back)[1] == flatten_states(states)[1]
    for a, b in zip(states_to_numpy(back), leaves):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        unflatten_states(states, states_from_numpy(leaves[:-1], "cpu"))


# dict-state chains (the FFT-convolution engines keep dsp_tpu's dicts):
# spec, block, blocks before the checkpoint, pinned limit (test_torch_fir.py)
_FIR_P = "fir_p coefs:" + ",".join(
    f"{v:.17g}" for v in np.random.default_rng(5).uniform(-0.1, 0.1, 9000)
)
DICT_CHAINS = {
    "decorrelate": ("decorrelate -s 7", 1024, 30, -270.0),
    # Nupols at B = 128 with m = 8: 21 blocks stop mid-super-block (cnt = 5)
    "fir_p_nupols": (_FIR_P, 128, 21, -255.0),
}


@pytest.mark.parametrize("name", list(DICT_CHAINS))
@pytest.mark.parametrize("first", ["dsp_tpu", "dsp_tpu_torch"])
def test_dict_state_checkpoint_crosses_packages(first, name, tmp_path):
    """save_state in one package, load_state in the other, for states that
    are dicts, with an int32 leaf (NupolsConv's cnt) stopped mid-super-block."""
    import jax

    spec, block, n_blocks, limit = DICT_CHAINS[name]
    x = stereo_signal(1.0, seed=block)
    half = n_blocks * block
    whole = jax_chain(spec, block).process_array(x)

    make = {"dsp_tpu": jax_chain, "dsp_tpu_torch": port_chain}
    second = "dsp_tpu_torch" if first == "dsp_tpu" else "dsp_tpu"
    a = make[first](spec, block)
    y1 = np.asarray(a.process_array(x[:half], drain=False))
    ckpt = tmp_path / "state.npz"
    a.save_state(str(ckpt))
    with np.load(ckpt) as z:
        treedef = str(z["__treedef__"])
        ints = [z[k] for k in z.files if k.startswith("leaf_") and z[k].dtype == np.int32]
    b = make[second](spec, block)
    if second == "dsp_tpu":
        assert treedef == str(jax.tree_util.tree_structure(b.states))
    if name == "fir_p_nupols":
        assert "'cnt': *" in treedef and [int(v) for v in ints] == [5]
    else:
        assert treedef == "PyTreeDef([{'fdl': *, 'prev': *}])"
    b.load_state(str(ckpt))
    y2 = np.asarray(b.process_array(x[half:]))
    y = np.concatenate([y1, y2])
    assert y.shape == whole.shape
    assert worst_dbfs(y, whole) <= limit


@pytest.mark.parametrize("name", list(DICT_CHAINS))
def test_dict_treedef_string_is_jax_s(name):
    import jax

    from dsp_tpu_torch.convert import flatten_states, states_to_numpy

    spec, block, _, _ = DICT_CHAINS[name]
    t = port_chain(spec, block)
    j = jax_chain(spec, block)
    assert flatten_states(t.states)[1] == str(jax.tree_util.tree_structure(j.states))
    leaves_t = states_to_numpy(t.states)
    leaves_j = jax.tree_util.tree_leaves(j.states)
    assert [(a.shape, a.dtype) for a in leaves_t] == [(np.shape(a), np.asarray(a).dtype) for a in leaves_j]


def test_convert_round_trip_of_dicts():
    """Dicts flatten by sorted key, nest, and keep integer leaves' dtype."""
    import jax
    import torch

    from dsp_tpu_torch.convert import (
        flatten_states,
        states_from_numpy,
        states_to_numpy,
        unflatten_states,
    )

    f64 = torch.float64
    states = [{"prev": torch.ones(2, dtype=f64), "fdl": torch.zeros(3, 2, dtype=f64)}, (),
              {"tail": torch.ones(1, dtype=f64), "cnt": torch.tensor(3, dtype=torch.int32),
               "head": {"prev": torch.ones(1, dtype=f64), "fdl": torch.ones(2, 2, dtype=f64)}}, {}]
    like = [{"prev": np.ones(2), "fdl": np.zeros((3, 2))}, (),
            {"tail": np.ones(1), "cnt": np.int32(3),
             "head": {"prev": np.ones(1), "fdl": np.ones((2, 2))}}, {}]
    leaves, treedef = flatten_states(states)
    assert treedef == str(jax.tree_util.tree_structure(like))
    as_np = states_to_numpy(states)
    for a, b in zip(as_np, jax.tree_util.tree_leaves(like)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.asarray(b).dtype
    back = unflatten_states(states, states_from_numpy(as_np, "cpu"))
    assert flatten_states(back)[1] == treedef
    assert back[2]["cnt"].dtype == torch.int32 and int(back[2]["cnt"]) == 3


# slice C chains: threefry keys (uint32 [2]), int64 and int32 leaves, 0-d
# leaves (the modulated delay's phase, the stats sample count and limit)
KEY_CHAINS = {
    "modulated": "delay -M 0.5m -q 2 10m noise -90 dither sloped2 16 stats levels",
    "delivery_i": "gain -1 noise -70 dither lipshitz 16 stats -i",
}


@pytest.mark.parametrize("name", list(KEY_CHAINS))
@pytest.mark.parametrize("first", ["dsp_tpu", "dsp_tpu_torch"])
def test_key_state_checkpoint_crosses_packages(first, name, tmp_path):
    """Blocks in one package, save_state, load_state in the other, and run
    on in both: the two continue the same noise (keys cross as uint32),
    the same dither, delay and meters."""
    import jax

    from dsp_tpu_torch.convert import states_to_numpy

    spec, B, k, n = KEY_CHAINS[name], 1024, 17, 30
    x = stereo_signal(1.0, seed=k)[: n * B].reshape(n, B, 2)
    make = {"dsp_tpu": jax_chain, "dsp_tpu_torch": port_chain}
    second = "dsp_tpu_torch" if first == "dsp_tpu" else "dsp_tpu"
    np.random.seed(99)
    a = make[first](spec, B)
    np.random.seed(12345)  # the second chain's own keys: the checkpoint replaces them
    b = make[second](spec, B)
    a.run_blocks(x[:k])
    ckpt = tmp_path / "state.npz"
    a.save_state(str(ckpt))
    with np.load(ckpt) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 2)]
    assert any(leaf.dtype == np.uint32 and leaf.shape == (2,) for leaf in leaves)
    assert any(leaf.dtype == np.int64 and leaf.shape == () for leaf in leaves)
    b.load_state(str(ckpt))
    y_a = np.asarray(a.run_blocks(x[k:]))
    y_b = np.asarray(b.run_blocks(x[k:]))
    np.testing.assert_array_equal(y_a, y_b)  # quantized by the dither: equal
    if second == "dsp_tpu":
        got, want = [np.asarray(v) for v in jax.tree_util.tree_leaves(b.states)], states_to_numpy(a.states)
    else:
        got, want = states_to_numpy(b.states), [np.asarray(v) for v in jax.tree_util.tree_leaves(a.states)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype.kind == "f":
            # the modulated read agrees to -280 dBFS (1e-14), and the
            # dither's error history carries that difference
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-13)
        else:
            np.testing.assert_array_equal(g, w)


def test_load_state_validates(tmp_path):
    from dsp_tpu_torch.chain import ChainError

    cc = port_chain("eq 1k 1.0 +3", 512)
    ckpt = str(tmp_path / "s.npz")
    cc.save_state(ckpt)
    with pytest.raises(ChainError):
        port_chain("eq 1k 1.0 +3 lowpass 2k 0.7071", 512).load_state(ckpt)
    with pytest.raises(ChainError):
        port_chain("lowpass 2k 0.7071", 512).load_state(ckpt)
    bogus = str(tmp_path / "b.npz")
    np.savez(bogus, a=np.zeros(3))
    with pytest.raises(ChainError):
        cc.load_state(bogus)


_STANDALONE = r"""
import sys
import dsp_tpu_torch
import dsp_tpu_torch.chain, dsp_tpu_torch.cli.main, dsp_tpu_torch.codecs
import dsp_tpu_torch.convert, dsp_tpu_torch.effects, dsp_tpu_torch.kernels
import dsp_tpu_torch.ops.iir, dsp_tpu_torch.ops.fft_conv, dsp_tpu_torch.ops.time_domain
import dsp_tpu_torch.cli.terminal
from dsp_tpu_torch.cli.main import main
rc = main(["-q", "-s", sys.argv[1], "-o", "-e", "s16", sys.argv[2],
           "gain", "-3", "eq", "1k", "1.0", "+3", "crossfeed", "700", "4.5",
           "fir", "coefs:0.5,0.5", "lowpass", "-r", "1k", "0.7071", "decorrelate", "-s", "3",
           "delay", "-M", "0.2m", "-q", "0", "1m", "noise", "-80", "dither", "lipshitz",
           "stats", "-i", "levels"])
assert rc == 0, rc
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dsp_tpu"))
assert not bad, bad
print("standalone ok")
"""


def test_port_imports_no_jax_nor_dsp_tpu(tmp_path):
    """In a fresh interpreter, the port's modules and CLI run without
    loading jax or dsp_tpu."""
    from torch_parity import write_wav

    src = tmp_path / "in.wav"
    write_wav(src, stereo_signal(0.3, seed=1))
    env = dict(os.environ, DSP_TPU_TORCH_DEVICE="cpu", PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _STANDALONE, str(src), str(tmp_path / "out.wav")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "standalone ok" in out.stdout


def test_port_sources_import_no_jax_nor_dsp_tpu():
    pat = re.compile(r"^\s*(import\s+(jax|dsp_tpu)\b|from\s+(jax|dsp_tpu)(\.|\s))", re.M)
    files = sorted((REPO / "dsp_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f"{f} imports jax or dsp_tpu"
