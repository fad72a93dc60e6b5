"""process_batch across a list of devices (CompiledChain.process_batch(xs,
devices=[...])), dsp_tpu's mesh route in one process, on lists of CPU
devices:

* ["cpu"] * 2 and ["cpu"] * 4 on S = 8 streams equal devices=None (one
  group of 8) bit for bit, in float64 and float32: the flagship, a fir_p
  chain on the Nupols engine run past a super-block (its host counter
  ``cnt``), matrix4 run past the end of a fade (its host leaves ``fade_p``
  and ``disable``) and chip_smoke.py's MODULATED chain (noise, dither and
  the meters: every group draws from the live key);
* each group's host leaves advance once a block, whatever the number of
  groups;
* an uneven S and an empty list raise ValueError, a CUDA device on a
  machine without one raises, and the live state is neither consumed nor
  advanced.

dryrun.MC_CHAIN's cases and the port's dry run are in
test_torch_batch_devices_mc.py, the comparison with dsp_tpu's 8-device mesh
batch in test_torch_batch_devices_jax.py, a replica on a second device (the
card and the CPU) in test_torch_devices_card.py.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a test process)
from test_torch_batch_m4 import _assert_tree_equal, _clone
from torch_parity import FLAGSHIP, FS
from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
from dsp_tpu_torch.core.types import StreamInfo

S = 8
DTYPES = {"f64": torch.float64, "f32": torch.float32}
# a 9000-tap filter at B = 128: 71 partitions, the Nupols engine with
# super-blocks of 8 blocks
FIR_P = "fir_p coefs:" + ",".join(
    f"{v:.5f}" for v in np.random.default_rng(1).uniform(-0.1, 0.1, 9000))
MODULATED = "delay -M 0.5m -q 2 10m noise -90 dither sloped2 16 stats levels"
# spec, block, input frames, process_batch's arguments (matrix4's drain of
# 2,875 frames would triple its blocks, and its plain event engine is a
# Python loop a tick; its latency is longer than the run, so nothing is
# discarded)
CHAINS = {
    "flagship": (FLAGSHIP, 1000, 5000, {}),
    "fir_p": (FIR_P, 128, 1500, {}),
    "matrix4": ("matrix4 -6", 256, 768, {"drain": False, "discard": False}),
    "modulated": (MODULATED, 2048, 1500, {}),
}
# matrix4's live state is set mid-fade: fade_p counts down by the block and
# ends inside the run (500, 244, 0)
FADE_LEFT = 500


def chain(name, dtype, seed=3):
    spec, block, _, _ = CHAINS[name]
    np.random.seed(seed)  # noise and dither draw their keys from it
    cc = CompiledChain(build_chain_from_string(spec, StreamInfo(FS, 2)), block, dtype=dtype,
                       device="cpu")
    if name == "matrix4":
        st = cc.states[0]
        st["fade_p"], st["disable"] = torch.tensor(FADE_LEFT), torch.tensor(True)
    return cc


def streams(name, seed=0):
    n = CHAINS[name][2]
    return np.random.default_rng(seed).standard_normal((S, n, 2)) * 0.3


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(CHAINS))
def test_device_groups_equal_one_group(name, dt):
    cc = chain(name, DTYPES[dt])
    xs, kw = streams(name), CHAINS[name][3]
    one = cc.process_batch(xs, **kw)
    assert one.shape[0] == S and one.shape[1] >= CHAINS[name][2] and np.isfinite(one).all()
    for n in (2, 4):
        np.testing.assert_array_equal(cc.process_batch(xs, devices=["cpu"] * n, **kw), one)


def test_one_device_list_equals_none():
    cc = chain("flagship", torch.float64)
    xs = streams("flagship")
    one = cc.process_batch(xs)
    np.testing.assert_array_equal(cc.process_batch(xs, devices=["cpu"]), one)
    np.testing.assert_array_equal(cc.process_batch(xs, devices=[torch.device("cpu")]), one)


@pytest.mark.parametrize("groups", [2, 4])
def test_host_leaves_advance_once_a_block_in_every_group(groups, monkeypatch):
    """Each group holds its own host leaves: NupolsConv's cnt and matrix4's
    fade_p count once a block in every group (a leaf shared by the groups
    would advance once a group)."""
    for name, leaf, stride in (("fir_p", "cnt", None), ("matrix4", "fade_p", 256)):
        cc = chain(name, torch.float64)
        e, _ = next((e, n) for e, n in cc._steps if n == 0 and hasattr(e, "host_leaves"))
        seen = []
        real = e.step

        def spy(state, x, real=real, seen=seen, leaf=leaf):
            seen.append(int(state[leaf]))
            return real(state, x)

        monkeypatch.setattr(e, "step", spy, raising=False)
        cc.process_batch(streams(name), devices=["cpu"] * groups, **CHAINS[name][3])
        monkeypatch.undo()
        per_group = [seen[g::groups] for g in range(groups)]
        assert all(p == per_group[0] for p in per_group), per_group
        if stride is None:  # the super-block of 8 blocks, from the live 0
            assert per_group[0] == [i % 8 for i in range(len(per_group[0]))]
        else:
            want = [max(FADE_LEFT - i * stride, 0) for i in range(len(per_group[0]))]
            assert per_group[0] == want and want[-1] == 0 and len(want) == 3
        assert int(cc.states[0][leaf]) == per_group[0][0]  # the live leaf unmoved


def test_live_state_neither_consumed_nor_advanced():
    cc = chain("modulated", torch.float64)
    xs = streams("modulated")
    cc.process_array(xs[0], drain=False)  # moves the live state on
    live = _clone(cc.states)
    batch = cc.process_batch(xs, devices=["cpu"] * 4)
    _assert_tree_equal(cc.states, live)
    for s in (0, 5):
        cc.states = _clone(live)
        np.testing.assert_array_equal(batch[s], cc.process_array(xs[s]))


@pytest.mark.parametrize("devices", [["cpu"] * 3, ["cpu"] * 5, []], ids=["3", "5", "none"])
def test_uneven_streams_raise(devices):
    cc = chain("flagship", torch.float64)
    with pytest.raises(ValueError, match="do not split evenly"):
        cc.process_batch(streams("flagship"), devices=devices)


def test_unreachable_device_raises():
    """Every device is resolved by config.resolve_device: a CUDA device where
    there is none raises, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cc = chain("flagship", torch.float64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cc.process_batch(streams("flagship"), devices=["cpu", "cuda:0"])


def test_replica_shares_the_chain_and_draws_no_seed():
    """A chain's replica for another device shares its effects, builds its
    own fused cascades, holds no states and draws nothing from numpy's
    generator (noise and dither draw their keys at _initial_state)."""
    cc = CompiledChain(build_chain_from_string(FLAGSHIP, StreamInfo(FS, 2)), 2048, device="cpu")
    other = torch.device("meta")
    np.random.seed(11)
    before = np.random.get_state()[1].copy()
    rep = cc._replica(other)
    assert np.array_equal(np.random.get_state()[1], before)
    assert rep is cc._replica(other) and rep is not cc and cc._replica(torch.device("cpu")) is cc
    assert rep.chain is cc.chain and rep.states is None and rep.device == other
    assert [e.name for e in rep._runtime_effects] == [e.name for e in cc._runtime_effects]
    fused = [i for i, e in enumerate(cc._runtime_effects) if type(e).__name__ == "FusedBiquadCascade"]
    assert fused and all(rep._runtime_effects[i] is not cc._runtime_effects[i] for i in fused)
