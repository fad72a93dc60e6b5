"""process_batch across devices on dsp_tpu's multi-chip dry-run chain
(dryrun.MC_CHAIN: an EQ, a 64-tap FIR's dict state, matrix4's host leaves
and a 2x rate change) in float64: ["cpu"] * 2 and ["cpu"] * 4 on S = 8
streams equal one group bit for bit, from a live state in the middle of a
matrix4 fade; and the port's dry run on ["cpu"] * 4. The float32 case is
in test_torch_batch_devices_mc32.py (matrix4's plain event engine is a
Python loop a tick: ~7 s a batch).
"""

import numpy as np
import torch

import torch_parity  # noqa: F401  (one torch thread a test process)
from torch_parity import FS
from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
from dsp_tpu_torch.core.types import StreamInfo
from dsp_tpu_torch.dryrun import BLOCK, MC_CHAIN

S = 8
# matrix4's live state is set mid-fade: its block is 4704 (the resampler's
# quantum), so the fade ends inside the one block the run takes
FADE_LEFT = 1000


def mc_groups_equal_one_group(dtype):
    """The one-group batch of S streams of MC_CHAIN from a live state in the
    middle of a matrix4 fade, and the same batch over ["cpu"] * 2 and
    ["cpu"] * 4, bit for bit."""
    cc = CompiledChain(build_chain_from_string(MC_CHAIN, StreamInfo(FS, 2)), BLOCK,
                       dtype=dtype, device="cpu")
    m4 = next(i for i, e in enumerate(cc._runtime_effects) if e.name == "matrix4")
    cc.states[m4]["fade_p"], cc.states[m4]["disable"] = torch.tensor(FADE_LEFT), torch.tensor(True)
    xs = np.random.default_rng(0).standard_normal((S, 2000, 2)) * 0.3
    one = cc.process_batch(xs)
    assert one.shape[0] == S and np.isfinite(one).all()
    for n in (2, 4):
        np.testing.assert_array_equal(cc.process_batch(xs, devices=["cpu"] * n), one)
    assert int(cc.states[m4]["fade_p"]) == FADE_LEFT  # the live leaf unmoved


def test_mc_chain_groups_equal_one_group_f64():
    mc_groups_equal_one_group(torch.float64)


def test_dryrun_on_cpu_devices(capsys):
    from dsp_tpu_torch.dryrun import STREAMS_A_DEVICE, dryrun_multidevice

    shape = dryrun_multidevice(["cpu"] * 4)
    assert shape[0] == 4 * STREAMS_A_DEVICE and shape[2] == 4
    assert "dryrun_multidevice: ok (4 devices, 8 streams" in capsys.readouterr().out
