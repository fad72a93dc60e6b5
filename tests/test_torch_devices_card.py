"""process_batch with a real replica on a second device: one group on the
card and one on the CPU, the chain built on either (CompiledChain._replica
builds the other device's copy). Each group's rows sit within
CARD_LIMIT_DBFS of the card's one-group batch, and the card group launches
the kernels of the one-group batch: K1 and the crossfeed's for the
flagship, the noise, dither and meter kernels for the modulated chain.

These tests need the card and skip without one. tests/conftest.py imports
jax, which the card's machine lacks, so they run there without it:

    python -m pytest --noconftest -m cuda tests/test_torch_devices_card.py
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a test process)
from torch_parity import FLAGSHIP, FS, worst_dbfs
from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
from dsp_tpu_torch.core.types import StreamInfo

S = 4
FRAMES = 16384
# the card's kernels against the CPU's plain versions: float64 sums taken in
# another order (the port's card-to-CPU limit)
CARD_LIMIT_DBFS = -200.0
MODULATED = "delay -M 0.5m -q 2 10m noise -90 dither sloped2 16 stats levels"
CHAINS = {"flagship": FLAGSHIP, "modulated": MODULATED}


def launches():
    from dsp_tpu_torch import kernels
    from dsp_tpu_torch.ops import iir

    return (iir.lti_blocked.launches + iir.crossfeed_step.launches + kernels.noise_launches()
            + kernels.dither_launches() + kernels.mod_delay_launches()
            + sum(kernels.meter_launches()))


def built(words, device):
    np.random.seed(7)  # noise and dither draw their keys from it
    return CompiledChain(build_chain_from_string(words, StreamInfo(FS, 2)), 2048, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("home, devices", [("cuda", ["cuda:0", "cpu"]), ("cpu", ["cpu", "cuda:0"])],
                         ids=["chain-on-card", "chain-on-cpu"])
@pytest.mark.parametrize("name", list(CHAINS))
def test_replica_on_a_second_device(name, home, devices):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    xs = np.random.default_rng(0).standard_normal((S, FRAMES, 2)) * 0.3
    k0 = launches()
    one = built(CHAINS[name], "cuda").process_batch(xs)
    k1 = launches() - k0
    k0 = launches()
    y = built(CHAINS[name], home).process_batch(xs, devices=devices)
    assert k1 > 0 and launches() - k0 == k1
    assert y.shape == one.shape and np.isfinite(y).all()
    for g in range(2):
        rows = slice(g * S // 2, (g + 1) * S // 2)
        assert worst_dbfs(y[rows], one[rows]) <= CARD_LIMIT_DBFS, (g, devices[g])
