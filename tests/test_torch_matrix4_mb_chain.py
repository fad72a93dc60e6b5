"""Slice F of dsp_tpu_torch against dsp_tpu, on the CPU in float64: the
`matrix4_mb` chain (its phase-linearising fir and the effect) free running.

matrix4_mb's engine is chaotic where a band sits at crosstalk level
(PARITY.md). At the stream's start the phase-linearising FIR's pre-ringing
leaves the upper bands at ~1e-15, where the packages' FFT and bank rounding
(~2e-16) is a large part of the signal; the engines then differ for a few
tenths of a second and converge as the bands fill (tests of the parts with
the same inputs on both sides: test_torch_matrix4_mb.py). So the free runs
are held in two parts, each limit pinned ~30 dB above its measurement: the
whole output, and the output from SETTLED s on. Frame counts and the event
counters are exact.
"""

import numpy as np
import pytest

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from test_torch_matrix4 import DECISIONS, transient_signal
from torch_parity import jax_chain, port_chain, worst_dbfs

# --- free runs -------------------------------------------------------------------

# (chain, block, whole limit, settled limit), pinned ~30 dB above the
# measurement on 1 s of transients
CHAINS = [
    ("matrix4_mb -6", 2048, -108.0, -152.0),  # measured -138.8, -182.0
    ("matrix4_mb direct_path -3/0", 2048, -106.0, -150.0),  # -136.0, -179.7
    ("matrix4_mb filter_type=butterworth,freq_mask=0.5 -6", 2048, -100.0, -149.0),  # -129.8, -179.3
    ("matrix4_mb -6", 1056, -92.0, -155.0),  # the bank's L = 1 plan: -122.2, -185.5
]
SETTLED = 0.6


def _ev(cc):
    return next(st for st in cc.states if isinstance(st, dict) and "ev_thresh" in st)["ev"]


def chain_cases(*indices):
    """pytest.param of CHAINS[i] for each index, with its id."""
    return [pytest.param(*CHAINS[i], id=f"{CHAINS[i][0]} -b {CHAINS[i][1]}") for i in indices]


# the other two cases run from test_torch_matrix4_mb_chain_1056.py and
# test_torch_matrix4_mb_chain_direct.py: one file runs on one worker of the
# parallel runner, and each case takes minutes
@pytest.mark.parametrize("spec,block,limit,settled", chain_cases(0, 2))
def test_chain_matches_dsp_tpu(spec, block, limit, settled):
    check_chain(spec, block, limit, settled)


def check_chain(spec, block, limit, settled):
    """One free run of CHAINS through both packages, held as the module's
    notes say."""
    from dsp_tpu_torch.chain.chain import expected_out_frames

    x = transient_signal(1.0, seed=12)[:-123]
    t = port_chain(spec, block)
    j = jax_chain(spec, block)
    assert t.block_frames == j.block_frames
    y_t = t.process_array(x)
    y_j = np.asarray(j.process_array(x))
    assert y_t.shape == y_j.shape
    assert len(y_t) == expected_out_frames(t.chain, len(x)) - t.chain.output_discard
    ev_t, ev_j = _ev(t), _ev(j)
    for k in DECISIONS:
        assert np.array_equal(ev_t[k].numpy(), np.asarray(ev_j[k])), k
    assert int(ev_t["diff_count"].sum()) + int(ev_t["ord_count"].sum()) > 0
    n0 = int(SETTLED * 44100)
    per = [round(worst_dbfs(y_t[i:i + 4410], y_j[i:i + 4410]), 1) for i in range(0, len(y_t), 4410)]
    print(f"{spec} -b {block}: {worst_dbfs(y_t, y_j):.1f} dBFS, from {SETTLED} s "
          f"{worst_dbfs(y_t[n0:], y_j[n0:]):.1f}; a tenth of a second at a time {per}")
    assert worst_dbfs(y_t, y_j) <= limit
    assert worst_dbfs(y_t[n0:], y_j[n0:]) <= settled
