"""The shipped example chains (examples/) through dsp_tpu_torch and dsp_tpu,
on the CPU in float64, at the same block, on 0.6 s of
torch_parity.stereo_signal (noise plus 40 Hz and 1 kHz sines).

matrix4_mb_2_4 and the riir crossover are held elsewhere
(test_torch_matrix4_mb_state.py, test_torch_fir.py). Frame counts are
exact. The others are pinned ~30 dB above their measurement. matrix4_mb's
engine is chaotic where a band sits at crosstalk level (PARITY.md), and
dsp_tpu's own output moves as much when only the chunking changes: dsp_tpu
at block 2048 against dsp_tpu at block 1000 differs by -106 to -108 dBFS
over the stream's first tenths. So the matrix4_mb examples are held, over
the whole run, to no worse than that spread (computed here on the same
input) plus 10 dB, and from 0.6 s on, where the 0.6 s input has ended and
the output is the chain's drain, ~30 dB above their measurement.
"""

import numpy as np
import pytest

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from torch_parity import FS, stereo_signal, worst_dbfs

SECONDS = 0.6
SETTLED = 0.6
SPREAD_MARGIN_DB = 10.0

# (example, block, limit), or for matrix4_mb (example, block, limit from
# SETTLED s on); measured on this input, the whole run:
CASES = [
    ("eq_demo", 2048, -283.0),  # -313.1
    ("eq_demo", 1000, -279.0),  # -309.5
    ("crossover_lr4_2kHz", 2048, -283.0),  # -313.1
    ("crossover_lr4_2kHz", 1000, -281.0),  # -311.1
    ("matrix4_2_2", 2048, -259.0),  # -289.2
    ("matrix4_2_2", 1000, -259.0),  # -289.3
    ("matrix4_2_4", 2048, -262.0),  # -292.0
    ("matrix4_2_4", 1000, -262.0),  # -292.3
    # whole run -102.3, -102.3, -105.0 (dsp_tpu's spread -106.4, -106.4,
    # -107.9); from SETTLED s on -128.6, -124.6, -124.6
    ("matrix4_mb_2_2", 2048, -98.0),
    ("matrix4_mb_direct_path_2_2", 2048, -94.0),
    ("matrix4_mb_direct_path_2_4", 2048, -94.0),
]


def _chains(path, block):
    from dsp_tpu.chain import CompiledChain as JaxChain
    from dsp_tpu.chain import build_chain_from_file as jax_build
    from dsp_tpu.core.types import StreamInfo as JaxStream
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_file
    from dsp_tpu_torch.core.types import StreamInfo

    port = CompiledChain(build_chain_from_file(path, StreamInfo(FS, 2)), block, device="cpu")
    return port, JaxChain(jax_build(path, JaxStream(FS, 2)), block)


def example_cases(*names):
    """pytest.param of each case of CASES whose example is in names, with
    its id."""
    return [pytest.param(*c, id=f"{c[0]} -b {c[1]}") for c in CASES if c[0] in names]


# the matrix4_mb examples run from test_torch_examples_mb*.py: one file runs
# on one worker of the parallel runner, and each of them takes minutes
@pytest.mark.parametrize("example,block,limit", example_cases(
    "eq_demo", "crossover_lr4_2kHz", "matrix4_2_2", "matrix4_2_4"))
def test_example_matches_dsp_tpu(example, block, limit):
    check_example(example, block, limit)


def check_example(example, block, limit):
    """One example of CASES through both packages, held as the module's
    notes say."""
    from pathlib import Path

    from dsp_tpu_torch.chain.chain import expected_out_frames

    path = str(Path(__file__).resolve().parents[1] / "examples" / example)
    x = stereo_signal(SECONDS)
    t, j = _chains(path, block)
    assert t.block_frames == j.block_frames
    y_t = t.process_array(x)
    y_j = np.asarray(j.process_array(x))
    assert y_t.shape == y_j.shape
    assert len(y_t) == expected_out_frames(t.chain, len(x)) - t.chain.output_discard
    whole = worst_dbfs(y_t, y_j)
    if not example.startswith("matrix4_mb"):
        print(f"{example} -b {block}: {whole:.1f} dBFS")
        assert whole <= limit
        return
    # dsp_tpu against itself, block 2048 against block 1000
    _, j1000 = _chains(path, 1000)
    spread = worst_dbfs(y_j, np.asarray(j1000.process_array(x)))
    n0 = int(SETTLED * FS)
    settled = worst_dbfs(y_t[n0:], y_j[n0:])
    print(f"{example} -b {block}: {whole:.1f} dBFS (dsp_tpu's spread {spread:.1f}), "
          f"from {SETTLED} s {settled:.1f}")
    assert len(y_t) > n0
    assert whole <= spread + SPREAD_MARGIN_DB
    assert settled <= limit
