"""The `matrix4_mb` free run of test_torch_matrix4_mb_chain.py with
the bank's L = 1 plan at block 1056, in a file of its own so that the parallel runner (one file a
worker) can place it beside the others; the module's notes there say how
it is held."""

import pytest

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from test_torch_matrix4_mb_chain import chain_cases, check_chain


@pytest.mark.parametrize("spec,block,limit,settled", chain_cases(3))
def test_chain_matches_dsp_tpu(spec, block, limit, settled):
    check_chain(spec, block, limit, settled)
