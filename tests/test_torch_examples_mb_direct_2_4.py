"""The matrix4_mb_direct_path_2_4 example of test_torch_examples.py, in a file of its
own so that the parallel runner (one file a worker) can place it beside
the others; the module's notes there say how it is held."""

import pytest

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from test_torch_examples import check_example, example_cases


@pytest.mark.parametrize("example,block,limit", example_cases("matrix4_mb_direct_path_2_4"))
def test_example_matches_dsp_tpu(example, block, limit):
    check_example(example, block, limit)
