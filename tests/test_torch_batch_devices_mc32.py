"""test_torch_batch_devices_mc.py's case in float32: MC_CHAIN over
["cpu"] * 2 and ["cpu"] * 4 on S = 8 streams equals one group bit for bit.
"""

import torch

import torch_parity  # noqa: F401  (one torch thread a test process)
from test_torch_batch_devices_mc import mc_groups_equal_one_group


def test_mc_chain_groups_equal_one_group_f32():
    mc_groups_equal_one_group(torch.float32)
