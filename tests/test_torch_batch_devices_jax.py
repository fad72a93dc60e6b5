"""process_batch across devices against dsp_tpu's mesh route: the flagship
and a fir_p chain on the Nupols engine, float64, S = 8 streams over
["cpu"] * 4 in the port and sharded over dsp_tpu's 8-device CPU mesh
(process_batch(xs, mesh=Mesh(8 CPU devices)), built as
tests/test_state_hygiene.py builds it), within BATCH_LIMIT_DBFS.

The other chains of test_torch_batch_devices.py are held to dsp_tpu's
batch through the one-group batch (test_torch_batch_m4_jax.py,
test_torch_batch_td_jax.py), which the devices route equals bit for bit:
noise on every channel rounds one ulp apart between dsp_tpu's batch and
its process_array, which can flip a dither step, and matrix4's decisions
follow the FIR's rounding.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from torch_parity import FLAGSHIP, jax_chain, port_chain, worst_dbfs
from test_torch_batch import BATCH_LIMIT_DBFS
from test_torch_batch_devices import FIR_P

S = 8
# measured: flagship -313.1, fir_p -296.2 dBFS (BATCH_LIMIT_DBFS -275).
# spec, block, input frames: the fir_p chain at B = 128 is on the Nupols
# engine, and 1500 frames and its drain cross super-blocks of 8 blocks
CHAINS = {"flagship": (FLAGSHIP, 2048, 5000), "fir_p": (FIR_P, 128, 1500)}


@pytest.mark.parametrize("name", list(CHAINS))
def test_device_groups_match_dsp_tpu_mesh(name):
    spec, block, n = CHAINS[name]
    xs = np.random.default_rng(4).standard_normal((S, n, 2)) * 0.3
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    ref = jax_chain(spec, block).process_batch(xs, mesh=mesh)
    got = port_chain(spec, block).process_batch(xs, devices=["cpu"] * 4)
    assert got.shape == ref.shape
    err = worst_dbfs(got, ref)
    assert err <= BATCH_LIMIT_DBFS, err
