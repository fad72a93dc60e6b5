"""process_batch of matrix4 on the CPU against dsp_tpu's process_batch,
which vmaps its step over the streams: `matrix4 -6` over S = 3 streams of
transients in float64 (tests/test_torch_batch_m4.py's streams). The
packages' sums differ in order only: held at -265 dBFS, the one-stream
chain's limit (tests/test_torch_matrix4.py), about 30 dB above the
measurement (-292.2 dBFS). A file of its own (14 s serial): dsp_tpu's
batch compiles and runs for about 8 s.
"""

import torch

import dsp_tpu  # noqa: F401  (its config turns on jax's float64, as dsp_tpu runs)
from test_torch_batch_m4 import S, SPEC, batch_streams, chain
from torch_parity import jax_chain, worst_dbfs

BATCH_LIMIT_DBFS = -265.0


def test_batch_matches_dsp_tpu():
    xs = batch_streams()
    batch = chain(SPEC, 2048, torch.float64).process_batch(xs)
    ref = jax_chain(SPEC, 2048).process_batch(xs)
    assert batch.shape == ref.shape
    print(f"{SPEC} batch of {S} against dsp_tpu's: {worst_dbfs(batch, ref):.1f} dBFS")
    assert worst_dbfs(batch, ref) <= BATCH_LIMIT_DBFS
