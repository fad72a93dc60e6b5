"""Slice F of dsp_tpu_torch on the CPU in float64: bench_goldens/
matrix4_mb.npz's control stream replayed through the port's `matrix4_mb`
audio path.
"""

from pathlib import Path

import numpy as np
import torch

from torch_parity import FS, worst_dbfs

REPO = Path(__file__).resolve().parents[1]


def test_bench_golden_control_replay():
    """bench_goldens/matrix4_mb.npz holds dsp_tpu f64's output of `matrix4_mb
    -6` on the 4 s program signal and its control stream (the interpolator's
    coefficient sets of every tick, fitted, stored as float32). The port's
    FIR and control path run, the golden's sets replace the engines' in the
    audio path, at block 32768, as bench.py replays them: over the first
    two blocks within -120 dBFS of the golden (BASELINE's budget; the
    float32 sets bound it: measured -137.1 here, -120.8 over the whole 4 s
    on the card by chip_smoke.py)."""
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.fir import FirEffect
    from dsp_tpu_torch.effects.matrix4_mb import Matrix4MbEffect
    from test_torch_resample import program_signal

    z = np.load(REPO / "bench_goldens" / "matrix4_mb.npz")
    want = z["hi"].astype(np.float64) + z["lo"].astype(np.float64)
    ics = torch.as_tensor(z["ics"].astype(np.float64))
    B, n_blocks = 32768, 2
    cc = CompiledChain(build_chain_from_string("matrix4_mb -6", StreamInfo(FS, 2)), B, device="cpu")
    fir = next(e for e in cc.chain.effects if isinstance(e, FirEffect))
    mb = next(e for e in cc.chain.effects if isinstance(e, Matrix4MbEffect))
    fst, mst = cc._initial_state(fir), cc._initial_state(mb)
    x = torch.as_tensor(program_signal()[: n_blocks * B])
    ys = []
    for i in range(n_blocks):
        fst, xf = fir.step(fst, x[i * B:(i + 1) * B])
        ctl = dict(mb._control(mst, xf), ics=ics[i * B // 32:(i + 1) * B // 32])
        mst, y = mb._audio(mst, xf, ctl)
        ys.append(y.numpy())
    got = np.concatenate(ys)
    print(f"golden replay: {worst_dbfs(got, want[: len(got)]):.1f} dBFS")
    assert worst_dbfs(got, want[: len(got)]) <= -120.0
