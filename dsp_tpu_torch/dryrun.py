"""Dry run of batched processing across devices.

    python -m dsp_tpu_torch.dryrun

runs one block of 2 streams a device through
``CompiledChain.process_batch(xs, devices=...)`` on every CUDA device there
is, and checks the output's shape. The chain (``MC_CHAIN``) is dsp_tpu's
multi-chip dry run's: an EQ, a 64-tap FIR (the FFT engine's dict state), a
matrix4 upmix (its host leaves ``fade_p`` and ``disable``) and a 2x rate
change, at block 256. ``dryrun_multidevice(devices)`` takes any list of
devices or their names, ``["cpu"] * 4`` too.
"""

import sys

import numpy as np

MC_CHAIN = (
    "eq 1k 1.0 +3 "
    "fir coefs:" + ",".join(f"{0.05 * (i % 7 - 3):.4f}" for i in range(64)) + " "
    "matrix4 -6 "
    "resample 88.2k"
)
FS = 44100
CHANNELS = 2
BLOCK = 256
STREAMS_A_DEVICE = 2


def dryrun_multidevice(devices):
    """Run one block of STREAMS_A_DEVICE streams a device of MC_CHAIN
    through process_batch(..., devices=devices), the chain compiled on
    devices[0], and check the output's shape. Returns that shape."""
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    devices = list(devices)
    if not devices:
        raise ValueError("dryrun_multidevice: no devices")
    chain = build_chain_from_string(MC_CHAIN, StreamInfo(FS, CHANNELS))
    cc = CompiledChain(chain, block_frames=BLOCK, device=devices[0])
    out_ch = chain.ostream.channels
    n_streams = STREAMS_A_DEVICE * len(devices)
    xs = np.random.default_rng(0).uniform(-0.5, 0.5, (n_streams, cc.block_frames, CHANNELS))
    ys = cc.process_batch(xs, devices=devices, drain=False, discard=False)
    want = (n_streams, cc.out_frames, out_ch)
    if ys.shape != want:
        raise AssertionError(f"dryrun_multidevice: output {ys.shape}, expected {want}")
    if not np.isfinite(ys).all():
        raise AssertionError("dryrun_multidevice: output not finite")
    print(f"dryrun_multidevice: ok ({len(devices)} devices, {n_streams} streams, "
          f"block {cc.block_frames}->{cc.out_frames}, ch {CHANNELS}->{out_ch})")
    return ys.shape


def main():
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        print("dryrun: no CUDA device", file=sys.stderr)
        return 1
    dryrun_multidevice([f"cuda:{i}" for i in range(n)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
