"""Shared pieces of the dsp_tpu_torch parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and fed to both packages; dsp_tpu
runs on the CPU in float64, as its own tests do, and the port runs on the
CPU, where every kernel wrapper takes its plain PyTorch version.
"""

import numpy as np
import torch

# One intra-op thread a test process. The parallel runner starts about one
# process a core, and torch's default of a thread a core in each of them
# oversubscribes the cores: the plain versions' many short parallel ops
# then wait on each other's threads. Measured on an 8-core host, six of the
# port's heaviest test files (the partition models) on 6 workers: 388 s
# with torch's default, 57 s with one thread. Every port test file imports
# this module.
torch.set_num_threads(1)

FS = 44100

FLAGSHIP = (
    "gain -3 eq 1k 1.0 +3 eq 3.5k 0.8 -2 lowshelf 90 0.7071s +4 highshelf 10k 0.7071s -2 "
    "lowpass 18k 0.7071 highpass 30 0.7071 crossfeed 700 4.5 st2ms ms2st"
)

# The port and dsp_tpu compute the same float64 recurrences with sums taken
# in another order, so they differ by rounding only. Measured on the
# flagship chain (2 s of stereo noise, blocks 2048 and 1000): -308 to -313
# dBFS. -280 dBFS keeps a margin of about 30 dB over that and sits far below
# the -220 dBFS asked of the port and the -120 dBFS budget.
CHAIN_LIMIT_DBFS = -280.0


def dbfs(err):
    return 20.0 * np.log10(err) if err > 0 else -np.inf


def worst_dbfs(a, b):
    return dbfs(float(np.abs(np.asarray(a) - np.asarray(b)).max(initial=0.0)))


def stereo_signal(seconds, seed=0):
    """Seeded stereo test signal: noise plus a low sine (exercises the 30 Hz
    highpass and 90 Hz shelf), peak well under full scale."""
    rng = np.random.default_rng(seed)
    n = int(seconds * FS)
    t = np.arange(n)[:, None] / FS
    return 0.2 * rng.standard_normal((n, 2)) + 0.3 * np.sin(2 * np.pi * np.array([40.0, 1000.0]) * t)


def port_chain(spec, block, channels=2):
    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo

    return CompiledChain(
        build_chain_from_string(spec, StreamInfo(FS, channels)), block, device="cpu"
    )


def jax_chain(spec, block, channels=2):
    from dsp_tpu.chain import CompiledChain, build_chain_from_string
    from dsp_tpu.core.types import StreamInfo

    return CompiledChain(build_chain_from_string(spec, StreamInfo(FS, channels)), block)


def write_wav(path, x, enc="double"):
    from dsp_tpu_torch.codecs.base import CODEC_MODE_WRITE, CodecParams
    from dsp_tpu_torch.codecs.wav import WavWriter

    w = WavWriter(CodecParams(path=str(path), enc=enc, fs=FS, channels=x.shape[1],
                              mode=CODEC_MODE_WRITE))
    try:
        w.write(x)
    finally:
        w.close()


def read_wav(path):
    from dsp_tpu_torch.codecs.base import CodecParams
    from dsp_tpu_torch.codecs.wav import WavReader

    r = WavReader(CodecParams(path=str(path)))
    try:
        return r.read(r.frames)
    finally:
        r.close()
