"""Internal channel-alignment effect (reference: align.c).

Inserted by the chain's alignment pass to equalize inter-channel latency.
Each channel k is delayed by a static ``len[k]`` samples, implemented as one
carried buffer of max(len) frames plus a static per-channel gather.

Deviation from align.c:53-62 (shared with dsp_tpu): the reference discards
``discard_frames`` initial frames *mid-chain* (variable first-block length).
Here the full delay is buffered and the chain accumulates an equivalent
*output-side* discard (CompiledChain.output_discard), which keeps block
shapes fixed and is exact for zero-initialized causal chains.
"""

import numpy as np
import torch

from dsp_tpu_torch.effects.base import EFFECT_FLAG_CH_DEPS_IDENTITY, Effect


class AlignEffect(Effect):
    def __init__(self, istream, lens, discard_frames=0):
        self.name = "align"
        self.istream = istream
        self.ostream = istream
        n = istream.channels
        self.channel_selector = np.ones(n, dtype=bool)
        self.flags = EFFECT_FLAG_CH_DEPS_IDENTITY
        self.lens = np.asarray(lens, dtype=np.int64)
        if len(self.lens) != n:
            raise ValueError(f"align: {len(self.lens)} lengths for {n} channels")
        self.discard_frames = int(discard_frames)
        self.maxlen = int(self.lens.max()) if n else 0

    def split_lookback(self):
        return self.maxlen

    def state0(self):
        return np.zeros((self.maxlen, self.istream.channels), dtype=np.float64)

    def step(self, state, x):
        L = self.maxlen
        if L == 0:
            return state, x
        B = x.shape[-2]
        buf = torch.cat([state.to(x.dtype), x], dim=-2)  # [L+B, C] (or [S, L+B, C])
        # out[n, k] = buf[n + L - len[k], k]
        self._gather_idx = np.arange(B)[:, None] + (L - self.lens)[None, :]
        idx = self.device_array("_gather_idx", buf, torch.int64)
        y = torch.gather(buf, -2, idx.expand(*buf.shape[:-2], B, buf.shape[-1]))
        return buf[..., -L:, :].clone(), y

    def drain_samples(self, samples):
        for k in range(self.istream.channels):
            if samples[k] is not None:
                samples[k] += int(self.lens[k])

    def plot(self, idx, channel_offset=0):
        return [f"H{k}_{idx}(f)=1.0" for k in range(self.ostream.channels)]  # effect_plot_noop (align.c:121)
