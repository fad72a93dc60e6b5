"""remix effect: channel select/mix (reference: remix.c).

Each selector argument names the input channels summed into one output
channel ('.' = none). Output count = in_channels + (n_selectors - mask_bits).
Channels outside the active mask pass through on their own position; mask
channels beyond the selector list pass through identity (remix.c:100-147).

On the device this is a single [frames, in] x [in, out] matmul of a 0/1
mixing matrix (torch.matmul, kept on the device once).
"""

import numpy as np

from dsp_tpu_torch.core.parse import ParseError, num_bits_set, parse_selector_masked, selector_to_string
from dsp_tpu_torch.core.types import StreamInfo
from dsp_tpu_torch.effects.base import (
    EFFECT_FLAG_NO_DITHER,
    EFFECT_FLAG_PLOT_MIX,
    Effect,
    EffectError,
    register_effect,
)


class RemixEffect(Effect):
    def __init__(self, name, istream, selectors):
        """selectors: bool matrix [out_ch, in_ch]."""
        self.name = name
        self.istream = istream
        self.matrix = np.asarray(selectors, dtype=bool)
        out_channels = self.matrix.shape[0]
        self.ostream = StreamInfo(istream.fs, out_channels)
        self.channel_selector = np.ones(istream.channels, dtype=bool)
        self.flags = EFFECT_FLAG_PLOT_MIX
        if all(self.matrix.sum(axis=1) <= 1):
            self.flags |= EFFECT_FLAG_NO_DITHER
        self._mix = self.matrix.T.astype(np.float64)  # [in, out]

    def step(self, state, x):
        return state, x @ self.device_array("_mix", x)

    def channel_deps(self):
        return self.matrix.copy()

    def plot(self, idx, channel_offset=0):
        lines = []
        fs = self.ostream.fs
        for k in range(self.ostream.channels):
            terms = "".join(
                f"+Ht{j}_{idx}(w*{fs}/2.0/pi)"
                for j in range(self.istream.channels)
                if self.matrix[k, j]
            )
            lines.append(f"H{k}_{idx}(w)=0.0{terms}")
        return lines


def remix_effect_init(ei, istream, selector, dir_, argv):
    name = argv[0]
    args = argv[1:]
    if not args:
        raise EffectError(f"{name}: usage: {ei.usage}")
    selector = np.asarray(selector, dtype=bool)
    n_selectors = len(args)
    mask_bits = num_bits_set(selector)
    delta = n_selectors - mask_bits
    out_channels = istream.channels + delta
    if out_channels <= 0:
        raise EffectError(f"{name}: no output channels")
    matrix = np.zeros((out_channels, istream.channels), dtype=bool)
    i = 0
    ch = 0
    for k in range(out_channels):
        if ch >= istream.channels or selector[ch]:
            if i < n_selectors:
                if args[i] != ".":
                    try:
                        matrix[k] = parse_selector_masked(args[i], selector)
                    except ParseError as e:
                        raise EffectError(f"{name}: {e}")
                i += 1
            else:
                while ch < istream.channels and selector[ch]:
                    ch += 1
                if ch < istream.channels:
                    matrix[k, ch] = True
        else:
            matrix[k, ch] = True
        ch += 1
    return RemixEffect(name, istream, matrix)


register_effect("remix", "remix channel_selector|. ...", remix_effect_init)
