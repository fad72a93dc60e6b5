"""st2ms / ms2st: mid/side encode/decode (reference: st2ms.c).

Operates on the two selected channels: st2ms scales by 0.5, ms2st by 1.
"""

import numpy as np

from dsp_tpu_torch.core.parse import num_bits_set
from dsp_tpu_torch.effects.base import EFFECT_FLAG_PLOT_MIX, Effect, EffectError, register_effect


class St2MsEffect(Effect):
    def __init__(self, name, istream, selector, scale):
        self.name = name
        self.istream = istream
        self.ostream = istream
        self.channel_selector = np.asarray(selector, dtype=bool).copy()
        self.flags = EFFECT_FLAG_PLOT_MIX
        self.scale = scale
        idx = np.flatnonzero(self.channel_selector)
        self.c0, self.c1 = int(idx[0]), int(idx[1])

    def step(self, state, x):
        s0 = x[..., self.c0]
        s1 = x[..., self.c1]
        y = x.clone()
        y[..., self.c0] = (s0 + s1) * self.scale
        y[..., self.c1] = (s0 - s1) * self.scale
        return state, y

    def channel_deps(self):
        deps = np.eye(self.istream.channels, dtype=bool)
        deps[self.c0, self.c1] = True
        deps[self.c1, self.c0] = True
        return deps

    def plot(self, idx, channel_offset=0):
        fs = self.ostream.fs
        lines = []
        for k in range(self.ostream.channels):
            if k == self.c0:
                lines.append(
                    f"H{k}_{idx}(w)=(Ht{self.c0}_{idx}(w*{fs}/2.0/pi)"
                    f"+Ht{self.c1}_{idx}(w*{fs}/2.0/pi))*{self.scale:g}"
                )
            elif k == self.c1:
                lines.append(
                    f"H{k}_{idx}(w)=(Ht{self.c0}_{idx}(w*{fs}/2.0/pi)"
                    f"-Ht{self.c1}_{idx}(w*{fs}/2.0/pi))*{self.scale:g}"
                )
            else:
                lines.append(f"H{k}_{idx}(w)=Ht{k}_{idx}(w*{fs}/2.0/pi)")
        return lines


def _st2ms_init(ei, istream, selector, dir_, argv):
    if len(argv) != 1:
        raise EffectError(f"{argv[0]}: usage: {ei.usage}")
    if num_bits_set(selector) != 2:
        raise EffectError(f"{argv[0]}: input channels must be 2")
    scale = 0.5 if ei.effect_number == 1 else 1.0
    return St2MsEffect(argv[0], istream, selector, scale)


register_effect("st2ms", "st2ms ", _st2ms_init, 1)
register_effect("ms2st", "ms2st ", _st2ms_init, 2)
