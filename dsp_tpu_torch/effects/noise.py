"""noise effect: add TPDF noise (reference: noise.c).

Level is peak dBFS, or effective precision in bits with the 'b' suffix
(mult = 2/2^bits). The noise is dsp_tpu's threefry stream (core/prng.py),
drawn on the device by the K18-noise kernel (ops/time_domain.tpdf_noise),
so both packages add the same numbers from the same key; the reference's
Park-Miller noise is wall-clock seeded and not reproducible anyway.
"""

import numpy as np
import torch

from dsp_tpu_torch.core.parse import strtod
from dsp_tpu_torch.core.prng import PM_RAND_MAX, prng_key
from dsp_tpu_torch.effects.base import (
    EFFECT_FLAG_CH_DEPS_IDENTITY,
    EFFECT_FLAG_PLOT_MIX,
    Effect,
    EffectError,
    register_effect,
)
from dsp_tpu_torch.ops import time_domain


def parse_level(s):
    """dBFS level, or bits with 'b' suffix (noise.c:29-44)."""
    v, rest = strtod(s)
    if rest == s:
        raise EffectError(f"noise: failed to parse level: {s}")
    if rest == "b":
        return 2.0 / (2.0**v)
    if rest:
        raise EffectError(f"noise: trailing characters: {rest}")
    return 10.0 ** (v / 20.0)


class NoiseEffect(Effect):
    split_safe = False  # PRNG stream: segments would replay the sequence

    def __init__(self, name, istream, selector, mult, seed=0):
        self.name = name
        self.istream = istream
        self.ostream = istream
        self.channel_selector = np.asarray(selector, dtype=bool).copy()
        self.flags = EFFECT_FLAG_PLOT_MIX | EFFECT_FLAG_CH_DEPS_IDENTITY
        self.mult = mult
        self.seed = seed
        self._every = bool(self.channel_selector.all())
        self._sel = {}  # the selector on each device, made at its first block there

    def state0(self):
        # the same draw as dsp_tpu's, so a seeded numpy gives both the same key
        return prng_key(self.seed if self.seed else np.random.randint(1 << 30)).numpy()

    def step(self, state, x):
        # the selector is fixed at init: a block reads its cached copy and
        # checks and copies nothing on the host
        sel = None
        if not self._every:
            sel = self._sel.get(x.device)
            if sel is None:
                sel = self._sel[x.device] = torch.as_tensor(self.channel_selector,
                                                            device=x.device)
        return time_domain.tpdf_noise(state, x, self.mult, sel)

    def plot(self, idx, channel_offset=0):
        fs = self.ostream.fs
        lines = []
        for k in range(self.ostream.channels):
            if self.channel_selector[k]:
                lines.append(f"H{k}_{idx}_lw=NaN")
                lines.append(f"H{k}_{idx}_lv=0")
                lines.append(
                    f"H{k}_{idx}_tpdf(w)=(w==H{k}_{idx}_lw)?H{k}_{idx}_lv:"
                    f"(H{k}_{idx}_lw=w, H{k}_{idx}_lv={self.mult * PM_RAND_MAX * 0.7071067811865476:.15e}"
                    f"*((rand(0)-rand(0))+j*(rand(0)-rand(0))))"
                )
                lines.append(f"H{k}_{idx}(w)=Ht{k}_{idx}(w*{fs}/2.0/pi)+H{k}_{idx}_tpdf(w)")
            else:
                lines.append(f"H{k}_{idx}(w)=Ht{k}_{idx}(w*{fs}/2.0/pi)")
        return lines


def _noise_init(ei, istream, selector, dir_, argv):
    if len(argv) != 2:
        raise EffectError(f"noise: usage: {ei.usage}")
    mult = parse_level(argv[1]) / PM_RAND_MAX
    return NoiseEffect(argv[0], istream, selector, mult)


register_effect("noise", "noise level[b]", _noise_init)
