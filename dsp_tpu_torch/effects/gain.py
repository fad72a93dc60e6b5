"""gain / mult / add effects (reference: gain.c).

Per-channel multiply (gain in dB, mult linear) or DC shift (add). Unselected
channels carry the identity value so the step is branch-free (gain.c:138-140).
Adjacent same-kind effects merge multiplicatively/additively (gain.c:57-79).
"""

import numpy as np

from dsp_tpu_torch.core.parse import strtod
from dsp_tpu_torch.effects.base import (
    EFFECT_FLAG_CH_DEPS_IDENTITY,
    EFFECT_FLAG_OPT_REORDERABLE,
    Effect,
    EffectError,
    register_effect,
)


class GainEffect(Effect):
    """Multiplicative (gain/mult) or additive (add) per-channel constant."""

    def __init__(self, name, istream, selector, v, additive):
        self.name = name
        self.istream = istream
        self.ostream = istream
        self.channel_selector = np.asarray(selector, dtype=bool).copy()
        self.additive = additive
        self.flags = EFFECT_FLAG_CH_DEPS_IDENTITY
        if not additive:
            self.flags |= EFFECT_FLAG_OPT_REORDERABLE
        noop = 0.0 if additive else 1.0
        self.v = np.where(self.channel_selector, v, noop).astype(np.float64)

    def step(self, state, x):
        v = self.device_array("v", x)
        return state, (x + v) if self.additive else (x * v)

    def merge(self, other):
        if type(other) is not type(self) or other.additive != self.additive:
            return False
        if self.additive:
            self.v = self.v + other.v
        else:
            self.v = self.v * other.v
        return True

    def plot(self, idx, channel_offset=0):
        if self.additive:
            # add uses effect_plot_noop in the reference (gain.c:122)
            return [f"H{k}_{idx}(f)=1.0" for k in range(self.ostream.channels)]
        return [f"H{k}_{idx}(w)={self.v[k]:.15e}" for k in range(self.ostream.channels)]


def _gain_init(ei, istream, selector, dir_, argv):
    name = argv[0]
    if len(argv) != 2:
        raise EffectError(f"{name}: usage: {ei.usage}")
    arg = argv[-1]
    v, rest = strtod(arg)
    if rest == arg or rest:
        raise EffectError(f"{name}: failed to parse value: {arg}")
    if ei.effect_number == 1:  # gain (dB)
        v = 10.0 ** (v / 20.0)
    additive = ei.effect_number == 3
    return GainEffect(name, istream, selector, v, additive)


register_effect("gain", "gain gain_dB", _gain_init, 1)
register_effect("mult", "mult multiplier", _gain_init, 2)
register_effect("add", "add value", _gain_init, 3)
