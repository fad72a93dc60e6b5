"""crossfeed: Linkwitz/CMoy-style headphone crossfeed
(reference: crossfeed.c).

out0 = direct*s0 + cross*LP(s1) + cross*HP(s0) (and symmetrically for out1)
with first-order low/high-pass at f0; direct = sep/(1+sep), cross = 1/(1+sep),
sep = 10^(separation_dB/20). The four first-order filters run as one 4-lane
biquad scan (K2) and the mix in the same launch
(dsp_tpu_torch.ops.iir.crossfeed_step). Under float32 the coefficients are
cast to float32 before the state-space form is computed, and the scan and
the mix run in float32, as dsp_tpu's do.
"""

import numpy as np
import torch

from dsp_tpu_torch.core.parse import num_bits_set, parse_freq, strtod, ParseError
from dsp_tpu_torch.effects import biquad as bq
from dsp_tpu_torch.effects.base import EFFECT_FLAG_PLOT_MIX, Effect, EffectError, register_effect
from dsp_tpu_torch.ops import iir


class CrossfeedEffect(Effect):
    def __init__(self, name, istream, selector, freq, sep_db):
        self.name = name
        self.istream = istream
        self.ostream = istream
        self.channel_selector = np.asarray(selector, dtype=bool).copy()
        self.flags = EFFECT_FLAG_PLOT_MIX
        idx = np.flatnonzero(self.channel_selector)
        self.c0, self.c1 = int(idx[0]), int(idx[1])
        sep = 10.0 ** (sep_db / 20.0)
        self.direct_gain = sep / (1 + sep)
        self.cross_gain = 1 / (1 + sep)
        lp = bq.normalize(*bq.design(bq.LOWPASS_1, istream.fs, freq))
        hp = bq.normalize(*bq.design(bq.HIGHPASS_1, istream.fs, freq))
        self.lp = lp
        self.hp = hp
        # lanes: [lp(s1)->c0, lp(s0)->c1, hp(s0)->c0, hp(s1)->c1]
        self.c = np.stack([np.array(lp), np.array(lp), np.array(hp), np.array(hp)], axis=1)
        # companion-form lanes, as dsp_tpu's crossfeed passes them to the scan
        self._ss_A, self._ss_Bv, self._ss_c0 = iir.biquad_coeffs_to_ss(self.c)
        self._ss32_A, self._ss32_Bv, self._ss32_c0 = iir.biquad_coeffs_to_ss(self.c, np.float32)

    def state0(self):
        return np.zeros((4, 2), dtype=np.float64)

    def step(self, state, x):
        ss = "_ss32" if x.dtype == torch.float32 else "_ss"
        A, Bv, c0c = (self.device_array(ss + k, x) for k in ("_A", "_Bv", "_c0"))
        return iir.crossfeed_step(A, Bv, c0c, state, x.contiguous(), self.c0, self.c1,
                                  self.direct_gain, self.cross_gain)

    def channel_deps(self):
        deps = np.eye(self.istream.channels, dtype=bool)
        deps[self.c0, self.c1] = True
        deps[self.c1, self.c0] = True
        return deps

    def _plot_channel(self, idx, c, cc):
        fs = self.ostream.fs
        lp, hp = self.lp, self.hp

        def bqf(co):
            return (
                f"{co[0]:.15e}+{co[1]:.15e}*exp(-j*w)+{co[2]:.15e}*exp(-2.0*j*w))/"
                f"(1.0+{co[3]:.15e}*exp(-j*w)+{co[4]:.15e}*exp(-2.0*j*w)"
            )

        return (
            f"H{c}_{idx}(w)=(abs(w)<=pi)?{self.direct_gain:.15e}*Ht{c}_{idx}(w*{fs}/2.0/pi)"
            f"+{self.cross_gain:.15e}*Ht{cc}_{idx}(w*{fs}/2.0/pi)*({bqf(lp)})"
            f"+{self.cross_gain:.15e}*Ht{c}_{idx}(w*{fs}/2.0/pi)*({bqf(hp)}):0/0"
        )

    def plot(self, idx, channel_offset=0):
        fs = self.ostream.fs
        lines = []
        for k in range(self.ostream.channels):
            if k == self.c0:
                lines.append(self._plot_channel(idx, self.c0, self.c1))
            elif k == self.c1:
                lines.append(self._plot_channel(idx, self.c1, self.c0))
            else:
                lines.append(f"H{k}_{idx}(w)=Ht{k}_{idx}(w*{fs}/2.0/pi)")
        return lines


def crossfeed_effect_init(ei, istream, selector, dir_, argv):
    name = argv[0]
    if len(argv) != 3:
        raise EffectError(f"{name}: usage: {ei.usage}")
    if num_bits_set(selector) != 2:
        raise EffectError(f"{name}: input channels must be 2")
    try:
        freq = parse_freq(argv[1])
    except ParseError:
        raise EffectError(f"{name}: failed to parse f0: {argv[1]}")
    if not (0.0 <= freq < istream.fs / 2.0):
        raise EffectError(f"{name}: f0 out of range")
    sep_db, rest = strtod(argv[2])
    if rest == argv[2] or rest:
        raise EffectError(f"{name}: failed to parse separation: {argv[2]}")
    if sep_db < 0.0:
        raise EffectError(f"{name}: separation out of range")
    return CrossfeedEffect(name, istream, selector, freq, sep_db)


register_effect("crossfeed", "crossfeed f0[k] separation", crossfeed_effect_init)
