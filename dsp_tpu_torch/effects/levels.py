"""levels effect: real-time per-channel RMS/peak meter
(reference: levels.c).

avg = EWMA of squared samples; peak = set-min EWMA (jump up instantly, decay
with the time constant), the max-affine recurrence m' = max(s, (1-g) m + g s).
A block runs on the K17 kernel (ops/time_domain.levels_step): one launch
of tiles of 256 samples over the card, each tile's max-affine map applied
to the carried meters in tile order (csrc/levels.cu). The meter bars render
through the status-line subsystem (dsp_tpu_torch.cli.terminal).
"""

import numpy as np

from dsp_tpu_torch.core.parse import ParseError, getopt, strtod
from dsp_tpu_torch.effects.base import (
    EFFECT_FLAG_ALIGN_BARRIER,
    EFFECT_FLAG_CH_DEPS_IDENTITY,
    EFFECT_FLAG_NO_DITHER,
    ChannelPick,
    Effect,
    EffectError,
    register_effect,
)
from dsp_tpu_torch.ops import time_domain


def draw_bar(avg, peak):
    """60-char meter bar (levels.c:38-49)."""
    s = [" "] * 60
    if not np.isfinite(avg):
        avg = -200.0
    if not np.isfinite(peak):
        peak = -200.0
    for i in range(4, 59, 5):
        s[i] = "."
    idx_avg = 59 + int(round(avg))
    if idx_avg >= 0:
        for i in range(min(idx_avg, 59) + 1):
            s[i] = "#"
    idx_peak = 59 + int(round(peak))
    if idx_peak >= 0:
        s[min(idx_peak, 59)] = "|"
    return "".join(s)


class LevelsEffect(Effect):
    split_safe = False  # host-visible meters

    def __init__(self, name, istream, selector, tc):
        self.name = name
        self.istream = istream
        self.ostream = istream
        self.channel_selector = np.asarray(selector, dtype=bool).copy()
        self.flags = EFFECT_FLAG_NO_DITHER | EFFECT_FLAG_CH_DEPS_IDENTITY | EFFECT_FLAG_ALIGN_BARRIER
        self.sel_idx = np.flatnonzero(self.channel_selector)
        self._pick = ChannelPick(self.sel_idx, istream.channels)
        self.g = 1.0 - np.exp(-1.0 / (istream.fs * tc))
        self._statuslines = None

    def state0(self):
        n = len(self.sel_idx)
        return {
            "avg": np.zeros(n),
            "peak": np.zeros(n),
            "block_peak": np.zeros(n),
        }

    def step(self, state, x):
        if len(self.sel_idx) == 0:
            return state, x
        avg, peak, block_peak = time_domain.levels_step(
            state["avg"], state["peak"], state["block_peak"], self._pick.take(x), self.g)
        return {"avg": avg, "peak": peak, "block_peak": block_peak}, x

    def plot(self, idx, channel_offset=0):
        # effect_plot_noop in the reference (levels.c:146, stats.c:302)
        return [f"H{k}_{idx}(f)=1.0" for k in range(self.ostream.channels)]

    def host_update(self, state):
        """Render the meters: one read of avg and block_peak a call (the
        hook's own sync), then block_peak is zeroed on the device."""
        from dsp_tpu_torch.cli import terminal

        if self._statuslines is None:
            self._statuslines = [terminal.Statusline() for _ in self.sel_idx]
            for sl in self._statuslines:
                terminal.register(sl)
        avg = state["avg"].cpu().numpy().copy()
        bp = state["block_peak"].cpu().numpy().copy()
        # the reference zeroes block_peak after every render (levels.c:84):
        # without the reset the peak readout is a lifetime max and never
        # falls back to the decaying set-min EWMA
        state["block_peak"].zero_()
        n_ch = self.istream.channels
        with np.errstate(divide="ignore"):
            for i, k in enumerate(self.sel_idx):
                a = 10.0 * np.log10(avg[i]) if avg[i] > 0 else -np.inf
                p = 10.0 * np.log10(bp[i]) if bp[i] > 0 else -np.inf
                bar = draw_bar(a, p)
                w = 2 if n_ch > 10 else 1
                self._statuslines[i].set(
                    f"{self.name}: channel {k:{w}d}: [{bar}]  avg:{a:+6.1f}; peak:{p:+6.1f}"
                )

    def host_finish(self, state):
        from dsp_tpu_torch.cli import terminal

        if self._statuslines:
            for sl in self._statuslines:
                terminal.unregister(sl)
            self._statuslines = None


def levels_effect_init(ei, istream, selector, dir_, argv):
    name = argv[0]
    try:
        opts, ind = getopt(argv[1:], "t:")
    except ParseError as e:
        raise EffectError(f"{name}: {e}")
    if ind != len(argv) - 1:
        raise EffectError(f"{name}: usage: {ei.usage}")
    tc = 0.3
    for opt, arg in opts:
        if opt == "t":
            v, rest = strtod(arg)
            if rest == arg or rest:
                raise EffectError(f"{name}: failed to parse time constant: {arg}")
            if not (0.01 <= v <= 10.0):
                raise EffectError(f"{name}: time constant out of range")
            tc = v
    return LevelsEffect(name, istream, selector, tc)


register_effect("levels", "levels [-t time_const]", levels_effect_init)
