"""hilbert: FIR Hilbert-transform approximation
(reference: hilbert.c).

Odd-length Blackman-windowed ideal response; ``-a angle`` (degrees, default
-90) mixes sin/cos weights: center tap = cos(-a), odd taps = sin(-a) *
2/(pi k) * blackman. Delegates to the fir (-p/-z: partitioned) engine;
``-c`` aligns channels to the middle tap.
"""

import numpy as np

from dsp_tpu_torch.core.parse import ParseError, getopt, strtod, strtol
from dsp_tpu_torch.effects.base import EffectError, register_effect
from dsp_tpu_torch.effects.fir import FirEffect


def hilbert_effect_init(ei, istream, selector, dir_, argv):
    name = argv[0]
    args = argv[1:]
    if not args:
        raise EffectError(f"{name}: usage: {ei.usage}")
    try:
        opts, ind = getopt(args[:-1], "pzca:")
    except ParseError as e:
        raise EffectError(f"{name}: {e}")
    if ind != len(args) - 1:
        raise EffectError(f"{name}: usage: {ei.usage}")
    partitioned = False
    do_align = False
    angle = -np.pi / 2
    for opt, arg in opts:
        if opt in ("p", "z"):
            partitioned = True
        elif opt == "c":
            do_align = True
        elif opt == "a":
            v, rest = strtod(arg)
            if rest == arg or rest:
                raise EffectError(f"{name}: failed to parse angle: {arg}")
            angle = v / 180.0 * np.pi
    taps, rest = strtol(args[-1])
    if rest == args[-1] or rest:
        raise EffectError(f"{name}: failed to parse taps: {args[-1]}")
    if taps <= 3:
        raise EffectError(f"{name}: taps must be > 3")
    if taps % 2 == 0:
        raise EffectError(f"{name}: taps must be odd")
    h = np.zeros(taps, dtype=np.float64)
    w_h, w_d = np.sin(-angle), np.cos(-angle)
    for i in range(taps):
        k = i - taps // 2
        if k == 0:
            h[i] = w_d
        elif k % 2 == 0:
            h[i] = 0.0
        else:
            x = 2.0 * np.pi * i / (taps - 1)
            h[i] = w_h * 2.0 / (np.pi * k) * (0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2.0 * x))
    ref = taps // 2 if do_align else 0
    return FirEffect(name, istream, selector, h[:, None], ref, partitioned)


register_effect("hilbert", "hilbert [-pzc] [-a angle] taps", hilbert_effect_init)
