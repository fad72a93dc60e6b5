"""fir / fir_p / zita_convolver effects: FFT convolution
(reference: fir.c, fir_p.c, zita_convolver.cpp).

All three share one implementation built on dsp_tpu_torch.ops.fft_conv,
with dsp_tpu's engine choice, so both packages pick the same engine and
state shapes for the same filter and block:

* ``fir``   -> zero-latency overlap-save (OlsConv, K5) while the filter is
  at most 4 blocks long; longer filters go to the partitioned engines below.
* ``fir_p`` / ``zita_convolver`` -> uniform partitioned overlap-save with an
  FDL (UpolsConv, K6), zero latency; from 64 partitions on, the two-group
  engine (NupolsConv, K7). ``max_part_len`` / ``min_part_len`` arguments
  are accepted for CLI compatibility and validated, but partitioning
  follows the chain block.

Mono filters are shared across all selected channels (fir.c:310-311).
"""

import numpy as np

from dsp_tpu_torch.core import log
from dsp_tpu_torch.core.parse import ParseError, getopt, num_bits_set, strtol
from dsp_tpu_torch.effects.base import (
    EFFECT_FLAG_CH_DEPS_IDENTITY,
    EFFECT_FLAG_OPT_REORDERABLE,
    ChannelPick,
    Effect,
    EffectError,
    register_effect,
)
from dsp_tpu_torch.effects.fir_util import filter_offset, parse_fir_opts, read_filter
from dsp_tpu_torch.ops.fft_conv import NupolsConv, OlsConv, UpolsConv


class FirEffect(Effect):
    # NupolsConv's block index within a super-block, read on the host
    host_leaves = frozenset({"cnt"})

    def __init__(self, name, istream, selector, filter_data, ref=0, partitioned=False):
        """filter_data: [frames, filter_channels] (1 or n_selected channels)."""
        self.name = name
        self.istream = istream
        self.ostream = istream
        self.channel_selector = np.asarray(selector, dtype=bool).copy()
        self.flags = EFFECT_FLAG_OPT_REORDERABLE | EFFECT_FLAG_CH_DEPS_IDENTITY
        self.sel_idx = np.flatnonzero(self.channel_selector)
        self._pick = ChannelPick(self.sel_idx, istream.channels)
        n_sel = len(self.sel_idx)
        filter_data = np.asarray(filter_data, dtype=np.float64)
        fch = filter_data.shape[1]
        if fch == 1 and n_sel > 1:
            filter_data = np.repeat(filter_data, n_sel, axis=1)
        elif fch != n_sel:
            raise EffectError(
                f"{name}: channels mismatch: channels={n_sel} filter_channels={fch}"
            )
        self.filters = filter_data.T  # [n_sel, F]
        self.filter_frames = filter_data.shape[0]
        self.ref = int(ref)
        self.partitioned = partitioned
        self._engines = {}

    def split_lookback(self):
        return int(self.filter_frames)

    def _engine(self, B):
        eng = self._engines.get(B)
        if eng is None:
            # single-FFT overlap-save is efficient when the filter is of the
            # order of the block; a long filter at a small block would redo
            # an O(F) FFT per block, so delegate to the partitioned FDL
            # engine (identical output, fft_conv.py)
            if self.partitioned or self.filter_frames > 4 * B:
                k_uniform = -(-self.filter_frames // B)
                # VERY long filters at SMALL blocks (realtime regimes): a
                # uniform FDL touches all k_uniform partition spectra every
                # block; switch to the two-group non-uniform engine
                # (fft_conv.NupolsConv, the fir_p.c:290-335 analog) once the
                # count is large enough that its cond/staging overhead pays
                # for itself. m ~ sqrt(F/B) balances head and tail groups.
                if k_uniform >= 64:
                    import math

                    # round-half-up so exact-half exponents (F/B = 4^k * 2)
                    # deliberately pick the LARGER head group: a bigger head
                    # shrinks the tail-group partition count, which is the
                    # expensive side at small blocks
                    m = 1 << int(math.log2(math.sqrt(self.filter_frames / B)) + 0.5)
                    m = max(2, m)
                    eng = NupolsConv(self.filters, B, m)
                else:
                    eng = UpolsConv(self.filters, B)
            else:
                eng = OlsConv(self.filters, B)
            self._engines[B] = eng
        return eng

    def state0(self):
        # the engine, and so the state's shape, depends on the block size:
        # CompiledChain asks state_for_block and converts numpy leaves
        return None  # placeholder; replaced via state_for_block

    def state_for_block(self, B):
        return self._engine(B).state0()

    def step(self, state, x):
        eng = self._engine(x.shape[-2])
        st, ys = eng.step(state, self._pick.take(x))
        return st, self._pick.put(x, ys)

    def channel_offsets(self):
        lat = np.zeros(self.ostream.channels, dtype=np.int64)
        req = np.zeros(self.ostream.channels, dtype=np.int64)
        req[self.sel_idx] = -self.ref
        return lat, req

    def drain_samples(self, samples):
        for k in self.sel_idx:
            samples[k] += self.filter_frames - 1

    def plot(self, idx, channel_offset=0):
        lines = []
        sel_map = {int(k): i for i, k in enumerate(self.sel_idx)}
        for k in range(self.ostream.channels):
            if k in sel_map:
                taps = self.filters[sel_map[k]]
                terms = "".join(
                    f"+exp(-j*w*{j})*{taps[j]:.15e}" for j in range(len(taps))
                )
                lines.append(
                    f"H{k}_{idx}(w)=(abs(w)<=pi)?exp(-j*w*{-self.ref})*(0.0{terms}):0/0"
                )
            else:
                lines.append(f"H{k}_{idx}(w)=1.0")
        return lines


def _fir_init_common(ei, istream, selector, dir_, argv, partitioned, extra_len_args):
    name = argv[0]
    args = argv[1:]
    if not args:
        raise EffectError(f"{name}: usage: {ei.usage}")
    try:
        opts, ind = getopt(args[:-1], "a::t:e:BLNr:c:")
    except ParseError as e:
        raise EffectError(f"{name}: {e}")
    cfg = parse_fir_opts(name, istream, opts)
    operands = args[ind:]
    if not operands:
        raise EffectError(f"{name}: usage: {ei.usage}")
    # optional part-len arguments before the filter path; validation matches
    # the reference exactly (they don't alter the uniform engine's execution)
    part_args = operands[:-1]
    if len(part_args) > extra_len_args:
        raise EffectError(f"{name}: usage: {ei.usage}")
    vals = []
    for a in part_args:
        v, rest = strtol(a)
        if rest:
            raise EffectError(f"{name}: failed to parse partition length: {a}")
        vals.append(v)
    path = operands[-1]
    data, fch, frames = read_filter(name, istream, selector, dir_, cfg, path)
    if extra_len_args == 2 and vals:
        # zita min/max_part_len, validated AFTER the filter loads (the
        # reference's checks live in init_with_filter, which runs after
        # fir_read_filter: zita_convolver.cpp:135-149, 245-248): 0 =
        # default, both within Convproc [MINPART=64, MAXPART=8192];
        # max < min is a warning (clamped); non-power-of-2 values pass the
        # range check but make Convproc::configure fail
        for v in vals:
            if v != 0 and not (64 <= v <= 8192):
                raise EffectError(
                    f"{name}: partition lengths must be within [64,8192] or 0 for default"
                )
        if len(vals) == 2:
            mn = vals[0] or 64
            mx = vals[1] or 8192
            if mx < mn:
                log.warn(f"{name}: warning: max_part_len < min_part_len")
        for v in vals:
            if v and v & (v - 1):
                raise EffectError(f"{name}: failed to configure convolution engine")
    if extra_len_args == 1 and vals and frames > 32:
        # fir_p max_part_len (fir_p.c:376-384): 0 = default, power of 2,
        # >= DIRECT_LEN (32). Filters of <= DIRECT_LEN taps bypass this
        # entirely — the reference delegates them to the plain fir engine
        # BEFORE validating (fir_p.c:364-365)
        v = vals[0]
        if v != 0:
            if v < 0 or v & (v - 1):
                raise EffectError(f"{name}: max_part_len must be a power of two")
            if v < 32:
                raise EffectError(
                    f"{name}: max_part_len must be within [32,{2**31 - 1}] or 0 for default"
                )
    ref = filter_offset(cfg, data)
    return FirEffect(name, istream, selector, data, ref, partitioned)


def fir_effect_init(ei, istream, selector, dir_, argv):
    return _fir_init_common(ei, istream, selector, dir_, argv, False, 0)


def fir_p_effect_init(ei, istream, selector, dir_, argv):
    return _fir_init_common(ei, istream, selector, dir_, argv, True, 1)


def zita_effect_init(ei, istream, selector, dir_, argv):
    return _fir_init_common(ei, istream, selector, dir_, argv, True, 2)


register_effect(
    "fir",
    "fir [-a[offset[s|m|S]]] [input_options] [file:][~/]filter_path|coefs:list[/list...]",
    fir_effect_init,
)
register_effect(
    "fir_p",
    "fir_p [-a[offset[s|m|S]]] [input_options] [max_part_len] [file:][~/]filter_path|coefs:list[/list...]",
    fir_p_effect_init,
)
register_effect(
    "zita_convolver",
    "zita_convolver [-a[offset[s|m|S]]] [input_options] [min_part_len [max_part_len]] [file:][~/]filter_path|coefs:list[/list...]",
    zita_effect_init,
)
