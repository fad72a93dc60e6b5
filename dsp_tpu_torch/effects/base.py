"""Effect protocol and registry (reference: effect.h, effect.c).

An effect is a typed stream transformer. Host-side construction (init) parses
arguments and precomputes coefficients (numpy/float64, like the reference's
init functions). The compute path is ``step(state, x)`` on torch tensors:
``x`` is a ``[frames, in_channels]`` block on the chain's device, the return
is ``(new_state, y)`` with ``y`` shaped ``[frames * ratio, out_channels]``.
``step`` returns new tensors and leaves its inputs unchanged. Every effect
also takes ``x`` as ``[S, frames, in_channels]`` (a stream axis) and every
state leaf with a leading S but its ``host_leaves`` (split and batched
processing, ``CompiledChain.process_array_split`` / ``process_batch``), so
it reads the block length as ``x.shape[-2]`` and the channels on dim -1.

State is a tensor, a tuple of tensors (``()`` when stateless), or a dict of
them (the FFT convolution engines), carried across blocks (filter memories,
delay lines). ``ratio`` is a Fraction: output/input frame ratio
(1 except for resample). Effects whose runtime is a no-op (``step is None``,
e.g. an integer ``delay`` folded into the alignment pass) still contribute
``channel_offsets`` to the chain passes, mirroring run==NULL effects
(effects_chain.c:586-590).
"""

from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from dsp_tpu_torch.core.types import StreamInfo

EFFECT_FLAG_PLOT_MIX = 1 << 0
EFFECT_FLAG_OPT_REORDERABLE = 1 << 1
EFFECT_FLAG_NO_DITHER = 1 << 2
EFFECT_FLAG_CH_DEPS_IDENTITY = 1 << 3
EFFECT_FLAG_ALIGN_BARRIER = 1 << 4


class EffectError(Exception):
    pass


@dataclass
class EffectInfo:
    name: str
    usage: str
    init: object  # callable(EffectInfo, StreamInfo, selector, dir, argv) -> Effect | list[Effect]
    effect_number: int = 0


_REGISTRY: dict[str, EffectInfo] = {}
_REGISTRY_ORDER: list[str] = []


def register_effect(name, usage, init, effect_number=0):
    info = EffectInfo(name=name, usage=usage, init=init, effect_number=effect_number)
    if name not in _REGISTRY:
        _REGISTRY_ORDER.append(name)
    _REGISTRY[name] = info
    return info


def get_effect_info(name):
    return _REGISTRY.get(name)


_CANONICAL_ORDER = [
    "lowpass_1", "highpass_1", "allpass_1", "lowshelf_1", "highshelf_1",
    "lowpass_1p", "lowpass", "highpass", "bandpass_skirt", "bandpass_peak",
    "notch", "allpass", "eq", "lowshelf", "highshelf", "lowpass_transform",
    "highpass_transform", "linkwitz_transform", "deemph", "biquad",
    "gain", "mult", "add", "crossfeed", "matrix4", "matrix4_mb", "remix",
    "st2ms", "ms2st", "delay", "resample", "fir", "fir_p", "zita_convolver",
    "hilbert", "decorrelate", "noise", "dither", "ladspa_host", "stats",
    "watch", "levels",
]


def reorder_registry():
    """Listing order = the reference's effect table (effect.c:46-67),
    independent of module import order (cross-imports register early)."""
    known = [n for n in _CANONICAL_ORDER if n in _REGISTRY]
    extra = [n for n in _REGISTRY_ORDER if n not in _CANONICAL_ORDER]
    _REGISTRY_ORDER[:] = known + extra


def print_all_effects(file=None):
    import sys

    f = file or sys.stdout
    for name in _REGISTRY_ORDER:
        f.write(f"  {_REGISTRY[name].usage}\n")


class Effect:
    """Base effect; subclasses set streams/selector and implement step()."""

    name: str = "?"
    istream: StreamInfo
    ostream: StreamInfo
    channel_selector: np.ndarray  # bool over istream.channels
    flags: int = 0
    ratio: Fraction = Fraction(1)

    # Offline split processing (CompiledChain.process_array_split): True when
    # running this effect from a zero state primed with enough preceding
    # input reproduces the sequential output to below the numerical noise
    # floor. False for effects whose state is not a decaying function of the
    # recent input: host-visible accumulators (stats/levels/watch), PRNG
    # streams (noise/dither/mod-delay), external plugins, and the adaptive
    # matrix4 event engines (multi-second ring buffers + discrete decisions).
    split_safe = True
    # The names of the state's dict leaves that the host reads and writes a
    # block (CPU tensors): with a stream axis they stay one for all streams,
    # which sit at the same block index.
    host_leaves = frozenset()

    def split_lookback(self):
        """Frames of preceding input (at this effect's input rate) that
        re-establish steady state from zeros for split processing. Stateless
        effects (state0 == ()) need none; the 1 s default covers
        fast-settling stateful filters; effects with long memory (long FIRs,
        near-unit-circle poles, explicit delays) override."""
        state = self.state0()
        if isinstance(state, tuple) and len(state) == 0:
            return 0
        return int(self.istream.fs)

    # --- compute path ---

    def state0(self):
        """Initial state (numpy arrays; converted to device tensors)."""
        return ()

    def step(self, state, x):
        """Block function on tensors: (state, x) -> (state', y)."""
        raise NotImplementedError

    # --- chain passes (host side) ---

    def prepare(self):
        """Called after the merge pass, before compilation."""

    def merge(self, other):
        """Try to absorb `other` (same class, compatible); return True if merged."""
        return False

    def channel_offsets(self):
        """(latency[out_ch], requested_delay[out_ch]) added by this effect."""
        n = self.ostream.channels
        return np.zeros(n, dtype=np.int64), np.zeros(n, dtype=np.int64)

    def channel_deps(self):
        """bool[out_ch, in_ch] dependence matrix, or None if not provided.

        None + CH_DEPS_IDENTITY flag means identity (handled by the passes);
        None without the flag means unknown (full alignment before this
        effect, mirroring effects_chain.c:779-783).
        """
        return None

    def drain_samples(self, samples):
        """Mutate cumulative per-output-channel tail lengths (may be None entries)."""

    def plot(self, idx, channel_offset=0):
        """Return gnuplot 'H<ch>_<idx>(w)=...' lines for each output channel,
        or None if the effect does not support plotting (a NULL e->plot in
        the reference, e.g. matrix4/resample/dither — effects_chain.c:1130)."""
        return None

    def signal(self):
        """Chain signal hook (SIGUSR2 / 's' key). Returns a state-update dict or None."""
        return None

    # --- host I/O hooks for stateful host-visible effects (stats, levels) ---

    def host_update(self, state):
        """Called by the runner after each block with the current state pytree."""

    def host_finish(self, state):
        """Called once at end of processing (e.g. stats prints its table)."""

    def describe(self):
        return self.name

    def device_array(self, name, like, dtype=None):
        """Host numpy attribute `name` as a tensor on `like`'s device, with
        `like`'s dtype unless `dtype` is given. Cached, and rebuilt when the host array's values change (a
        merge edits coefficients in place), so a step does not copy its
        constants to the device on every block."""
        host = np.asarray(getattr(self, name))
        cache = self.__dict__.setdefault("_device_arrays", {})
        dtype = dtype or like.dtype
        key = (name, like.device, dtype)
        hit = cache.get(key)
        if hit is None or not np.array_equal(hit[0], host):
            hit = (host.copy(), torch.as_tensor(host, dtype=dtype, device=like.device))
            cache[key] = hit
        return hit[1]


class ChannelPick:
    """Gather and scatter of the selected channels of a [B, C] (or
    [S, B, C]) block: the torch form of dsp_tpu's ``x[:, sel_idx]`` and
    ``x.at[:, sel_idx].set(ys)``.

    All channels in order pass the block itself; any other set uses an
    index tensor made once per device. No step builds an index on the host
    or reads one back from the device."""

    def __init__(self, sel_idx, channels):
        self.idx = np.asarray(sel_idx, dtype=np.int64)
        self.all = len(self.idx) == channels and np.array_equal(self.idx, np.arange(channels))
        self._index = {}

    def _index_on(self, device):
        t = self._index.get(device)
        if t is None:
            t = self._index[device] = torch.as_tensor(self.idx, device=device)
        return t

    def take(self, x):
        if self.all:
            return x
        return x.index_select(-1, self._index_on(x.device))

    def put(self, x, ys):
        if self.all:
            return ys
        y = x.clone()
        return y.index_copy_(x.dim() - 1, self._index_on(x.device), ys)
