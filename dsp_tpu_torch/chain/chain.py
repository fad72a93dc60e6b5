"""Effects chain: build, optimize, align, compile, run.

The analog of the reference's effects_chain.c, as a pipeline: parse -> typed
effect list -> passes (merge optimization, channel alignment, drain
computation) -> a ``(states, block) -> (states, out_block)`` step over torch
tensors on one device. Offline processing loops that step over many blocks
that stay on the device, with one host->device and one device->host copy
per run of blocks. The passes are copied unchanged from dsp_tpu, so both
packages build the same chain from the same string.

Split and batched processing (``process_array_split``, ``process_batch``)
run S streams through the same step, a block of each at once: x [S, B, C]
and every state leaf with a leading S (but the host's counters, one for
all streams), so each kernel of the step runs the S streams in the launch
of one. ``process_batch(xs, devices=[...])`` cuts the streams into one
group a device, each on its device's replica of the compiled chain.
"""

import contextlib
import copy
from dataclasses import dataclass, field
from fractions import Fraction
from math import gcd, lcm

import numpy as np
import torch

from dsp_tpu_torch import config
from dsp_tpu_torch.core import log
from dsp_tpu_torch.core.types import StreamInfo
from dsp_tpu_torch.effects.align import AlignEffect
from dsp_tpu_torch.effects.base import EFFECT_FLAG_ALIGN_BARRIER, EFFECT_FLAG_CH_DEPS_IDENTITY, EFFECT_FLAG_OPT_REORDERABLE


class ChainError(Exception):
    pass


@dataclass
class Chain:
    istream: StreamInfo
    ostream: StreamInfo
    effects: list = field(default_factory=list)
    ratio: Fraction = Fraction(1)
    drain_frames: int = 0
    drain_out_frames: int = 0  # the same drain expressed at the OUTPUT rate (exact)
    output_discard: int = 0  # frames to drop at chain output (align-discard equivalent)
    zero_ref: int = 0

    @property
    def max_ch(self):
        m = max(self.istream.channels, self.ostream.channels)
        for e in self.effects:
            m = max(m, e.istream.channels, e.ostream.channels)
        return m

    def delay_frames(self):
        """Total chain latency in *input* frames (approx; effects_chain.c:1083-1089)."""
        d = Fraction(0)
        r = Fraction(1)
        for e in self.effects:
            lat, _ = e.channel_offsets()
            if len(lat):
                d += Fraction(int(lat.max()), 1) / r
            r *= e.ratio
        return float(d)


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------


def _has_merge(e):
    from dsp_tpu_torch.effects.base import Effect

    return type(e).merge is not Effect.merge


def optimize_chain(chain):
    """Merge pass (effects_chain.c:605-641): each merge-capable effect tries
    to absorb every following effect with identical stream params, skipping
    over OPT_REORDERABLE non-mergeables (so eq's merge across a gain)."""
    n_before = len(chain.effects)
    effects = chain.effects
    i = 0
    while i < len(effects):
        dest = effects[i]
        if _has_merge(dest):
            j = i + 1
            while j < len(effects):
                src = effects[j]
                if (
                    src.istream.fs != dest.istream.fs
                    or src.istream.channels != dest.istream.channels
                    or src.ostream.fs != dest.ostream.fs
                    or src.ostream.channels != dest.ostream.channels
                ):
                    break
                if not _has_merge(src):
                    if src.flags & EFFECT_FLAG_OPT_REORDERABLE:
                        j += 1
                        continue
                    break
                if dest.merge(src):
                    effects.pop(j)
                else:
                    j += 1
        i += 1
    if len(effects) < n_before:
        log.verbose(
            "optimize: info: reduced number of effects from %d to %d", n_before, len(effects)
        )


def prepare_chain(chain):
    for e in chain.effects:
        e.prepare()


def _query_channel_deps(e):
    deps = e.channel_deps()
    if deps is None:
        return None
    return np.asarray(deps, dtype=bool)


def _find_input_deps(ch, deps):
    """Transitive closure of channel coupling (effects_chain.c:703-725)."""
    n_out, n_in = deps.shape
    r = np.zeros(n_in, dtype=bool)
    r[ch] = True
    changed = True
    while changed:
        changed = False
        for i in range(n_out):
            if (r & deps[i]).any():
                new = deps[i] & ~r
                if new.any():
                    r |= deps[i]
                    changed = True
    return r


def _is_passthrough(e):
    return e.istream.channels == e.ostream.channels and (
        e.flags & (EFFECT_FLAG_CH_DEPS_IDENTITY | EFFECT_FLAG_OPT_REORDERABLE)
    )


def _insert_align(chain, idx, offsets, align_refs, prev):
    """Insert an AlignEffect after position idx-1 (align.c:95-162).

    Returns (n_inserted, discard_frames_at_this_point).
    """
    n = prev.ostream.channels
    at_end = idx >= len(chain.effects)
    if align_refs is not None:
        do_align = any(offsets[k] != align_refs[k] for k in range(n))
    else:
        do_align = any(offsets[k] != 0 for k in range(n))
    if not do_align:
        return 0, 0
    max_offset = 0 if at_end else offsets[0]
    for k in range(n):
        max_offset = max(max_offset, offsets[k])
    lens = np.zeros(n, dtype=np.int64)
    min_ref = max_offset
    for k in range(n):
        ref = align_refs[k] if align_refs is not None else max_offset
        min_ref = min(min_ref, ref)
        if offsets[k] != ref:
            lens[k] = ref - offsets[k]
        offsets[k] = ref
    discard = 0
    if min_ref > 0:
        for k in range(n):
            offsets[k] -= min_ref
        discard = min_ref
    e = AlignEffect(prev.ostream, lens, discard)
    chain.effects.insert(idx, e)
    if log.loglevel(log.LL_VERBOSE):
        for k in range(n):
            if lens[k]:
                log.verbose("align: info: channel %d: %d", k, int(lens[k]))
        if discard:
            log.verbose("align: info: discarding %d frames (at chain output)", discard)
    return 1, discard


def align_channels(chain):
    """Alignment pass (effects_chain.c:727-875), with output-side discard."""
    max_ch = chain.max_ch
    offsets = [0] * max_ch
    delays = [0] * max_ch
    nd_part = 0
    discards = []  # (position_after_insert, discard_frames)

    i = 0
    prev = None
    while i < len(chain.effects):
        e = chain.effects[i]
        deps = _query_channel_deps(e)
        have_deps = deps is not None
        if prev is not None:
            if e.flags & EFFECT_FLAG_ALIGN_BARRIER:
                ins, disc = _insert_align(chain, i, offsets, None, prev)
            elif have_deps:
                n_in = e.istream.channels
                align_refs = list(offsets[:n_in])
                done = np.zeros(n_in, dtype=bool)
                for k in range(n_in):
                    if done[k]:
                        continue
                    grp = _find_input_deps(k, deps)
                    max_offset = offsets[k]
                    for m in range(n_in):
                        if grp[m]:
                            done[m] = True
                            max_offset = max(max_offset, offsets[m])
                    for m in range(n_in):
                        if grp[m]:
                            align_refs[m] = max_offset
                ins, disc = _insert_align(chain, i, offsets, align_refs, prev)
            elif e.istream.fs != e.ostream.fs:
                log.verbose("info: %s: sample rate changed; doing full alignment", e.name)
                ins, disc = _insert_align(chain, i, offsets, None, prev)
            elif not _is_passthrough(e):
                log.verbose("warning: %s: channel deps unknown; doing full alignment", e.name)
                ins, disc = _insert_align(chain, i, offsets, None, prev)
            else:
                ins, disc = 0, 0
            if ins:
                i += ins
                if disc:
                    discards.append((i, disc))
        # propagate offsets/delays through the effect
        if have_deps:
            n_in, n_out = e.istream.channels, e.ostream.channels
            tmp_offsets = list(offsets[:n_in])
            tmp_delays = list(delays[:n_in])
            max_offset = max(tmp_offsets[:n_in], default=0)
            for o in range(n_out):
                offset_idx = -1
                delays[o] = 0
                for k in range(n_in):
                    if deps[o, k]:
                        if offset_idx < 0:
                            offset_idx = k
                            delays[o] = tmp_delays[k]
                        elif tmp_offsets[k] != tmp_offsets[offset_idx]:
                            raise ChainError(
                                f"align: BUG: channel {k} offset incorrect: "
                                f"{tmp_offsets[k]}!={tmp_offsets[offset_idx]}"
                            )
                        else:
                            delays[o] = min(delays[o], tmp_delays[k])
                offsets_o = tmp_offsets[offset_idx] if offset_idx >= 0 else max_offset
                if o < len(offsets):
                    offsets[o] = offsets_o
        elif not _is_passthrough(e):
            n_in, n_out = e.istream.channels, e.ostream.channels
            min_delay = delays[0]
            for k in range(1, n_in):
                min_delay = min(min_delay, delays[k])
                if offsets[k] != offsets[k - 1]:
                    raise ChainError(
                        f"align: BUG: channel {k} offset incorrect: {offsets[k]}!={offsets[k-1]}"
                    )
            for o in range(n_out):
                delays[o] = min_delay
        for o in range(e.ostream.channels, e.istream.channels):
            delays[o] = offsets[o] = 0
        n_out = e.ostream.channels
        for o in range(n_out):
            offsets[o] += delays[o] - nd_part
        lat, req = e.channel_offsets()
        if lat.any() or req.any():
            for o in range(n_out):
                offsets[o] += int(lat[o])
                delays[o] += int(req[o])
        elif e.ostream.fs != e.istream.fs:
            g = gcd(e.ostream.fs, e.istream.fs)
            rn, rd = e.ostream.fs // g, e.istream.fs // g
            for o in range(n_out):
                delays[o] = -(-delays[o] * rn // rd)
        nd_part = 0
        for o in range(n_out):
            nd_part = min(nd_part, delays[o])
        for o in range(n_out):
            offsets[o] -= delays[o] - nd_part
        prev = e
        i += 1

    chain.zero_ref = -nd_part
    if prev is not None:
        ins, disc = _insert_align(chain, len(chain.effects), offsets, None, prev)
        if disc:
            discards.append((len(chain.effects), disc))

    # convert per-position discards to chain-output frames
    total = Fraction(0)
    for pos, disc in discards:
        r = Fraction(1)
        for e in chain.effects[pos:]:
            r *= e.ratio
        total += disc * r
    if total.denominator != 1:
        # a rate change after an align-discard point makes the discard
        # fractional in output frames; the output-side discard (documented
        # deviation #2, PARITY.md) floors it — up to one output frame of
        # phase offset vs the reference's exact mid-chain discard
        log.verbose(
            "info: align discard is fractional at the output (%s frames); flooring",
            total,
        )
    chain.output_discard = int(total)


def set_drain_frames(chain):
    """Drain computation (effects_chain.c:877-923)."""
    max_ch = chain.max_ch
    samples = [0] * max_ch
    for e in chain.effects:
        deps = _query_channel_deps(e)
        if deps is not None:
            tmp = list(samples)
            for o in range(e.ostream.channels):
                ch_drain = 0
                for k in range(e.istream.channels):
                    if deps[o, k]:
                        ch_drain = max(ch_drain, tmp[k])
                samples[o] = ch_drain
        elif (
            not (e.flags & (EFFECT_FLAG_CH_DEPS_IDENTITY | EFFECT_FLAG_OPT_REORDERABLE))
            and e.istream.channels != e.ostream.channels
        ):
            m = max(samples[: e.istream.channels], default=0)
            for o in range(e.ostream.channels):
                samples[o] = m
        before = list(samples)
        e.drain_samples(samples)
        if samples == before and e.ostream.fs != e.istream.fs:
            g = gcd(e.ostream.fs, e.istream.fs)
            rn, rd = e.ostream.fs // g, e.istream.fs // g
            for o in range(e.ostream.channels):
                samples[o] = -(-samples[o] * rn // rd)
        for o in range(e.ostream.channels, e.istream.channels):
            samples[o] = 0
    drain = 0
    out_ch = chain.ostream.channels
    for o in range(out_ch):
        drain = max(drain, samples[o])
    # keep the exact output-rate figure: the back-conversion to input frames
    # below floors (mirroring effects_chain.c:918-920) and the runners need
    # the exact output-frame drain for their length accounting
    chain.drain_out_frames = drain
    if chain.istream.fs != chain.ostream.fs:
        g = gcd(chain.istream.fs, chain.ostream.fs)
        drain = drain * (chain.istream.fs // g) // (chain.ostream.fs // g)
    chain.drain_frames = drain
    log.verbose("info: input drain frames: %d", chain.drain_frames)


def finish_chain(chain):
    if not chain.effects:
        chain.ostream = chain.istream
        return chain
    chain.ostream = chain.effects[-1].ostream
    g = gcd(chain.ostream.fs, chain.istream.fs)
    chain.ratio = Fraction(chain.ostream.fs // g, chain.istream.fs // g)
    optimize_chain(chain)
    prepare_chain(chain)
    align_channels(chain)
    set_drain_frames(chain)
    return chain


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def build_chain_from_args(argv, stream, mask=None, dir_=None):
    """argv: list of effect/arg words (no program name)."""
    from dsp_tpu_torch.chain.parser import parse_string_into

    # join argv into a single line for diagnostics, preserving word boundaries
    # exactly (each argv element is one token, like ec_parse_argv)
    return build_chain_from_string(" ".join(_escape_word(w) for w in argv), stream, mask, dir_)


def _escape_word(w):
    # the reference lexes each argv element as ONE verbatim token
    # (ec_lex_word, effects_chain.c:79-103): quote anything the string
    # re-lexer would split or misread — whitespace, quotes, and '#'
    # (comment-start in the string grammar, plain literal in argv)
    if w == "" or any(c.isspace() for c in w) or '"' in w or "\\" in w or "#" in w:
        return '"' + w.replace("\\", "\\\\").replace('"', '\\"') + '"'
    return w


def build_chain_from_string(s, stream, mask=None, dir_=None):
    from dsp_tpu_torch.chain.parser import parse_string_into

    chain = Chain(istream=stream, ostream=stream)
    sref = [stream]
    parse_string_into(chain, s, None, dir_ or ".", sref, mask)
    return finish_chain(chain)


def build_chain_from_file(path, stream, mask=None, dir_=None, enforce_eof_marker=False):
    from dsp_tpu_torch.chain.parser import parse_file_into

    chain = Chain(istream=stream, ostream=stream)
    sref = [stream]
    if mask is None:
        mask = np.ones(stream.channels, dtype=bool)
    parse_file_into(chain, path, dir_ or ".", sref, mask, enforce_eof_marker)
    return finish_chain(chain)


# ---------------------------------------------------------------------------
# compilation / execution
# ---------------------------------------------------------------------------


def expected_out_frames(chain, n_in, drain=True):
    """THE output-length law, shared by every runner (process_array,
    process_batch, run_offline, the streaming flush): ceil(n_in * ratio)
    plus the chain's OUTPUT-rate drain when draining — the emergent total
    of the reference's run + drain accounting (ratio_mult_ceil at each
    rate change; ceil(N*n/d) exactly for a pure resample chain,
    resample.c:163-188). Pre-discard frames."""
    r = chain.ratio
    out = -(-n_in * r.numerator // r.denominator)
    if drain:
        out += chain.drain_out_frames
    return out


def block_quantum_for(effects):
    """Input-block quantum for a list of effects: the block size must keep
    every intermediate frame count integral (static shapes) and be a
    multiple of each effect's block_quantum expressed in input frames.
    Used by CompiledChain and by container effects (watch) that must export
    their sub-chain's quantum."""
    q = 1
    r = Fraction(1)  # product of ratios before the current effect
    for e in effects:
        quantum = int(getattr(e, "block_quantum", 1))
        if quantum > 1:
            need = Fraction(quantum) / r  # input frames per quantum
            q = lcm(q, need.numerator)
        r *= e.ratio
        q = lcm(q, r.denominator)
    return q


class CompiledChain:
    """A chain set up for a fixed input block size on one device.

    The input block size is rounded up so that every intermediate frame count
    is integral. ``device`` is a torch.device or a name (None reads
    DSP_TPU_TORCH_DEVICE, default cuda; config.resolve_device raises when
    CUDA is asked for and absent). ``dtype`` is torch.float64 or
    torch.float32 (None reads DSP_TPU_TORCH_DTYPE, default float64); every
    state leaf is cast to it, so a float32 chain carries the biquads' state
    as a float32 (hi, lo) pair, dsp_tpu's layout, and the keys and counters
    keep their integer dtypes.

    ``states`` holds one entry per runtime effect: a tensor, a tuple of
    tensors (``()`` for stateless effects), or a dict of them (the FFT
    convolution engines, dsp_tpu's layout). Offline use: process_array()
    runs every block of a whole array on the device and copies back once.
    """

    def __init__(self, chain, block_frames=None, dtype=None, device=None):
        self.chain = chain
        self.dtype = config.resolve_dtype(dtype)
        self.device = config.resolve_device(device)
        block_frames = block_frames or config.DEFAULT_BLOCK_FRAMES
        q = block_quantum_for(chain.effects)
        self.block_frames = -(-block_frames // q) * q
        self.out_frames = int(self.block_frames * chain.ratio)
        # per-effect input block size (rate changes alter it mid-chain)
        self._block_at = {}
        self._ratio_at = {}  # cumulative rate ratio BEFORE each effect
        frames = Fraction(self.block_frames)
        ratio = Fraction(1)
        for e in chain.effects:
            self._block_at[id(e)] = int(frames)
            self._ratio_at[id(e)] = ratio
            frames *= e.ratio
            ratio *= e.ratio
        self._replicas = {}
        self._compile()
        self.states = [self._initial_state(e) for e in self._runtime_effects]

    def _compile(self):
        """The runtime effects (fused cascades bound to self.device) and
        their execution plan."""
        self._runtime_effects = self._fuse(
            [e for e in self.chain.effects if not getattr(e, "runtime_noop", False)]
        )
        self._steps = self._schedule(self._runtime_effects)

    def _replica(self, device):
        """This chain compiled for `device` (a torch.device): self on its own
        device; elsewhere a copy made once a device that shares the chain,
        its effects (whose device tensors are cached a device) and its block
        plan, and builds its own fused cascades and biquad runs there. A
        replica holds no states: a batch gives each group its own copy of
        the live ones. Built without _initial_state, so no effect draws a
        seed from numpy's generator for it."""
        key = _device_key(device)
        if key == _device_key(self.device):
            return self
        cc = self._replicas.get(key)
        if cc is None:
            cc = copy.copy(self)
            cc.device, cc.states, cc._replicas = key, None, {}
            cc._compile()
            self._replicas[key] = cc
        return cc

    def _step(self, states, x):
        new_states = []
        for e, n in self._steps:
            if n:  # a BiquadRun: the states of its n effects
                st, x = e.step(states[len(new_states):len(new_states) + n], x)
                new_states.extend(st)
            else:
                st, x = e.step(states[len(new_states)], x)
                new_states.append(st)
        return new_states, x

    def _schedule(self, effects):
        """The execution plan of the runtime effects: (stepper, n) in
        order, n = 0 for an effect that steps alone. Runs of 2+ adjacent
        biquads at a block _fuse leaves to the per-sample path step as one
        BiquadRun of n of them (one launch a run, at most the kernel's stage
        limit; a longer run is cut), so the runtime effects, their names and
        states stay as _fuse left them."""
        from dsp_tpu_torch.effects.biquad import BiquadEffect, BiquadRun
        from dsp_tpu_torch.kernels import BIQUAD_RUN_MAX_STAGES
        from dsp_tpu_torch.ops.iir import BLOCKED_L

        steps, run = [], []

        def flush():
            for i in range(0, len(run), BIQUAD_RUN_MAX_STAGES):
                part = run[i:i + BIQUAD_RUN_MAX_STAGES]
                if len(part) >= 2:
                    steps.append((BiquadRun(part, self.device), len(part)))
                else:
                    steps.extend((e, 0) for e in part)
            run.clear()

        for e in effects:
            blk = self._block_at.get(id(e), 0)
            if type(e) is BiquadEffect and (blk % BLOCKED_L or blk < 2 * BLOCKED_L):
                run.append(e)
            else:
                flush()
                steps.append((e, 0))
        flush()
        return steps

    def _fuse(self, effects):
        """Execution-time fusion: collapse runs of 2+ adjacent biquads into
        one CascadeBlockedPlan (one K1 launch instead of K). Execution-only —
        the chain object, plot output, and merge semantics stay
        reference-identical (biquad.c merges only disjoint-channel biquads)."""
        from dsp_tpu_torch.effects.biquad import BiquadEffect, FusedBiquadCascade
        from dsp_tpu_torch.ops.iir import BLOCKED_L

        out = []
        run = []

        def flush():
            if len(run) >= 2:
                out.append(FusedBiquadCascade(list(run)))
            else:
                out.extend(run)
            run.clear()

        for e in effects:
            blk = self._block_at.get(id(e), 0)
            if type(e) is BiquadEffect and blk % BLOCKED_L == 0 and blk >= 2 * BLOCKED_L:
                run.append(e)
            else:
                flush()
                out.append(e)
        flush()
        return out

    def _initial_state(self, e):
        if hasattr(e, "state_for_block"):
            return self._to_device(e.state_for_block(self._block_at[id(e)]))
        return self._to_device(e.state0())

    def _to_device(self, tree):
        """numpy state (arrays in nested tuples, lists and dicts) -> tensors
        on the device. A leaf that is already a tensor stays where the
        effect put it: a counter the host reads every block lives on the
        CPU (fft_conv.NupolsConv's ``cnt``)."""
        if isinstance(tree, (tuple, list)):
            return type(tree)(self._to_device(t) for t in tree)
        if isinstance(tree, dict):
            return {k: self._to_device(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return tree
        a = np.asarray(tree)
        if a.dtype in (np.float64, np.float32):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)
        if a.dtype in (np.complex128, np.complex64):
            cdt = torch.complex64 if self.dtype == torch.float32 else torch.complex128
            return torch.as_tensor(a, dtype=cdt, device=self.device)
        return torch.as_tensor(a, device=self.device)

    def _input(self, x):
        """Host array or tensor -> contiguous tensor on the device, in dtype."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=self.device, dtype=self.dtype).contiguous()

    def reset(self):
        self.states = [self._initial_state(e) for e in self._runtime_effects]

    def _effect_names(self):
        return "|".join(e.name for e in self._runtime_effects)

    def save_state(self, path):
        """Checkpoint the live stream state to an .npz file.

        The format is dsp_tpu's (chain.py save_state): ``leaf_<i>`` arrays in
        depth-first order, ``__treedef__`` (the string jax prints for the
        state structure) and ``__effects__`` (the runtime effect names), so
        a checkpoint written by either package loads in the other.
        """
        from dsp_tpu_torch.convert import flatten_states, states_to_numpy

        _, treedef = flatten_states(self.states)
        arrays = {f"leaf_{i}": a for i, a in enumerate(states_to_numpy(self.states))}
        arrays["__treedef__"] = np.asarray(treedef)
        arrays["__effects__"] = np.asarray(self._effect_names())
        np.savez_compressed(path, **arrays)

    def load_state(self, path):
        """Restore a state checkpoint written by save_state (of either package).

        Validated: the state structure, every leaf's shape and dtype, and the
        runtime effect-name sequence. NOT validated (state arrays don't
        encode them): effect parameters — loading a checkpoint into a chain
        built from different arguments but with the same effect names and
        state shapes resumes silently with the new coefficients."""
        from dsp_tpu_torch.convert import flatten_states, states_from_numpy, unflatten_states

        with np.load(path) as z:
            if "__treedef__" not in z or "__effects__" not in z:
                raise ChainError(f"{path}: not a dsp_tpu state checkpoint")
            leaves, treedef = flatten_states(self.states)
            names = self._effect_names()
            if str(z["__effects__"]) != names:
                raise ChainError(
                    f"state checkpoint is for effects [{z['__effects__']}], "
                    f"this chain runs [{names}]"
                )
            if str(z["__treedef__"]) != treedef:
                if "'bank': {'a1': " in str(z["__treedef__"]):
                    raise ChainError(
                        "state checkpoint carries matrix4_mb's sequential filter-bank state "
                        "(per-cap 'a1', 'a2p', 'a2o', 'comp'); dsp_tpu_torch runs only the "
                        "fused bank ('bank': {'fused': ...}) and does not convert it"
                    )
                raise ChainError("state checkpoint does not match this chain's structure")
            new = []
            for i, cur in enumerate(leaves):
                key = f"leaf_{i}"
                if key not in z:
                    raise ChainError(f"{path}: truncated state checkpoint")
                a = z[key]
                cur_dtype = np.dtype(str(cur.dtype).removeprefix("torch."))
                if a.shape != tuple(cur.shape) or a.dtype != cur_dtype:
                    raise ChainError(
                        f"state leaf {i} mismatch: checkpoint "
                        f"{a.shape}/{a.dtype} vs chain {tuple(cur.shape)}/{cur_dtype}"
                    )
                new.append(a)
        # each leaf goes back to the device its current leaf lives on
        self.states = unflatten_states(
            self.states, states_from_numpy(new, [cur.device for cur in leaves])
        )

    def set_valid_frames(self, n_in_frames):
        """Tell measurement effects (stats) the true stream length in chain
        INPUT frames (absolute since the last reset), so zero padding added
        for fixed block shapes never enters their accumulators — the
        reference processes exact-length short blocks instead
        (effects_chain.c:1058-1081)."""
        for i, e in enumerate(self._runtime_effects):
            if hasattr(e, "set_valid_limit"):
                r = self._ratio_at.get(id(e), Fraction(1))
                self.states[i] = self._to_device(
                    e.set_valid_limit(self.states[i], int(n_in_frames * r))
                )

    def run_block(self, x):
        """x: [block_frames, in_ch] (numpy or tensor) -> [out_frames, out_ch]
        tensor on the device."""
        self.states, y = self._step(self.states, self._input(x))
        return y

    def run_blocks(self, xs):
        """xs: [n, block_frames, in_ch] -> [n, out_frames, out_ch] tensor on
        the device. One host->device copy; the blocks run back to back on
        the device's stream and nothing is copied back here."""
        xs = self._input(xs)
        ys = []
        for i in range(xs.shape[0]):
            self.states, y = self._step(self.states, xs[i])
            ys.append(y)
        return torch.stack(ys)

    def host_update(self):
        for e, st in zip(self._runtime_effects, self.states):
            e.host_update(st)

    def host_finish(self):
        for e, st in zip(self._runtime_effects, self.states):
            e.host_finish(st)

    def split_safe(self):
        """True when every effect tolerates zero-state lookback priming
        (Effect.split_safe), which process_array_split requires."""
        return all(getattr(e, "split_safe", True) for e in self.chain.effects)

    def split_lookback_frames(self):
        """Chain-input frames of lookback that re-establish steady state.

        Sums each effect's own-rate lookback (Effect.split_lookback)
        converted to chain-input frames: transients of a cascade convolve,
        so the sum bounds the cascade's settle time."""
        fs0 = self.chain.istream.fs
        total = 0.0
        for e in self.chain.effects:
            total += e.split_lookback() * fs0 / e.istream.fs
        return int(np.ceil(total))

    def _unsafe_names(self):
        return [e.name for e in self.chain.effects if not getattr(e, "split_safe", True)]

    def _stream_states(self, states, S, device=None):
        """states (one a runtime effect) copied to `device` (this chain's
        own by default) with a leading stream axis of S: each leaf copied
        for every stream, but an effect's host_leaves (NupolsConv's block
        counter ``cnt``, matrix4's ``fade_p`` and ``disable``), which stay on
        the host and keep one value for all streams: every stream of a split or a group sits at
        the same block index, and ``fade_p`` counts down by the block
        whatever the signal. Each call copies the host leaves, so each group
        of a batch holds its own, which its own steps advance once a block."""
        device = self.device if device is None else device
        return [_with_streams(_moved(st, device, host), S, host)
                for e, st in zip(self._runtime_effects, states)
                for host in (getattr(e, "host_leaves", ()),)]

    def _run_groups(self, groups):
        """groups: (compiled chain, stream-axis states, xs [S_g, n·B, C]
        host float64) a group -> each group's output [S_g, n·out_frames,
        out_ch] on its chain's device, stepping its streams a block at a
        time from its states (not kept). A group's input takes one
        host->device copy; its blocks are laid out block-major, and its
        outputs back stream-major, by one device copy each, not on the
        host. The groups step in turn, block by block, from this thread,
        each under its CUDA device (a launch goes to the thread's current
        device, whatever its tensors' device); nothing here synchronises,
        so the launches of groups on different cards overlap."""
        B = self.block_frames
        runs = []
        for cc, states, xs in groups:
            S = xs.shape[0]
            x = cc._input(xs).view(S, -1, B, xs.shape[-1]).transpose(0, 1).contiguous()
            runs.append([cc, states, x, []])
        for i in range(runs[0][2].shape[0]):
            for run in runs:
                cc, states, x, ys = run
                with _current_device(cc.device):
                    run[1], y = cc._step(states, x[i])
                ys.append(y)
        out = []
        for _, _, _, ys in runs:
            y = torch.stack(ys, dim=1)  # [S_g, n, out_frames, out_ch]
            out.append(y.view(y.shape[0], -1, y.shape[-1]))
        return out

    def process_batch(self, xs, devices=None, drain=True, discard=True):
        """Process S independent streams at once: xs [S, frames, in_ch] ->
        [S, out_frames, out_ch] numpy.

        Each stream starts from the live state (broadcast over the stream
        axis; the live state is neither consumed nor advanced), so stream s
        is process_array(xs[s]) on this chain as it stands: every stream
        draws its noise from the live key, and stats counts to the live
        limit. Every block of the S streams is one step, each kernel one
        launch for the S; as in dsp_tpu, whose batch steps _step_fn_raw and
        drops the states, no host hook runs (the meters' and upmixes' status
        lines, stats' table) and the streams' states are not kept.

        ``devices`` (devices or their names) is dsp_tpu's mesh route
        (process_batch(xs, mesh=...)) in one process: the S streams are cut
        into len(devices) contiguous groups, one a device, and S must be a
        multiple of len(devices) (ValueError, as dsp_tpu's sharding raises).
        Each group runs on its device's replica of this chain (_replica)
        from its own copy of the live states, the host leaves too; the
        groups step in turn, block by block (_run_groups), and each group's
        output comes back in one copy, into its rows of the result (one
        copy a device where each device holds one group). Every device is
        resolved by config.resolve_device, which raises for one that cannot
        be reached: nothing falls back. None is one group on this chain's
        own device."""
        xs = np.asarray(xs, dtype=np.float64)
        S, n_in, c_in = xs.shape
        pad = self.chain.drain_frames if drain else 0
        total = n_in + pad
        B = self.block_frames
        out_valid = expected_out_frames(self.chain, n_in, drain)
        b_out = int(B * self.chain.ratio)
        n_blocks = max(1, -(-total // B), -(-out_valid // b_out))
        first = self.chain.output_discard if discard else 0
        devices = [self.device] if devices is None else [config.resolve_device(d) for d in devices]
        if not devices or S % len(devices):
            raise ValueError(f"process_batch: {S} streams do not split evenly over "
                             f"{len(devices)} devices")
        flat = np.zeros((S, n_blocks * B, c_in), dtype=np.float64)
        flat[:, :n_in] = xs
        k = S // len(devices)
        groups = [(self._replica(d), self._stream_states(self.states, k, d), flat[g * k:(g + 1) * k])
                  for g, d in enumerate(devices)]
        ys = self._run_groups(groups)
        out = torch.empty((S, max(0, out_valid - first), ys[0].shape[-1]), dtype=torch.float64)
        for g, y in enumerate(ys):  # one copy to the host a group, into its rows
            out[g * k:(g + 1) * k].copy_(y[:, first:out_valid])
        return out.numpy()

    def process_array_split(self, x, splits=8, lookback=None, drain=True, discard=True):
        """Process ONE long [frames, in_ch] array as `splits` lookback-primed
        segments over the stream axis: one host step serves S segments, and
        each kernel of it runs the S in one launch. The reference's offline
        path is strictly sequential (dsp.c); this is dsp_tpu's route
        (dsp_tpu/chain/chain.py process_array_split), with the same segment
        layout.

        Segment 0 runs from the true zero state and is exact. Each later
        segment starts from zero state primed with `lookback` frames of the
        preceding input (default: split_lookback_frames()), and its primed
        output is discarded; the residual error is the chain's impulse-
        response tail past the lookback. Raises ChainError when the chain
        holds split-unsafe effects. Uses fresh states: the live stream state
        is neither read nor advanced. One host->device copy of the S
        segments of wb + seg_nb blocks and one copy back."""
        if not self.split_safe():
            raise ChainError(f"chain is not split-safe (effects: {', '.join(self._unsafe_names())})")
        x = np.asarray(x, dtype=np.float64)
        n_in = len(x)
        pad = self.chain.drain_frames if drain else 0
        total = n_in + pad
        B = self.block_frames
        out_valid = expected_out_frames(self.chain, n_in, drain)
        b_out = int(B * self.chain.ratio)
        nb = max(1, -(-total // B), -(-out_valid // b_out))
        if lookback is None:
            lookback = self.split_lookback_frames()
        wb = -(-int(lookback) // B)
        seg_nb = max(1, -(-nb // int(splits)))
        S = -(-nb // seg_nb)
        # segment k: the wb look-back blocks before it (zeros before the
        # input's start) and its seg_nb blocks (zeros past the input's end)
        segs = np.zeros((S, (wb + seg_nb) * B, x.shape[1]), dtype=np.float64)
        for k in range(S):
            s0 = k * seg_nb * B
            w0 = max(0, s0 - wb * B)
            seg = x[w0 : min(n_in, s0 + seg_nb * B)]
            off = wb * B - (s0 - w0)
            segs[k, off : off + len(seg)] = seg
        states = self._stream_states([self._initial_state(e) for e in self._runtime_effects], S)
        y = self._run_groups([(self, states, segs)])[0][:, wb * b_out :]  # [S, seg_nb·b_out, ch]
        y = y.reshape(-1, y.shape[-1])[self.chain.output_discard if discard else 0 : out_valid]
        return y.to("cpu", torch.float64).numpy()

    def process_array(self, x, drain=True, discard=True):
        """Process a whole [frames, in_ch] array; returns [out, out_ch] numpy.

        Appends chain.drain_frames of silence when drain=True and slices the
        chain's output_discard when discard=True, so the result matches the
        reference's file-to-file output.
        """
        x = np.asarray(x, dtype=np.float64)
        n_in = len(x)
        pad = self.chain.drain_frames if drain else 0
        total = n_in + pad
        self.set_valid_frames(total)
        B = self.block_frames
        out_valid = expected_out_frames(self.chain, n_in, drain)
        b_out = int(B * self.chain.ratio)
        n_blocks = max(1, -(-total // B), -(-out_valid // b_out))
        xp = np.zeros((n_blocks * B, x.shape[1]), dtype=np.float64)
        xp[:n_in] = x
        ys = self.run_blocks(xp.reshape(n_blocks, B, x.shape[1]))
        y = ys.reshape(-1, ys.shape[-1]).to("cpu", torch.float64).numpy()
        y = y[:out_valid]
        if discard and self.chain.output_discard:
            y = y[self.chain.output_discard :]
        return y


def _device_key(device):
    """A device with its index: CUDA's current device for ``cuda``."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _current_device(device):
    """A context in which `device`, if CUDA, is the thread's current device."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _moved(tree, device, host):
    """A state tree on `device`, but the dict leaves named in host, each a
    copy on the host."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_moved(t, device, host) for t in tree)
    if isinstance(tree, dict):
        return {k: v.clone() if k in host else _moved(v, device, host) for k, v in tree.items()}
    return tree.to(device)


def _with_streams(tree, S, host):
    """A state tree with a leading stream axis of S on every leaf but the
    dict leaves named in host."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_with_streams(t, S, host) for t in tree)
    if isinstance(tree, dict):
        return {k: v if k in host else _with_streams(v, S, host) for k, v in tree.items()}
    return tree.unsqueeze(0).expand(S, *tree.shape).contiguous()


def chain_needs_dither(chain):
    """True if any effect modifies the signal such that dither is useful
    (effects_chain.c:1022-1030)."""
    from dsp_tpu_torch.effects.base import EFFECT_FLAG_NO_DITHER

    for e in chain.effects:
        if not (e.flags & EFFECT_FLAG_NO_DITHER) and not getattr(e, "is_dither", False):
            return True
    return False


def chain_set_dither_params(chain, prec, enabled):
    """Propagate auto-dither params; returns True if app-level dither should
    be added (effects_chain.c:1032-1043)."""
    from dsp_tpu_torch.effects.base import EFFECT_FLAG_NO_DITHER

    r = True
    for e in chain.effects:
        if getattr(e, "is_dither", False):
            e.set_auto_params(prec, enabled)
            r = False
        elif not (e.flags & EFFECT_FLAG_NO_DITHER):
            r = True
    return r and enabled


