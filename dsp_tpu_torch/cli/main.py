"""dsp-torch CLI (reference: dsp.c), the offline path of dsp_tpu's CLI.

Synopsis: ``dsp-torch [options] path ... [effect [args]] ...``

The same option/input parsing, dither policy, clip accounting, plot mode
and concatenate-mode processing loop as ``dsp``, running the chain on the
device that ``DSP_TPU_TORCH_DEVICE`` names (default ``cuda``; it raises when
CUDA is asked for and absent; plot mode touches no device). Interactive,
ABX, sequence and watch modes are not ported yet and exit with an error
saying so.
"""

import os
import sys
from fractions import Fraction

import numpy as np
import torch

from dsp_tpu_torch import config
from dsp_tpu_torch.chain import ChainError, CompiledChain, build_chain_from_args
from dsp_tpu_torch.chain.chain import chain_needs_dither, chain_set_dither_params
from dsp_tpu_torch.chain.parser import ChainParseError
from dsp_tpu_torch.chain.plot import PlotError, plot_chain
from dsp_tpu_torch.codecs import (
    CODEC_HINT_CAN_DITHER,
    CODEC_MODE_READ,
    CODEC_MODE_WRITE,
    CODEC_ENDIAN_BIG,
    CODEC_ENDIAN_LITTLE,
    CODEC_ENDIAN_NATIVE,
    CodecError,
    CodecParams,
    init_codec,
)
from dsp_tpu_torch.core import log
from dsp_tpu_torch.core.parse import ParseError, parse_freq, parse_timespec, strtol
from dsp_tpu_torch.core.prng import TpdfNoise, tpdf_dither_get_mult
from dsp_tpu_torch.core.types import StreamInfo
from dsp_tpu_torch.effects.base import get_effect_info
from dsp_tpu_torch.chain.lexer import token_id, TOK_LITERAL

HELP_TEXT = """\
Usage: dsp-torch [options] path ... [effect [args]] ...

Global options:
  -h         show this help
  -b frames  block size (must be given before the first input)
  -i         force interactive mode
  -I         disable interactive mode
  -q         disable progress display
  -s         silent mode
  -v         verbose mode
  -d         force dithering
  -D         disable dithering
  -E         don't drain effects chain before rebuilding
  -p         plot effects chain magnitude response instead of processing audio
  -P         same as '-p', but also plot phase response
  -V         verbose progress display
  -S         use "sequence" input combining mode
  -X[n]      run in ABX comparator mode

Input/output options:
  -o               output
  -t type          type
  -e encoding      encoding
  -B/L/N           big/little/native endian
  -r frequency[k]  sample rate
  -c channels      number of channels
  -R ratio         buffer ratio
  -T time_range    set start and end positions (input only)
  -l[n]            repeat n times or indefinitely (input only)
  -n               equivalent to '-t null null'
"""

ABX_TRIALS_DEFAULT = 10


class _Input:
    def __init__(self, codec, start_pos=0, end_pos=-1, repeats=0):
        self.codec = codec
        self.start_pos = start_pos
        self.end_pos = end_pos  # -1 = unspecified
        self.repeats = repeats  # -1 = infinite


def _is_chain_start(word):
    if token_id(word) != TOK_LITERAL:
        return True
    return get_effect_info(word) is not None


_GLOBAL_FLAGS = "hbiIqsvdDEpPVSX"
_IO_OPTSTRING = {
    "b": 1, "t": 1, "e": 1, "r": 1, "c": 1, "R": 1, "T": 1,
    "X": 2, "l": 2,
}


class CliState:
    def __init__(self):
        self.block_frames = config.DEFAULT_BLOCK_FRAMES
        self.interactive = None
        self.show_progress = True
        self.verbose_progress = False
        self.force_dither = 0
        self.drain_effects = True
        self.plot = 0
        self.input_mode = "concat"  # concat | sequence | abx
        self.n_trials = ABX_TRIALS_DEFAULT
        self.inputs = []
        self.out_params = None
        self.peak = 0.0
        self.clip_count = 0
        self.input_buf_ratio = config.DEFAULT_INPUT_BUF_RATIO
        self.output_buf_ratio = config.DEFAULT_OUTPUT_BUF_RATIO


def _parse_codec_params(state, argv, ind):
    """Parse one input's/output's options; returns (params, timespan, repeats, ind)."""
    p = CodecParams(path="", fs=0, channels=0, mode=CODEC_MODE_READ, buf_ratio=0)
    timespan = None
    repeats = 0
    while ind < len(argv):
        a = argv[ind]
        if len(a) < 2 or a[0] != "-":
            break
        sp = 1
        while sp < len(a):
            c = a[sp]
            arg = None

            def need_arg():
                nonlocal sp, ind
                if sp + 1 < len(a):
                    v = a[sp + 1 :]
                    sp = len(a)
                else:
                    ind += 1
                    if ind >= len(argv):
                        raise CliError(f"expected argument to option '{c}'")
                    v = argv[ind]
                return v

            def opt_arg():
                nonlocal sp
                v = a[sp + 1 :] if sp + 1 < len(a) else None
                sp = len(a)
                return v

            if c == "h":
                sys.stdout.write(HELP_TEXT)
                sys.stdout.write("\n")
                from dsp_tpu_torch.codecs import print_all_codecs

                print_all_codecs(sys.stdout)
                sys.stdout.write("\nEffects:\n")
                from dsp_tpu_torch.effects import print_all_effects

                print_all_effects(sys.stdout)
                raise SystemExit(0)
            elif c == "b":
                arg = need_arg()
                if not state.inputs:
                    v, rest = strtol(arg)
                    if rest or v <= 1:
                        raise CliError("block size must be > 1")
                    state.block_frames = v
                else:
                    log.error("warning: block size must be specified before the first input")
            elif c == "i":
                state.interactive = True
            elif c == "I":
                state.interactive = False
            elif c == "q":
                state.show_progress = False
            elif c == "s":
                log.set_loglevel(log.LL_SILENT)
            elif c == "v":
                log.set_loglevel(log.LL_VERBOSE)
            elif c == "d":
                state.force_dither = 1
            elif c == "D":
                state.force_dither = -1
            elif c == "E":
                state.drain_effects = False
            elif c == "p":
                state.plot = 1
            elif c == "P":
                state.plot = 2
            elif c == "V":
                state.verbose_progress = True
            elif c == "S":
                state.input_mode = "sequence"
            elif c == "X":
                state.input_mode = "abx"
                arg = opt_arg()
                if arg is not None:
                    v, rest = strtol(arg)
                    if rest or v < 2:
                        raise CliError("minimum number of trials is 2")
                    state.n_trials = v
            elif c == "o":
                p.mode = CODEC_MODE_WRITE
            elif c == "t":
                p.type = need_arg()
            elif c == "e":
                p.enc = need_arg()
            elif c == "B":
                p.endian = CODEC_ENDIAN_BIG
            elif c == "L":
                p.endian = CODEC_ENDIAN_LITTLE
            elif c == "N":
                p.endian = CODEC_ENDIAN_NATIVE
            elif c == "r":
                arg = need_arg()
                try:
                    fs = int(round(parse_freq(arg)))
                except ParseError:
                    raise CliError(f"failed to parse sample rate: {arg}")
                if fs <= 0:
                    raise CliError("sample rate must be > 0")
                p.fs = fs
            elif c == "c":
                arg = need_arg()
                v, rest = strtol(arg)
                if rest or v <= 0:
                    raise CliError("number of channels must be > 0")
                p.channels = v
            elif c == "R":
                arg = need_arg()
                v, rest = strtol(arg)
                if rest or v <= 0:
                    raise CliError("buffer ratio must be > 0")
                p.buf_ratio = v
            elif c == "n":
                p.path = "null"
                p.type = "null"
                return p, timespan, repeats, ind + 1
            elif c == "T":
                timespan = need_arg()
            elif c == "l":
                arg = opt_arg()
                if arg is not None:
                    v, rest = strtol(arg)
                    if rest:
                        raise CliError(f"failed to parse number of repeats: {arg}")
                    repeats = v
                else:
                    repeats = -1
            else:
                raise CliError(f"unrecognized option '{c}'")
            sp += 1
        ind += 1
    if p.buf_ratio == 0:
        p.buf_ratio = state.output_buf_ratio if p.mode == CODEC_MODE_WRITE else state.input_buf_ratio
    else:
        if p.mode == CODEC_MODE_WRITE:
            state.output_buf_ratio = p.buf_ratio
        else:
            state.input_buf_ratio = p.buf_ratio
    p.block_frames = state.block_frames
    if ind < len(argv):
        p.path = argv[ind]
        ind += 1
    else:
        raise CliError("expected path")
    return p, timespan, repeats, ind


class CliError(Exception):
    pass


def _open_input(state, p, timespan, repeats):
    if p.fs == 0:
        p.fs = (
            config.DEFAULT_FS
            if (not state.inputs or state.input_mode == "sequence")
            else state.inputs[0].codec.fs
        )
    if p.channels == 0:
        p.channels = (
            config.DEFAULT_CHANNELS
            if (not state.inputs or state.input_mode == "sequence")
            else state.inputs[0].codec.channels
        )
    c = init_codec(p)
    _print_io_info(c, "input")
    start_pos, end_pos = 0, -1
    if timespan:
        start_pos, rest = parse_timespec(timespan, c.fs)
        end_is_rel = rest.startswith("+")
        if rest and (end_is_rel or rest.startswith("-")):
            end_pos, rest2 = parse_timespec(rest[1:], c.fs)
            if rest2:
                raise CliError(f"failed to parse end timespec: {timespan}")
            if end_pos < 0:
                if end_is_rel:
                    raise CliError(
                        f"{c.path}: end timespec must be positive when relative to start timespec"
                    )
                end_pos = max(c.frames + end_pos, 0)
        elif rest:
            raise CliError(f"failed to parse start timespec: {timespan}")
        if start_pos < 0:
            start_pos = max(c.frames + start_pos, 0)
        if start_pos > 0:
            got = c.seek(start_pos)
            if got < 0:
                raise CliError(f"seek failed: {c.path}")
            start_pos = got
        if end_pos >= 0:
            end_pos = start_pos + end_pos if end_is_rel else end_pos
            if end_pos < start_pos:
                log.error("warning: %s: end timespec precedes start timespec", c.path)
    state.inputs.append(_Input(c, start_pos, end_pos, repeats))


def _print_io_info(c, n):
    frames = c.frames
    if frames is not None and frames >= 0:
        secs = frames / c.fs
        t = f"{int(secs // 3600):02d}:{int(secs // 60) % 60:02d}:{secs % 60:05.2f}"
    else:
        t = "00:00:00.00"
    log.info(
        "%s: %s; type=%s enc=%s precision=%d channels=%d fs=%d frames=%d [%s]",
        n, c.path, c.type, c.enc, c.prec, c.channels, c.fs,
        frames if frames is not None else -1, t,
    )


def should_dither(in_codec, out_codec, needs, force_dither):
    """SHOULD_DITHER policy (dsp.c:46-48)."""
    if force_dither == -1:
        return False
    if not (out_codec.hints & CODEC_HINT_CAN_DITHER):
        return False
    if force_dither == 1:
        return True
    return out_codec.prec < 24 and (
        needs or in_codec.prec > out_codec.prec or not (in_codec.hints & CODEC_HINT_CAN_DITHER)
    )


class OutputWriter:
    """Clip accounting + optional app-level TPDF dither (dsp.c:673-700)."""

    def __init__(self, state, out_codec):
        self.state = state
        self.codec = out_codec
        self.add_dither = False
        self.dither_mult = tpdf_dither_get_mult(out_codec.prec)
        self._noise = TpdfNoise(seed1=np.random.randint(1, 1 << 30), seed2=np.random.randint(1, 1 << 30))

    def write(self, buf):
        buf = np.asarray(buf, dtype=np.float64)
        if self.add_dither and self.dither_mult:
            buf = buf + self._noise.block(buf.size, self.dither_mult).reshape(buf.shape)
        a = np.abs(buf)
        m = a.max(initial=0.0)
        self.state.peak = max(self.state.peak, float(m))
        if m > 1.0:
            self.state.clip_count += int(np.count_nonzero(a > 1.0))
            buf = np.clip(buf, -1.0, 1.0)
        self.codec.write(buf)


def _input_chunks(state, want_frames):
    """Yield raw input buffers across all inputs, honoring -T ranges and -l
    repeats (concatenate mode, dsp.c's read loop)."""
    for inp in state.inputs:
        c = inp.codec
        pos = inp.start_pos
        repeats = inp.repeats
        while True:
            want = want_frames
            if inp.end_pos >= 0:
                want = min(want, inp.end_pos - pos)
            buf = c.read(want) if want > 0 else np.zeros((0, c.channels))
            if len(buf) == 0:
                if repeats != 0:
                    if repeats > 0:
                        repeats -= 1
                    if c.seek(inp.start_pos) >= 0:
                        pos = inp.start_pos
                        continue
                break
            pos += len(buf)
            yield buf
            if inp.end_pos >= 0 and pos >= inp.end_pos:
                if repeats != 0:
                    if repeats > 0:
                        repeats -= 1
                    if c.seek(inp.start_pos) >= 0:
                        pos = inp.start_pos
                        continue
                break


def run_offline_split(state, chain, out_writer, device=None, dtype=None):
    """Split offline path (``DSP_TPU_SPLIT=<segments>``), dsp_tpu's
    (dsp_tpu/cli/main.py run_offline_split): read the whole input, cut it
    into lookback-primed segments, and run them over the stream axis
    (CompiledChain.process_array_split), so one host step serves every
    segment and each kernel runs them all in one launch. Opt-in through the
    environment: it holds the whole stream in host memory and trades the
    segment-boundary accuracy contract (tests/test_torch_split.py) for
    throughput.

    Returns frames written, or None to fall back to the streaming loop;
    the fallback is decided before any input is read."""
    try:
        splits = int(os.environ.get("DSP_TPU_SPLIT", "0"))
    except ValueError:
        log.warn("warning: DSP_TPU_SPLIT is not an integer; ignoring")
        return None
    if splits < 2:
        return None
    cc = CompiledChain(chain, block_frames=state.block_frames, dtype=dtype, device=device)
    if not cc.split_safe():
        log.verbose("DSP_TPU_SPLIT: chain is not split-safe; streaming instead")
        return None
    bufs = list(_input_chunks(state, 1 << 20))
    x = np.concatenate(bufs, axis=0) if bufs else np.zeros((0, chain.istream.channels))
    drain = bool(state.drain_effects)
    # each segment must dwarf its lookback re-compute or splitting loses
    if len(x) < splits * 4 * cc.split_lookback_frames():
        log.verbose("DSP_TPU_SPLIT: input too short to amortize lookback; running sequentially")
        y = cc.process_array(x, drain=drain, discard=True)
    else:
        y = cc.process_array_split(x, splits=splits, drain=drain, discard=True)
    out_writer.write(y)
    cc.host_finish()
    return len(y)


def run_offline(state, chain, out_writer, progress_cb=None, device=None, dtype=None):
    """Concatenate-mode batch processing: read -> chain -> write.

    The host buffers stay float64, as dsp_tpu's do; a float32 chain casts
    each chunk once, on its device copy, and its output comes back to the
    codecs as float64.

    Input is pushed in chunks of ``meta_blocks`` blocks (about 1M samples):
    each chunk is one host->device copy, a loop of chain steps on the
    device, and one device->host copy. The last chunk is padded with zeros
    to whole blocks, and their output is trimmed. Returns frames written."""
    cc = CompiledChain(chain, block_frames=state.block_frames, dtype=dtype, device=device)
    B = cc.block_frames
    meta_blocks = max(1, (1 << 20) // max(1, B * chain.istream.channels))  # ~1M samples / chunk
    CH = meta_blocks * B
    CHr = int(Fraction(CH) * chain.ratio)  # integral: CH is a B-multiple
    carry = np.zeros((0, chain.istream.channels), dtype=np.float64)
    discard_left = chain.output_discard
    written = 0
    raw_out = 0  # pre-discard output frames emitted (post-trim)
    target_out = 0  # set before the final push

    def run_chunk(xs, trim):
        nonlocal discard_left, written
        ys = cc.run_blocks(xs)
        y = ys.reshape(-1, ys.shape[-1]).to("cpu", torch.float64).numpy()
        if trim:
            # trim output from the zero padding added to complete the chunk
            y = y[: len(y) - trim] if trim <= len(y) else y[:0]
        if discard_left:
            d = min(discard_left, len(y))
            y = y[d:]
            discard_left -= d
        out_writer.write(y)
        cc.host_update()
        written += len(y)

    def push(chunk, final=False):
        nonlocal carry, raw_out
        if chunk is not None and len(chunk):
            carry = np.concatenate([carry, chunk], axis=0) if len(carry) else chunk
        while len(carry) >= CH:
            xs = carry[:CH].reshape(meta_blocks, B, carry.shape[1])
            carry = carry[CH:]
            run_chunk(xs, 0)
            raw_out += CHr
        if final:
            # emit the rest in zero-padded blocks until the exact pre-discard
            # output target is reached, trimming the last — the reference's
            # drain accounting rounds pending input UP at each rate change
            # (ratio_mult_ceil, resample.c:175; see chain.drain_out_frames)
            while len(carry) or raw_out < target_out:
                n = min(len(carry), CH)
                nb = max(1, -(-n // B), -(-(target_out - raw_out) // cc.out_frames))
                nb = min(nb, meta_blocks)
                xs = np.zeros((nb * B, carry.shape[1]), dtype=np.float64)
                xs[:n] = carry[:n]
                carry = carry[n:]
                trim = max(0, raw_out + nb * cc.out_frames - target_out)
                run_chunk(xs.reshape(nb, B, carry.shape[1]), trim)
                raw_out += nb * cc.out_frames - trim

    total_in = 0
    for buf in _input_chunks(state, CH):
        total_in += len(buf)
        push(buf)
        if progress_cb:
            progress_cb(total_in, written)
    # drain (feed chain.drain_frames of silence; effects_chain.c:1186-1218)
    # the true stream length (input + drain) is known now: stop measurement
    # effects (stats) there so final-block zero padding never enters them
    pre_pad = total_in + (chain.drain_frames if state.drain_effects else 0)
    cc.set_valid_frames(pre_pad)
    rr = chain.ratio
    target_out = -(-total_in * rr.numerator // rr.denominator)
    if state.drain_effects:
        target_out += chain.drain_out_frames
    if state.drain_effects and chain.drain_frames > 0:
        drain_in = np.zeros((chain.drain_frames, chain.istream.channels), dtype=np.float64)
        push(drain_in, final=True)
    else:
        push(None, final=True)
    cc.host_finish()
    return written


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    state = CliState()
    log.set_prog_name("dsp-torch")
    ind = 0
    try:
        while ind < len(argv) and not _is_chain_start(argv[ind]):
            p, timespan, repeats, ind = _parse_codec_params(state, argv, ind)
            if p.mode == CODEC_MODE_WRITE:
                if timespan:
                    log.error("warning: ignoring '-T' option for output: %s", p.path)
                if repeats:
                    log.error("warning: ignoring '-l' option for output: %s", p.path)
                state.out_params = p
            else:
                _open_input(state, p, timespan, repeats)
    except (CliError, CodecError, ParseError) as e:
        log.error("dsp: error: %s", e)
        return 1

    if state.input_mode != "sequence":
        for inp in state.inputs[1:]:
            if inp.codec.fs != state.inputs[0].codec.fs:
                log.error("error: all inputs must have the same sample rate")
                return 1
            if inp.codec.channels != state.inputs[0].codec.channels:
                log.error("error: all inputs must have the same number of channels")
                return 1

    if not state.inputs:
        log.error("error: no inputs")
        return 1

    chain_args = argv[ind:]
    stream = StreamInfo(state.inputs[0].codec.fs, state.inputs[0].codec.channels)

    try:
        chain = build_chain_from_args(chain_args, stream)
    except (ChainParseError, ChainError) as e:
        log.error("%s", str(e))
        return 1

    if state.plot:  # no audio and no device: runs with or without CUDA
        try:
            sys.stdout.write(plot_chain(chain, state.plot > 1))
        except PlotError as e:
            log.error("%s", e)
            return 1
        return 0

    not_ported = None
    if state.input_mode != "concat":
        not_ported = f"{state.input_mode} mode"
    elif state.interactive:
        not_ported = "interactive mode (-i)"
    if not_ported:
        log.error("error: %s is not yet ported to dsp_tpu_torch", not_ported)
        return 1
    try:
        device = config.resolve_device()
        dtype = config.resolve_dtype()
    except (RuntimeError, ValueError) as e:
        log.error("error: %s", e)
        return 1

    # open output
    p = state.out_params or CodecParams(
        path="null", type="null", mode=CODEC_MODE_WRITE, buf_ratio=state.output_buf_ratio
    )
    p.mode = CODEC_MODE_WRITE
    if not p.path:
        p.path = "default"
    if p.fs == 0:
        p.fs = chain.ostream.fs
    if p.channels == 0:
        p.channels = chain.ostream.channels
    p.block_frames = state.block_frames
    try:
        out_codec = init_codec(p)
    except CodecError as e:
        log.error("error: failed to open output: %s", e)
        return 1
    _print_io_info(out_codec, "output")
    if out_codec.fs != chain.ostream.fs:
        log.error("error: sample rate mismatch: %s", out_codec.path)
        return 1
    if out_codec.channels != chain.ostream.channels:
        log.error("error: channels mismatch: %s", out_codec.path)
        return 1

    from dsp_tpu_torch.cli.writebuf import AsyncWriter

    writer = AsyncWriter(OutputWriter(state, out_codec), max_blocks=state.output_buf_ratio)
    in_codec = state.inputs[0].codec
    needs = chain_needs_dither(chain)
    do_dither = should_dither(in_codec, out_codec, needs, state.force_dither)
    writer.add_dither = chain_set_dither_params(chain, out_codec.prec, do_dither)
    log.verbose(
        "info: auto dither %s%s",
        "on" if do_dither else "off",
        " (effect)" if do_dither and not writer.add_dither else "",
    )

    ret = 0
    try:
        cb = _offline_progress(state)
        done = None
        if os.environ.get("DSP_TPU_SPLIT"):
            done = run_offline_split(state, chain, writer, device=device, dtype=dtype)
        if done is None:
            run_offline(state, chain, writer, progress_cb=cb, device=device, dtype=dtype)
        if cb is not None:
            sys.stderr.write("\r\033[K")
            sys.stderr.flush()
    except KeyboardInterrupt:
        log.info("interrupted")
    finally:
        for inp in state.inputs:
            inp.codec.close()
        try:
            writer.close()  # flush the writer thread before the sink closes
        except Exception as e:
            log.error("error: output: %s", e)
            ret = 1
        writer.codec.close()
    if state.clip_count > 0:
        log.info(
            "warning: clipped %d samples (%.2fdBFS peak)",
            state.clip_count,
            20 * np.log10(state.peak) if state.peak > 0 else -np.inf,
        )
    return ret


def _offline_progress(state):
    """Throttled progress line for offline runs (dsp.c:612-659), unless -q
    or stderr is not a terminal."""
    if not state.show_progress or not sys.stderr.isatty():
        return None
    import time as _time

    from dsp_tpu_torch.core.parse import format_dur

    total = 0
    known = True
    for inp in state.inputs:
        if inp.end_pos >= 0:
            span = inp.end_pos - inp.start_pos
        elif inp.codec.frames and inp.codec.frames > 0:
            span = inp.codec.frames - inp.start_pos
        else:
            span = None
        if span is None or inp.repeats != 0:
            known = False
            break
        total += span
    fs = state.inputs[0].codec.fs if state.inputs else 44100
    last = [0.0]

    def cb(frames_in, written):
        now = _time.monotonic()
        if now - last[0] < 0.1:  # 10 Hz throttle like the reference
            return
        last[0] = now
        cur = format_dur(frames_in / fs)
        if known and total > 0:
            pct = 100.0 * frames_in / total
            rem = format_dur(max(total - frames_in, 0) / fs)
            line = f"> {cur} [{pct:5.1f}%] of {format_dur(total / fs)} -{rem}"
        else:
            line = f"> {cur}"
        sys.stderr.write(f"\r\033[K{line}")
        sys.stderr.flush()

    return cb


if __name__ == "__main__":
    sys.exit(main())
