"""Effects-chain parser (reference: effects_chain.c:445-603).

Recursive descent over the token stream, tracking:

  * stream_info mutation after every effect init
  * the active channel *mask* (block property) and *selector* (``:sel``,
    indices into the mask's set bits, block scope)
  * mask/selector re-derivation when an effect changes the channel count:
    grown masks append the new channels; shrunk masks keep the lowest set
    bits; the last ``:sel`` token is re-parsed against the new mask
    (effects_chain.c:459-511)
  * ``{ ... }`` blocks (child mask = parent's current selector), ``@file``
    sourcing (implicit block, paths relative to the file), ``!`` allow-fail
"""

import os

import numpy as np

from dsp_tpu_torch.core import log
from dsp_tpu_torch.core.parse import ParseError, construct_full_path, num_bits_set, parse_selector_masked
from dsp_tpu_torch.effects.base import EffectError, get_effect_info
from dsp_tpu_torch.chain.lexer import (
    TOK_ALLOW_FAIL,
    TOK_BLOCK_END,
    TOK_BLOCK_START,
    TOK_CH_SEL,
    TOK_LITERAL,
    TOK_SOURCE,
    LexError,
    is_keyword_token,
    lex_string,
)

MAX_RDEPTH = 512
EOF_MARKER = "#EOF#"


class ChainParseError(ValueError):
    pass


class _ParserState:
    def __init__(self, chain, stream, path, dir_, line_strs, ch_mask):
        self.chain = chain
        self.stream = stream  # mutable [StreamInfo] single-element list
        self.path = path
        self.dir = dir_
        self.line_strs = line_strs
        n = stream[0].channels
        self.ch_mask = (
            np.asarray(ch_mask, dtype=bool).copy() if ch_mask is not None else np.ones(n, dtype=bool)
        )
        self.ch_sel = self.ch_mask.copy()
        self.last_ch_sel = None
        self.allow_fail = False
        self.last_stream_ch = n


def _err_location(state, tok, msg):
    loc = ""
    if state.path:
        loc = f"{state.path}: line {tok.line + 1}: "
    src = state.line_strs[tok.line] if tok.line < len(state.line_strs) else ""
    caret = " " * tok.col + "^" + "~" * max(0, tok.len - 1)
    return f"{loc}{msg}\n  | {src}\n  | {caret}"


def _parse(state, toks, pos, nested, rdepth):
    """Parse tokens from pos; returns position after a block end (or len)."""
    if rdepth > MAX_RDEPTH:
        raise ChainParseError("maximum recursion depth exceeded")
    while pos < len(toks):
        tok = toks[pos]
        if nested and tok.id == TOK_BLOCK_END:
            return pos
        if tok.id == TOK_ALLOW_FAIL:
            state.allow_fail = True
            pos += 1
            continue
        # reconstruct channel mask if an effect changed the channel count
        cur_ch = state.stream[0].channels
        if state.last_stream_ch != cur_ch:
            delta = cur_ch - state.last_stream_ch
            if delta > 0:
                new_mask = np.ones(cur_ch, dtype=bool)
                new_mask[: state.last_stream_ch] = state.ch_mask
            else:
                new_mask = np.zeros(cur_ch, dtype=bool)
                nb = num_bits_set(state.ch_mask) + delta
                cnt = 0
                for j in range(cur_ch):
                    if cnt >= nb:
                        break
                    if j < len(state.ch_mask) and state.ch_mask[j]:
                        new_mask[j] = True
                        cnt += 1
            state.ch_mask = new_mask
        if tok.id == TOK_CH_SEL:
            state.last_stream_ch = cur_ch
            try:
                state.ch_sel = parse_selector_masked(tok.str, state.ch_mask)
            except ParseError as e:
                raise ChainParseError(_err_location(state, tok, f"error: {e}"))
            state.last_ch_sel = tok
            pos += 1
            continue
        if state.last_stream_ch != cur_ch:
            # re-parse the active selector against the new mask
            if state.last_ch_sel is None:
                state.ch_sel = state.ch_mask.copy()
            else:
                try:
                    state.ch_sel = parse_selector_masked(state.last_ch_sel.str, state.ch_mask)
                except ParseError as e:
                    raise ChainParseError(
                        _err_location(state, state.last_ch_sel, f"error: {e} (after channel count change)")
                    )
            state.last_stream_ch = cur_ch
        if tok.id == TOK_SOURCE:
            parse_file_into(
                state.chain, tok.str, state.dir, state.stream, state.ch_sel, False, rdepth + 1
            )
            pos += 1
            continue
        if tok.id == TOK_BLOCK_START:
            child = _ParserState(
                state.chain, state.stream, state.path, state.dir, state.line_strs, state.ch_sel
            )
            child.last_stream_ch = state.last_stream_ch
            end = _parse(child, toks, pos + 1, True, rdepth + 1)
            if end >= len(toks):
                raise ChainParseError(_err_location(state, tok, "error: unterminated block"))
            pos = end + 1
            continue
        if tok.id not in (TOK_LITERAL,):
            raise ChainParseError(_err_location(state, tok, "error: unexpected token"))

        ei = get_effect_info(tok.str)
        # collect argument tokens until next keyword
        argv_end = pos
        while argv_end + 1 < len(toks) and not is_keyword_token(toks[argv_end + 1], get_effect_info):
            argv_end += 1
        if ei is None:
            msg = f"error: no such effect: {tok.str}"
            if state.allow_fail:
                log.warn("warning: no such effect: %s", tok.str)
            else:
                raise ChainParseError(_err_location(state, tok, msg))
        else:
            argv = [toks[i].str for i in range(pos, argv_end + 1)]
            if log.loglevel(log.LL_VERBOSE):
                from dsp_tpu_torch.core.parse import selector_to_string

                log.verbose(
                    "effect: %s; channels=%d [%s] fs=%d",
                    " ".join(argv),
                    state.stream[0].channels,
                    selector_to_string(state.ch_sel),
                    state.stream[0].fs,
                )
            try:
                e = ei.init(ei, state.stream[0], state.ch_sel, state.dir, argv)
            except EffectError as err:
                if state.allow_fail:
                    log.warn("warning: failed to initialize effect: %s", err)
                    e = None
                else:
                    raise ChainParseError(_err_location(state, tok, f"error: {err}"))
            if e is not None:
                effects = e if isinstance(e, list) else [e]
                for sub in effects:
                    if getattr(sub, "unused", False):
                        # run==NULL sub-effect: dropped (effects_chain.c:586-590)
                        log.verbose("info: not using effect: %s", sub.name)
                        continue
                    state.chain.effects.append(sub)
                    state.stream[0] = sub.ostream
        state.allow_fail = False
        pos = argv_end + 1
    # a nested parse that exhausts the tokens RETURNS len(toks): the parent
    # emits the located caret error at its '{' (effects_chain.c:518-521)
    return pos


def parse_string_into(chain, s, path, dir_, stream, ch_mask, rdepth=0):
    try:
        toks, line_strs = lex_string(s)
    except LexError as e:
        raise ChainParseError(f"{path or '<string>'}: line {e.line + 1}: error: {e}")
    state = _ParserState(chain, stream, path, dir_, line_strs, ch_mask)
    _parse(state, toks, 0, False, rdepth + 1)


def parse_file_into(chain, path, dir_, stream, ch_mask, enforce_eof_marker, rdepth=0):
    full = construct_full_path(dir_, path, stream[0].fs, num_bits_set(ch_mask))
    try:
        with open(full) as f:
            contents = f.read()
    except OSError as e:
        raise ChainParseError(f"error: failed to load effects file: {full}: {e}")
    if enforce_eof_marker:
        stripped = contents.rstrip()
        if not stripped.endswith(EOF_MARKER) or (
            len(stripped) > len(EOF_MARKER)
            and stripped[-len(EOF_MARKER) - 1] != "\n"
        ):
            raise ChainParseError(f"error: no valid end-of-file marker: {full}")
    new_dir = os.path.dirname(full) or "."
    log.verbose("info: begin effects file: %s", full)
    parse_string_into(chain, contents, full, new_dir, stream, ch_mask, rdepth)
    log.verbose("info: end effects file: %s", full)
