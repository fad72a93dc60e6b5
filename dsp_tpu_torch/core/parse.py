"""Argument parsers with the reference's exact semantics.

Mirrors util.c:

  * parse_freq       (util.c:49-63)    — float with optional 'k' (×1000)
  * parse_len        (util.c:90-93)    — length -> integer samples, suffixes s/m/S
  * parse_len_frac   (util.c:95-98)    — length -> fractional samples
  * parse_timespec   (util.c:100-111)  — [[hh:]mm:]ss or offset[s|m|S]
  * parse_selector   (util.c:131-188)  — channel selector -> bool mask
  * parse_selector_masked (util.c:190-213) — selector indices into set bits of a mask
  * selector_to_string    (util.c:215-237)
  * construct_full_path   (util.c:276-343) — ~/ expansion + %r/%k/%c substitutions

All "strtod-style" parsers consume a leading numeric prefix and return
``(value, rest)``; wrappers raise ParseError on trailing characters the
reference would reject.
"""

import os
import re

import numpy as np


class ParseError(ValueError):
    pass


_FLOAT_RE = re.compile(
    # hex-float alternative FIRST: regex alternation is ordered, and the
    # decimal branch would otherwise consume the leading '0' of '0x10'
    r"[ \t\n]*[+-]?(?:"
    r"0[xX][0-9a-fA-F]+(?:\.[0-9a-fA-F]*)?(?:[pP][+-]?\d+)?"
    r"|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
    r"|[iI][nN][fF](?:[iI][nN][iI][tT][yY])?"
    r"|[nN][aA][nN]"
    r")"
)
_INT_RE = re.compile(r"[ \t\n]*[+-]?\d+")


def strtod(s):
    """C strtod: parse a leading double; return (value, rest).

    If nothing parses, returns (0.0, s) like strtod with endptr == s.
    """
    m = _FLOAT_RE.match(s)
    if not m:
        return 0.0, s
    tok = m.group(0).strip()
    try:
        v = float.fromhex(tok) if tok.lower().startswith(("0x", "-0x", "+0x")) else float(tok)
    except ValueError:
        return 0.0, s
    return v, s[m.end():]


def strtol(s, base=10):
    """C strtol (base 10): parse a leading integer; return (value, rest)."""
    m = _INT_RE.match(s)
    if not m:
        return 0, s
    return int(m.group(0)), s[m.end():]


def _lround(x):
    """C lround: round half away from zero."""
    return int(np.floor(x + 0.5)) if x >= 0 else int(np.ceil(x - 0.5))


def parse_freq(s, partial=False):
    """Frequency with optional 'k' suffix (util.c:49-63)."""
    v, rest = strtod(s)
    if rest is not s and rest[:1] == "k":
        v *= 1000.0
        rest = rest[1:]
    if partial:
        return v, rest
    if rest == s or rest:
        raise ParseError(f"failed to parse frequency: {s!r}")
    return v


def _parse_len_frac(s, fs):
    v, rest = strtod(s)
    samples = v * fs
    if rest is not s:
        suf = rest[:1]
        if suf == "m":
            samples = v / 1000.0 * fs
            rest = rest[1:]
        elif suf == "s":
            samples = v * fs
            rest = rest[1:]
        elif suf == "S":
            samples = v
            rest = rest[1:]
    return samples, rest


def parse_len_frac(s, fs, partial=False):
    """Length in fractional samples; suffixes s (sec, default), m (ms), S (samples)."""
    samples, rest = _parse_len_frac(s, fs)
    if partial:
        return samples, rest
    if rest == s or rest:
        raise ParseError(f"failed to parse length: {s!r}")
    return samples


def parse_len(s, fs, partial=False):
    """Length in whole samples (lround of parse_len_frac)."""
    if partial:
        samples, rest = _parse_len_frac(s, fs)
        return _lround(samples), rest
    return _lround(parse_len_frac(s, fs))


def parse_timespec(s, fs):
    """``[[hours:]minutes:]seconds`` or ``offset[s|m|S]`` -> samples (util.c:100-111)."""
    if ":" not in s:
        samples, rest = _parse_len_frac(s, fs)
        if rest == s:
            raise ParseError(f"failed to parse timespec: {s!r}")
        return _lround(samples), rest
    v, rest = strtod(s)
    if rest == s:
        raise ParseError(f"failed to parse timespec: {s!r}")
    sign = -1.0 if (v < 0 or s.lstrip()[:1] == "-") else 1.0
    i = 0
    while rest[:1] == ":" and i < 2:
        nxt, rest2 = strtod(rest[1:])
        v = v * 60.0 + nxt * sign
        rest = rest2
        i += 1
    return _lround(v * fs), rest


def parse_selector(s, n):
    """Channel selector -> bool ndarray of length n (util.c:131-188).

    Grammar: empty or '-' = all; comma-separated values and ranges 'a-b',
    'a-', '-b'. Raises ParseError on malformed input or out-of-range values.
    """
    b = np.zeros(n, dtype=bool)
    if s == "" or s == "-":
        b[:] = True
        return b
    start = end = -1
    dash = False

    def set_range():
        s_, e_ = start, end
        if s_ == -1 and e_ == -1:
            s_, e_ = 0, n - 1
        elif s_ == -1:
            s_ = 0
        elif e_ == -1:
            e_ = (n - 1) if dash else s_
        b[s_ : e_ + 1] = True

    i = 0
    seen_any = False
    while i < len(s):
        c = s[i]
        if c.isdigit():
            j = i
            while j < len(s) and s[j].isdigit():
                j += 1
            v = int(s[i:j])
            if v > n - 1 or v < 0:
                raise ParseError(f"value out of range: {v}")
            if dash:
                if v < start:
                    raise ParseError(f"malformed range: {max(start, 0)}-{v}")
                end = v
            else:
                start = v
            seen_any = True
            i = j
        elif c == "-":
            if dash:
                raise ParseError("'-' unexpected")
            dash = True
            seen_any = True
            i += 1
        elif c == ",":
            if start == -1 and end == -1 and not dash:
                raise ParseError("',' unexpected")
            set_range()
            start = end = -1
            dash = False
            i += 1
        else:
            raise ParseError(f"invalid character: {c}")
    if start == -1 and end == -1 and not dash:
        raise ParseError("',' unexpected")
    set_range()
    return b


def parse_selector_masked(s, mask):
    """Selector whose indices refer to set bits of ``mask`` (util.c:190-213).

    Returns a bool ndarray of len(mask) with selected absolute channels set.
    """
    mask = np.asarray(mask, dtype=bool)
    n = len(mask)
    idx = np.flatnonzero(mask)
    inner = parse_selector(s, len(idx))
    b = np.zeros(n, dtype=bool)
    b[idx[inner]] = True
    return b


def selector_to_string(b):
    """Compact selector string for a bool mask (util.c:215-237)."""
    b = np.asarray(b, dtype=bool)
    n = len(b)
    parts = []
    i = 0
    while i < n:
        if b[i]:
            j = i
            while j + 1 < n and b[j + 1]:
                j += 1
            if j == i:
                parts.append(str(i))
            elif j == i + 1:
                parts.append(f"{i},{j}")
            else:
                parts.append(f"{i}-{j}")
            i = j + 1
        else:
            i += 1
    return ",".join(parts)


def num_bits_set(b):
    return int(np.count_nonzero(np.asarray(b, dtype=bool)))


def construct_full_path(dir_, path, fs, channels):
    """Path construction with ~/ and %r/%k/%c/%% substitutions (util.c:276-343).

    The prefix ($HOME or the sourcing directory) is copied VERBATIM like the
    reference — substitutions apply only within the path argument itself, so
    a directory named '100%room' survives."""
    prefix = ""
    base = path
    if path.startswith("~/"):
        home = os.environ.get("HOME")
        if home:
            prefix = home
        base = path[1:]
    elif dir_ is not None and not path.startswith("/"):
        prefix = dir_ + "/"
    out = [prefix]
    i = 0
    while i < len(base):
        c = base[i]
        if c == "%" and i + 1 < len(base):
            nxt = base[i + 1]
            if nxt == "r":
                out.append(str(int(fs)))
                i += 2
                continue
            if nxt == "k":
                out.append(f"{fs / 1000.0:.10g}")
                i += 2
                continue
            if nxt == "c":
                out.append(str(int(channels)))
                i += 2
                continue
            if nxt == "%":
                out.append("%")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def format_dur(seconds):
    """h:mm:ss.cc style duration used by the progress display (dsp.c)."""
    neg = seconds < 0
    seconds = abs(seconds)
    h = int(seconds // 3600)
    m = int((seconds % 3600) // 60)
    sec = seconds % 60
    sign = "-" if neg else ""
    if h:
        return f"{sign}{h}:{m:02d}:{sec:05.2f}"
    if m:
        return f"{sign}{m}:{sec:05.2f}"
    return f"{sign}{sec:.2f}"


def getopt(argv, optstring):
    """POSIX-style option scan matching dsp_getopt (util.c:374-418).

    optstring: chars, ':' = required arg, '::' = optional arg (attached only).
    Returns (options, operand_index): options is a list of (char, arg_or_None);
    scanning stops at the first non-option argument or '--'.
    Raises ParseError on unknown options or missing required arguments.
    """
    spec = {}
    i = 0
    while i < len(optstring):
        c = optstring[i]
        n = 0
        while i + 1 + n < len(optstring) and optstring[i + 1 + n] == ":":
            n += 1
        spec[c] = n  # 0 = flag, 1 = required, 2 = optional
        i += 1 + n
    opts = []
    ind = 0
    while ind < len(argv):
        a = argv[ind]
        if len(a) < 2 or a[0] != "-" or a == "-":
            break
        if a == "--":
            ind += 1
            break
        # NOTE: like the reference's IS_OPT (util.c:373), anything starting
        # with '-' is an option here — "stats -6" is an error, not ref_level
        sp = 1
        while sp < len(a):
            c = a[sp]
            if c not in spec:
                raise ParseError(f"unrecognized option '{c}'")
            kind = spec[c]
            if kind == 0:
                opts.append((c, None))
                sp += 1
            elif kind == 1:
                if sp + 1 < len(a):
                    opts.append((c, a[sp + 1 :]))
                elif ind + 1 < len(argv):
                    ind += 1
                    opts.append((c, argv[ind]))
                else:
                    raise ParseError(f"expected argument to option '{c}'")
                break
            else:  # optional, attached only
                opts.append((c, a[sp + 1 :] if sp + 1 < len(a) else None))
                break
        ind += 1
    return opts, ind
