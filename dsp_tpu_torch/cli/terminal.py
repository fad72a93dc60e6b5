"""Status-line display subsystem (reference: dsp.c:184-284,
dsp.h:57-72).

Effects (levels meters, matrix4 steering bars) register status lines; the
display renders them as an ANSI region below the progress line and clears/
redraws around log output. Falls back to no-op when stderr is not a tty.
"""

import os
import sys
import threading

from dsp_tpu_torch.core import log

_lock = threading.RLock()
_lines: list["Statusline"] = []
_progress = ""
_active = False
_drawn_lines = 0


class Statusline:
    def __init__(self, text=""):
        self.text = text

    def set(self, text):
        self.text = text


def is_tty():
    try:
        return sys.stderr.isatty()
    except Exception:
        return False


def term_width(default=80):
    try:
        w = os.get_terminal_size(sys.stderr.fileno()).columns
        return w if w > 0 else default  # fresh ptys report 0x0
    except Exception:
        return default


def register(sl):
    with _lock:
        if sl not in _lines:
            _lines.append(sl)


def unregister(sl):
    with _lock:
        if sl in _lines:
            _lines.remove(sl)


def set_progress(text):
    global _progress
    with _lock:
        _progress = text


def enable():
    global _active
    _active = is_tty()
    if _active:
        log.set_hooks(_clear, _redraw)


def disable():
    global _active
    with _lock:
        _clear()
        _active = False
        log.set_hooks(None, None)


def _clear():
    # runs as the log pre-hook on WHATEVER thread logs (readbuf worker,
    # writer thread): must hold the lock like statuslines_clear
    # (dsp.c:185-195); _lock is an RLock so update() can nest safely
    global _drawn_lines
    with _lock:
        if not _active or _drawn_lines == 0:
            return
        if _drawn_lines > 1:
            out = "\r" + f"\033[{_drawn_lines - 1}A" + "\033[J"
        else:
            out = "\r\033[K"
        sys.stderr.write(out)
        _drawn_lines = 0


def _redraw():
    global _drawn_lines
    with _lock:
        if not _active:
            return
        # truncate to the terminal width (trunc_line, dsp.c:199-225): a
        # wrapped physical line would make _drawn_lines undercount and the
        # next _clear would leave stale rows behind
        w = term_width()
        rows = [_progress] + [sl.text for sl in _lines]
        rows = [r[: max(w - 1, 1)] for r in rows if r]
        if not rows:
            return
        sys.stderr.write("\n".join(rows) + "\r")
        sys.stderr.flush()
        _drawn_lines = len(rows)


def update():
    """Clear + redraw (called by the runner at the progress interval)."""
    if not _active:
        return
    with _lock:
        _clear()
        _redraw()
