"""Leveled logging (reference: dsp.h:25-31, util.c:503-563).

Log levels mirror the reference: SILENT < ERROR < OPEN_ERROR < NORMAL < VERBOSE.
Output goes to stderr and cooperates with the status-line display in
dsp_tpu_torch.cli.terminal (the display registers a hook that clears/redraws the
status region around log output, mirroring dsp.c:239-251).
"""

import sys
import threading

LL_SILENT = 0
LL_ERROR = 1
LL_OPEN_ERROR = 2
LL_NORMAL = 3
LL_VERBOSE = 4

_state = threading.local()
_lock = threading.RLock()
_level = LL_NORMAL
_prog_name = "dsp"

# hook called (acquired) before/after emitting, used by the terminal status
# region; signature: pre_hook() / post_hook()
_pre_hook = None
_post_hook = None


def set_loglevel(level):
    global _level
    _level = level


def get_loglevel():
    return _level


def loglevel(l):
    return _level >= l


def set_prog_name(name):
    global _prog_name
    _prog_name = name


def set_hooks(pre, post):
    global _pre_hook, _post_hook
    _pre_hook, _post_hook = pre, post


def _emit(msg):
    with _lock:
        if _pre_hook:
            _pre_hook()
        sys.stderr.write(msg)
        if not msg.endswith("\n"):
            sys.stderr.write("\n")
        sys.stderr.flush()
        if _post_hook:
            _post_hook()


def log(level, msg, *args):
    if _level >= level:
        _emit(msg % args if args else msg)


def error(msg, *args):
    log(LL_ERROR, msg, *args)


def warn(msg, *args):
    log(LL_NORMAL, msg, *args)


def info(msg, *args):
    log(LL_NORMAL, msg, *args)


def verbose(msg, *args):
    log(LL_VERBOSE, msg, *args)
