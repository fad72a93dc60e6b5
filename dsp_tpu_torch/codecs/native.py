"""ctypes bindings for the native dspio runtime (native/dspio.cpp).

Provides the C-implemented decode/encode + prefetching reader thread that
mirrors the reference's codec layer and codec_buf threads, as dsp_tpu's
codecs/native.py does. The wav and pcm readers use it transparently when the
library is built (``make -C native``; nothing here builds it); set
DSP_TPU_NATIVE=0 to force the pure-Python paths.
"""

import ctypes
import os

import numpy as np

_ENC = {"u8": 0, "s8": 1, "s16": 2, "s24": 3, "s24_3": 4, "s32": 5, "float": 6, "double": 7}

# where the shims are looked for, in order: the repo's native/ directory
# (``make -C native`` builds there) and this package's codecs directory
SEARCH_DIRS = (
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                 "native"),
    os.path.dirname(os.path.abspath(__file__)),
)


def load_shim(soname, declare):
    """Shared shim loader for the native C libraries (libdspio/libdspav/
    libdspmad): honors the DSP_TPU_NATIVE=0 gate, looks in SEARCH_DIRS, and
    returns False when none loads (the callers memoize it). `declare(lib)`
    sets the ctypes prototypes."""
    if os.environ.get("DSP_TPU_NATIVE", "1") == "0":
        return False
    for d in SEARCH_DIRS:
        cand = os.path.join(d, soname)
        if os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
            except OSError:
                continue
            declare(lib)
            return lib
    return False


def _declare(lib):
    lib.dspio_reader_open.restype = ctypes.c_void_p
    lib.dspio_reader_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.dspio_reader_read.restype = ctypes.c_int64
    lib.dspio_reader_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.dspio_reader_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dspio_reader_close.argtypes = [ctypes.c_void_p]
    lib.dspio_writer_open.restype = ctypes.c_void_p
    lib.dspio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.dspio_writer_write.restype = ctypes.c_int64
    lib.dspio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.dspio_writer_seek_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dspio_writer_write_bytes.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    lib.dspio_writer_close.argtypes = [ctypes.c_void_p]


_lib = None


def _load():
    global _lib
    if _lib is None:
        _lib = load_shim("libdspio.so", _declare)
    return _lib


def available():
    return bool(_load())


class NativeReader:
    """Prefetching file reader (decode thread runs ahead of the consumer)."""

    def __init__(self, path, enc, channels, data_off=0, frames=-1, block_frames=16384):
        lib = _load()
        if not lib:
            raise OSError("dspio library not available")
        self._lib = lib
        self._channels = channels
        self._h = lib.dspio_reader_open(
            path.encode(), _ENC[enc], channels, data_off, frames, block_frames
        )
        if not self._h:
            raise OSError(f"dspio: failed to open {path}")

    def read(self, frames):
        buf = np.empty((frames, self._channels), dtype=np.float64)
        got = self._lib.dspio_reader_read(self._h, buf.ctypes.data, frames)
        return buf[:got]

    def seek(self, frame):
        self._lib.dspio_reader_seek(self._h, frame)

    def close(self):
        if self._h:
            self._lib.dspio_reader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeWriter:
    def __init__(self, path, enc, channels):
        lib = _load()
        if not lib:
            raise OSError("dspio library not available")
        self._lib = lib
        self._channels = channels
        self._h = lib.dspio_writer_open(path.encode(), _ENC[enc], channels)
        if not self._h:
            raise OSError(f"dspio: failed to open {path}")

    def write(self, buf):
        buf = np.ascontiguousarray(buf, dtype=np.float64)
        return int(self._lib.dspio_writer_write(self._h, buf.ctypes.data, len(buf)))

    def write_bytes_at(self, off, data):
        self._lib.dspio_writer_seek_bytes(self._h, off)
        self._lib.dspio_writer_write_bytes(self._h, data, len(data))

    def close(self):
        if self._h:
            self._lib.dspio_writer_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
