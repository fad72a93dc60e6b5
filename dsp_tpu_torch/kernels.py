"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use, never at import, into ``dsp_tpu_torch/_build/<hash>/``,
keyed by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the library already built. A missing ``nvcc`` or a
failed build raises ``KernelBuildError``; nothing falls back.

Each launch function here takes tensors the caller (``ops/iir.py``,
``ops/fft_conv.py``) has checked, passes raw pointers and the current
stream, and raises ``KernelLaunchError`` when the C function returns a CUDA
error. None of them synchronises or allocates.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libdsp_tpu_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def build_dir():
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode() + b"\0")
    for src in sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    return BUILD_ROOT / h.hexdigest()[:16]


def find_nvcc():
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class _Library:
    """The loaded shared library and the log of the build that made it."""

    def __init__(self):
        self._lock = threading.Lock()
        self.lib = None
        self.build_log = ""  # empty when the library was built before

    def build(self):
        """Compile the sources unless this hash is built; return the path."""
        out_dir = build_dir()
        lib_path = out_dir / LIB_NAME
        if lib_path.exists():
            return lib_path
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + self.build_log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed (exit {proc.returncode}):\n{self.build_log[-4000:]}"
            )
        os.replace(tmp, lib_path)
        return lib_path

    def get(self):
        with self._lock:
            if self.lib is None:
                lib = ctypes.CDLL(str(self.build()))
                p, i = ctypes.c_void_p, ctypes.c_int
                lib.dsp_lti_blocked_f64.argtypes = [p] * 11 + [i] * 4 + [p]
                lib.dsp_lti_blocked_f64.restype = i
                lib.dsp_biquad_scan_f64.argtypes = [p] * 7 + [i] * 2 + [p]
                lib.dsp_biquad_scan_f64.restype = i
                lib.dsp_fdl_mac_c128.argtypes = [p] * 5 + [ctypes.c_longlong, i, p]
                lib.dsp_fdl_mac_c128.restype = i
                ll = ctypes.c_longlong
                lib.dsp_rfft_pack_c128.argtypes = [p, ll, p, ll, p, p, i, i, p]
                lib.dsp_rfft_pack_c128.restype = i
                lib.dsp_irfft_crop_c128.argtypes = [p, p, p, ll, ll, p, i, i, p]
                lib.dsp_irfft_crop_c128.restype = i
                lib.dsp_splice_f64.argtypes = [p, p, p, ll, ll, ll, ll, i, p]
                lib.dsp_splice_f64.restype = i
                lib.dsp_cuda_error_string.argtypes = [i]
                lib.dsp_cuda_error_string.restype = ctypes.c_char_p
                self.lib = lib
            return self.lib


LIBRARY = _Library()


def load():
    """Build (if needed) and load the kernel library; returns the ctypes handle."""
    return LIBRARY.get()


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check(rc, name):
    if rc != 0:
        what = load().dsp_cuda_error_string(rc).decode()
        raise KernelLaunchError(f"{name}: CUDA error {rc}: {what}")


def launch_lti_blocked(x, y, state_in, state_out, h, V, P, AL, c0, v_scratch, s_scratch, L):
    B, C = x.shape
    n = AL.shape[-1]
    rc = load().dsp_lti_blocked_f64(
        _ptr(x), _ptr(y), _ptr(state_in), _ptr(state_out), _ptr(h), _ptr(V), _ptr(P),
        _ptr(AL), _ptr(c0), _ptr(v_scratch), _ptr(s_scratch), B, C, n, L, _stream(x.device),
    )
    _check(rc, "lti_blocked")


def launch_biquad_scan(A, Bv, c0, state_in, state_out, x, y):
    B, C = x.shape
    rc = load().dsp_biquad_scan_f64(
        _ptr(A), _ptr(Bv), _ptr(c0), _ptr(state_in), _ptr(state_out), _ptr(x), _ptr(y),
        B, C, _stream(x.device),
    )
    _check(rc, "biquad_scan")


def launch_fdl_mac(X, H, fdl_in, Y, fdl_out):
    rc = load().dsp_fdl_mac_c128(
        _ptr(X), _ptr(H), _ptr(fdl_in), _ptr(Y), _ptr(fdl_out), X.numel(), H.shape[0],
        _stream(X.device),
    )
    _check(rc, "fdl_mac")


def launch_rfft_pack(a, x, X, work, N):
    rc = load().dsp_rfft_pack_c128(
        _ptr(a), a.shape[0], _ptr(x), x.shape[0], _ptr(X), _ptr(work), N, x.shape[1],
        _stream(x.device),
    )
    _check(rc, "rfft_pack")


def launch_irfft_crop(Y, work, out, N, lo, add):
    rc = load().dsp_irfft_crop_c128(
        _ptr(Y), _ptr(work), _ptr(out), lo, out.shape[0], _ptr(add), N, Y.shape[1],
        _stream(Y.device),
    )
    _check(rc, "irfft_crop")


def launch_splice(a, x, out, lo, shift):
    rc = load().dsp_splice_f64(
        _ptr(a), _ptr(x), _ptr(out), out.shape[0], x.shape[0], lo, shift, out.shape[1],
        _stream(x.device),
    )
    _check(rc, "splice")
