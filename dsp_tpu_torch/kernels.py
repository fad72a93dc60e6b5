"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per ``.cu`` file, all started together, and linked into
one shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, never at import, into
``dsp_tpu_torch/_build/<hash>/``, keyed by a hash of the sources (headers
included) and flags, so an edited source rebuilds and an unchanged one loads
the library already built. A missing ``nvcc`` or a failed build raises
``KernelBuildError``; nothing falls back.

Each launch function here takes tensors the caller (``ops/iir.py``,
``ops/fft_conv.py``, ``ops/time_domain.py``, ``ops/resample_ops.py``,
``ops/m4_engine.py``) has checked, passes raw pointers and the current stream, and raises ``KernelLaunchError`` when the C
function returns a CUDA error. None of them synchronises or allocates; K1,
K11, matrix4_mb's K12-K13, K16's plain mode and K17 take the look-back
scratch of ``lookback_scratch``, made once a device and stream (grown when
a launch needs more). Every entry on a chain's path takes a stream count S
(split and batched processing): x [S, B, C] and each state led by S, the
S streams in the one launch of a single stream.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# extra nvcc flags of one source: the matrix4 engine rounds every product
# and sum on its own, as the plain version's torch ops do (csrc/m4_event.cu)
FILE_FLAGS = {"m4_event.cu": ("-fmad=false",)}


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def build_dir():
    h = hashlib.sha256()
    for flag in NVCC_FLAGS + tuple(f for name in sorted(FILE_FLAGS) for f in (name, *FILE_FLAGS[name])):
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


BIQUAD_RUN_MAX_STAGES = 16  # csrc/biquad_scan.cu kMaxStages


class BiquadRunStates(ctypes.Structure):
    """csrc/biquad_scan.cu's RunStates: a run's per-stage state pointers
    in and out, the elements from one lane's state to the next, from a
    state's hi part to its lo part, and from one stream's state to the
    next."""

    _fields_ = [("inp", ctypes.c_void_p * BIQUAD_RUN_MAX_STAGES),
                ("out", ctypes.c_void_p * BIQUAD_RUN_MAX_STAGES),
                ("lane", ctypes.c_int), ("lo", ctypes.c_int), ("stream", ctypes.c_longlong)]


class M4EvPtrs(ctypes.Structure):
    """csrc/m4_event.cu's EvPtrs: the event state's leaves in
    ops/m4_engine.EV_LEAVES order (11 bool, 28 float64, 8 int64)."""

    _fields_ = [("b", ctypes.c_void_p * 11), ("f", ctypes.c_void_p * 28), ("i", ctypes.c_void_p * 8)]


class M4EvPtrsF32(ctypes.Structure):
    """csrc/m4_event.cu's EvPtrsF32: the float32 event state, each float
    leaf as its (hi, lo) pair."""

    _fields_ = [("b", ctypes.c_void_p * 11), ("f", ctypes.c_void_p * 28),
                ("lo", ctypes.c_void_p * 28), ("i", ctypes.c_void_p * 8)]


class M4EvParams(ctypes.Structure):
    """csrc/m4_event.cu's EvParams."""

    _fields_ = (
        [(k, ctypes.c_double) for k in (
            "g_accom", "g_norm", "g_norm_fast", "g_slow", "g_smooth", "g_avg", "g_drift_slow",
            "g_drift_fast", "g_dpwr_slow", "g_dpwr_fast", "g_ds0", "g_ds1", "g_pwrcmp",
            "g_ord_notch_scale", "base_ord_ns")]
        + [("ord_lp_c", ctypes.c_double * 5)]
        + [(k, ctypes.c_double) for k in (
            "svf1_a0", "svf1_alpha", "svf1_beta", "svf2_a0", "svf2_alpha", "svf2_beta",
            "clip_thresh", "pcf_sens", "ord_factor_c", "diff_lim", "rear_ev_mask",
            "accom_mask_fall", "norm_accom_factor", "thresh", "bg_g0", "bg_c0", "bg_c1")]
        + [(k, ctypes.c_int) for k in ("buf_len", "sample_frames", "max_hold_frames",
                                       "min_hold_frames")]
    )


class M4K10Params(ctypes.Structure):
    """csrc/m4_event.cu's K10Params."""

    _fields_ = (
        [(k, ctypes.c_double) for k in ("surr_mult0", "surr_mult1", "contour_pwrcmp", "shelf_mult",
                                        "lowpass_mult", "matrix_param", "pf_c0", "pf_c1")]
        + [(k, ctypes.c_int) for k in ("matrix_v4", "dpwr_decouple", "fade_frames", "D")]
    )


class M4MbParams(ctypes.Structure):
    """csrc/m4_event.cu's MbParams."""

    _fields_ = (
        [(k, ctypes.c_double * 13) for k in ("etmax", "etmin", "contour", "base_ord_ns",
                                             "clip_thresh", "pcf_sens")]
        + [(k, ctypes.c_double) for k in ("g_evt", "surr_mult0", "surr_mult1", "contour_pwrcmp",
                                          "matrix_param", "pf_c0", "pf_c1")]
        + [(k, ctypes.c_int) for k in ("matrix_v4", "dpwr_decouple", "fade_frames", "D")]
    )


class M4MbAudioCfg(ctypes.Structure):
    """csrc/m4mb_audio.cu's MbAudioCfg."""

    _fields_ = [(k, ctypes.c_int) for k in ("len", "D", "phase_flip", "direct")]


class M4AudioCfg(ctypes.Structure):
    """csrc/m4_audio.cu's AudioCfg."""

    _fields_ = (
        [(k, ctypes.c_double) for k in ("shelf_sin", "shelf_cos1", "shelf_norm", "shelf_c2",
                                        "lp_sin", "lp_cos1", "lp_norm", "lp_c2")]
        + [(k, ctypes.c_int) for k in ("c0", "c1", "n_in", "n_out", "len", "D", "shelf_on",
                                       "lp_on", "phase_flip", "direct")]
    )


class ResampleStepCfg(ctypes.Structure):
    """csrc/resample.cu's ResampleStepCfg: a resampler's plans (host int
    arrays), its transforms' tables and fold tables on the card, the rate
    ratio and the inner block lengths."""

    _fields_ = ([(k, ctypes.c_void_p) for k in ("plan_f", "plan_i", "tables_f", "tables_i", "ptr",
                                               "j", "flags", "s")]
                + [("ratio", ctypes.c_double)]
                + [(k, ctypes.c_int) for k in ("in_len", "out_len")])


class _Library:
    """The loaded shared library and the log of the build that made it."""

    def __init__(self):
        self._lock = threading.Lock()
        self.lib = None
        self.build_log = ""  # empty when the library was built before
        self.fdl_mac = None  # (dsp_fdl_mac_c128, dsp_fdl_mac_f32), bound once at load

    def build(self):
        """Compile the sources unless this hash is built; return the path.
        Every .cu file compiles in its own nvcc process, all at once; then
        one nvcc links the objects."""
        out_dir = build_dir()
        lib_path = out_dir / LIB_NAME
        if lib_path.exists():
            return lib_path
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        tag = f"{os.getpid()}.tmp"
        jobs = []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = out_dir / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, *FILE_FLAGS.get(src.name, ()), "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"{Path(cmd[-1]).name} (exit {proc.returncode})")
        tmp = out_dir / f"{LIB_NAME}.{tag}"
        if not failed:
            cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"the link (exit {proc.returncode})")
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        self.build_log = "\n".join(logs)
        (out_dir / "build.log").write_text(self.build_log)
        if failed:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed: {', '.join(failed)}:\n{self.build_log[-4000:]}"
            )
        os.replace(tmp, lib_path)
        return lib_path

    def get(self):
        with self._lock:
            if self.lib is None:
                lib = ctypes.CDLL(str(self.build()))
                p, i = ctypes.c_void_p, ctypes.c_int
                ll = ctypes.c_longlong
                lib.dsp_lti_blocked_f64.argtypes = [p] * 12 + [ll, p, ll] + [i] * 7 + [p]
                lib.dsp_lti_blocked_f64.restype = i
                lib.dsp_lti_blocked_f32.argtypes = [p] * 13 + [ll, p, ll] + [i] * 7 + [p]
                lib.dsp_lti_blocked_f32.restype = i
                for fn in (lib.dsp_biquad_scan_f64, lib.dsp_biquad_scan_f32,
                           lib.dsp_biquad_scan_df, lib.dsp_biquad_scan_df1,
                           lib.dsp_biquad_scan_f64_pair):
                    fn.argtypes = [p] * 7 + [i] * 3 + [p]
                    fn.restype = i
                lib.dsp_biquad_scan_series_f64.argtypes = [p] * 7 + [i] * 3 + [p]
                lib.dsp_biquad_scan_series_f64.restype = i
                lib.dsp_biquad_scan_run.argtypes = ([p] * 3 + [ctypes.POINTER(BiquadRunStates)]
                                                    + [p] * 2 + [i] * 6 + [p])
                lib.dsp_biquad_scan_run.restype = i
                lib.dsp_crossfeed_step_f64.argtypes = ([p] * 7 + [i] * 5 + [ctypes.c_double] * 2
                                                       + [p])
                lib.dsp_crossfeed_step_f32.argtypes = ([p] * 7 + [i] * 5 + [ctypes.c_float] * 2
                                                       + [p])
                for fn in (lib.dsp_crossfeed_step_f64, lib.dsp_crossfeed_step_f32):
                    fn.restype = i
                for fn in (lib.dsp_fdl_mac_c128, lib.dsp_fdl_mac_f32):
                    fn.argtypes = [p] * 5 + [ctypes.c_longlong, i, i, p]
                    fn.restype = i
                self.fdl_mac = (lib.dsp_fdl_mac_c128, lib.dsp_fdl_mac_f32)
                for fn in (lib.dsp_rfft_pack_c128, lib.dsp_rfft_pack_f32):
                    fn.argtypes = [p, p, p, ll, p, ll, i, p, ll, p, p, i, i, i, p]
                    fn.restype = i
                for fn in (lib.dsp_irfft_crop_c128, lib.dsp_irfft_crop_f32):
                    fn.argtypes = [p, p, p, p, p, ll, ll, p, i, i, i, p]
                    fn.restype = i
                for fn in (lib.dsp_splice_f64, lib.dsp_splice_f32):
                    fn.argtypes = [p, p, p, ll, ll, ll, ll, i, i, ll, p]
                    fn.restype = i
                d = ctypes.c_double
                for fn in (lib.dsp_irfft_ola_f64, lib.dsp_irfft_ola_f32):
                    fn.argtypes = [p] * 7 + [d, i, i, i, i, p]
                    fn.restype = i
                for fn in (lib.dsp_fft_launches, lib.dsp_lti_launches, lib.dsp_m4_env_launches,
                           lib.dsp_biquad_run_launches, lib.dsp_m4mb_audio_launches,
                           lib.dsp_mod_delay_launches, lib.dsp_stats_launches,
                           lib.dsp_levels_launches, lib.dsp_resample_launches,
                           lib.dsp_noise_launches, lib.dsp_dither_launches,
                           lib.dsp_m4_event_launches, lib.dsp_m4_audio_launches):
                    fn.argtypes = []
                    fn.restype = ctypes.c_ulonglong
                for fn in (lib.dsp_tpdf_noise_f64, lib.dsp_tpdf_noise_f32):
                    fn.argtypes = [p] * 5 + [d, i, i, i, p]
                    fn.restype = i
                for fn in (lib.dsp_tpdf_dither_f64, lib.dsp_tpdf_dither_f32):
                    fn.argtypes = [p] * 13 + [i, i, i, i, p]
                    fn.restype = i
                for fn in (lib.dsp_levels_f64, lib.dsp_levels_f32):
                    fn.argtypes = [p] * 5 + [d, i, i, i, p, ll, p, ll, p]
                    fn.restype = i
                for fn in (lib.dsp_stats_f64, lib.dsp_stats_f32):
                    fn.argtypes = [p] * 20 + [i, i, i, p, ll, p, ll, p]
                    fn.restype = i
                for fn in (lib.dsp_stats_set_insert_f64, lib.dsp_stats_set_insert_f32):
                    fn.argtypes = [p, p]
                    fn.restype = i
                for fn in (lib.dsp_mod_delay_f64, lib.dsp_mod_delay_f32):
                    fn.argtypes = [p] * 12 + [i] * 7 + [d] * 3 + [i, p]
                    fn.restype = i
                lib.dsp_resample_fold_c128.argtypes = [p] * 6 + [i, i, p]
                lib.dsp_resample_fold_c128.restype = i
                lib.dsp_resample_step.argtypes = [p] * 5 + [i] * 4 + [p]
                lib.dsp_resample_step.restype = i
                lib.dsp_m4_env_f64.argtypes = [p] * 5 + [d] + [i] * 5 + [p, ll, p, ll, p]
                lib.dsp_m4_env_f64.restype = i
                lib.dsp_m4_env_f32.argtypes = [p] * 8 + [d] + [i] * 5 + [p, ll, p, ll, p]
                lib.dsp_m4_env_f32.restype = i
                lib.dsp_m4_event_f64.argtypes = [p] * 13 + [i] * 4 + [ll, ll, i, p]
                lib.dsp_m4_event_f64.restype = i
                lib.dsp_m4_event_f32.argtypes = [p] * 15 + [i] * 4 + [ll, ll, i, p]
                lib.dsp_m4_event_f32.restype = i
                for fn in (lib.dsp_m4_audio_f64, lib.dsp_m4_audio_f32):
                    fn.argtypes = [p] * 12 + [i, i, p]
                    fn.restype = i
                lib.dsp_m4mb_event_f64.argtypes = [p] * 13 + [i] * 4 + [ll, ll, i, p]
                lib.dsp_m4mb_event_f64.restype = i
                lib.dsp_m4mb_event_f32.argtypes = [p] * 15 + [i] * 4 + [ll, ll, i, p]
                lib.dsp_m4mb_event_f32.restype = i
                for fn in (lib.dsp_m4mb_audio_f64, lib.dsp_m4mb_audio_f32):
                    fn.argtypes = [p] * 8 + [i, i, p, ll, p, ll, p]
                    fn.restype = i
                lib.dsp_cuda_error_string.argtypes = [i]
                lib.dsp_cuda_error_string.restype = ctypes.c_char_p
                self.lib = lib
            return self.lib


LIBRARY = _Library()


def load():
    """Build (if needed) and load the kernel library; returns the ctypes handle."""
    return LIBRARY.lib or LIBRARY.get()


def _ptr(t):
    """A tensor's device address for a c_void_p argument (None: NULL)."""
    return None if t is None else t.data_ptr()


def _stream(t):
    """The handle of PyTorch's current stream on the CUDA device of tensor t,
    taken raw, without the Stream object torch.cuda.current_stream builds."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _check(rc, name):
    if rc != 0:
        what = load().dsp_cuda_error_string(rc).decode()
        raise KernelLaunchError(f"{name}: CUDA error {rc}: {what}")


_SCRATCH = {}


def lookback_scratch(like, nslots, width):
    """The scratch of csrc/lookback.cuh's chained scan for a launch of
    nslots tiles carrying `width` float64 values each, on like's device
    and current stream: (flags, agg), an int32 buffer of 4 head words and
    the tiles' flags, and a float64 buffer of their aggregates. One pair a
    (device, stream), shared by every K1, K11, m4mb_audio, stats (plain) and
    levels launch there; the flags
    are zeroed when made and made anew (zeroed) when a launch needs more
    slots, the aggregates grown without clearing. The kernels leave the
    flags ready for the next launch on that stream, so they are never
    cleared between launches, and they never share storage with the
    aggregates: a launch with fewer tiles than the one before cannot write
    an aggregate over a flag that a later launch reads."""
    key = (like.get_device(), _stream(like))
    flags, agg = _SCRATCH.get(key, (None, None))
    if flags is None or flags.numel() - 4 < nslots:
        slots = max(nslots, 1020, 0 if flags is None else 2 * (flags.numel() - 4))
        flags = torch.zeros(4 + slots, dtype=torch.int32, device=like.device)
    if agg is None or agg.numel() < nslots * width:
        agg = torch.empty(max(nslots * width, 4096, 0 if agg is None else 2 * agg.numel()),
                          dtype=torch.float64, device=like.device)
    _SCRATCH[key] = flags, agg
    return flags, agg


def _scratch_args(scratch):
    """(flags, flag_slots, agg, agg_doubles) for a C entry."""
    flags, agg = scratch
    return _ptr(flags), flags.numel() - 4, _ptr(agg), agg.numel()


def launch_lti_blocked(x, y, state_in, state_out, tables, scratch, L, T, S=1, y_lo=None):
    """float64 x, or float32 x with a float32 (hi, lo) state and, when
    y_lo is given, the (hi, lo) split of y; `tables` the (h, V, P, Qc, Qt,
    At, c0) of ops/iir.py lti_kernel_tables (At None when the last chunk
    is whole), built for chunks of L samples and tiles of T chunks; x
    [S, B, C] and the state [S, 2, C, n] for S streams."""
    B, C = x.shape[-2:]
    h, V, P, Qc, Qt, At, c0 = tables
    n = Qc.shape[-1]
    tail = (_ptr(h), _ptr(V), _ptr(P), _ptr(Qc), _ptr(Qt), _ptr(At), _ptr(c0),
            *_scratch_args(scratch), B, C, n, L, T, Qt.shape[1], S, _stream(x))
    if x.dtype == torch.float32:
        rc = load().dsp_lti_blocked_f32(_ptr(x), _ptr(y), _ptr(y_lo), _ptr(state_in),
                                        _ptr(state_out), *tail)
    else:
        rc = load().dsp_lti_blocked_f64(_ptr(x), _ptr(y), _ptr(state_in), _ptr(state_out), *tail)
    _check(rc, "lti_blocked")


def launch_biquad_scan(A, Bv, c0, state_in, state_out, x, y, S=1, pair=False):
    """K2 on float64 (a [C, 2] state, or with pair a [2, C, 2] (hi, lo)
    one) or float32 (coefficients of x's dtype), or K3 (float64
    coefficients, float32 x and a [2, C, 2] (hi, lo) state or a single
    [C, 2] float32 state); x [S, B, C] and each state with a leading S for
    S streams."""
    B, C = x.shape[-2:]
    if x.dtype == torch.float64:
        fn = load().dsp_biquad_scan_f64_pair if pair else load().dsp_biquad_scan_f64
    elif A.dtype == torch.float32:
        fn = load().dsp_biquad_scan_f32
    elif pair:
        fn = load().dsp_biquad_scan_df
    else:
        fn = load().dsp_biquad_scan_df1
    rc = fn(_ptr(A), _ptr(Bv), _ptr(c0), _ptr(state_in), _ptr(state_out), _ptr(x), _ptr(y),
            B, C, S, _stream(x))
    _check(rc, "biquad_scan")


def launch_biquad_scan_series(A, Bv, c0, state_in, state_out, x, y, S=1):
    """Two float64 K2 stages in series (rows [0, C) of the coefficients and
    state the first); x [S, B, C] and the state [S, 2C, 2] for S streams."""
    B, C = x.shape[-2:]
    rc = load().dsp_biquad_scan_series_f64(_ptr(A), _ptr(Bv), _ptr(c0), _ptr(state_in),
                                           _ptr(state_out), _ptr(x), _ptr(y), B, C, S,
                                           _stream(x))
    _check(rc, "biquad_scan_series")


def launch_biquad_scan_run(A, Bv, c0, states, out, x, y, lane, lo, stream, pair):
    """A run of n = len(states) stages in series on float64 or float32 x
    (csrc/biquad_scan.cu dsp_biquad_scan_run): A [n, C, 2, 2], Bv [n, C, 2],
    c0 [n, C] float64; states and out each stage's state in and out, whose
    lanes sit `lane` elements apart and, with pair, each lo `lo` elements
    after its hi; x [S, B, C] for S streams, each stream's states `stream`
    elements after the one before's."""
    B, C = x.shape[-2:]
    S = x.shape[0] if x.dim() == 3 else 1
    n = len(states)
    st = BiquadRunStates()
    st.inp[:n] = [t.data_ptr() for t in states]
    st.out[:n] = [t.data_ptr() for t in out]
    st.lane, st.lo, st.stream = lane, lo, stream
    rc = load().dsp_biquad_scan_run(A.data_ptr(), Bv.data_ptr(), c0.data_ptr(), ctypes.byref(st),
                                    x.data_ptr(), y.data_ptr(), B, C, n, S,
                                    int(x.dtype == torch.float32), int(pair), _stream(x))
    if rc:
        _check(rc, "biquad_scan_run")


def biquad_run_launches():
    """The kernels csrc/biquad_scan.cu's run entry (dsp_biquad_scan_run and
    its n = 2 case dsp_biquad_scan_series_f64) has launched in this process
    (the library's own count)."""
    return load().dsp_biquad_run_launches()


def launch_crossfeed_step(A, Bv, c0, state_in, state_out, x, out, col0, col1, direct, cross):
    """crossfeed's step on float64 or float32 x (coefficients, state and
    gains of x's dtype); x [S, B, C] and the state [S, 4, 2] for S
    streams."""
    B, C = x.shape[-2:]
    S = x.shape[0] if x.dim() == 3 else 1
    fn = load().dsp_crossfeed_step_f32 if x.dtype == torch.float32 else load().dsp_crossfeed_step_f64
    rc = fn(_ptr(A), _ptr(Bv), _ptr(c0), _ptr(state_in), _ptr(state_out), _ptr(x), _ptr(out), B, C,
            S, col0, col1, direct, cross, _stream(x))
    _check(rc, "crossfeed_step")


def launch_fdl_mac(X, H, fdl_in, Y, fdl_out, f32=False):
    """f32: the FDL as float32 (re, im) pairs (or none, for an overlap-save
    step of a float32 chain); X [S, NB, C] and the FDL [S, K, NB, C, 2]
    for S streams against the one H. The C entries are bound once, at
    load."""
    load()
    S = X.shape[0] if X.dim() == 3 else 1
    rc = LIBRARY.fdl_mac[f32](_ptr(X), _ptr(H), _ptr(fdl_in), _ptr(Y), _ptr(fdl_out), X.numel(),
                              H.shape[0], S, torch._C._cuda_getCurrentRawStream(X.get_device()))
    if rc:
        _check(rc, "fdl_mac")


def launch_rfft_pack(plan, tables, a, x, Lx, blocks, kept, X, work, grouped_out=False):
    """plan: ops/fft_conv.FftPlan of X's N and columns; tables its
    fft_tables on the card; x `blocks` groups of Lx rows, [blocks, Lx,
    C / blocks] (inner blocks, or streams), a [blocks, La, C / blocks] and
    kept [blocks, keep, C / blocks] or None; X [N//2+1, C], or with
    grouped_out a group at a time, [blocks, N//2+1, C / blocks]."""
    fn = load().dsp_rfft_pack_f32 if x.dtype == torch.float32 else load().dsp_rfft_pack_c128
    rc = fn(
        plan.c_plan, tables.data_ptr(), a.data_ptr(), a.shape[-2], x.data_ptr(), Lx, blocks,
        _ptr(kept), 0 if kept is None else kept.shape[-2], X.data_ptr(), _ptr(work), plan.N,
        plan.C, int(grouped_out), _stream(x),
    )
    _check(rc, "rfft_pack")


def launch_irfft_crop(plan, tables, Y, work, out, lo, add, ch):
    """Y [G, N//2+1, ch], out and add [G, L, ch]: plan.C = G·ch columns,
    ch a group (G streams)."""
    fn = load().dsp_irfft_crop_f32 if out.dtype == torch.float32 else load().dsp_irfft_crop_c128
    rc = fn(
        plan.c_plan, tables.data_ptr(), Y.data_ptr(), _ptr(work), out.data_ptr(), lo,
        out.shape[-2], _ptr(add), plan.N, plan.C, ch, _stream(Y),
    )
    _check(rc, "irfft_crop")


def launch_irfft_ola(plan, tables, Y, work, y, ov_out, ov_in, ratio, n):
    """y, ov_out and ov_in float64 (irfft_ola) or float32 (irfft_ola_f32);
    Y's columns are streams of n inner blocks each, ov_in and ov_out [S,
    N//2, ch] (S = 1: [N//2, ch])."""
    f32 = y.dtype == torch.float32
    fn = load().dsp_irfft_ola_f32 if f32 else load().dsp_irfft_ola_f64
    rc = fn(
        plan.c_plan, tables.data_ptr(), Y.data_ptr(), _ptr(work), y.data_ptr(), ov_out.data_ptr(),
        ov_in.data_ptr(), ratio, plan.N, plan.C, ov_in.shape[-1], n, _stream(Y),
    )
    _check(rc, "irfft_ola_f32" if f32 else "irfft_ola")


def launch_resample_step(cfg, x_ptr, y, ov_out, ov_ptr, n, C, S, f32, device):
    """cfg: the address of the resampler's ResampleStepCfg on `device`;
    x_ptr and ov_ptr the checked addresses of x and the carried overlap;
    y and ov_out the outputs (views of one buffer); S streams of n inner
    blocks of C channels."""
    rc = load().dsp_resample_step(cfg, x_ptr, y.data_ptr(), ov_out.data_ptr(), ov_ptr, n, C, S,
                                  f32, torch._C._cuda_getCurrentRawStream(device))
    if rc:
        _check(rc, "resample_step")


def resample_launches():
    """The steps csrc/resample.cu's one-launch kernel has run in this
    process (the library's own count)."""
    return load().dsp_resample_launches()


def noise_launches():
    """The kernels csrc/tpdf.cu's noise entries have launched in this
    process (the library's own count)."""
    return load().dsp_noise_launches()


def dither_launches():
    """The kernels csrc/tpdf.cu's dither entries have launched in this
    process (the library's own count)."""
    return load().dsp_dither_launches()


def fft_launches():
    """The kernels csrc/fft_conv.cu's transforms have launched in this
    process, every pass counted (the library's own count)."""
    return load().dsp_fft_launches()


def lookback_launches():
    """The kernels csrc/lti_blocked.cu, csrc/m4_env.cu and
    csrc/m4mb_audio.cu have launched in this process together (the
    library's own count)."""
    lib = load()
    return lib.dsp_lti_launches() + lib.dsp_m4_env_launches() + lib.dsp_m4mb_audio_launches()


def upmix_launches():
    """The kernels csrc/m4_event.cu (both engines) and csrc/m4_audio.cu have
    launched in this process together (the library's own count)."""
    lib = load()
    return lib.dsp_m4_event_launches() + lib.dsp_m4_audio_launches()


def mod_delay_launches():
    """The kernels csrc/mod_delay.cu has launched in this process (the
    library's own count)."""
    return load().dsp_mod_delay_launches()


def meter_launches():
    """The kernels csrc/stats.cu and csrc/levels.cu have launched in this
    process, (stats, levels) (the library's own counts)."""
    lib = load()
    return lib.dsp_stats_launches(), lib.dsp_levels_launches()


def launch_splice(a, x, out, L, lo, shift):
    """a [S, La, C], x [S, Lx, C] and out [S, L, C] for S streams (or
    without the leading S)."""
    fn = load().dsp_splice_f32 if x.dtype == torch.float32 else load().dsp_splice_f64
    S = x.shape[0] if x.dim() == 3 else 1
    rc = fn(a.data_ptr(), x.data_ptr(), out.data_ptr(), L, x.shape[-2], lo, shift, x.shape[-1],
            S, a.shape[-2], _stream(x))
    _check(rc, "splice")


def _by_dtype(t, name):
    """The float64 or float32 entry point `name`_f64 / `name`_f32 for t's dtype."""
    return getattr(load(), f"{name}_{'f32' if t.dtype == torch.float32 else 'f64'}")


def launch_tpdf_noise(ptrs, key_out, y, mult, B, C, S=1):
    """ptrs: the checked device addresses of x, key and, when some
    channels are not selected, the selector; key_out and y: views of the
    one output buffer; S streams; one ctypes call."""
    sel = ptrs[2] if len(ptrs) > 2 else None
    rc = _by_dtype(y, "dsp_tpdf_noise")(ptrs[1], key_out.data_ptr(), ptrs[0], y.data_ptr(), sel,
                                        mult, B, C, S, _stream(y))
    if rc:
        _check(rc, "tpdf_noise")


def launch_tpdf_dither(key, key_out, x, y, ehist, ehist_out, nprev, nprev_out, n_mult, q0, q1,
                       enabled, fir, mode):
    """x [S, B, C] (or [B, C]), each state led by S."""
    B, C = x.shape[-2:]
    S = x.shape[0] if x.dim() == 3 else 1
    rc = _by_dtype(x, "dsp_tpdf_dither")(
        _ptr(key), _ptr(key_out), _ptr(x), _ptr(y), _ptr(ehist), _ptr(ehist_out), _ptr(nprev),
        _ptr(nprev_out), _ptr(n_mult), _ptr(q0), _ptr(q1), _ptr(enabled), _ptr(fir), mode, B, C,
        S, _stream(x),
    )
    _check(rc, "tpdf_dither")


# the look-back scratch's width for csrc/stats.cu's plain mode (kPubWidth)
# and csrc/levels.cu (kSlot): tiles of TD_TILE samples of TD_GROUP channels
TD_TILE, TD_GROUP = 256, 8
STATS_SLOT, LEVELS_SLOT = 5 * TD_GROUP, 3 * TD_GROUP


def td_scratch(xs, B, n, width, S=1):
    """The look-back scratch of a stats (plain) or levels launch on S
    streams of [B, n] as a C entry's (flags, flag_slots, agg, agg_doubles):
    two slots a tile of each stream, `width` doubles each."""
    tiles = -(-B // TD_TILE) * max(1, -(-n // TD_GROUP)) * S
    return _scratch_args(lookback_scratch(xs, 2 * tiles, width))


def launch_levels(ptrs, out, xs, g, B, n, S=1):
    """ptrs: the device addresses of avg, peak and block_peak [S, n]; out:
    the [3, S, n] buffer of the new ones; one ctypes call."""
    lib = load()
    fn = lib.dsp_levels_f32 if xs.dtype == torch.float32 else lib.dsp_levels_f64
    rc = fn(*ptrs, out.data_ptr(), xs.data_ptr(), g, B, n, S,
            *td_scratch(xs, B, n, LEVELS_SLOT, S), _stream(xs))
    if rc:
        _check(rc, "levels")


# the -i insert template in csrc/stats.cu's constant bank, by (device,
# dtype): the table tensor last uploaded (held, so its memory is not reused)
# and its version counter
_STATS_INSERT = {}


def launch_stats(ptrs, fout, iout, nctr_out, limit, xs, insert_h, B, n, S=1):
    """ptrs: the device addresses of the state's leaves in csrc/stats.cu's
    order (plain: 8, then 6 None; -i: 14), each led by S for S streams;
    fout, iout, nctr_out: the new state's buffers (nctr_out None in plain
    mode); one ctypes call (and,
    with -i, the table's upload to the kernel's constant bank unless that
    table, the same tensor unmodified, is there already: an effect hands
    the same cached table every block)."""
    lib = load()
    f32 = xs.dtype == torch.float32
    if insert_h is not None:
        slot = (xs.device.index, xs.dtype)
        held = _STATS_INSERT.get(slot)
        if held is None or held[0] is not insert_h or held[1] != insert_h._version:
            up = lib.dsp_stats_set_insert_f32 if f32 else lib.dsp_stats_set_insert_f64
            _check(up(insert_h.data_ptr(), _stream(xs)), "stats")
            _STATS_INSERT[slot] = (insert_h, insert_h._version)
        scratch = (None, 0, None, 0)
    else:
        scratch = td_scratch(xs, B, n, STATS_SLOT, S)
    rc = (lib.dsp_stats_f32 if f32 else lib.dsp_stats_f64)(
        *ptrs, fout.data_ptr(), iout.data_ptr(), _ptr(nctr_out), limit, xs.data_ptr(),
        _ptr(insert_h), B, n, S, *scratch, _stream(xs))
    if rc:
        _check(rc, "stats")


def launch_resample_fold(X, Y, ptr, j, flags, s):
    rc = load().dsp_resample_fold_c128(
        _ptr(X), _ptr(Y), _ptr(ptr), _ptr(j), _ptr(flags), _ptr(s), Y.shape[0], Y.shape[1],
        _stream(X),
    )
    _check(rc, "resample_fold")


def launch_mod_delay(key, key_out, yk, yk_out, t, t_out, buf, x, y, buf_out, sel, table, n_new,
                     n_phases, n_taps, depth, step, step_b):
    """x [S, B, C] (or [B, C]), each state led by S."""
    B, C = x.shape[-2:]
    S = x.shape[0] if x.dim() == 3 else 1
    rc = _by_dtype(x, "dsp_mod_delay")(
        _ptr(key), _ptr(key_out), _ptr(yk), _ptr(yk_out), _ptr(t), _ptr(t_out), _ptr(buf),
        _ptr(x), _ptr(y), _ptr(buf_out), _ptr(sel), _ptr(table), buf.shape[-2], B, C,
        yk.shape[-1], n_new, n_phases, n_taps, depth, step, step_b, S, _stream(x),
    )
    _check(rc, "mod_delay")


def launch_m4_env(ybp, env_m, env_out, env_ds, g, nseg, scratch, w=None, lo=None):
    """ybp [NS, B, G, 2]: NS streams of G lanes; env_ds [NS, B/D, G, 8];
    tiles of nseg segments; w the [G, G] mix weights or None; scratch the
    look-back scratch; lo None (float64), or the float32 entry's lo parts
    (ybp_lo, env_m_lo, env_out_lo)."""
    NS, B, G = ybp.shape[:3]
    tail = (_ptr(env_ds), g, B, G, NS, B // env_ds.shape[1], nseg, *_scratch_args(scratch),
            _stream(ybp))
    if lo is None:
        rc = load().dsp_m4_env_f64(_ptr(ybp), _ptr(w), _ptr(env_m), _ptr(env_out), *tail)
    else:
        ybp_lo, env_lo, env_out_lo = lo
        rc = load().dsp_m4_env_f32(_ptr(ybp), _ptr(ybp_lo), _ptr(w), _ptr(env_m), _ptr(env_lo),
                                   _ptr(env_out), _ptr(env_out_lo), *tail)
    _check(rc, "m4_env")


def _ev_ptrs(ev, ev_lo=None):
    """EvPtrs of the event state ev, or EvPtrsF32 with the lo parts ev_lo."""
    from dsp_tpu_torch.ops.m4_engine import EV_LEAVES

    ptrs = M4EvPtrs() if ev_lo is None else M4EvPtrsF32()
    slots = {"b": 0, "f": 0, "i": 0}
    for name, kind in EV_LEAVES:
        getattr(ptrs, kind)[slots[kind]] = ev[name].data_ptr()
        if kind == "f" and ev_lo is not None:
            ptrs.lo[slots[kind]] = ev_lo[name].data_ptr()
        slots[kind] += 1
    return ptrs


def launch_m4_event(ctl, ev, ev_out, bg, bg_out, env_ds, vt, iy_in, ics, iy_out, aux, fade_p,
                    disable, geometry, ring, lo=None):
    """geometry: (threads, chunk, shared memory bytes, ring doubles),
    ops/m4_engine's event_geometry; ring: the rings' device scratch, or None
    where they sit in shared memory; lo None (float64), or the float32
    entry's lo parts (ev_lo, ev_out_lo, bg_lo, bg_out_lo)."""
    S, Nc = env_ds.shape[0], env_ds.shape[1]
    evp, k10 = ctl.c_structs()
    tail = (_ptr(env_ds), _ptr(vt), _ptr(iy_in), _ptr(ics), _ptr(iy_out), _ptr(aux), _ptr(ring),
            ctypes.byref(evp), ctypes.byref(k10), S, Nc, *geometry[:3], fade_p, int(disable),
            _stream(env_ds))
    if lo is None:
        rc = load().dsp_m4_event_f64(ctypes.byref(_ev_ptrs(ev)), ctypes.byref(_ev_ptrs(ev_out)),
                                     _ptr(bg), _ptr(bg_out), *tail)
    else:
        ev_lo, out_lo, bg_lo, bg_out_lo = lo
        rc = load().dsp_m4_event_f32(
            ctypes.byref(_ev_ptrs(ev, ev_lo)), ctypes.byref(_ev_ptrs(ev_out, out_lo)), _ptr(bg),
            _ptr(bg_lo), _ptr(bg_out), _ptr(bg_out_lo), *tail)
    _check(rc, "m4_event")


def launch_m4_audio(cfg, x, buf, interp_c, ics, shelf_m, lp_m, pf_m, y, shelf_out, lp_out, pf_out):
    """x [B, n_in], or [S, B, n_in] with every other tensor led by S."""
    fn = load().dsp_m4_audio_f32 if x.dtype == torch.float32 else load().dsp_m4_audio_f64
    rc = fn(
        _ptr(x), _ptr(buf), _ptr(interp_c), _ptr(ics), _ptr(shelf_m), _ptr(lp_m), _ptr(pf_m),
        _ptr(y), _ptr(shelf_out), _ptr(lp_out), _ptr(pf_out),
        ctypes.byref(cfg.c_struct()), x.shape[-2], x.shape[0] if x.dim() == 3 else 1, _stream(x),
    )
    _check(rc, "m4_audio")


def launch_m4mb_event(ctl, ev, ev_out, evt, evt_out, env_ds, vt, iy_in, ics, iy_out, aux, fade_p,
                      disable, geometry, ring, S=1, lo=None):
    """env_ds [Nc, 13, 8], or [S, Nc, 13, 8] for S streams with every other
    tensor led by S; geometry, ring and lo as launch_m4_event's (lo: ev_lo,
    ev_out_lo, evt_lo, evt_out_lo)."""
    evp, mb = ctl.c_structs()
    tail = (_ptr(env_ds), _ptr(vt), _ptr(iy_in), _ptr(ics), _ptr(iy_out), _ptr(aux), _ptr(ring),
            ctypes.byref(evp), ctypes.byref(mb), S, env_ds.shape[-3], *geometry[:3], fade_p,
            int(disable), _stream(env_ds))
    if lo is None:
        rc = load().dsp_m4mb_event_f64(ctypes.byref(_ev_ptrs(ev)), ctypes.byref(_ev_ptrs(ev_out)),
                                       _ptr(evt), _ptr(evt_out), *tail)
    else:
        ev_lo, out_lo, evt_lo, evt_out_lo = lo
        rc = load().dsp_m4mb_event_f32(
            ctypes.byref(_ev_ptrs(ev, ev_lo)), ctypes.byref(_ev_ptrs(ev_out, out_lo)), _ptr(evt),
            _ptr(evt_lo), _ptr(evt_out), _ptr(evt_out_lo), *tail)
    _check(rc, "m4mb_event")


def launch_m4mb_audio(cfg, bands, fb_buf, interp_c, ics, pf_m, sig, pf_out, scratch):
    """bands [B, 13, 2], or [S, B, 13, 2] with every other tensor led by S;
    scratch: the look-back scratch (read with the phase flip only)."""
    from dsp_tpu_torch.ops.m4_engine import DOWNSAMPLE_FACTOR

    c = M4MbAudioCfg(cfg.len, DOWNSAMPLE_FACTOR, int(cfg.phase_flip), int(cfg.direct_path))
    fn = load().dsp_m4mb_audio_f32 if bands.dtype == torch.float32 else load().dsp_m4mb_audio_f64
    rc = fn(
        _ptr(bands), _ptr(fb_buf), _ptr(interp_c), _ptr(ics), _ptr(pf_m), _ptr(sig), _ptr(pf_out),
        ctypes.byref(c), bands.shape[-3], bands.shape[0] if bands.dim() == 4 else 1,
        *_scratch_args(scratch), _stream(bands),
    )
    _check(rc, "m4mb_audio")
