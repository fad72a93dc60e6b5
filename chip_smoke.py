#!/usr/bin/env python3
"""Smoke run of dsp_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA Hopper card,
nvcc and PyTorch built for CUDA. It

1. prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernels from dsp_tpu_torch/csrc with nvcc;
2. runs each kernel (K1 lti_blocked, K2 biquad_scan) against its plain
   PyTorch version on the card, on the same inputs at the main path's
   shapes, fails above -200 dBFS, and times both with CUDA events;
3. writes 300 s of stereo 44.1 kHz float64 wav (seeded noise plus sines), a
   full track, and runs
   the port's CLI on it file to file with the flagship chain, at the default
   block (2048) and at -b 65536. Each run must produce the expected frame
   count, launch both kernels (their launch counts are zeroed just before
   the run), and match the port's CPU run on the first 10 s within -200 dBFS;
4. prints the kernels' record as one JSON line, then as the last line
   {"ok": true, "device": {...}}.

Any failed phase exits nonzero before the last line. Without CUDA, or
without the dsp_tpu_torch package beside this script, it exits nonzero and
prints no result. It imports nothing of jax or dsp_tpu.
"""

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FS = 44100
CHANNELS = 2
FLAGSHIP = (
    "gain -3 eq 1k 1.0 +3 eq 3.5k 0.8 -2 lowshelf 90 0.7071s +4 highshelf 10k 0.7071s -2 "
    "lowpass 18k 0.7071 highpass 30 0.7071 crossfeed 700 4.5 st2ms ms2st"
)
# f64 rounding amplified by the 30 Hz highpass's pole sensitivity (~1e5)
# stays near -220 dBFS; -200 leaves a margin and is far inside the -120 dBFS
# budget of dsp_tpu's parity tests
LIMIT_DBFS = -200.0
COMPARE_SECONDS = 10
SECONDS = 300  # the main path's input: a full track


class SmokeError(Exception):
    pass


def dbfs(err):
    return 20.0 * math.log10(err) if err > 0 else -math.inf


def check_close(what, err):
    print(f"  {what}: max |diff| {err:.3e} ({dbfs(err):.1f} dBFS)")
    if not dbfs(err) <= LIMIT_DBFS:
        raise SmokeError(f"{what}: {dbfs(err):.1f} dBFS is above {LIMIT_DBFS} dBFS")


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn() on the current stream, after a
    warm-up, from CUDA events around `reps` calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def card_info():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        raise SmokeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def build_kernels():
    from dsp_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.load()
    wall = time.perf_counter() - t0
    print(f"kernels: built {kernels.build_dir().name} with nvcc in {wall:.2f} s")
    for line in kernels.LIBRARY.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def flagship_parts():
    """The flagship chain's fused-cascade plan, crossfeed lanes and the
    coupled form of its 30 Hz highpass, from the port's own chain build."""
    import numpy as np

    from dsp_tpu_torch.chain import build_chain_from_string
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.effects.biquad import BiquadEffect
    from dsp_tpu_torch.effects.crossfeed import CrossfeedEffect
    from dsp_tpu_torch.ops import iir

    chain = build_chain_from_string(FLAGSHIP, StreamInfo(FS, CHANNELS))
    biquads = [e for e in chain.effects if type(e) is BiquadEffect]
    crossfeed = next(e for e in chain.effects if isinstance(e, CrossfeedEffect))
    plan = iir.CascadeBlockedPlan([e.c for e in biquads])
    hp = next(e for e in biquads if e.name == "highpass")
    A_cf, Bv_cf, c0_cf = iir.biquad_coeffs_to_ss(crossfeed.c)
    A_hp, Bv_hp = iir._coupled_form_ss(hp.c)
    return plan, {
        "crossfeed (companion, 4 lanes)": (A_cf, Bv_cf, c0_cf),
        "highpass 30 (coupled, 2 lanes)": (A_hp, Bv_hp, np.asarray(hp.c[0])),
    }


def kernel_phases(records):
    import numpy as np
    import torch

    from dsp_tpu_torch.ops import iir

    dev = torch.device("cuda")
    rng = np.random.default_rng(20260)
    plan, scans = flagship_parts()
    k1 = records["lti_blocked"]
    k2 = records["biquad_scan"]

    print(f"K1 lti_blocked: flagship cascade, n = {plan.n}, C = {plan.C}, L = {plan.L}")
    for B in (2048, 65536):
        x = torch.as_tensor(rng.standard_normal((B, CHANNELS)) * 0.3, device=dev)
        st = torch.as_tensor(rng.standard_normal((2, CHANNELS, plan.n)) * 1e-2, device=dev)
        st[1] *= 1e-9  # a small lo part, as a state handed over from dsp_tpu may carry
        s_k, y_k = iir.lti_blocked(plan, st, x)
        s_r, y_r = iir.lti_blocked_ref(plan, st, x)
        torch.cuda.synchronize()
        err = max((y_k - y_r).abs().max().item(), (s_k - s_r).abs().max().item())
        check_close(f"B={B} kernel vs plain", err)
        ms = cuda_ms(lambda: iir.lti_blocked(plan, st, x), 50)
        plain_ms = cuda_ms(lambda: iir.lti_blocked_ref(plan, st, x), 5)
        print(f"  B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        if B == 2048:
            k1["ms"], k1["plain_ms"] = ms, plain_ms

    print("K2 biquad_scan")
    for label, (A, Bv, c0) in scans.items():
        C = A.shape[0]
        A_t, Bv_t, c0_t = (torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in (A, Bv, c0))
        for B in (1, 7, 2048, 65536):
            x = torch.as_tensor(rng.standard_normal((B, C)) * 0.3, device=dev)
            st = torch.as_tensor(rng.standard_normal((C, 2)) * 1e-2, device=dev)
            s_k, y_k = iir.biquad_scan(A_t, Bv_t, c0_t, st, x)
            s_r, y_r = iir.biquad_scan_ref(A_t, Bv_t, c0_t, st, x)
            torch.cuda.synchronize()
            err = max((y_k - y_r).abs().max().item(), (s_k - s_r).abs().max().item())
            check_close(f"{label} B={B} kernel vs plain", err)
            k2["max_abs_err"] = max(k2["max_abs_err"], err)
            if B in (2048, 65536):
                ms = cuda_ms(lambda: iir.biquad_scan(A_t, Bv_t, c0_t, st, x), 50)
                plain_ms = cuda_ms(lambda: iir.biquad_scan_ref(A_t, Bv_t, c0_t, st, x), 5)
                print(f"  {label} B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
                if B == 2048 and label.startswith("crossfeed"):
                    k2["ms"], k2["plain_ms"] = ms, plain_ms


def write_input(path, seconds):
    """Seeded stereo test signal: sines summing to -6 dBFS plus noise."""
    import numpy as np

    from dsp_tpu_torch.codecs.base import CODEC_MODE_WRITE, CodecParams
    from dsp_tpu_torch.codecs.wav import WavWriter

    rng = np.random.default_rng(7)
    n = seconds * FS
    w = WavWriter(CodecParams(path=str(path), enc="double", fs=FS, channels=CHANNELS,
                              mode=CODEC_MODE_WRITE))
    head = None
    step = 1 << 20
    try:
        for t0 in range(0, n, step):
            t = np.arange(t0, min(n, t0 + step))[:, None] / FS
            x = 0.25 * np.sin(2 * np.pi * np.array([55.0, 440.0]) * t)
            x += 0.25 * np.sin(2 * np.pi * np.array([1000.0, 6000.0]) * t)
            x += 0.01 * rng.standard_normal(x.shape)
            w.write(x)
            if head is None:
                head = x[: COMPARE_SECONDS * FS].copy()
    finally:
        w.close()
    return n, head


def read_wav(path, frames=None):
    from dsp_tpu_torch.codecs.base import CodecParams
    from dsp_tpu_torch.codecs.wav import WavReader

    r = WavReader(CodecParams(path=str(path)))
    try:
        total = r.frames
        return total, r.read(total if frames is None else min(frames, total))
    finally:
        r.close()


def main_path(records, seconds, tmp):
    import os

    import numpy as np

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_string
    from dsp_tpu_torch.chain.chain import expected_out_frames
    from dsp_tpu_torch.cli.main import main as cli_main
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.ops import iir

    src = tmp / "in.wav"
    t0 = time.perf_counter()
    n_in, head = write_input(src, seconds)
    print(f"main path: wrote {seconds} s of stereo {FS} Hz float64 ({n_in} frames, "
          f"{src.stat().st_size / 1e6:.1f} MB) in {time.perf_counter() - t0:.2f} s")
    chain = build_chain_from_string(FLAGSHIP, StreamInfo(FS, CHANNELS))
    want = expected_out_frames(chain, n_in) - chain.output_discard
    os.environ["DSP_TPU_TORCH_DEVICE"] = "cuda"
    wrappers = {"lti_blocked": iir.lti_blocked, "biquad_scan": iir.biquad_scan}
    for block in (2048, 65536):
        out = tmp / f"out_{block}.wav"
        argv = (["-b", str(block)] if block != 2048 else []) + [
            "-q", str(src), "-o", "-e", "double", str(out), *FLAGSHIP.split()]
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        rc = cli_main(argv)
        wall = time.perf_counter() - t0
        counts = {name: w.launches for name, w in wrappers.items()}
        if rc != 0:
            raise SmokeError(f"dsp-torch -b {block} exited {rc}")
        print(f"  dsp-torch -b {block}: {wall:.3f} s wall, {seconds / wall:.1f}x realtime, "
              f"launches {counts}")
        for name, c in counts.items():
            if c <= 0:
                raise SmokeError(f"-b {block}: {name} kernel was not launched")
            records[name]["launches"] += c
        got, y = read_wav(out, COMPARE_SECONDS * FS)
        if got != want:
            raise SmokeError(f"-b {block}: {got} output frames, expected {want}")
        cpu = CompiledChain(build_chain_from_string(FLAGSHIP, StreamInfo(FS, CHANNELS)),
                            block, device="cpu")
        ref = cpu.process_array(head, drain=False)
        if not np.isfinite(y).all():
            raise SmokeError(f"-b {block}: non-finite output")
        check_close(f"-b {block} first {COMPARE_SECONDS} s vs the port on the CPU",
                    float(np.abs(y - ref).max()))
        out.unlink()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import dsp_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: dsp_tpu_torch not found beside this script: {e}", file=sys.stderr)
        return 1
    if Path(dsp_tpu_torch.__file__).resolve().parent.parent != ROOT:
        print(f"chip_smoke: dsp_tpu_torch imported from {dsp_tpu_torch.__file__}, "
              f"not from beside this script", file=sys.stderr)
        return 1

    records = {
        name: {"name": name, "route": "cuda", "source": f"dsp_tpu_torch/csrc/{name}.cu",
               "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
               "ms": None, "plain_ms": None, "timed_at": "B=2048"}
        for name, replaces in (("lti_blocked", "dsp_tpu/ops/iir.py:566"),
                               ("biquad_scan", "dsp_tpu/ops/iir.py:77"))
    }
    tmp = ROOT / ".smoke_tmp"
    try:
        print(card_info())
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}")
        build_kernels()
        kernel_phases(records)
        tmp.mkdir(exist_ok=True)
        main_path(records, SECONDS, tmp)
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
