#!/usr/bin/env python3
"""Smoke run of dsp_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA Hopper card,
nvcc and PyTorch built for CUDA. It

1. prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernels from dsp_tpu_torch/csrc with nvcc;
2. runs each kernel (K1 lti_blocked, K2 biquad_scan; K5-K7 rfft_pack,
   fdl_mac, irfft_crop and splice) against its plain PyTorch version on the
   card, on the same inputs at the main path's shapes, fails above
   -200 dBFS, and times both with CUDA events;
3. writes 300 s of stereo 44.1 kHz float64 wav (seeded noise plus sines), a
   full track, and runs the port's CLI on it file to file: the flagship
   chain at the default block (2048) and at -b 65536; then the FFT
   convolution paths, with seeded flat-noise filters it writes itself:
   `fir` 64k taps at -b 65536 (OLS) and 2048 (Upols), `fir_p` 1M taps at
   2048 (Nupols) and -b 65536 (Upols), and the shipped linear-phase
   crossover example (remix, forward and time-reversed biquads). Each run
   must produce the expected frame count, launch its kernels (their launch
   counts are zeroed just before the run), and match the port's CPU run on
   the first 10 s within -200 dBFS;
4. runs 96 blocks of the Nupols path (fir_p 1M at B = 2048) with the input
   on the card under torch.cuda.set_sync_debug_mode("error"): a step must
   not wait on the device;
5. prints the kernels' record as one JSON line, then as the last line
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
# the linear-phase crossover that ships with the repo: remix 2 -> 4, forward
# biquads (K1) and time-reversed ones (the reverse IIR on fdl_mac)
CROSSOVER = ROOT / "examples" / "crossover_lr4_2kHz_riir_linphase"


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


# (K, NB) of each fdl_mac call on the main path, C = 2 throughout
FDL_MAC_SHAPES = (
    (1, 65537, "OLS: fir 64k at B=65536"),
    (32, 2049, "Upols: fir 64k at B=2048, and the Nupols head"),
    (15, 65537, "the Nupols tail: fir_p 1M at B=2048"),
    (16, 65537, "Upols: fir_p 1M at B=65536"),
    (1, 2049, "the reverse IIR at B=2048"),
)


def fdl_mac_phase(rec):
    """fdl_mac against fdl_mac_ref on the card at the main path's shapes,
    seeded inputs and a nonzero FDL; both Y and FDL_out are held to
    LIMIT_DBFS (and Y alone for the K = 1 form without a delay line, as
    OlsConv calls it). Times both with CUDA events."""
    import numpy as np
    import torch

    from dsp_tpu_torch.ops.fft_conv import fdl_mac, fdl_mac_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261)

    def cnormal(*shape):
        return torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                               device=dev)

    print("K5-K7 fdl_mac (complex128)")
    rec["times"] = []
    for K, NB, what in FDL_MAC_SHAPES:
        X, H = cnormal(NB, CHANNELS), cnormal(K, NB, CHANNELS)
        fdl = torch.as_tensor(rng.standard_normal((K, NB, CHANNELS, 2)), device=dev)
        y_k, f_k = fdl_mac(X, H, fdl)
        y_r, f_r = fdl_mac_ref(X, H, fdl)
        torch.cuda.synchronize()
        err = max((y_k - y_r).abs().max().item(), (f_k - f_r).abs().max().item())
        check_close(f"K={K} NB={NB} ({what}) kernel vs plain", err)
        if K == 1:
            y_k, _ = fdl_mac(X, H)
            y_r, _ = fdl_mac_ref(X, H)
            torch.cuda.synchronize()
            e1 = (y_k - y_r).abs().max().item()
            check_close(f"K={K} NB={NB} without a delay line, kernel vs plain", e1)
            err = max(err, e1)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        ms = cuda_ms(lambda: fdl_mac(X, H, fdl), 50)
        plain_ms = cuda_ms(lambda: fdl_mac_ref(X, H, fdl), 20)
        mb = (3 * K + 1) * NB * CHANNELS * 16 / 1e6
        print(f"  K={K} NB={NB}: kernel {ms:.4f} ms ({mb / ms:.0f} GB/s of {mb:.1f} MB), "
              f"plain {plain_ms:.4f} ms")
        rec["times"].append({"K": K, "NB": NB, "ms": ms, "plain_ms": plain_ms})
        if (K, NB) == (32, 2049):
            rec["ms"], rec["plain_ms"] = ms, plain_ms


# One FFT-convolution step of each engine on the main path:
# (label, C, N, La, Lx, lo, L, with_add). rfft_pack transforms [a | x | 0]
# (a: La rows, x: Lx rows) at N; irfft_crop keeps rows [lo, lo + L) of the
# inverse, plus the Nupols tail's rows when with_add.
STEP_SHAPES = (
    ("OLS: fir 64k at B=65536", 2, 131072, 65535, 65536, 65535, 65536, False),
    ("Upols: fir 64k at B=2048", 2, 4096, 2048, 2048, 2048, 2048, False),
    ("the Nupols head: fir_p 1M at B=2048", 2, 4096, 2048, 2048, 2048, 2048, True),
    ("the Nupols tail, and Upols: fir_p 1M at B=65536", 2, 131072, 65536, 65536, 65536,
     65536, False),
    ("the reverse IIR of the crossover at B=2048", 4, 4096, 2048, 2048, 2048, 2048, False),
)
# The carried inputs: (label, C, La, Lx, L, lo, shift); see fft_conv.splice.
SPLICE_SHAPES = (
    ("OLS history: fir 64k at B=65536", 2, 65535, 65536, 65535, -1, 65536),
    ("Upols previous block at B=2048", 2, 2048, 2048, 2048, 0, 2048),
    ("Nupols stage write, block 17 of 32", 2, 65536, 2048, 65536, 17 * 2048, 0),
)


def step_kernels_phase(records):
    """rfft_pack, irfft_crop and splice against their plain versions on the
    card at the main path's shapes, seeded audio-scale inputs; held to
    LIMIT_DBFS (splice exactly). Times both with CUDA events."""
    import numpy as np
    import torch

    from dsp_tpu_torch.ops import fft_conv as fc

    dev = torch.device("cuda")
    rng = np.random.default_rng(20262)

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape) * 0.3, device=dev)

    print("K5-K7 rfft_pack and irfft_crop (float64, hand-written Stockham FFT)")
    for name in ("rfft_pack", "irfft_crop", "splice"):
        records[name]["times"] = []
    for what, C, N, La, Lx, lo, L, with_add in STEP_SHAPES:
        a, x = normal(La, C), normal(Lx, C)
        X_k, X_r = fc.rfft_pack(a, x, N), fc.rfft_pack_ref(a, x, N).contiguous()
        add = normal(L, C) if with_add else None
        y_k, y_r = fc.irfft_crop(X_r, N, lo, L, add), fc.irfft_crop_ref(X_r, N, lo, L, add)
        torch.cuda.synchronize()
        for name, err in (("rfft_pack", (X_k - X_r).abs().max().item()),
                          ("irfft_crop", (y_k - y_r).abs().max().item())):
            check_close(f"{name} N={N} C={C} ({what}) kernel vs plain", err)
            rec = records[name]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        timed = {
            "rfft_pack": (lambda: fc.rfft_pack(a, x, N), lambda: fc.rfft_pack_ref(a, x, N)),
            "irfft_crop": (lambda: fc.irfft_crop(X_r, N, lo, L, add),
                           lambda: fc.irfft_crop_ref(X_r, N, lo, L, add)),
        }
        for name, (kern, plain) in timed.items():
            ms, plain_ms = cuda_ms(kern, 50), cuda_ms(plain, 50)
            print(f"  {name} N={N} C={C}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            records[name]["times"].append({"N": N, "C": C, "ms": ms, "plain_ms": plain_ms})
            if (N, C, with_add) == (4096, 2, False):
                records[name]["ms"], records[name]["plain_ms"] = ms, plain_ms
    print("K5-K7 splice (float64)")
    rec = records["splice"]
    for what, C, La, Lx, L, lo, shift in SPLICE_SHAPES:
        a, x = normal(La, C), normal(Lx, C)
        o_k, o_r = fc.splice(a, x, L, lo, shift), fc.splice_ref(a, x, L, lo, shift)
        torch.cuda.synchronize()
        if not torch.equal(o_k, o_r):
            raise SmokeError(f"splice ({what}): kernel and plain version differ")
        ms = cuda_ms(lambda: fc.splice(a, x, L, lo, shift), 50)
        plain_ms = cuda_ms(lambda: fc.splice_ref(a, x, L, lo, shift), 50)
        print(f"  splice L={L} ({what}): equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        rec["times"].append({"L": L, "ms": ms, "plain_ms": plain_ms})
        if L == 2048:
            rec["ms"], rec["plain_ms"] = ms, plain_ms


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


def write_filter(path, taps, seed):
    """Seeded flat-noise impulse response, mono, scaled to an L1 norm of
    0.5 so the output stays inside full scale; every partition, the tail
    included, carries weight."""
    import numpy as np

    from dsp_tpu_torch.codecs.base import CODEC_MODE_WRITE, CodecParams
    from dsp_tpu_torch.codecs.wav import WavWriter

    h = np.random.default_rng(seed).standard_normal((taps, 1))
    h *= 0.5 / np.abs(h).sum(axis=0).max()
    w = WavWriter(CodecParams(path=str(path), enc="double", fs=FS, channels=1,
                              mode=CODEC_MODE_WRITE))
    try:
        w.write(h)
    finally:
        w.close()


def cli_run(label, chain_words, block, wrappers, records, src, n_in, head, seconds, tmp):
    """One file-to-file run of dsp-torch on the card. Fails unless it
    writes the expected frame count, launches every kernel in `wrappers`
    (their counts are zeroed just before the run) and matches the port's
    CPU run on the first COMPARE_SECONDS within LIMIT_DBFS."""
    import numpy as np

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_args
    from dsp_tpu_torch.chain.chain import expected_out_frames
    from dsp_tpu_torch.cli.main import main as cli_main
    from dsp_tpu_torch.core.types import StreamInfo

    chain = build_chain_from_args(chain_words, StreamInfo(FS, CHANNELS))
    want = expected_out_frames(chain, n_in) - chain.output_discard
    out = tmp / "out.wav"
    argv = (["-b", str(block)] if block != 2048 else []) + [
        "-q", str(src), "-o", "-e", "double", str(out), *chain_words]
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    rc = cli_main(argv)
    wall = time.perf_counter() - t0
    counts = {name: w.launches for name, w in wrappers.items()}
    if rc != 0:
        raise SmokeError(f"{label}: dsp-torch exited {rc}")
    print(f"  {label}: {wall:.3f} s wall, {seconds / wall:.1f}x realtime, launches {counts}")
    for name, c in counts.items():
        if c <= 0:
            raise SmokeError(f"{label}: {name} kernel was not launched")
        records[name]["launches"] += c
    got, y = read_wav(out, COMPARE_SECONDS * FS)
    if got != want:
        raise SmokeError(f"{label}: {got} output frames, expected {want}")
    cpu = CompiledChain(build_chain_from_args(chain_words, StreamInfo(FS, CHANNELS)), block,
                        device="cpu")
    ref = cpu.process_array(head, drain=False)
    if not np.isfinite(y).all():
        raise SmokeError(f"{label}: non-finite output")
    if len(ref) == 0 or len(y) < len(ref):
        raise SmokeError(f"{label}: {len(y)} frames to compare with {len(ref)} of the CPU run")
    check_close(f"{label}: first {COMPARE_SECONDS} s vs the port on the CPU",
                float(np.abs(y[: len(ref)] - ref).max()))
    out.unlink()


def main_path(records, seconds, tmp):
    """The flagship chain, then the FFT-convolution paths, file to file."""
    import os

    from dsp_tpu_torch.ops import fft_conv, iir

    src = tmp / "in.wav"
    t0 = time.perf_counter()
    n_in, head = write_input(src, seconds)
    print(f"main path: wrote {seconds} s of stereo {FS} Hz float64 ({n_in} frames, "
          f"{src.stat().st_size / 1e6:.1f} MB) in {time.perf_counter() - t0:.2f} s")
    os.environ["DSP_TPU_TORCH_DEVICE"] = "cuda"
    common = (records, src, n_in, head, seconds, tmp)
    k12 = {"lti_blocked": iir.lti_blocked, "biquad_scan": iir.biquad_scan}
    for block in (2048, 65536):
        cli_run(f"flagship -b {block}", FLAGSHIP.split(), block, k12, *common)

    f64k, f1m = tmp / "f64k.wav", tmp / "f1m.wav"
    write_filter(f64k, 1 << 16, seed=0xBE)
    write_filter(f1m, 1 << 20, seed=0xBF)
    mac = {name: getattr(fft_conv, name)
           for name in ("rfft_pack", "fdl_mac", "irfft_crop", "splice")}
    for label, words, block, wrappers in (
        ("fir 64k -b 65536 (OLS)", ["fir", str(f64k)], 65536, mac),
        ("fir 64k -b 2048 (Upols, K = 32)", ["fir", str(f64k)], 2048, mac),
        ("fir_p 1M -b 2048 (Nupols, m = 32)", ["fir_p", str(f1m)], 2048, mac),
        ("fir_p 1M -b 65536 (Upols, K = 16)", ["fir_p", str(f1m)], 65536, mac),
        ("crossover_lr4_2kHz_riir_linphase -b 2048", [f"@{CROSSOVER}"], 2048,
         {"lti_blocked": iir.lti_blocked, **mac}),
    ):
        cli_run(label, words, block, wrappers, *common)
    return f1m


def nupols_no_sync(f1m):
    """The Nupols step does not synchronise: CompiledChain.run_blocks over
    3 super-blocks (96 blocks at B = 2048) of input already on the card,
    under torch.cuda.set_sync_debug_mode("error")."""
    import numpy as np
    import torch

    from dsp_tpu_torch.chain import CompiledChain, build_chain_from_args
    from dsp_tpu_torch.core.types import StreamInfo
    from dsp_tpu_torch.ops.fft_conv import NupolsConv

    cc = CompiledChain(build_chain_from_args(["fir_p", str(f1m)], StreamInfo(FS, CHANNELS)),
                       2048, device="cuda")
    eng = cc._runtime_effects[0]._engine(2048)
    if not isinstance(eng, NupolsConv) or (eng.m, eng.K1, eng.head.K) != (32, 15, 32):
        raise SmokeError(f"fir_p 1M at B=2048: engine {type(eng).__name__}, expected Nupols m=32")
    rng = np.random.default_rng(11)
    warm = torch.as_tensor(rng.standard_normal((40, 2048, CHANNELS)) * 0.1, device="cuda")
    xs = torch.as_tensor(rng.standard_normal((96, 2048, CHANNELS)) * 0.1, device="cuda")
    cc.run_blocks(warm)  # uploads the spectra, plans the FFTs, fires once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ys = cc.run_blocks(xs)
    except RuntimeError as e:
        raise SmokeError(f"the Nupols step synchronised: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not torch.isfinite(ys).all():
        raise SmokeError("the Nupols run without syncs gave non-finite output")
    print(f"Nupols step: 96 blocks (3 super-blocks of 32) ran with no host sync, "
          f"cnt = {int(cc.states[0]['cnt'])}")


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
        name: {"name": name, "route": "cuda", "source": f"dsp_tpu_torch/csrc/{src}.cu",
               "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
               "ms": None, "plain_ms": None, "timed_at": timed_at}
        for name, src, replaces, timed_at in (
            ("lti_blocked", "lti_blocked", "dsp_tpu/ops/iir.py:566", "B=2048"),
            ("biquad_scan", "biquad_scan", "dsp_tpu/ops/iir.py:77", "B=2048"),
            ("rfft_pack", "fft_conv", "dsp_tpu/ops/fft_conv.py:85,137,204", "N=4096, C=2"),
            ("fdl_mac", "fdl_mac", "dsp_tpu/ops/fft_conv.py:85,137,204", "K=32, NB=2049, C=2"),
            ("irfft_crop", "fft_conv", "dsp_tpu/ops/fft_conv.py:85,137,204", "N=4096, C=2"),
            ("splice", "fft_conv", "dsp_tpu/ops/fft_conv.py:85,137,204", "L=2048, C=2"),
        )
    }
    tmp = ROOT / ".smoke_tmp" / "run"  # removed at the end; scratch scripts may sit beside it
    try:
        print(card_info())
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}")
        build_kernels()
        kernel_phases(records)
        fdl_mac_phase(records["fdl_mac"])
        step_kernels_phase(records)
        tmp.mkdir(parents=True, exist_ok=True)
        f1m = main_path(records, SECONDS, tmp)
        nupols_no_sync(f1m)
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
