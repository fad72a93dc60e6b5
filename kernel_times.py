#!/usr/bin/env python3
"""Time dsp_tpu_torch's FFT-convolution transforms and splice on one CUDA
card, per call and device-only, beside the PyTorch call that computes the
same function, and compare two trees of the repository on the same card.

    python3 kernel_times.py                    # this checkout: one JSON line
    python3 kernel_times.py --tree DIR         # the dsp_tpu_torch beside DIR
    python3 kernel_times.py --against DIR      # DIR and this checkout in turns
                                               # (DIR, this, this, DIR), a table

DIR is an unpacked checkout of another commit (e.g. `git archive <commit> |
tar -x -C .smoke_tmp/parent`). Each tree runs in a process of its own, since
both packages are named dsp_tpu_torch, and builds its own kernels. Every
row calls only what both trees have: rfft_pack and rfft_pack_f32 without
the kept rows, irfft_crop, irfft_crop_f32, irfft_ola_f32, splice,
splice_f32, and the Upols and resampler steps. A row's times:

* per call: chip_smoke.py's cuda_ms, the mean of 50 calls back to back
  between CUDA events, after a warm-up (for a call this short, the host's
  enqueue);
* device-only: chip_smoke.py's device_ms, the card's kernels as
  torch.profiler records them over 20 calls, summed, a call; with the
  kernels a call.

The rows are chip_smoke.py's main-path shapes, where chip_smoke.py holds
each kernel against its plain version; this script only times them. Prints
the card's name and power limit (nvidia-smi) with the results. Needs a
CUDA card; exits nonzero without one.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

from chip_smoke import card_info, cuda_ms, device_ms

ROOT = Path(__file__).resolve().parent


def rows():
    """(name, the port's call, the library call or None) at the main path's
    shapes, seeded."""
    import numpy as np
    import torch

    from dsp_tpu_torch.ops import fft_conv as fc
    from dsp_tpu_torch.ops import resample_ops as ro

    dev = torch.device("cuda")
    rng = np.random.default_rng(20290)

    def normal(*shape, dtype=torch.float64):
        return torch.as_tensor(rng.standard_normal(shape) * 0.3, dtype=dtype, device=dev)

    a, x = normal(2048, 2), normal(2048, 2)
    a32, x32, add32 = (t.float() for t in (a, x, normal(2048, 2)))
    packed, packed32 = torch.cat([a, x]), torch.cat([a32, x32])
    Y = torch.fft.rfft(packed, n=4096, dim=0).contiguous()
    Y64 = Y.to(torch.complex64)
    cols32 = normal(588, 8, dtype=torch.float32)
    rs = ro.SpectralResampler(44100, 48000)
    Yr = ro.resample_fold(torch.fft.rfft(cols32.double(), n=1176, dim=0).contiguous(), rs.fold)
    ov32 = normal(640, 2, dtype=torch.float32)
    h = rng.standard_normal((2, 1 << 16)) * 0.01
    up = fc.UpolsConv(h, 2048)
    st64 = {k: torch.as_tensor(v, device=dev) for k, v in up.state0().items()}
    st32 = {k: v.float() for k, v in st64.items()}
    xr = normal(4 * 588, 2)
    ov = normal(640, 2)
    return [
        ("rfft_pack N=4096 C=2", lambda: fc.rfft_pack(a, x, 4096),
         lambda: torch.fft.rfft(packed, n=4096, dim=0)),
        ("rfft_pack_f32 N=4096 C=2", lambda: fc.rfft_pack_f32(x32, 4096, a32),
         lambda: torch.fft.rfft(packed32, n=4096, dim=0)),
        ("rfft_pack_f32 N=1176 C=8", lambda: fc.rfft_pack_f32(cols32, 1176),
         lambda: torch.fft.rfft(cols32, n=1176, dim=0)),
        ("irfft_crop N=4096 C=2", lambda: fc.irfft_crop(Y, 4096, 2048, 2048),
         lambda: torch.fft.irfft(Y, n=4096, dim=0)[2048:]),
        ("irfft_crop_f32 N=4096 C=2, addend", lambda: fc.irfft_crop_f32(Y, 4096, 2048, 2048, add32),
         lambda: torch.fft.irfft(Y64, n=4096, dim=0)[2048:]),
        ("irfft_ola_f32 N=1280 C=8", lambda: ro.irfft_ola_f32(Yr, 1280, ov32, 640 / 588), None),
        ("splice L=2048 C=2", lambda: fc.splice(a, x, 2048, 0, 2048),
         lambda: torch.cat([a[2048:], x])),
        ("splice_f32 L=2048 C=2", lambda: fc.splice_f32(a32, x32, 2048, 0, 2048),
         lambda: torch.cat([a32[2048:], x32])),
        ("Upols step (fir 64k, B=2048)", lambda: up.step(st64, x), None),
        ("Upols step float32", lambda: up.step(st32, x32), None),
        ("resample 48k step (4 inner blocks)", lambda: rs.block(ov, xr), None),
        ("resample 48k step float32", lambda: rs.block(ov32, xr.float()), None),
    ]


def measure():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: CUDA is not available")
    out = []
    for name, kern, lib in rows():
        r = {"name": name, "ms": cuda_ms(kern, 50)}
        r["device_ms"], r["kernels"] = device_ms(kern)
        if lib is not None:
            r["library_ms"] = cuda_ms(lib, 50)
            r["library_device_ms"], r["library_kernels"] = device_ms(lib)
        out.append(r)
    return out


def run_tree(tree):
    """This script on the dsp_tpu_torch beside `tree`, in a process of its
    own; returns its rows."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree", str(tree)],
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise SystemExit(f"kernel_times: {tree}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["rows"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=None)
    ap.add_argument("--against", type=Path, default=None)
    args = ap.parse_args()
    if args.against is None:
        tree = (args.tree or ROOT).resolve()
        sys.path.insert(0, str(tree))
        import dsp_tpu_torch

        if Path(dsp_tpu_torch.__file__).resolve().parent.parent != tree:
            raise SystemExit(f"kernel_times: dsp_tpu_torch imported from {dsp_tpu_torch.__file__}")
        rows_out = measure()
        print(json.dumps({"tree": str(tree), "card": card_info(), "rows": rows_out}))
        return 0
    card = card_info()
    order = [("before", args.against), ("after", ROOT), ("after", ROOT), ("before", args.against)]
    runs = [(label, run_tree(tree)) for label, tree in order]
    print(f"card: {card}; order: before, after, after, before")
    keys = ("ms", "device_ms", "kernels", "library_ms", "library_device_ms")
    table = []
    for i, first in enumerate(runs[0][1]):
        name = first["name"]
        row = {"name": name}
        for label in ("before", "after"):
            got = [r[i] for lab, rr in runs for r in [rr] if lab == label]
            for k in keys:
                vals = [g[k] for g in got if k in g]
                if vals:
                    row[f"{label}_{k}"] = vals
        table.append(row)
        print(f"{name}: " + "; ".join(
            f"{label} {'/'.join(f'{v:.4f}' for v in row[f'{label}_ms'])} ms a call, "
            f"{'/'.join(f'{v:.4f}' for v in row[f'{label}_device_ms'])} ms device-only, "
            f"{row[f'{label}_kernels'][0]} kernels"
            + (f", library {'/'.join(f'{v:.4f}' for v in row[f'{label}_library_ms'])} ms a call, "
               f"{'/'.join(f'{v:.4f}' for v in row[f'{label}_library_device_ms'])} ms device-only"
               if f"{label}_library_ms" in row else "")
            for label in ("before", "after")))
    print(json.dumps({"card": card, "rows": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
