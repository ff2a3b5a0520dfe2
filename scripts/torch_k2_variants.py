#!/usr/bin/env python3
"""Time variants of the smooth + NMS kernel (K2, ``csrc/smooth_nms.cu``)
on one CUDA card, to show which of its phases and choices sets its time.

    python3 scripts/torch_k2_variants.py

Each variant is the committed source with its tile, thread count or
channel chunks changed, or cut short after the vertical
pass (``stop 1``) or after the horizontal pass (``stop 2``), generated
here by text substitution and built by its own ``nvcc``. Every variant
runs on the same (184, 216, 19) map (the ``inference`` path at 4x);
full variants are checked bit for bit against the plain version. Prints
ptxas's registers per variant, then one JSON line per variant and turn:
ms per launch by CUDA events over back-to-back launches, and the card.

A one-off study of the kernel as it stands: the substitutions match its
text exactly and stop with an error once it changes. Delete the script
with the next change to the kernel rather than keep it in step.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {  # name -> -D flags
    "committed: 14x24 tile, 512 threads": "",
    "stop 1: vertical pass only": "-DK2_STOP=1",
    "stop 2: vertical and horizontal passes": "-DK2_STOP=2",
    "256 threads": "-DK2_THREADS=256",
    "256 threads, 2 channel chunks": "-DK2_THREADS=256 -DK2_CHUNKS=2",
    "6x50 tile": "-DK2_TH=6 -DK2_TW=50",
    "14x50 tile, 2 channel chunks": "-DK2_TW=50 -DK2_CHUNKS=2",
    "30x24 tile, 2 channel chunks": "-DK2_TH=30 -DK2_CHUNKS=2",
    "1024 threads": "-DK2_THREADS=1024",
}


def variant_source(src: str) -> str:
    """The committed source with its constants as -D knobs and early exits
    after a pass (writing a value read from shared memory, so that the
    pass is not dropped)."""
    subs = [
        ('#include "peak_select.cuh"',
         f'#include "{ROOT}/tfpose_tpu_torch/csrc/peak_select.cuh"\n'
         "#ifndef K2_TH\n#define K2_TH 14\n#endif\n"
         "#ifndef K2_TW\n#define K2_TW 24\n#endif\n"
         "#ifndef K2_THREADS\n#define K2_THREADS 512\n#endif\n"
         "#ifndef K2_CHUNKS\n#define K2_CHUNKS 1\n#endif\n"
         "#ifndef K2_STOP\n#define K2_STOP 3\n#endif"),
        ("constexpr int kTH = 14, kTW = 24;",
         "constexpr int kTH = K2_TH, kTW = K2_TW;"),
        ("constexpr int kThreads = 512;", "constexpr int kThreads = K2_THREADS;"),
        ('static_assert(kRows == 16, "a warp is 16 rows of two (channel, run) '
         'pairs");', ""),
        ("  int cb = C;\n", "  int cb = (C + K2_CHUNKS - 1) / K2_CHUNKS;\n"),
        ("    for (int r = 0; r < kRows; ++r) vb[r * g.lv + j] = v[r];\n  }\n"
         "  __syncthreads();\n",
         "    for (int r = 0; r < kRows; ++r) vb[r * g.lv + j] = v[r];\n  }\n"
         "  __syncthreads();\n#if K2_STOP == 1\n"
         "  for (int j = tid; j < g.vcols * cb; j += kThreads)\n"
         "    if (vb[j] == 12345.0f) out[j] = 1.0f;\n  return;\n#endif\n"),
        ("    for (int j = 0; j < kRH; ++j) sb[r * g.ls + (xs0 + j) * cb + c] = s[j];\n"
         "  }\n  __syncthreads();\n",
         "    for (int j = 0; j < kRH; ++j) sb[r * g.ls + (xs0 + j) * cb + c] = s[j];\n"
         "  }\n  __syncthreads();\n#if K2_STOP == 2\n"
         "  for (int j = tid; j < kSCols * cb; j += kThreads)\n"
         "    if (sb[j] == 12345.0f) out[j] = 1.0f;\n  return;\n#endif\n"),
    ]
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"csrc/smooth_nms.cu changed: {old[:60]!r} not found")
        src = src.replace(old, new)
    return src


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_k2_variants: no CUDA card available", file=sys.stderr)
        return 1
    from tfpose_tpu_torch.ops import resize
    from tfpose_tpu_torch.ops.kernels import build
    from tfpose_tpu_torch.ops.kernels.smooth_nms import (
        SMOOTH_NMS_ARGTYPES, _taps, smooth_nms_plain)
    from tfpose_tpu_torch.utils import synthetic

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=10, check=True).stdout.strip().splitlines()[0]
    with open(os.path.join(build.CSRC, "smooth_nms.cu")) as f:
        src = variant_source(f.read())
    os.makedirs(build.BUILD_ROOT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="k2_variants_", dir=build.BUILD_ROOT)
    cu = os.path.join(tmp, "k2.cu")
    with open(cu, "w") as f:
        f.write(src)
    procs = {}
    for i, (name, flags) in enumerate(VARIANTS.items()):
        so = os.path.join(tmp, f"v{i}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags.split(), "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        out = proc.communicate(timeout=build.BUILD_TIMEOUT_S)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{out}")
        regs = [line.split(":", 1)[1].strip() for line in out.splitlines()
                if "Used" in line and "smem" not in line]
        print(f"ptxas {name}: {' | '.join(regs)}", flush=True)
        fn = ctypes.CDLL(so).smooth_nms_launch
        fn.restype, fn.argtypes = ctypes.c_int, SMOOTH_NMS_ARGTYPES
        libs[name] = fn

    rng = np.random.default_rng(0)
    net = torch.from_numpy(synthetic.render_scene(rng, 3, 46, 54)[0]).cuda()
    heat = resize.resize_area(net[..., :19], 184, 216).contiguous()
    want = smooth_nms_plain(heat)
    taps = _taps(25, 3.0, "cpu")
    stream = torch.cuda.current_stream().cuda_stream
    for turn in range(2):
        for name, fn in libs.items():
            out = torch.zeros_like(heat)

            def call():
                status = fn(heat.data_ptr(), out.data_ptr(), taps.data_ptr(),
                            *heat.shape, 25, stream)
                if status != 0:
                    raise RuntimeError(f"{name}: CUDA error {status}")

            call()
            torch.cuda.synchronize()
            same = None if "stop" in name else bool(torch.equal(out, want))
            if same is False:
                raise AssertionError(f"{name} differs from the plain version")
            per = []
            for _ in range(20):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(50):
                    call()
                b.record()
                b.synchronize()
                per.append(a.elapsed_time(b) / 50)
            print(json.dumps({"variant": name, "turn": turn,
                              "ms_per_launch": float(np.median(per)),
                              "bit_identical": same, "card": smi}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
