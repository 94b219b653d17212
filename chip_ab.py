#!/usr/bin/env python3
"""Variants of a kernel source of the port, built and timed in turns on one
NVIDIA card.

    python3 chip_ab.py conv_stats_tiles
    python3 chip_ab.py conv_stats_scale_d

An experiment names a source under ``deeplearning4j_tpu_torch/ops/kernels/
csrc/``, its variants as textual edits of that source (the first variant is
the source as it is) and the shapes to run. Each variant is built by
``nvcc`` with the port's flags into a temporary directory under the
git-ignored ``ops/kernels/_build/`` and loaded with ``ctypes``; at each
shape its outputs must equal the first variant's bit for bit, and its
device time (``torch.profiler``, the library's kernels only)
is taken in turns: every variant first to last, then last to first, so that
a drift of the card's clock reaches every variant alike. It prints the
card's name and power limit, each reading, and the least and largest
reading of each variant at each shape. Exit 1 if a variant does not build
or does not give the first variant's bits.

Experiments:

- ``conv_stats_tiles``: ``conv_stats_wgmma_kernel``'s tile width. As it is,
  BN = 128 also where 128 x 256 output tiles would fill the SMs three times
  or less; the other variants take BN = 256 for every N > 128, and BN = 128
  for every N > 64. Every shape of the ResNet-50 step.
- ``conv_stats_scale_d``: as it is, the accumulators are zeroed at each tile
  and every ``wgmma`` accumulates; the other variant zeroes them once and
  gives the first product of a tile a scale-d of 0, a runtime predicate.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# The 15 (M, K, N) of ResNet-50's step at batch 256 (chip_smoke.RESNET_CONV_SHAPES).
RESNET_SHAPES = [(802816, 64, 64), (802816, 64, 256), (802816, 256, 64), (200704, 256, 128),
                 (200704, 512, 128), (200704, 128, 512), (200704, 256, 512),
                 (50176, 512, 256), (50176, 1024, 256), (50176, 256, 1024),
                 (50176, 512, 1024), (12544, 1024, 512), (12544, 2048, 512),
                 (12544, 512, 2048), (12544, 1024, 2048)]

_FIRST_PRODUCT_SCALED = [
    ("""#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
""", ""),
    ("""    float acc[BN / 2];
""", """    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
"""),
    ("(float* d, uint64_t da, uint64_t db)", "(float* d, uint64_t da, uint64_t db, int scale_d)"),
    ('"r"(1));', '"r"(scale_d));'),
    ("sw128_desc(ws + 16 * 128 * kk, kBoxBytes, kSwizzleSpan));",
     "sw128_desc(ws + 16 * 128 * kk, kBoxBytes, kSwizzleSpan), ks > 0 || kk > 0);"),
]

EXPERIMENTS = {
    "conv_stats_tiles": {
        "source": "conv_stats.cu",
        "variants": {
            "as_is": [],
            "bn256_above_128": [("else if (N <= 128 || wgmma_tiles(M, N, 256) <= 3LL * sms)",
                                 "else if (N <= 128)")],
            "bn128_above_64": [("else if (N <= 128 || wgmma_tiles(M, N, 256) <= 3LL * sms)",
                                "else if (true)")],
        },
        "shapes": RESNET_SHAPES,
    },
    "conv_stats_scale_d": {
        "source": "conv_stats.cu",
        "variants": {"as_is": [], "first_product_scaled": _FIRST_PRODUCT_SCALED},
        "shapes": [(12544, 2048, 512), (12544, 1024, 2048), (50176, 256, 1024),
                   (802816, 64, 256)],
    },
}


def edit(src: str, edits) -> str:
    """Every occurrence of each old text replaced; each must occur."""
    for old, new in edits:
        if old not in src:
            raise ValueError(f"edit does not apply: {old[:70]!r}")
        src = src.replace(old, new)
    return src


def build(source, edits, workdir, name):
    from deeplearning4j_tpu_torch.ops.kernels import _native
    path = os.path.join(workdir, name + ".cu")
    with open(_native.CSRC / source) as f:
        src = edit(f.read(), edits)
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(workdir, name + ".so")
    t0 = time.perf_counter()
    out = subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, f"-I{_native.CSRC}", "-o", so,
                          path], capture_output=True, text=True)
    notes = [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
             if "C75" in ln or "spill stores" in ln and " 0 bytes spill" not in ln]
    print(f"[{name}] nvcc exit {out.returncode} in {time.perf_counter() - t0:.1f} s"
          + "".join(f"\n    {n[:160]}" for n in notes), flush=True)
    if out.returncode:
        print(out.stdout[-3000:], out.stderr[-3000:])
        return None
    return so


def conv_stats_case(lib, shape, device):
    """Inputs at ``shape`` and a call of the library's ``dl4j_conv_stats``
    on them; returns (call, outputs)."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import conv_stats as cs
    cs._declare(lib)
    m, k, n = shape
    g = torch.Generator(device=device).manual_seed(m + k)
    x = (torch.rand(m, k, generator=g, device=device) * 2.0).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device=device) * k ** -0.5).to(torch.bfloat16)
    shift = torch.randn(n, generator=g, device=device)
    y = torch.empty(m, n, dtype=torch.bfloat16, device=device)
    s1, s2 = torch.empty(n, device=device), torch.empty(n, device=device)
    part = torch.empty(2, lib.dl4j_conv_stats_blocks(m), n, device=device)

    def call():
        err = lib.dl4j_conv_stats(1, x.data_ptr(), w.data_ptr(), shift.data_ptr(), y.data_ptr(),
                                  part[0].data_ptr(), part[1].data_ptr(), s1.data_ptr(),
                                  s2.data_ptr(), m, k, n,
                                  torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"dl4j_conv_stats failed: cudaError {err}")

    return call, (y, s1, s2)


def main(argv) -> int:
    import torch
    if len(argv) != 1 or argv[0] not in EXPERIMENTS:
        print(f"usage: chip_ab.py {{{','.join(EXPERIMENTS)}}}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is False; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    exp = EXPERIMENTS[argv[0]]
    print(chip_smoke.nvidia_smi(), flush=True)
    device = torch.device("cuda:0")
    smoke = chip_smoke.Smoke(device)
    from deeplearning4j_tpu_torch.ops.kernels import _native
    _native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_ab-", dir=_native.BUILD_DIR) as workdir:
        libs = {}
        for name, edits in exp["variants"].items():
            so = build(exp["source"], edits, workdir, name)
            if so is None:
                return 1
            libs[name] = ctypes.CDLL(so)
        names = list(libs)
        readings = {(v, s): [] for v in names for s in exp["shapes"]}
        failed = False
        for shape in exp["shapes"]:
            cases = {v: conv_stats_case(libs[v], shape, device) for v in names}
            first = None
            for v in names + names[::-1]:
                call, outs = cases[v]
                with torch.no_grad():
                    call()
                    torch.cuda.synchronize()
                    bits = [chip_smoke.bits_equal(a, b) for a, b in
                            zip(outs, first or outs)]
                    first = first or [t.clone() for t in outs]
                    per, _ = smoke.profile_kernels(call, 20)
                ms = sum(t for key, (t, _) in per.items()
                         if "conv_stats" in key or "column_sums_kernel" in key)
                readings[(v, shape)].append(ms)
                failed |= not all(bits)
                print(f"  {v:22s} M={shape[0]} K={shape[1]} N={shape[2]}: {ms:.4f} ms by device "
                      f"time; the first variant's bits: {all(bits)}", flush=True)
            del cases
            torch.cuda.empty_cache()
        for v in names:
            print(f"{v}: " + "; ".join(
                f"{s}: {min(readings[(v, s)]):.4f}-{max(readings[(v, s)]):.4f}"
                for s in exp["shapes"]), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
