#!/usr/bin/env python3
"""Variants of a kernel source of the port, built and timed in turns on one
NVIDIA card.

    python3 chip_ab.py conv_stats_tiles
    python3 chip_ab.py conv_stats_scale_d
    python3 chip_ab.py lstm_fwd_staging
    python3 chip_ab.py lstm_barrier
    python3 chip_ab.py lstm_w_registers

An experiment names kernel sources under ``deeplearning4j_tpu_torch/ops/
kernels/csrc/``, its variants as textual edits of each source (the first
variant is the sources as they are), the edits every variant shares, and the
cases to run. Each variant is built by ``nvcc`` with the port's flags into a
temporary directory under the git-ignored ``ops/kernels/_build/`` and
loaded with ``ctypes``; in each case its outputs must equal the first
variant's bit for bit, and its device time (``torch.profiler``, the
library's kernels only) is taken in turns: every variant first to last, then
last to first, so that a drift of the card's clock reaches every variant
alike. It prints the card's name and power limit, each reading, and the
least and largest reading of each variant in each case. Exit 1 if a variant
does not build or does not give the first variant's bits.

Experiments:

- ``conv_stats_tiles``: ``conv_stats_wgmma_kernel``'s tile width. As it is,
  BN = 128 also where 128 x 256 output tiles would fill the SMs three times
  or less; the other variants take BN = 256 for every N > 128, and BN = 128
  for every N > 64. Every shape of the ResNet-50 step.
- ``conv_stats_scale_d``: as it is, the accumulators are zeroed at each tile
  and every ``wgmma`` accumulates; the other variant zeroes them once and
  gives the first product of a tile a scale-d of 0, a runtime predicate.
- ``lstm_fwd_staging``: the CUDA-core LSTM forward (``lstm_fwd_kernel``,
  which float32 and unaligned bf16 take) staging h_{t-1} with ``stage_rows``
  (16-byte loads) as it is, against one 2-byte load per value as it was
  written. B=64, T=256, H=512 bf16: the plain cell's inference and saving
  instances and the peephole cell's inference instance. The bf16 dispatch is
  sent to the CUDA-core kernel in both variants.
- ``lstm_barrier``: the row-group LSTM kernels (``lstm_fwd_mma_kernel``,
  ``lstm_bwd_mma_kernel``) meeting the other blocks of their row group at a
  counter as they are, against ``grid.sync()`` over the whole grid. The main
  path's cases above and the backward of both cells.
- ``lstm_w_registers``: the same kernels reading W_rec's B fragments from
  the pinned shared-memory copy by ``ldmatrix`` every step as they are,
  against loading them into registers once per launch (64 registers a
  thread at H = 512; only the main path's shape). The same cases.
"""

from __future__ import annotations

import ctypes
import os
import re
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

# The LSTM main path's cases: (cell, instance, T, B, H), bf16.
LSTM_MAIN = [("lstm", "infer", 256, 64, 512), ("lstm", "save", 256, 64, 512),
             ("graves", "infer", 256, 64, 512)]

_ELEMENT_STAGING = [(
    "      stage_rows(hs, H, hprev + (size_t)(a.r0 + rc0) * H, H, nr, H);\n",
    """      for (int idx = threadIdx.x; idx < nr * H; idx += kThreads) {
        const int r = idx / H, k = idx % H;
        hs[idx] = load_l2(hprev + (size_t)(a.r0 + rc0 + r) * H + k);
      }
""")]

# The row-group LSTM kernels with W_rec's B fragments loaded into registers
# once per launch, in place of an ldmatrix of the pinned W each step. Only at
# the main path's shape: the fragment arrays hold 4 k tiles a warp forward (H
# <= 512) and 8 pairs of k tiles a warp backward (4H <= 2048).
_FWD_W_REGISTERS = [
    ("""  const int chunks = KP / 8;  // 16-byte chunks of a staged row
""", """  const int chunks = KP / 8;  // 16-byte chunks of a staged row
  __syncthreads();
  uint32_t wreg[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int np = 0; np < 4; ++np)
      if (warp + 8 * i < KP / 16 && np * 16 < NC)
        attn_mma::ldmatrix_x4(wreg[i][np], wb + (size_t)np * 16 * LD + (warp + 8 * i) * 16);
"""),
    ("""    for (int kt = warp; kt < KP / 16; kt += kWarps) {
      uint32_t af[4];
      attn_mma::ldmatrix_x4(af, ha + kt * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np * 16 >= NC) break;
        uint32_t bfr[4];
        attn_mma::ldmatrix_x4(bfr, wb + (size_t)np * 16 * LD + kt * 16);
        attn_mma::mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
        attn_mma::mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }
""", """#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kt = warp + 8 * i;
      if (kt >= KP / 16) break;
      uint32_t af[4];
      attn_mma::ldmatrix_x4(af, ha + kt * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np * 16 >= NC) break;
        attn_mma::mma_bf16(acc[2 * np], af, wreg[i][np][0], wreg[i][np][1]);
        attn_mma::mma_bf16(acc[2 * np + 1], af, wreg[i][np][2], wreg[i][np][3]);
      }
    }
"""),
]
_BWD_W_REGISTERS = [
    ("""  const bf16* wb = ws + (lane & 7) * LD + (lane >> 3) * 8;
""", """  const bf16* wb = ws + (lane & 7) * LD + (lane >> 3) * 8;
  uint32_t wreg[8][2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      if (warp + 8 * i < K / 32 && nt * 8 < U)
        attn_mma::ldmatrix_x4(wreg[i][nt], wb + (size_t)nt * 8 * LD + (warp + 8 * i) * 32);
"""),
    ("""    for (int kp = warp; kp < K / 32; kp += kWarps) {
      uint32_t a0[4], a1[4];
      attn_mma::ldmatrix_x4(a0, da + kp * 32);
      attn_mma::ldmatrix_x4(a1, da + kp * 32 + 16);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (nt * 8 >= U) break;
        uint32_t bfr[4];
        attn_mma::ldmatrix_x4(bfr, wb + (size_t)nt * 8 * LD + kp * 32);
        attn_mma::mma_bf16(acc[nt], a0, bfr[0], bfr[1]);
        attn_mma::mma_bf16(acc[nt], a1, bfr[2], bfr[3]);
      }
    }
""", """#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kp = warp + 8 * i;
      if (kp >= K / 32) break;
      uint32_t a0[4], a1[4];
      attn_mma::ldmatrix_x4(a0, da + kp * 32);
      attn_mma::ldmatrix_x4(a1, da + kp * 32 + 16);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (nt * 8 >= U) break;
        attn_mma::mma_bf16(acc[nt], a0, wreg[i][nt][0], wreg[i][nt][1]);
        attn_mma::mma_bf16(acc[nt], a1, wreg[i][nt][2], wreg[i][nt][3]);
      }
    }
"""),
]
# Both LSTM sources: the row-group kernels' barrier replaced by grid.sync()
# (the saving forward's gate stores then follow the grid barrier, as they
# follow the counter's arrival).
_GRID_SYNC = {
    "lstm_fwd.cu": [("    if (t + 1 < a.T) group_arrive(counter);\n",
                     "    if (t + 1 < a.T) cg::this_grid().sync();\n"),
                    ("    if (t + 1 < a.T) group_wait(counter, (t + 1) * ugroups);\n", "")],
    "lstm_bwd.cu": [("    group_arrive(counter);\n    group_wait(counter, (a.T - t) * ugroups);\n",
                     "    cg::this_grid().sync();\n")],
}
# Each LSTM source's bf16 dispatch sent to its CUDA-core kernel.
_CUDA_CORE_ONLY = [("    if (mma_operands(a)) {", "    if (false) {")]
LSTM_ALL = LSTM_MAIN + [("lstm", "bwd", 256, 64, 512), ("graves", "bwd", 256, 64, 512)]

EXPERIMENTS = {
    "conv_stats_tiles": {
        "sources": ["conv_stats.cu"],
        "case": "conv_stats",
        "variants": {
            "as_is": {},
            "bn256_above_128": {"conv_stats.cu": [
                ("else if (N <= 128 || wgmma_tiles(M, N, 256) <= 3LL * sms)",
                 "else if (N <= 128)")]},
            "bn128_above_64": {"conv_stats.cu": [
                ("else if (N <= 128 || wgmma_tiles(M, N, 256) <= 3LL * sms)",
                 "else if (true)")]},
        },
        "shapes": RESNET_SHAPES,
    },
    "conv_stats_scale_d": {
        "sources": ["conv_stats.cu"],
        "case": "conv_stats",
        "variants": {"as_is": {}, "first_product_scaled": {"conv_stats.cu": _FIRST_PRODUCT_SCALED}},
        "shapes": [(12544, 2048, 512), (12544, 1024, 2048), (50176, 256, 1024),
                   (802816, 64, 256)],
    },
    "lstm_fwd_staging": {
        "sources": ["lstm_fwd.cu"],
        "case": "lstm",
        "common": {"lstm_fwd.cu": _CUDA_CORE_ONLY},
        "variants": {"as_is": {}, "element_loads": {"lstm_fwd.cu": _ELEMENT_STAGING}},
        "shapes": LSTM_MAIN,
    },
    "lstm_barrier": {
        "sources": ["lstm_fwd.cu", "lstm_bwd.cu"],
        "case": "lstm",
        "variants": {"as_is": {}, "grid_sync": _GRID_SYNC},
        "shapes": LSTM_ALL,
    },
    "lstm_w_registers": {
        "sources": ["lstm_fwd.cu", "lstm_bwd.cu"],
        "case": "lstm",
        "variants": {"as_is": {}, "w_registers": {"lstm_fwd.cu": _FWD_W_REGISTERS,
                                                  "lstm_bwd.cu": _BWD_W_REGISTERS}},
        "shapes": LSTM_ALL,
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
    path = os.path.join(workdir, f"{name}-{source}")
    with open(_native.CSRC / source) as f:
        src = edit(f.read(), edits)
    with open(path, "w") as f:
        f.write(src)
    so = path.replace(".cu", ".so")
    t0 = time.perf_counter()
    out = subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, f"-I{_native.CSRC}", "-o", so,
                          path], capture_output=True, text=True)
    notes = [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
             if "C75" in ln or "spill stores" in ln and " 0 bytes spill" not in ln]
    print(f"[{name} {source}] nvcc exit {out.returncode} in {time.perf_counter() - t0:.1f} s"
          + "".join(f"\n    {n[:160]}" for n in notes), flush=True)
    if out.returncode:
        print(out.stdout[-3000:], out.stderr[-3000:])
        return None
    return so


def conv_stats_case(libs, shape, device):
    """Inputs at ``shape`` and a call of the library's ``dl4j_conv_stats``
    on them; returns (call, outputs, the kernel names it times)."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import conv_stats as cs
    lib = libs["conv_stats.cu"]
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

    return call, (y, s1, s2), ("conv_stats", "column_sums_kernel")


class _Built:
    """A variant's library in the place of a wrapper's ``NativeLibrary``."""

    def __init__(self, lib, declare):
        declare(lib)
        self.lib = lib

    def load(self):
        return self.lib


def lstm_case(libs, shape, device):
    """The LSTM wrappers' launch of a variant's kernels at ``shape`` =
    (cell, instance, T, B, H) in bf16: the forward (``infer``, ``save``) or
    the backward (``bwd``, on the residuals of a saving forward of the
    sources as they are, run by the wrapper once before any variant); the
    main path's arguments (peepholes for ``graves``, no mask). Returns
    (call, outputs, the kernel names it times)."""
    import torch
    import chip_smoke
    from deeplearning4j_tpu_torch.ops.kernels import fused_lstm as fl
    cell, inst, T, B, H = shape
    a = chip_smoke.lstm_inputs(T, B, H, torch.bfloat16, device, seed=5, peep=cell == "graves",
                               mask=False)
    fwd = (a["zx"], a["w_rec"], a["peep"], a["h0"], a["c0"], None)
    counter = fl.LaunchCounter("chip_ab")
    if inst != "bwd":
        lib = _Built(libs["lstm_fwd.cu"], fl._declare_fwd)
        outs = []

        def call():
            fl.LIBRARY, keep = lib, fl.LIBRARY
            try:
                outs[:] = fl.launch_lstm_fwd(*fwd, counter, save=inst == "save")
            finally:
                fl.LIBRARY = keep

        call()
        return call, outs, ("lstm_fwd",)
    res = fl.launch_lstm_fwd(*fwd, counter, save=True)
    g = torch.Generator().manual_seed(6)
    cot = [torch.randn(s_, generator=g).to(torch.bfloat16).to(device)
           for s_ in ((T, B, H), (B, H), (B, H))]
    bwd = (*cot, res[3], res[4], a["c0"], a["w_rec"], a["peep"], None)
    lib = _Built(libs["lstm_bwd.cu"], fl._declare_bwd)
    outs = []

    def call():
        fl.BWD_LIBRARY, keep = lib, fl.BWD_LIBRARY
        try:
            outs[:] = fl.launch_lstm_bwd(*bwd, counter)
        finally:
            fl.BWD_LIBRARY = keep

    call()
    return call, outs, ("lstm_bwd",)


CASES = {"conv_stats": conv_stats_case, "lstm": lstm_case}


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
            libs[name] = {}
            for source in exp["sources"]:
                so = build(source, exp.get("common", {}).get(source, []) + edits.get(source, []),
                           workdir, name)
                if so is None:
                    return 1
                libs[name][source] = ctypes.CDLL(so)
        names = list(libs)
        readings = {(v, s): [] for v in names for s in exp["shapes"]}
        failed = False
        for shape in exp["shapes"]:
            cases = {v: CASES[exp["case"]](libs[v], shape, device) for v in names}
            first = None
            for v in names + names[::-1]:
                call, outs, timed = cases[v]
                with torch.no_grad():
                    call()
                    torch.cuda.synchronize()
                    bits = [chip_smoke.bits_equal(a, b) for a, b in
                            zip(outs, first or outs)]
                    first = first or [t.clone() for t in outs]
                    per, _ = smoke.profile_kernels(call, 20)
                ms = sum(t for key, (t, _) in per.items() if any(n in key for n in timed))
                ran = sorted({m[1] for key in per if any(n in key for n in timed)
                              and (m := re.search(r"(\w+_kernel)", key))})
                readings[(v, shape)].append(ms)
                failed |= not all(bits)
                print(f"  {v:22s} {shape}: {ms:.4f} ms by device time ({', '.join(ran)}); "
                      f"the first variant's bits: {all(bits)}", flush=True)
            del cases
            torch.cuda.empty_cache()
        for v in names:
            print(f"{v}: " + "; ".join(
                f"{s}: {min(readings[(v, s)]):.4f}-{max(readings[(v, s)]):.4f}"
                for s in exp["shapes"]), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
