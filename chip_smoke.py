#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``deeplearning4j_tpu_torch`` (never the JAX package, never JAX) on
the card and exits nonzero if any phase fails:

1. build  : compiles every CUDA kernel source of the port with ``nvcc``
            (one process per source, all started together) and prints the
            build time and each kernel's register use;
2. kernels: every kernel against its plain PyTorch version on the card, in
            float32 and bfloat16, at the serving shape (B=64, T=256, H=512)
            and at ragged shapes, with a random mask holding all-zero rows
            for the peephole/mask kernel; max error beside the tolerance;
3. slice  : the serving path at full width. ``TextGenerationLSTM(vocab 96,
            hidden 512, 2 layers)`` with random weights from a seed, in
            bf16 compute, is written to an archive, loaded by
            ``ModelRegistry.load`` and served to 8 client threads sending
            requests of 1-64 rows at T=256. Every answer is held against a
            forward pass built from the plain versions; the launch counts
            of the run must show the kernels ran; ``rnn_time_step`` over 4
            chunks of 64 steps must equal the whole-sequence output. Once
            with ``graves=True`` (GravesLSTM, kernel of
            ``fused_lstm_graves``) and once with ``graves=False`` (LSTM,
            kernel of ``fused_lstm``);
4. times  : each kernel's time at the serving shape (CUDA events, after
            warm-up) beside its bound, its plain version's time and, for the
            plain cell, ``torch.nn.LSTM`` (cuDNN) as a yardstick the port
            never calls; one 64-row request's latency and tokens/s.

Before the last line it prints one JSON object ``{"kernels": [...]}`` and
the card's name and power limit as ``nvidia-smi`` gives them; the last line
is ``{"ok": true, "device": {...}}``. With no CUDA device, or without the
rest of the repository beside it, it prints no result and exits nonzero.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SERVE_T, SERVE_B, HIDDEN, VOCAB, LAYERS = 256, 64, 512, 96, 2
# (T, B, H): the serving shape first, then the 1-row bucket, ragged widths, one
# step (rnn_time_step), and more rows than one launch takes
KERNEL_SHAPES = [(SERVE_T, SERVE_B, HIDDEN), (SERVE_T, 1, HIDDEN), (5, 3, 200),
                 (1, 64, 512), (3, 130, 64)]
# Kernel vs plain version, max abs error over ys/hT/cT. float32: the two sum
# h @ W_rec in different orders. bfloat16: both round h to bf16 at every
# step, so a tie broken the other way by that order carries one bf16 ulp
# (0.0078 at |c| in [1, 2)) down the sequence; 4 ulps of headroom.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 3.2e-2}
# Served softmax probabilities vs the plain forward (bf16 compute).
SERVE_TOL = 1e-2
# rnn_time_step in 4 chunks vs the whole sequence: the chunks hand h/c over
# in bf16 where the whole sequence keeps c in fp32 inside the kernel.
CHUNK_TOL = 2e-2
CLIENTS, REQUESTS_PER_CLIENT = 8, 3
# Published peaks of one H100 SXM (dense): bf16 tensor cores, fp32 without
# tensor cores, memory rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lstm_inputs(T, B, H, dtype, device, seed, peep, mask):
    import torch
    g = torch.Generator().manual_seed(seed)
    a = {"zx": torch.randn(T, B, 4 * H, generator=g),
         "w_rec": torch.randn(H, 4 * H, generator=g) * (1.0 / H) ** 0.5,
         "peep": torch.randn(3 * H, generator=g) * 0.3 if peep else None,
         "h0": torch.randn(B, H, generator=g) * 0.5,
         "c0": torch.randn(B, H, generator=g)}
    if mask:
        m = (torch.rand(T, B, generator=g) > 0.25).float()
        m[:, 0] = 0.0  # a row with every step masked
        if B > 2:
            m[:, B // 2] = 0.0
        a["mask"] = m
    else:
        a["mask"] = None
    return {k: None if v is None else v.to(dtype).to(device).contiguous()
            for k, v in a.items()}


def bound(a, outs):
    """Least time the card could take: each input read once and each output
    written once at the memory rate, vs the recurrent product's operations
    at the peak rate of the input type. Returns (ms, 'bytes'|'operations')."""
    T, B, H4 = a["zx"].shape
    moved = sum(t.numel() * t.element_size() for t in list(a.values()) + list(outs)
                if t is not None)
    flops = 2.0 * T * B * (H4 // 4) * H4
    rate = PEAK_FLOPS[str(a["zx"].dtype).replace("torch.", "")]
    t_bytes, t_ops = moved / PEAK_BYTES * 1e3, flops / rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Smoke:
    def __init__(self, device):
        import torch
        self.torch = torch
        self.device = device
        self.failures = []
        self.kernels = {}  # name -> JSON row

    def check(self, ok, what):
        log(("ok   " if ok else "FAIL ") + what)
        if not ok:
            self.failures.append(what)

    # ------------------------------------------------------------ phases
    def phase(self, name, fn):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # record, keep going, fail at the end
            import traceback
            traceback.print_exc()
            self.failures.append(f"{name}: {type(e).__name__}: {e}")
        log(f"== {name} took {time.perf_counter() - t0:.1f} s")

    def build(self):
        from deeplearning4j_tpu_torch.ops.kernels import _native, fused_lstm  # noqa: F401
        t0 = time.perf_counter()
        seconds = _native.build_all()
        log(f"kernel build: {time.perf_counter() - t0:.2f} s wall; per source {seconds}")
        for lib in _native._LIBRARIES.values():
            kernel = ""
            for line in lib.build_log.splitlines():
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1] if "'" in line else line
                    # lstm_fwd_kernel<T, PEEP, MASK> from its mangled name
                    m = re.search(r"\d+([a-z_]+_kernel)I\d*(\w+?)Lb(\d)ELb(\d)E", kernel)
                    kernel = f"{m[1]}<{m[2]}, {m[3]}, {m[4]}>" if m else kernel
                elif "Used" in line and "registers" in line:
                    log(f"  {lib.source.name} {kernel}: {line.split(':', 1)[1].strip()}")

    def kernel_phase(self):
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm as fl
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm_graves as fg
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            for T, B, H in KERNEL_SHAPES:
                for name, peep, mask in (("fused_lstm", False, False),
                                         ("fused_graves_lstm", True, True),
                                         ("fused_graves_lstm", True, False)):
                    a = lstm_inputs(T, B, H, dtype, self.device, seed=T * 7 + B, peep=peep,
                                    mask=mask)
                    if name == "fused_lstm":
                        got = fl.fused_lstm(a["zx"], a["w_rec"], a["h0"], a["c0"])
                        torch.cuda.synchronize()
                        want = fl.fused_lstm_reference(a["zx"], a["w_rec"], a["h0"], a["c0"])
                    else:
                        got = fg.fused_graves_lstm(a["zx"], a["w_rec"], a["peep"], a["h0"],
                                                   a["c0"], a["mask"])
                        torch.cuda.synchronize()
                        want = fg.fused_graves_lstm_reference(
                            a["zx"], a["w_rec"], a["peep"], a["h0"], a["c0"], a["mask"])
                    torch.cuda.synchronize()
                    err = max((x.float() - y.float()).abs().max().item()
                              for x, y in zip(got, want))
                    finite = all(bool(torch.isfinite(x.float()).all()) for x in got)
                    tol = KERNEL_TOL[dname]
                    self.check(finite and err <= tol,
                               f"{name:18s} {dname:8s} T={T:3d} B={B:3d} H={H:3d} "
                               f"mask={'yes' if mask else 'no '} max_abs_err={err:.3g} "
                               f"tol={tol:g}")
                    if (T, B, H) == KERNEL_SHAPES[0] and dtype == torch.bfloat16 \
                            and not mask:
                        row = self.kernels.setdefault(name, {})
                        row["max_abs_err"] = err

    def plain_forward(self, net, x):
        """The network's forward with every kernel replaced by its plain
        version: the reference the served answers are held against."""
        torch = self.torch
        from deeplearning4j_tpu_torch.nn.base import cast_floating
        from deeplearning4j_tpu_torch.nn.recurrent_layers import LSTM
        from deeplearning4j_tpu_torch.ops.kernels.fused_lstm import lstm_reference
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        cdt = get_environment().compute_dtype
        h = torch.as_tensor(x, device=net.device).to(cdt)
        params = cast_floating(net.params(), cdt)
        with torch.inference_mode():
            for i, layer in enumerate(net.layers):
                p = params[layer.name or f"layer_{i}"]
                if isinstance(layer, LSTM):
                    zx = torch.matmul(h.transpose(0, 1), p["W"]) + p["b"]
                    zero = torch.zeros(h.shape[0], layer.n_out, dtype=cdt, device=h.device)
                    ys, _, _ = lstm_reference(zx, p["W_rec"], p.get("peephole"), zero,
                                              zero, None)
                    h = ys.transpose(0, 1)
                else:
                    h = layer.activate(p, h)
        return h.float().cpu().numpy()

    def slice_phase(self, graves, workdir):
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ModelSerializer
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm as fl
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm_graves as fg
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.serving import ModelRegistry
        from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

        get_environment().allow_bfloat16()
        kernel = fg if graves else fl
        other = fl if graves else fg
        tag = f"graves={graves}"
        net = TextGenerationLSTM(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS,
                                 graves=graves).init(device=self.device)
        path = os.path.join(workdir, f"char-rnn-{'graves' if graves else 'lstm'}.zip")
        ModelSerializer.write_model(net, path)
        reg = ModelRegistry()
        served = reg.load("char-rnn", path, device=self.device, max_batch_size=SERVE_B,
                          batch_timeout_ms=5.0)
        rng = np.random.default_rng(1234 + graves)
        rows = rng.integers(1, SERVE_B + 1, (CLIENTS, REQUESTS_PER_CLIENT))
        rows[0, 0], rows[1, 0] = 1, SERVE_B
        eye = np.eye(VOCAB, dtype=np.float32)
        reqs = [[eye[rng.integers(0, VOCAB, (int(n), SERVE_T))] for n in r] for r in rows]
        answers = [[None] * REQUESTS_PER_CLIENT for _ in range(CLIENTS)]
        lat = []
        errors = []
        lat_lock = threading.Lock()

        def client(c):
            try:
                for k, x in enumerate(reqs[c]):
                    t0 = time.perf_counter()
                    answers[c][k] = reg.predict("char-rnn", x)
                    with lat_lock:
                        lat.append(time.perf_counter() - t0)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,), name=f"smoke-client-{c}")
                   for c in range(CLIENTS)]
        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        fl.counter.reset()
        fg.counter.reset()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched, stray = kernel.counter.value, other.counter.value
        # ----
        batches = served.batcher.batches
        self.check(not errors, f"{tag} serving: {len(lat)} requests answered, errors={errors}")
        self.check(launched == LAYERS * batches and stray == 0,
                   f"{tag} launch counts over the serving run: {kernel.counter.name}="
                   f"{launched} (expected {LAYERS} layers x {batches} batches), "
                   f"{other.counter.name}={stray} (expected 0)")
        self.kernels.setdefault(kernel.counter.name, {})["launches"] = launched
        log(f"{tag} {kernel.counter.name}: {launched / max(1, len(lat)):.2f} launches per "
            f"request, {launched / max(1, batches):.2f} per batch")
        worst = 0.0
        for c in range(CLIENTS):
            for k, x in enumerate(reqs[c]):
                got = answers[c][k]
                n = x.shape[0]
                bucket = next(b for b in served.batcher.buckets if b >= n)
                padded = np.zeros((bucket,) + x.shape[1:], np.float32)
                padded[:n] = x
                want = self.plain_forward(served.model, padded)[:n]
                ok = got is not None and got.shape == (n, SERVE_T, VOCAB) and \
                    bool(np.isfinite(got).all())
                worst = max(worst, float(np.abs(got - want).max()) if ok else float("inf"))
        self.check(worst <= SERVE_TOL,
                   f"{tag} {CLIENTS * REQUESTS_PER_CLIENT} served answers vs plain forward: "
                   f"max_abs_err={worst:.3g} tol={SERVE_TOL:g}")
        total_rows = int(rows.sum())
        lat_ms = sorted(1e3 * v for v in lat)
        log(f"{tag} serving: {len(lat)} requests, {total_rows} rows x {SERVE_T} steps in "
            f"{wall:.3f} s over {batches} batches (buckets {served.batcher.bucket_counts}); "
            f"latency p50 {lat_ms[len(lat_ms) // 2]:.2f} ms, max {lat_ms[-1]:.2f} ms; "
            f"{total_rows * SERVE_T / wall:.0f} tokens/s")

        # rnn_time_step in 4 chunks of 64 steps == the whole sequence
        model = served.model
        x = reqs[1][0][:8]
        whole = model.output(x).float().cpu().numpy()
        model.rnn_clear_previous_state()
        before = kernel.counter.value
        chunks = [model.rnn_time_step(x[:, s:s + 64]).float().cpu().numpy()
                  for s in range(0, SERVE_T, 64)]
        model.rnn_clear_previous_state()
        err = float(np.abs(np.concatenate(chunks, axis=1) - whole).max())
        self.check(err <= CHUNK_TOL and kernel.counter.value - before == LAYERS * 4,
                   f"{tag} rnn_time_step 4 x 64 steps vs whole sequence: "
                   f"max_abs_err={err:.3g} tol={CHUNK_TOL:g}; "
                   f"{kernel.counter.value - before} launches (expected {LAYERS * 4})")

        # one full-bucket request alone: latency and tokens/s
        x = reqs[1][0]  # SERVE_B rows
        reg.predict("char-rnn", x)  # warm-up
        ms = []
        for _ in range(20):
            t0 = time.perf_counter()
            reg.predict("char-rnn", x)
            ms.append(1e3 * (time.perf_counter() - t0))
        ms.sort()
        p50 = ms[len(ms) // 2]
        log(f"{tag} one {SERVE_B}-row request at a time, {len(ms)} requests: p50 "
            f"{p50:.2f} ms (min {ms[0]:.2f}, max {ms[-1]:.2f}), "
            f"{SERVE_B * SERVE_T / p50 * 1e3:.0f} tokens/s at p50")
        reg.shutdown()
        self.check(not served.batcher._worker.is_alive(), f"{tag} registry shut down")

    def times_phase(self):
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm as fl
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm_graves as fg
        T, B, H = KERNEL_SHAPES[0]
        dt = torch.bfloat16
        specs = [
            ("fused_graves_lstm", True,
             "deeplearning4j_tpu/ops/pallas/fused_lstm_graves.py:146"),
            ("fused_lstm", False, "deeplearning4j_tpu/ops/pallas/fused_lstm.py:162"),
        ]
        for name, peep, replaces in specs:
            # the main path's arguments: GravesLSTM has peepholes, no mask
            a = lstm_inputs(T, B, H, dt, self.device, seed=5, peep=peep, mask=False)
            if peep:
                def kern():
                    return fg.fused_graves_lstm(a["zx"], a["w_rec"], a["peep"], a["h0"], a["c0"])

                def plain():
                    return fg.fused_graves_lstm_reference(a["zx"], a["w_rec"], a["peep"],
                                                          a["h0"], a["c0"])
            else:
                def kern():
                    return fl.fused_lstm(a["zx"], a["w_rec"], a["h0"], a["c0"])

                def plain():
                    return fl.fused_lstm_reference(a["zx"], a["w_rec"], a["h0"], a["c0"])
            outs = kern()
            ms = cuda_ms(kern, reps=10)
            plain_ms = cuda_ms(plain, reps=3, warmup=1)
            bound_ms, bound_by = bound(a, outs)
            library_ms = None if peep else self.cudnn_ms(T, B, H, dt)
            row = self.kernels.setdefault(name, {})
            row.update({"name": name, "route": "cuda",
                        "source": "deeplearning4j_tpu_torch/ops/kernels/csrc/lstm_fwd.cu",
                        "replaces": replaces, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms})
            log(f"{name}: {ms:.3f} ms per launch at T={T} B={B} H={H} bf16; bound "
                f"{bound_ms:.4f} ms ({bound_by}); plain version {plain_ms:.3f} ms; "
                f"library {'n/a' if library_ms is None else f'{library_ms:.3f} ms'}")

    def cudnn_ms(self, T, B, H, dtype):
        """``torch.nn.LSTM`` (cuDNN) on layer 0's work: the input projection
        from the 96-wide one-hot plus the recurrence. A yardstick only."""
        torch = self.torch
        lstm = torch.nn.LSTM(VOCAB, H).to(self.device, dtype)
        lstm.flatten_parameters()
        x = torch.randn(T, B, VOCAB, device=self.device, dtype=dtype)
        with torch.inference_mode():
            return cuda_ms(lambda: lstm(x), reps=10)


def nvidia_smi():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
            f"nvidia-smi gave nothing (exit {out.returncode})"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    card = nvidia_smi()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    smoke = Smoke(device)
    t0 = time.perf_counter()
    smoke.phase("build", smoke.build)
    if smoke.failures:
        log("FAILED:", smoke.failures)
        return 1
    smoke.phase("kernels", smoke.kernel_phase)
    workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
    try:
        smoke.phase("slice graves=True", lambda: smoke.slice_phase(True, workdir))
        smoke.phase("slice graves=False", lambda: smoke.slice_phase(False, workdir))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    smoke.phase("times", smoke.times_phase)
    log(f"total {time.perf_counter() - t0:.1f} s")
    if smoke.failures:
        log("FAILED:")
        for f in smoke.failures:
            log("  " + f)
        return 1
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    rows = [{k: r.get(k) for k in keys} for r in smoke.kernels.values()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
