"""Memory crash reports.

Counterpart of ``deeplearning4j_tpu/runtime/crash_reporting.py``: rebuild
of upstream ``org.deeplearning4j.util.CrashReportingUtil``. On a training
out-of-memory error the reference writes a memory dump (system info,
workspace sizes, per-layer memory breakdown); here the report holds the
CUDA allocator's statistics per device (``torch.cuda.memory_stats``:
allocated, reserved, peak), the per-layer parameter memory breakdown and
the error text — written to a timestamped file and returned as a string.

``CrashReportingUtil.wrap(fn, model)`` runs ``fn`` and writes the report on
``torch.cuda.OutOfMemoryError`` (or an error whose text says out of
memory). Every written (or failed) dump emits a ``crash.report`` event into
the event journal with the report path and the active trace id.
``CrashReportingUtil.clock`` is injectable (default
``datetime.datetime.now``) so tests drive the timestamped filename.
"""

from __future__ import annotations

import datetime
import os
import platform
import sys
from typing import Callable, Optional


from deeplearning4j_tpu_torch.runtime import journal


class CrashReportingUtil:
    crash_dump_dir: Optional[str] = None
    enabled: bool = True
    #: injectable wall clock: returns a
    #: ``datetime.datetime`` — drives both the report header and the
    #: dump filename, so tests assert exact paths without freezing time
    clock: Callable[[], datetime.datetime] = datetime.datetime.now

    @staticmethod
    def memory_report(model=None, error: Optional[BaseException] = None) -> str:
        import torch

        from deeplearning4j_tpu_torch.runtime import trace
        from deeplearning4j_tpu_torch.runtime.profiler import device_memory_stats
        from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
        devices = ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
        lines = ["===== deeplearning4j_tpu_torch memory / crash report =====",
                 f"time: {CrashReportingUtil.clock().isoformat()}",
                 f"python: {sys.version.split()[0]}  platform: {platform.platform()}",
                 f"torch: {torch.__version__}  cuda: {torch.version.cuda}",
                 f"devices: {devices}",
                 f"trace: {trace.current_trace_id() or '-'}"]
        if error is not None:
            lines += ["", "---- error ----", repr(error)]
        lines += ["", "---- device memory ----"]
        stats = device_memory_stats()
        if not stats:
            lines.append("  no CUDA device: memory stats unavailable")
        for d, st in stats.items():
            for k, v in sorted(st.items()):
                if k.endswith("bytes.all.current") or k.endswith("bytes.all.peak"):
                    lines.append(f"  {d}: {k:40s} {v / (1 << 20):12.1f} MiB")
        params = model.params() if model is not None and hasattr(model, "params") else None
        if params:
            lines += ["", "---- parameter memory breakdown ----"]
            total = 0
            for layer, sub in params.items():
                leaves = tree_leaves(sub)
                n = sum(int(t.numel()) for t in leaves)
                b = sum(int(t.numel()) * t.element_size() for t in leaves)
                total += b
                lines.append(f"  {layer:28s} {n:12,d} params {b / (1 << 20):10.2f} MiB")
            lines.append(f"  {'TOTAL':28s} {'':12s}        {total / (1 << 20):10.2f} MiB")
            lines.append("  (optimizer state typically 1-2x this again; activations "
                         "depend on the batch)")
        return "\n".join(lines)

    @staticmethod
    def write_memory_crash_dump(model=None, error: Optional[BaseException] = None) -> str:
        report = CrashReportingUtil.memory_report(model, error)
        d = CrashReportingUtil.crash_dump_dir or os.getcwd()
        path = os.path.join(
            d, f"dl4j-tpu-memory-crash-dump-"
               f"{CrashReportingUtil.clock():%Y%m%d-%H%M%S}.txt")
        written = True
        try:
            with open(path, "w") as f:
                f.write(report)
        except OSError:
            written = False
        # the crash joins the black box: the event carries the report
        # path and (via journal.emit) the active trace id, so the bundle
        # and the timeline reference the same artifact
        journal.emit("crash.report", path=path if written else None,
                     written=written,
                     error=type(error).__name__ if error else None)
        return report

    @staticmethod
    def wrap(fn, model=None):
        """Run ``fn()``; on a CUDA out-of-memory error, write the crash dump
        then re-raise (the reference hooks this into fit())."""
        import torch
        try:
            return fn()
        except Exception as e:
            msg = str(e).upper()
            if CrashReportingUtil.enabled and (
                    isinstance(e, torch.cuda.OutOfMemoryError)
                    or "OUT OF MEMORY" in msg or "OOM" in msg):
                CrashReportingUtil.write_memory_crash_dump(model, e)
            raise
