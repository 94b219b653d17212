"""Cold-start layer: the kernels' build cache and captured-graph dispatch.

Counterpart of ``deeplearning4j_tpu/runtime/compile_cache.py``, which does
two jobs for XLA; the port does the same two for CUDA.

**Build cache** (:func:`enable`): the JAX module keeps XLA executables in a
framework-keyed directory; the port's one-time cost is ``nvcc`` building
``ops/kernels/csrc/*.cu``, so :func:`enable` moves the kernels' build
directory (``ops/kernels/_build/`` when it is never called) under
``<directory>/dl4j-tpu-torch-v1-torch<version>-cuda<version>-sm_90a``: a new
PyTorch or CUDA never loads a library built for another. :func:`stats`
counts libraries loaded from the directory (``hits``), built (``misses``,
``compiles``, ``compile_seconds``) and found unloadable
(``corrupt_entries``): a truncated or bit-rotten ``.so`` (or a fault
injected at the ``runtime.compile_cache.load`` chaos point) is counted,
deleted and rebuilt, never fatal (JAX ``:17-23``).

**AOT dispatch** (:class:`AotCache`): where the JAX fit loops call a cached
``lower().compile()`` executable per argument signature, the port captures
the step into a ``torch.cuda.CUDAGraph`` per caller-owned key and replays
it. The step reads and writes the network's state in place (the packed
buffers of :mod:`.state_packing`), and takes its per-step arguments from
static input buffers that each call copies into. Arguments that no longer
fit the buffers (shape, dtype, device) are signature drift: the entry is
dropped and the step runs eagerly (``aot_fallbacks``), the JAX module's
one fallback (``:295-308``). A capture that fails raises. Off with
``DL4J_TPU_AOT_DISPATCH=0`` or ``get_environment().set_aot_dispatch(False)``.
"""

from __future__ import annotations

import gc
import logging
import os
import threading
import time
from typing import Any, Dict, Hashable, List, Optional

import torch

from deeplearning4j_tpu_torch.runtime import chaos, trace

logger = logging.getLogger(__name__)

#: Framework key of the build directory: a library is reusable only within
#: one PyTorch/CUDA build for one architecture, so they are in the path.
FRAMEWORK_KEY = "dl4j-tpu-torch-v1"
ARCH = "sm_90a"


class CompileCacheStats:
    """Thread-safe counters of the build cache and the captured graphs."""

    def __init__(self):
        # guards: hits, misses, corrupt_entries, compiles, compile_seconds, aot_compiles, aot_compile_seconds, aot_fallbacks, aot_replays
        self._lock = threading.Lock()
        self._zero()

    def _zero(self):  # holds: _lock (or pre-sharing, from __init__)
        self.hits = 0               # libraries loaded as already built
        self.misses = 0             # absent -> nvcc
        self.corrupt_entries = 0    # unloadable library -> rebuilt
        self.compiles = 0           # nvcc runs
        self.compile_seconds = 0.0  # their wall time
        self.aot_compiles = 0       # graphs captured
        self.aot_compile_seconds = 0.0
        self.aot_fallbacks = 0      # signature drift -> eager step
        self.aot_replays = 0        # graph replays

    def reset(self):
        with self._lock:
            self._zero()

    def record(self, field: str, dt: float = 0.0):
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)
            if field == "compiles":
                self.compile_seconds += dt
            elif field == "aot_compiles":
                self.aot_compile_seconds += dt

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": is_enabled(),
                "cache_dir": _cache_dir,
                "hits": self.hits,
                "misses": self.misses,
                "corrupt_entries": self.corrupt_entries,
                "compiles": self.compiles,
                "compile_seconds": round(self.compile_seconds, 4),
                "aot_compiles": self.aot_compiles,
                "aot_compile_seconds": round(self.aot_compile_seconds, 4),
                "aot_fallbacks": self.aot_fallbacks,
                "aot_replays": self.aot_replays,
            }


STATS = CompileCacheStats()

_cache_dir: Optional[str] = None


def stats() -> Dict[str, Any]:
    """Process-wide build-cache and graph counters (also
    ``runtime.profiler.compile_cache_stats``)."""
    return STATS.snapshot()


def reset_stats() -> None:
    STATS.reset()


def is_enabled() -> bool:
    return _cache_dir is not None


def cache_dir() -> Optional[str]:
    return _cache_dir


def framework_dirname() -> str:
    return f"{FRAMEWORK_KEY}-torch{torch.__version__}-cuda{torch.version.cuda}-{ARCH}"


def enable(directory: Optional[str] = None) -> str:
    """Build and load the kernels under ``directory`` (default: the
    ``DL4J_TPU_COMPILE_CACHE`` variable), in its framework-keyed
    subdirectory, which is returned. Safe to call again with another
    directory; libraries already loaded stay loaded."""
    global _cache_dir
    base = directory or os.environ.get("DL4J_TPU_COMPILE_CACHE")
    if not base:
        raise ValueError("compile_cache.enable() needs a directory (or set "
                         "DL4J_TPU_COMPILE_CACHE)")
    resolved = os.path.join(os.path.abspath(os.path.expanduser(base)), framework_dirname())
    os.makedirs(resolved, exist_ok=True)
    _cache_dir = resolved
    logger.info("kernel build cache at %s", resolved)
    return resolved


def disable() -> None:
    """Back to the default build directory (counters stay)."""
    global _cache_dir
    _cache_dir = None


def load_library(path, build):
    """Load the built library at ``path`` (a :class:`pathlib.Path`) with
    ctypes, building it first when absent (``build()`` runs nvcc and puts
    the library there). An unloadable file is a corrupt entry: counted,
    deleted and built again."""
    import ctypes
    if path.exists():
        try:
            chaos.inject("runtime.compile_cache.load")
            lib = ctypes.CDLL(str(path))
            STATS.record("hits")
            return lib
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # a truncated .so raises OSError
            STATS.record("corrupt_entries")
            logger.warning("kernel cache: %s unloadable (%s: %s); rebuilding",
                           path.name, type(e).__name__, e)
            path.unlink(missing_ok=True)
    STATS.record("misses")
    build()
    return ctypes.CDLL(str(path))


# --------------------------------------------------------------------- AOT
def aot_enabled() -> bool:
    from deeplearning4j_tpu_torch.runtime.environment import get_environment
    return bool(get_environment().aot_dispatch)


def _flatten(tree, out: List[Any]) -> None:
    if isinstance(tree, (list, tuple)):
        for v in tree:
            _flatten(v, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    else:
        out.append(tree)


def _rebuild(tree, it):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    if isinstance(tree, dict):
        vals = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    return next(it)


def _fits(static, new, baked: bool) -> bool:
    """Whether ``new`` may take ``static``'s place: a tensor of the same
    shape, dtype and device; else, in a graph (``baked``), the same object
    or an equal plain value, and otherwise a value of the same type."""
    if isinstance(static, torch.Tensor):
        return (isinstance(new, torch.Tensor) and new.shape == static.shape
                and new.dtype == static.dtype and new.device == static.device)
    if isinstance(new, torch.Tensor) or type(new) is not type(static):
        return False
    if not baked or new is static:
        return True
    return isinstance(new, (int, float, bool, str)) and new == static


def _clone_out(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (list, tuple)):
        return type(out)(_clone_out(v) for v in out)
    return out


class _Entry:
    """Static input buffers of one key and, on a CUDA device once captured,
    its graph, its static outputs and the launches its capture recorded."""

    __slots__ = ("tree", "static", "cuda", "graph", "out", "launches")

    def __init__(self, args):
        leaves: List[Any] = []
        _flatten(args, leaves)
        self.tree = args
        self.static = [t.detach().clone() if isinstance(t, torch.Tensor) else t
                       for t in leaves]
        self.cuda = any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves)
        self.graph = None
        self.out = None
        self.launches: Dict[Any, int] = {}

    def load(self, args) -> bool:
        """Copy ``args`` into the static buffers; False on signature drift
        (nothing copied)."""
        leaves: List[Any] = []
        _flatten(args, leaves)
        if len(leaves) != len(self.static) or not all(
                _fits(s, n, self.cuda) for s, n in zip(self.static, leaves)):
            return False
        for i, (s, n) in enumerate(zip(self.static, leaves)):
            if isinstance(s, torch.Tensor):
                if n is not s:
                    s.copy_(n)
            elif not self.cuda:
                self.static[i] = n  # called, not replayed: the current value
        return True

    def args(self):
        return _rebuild(self.tree, iter(self.static))


class AotCache:
    """Captured CUDA graphs for ONE call site, one per caller-owned key.

    ``call(key, fn, *args)`` runs ``fn(*args)``. On a CUDA device, at the
    first sight of ``key``, the arguments are cloned into static buffers.
    When the cache has not yet run ``fn`` on tensors of these shapes, ``fn``
    runs eagerly on the buffers on the cache's side stream (the warm-up: it
    is that call's step; cuBLAS and cuDNN make their lazy choices there),
    and the next call captures; otherwise (a group of K steps whose step
    shapes a single step has warmed) the first call captures. A capture
    copies the arguments into the buffers and records ``fn``
    (``torch.cuda.graph`` on the same side stream, in the memory pool its
    live graphs share, with :attr:`generators` registered so that every replay draws
    fresh numbers), then replays it; every later call copies and replays.
    Outputs are cloned after a replay, since the next replay overwrites the
    graph's own. A launch counter of ``ops/kernels/_native.py`` counts in
    Python, so at capture time: the capture's count is taken back and each
    replay adds it.

    On the CPU the same static-buffer protocol runs, but ``fn`` is called
    on the buffers instead of a replay.

    ``fn`` must keep its state in place (the graph reads and writes fixed
    addresses) and must not read the device from the host. The caller's key
    must change when the state ``fn`` reads moves (see
    :class:`~.state_packing.PackedStepLoop`). Not locked: every call site
    dispatches from one thread.
    """

    __slots__ = ("name", "_entries", "_stream", "_warm", "generators")

    def __init__(self, name: str = ""):
        self.name = name
        self._entries: Dict[Hashable, _Entry] = {}
        self._stream = None
        self._warm: set = set()  # (shape, dtype) of the tensors run eagerly here
        #: CUDA generators the captured functions draw from
        self.generators: List[torch.Generator] = []

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self._warm.clear()

    def evict(self, pred) -> int:
        """Drop every entry whose key satisfies ``pred``; returns how many.
        A replay already launched is unaffected."""
        dead = [k for k in list(self._entries) if pred(k)]
        for k in dead:
            self._entries.pop(k, None)
        return len(dead)

    def call(self, key: Hashable, fn, *args):
        if not aot_enabled():
            return fn(*args)
        entry = self._entries.get(key)
        trace.annotate_current("aot", "hit" if entry is not None else "miss")
        if entry is None:
            entry = _Entry(args)
            self._entries[key] = entry
            if not entry.cuda:
                return fn(*entry.args())
            shapes = {(tuple(t.shape), t.dtype) for t in entry.static
                      if isinstance(t, torch.Tensor)}
            if not shapes <= self._warm:
                self._warm |= shapes
                return self._warm_up(fn, entry)
        if not entry.load(args):
            self._entries.pop(key, None)
            STATS.record("aot_fallbacks")
            logger.debug("AotCache(%s): signature drift at key %r; eager step",
                         self.name, key)
            return fn(*args)
        if not entry.cuda:
            return fn(*entry.args())
        if entry.graph is None:
            self._capture(fn, entry)
        return self._replay(entry)

    # ------------------------------------------------------------ CUDA side
    def _side_stream(self, device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=device)
        return self._stream

    def _warm_up(self, fn, entry: _Entry):
        dev = next(t.device for t in entry.static if isinstance(t, torch.Tensor) and t.is_cuda)
        s = self._side_stream(dev)
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            out = fn(*entry.args())
        torch.cuda.current_stream(dev).wait_stream(s)
        return out

    def _capture(self, fn, entry: _Entry) -> None:
        from deeplearning4j_tpu_torch.ops.kernels import _native
        dev = next(t.device for t in entry.static if isinstance(t, torch.Tensor) and t.is_cuda)
        s = self._side_stream(dev)
        # share the pool of a graph that is still alive; once every graph of
        # the cache is gone its pool is released, and its id must not be
        # captured into again (the allocator asserts), so a fresh one
        live = [e.graph for e in self._entries.values() if e.graph is not None]
        pool = live[0].pool() if live else torch.cuda.graph_pool_handle()
        g = torch.cuda.CUDAGraph()
        for gen in self.generators:
            g.register_generator_state(gen)
        before = _native.counter_values()
        t0 = time.perf_counter()
        s.wait_stream(torch.cuda.current_stream(dev))
        # a graph that the cyclic garbage collector destroyed mid-capture would
        # invalidate it (no graph may be freed while a stream captures): collect
        # before, and not during
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the completion thread of the fit may read an
            # earlier step's loss meanwhile, which a process-wide capture
            # would refuse
            with torch.cuda.graph(g, pool=pool, stream=s, capture_error_mode="thread_local"):
                out = fn(*entry.args())
        finally:
            if collecting:
                gc.enable()
        STATS.record("aot_compiles", time.perf_counter() - t0)
        after = _native.counter_values()
        entry.launches = {c: after[c] - before.get(c, 0) for c in after
                          if after[c] != before.get(c, 0)}
        for c, n in entry.launches.items():
            c.add(-n)  # the capture launched nothing
        entry.graph, entry.out = g, out

    def _replay(self, entry: _Entry):
        entry.graph.replay()
        STATS.record("aot_replays")
        for c, n in entry.launches.items():
            c.add(n)
        return _clone_out(entry.out)
