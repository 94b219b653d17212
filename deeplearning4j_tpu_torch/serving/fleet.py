"""Fleet worker lifecycle: supervised ``ModelServer`` processes
(counterpart of ``deeplearning4j_tpu/serving/fleet.py``, with the same spec
file, port and heartbeat files, journal events and restart budget).

The :class:`~deeplearning4j_tpu_torch.serving.router.FleetRouter` routes;
this module owns the processes it routes *to*. It is the
:class:`~deeplearning4j_tpu_torch.train.distributed.DistributedSupervisor`
pattern one level up the serving stack — heartbeat-file + exit-code
watchdog, budgeted restarts, leak-guarded worker pids — with one key
difference: serving workers are independent fault domains, so a dead
worker is restarted *alone* while its peers keep taking traffic (an SPMD
training group, by contrast, restarts whole).

- :class:`WorkerSpec` — everything one worker process needs: archive,
  model name/version, batcher knobs, the device it serves on (``cuda``
  unless the spec asks for the CPU), the shared kernel build directory,
  and an optional deterministic straggler schedule (seeded
  ``AddLatency(p=...)`` on ``serving.worker.predict`` — the injected tail
  latency a router hedges against).
- :class:`FleetSupervisor` — spawns one subprocess per spec (``python -m
  deeplearning4j_tpu_torch.serving.fleet <spec.json>``), waits for each
  worker's port file (written only after the registry is loaded and
  manifest-warmed, so "port known" means "ready"), watches exit codes
  and heartbeat files, and relaunches a crashed or stalled worker within
  a restart budget (`TrainingFailure` escalation when exhausted).
  ``restart_worker`` is the *intentional* relaunch (graceful SIGTERM →
  worker drains its registry and refreshes the warmup manifest → spawn on
  the new archive) that :meth:`FleetRouter.rolling_deploy` drives;
  ``kill_worker`` is the chaos drill's SIGKILL.
- Worker pids launched here register in a module-level table
  (:func:`live_worker_pids` / :func:`kill_stray_workers`) that a test's
  leak guard polls, so no orphaned serving worker survives a test.

A worker process serves on the device its spec names: ``cuda`` by
default, where it raises before it is ready if no GPU is visible (there
is no CPU fallback); ``"cpu"`` only when asked. It inherits the parent's
kernel build directory (``DL4J_TPU_COMPILE_CACHE``), so it loads the
libraries the parent built and runs no ``nvcc``. At graceful drain it
writes its process's kernel launch counts next to its port file
(``<worker_id>.<pid>.launches.json``): the launches a worker makes are
counted in its own process, never in the parent's counters.

Multi-host fleets: ``WorkerSpec.host`` names the machine a worker lives
on, resolved through a :class:`HostAdapter` — the per-host spawn/address
seam over the ``runtime/mesh.py`` bring-up machinery
(:class:`~deeplearning4j_tpu_torch.runtime.mesh.HostSpec`). The default
``"local"`` adapter is this machine; ``loopback`` adapters are
same-machine stand-ins that let tests and drills exercise the multi-host
spawn/watchdog/endpoint paths without real remote machines; a real
remote adapter needs only ``spawn`` + ``address``. The supervisor can
also PUBLISH its live roster into a shared
:class:`~deeplearning4j_tpu_torch.serving.control_plane.FleetConfig` so N
replicated routers discover workers from one versioned file instead of
holding a supervisor reference.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.runtime import journal, trace

logger = logging.getLogger(__name__)

# -------------------------------------------------------------------------
# worker-pid registry (a test's process-leak guard polls this, exactly like
# train.distributed's)
class PidRegistry:
    """Subprocess bookkeeping for one supervised tier (fleet workers
    here; router processes in ``serving/control_plane.py`` instantiate
    their own): track spawned children, poll the live set, kill
    strays/orphans with one wait-and-prune discipline. ``active`` holds
    the tier's RUNNING supervisors (``start()``..``stop()``) — their
    children are MANAGED, not leaked, so the per-test leak guard flags
    only orphans (a module-scoped fixture fleet must survive another
    test's cleanup)."""

    def __init__(self):
        self._lock = threading.Lock()  # guards: _children
        self._children: List[subprocess.Popen] = []
        self.active: List[Any] = []   # running supervisors of this tier

    def track(self, proc: subprocess.Popen) -> None:
        with self._lock:
            self._children.append(proc)

    def live_pids(self) -> List[int]:
        with self._lock:
            self._children[:] = [p for p in self._children
                                 if p.poll() is None]
            return [p.pid for p in self._children]

    def _kill(self, pids: Optional[set] = None) -> List[int]:
        with self._lock:
            stray = [p for p in self._children if p.poll() is None
                     and (pids is None or p.pid in pids)]
            for p in stray:
                try:
                    p.kill()
                except OSError:
                    pass
            for p in stray:
                try:
                    p.wait(timeout=10)
                except Exception:
                    pass
            self._children[:] = [p for p in self._children
                                 if p.poll() is None]
        return [p.pid for p in stray]

    def kill_stray(self) -> List[int]:
        """Kill EVERY still-live tracked child (teardown of last resort)."""
        return self._kill()

    def orphaned_pids(self) -> List[int]:
        """Live tracked pids NOT owned by any active supervisor — what
        a test's leak guard polls."""
        managed = set()
        for sup in list(self.active):
            managed.update(sup.managed_pids())
        return [pid for pid in self.live_pids() if pid not in managed]

    def kill_orphaned(self) -> List[int]:
        """Kill only the ORPHANED children; never a live supervisor's."""
        return self._kill(set(self.orphaned_pids()))


_registry = PidRegistry()


def _track_child(proc: subprocess.Popen) -> None:
    _registry.track(proc)


def live_worker_pids() -> List[int]:
    """PIDs of fleet worker subprocesses launched through this module that
    are still alive — polled by a test's leak guard after every test."""
    return _registry.live_pids()


def kill_stray_workers() -> List[int]:
    """Kill any still-live tracked workers (leak-guard teardown); returns
    the PIDs that had to be killed."""
    return _registry.kill_stray()


def orphaned_worker_pids() -> List[int]:
    """Live tracked worker pids NOT owned by any active supervisor — what
    a test's leak guard polls (a supervised fixture fleet is fine; a
    worker that outlived its supervisor is a leak)."""
    return _registry.orphaned_pids()


def kill_orphaned_workers() -> List[int]:
    """Kill only the ORPHANED tracked workers (leak-guard teardown); a
    managed fixture fleet mid-suite must survive another test's leak, so
    this never touches a live supervisor's children. Returns killed pids."""
    return _registry.kill_orphaned()


#: the tier's running supervisors (see PidRegistry.active)
_active_supervisors = _registry.active


def _worker_env(spec: "WorkerSpec") -> Dict[str, str]:
    """Subprocess env for a fleet worker: this one with the repository on
    ``PYTHONPATH`` (the contract proven by the multi-process training
    workers), and the kernel build directory this process loads from
    passed down as ``DL4J_TPU_COMPILE_CACHE`` — a worker then loads the
    libraries already built here instead of running ``nvcc`` itself."""
    from deeplearning4j_tpu_torch.runtime import compile_cache
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    built = compile_cache.cache_dir()
    if built:
        # the framework-keyed subdirectory is appended again by enable()
        env["DL4J_TPU_COMPILE_CACHE"] = os.path.dirname(built)
    return env


# -------------------------------------------------------------------------
# host adapters: the per-host seam the supervisor spawns and
# watches workers through. An adapter answers two questions — "launch this
# argv on your machine" (returning a Popen-compatible handle the watchdog
# polls/kills) and "at what address are your workers reachable". The
# mesh-level description of the host roster is
# ``runtime.mesh.HostSpec`` / ``runtime.mesh.loopback_hosts`` (kept there,
# next to MeshSpec, because the same roster seeds the multi-host training
# bring-up); this module holds the process-spawning side so it stays
# importable without torch's device side.
class HostAdapter:
    """One machine's process bring-up. ``name`` is what
    :attr:`WorkerSpec.host` references; ``address`` is the host part of
    every endpoint this host's workers serve on."""

    name = "local"
    address = "127.0.0.1"

    def spawn(self, argv: List[str], env: Dict[str, str],
              stdout, stderr) -> subprocess.Popen:
        raise NotImplementedError

    def describe(self) -> Dict[str, str]:
        return {"name": self.name, "address": self.address,
                "kind": type(self).__name__}


class LocalHostAdapter(HostAdapter):
    """This machine (the default): plain subprocess spawn."""

    def spawn(self, argv, env, stdout, stderr) -> subprocess.Popen:
        return subprocess.Popen(argv, env=env, stdout=stdout,
                                stderr=stderr, text=True)


class LoopbackHostAdapter(LocalHostAdapter):
    """A NAMED same-machine "host": processes spawn locally but carry a
    distinct host identity, so tests and drills drive the multi-host
    spawn/watchdog/endpoint paths (per-host adapters, host-qualified
    endpoints, host-spread placement) without remote machines — the
    serving twin of the ``local[N]`` Spark-master trick."""

    def __init__(self, name: str, address: str = "127.0.0.1"):
        self.name = str(name)
        self.address = str(address)


def resolve_host_adapters(specs: List["WorkerSpec"],
                          hosts=None) -> Dict[str, HostAdapter]:
    """The ``{host_name: adapter}`` map for a fleet: ``hosts`` may carry
    :class:`HostAdapter` instances or ``runtime.mesh.HostSpec``-shaped
    records (``.name``/``.address``/``.spawn``); every host a spec
    references must resolve (``"local"`` always does), so a typo'd host
    fails at supervisor construction, not at first relaunch."""
    out: Dict[str, HostAdapter] = {"local": LocalHostAdapter()}
    for h in (hosts or []) if not isinstance(hosts, dict) else hosts.values():
        if isinstance(h, HostAdapter):
            out[h.name] = h
            continue
        name = getattr(h, "name", None)
        spawn = getattr(h, "spawn", "loopback")
        if name is None:
            raise TypeError(f"not a host adapter or HostSpec: {h!r}")
        if spawn in ("loopback", "local"):
            out[str(name)] = LoopbackHostAdapter(
                str(name), getattr(h, "address", "127.0.0.1"))
        else:
            raise NotImplementedError(
                f"host {name!r} wants spawn={spawn!r}; only local/loopback "
                f"adapters ship — a remote adapter implements "
                f"HostAdapter.spawn over its own transport")
    missing = sorted({getattr(s, "host", "local") for s in specs} - set(out))
    if missing:
        raise ValueError(f"worker specs reference unknown host(s) "
                         f"{missing}; pass adapters via hosts=")
    return out


# -------------------------------------------------------------------------
@dataclasses.dataclass
class WorkerSpec:
    """One worker process's configuration (JSON-serializable; the spec
    file IS the worker's argv)."""

    worker_id: str
    model_name: str
    archive: str
    version: Optional[int] = None
    batcher_kw: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: manifest-style input signature ({name|"__single__": {"shape_tail",
    #: "dtype"}}) used to build a zeros warmup example on a FIRST launch,
    #: before any warmup manifest exists next to the archive. Replays of a
    #: recorded manifest take precedence (they know the real bucket set).
    warmup_signature: Optional[Dict[str, Any]] = None
    cache_dir: Optional[str] = None          # shared persistent compile cache
    straggle: Optional[Dict[str, Any]] = None  # {"p", "ms", "seed"[, "point"]}
    #: HBM-budgeted paging: resident-byte ceiling for this
    #: worker's registry (None = env knob / measured budget / unbounded)
    hbm_budget_bytes: Optional[int] = None
    #: additional archives registered COLD ({name: archive_path}): zero
    #: HBM until first request, paged in on demand under the budget —
    #: a fleet where every worker KNOWS every model but each is resident
    #: only where traffic placed it
    extra_models: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: session tier: spill directory for streaming-session
    #: carries. The WHOLE fleet must share one directory — migration is a
    #: new worker rehydrating a spill some other worker wrote. ``None``
    #: keeps sessions off; ``""`` asks the supervisor for its fleet-shared
    #: default (``run_dir/sessions``). Needs a recurrent primary model.
    session_dir: Optional[str] = None
    #: the one fixed padded batch size every session step executes at
    session_bucket: int = 8
    #: SessionStore knobs (idle_ttl_s, byte_budget_bytes, ...)
    session_kw: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: which machine this worker lives on: the name of a
    #: :class:`HostAdapter` registered with the supervisor ("local" =
    #: this machine; loopback adapters are the tests' multi-host stand-in)
    host: str = "local"
    #: the device the worker serves on: ``cuda`` (the default; the worker
    #: raises before it is ready when no GPU is visible) or ``cpu``
    device: str = "cuda"
    heartbeat_interval_s: float = 0.5

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class _WorkerHandle:
    def __init__(self, spec: WorkerSpec, run_dir: str):
        self.spec = spec
        self.run_dir = run_dir
        self.spec_path = os.path.join(run_dir, f"{spec.worker_id}.spec.json")
        self.port_file = os.path.join(run_dir, f"{spec.worker_id}.port.json")
        self.heartbeat_file = os.path.join(run_dir, f"{spec.worker_id}.hb")
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.stopping = False    # intentional stop/restart in progress
        self.relaunching = False  # watchdog relaunch in progress
        self.dead = False        # restart budget exhausted; left down
        self.restarts = 0
        self.generation = 0

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class FleetSupervisor:
    """Launch + watch + restart N independent serving workers.

    ``specs`` is a list of :class:`WorkerSpec`. The restart budget
    (``max_restarts`` within ``restart_window_s``, lifetime when None) is
    shared across the fleet — a crash-looping fleet escalates with
    :class:`~deeplearning4j_tpu_torch.train.fault_tolerance.TrainingFailure`
    (surfaced by :meth:`check`) instead of flapping forever. Intentional
    restarts (:meth:`restart_worker`, the rolling-deploy path) do not
    consume the budget.
    """

    #: subprocess entry module + pid/active registries — class seams so
    #: RouterSupervisor (serving/control_plane.py: the same supervisor
    #: pattern one level up, over router processes) reuses this machinery
    #: wholesale while keeping its own leak-guard population
    _worker_module = "deeplearning4j_tpu_torch.serving.fleet"

    @staticmethod
    def _spawn_env(spec) -> Dict[str, str]:
        return _worker_env(spec)

    @staticmethod
    def _track(proc: subprocess.Popen) -> None:
        _track_child(proc)

    @staticmethod
    def _active_list() -> List["FleetSupervisor"]:
        return _active_supervisors

    def __init__(self, specs: List[WorkerSpec], run_dir: Optional[str] = None,
                 max_restarts: int = 3,
                 restart_window_s: Optional[float] = None,
                 heartbeat_timeout_s: float = 30.0,
                 ready_timeout_s: float = 180.0,
                 poll_s: float = 0.2,
                 hosts=None,
                 config=None):
        ids = [s.worker_id for s in specs]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate worker ids: {ids}")
        self._hosts = resolve_host_adapters(specs, hosts)
        #: a shared FleetConfig-shaped object (``set_workers(endpoints)``)
        #: the supervisor publishes its live roster into on every change —
        #: what replicated routers read instead of holding a
        #: supervisor reference
        self._config = config
        self._own_run_dir = run_dir is None
        self.run_dir = run_dir or tempfile.mkdtemp(prefix="dl4j-fleet-")
        os.makedirs(self.run_dir, exist_ok=True)
        for s in specs:
            # "" = "the fleet-shared default": every worker spilling into
            # one directory is what makes drain-by-migration work
            if getattr(s, "session_dir", None) == "":
                s.session_dir = os.path.join(self.run_dir, "sessions")
        shared_spills = {s.session_dir for s in specs
                         if getattr(s, "session_dir", None)}
        for d in sorted(shared_spills):
            os.makedirs(d, exist_ok=True)
        self._handles: Dict[str, _WorkerHandle] = {
            s.worker_id: _WorkerHandle(s, self.run_dir) for s in specs}
        self.max_restarts = int(max_restarts)
        self.restart_window_s = restart_window_s
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.ready_timeout_s = float(ready_timeout_s)
        self.poll_s = float(poll_s)
        self.restarts = 0
        self._restart_times: deque = deque()
        self._failure: Optional[BaseException] = None
        # spawn/restart/retire serialization: closes the watchdog-vs-
        # deploy double-spawn race and covers _handles roster mutations
        # guards: (spawn/restart/retire serialization)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None

    # ------------------------------------------------------------- spawning
    def _spawn(self, handle: _WorkerHandle) -> None:
        for stale in (handle.port_file, handle.heartbeat_file):
            try:
                os.unlink(stale)
            except OSError:
                pass
        spec = handle.spec.to_dict()
        spec["port_file"] = handle.port_file
        spec["heartbeat_file"] = handle.heartbeat_file
        with open(handle.spec_path, "w") as f:
            json.dump(spec, f, indent=2)
        # output to temp FILES, not pipes (a chatty worker must not block
        # on a full pipe buffer and read as a stalled straggler)
        out_f = tempfile.NamedTemporaryFile(
            mode="w+", prefix=f"dl4j-fleet-{handle.spec.worker_id}-out-",
            dir=self.run_dir, delete=False)
        err_f = tempfile.NamedTemporaryFile(
            mode="w+", prefix=f"dl4j-fleet-{handle.spec.worker_id}-err-",
            dir=self.run_dir, delete=False)
        adapter = self._hosts[getattr(handle.spec, "host", "local")]
        proc = adapter.spawn(
            [sys.executable, "-m", self._worker_module, handle.spec_path],
            env=self._spawn_env(handle.spec), stdout=out_f, stderr=err_f)
        proc._dl4j_capture = (out_f, err_f)  # type: ignore[attr-defined]
        self._track(proc)
        handle.proc = proc
        handle.port = None
        handle.generation += 1
        # every process bring-up is a journal event: initial
        # start, watchdog relaunch and deploy restart all leave a record
        journal.emit("fleet.worker_spawn",
                     worker=handle.spec.worker_id, pid=proc.pid,
                     generation=handle.generation,
                     host=getattr(handle.spec, "host", "local"))

    @staticmethod
    def _stderr_tail(handle: _WorkerHandle, n: int = 2000) -> str:
        try:
            _, err_f = getattr(handle.proc, "_dl4j_capture", (None, None))
            err_f.flush()
            err_f.seek(0, os.SEEK_END)
            size = err_f.tell()
            err_f.seek(max(0, size - n))
            return err_f.read()
        except Exception:
            return "<no stderr captured>"

    def _wait_port(self, handle: _WorkerHandle,
                   timeout_s: Optional[float] = None) -> int:
        """Block until the worker writes its port file (it does so only
        AFTER the registry is loaded and warmed — ready, not just alive)."""
        timeout_s = self.ready_timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if handle.proc.poll() is not None:
                raise RuntimeError(
                    f"fleet worker {handle.spec.worker_id!r} exited "
                    f"rc={handle.proc.returncode} before becoming ready:\n"
                    f"{self._stderr_tail(handle)}")
            try:
                with open(handle.port_file) as f:
                    info = json.load(f)
                if info.get("pid") == handle.proc.pid:
                    handle.port = int(info["port"])
                    return handle.port
            except (OSError, ValueError):
                pass
            time.sleep(0.05)
        handle.proc.kill()
        raise RuntimeError(
            f"fleet worker {handle.spec.worker_id!r} not ready after "
            f"{timeout_s:.0f}s:\n{self._stderr_tail(handle)}")

    def start(self) -> "FleetSupervisor":
        """Spawn every worker (concurrently — warmups overlap), wait for
        all to become ready, then start the watchdog. A worker failing to
        come up kills the whole just-spawned group before raising —
        a failed start must not leak processes."""
        with self._lock:
            for handle in self._handles.values():
                self._spawn(handle)
        try:
            for handle in self._handles.values():
                self._wait_port(handle)
        except BaseException:
            for handle in self._handles.values():
                if handle.alive():
                    handle.proc.kill()
                    try:
                        handle.proc.wait(timeout=10)
                    except Exception:
                        pass
                self._close_capture(handle)
            raise
        self._stop.clear()
        self._watchdog = threading.Thread(target=self._watch, daemon=True,
                                          name="FleetSupervisor")
        self._watchdog.start()
        if self not in self._active_list():
            self._active_list().append(self)
        self._publish_roster()
        return self

    # ------------------------------------------------------------ fleet API
    def managed_pids(self) -> List[int]:
        """PIDs of this supervisor's currently-live workers."""
        with self._lock:
            return [h.proc.pid for h in self._handles.values() if h.alive()]

    def endpoints(self) -> Dict[str, str]:
        """``{worker_id: "host:port"}`` for every worker that is alive
        with a known port (the router's view of the fleet). The host part
        comes from the worker's host adapter, so a multi-host fleet's
        endpoints point at the right machines."""
        out = {}
        with self._lock:
            for wid, h in self._handles.items():
                if h.port is not None and h.alive() and not h.stopping:
                    adapter = self._hosts[getattr(h.spec, "host", "local")]
                    out[wid] = f"{adapter.address}:{h.port}"
        return out

    def hosts(self) -> Dict[str, Dict[str, str]]:
        """The resolved host roster (``{name: describe()}``) plus each
        host's live worker ids — the multi-host topology surface."""
        with self._lock:
            per_host: Dict[str, List[str]] = {}
            for wid, h in self._handles.items():
                per_host.setdefault(
                    getattr(h.spec, "host", "local"), []).append(wid)
        return {name: {**adapter.describe(),
                       "workers": sorted(per_host.get(name, []))}
                for name, adapter in sorted(self._hosts.items())}

    def _publish_roster(self) -> None:
        """Best-effort push of the live endpoints into the shared fleet
        config (when attached) — called on every membership change so N
        shared-nothing routers converge on the roster within one config
        read. Publication must never take the fleet down."""
        if self._config is None:
            return
        try:
            self._config.set_workers(self.endpoints())
        except Exception:
            logger.exception("fleet roster publication failed")

    def worker_ids(self) -> List[str]:
        return sorted(self._handles)

    def worker_archive(self, worker_id: str) -> str:
        """The archive ``worker_id`` currently runs (its spec's view) —
        what a gated deploy's rollback restores the canary onto."""
        with self._lock:
            return self._handles[worker_id].spec.archive

    def check(self) -> None:
        """Raise the stored escalation (restart budget exhausted), if any."""
        if self._failure is not None:
            raise self._failure

    def kill_worker(self, worker_id: str) -> int:
        """SIGKILL a worker (the chaos drill). The watchdog notices the
        exit and restarts it within the budget. Returns the killed pid.

        The kill is the first event of an incident timeline,
        so it gets its own flagged trace span — the journal event is
        trace-linked like the breaker/failover events that follow it."""
        handle = self._handles[worker_id]
        pid = handle.proc.pid
        sp = trace.span("fleet.kill") if trace.enabled() else trace.NOOP
        with sp:
            if sp.recording:
                sp.flag("fleet")
                sp.set("worker", worker_id)
            journal.emit("fleet.worker_kill", worker=worker_id, pid=pid)
            handle.proc.kill()
        return pid

    def restart_worker(self, worker_id: str, archive: Optional[str] = None,
                       version: Optional[int] = None,
                       stop_timeout_s: float = 30.0) -> int:
        """Intentional relaunch (the rolling-deploy step): graceful
        SIGTERM (the worker drains its registry, refreshing the warmup
        manifest), then spawn — on ``archive``/``version`` when given —
        and wait ready. Does not consume the restart budget."""
        handle = self._handles[worker_id]
        # claim the handle under the lock: the watchdog sets `relaunching`
        # under the same lock before acting on a crash, so exactly one of
        # the two paths owns the handle — no double spawn
        with self._lock:
            handle.stopping = True
        # a watchdog crash-relaunch of this worker may be mid-flight
        # (spawned, waiting for the port file); let it settle before
        # replacing the process, or two children race for one handle
        settle = time.monotonic() + self.ready_timeout_s
        while handle.relaunching and time.monotonic() < settle:
            time.sleep(0.05)
        try:
            if handle.alive():
                handle.proc.terminate()
                try:
                    handle.proc.wait(timeout=stop_timeout_s)
                except subprocess.TimeoutExpired:
                    logger.warning("worker %s ignored SIGTERM; killing",
                                   worker_id)
                    handle.proc.kill()
                    handle.proc.wait(timeout=10)
            self._close_capture(handle)
            if archive is not None:
                handle.spec.archive = archive
            if version is not None:
                handle.spec.version = version
            journal.emit("fleet.worker_restart", worker=worker_id,
                         cause="intentional", archive=archive,
                         version=version)
            with self._lock:
                self._spawn(handle)
            port = self._wait_port(handle)
        finally:
            handle.stopping = False
        self._publish_roster()
        return port

    def clone_spec(self, worker_id: str, new_worker_id: str) -> WorkerSpec:
        """A deep copy of ``worker_id``'s CURRENT spec (post any rolling
        deploy) under a fresh id — what the SLO autoscaler's worker lever
        spawns. The clone shares the archive, batcher knobs
        and persistent compile cache, so it comes up manifest-prewarmed
        exactly like a rolling-deploy relaunch."""
        spec = copy.deepcopy(self._handles[worker_id].spec)
        spec.worker_id = str(new_worker_id)
        return spec

    def add_worker(self, spec: WorkerSpec,
                   ready_timeout_s: Optional[float] = None) -> int:
        """Grow the fleet by one worker at runtime (the
        autoscaler's fleet lever). Spawns ``spec``, blocks until its port
        file says ready (registry loaded + manifest-warmed), and hands it
        to the running watchdog; the router's ``/readyz`` prober admits
        it on its next cycle. Returns the worker's port."""
        if getattr(spec, "host", "local") not in self._hosts:
            raise ValueError(f"worker spec references unknown host "
                             f"{spec.host!r}; known: {sorted(self._hosts)}")
        with self._lock:
            if spec.worker_id in self._handles:
                raise ValueError(f"worker id {spec.worker_id!r} already "
                                 f"exists in this fleet")
            handle = _WorkerHandle(spec, self.run_dir)
            self._handles[spec.worker_id] = handle
            self._spawn(handle)
        try:
            port = self._wait_port(handle, ready_timeout_s)
            self._publish_roster()
            return port
        except BaseException:
            with self._lock:
                self._handles.pop(spec.worker_id, None)
            if handle.alive():
                handle.proc.kill()
                try:
                    handle.proc.wait(timeout=10)
                except Exception:
                    pass
            self._close_capture(handle)
            raise

    def remove_worker(self, worker_id: str,
                      stop_timeout_s: float = 30.0) -> None:
        """Retire one worker from the fleet (the autoscaler's scale-down
        unwind): graceful SIGTERM — the worker drains its registry and
        refreshes the warmup manifest — escalating to SIGKILL, then the
        handle is dropped so the watchdog never resurrects it. The
        router's view reconciles on its next probe cycle."""
        with self._lock:
            handle = self._handles.get(worker_id)
            if handle is None:
                raise KeyError(f"unknown worker {worker_id!r}")
            handle.stopping = True
        settle = time.monotonic() + self.ready_timeout_s
        while handle.relaunching and time.monotonic() < settle:
            time.sleep(0.05)
        if handle.alive():
            handle.proc.terminate()
            try:
                handle.proc.wait(timeout=stop_timeout_s)
            except subprocess.TimeoutExpired:
                logger.warning("worker %s ignored SIGTERM on retire; "
                               "killing", worker_id)
                handle.proc.kill()
                try:
                    handle.proc.wait(timeout=10)
                except Exception:
                    pass
        self._close_capture(handle)
        with self._lock:
            self._handles.pop(worker_id, None)
        journal.emit("fleet.worker_retire", worker=worker_id)
        self._publish_roster()

    def prewarm_manifest(self, archive: str) -> Optional[str]:
        """Ensure ``archive`` has a warmup manifest before a rolling
        deploy: when it has none, copy a live worker's current-archive
        manifest next to it (same model family — the recorded buckets /
        input signature are what the replacement must pre-warm). This is
        what makes readmission compile-free together with the shared
        persistent executable cache."""
        from deeplearning4j_tpu_torch.serving.manifest import manifest_path
        target = manifest_path(archive)
        if os.path.exists(target):
            return target
        for handle in self._handles.values():
            src = manifest_path(handle.spec.archive)
            if os.path.exists(src) and os.path.abspath(src) != \
                    os.path.abspath(target):
                shutil.copyfile(src, target)
                return target
        return None

    # ------------------------------------------------------------- watchdog
    def _register_restart(self, cause: str) -> None:
        now = time.monotonic()
        self.restarts += 1
        self._restart_times.append(now)
        if self.restart_window_s is not None:
            while (self._restart_times and
                   now - self._restart_times[0] > self.restart_window_s):
                self._restart_times.popleft()
            recent = len(self._restart_times)
            budget = (f"{self.max_restarts} restarts in "
                      f"{self.restart_window_s:.0f}s")
        else:
            recent = self.restarts
            budget = f"{self.max_restarts} restarts"
        if recent > self.max_restarts:
            from deeplearning4j_tpu_torch.train.fault_tolerance import \
                TrainingFailure
            raise TrainingFailure(
                f"fleet giving up after {budget} (last cause: {cause})")
        logger.warning("fleet worker failed (%s); restart %d within "
                       "budget %s", cause, recent, budget)

    @staticmethod
    def _close_capture(handle: _WorkerHandle) -> None:
        for f in getattr(handle.proc, "_dl4j_capture", ()):
            try:
                f.close()
                os.unlink(f.name)
            except (OSError, ValueError):
                pass

    def _heartbeat_stale(self, handle: _WorkerHandle) -> bool:
        if handle.port is None:  # not ready yet; readiness has its own wait
            return False
        try:
            age = time.time() - os.stat(handle.heartbeat_file).st_mtime
        except OSError:
            return False
        return age > self.heartbeat_timeout_s

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            for handle in list(self._handles.values()):
                if handle.stopping or handle.dead or handle.proc is None:
                    continue
                cause = None
                code = handle.proc.poll()
                if code is not None:
                    cause = (f"worker {handle.spec.worker_id} exited "
                             f"rc={code}")
                elif self._heartbeat_stale(handle):
                    cause = (f"worker {handle.spec.worker_id} heartbeat "
                             f"stale > {self.heartbeat_timeout_s:.0f}s")
                    handle.proc.kill()
                    try:
                        handle.proc.wait(timeout=10)
                    except Exception:
                        pass
                if cause is None:
                    continue
                # claim the handle before acting: restart_worker sets
                # `stopping` under this lock, so a crash noticed just as
                # an intentional restart begins is ceded to it instead of
                # racing two spawns onto one handle
                with self._lock:
                    if handle.stopping:
                        continue
                    handle.relaunching = True
                try:
                    self._close_capture(handle)
                    try:
                        self._register_restart(cause)
                    except BaseException as e:
                        self._failure = e
                        handle.dead = True
                        logger.error("fleet restart budget exhausted: %s",
                                     e)
                        continue
                    handle.restarts += 1
                    try:
                        # the crash relaunch is the incident timeline's
                        # recovery leg: flagged span so the
                        # journal event is trace-linked
                        sp = (trace.span("fleet.relaunch")
                              if trace.enabled() else trace.NOOP)
                        with sp:
                            if sp.recording:
                                sp.flag("fleet")
                                sp.set("worker", handle.spec.worker_id)
                            journal.emit("fleet.worker_restart",
                                         worker=handle.spec.worker_id,
                                         cause=cause,
                                         restarts=handle.restarts)
                            with self._lock:
                                self._spawn(handle)
                            self._wait_port(handle)
                        self._publish_roster()
                    except Exception:
                        logger.exception("relaunch of %s failed",
                                         handle.spec.worker_id)
                finally:
                    handle.relaunching = False

    # ------------------------------------------------------------ lifecycle
    def stop(self, timeout_s: float = 30.0) -> None:
        """Stop the watchdog, then gracefully stop every worker (SIGTERM →
        drain → manifest refresh → exit 0), escalating to SIGKILL."""
        self._stop.set()
        if self in self._active_list():
            self._active_list().remove(self)
        if self._watchdog is not None:
            self._watchdog.join(timeout=10.0)
            self._watchdog = None
        for handle in self._handles.values():
            handle.stopping = True
            if handle.alive():
                handle.proc.terminate()
        deadline = time.monotonic() + timeout_s
        for handle in self._handles.values():
            if handle.proc is None:
                continue
            try:
                handle.proc.wait(timeout=max(0.1,
                                             deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                handle.proc.kill()
                try:
                    handle.proc.wait(timeout=10)
                except Exception:
                    pass
            self._close_capture(handle)
        self._publish_roster()  # an empty roster, not a stale one

    def __enter__(self) -> "FleetSupervisor":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


# -------------------------------------------------------------------------
# worker process entry point: python -m deeplearning4j_tpu_torch.serving.fleet
# <spec.json>
def worker_main(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    # the device comes first: everything built below (the restored model,
    # its replicas and graphs) lands on it. ``cuda`` with no GPU visible
    # raises here, before the port file says ready — no CPU fallback.
    from deeplearning4j_tpu_torch.runtime.environment import get_environment
    env = get_environment()
    env.set_device(spec.get("device", "cuda"))
    env.resolve_device()
    if spec.get("cache_dir"):
        env.set_compile_cache(spec["cache_dir"])
    straggle = spec.get("straggle")
    if straggle:
        from deeplearning4j_tpu_torch.runtime.chaos import (AddLatency,
                                                            ChaosController)
        controller = ChaosController(seed=int(straggle.get("seed", 0)))
        controller.on(straggle.get("point", "serving.worker.predict"),
                      AddLatency(float(straggle["ms"]) / 1000.0,
                                 p=float(straggle.get("p", 1.0))))
        controller.__enter__()  # process-lifetime schedule, never exited

    stop = threading.Event()

    def _graceful(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)

    from deeplearning4j_tpu_torch.serving.manifest import WarmupManifest
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.serving.server import ModelServer

    batcher_kw = dict(spec.get("batcher_kw") or {})
    sig = spec.get("warmup_signature")
    if sig and "warmup_example" not in batcher_kw and \
            WarmupManifest.load_for_archive(spec["archive"]) is None:
        # first launch of this archive: no manifest to replay yet — build
        # a zeros warmup example from the recorded input signature so the
        # worker still reaches READY fully AOT-warmed
        batcher_kw["warmup_example"] = WarmupManifest(
            inputs={str(k): dict(v) for k, v in sig.items()},
            buckets=[], replicas=1, pairs=[]).example()
    registry = ModelRegistry(hbm_budget_bytes=spec.get("hbm_budget_bytes"))
    served = registry.load(spec["model_name"], spec["archive"],
                           version=spec.get("version"), **batcher_kw)
    # paging catalogue: extra archives registered COLD — zero
    # HBM now, rehydrated on demand under the worker's budget with the
    # same batcher knobs as the primary model
    for extra_name, extra_archive in sorted(
            (spec.get("extra_models") or {}).items()):
        registry.load(extra_name, extra_archive, resident=False,
                      **batcher_kw)
    session_dir = spec.get("session_dir")
    if session_dir:
        # session tier: warm the fixed-bucket step program
        # BEFORE the port file (readiness) is written, from the same
        # signature the stateless warmup uses — first step never compiles
        man = WarmupManifest.load_for_archive(spec["archive"])
        if man is not None and man.inputs:
            step_example = man.example(rows=1)
        elif sig:
            step_example = WarmupManifest(
                inputs={str(k): dict(v) for k, v in sig.items()},
                buckets=[], replicas=1, pairs=[]).example(rows=1)
        else:
            raise ValueError(
                "session_dir set but neither a warmup manifest nor a "
                "warmup_signature describes the step input shape")
        served.batcher.enable_sessions(
            step_example, session_bucket=int(spec.get("session_bucket", 8)))
    server = ModelServer(registry, worker_id=spec["worker_id"],
                         session_dir=session_dir or None,
                         session_kw=spec.get("session_kw") or None)
    port = server.start(0)
    # the port file is the readiness signal: written only after the
    # registry is loaded, manifest-warmed and serving — atomic so the
    # supervisor never reads a torn record
    info = {"port": port, "pid": os.getpid(),
            "worker_id": spec["worker_id"], "version": served.version}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(spec["port_file"]))
    with os.fdopen(fd, "w") as f:
        json.dump(info, f)
    os.replace(tmp, spec["port_file"])

    hb = spec["heartbeat_file"]
    interval = float(spec.get("heartbeat_interval_s", 0.5))
    while not stop.wait(interval):
        with open(hb, "a"):
            os.utime(hb)
    # graceful drain: queued requests complete, the warmup manifest is
    # refreshed next to the archive (traffic-minted buckets included) so
    # the NEXT launch of this archive pre-warms what we actually served
    registry.shutdown(drain=True)
    server.stop()
    _write_launch_counts(spec)
    return 0


def _write_launch_counts(spec: Dict[str, Any]) -> None:
    """This process's kernel launch counts (``_native`` counters), logged
    and written atomically next to the port file as
    ``<worker_id>.<pid>.launches.json`` — the launches a worker made are
    counted here, in its own process, and read back by whoever reads the
    supervisor's run dir."""
    from deeplearning4j_tpu_torch.ops.kernels import _native
    counts = {c.name: c.value for c in _native.counter_values()}
    sys.stderr.write(f"worker {spec['worker_id']} launch counts: "
                     f"{json.dumps(counts, sort_keys=True)}\n")
    d = os.path.dirname(spec["port_file"])
    path = os.path.join(d, f"{spec['worker_id']}.{os.getpid()}.launches.json")
    fd, tmp = tempfile.mkstemp(dir=d)
    with os.fdopen(fd, "w") as f:
        json.dump({"worker_id": spec["worker_id"], "pid": os.getpid(),
                   "launches": counts}, f)
    os.replace(tmp, path)


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1]))
