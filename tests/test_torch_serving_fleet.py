"""The port's fleet tier (``serving/fleet.py``) against the JAX package's.

- **Specs and adapters**: ``WorkerSpec`` has the JAX fields, less the JAX
  platform pair, plus ``device`` (default ``cuda``); host adapters resolve
  the port's and the JAX package's ``HostSpec`` records alike; a worker's
  env carries the repository and the parent's kernel build directory.
- **No GPU, no CPU fallback**: a worker left on its default ``cuda`` on a
  machine without a GPU exits before it is ready, naming the CPU request.
- **Processes across packages** (a module fleet of 3 processes: two port
  workers on the CPU, one JAX worker): the JAX ``FleetRouter`` in front of
  the port's workers and the port's router in front of the JAX worker
  answer as the same-package pairs do (1e-6 of the oracle at the serving
  bucket), with the worker's ids in the headers.
- **Lifecycle**: a SIGKILL is relaunched by the watchdog with no client
  error and journals ``fleet.worker_kill`` / ``fleet.worker_restart`` /
  ``fleet.worker_spawn``; an intentional restart onto version 2 drains,
  writes the worker's launch counts next to its port file and comes back
  serving v2; ``clone_spec`` + ``add_worker`` grow the fleet (the
  autoscaler's worker lever) and ``remove_worker`` retires a worker.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from _torch_serving_host import (BATCHER_KW, RTOL, jax_archive, oracle_outs,  # noqa: F401
                                 port_on_cpu, port_restore, post,
                                 wait_until)
from _torch_serving_procs import port_process_guard  # noqa: F401
from deeplearning4j_tpu.serving import fleet as jfleet
from deeplearning4j_tpu.serving.router import FleetRouter as JRouter
from deeplearning4j_tpu_torch.runtime import journal
from deeplearning4j_tpu_torch.serving import FleetRouter
from deeplearning4j_tpu_torch.serving import fleet

SIG = {"__single__": {"shape_tail": [8], "dtype": "float32"}}


def _port_spec(wid, archive, **kw):
    return fleet.WorkerSpec(worker_id=wid, model_name="m", archive=archive, device="cpu",
                            batcher_kw=dict(BATCHER_KW), warmup_signature=SIG,
                            heartbeat_interval_s=0.2, **kw)


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """Two port worker processes and one JAX worker process on one
    JAX-written MLP archive, each tier under its own supervisor."""
    d = tmp_path_factory.mktemp("fleet")
    archive = jax_archive(d / "mlp.zip")
    jarchive = jax_archive(d / "mlp-jax.zip")
    psup = fleet.FleetSupervisor([_port_spec("pw0", archive), _port_spec("pw1", archive)],
                                 run_dir=str(d / "port-run"), heartbeat_timeout_s=30.0)
    jsup = jfleet.FleetSupervisor(
        [jfleet.WorkerSpec(worker_id="jw0", model_name="m", archive=jarchive,
                           batcher_kw=dict(BATCHER_KW), warmup_signature=SIG)],
        run_dir=str(d / "jax-run"))
    errors = []

    def start(sup):
        try:
            sup.start()
        except BaseException as e:  # surfaced below, after both joined
            errors.append(e)

    threads = [threading.Thread(target=start, args=(s,)) for s in (psup, jsup)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    try:
        assert not errors, errors
        yield {"port": psup, "jax": jsup, "archive": archive, "dir": d,
               "oracle": port_restore(archive).output}
    finally:
        psup.stop()
        jsup.stop()


def _close(got, output_fn, n):
    return any(np.allclose(got, want, rtol=RTOL, atol=1e-7)
               for want in oracle_outs(output_fn, n))


# ============================================================ specs, env
def test_worker_spec_fields_are_the_jax_fields_on_a_device():
    port = {f.name: f.default for f in dataclasses.fields(fleet.WorkerSpec)}
    jax = {f.name: f.default for f in dataclasses.fields(jfleet.WorkerSpec)}
    assert set(port) == set(jax) - {"jax_platforms", "host_device_count"} | {"device"}
    assert port["device"] == "cuda"
    same = set(port) & set(jax)
    assert {k: port[k] for k in same} == {k: jax[k] for k in same}


def test_worker_env_carries_the_repository_and_the_build_dir(tmp_path):
    from deeplearning4j_tpu_torch.runtime import compile_cache
    spec = _port_spec("w", "a.zip")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(fleet.__file__)))
    repo = os.path.dirname(repo)
    saved = compile_cache.cache_dir()
    try:
        compile_cache.disable()
        env = fleet._worker_env(spec)
        assert env["PYTHONPATH"].split(os.pathsep)[0] == repo
        built = compile_cache.enable(str(tmp_path / "kernels"))
        env = fleet._worker_env(spec)
        assert env["DL4J_TPU_COMPILE_CACHE"] == str(tmp_path / "kernels")
        assert os.path.join(env["DL4J_TPU_COMPILE_CACHE"],
                            compile_cache.framework_dirname()) == built
    finally:
        compile_cache.disable()
        if saved:
            compile_cache._cache_dir = saved


def test_host_adapters_resolve_as_jax():
    from deeplearning4j_tpu.runtime.mesh import loopback_hosts as jloopback
    from deeplearning4j_tpu_torch.runtime.mesh import HostSpec, loopback_hosts
    specs = [_port_spec("a", "x.zip", host="host0"), _port_spec("b", "x.zip", host="host1")]
    jspecs = [jfleet.WorkerSpec(worker_id=s.worker_id, model_name="m", archive="x.zip",
                                host=s.host) for s in specs]
    for hosts in (loopback_hosts(2), jloopback(2)):
        got = {k: v.describe() for k, v in fleet.resolve_host_adapters(specs, hosts).items()}
        want = {k: v.describe()
                for k, v in jfleet.resolve_host_adapters(jspecs, jloopback(2)).items()}
        assert got == want
    with pytest.raises(ValueError, match="unknown host"):
        fleet.resolve_host_adapters(specs)
    with pytest.raises(NotImplementedError, match="only local/loopback"):
        fleet.resolve_host_adapters(specs, [HostSpec("host0", spawn="ssh")])


def test_pid_registry_separates_managed_from_orphaned():
    reg = fleet.PidRegistry()
    procs = [subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
             for _ in range(2)]
    try:
        for p in procs:
            reg.track(p)
        assert sorted(reg.live_pids()) == sorted(p.pid for p in procs)

        class Sup:
            def managed_pids(self):
                return [procs[0].pid]

        reg.active.append(Sup())
        assert reg.orphaned_pids() == [procs[1].pid]
        assert reg.kill_orphaned() == [procs[1].pid]
        assert reg.live_pids() == [procs[0].pid]
        reg.active.clear()
        assert reg.kill_stray() == [procs[0].pid] and reg.live_pids() == []
    finally:
        for p in procs:
            p.kill()
            p.wait(10)


def test_a_cuda_worker_without_a_gpu_never_becomes_ready(tmp_path):
    """No CPU fallback: the default device is ``cuda`` and the worker
    raises through ``resolve_device`` before it writes its port file."""
    archive = jax_archive(tmp_path / "m.zip")
    spec = fleet.WorkerSpec(worker_id="gpu0", model_name="m", archive=archive,
                            batcher_kw=dict(BATCHER_KW), warmup_signature=SIG)
    sup = fleet.FleetSupervisor([spec], run_dir=str(tmp_path / "run"), ready_timeout_s=120.0)
    with pytest.raises(RuntimeError, match="before becoming ready") as e:
        sup.start()
    assert "no CUDA device is available" in str(e.value)
    assert not os.path.exists(os.path.join(str(tmp_path / "run"), "gpu0.port.json"))
    assert fleet.live_worker_pids() == [] or all(
        p not in fleet.live_worker_pids() for p in sup.managed_pids())


# ===================================================== across packages
def test_jax_router_in_front_of_port_workers(fleets):
    router = JRouter(fleets["port"], probe_interval_s=0.05, hedge_enabled=False)
    port = router.start(0)
    try:
        assert wait_until(lambda: sum(v.ready for v in router.workers().values()) == 2, 30)
        seen = set()
        for n in (1, 2, 3, 4):
            status, headers, body = post(port, n=n)
            assert status == 200
            assert _close(np.asarray(body["outputs"], np.float32), fleets["oracle"], n)
            seen.add(headers["X-Worker-Id"])
        assert seen <= {"pw0", "pw1"} and seen
    finally:
        router.stop()


def test_port_router_in_front_of_the_jax_worker(fleets):
    router = FleetRouter(fleets["jax"], probe_interval_s=0.05, hedge_enabled=False)
    port = router.start(0)
    try:
        assert wait_until(lambda: sum(v.ready for v in router.workers().values()) == 1, 30)
        for n in (1, 3):
            status, headers, body = post(port, n=n)
            assert status == 200 and headers["X-Worker-Id"] == "jw0"
            assert _close(np.asarray(body["outputs"], np.float32), fleets["oracle"], n)
    finally:
        router.stop()


# ============================================================ lifecycle
def test_sigkill_is_relaunched_with_no_client_error(fleets):
    sup = fleets["port"]
    j = journal.enable(capacity=4096)
    router = FleetRouter(sup, probe_interval_s=0.05, hedge_enabled=False)
    port = router.start(0)
    outcomes, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            try:
                outcomes.append(post(port, n=2)[0])
            except Exception as e:  # a client-visible failure
                outcomes.append(repr(e))

    try:
        assert wait_until(lambda: sum(v.ready for v in router.workers().values()) == 2, 30)
        old = sup.endpoints()["pw1"]
        t = threading.Thread(target=client)
        t.start()
        time.sleep(0.3)
        pid = sup.kill_worker("pw1")
        assert wait_until(lambda: "pw1" in sup.endpoints() and sup.endpoints()["pw1"] != old, 60)
        time.sleep(0.3)
        stop.set()
        t.join(60)
        assert outcomes and all(o == 200 for o in outcomes), outcomes[:5]
        types = [e["type"] for e in j.events()
                 if e["attrs"].get("worker") == "pw1" and e["type"].startswith("fleet.")]
        assert types[:3] == ["fleet.worker_kill", "fleet.worker_restart", "fleet.worker_spawn"]
        assert pid not in sup.managed_pids() and sup.restarts == 1
    finally:
        stop.set()
        router.stop()


def test_intentional_restart_serves_v2_and_writes_launch_counts(fleets):
    sup = fleets["port"]
    old_pid = next(h.proc.pid for w, h in sup._handles.items() if w == "pw0")
    sup.restart_worker("pw0", version=2)
    counts = os.path.join(sup.run_dir, f"pw0.{old_pid}.launches.json")
    rec = json.load(open(counts))
    assert rec["worker_id"] == "pw0" and rec["pid"] == old_pid
    assert {"flash_attention", "flash_attention_lse", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv", "fused_lstm", "conv_stats"} <= set(rec["launches"])
    assert all(v == 0 for v in rec["launches"].values())  # an MLP on the CPU
    host, p = sup.endpoints()["pw0"].rsplit(":", 1)
    status, headers, _ = post(int(p), n=1)
    assert status == 200 and headers["X-Model-Version"] == "2"


def test_clone_add_and_remove_a_worker(fleets):
    sup = fleets["port"]
    sup.remove_worker("pw1")
    assert "pw1" not in sup.worker_ids() and "pw1" not in sup.endpoints()
    spec = sup.clone_spec("pw0", "pw0-as1")
    assert spec.device == "cpu" and spec.archive == sup.worker_archive("pw0")
    t0 = time.monotonic()
    port = sup.add_worker(spec)
    assert time.monotonic() - t0 < 120
    assert sup.endpoints()["pw0-as1"].endswith(f":{port}")
    status, headers, _ = post(port, n=2)
    assert status == 200 and headers["X-Worker-Id"] == "pw0-as1"
    with pytest.raises(ValueError, match="already exists"):
        sup.add_worker(sup.clone_spec("pw0", "pw0-as1"))
