"""The port's control plane (``serving/control_plane.py``) against the JAX
package's.

- **One config file, two packages**: a JAX and a port ``FleetConfig`` on one
  path see each other's mutations with one version rule; racing claims of
  one action id from both packages' threads: exactly one wins; a released
  claim can be won again from the other package; a corrupt or regressed
  file degrades both to the last valid snapshot and counts it alike.
- **One lease file, two packages**: exactly one leader; the follower takes
  over once the leader stops beating, with ``seq`` one larger.
- **Router processes** (a module tier of 3 processes: two port routers with
  lease-elected autoscalers, one JAX router, in front of one in-process
  port worker): each package's ``MultiRouterClient`` over the other's
  routers answers as the worker does; a port router SIGKILLed under load
  costs no client a request, the watchdog relaunches it and it registers
  again; exactly one router's autoscaler leads and the leader's death moves
  the lease with a larger ``seq``; a port router holds no GPU
  (``CUDA_VISIBLE_DEVICES`` empty) and runs on the CPU.
"""

import dataclasses
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

from _torch_serving_host import (BATCHER_KW, RTOL, X, mlp, oracle_outs,  # noqa: F401
                                 port_on_cpu, set_port_cpu, wait_until)
from _torch_serving_procs import port_process_guard  # noqa: F401
from deeplearning4j_tpu.serving import control_plane as jcp
from deeplearning4j_tpu_torch.serving import control_plane as cp


def _get(address, path):
    with urllib.request.urlopen(f"http://{address}{path}", timeout=10) as resp:
        return json.loads(resp.read())


# ======================================================= one config file
def test_one_config_file_versions_and_claims_across_packages(tmp_path):
    path = str(tmp_path / "fleet.json")
    jc, pc = jcp.FleetConfig(path), cp.FleetConfig(path)
    jc.set_workers({"w0": "127.0.0.1:1"})
    pc.set_router("r0", "127.0.0.1:2")
    jc.set_router("r1", "127.0.0.1:3")
    assert pc.version == jc.version == 3
    assert pc.snapshot() == jc.snapshot()
    assert pc.endpoints() == {"w0": "127.0.0.1:1"}
    assert jc.routers() == pc.routers() == {"r0": "127.0.0.1:2", "r1": "127.0.0.1:3"}
    won = []
    lock = threading.Lock()

    def claim(cfg, who):
        ok = cfg.try_claim("deploy:v2", {"by": who})
        with lock:
            won.append((who, ok))

    threads = [threading.Thread(target=claim, args=((jc, pc)[i % 2], f"{'jp'[i % 2]}{i}"))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    winners = [w for w, ok in won if ok]
    assert len(winners) == 1
    assert pc.applied("deploy:v2")["by"] == jc.applied("deploy:v2")["by"] == winners[0]
    (jc if winners[0].startswith("p") else pc).release_claim("deploy:v2")
    assert pc.applied("deploy:v2") is None
    assert (pc if winners[0].startswith("p") else jc).try_claim("deploy:v2")
    assert pc.snapshot() == jc.snapshot()
    pc.remove_router("r1")
    assert jc.routers() == {"r0": "127.0.0.1:2"}


def test_corrupt_and_regressed_files_degrade_alike(tmp_path):
    path = str(tmp_path / "fleet.json")
    jc, pc = jcp.FleetConfig(path), cp.FleetConfig(path)
    pc.set_workers({"w0": "127.0.0.1:1"})
    good = pc.snapshot()
    assert jc.snapshot() == good  # both have read the valid v1
    for bad in (b"{ torn", json.dumps({**good, "version": 0}).encode(),
                json.dumps({"format": "nope", "version": 9}).encode()):
        with open(path, "wb") as f:
            f.write(bad)
        time.sleep(0.01)
        assert pc.snapshot() == jc.snapshot() == good
    # (loads_total differs: the writer counts its own write as a load)
    for k in ("version", "load_failures_total"):
        assert pc.counters()[k] == jc.counters()[k]
    assert pc.counters()["load_failures_total"] == 3
    jc.set_workers({"w1": "127.0.0.1:4"})  # a mutation heals the file
    assert pc.endpoints() == {"w1": "127.0.0.1:4"} and pc.version == good["version"] + 1


# ======================================================== one lease file
@pytest.mark.parametrize("first", ["jax", "port"])
def test_one_lease_file_one_leader_and_fenced_takeover(tmp_path, first):
    path = str(tmp_path / "lease")
    ej, ep = jcp.LeaseElection(path, "rj", lease_s=0.3), cp.LeaseElection(path, "rp", lease_s=0.3)
    a, b = (ej, ep) if first == "jax" else (ep, ej)
    assert a.ensure() == "leader" and b.ensure() == "follower"
    assert a.ensure() == "leader" and b.ensure() == "follower"  # a heartbeat
    rec = json.load(open(path))
    assert rec["format"] == cp.LEASE_FORMAT == jcp.LEASE_FORMAT
    assert rec["holder"] == a.holder_id and rec["seq"] == 1
    assert b.snapshot()["holder"] == a.holder_id
    time.sleep(0.45)  # a stops beating
    assert b.ensure() == "leader" and b.verify()
    assert json.load(open(path))["seq"] == 2
    assert a.ensure() == "follower" and not a.verify()
    assert [e["reason"] for e in b.elections] == ["takeover"]  # follower was its start
    b.release()
    assert not os.path.exists(path)


def test_router_spec_fields_are_the_jax_fields_off_the_card():
    port = {f.name: f.default for f in dataclasses.fields(cp.RouterSpec)}
    jax = {f.name: f.default for f in dataclasses.fields(jcp.RouterSpec)}
    assert set(port) == set(jax) - {"jax_platforms", "host_device_count"}
    assert {k: port[k] for k in port} == {k: jax[k] for k in port}
    assert cp.__all__ == jcp.__all__
    env = cp.RouterSupervisor._spawn_env(cp.RouterSpec("r", "c.json"))
    assert env["CUDA_VISIBLE_DEVICES"] == ""


# ===================================================== router processes
AUTOSCALER = {"tick_s": 0.2, "fast_window_s": 10, "slow_window_s": 60, "min_requests": 1000}


@pytest.fixture(scope="module")
def tier(tmp_path_factory):
    """One in-process port worker; two port router processes with
    lease-elected autoscalers and one JAX router process over one config."""
    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
    set_port_cpu()
    d = tmp_path_factory.mktemp("cp")
    reg = ModelRegistry()
    net = mlp(False)
    reg.register("m", net, **BATCHER_KW)
    srv = ModelServer(reg, worker_id="w0")
    port = srv.start(0)
    path = str(d / "fleet.json")
    cp.FleetConfig(path).set_workers({"w0": f"127.0.0.1:{port}"})
    kw = {"hedge_enabled": False, "probe_interval_s": 0.1}
    psup = cp.RouterSupervisor(
        [cp.RouterSpec(router_id=f"pr{i}", config_path=path, router_kw=kw, lease_s=1.0,
                       slo_windows_s=[10, 60], autoscaler=dict(AUTOSCALER))
         for i in range(2)], run_dir=str(d / "port-run"), max_restarts=4,
        heartbeat_timeout_s=60.0)
    jsup = jcp.RouterSupervisor([jcp.RouterSpec(router_id="jr0", config_path=path,
                                                router_kw=kw)],
                                run_dir=str(d / "jax-run"), heartbeat_timeout_s=60.0)
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
        config = cp.FleetConfig(path)
        assert wait_until(lambda: len(config.routers()) == 3, 30)
        yield {"port": psup, "jax": jsup, "config": config, "path": path,
               "oracle": lambda x: net.output(x).numpy()}
    finally:
        psup.stop()
        jsup.stop()
        srv.stop(shutdown_registry=True)


def _ok(status, payload, oracle, n):
    return status == 200 and any(
        np.allclose(np.asarray(payload["outputs"], np.float32), want, rtol=RTOL, atol=1e-7)
        for want in oracle_outs(oracle, n))


def test_clients_of_each_package_over_the_others_routers(tier):
    routers = tier["config"].routers()
    port_eps = [routers[r] for r in ("pr0", "pr1")]
    jclient = jcp.MultiRouterClient(endpoints=port_eps)
    pclient = cp.MultiRouterClient(endpoints=[routers["jr0"]])
    try:
        for proto in ("binary", "json"):
            for n in (1, 3):
                for client in (jclient, pclient):
                    status, payload = client.predict("m", X[:n], timeout_ms=5000,
                                                     protocol=proto)
                    assert _ok(status, payload, tier["oracle"], n), (proto, status)
        assert set(jclient.snapshot()["router_requests"]) == set(port_eps)
        assert pclient.snapshot()["failovers_total"] == 0
    finally:
        jclient.close()
        pclient.close()


def test_routers_hold_no_gpu_and_one_autoscaler_leads(tier):
    sup = tier["port"]
    for pid in sup.managed_pids():
        with open(f"/proc/{pid}/environ", "rb") as f:
            env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)
        assert env[b"CUDA_VISIBLE_DEVICES"] == b""
    routers = tier["config"].routers()

    def roles():
        return {r: _get(routers[r], "/v1/autoscaler")["role"] for r in ("pr0", "pr1")}

    assert wait_until(lambda: sorted(roles().values()) == ["follower", "leader"], 20), roles()


def test_sigkill_a_router_under_load(tier):
    """The drill of record, across packages: a JAX client over the port's
    router processes; the leading router is SIGKILLed; no request fails,
    the lease moves to the survivor with a larger ``seq``, and the victim
    is relaunched and registers again."""
    sup, config = tier["port"], tier["config"]
    routers = config.routers()
    snaps = {r: _get(routers[r], "/v1/autoscaler") for r in ("pr0", "pr1")}
    leader = next(r for r, s in snaps.items() if s["role"] == "leader")
    survivor = "pr1" if leader == "pr0" else "pr0"
    seq0 = snaps[leader]["election"]["seq"]
    client = jcp.MultiRouterClient(endpoints=[routers["pr0"], routers["pr1"]])
    outcomes, stop = [], threading.Event()

    def loop():
        while not stop.is_set():
            try:
                status, payload = client.predict("m", X[:2], timeout_ms=8000)
                outcomes.append(_ok(status, payload, tier["oracle"], 2))
            except Exception as e:  # a client-visible failure
                outcomes.append(repr(e))

    threads = [threading.Thread(target=loop) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        sup.kill_router(leader)
        time.sleep(1.0)
        assert wait_until(lambda: _get(routers[survivor], "/v1/autoscaler")["role"]
                          == "leader", 20)
        stop.set()
        for t in threads:
            t.join(30)
        assert outcomes and all(o is True for o in outcomes), \
            [o for o in outcomes if o is not True][:5]
        assert client.snapshot()["failovers_total"] >= 1
        election = _get(routers[survivor], "/v1/autoscaler")["election"]
        assert election["seq"] > seq0 and election["holder"].startswith(survivor + "@")
        assert wait_until(lambda: len(sup.endpoints()) == 2, 60)
        assert wait_until(lambda: config.routers().get(leader) == sup.endpoints()[leader], 30)
        sup.check()
    finally:
        stop.set()
        client.close()
