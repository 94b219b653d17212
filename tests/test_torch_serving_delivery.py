"""The port's staged rollout, SLO monitor, feedback log and watchdog
against the JAX package's, and gated deploys over an in-process port fleet.

- ``ShadowComparator``: the verdict table, observation by observation,
  equal to the JAX comparator's.
- ``DeliveryController``: promote and every rollback cause under the same
  scripted observations and injected clock as the JAX controller: the same
  stage history, the same journaled ``delivery.*`` sequence, the same seeded
  shadow/canary picks.
- ``FeedbackLog``: joins and orphans, keep-1 rollovers, and the
  ``/v1/feedback`` handler's answers, as the JAX package's.
- ``SLOMonitor``: burn rates, attainment and Prometheus text equal to the
  JAX monitor's for the same outcome sequence; the cardinality cap and the
  create gate (``tests/test_trace.py:267``, ``:301``, ``:314``).
- ``AnomalyWatchdog``: every default rule opens once and closes, as the
  JAX watchdog does on the same events (``tests/test_journal.py:411-480``).
- ``rolling_deploy(strategy="gated")`` over in-process port workers
  (``tests/test_delivery.py:422-750``): failed and refused gates leave the
  incumbent serving, a perfect candidate promotes through shadow and the
  ramped canary and the deploy is idempotent through an attached config, a
  wrong-output candidate is caught in shadow, latency chaos trips the
  canary's SLO window, a corrupt mirror refuses promotion; zero client
  errors throughout, every answer bit for bit the incumbent's. The
  subprocess drill (``:752``) needs worker processes, which come with
  ``serving/fleet.py``.
"""

import json
import os
import random
import threading
import time
import urllib.error

import numpy as np
import pytest

from _torch_serving_host import (BATCHER_KW, X, jax_archive, mlp, oracle_outs,  # noqa: F401
                                 port_on_cpu, port_restore, post, rolled_jax_net, wait_until)
from deeplearning4j_tpu.runtime import journal as jjournal
from deeplearning4j_tpu.serving import blackbox as jblackbox
from deeplearning4j_tpu.serving import delivery as jdelivery
from deeplearning4j_tpu.serving import slo as jslo
from deeplearning4j_tpu_torch.runtime import journal
from deeplearning4j_tpu_torch.runtime.chaos import AddLatency, ChaosController, CorruptBytes
from deeplearning4j_tpu_torch.serving import (FleetRouter, ModelRegistry, ModelServer,
                                              blackbox, delivery)
from deeplearning4j_tpu_torch.serving.delivery import (DeliveryConfig, GateFailed, GateRefused,
                                                       GoldenSet)
from deeplearning4j_tpu_torch.serving.slo import SLOMonitor, SLOTarget


@pytest.fixture()
def journals():
    """Fresh rings in both packages (the journal is process-global)."""
    yield journal.enable(capacity=4096), jjournal.enable(capacity=4096)
    journal.enable(capacity=1024)
    jjournal.enable(capacity=1024)


def _body(cls=1):
    out = [[0.0] * 4]
    out[0][cls] = 1.0
    return json.dumps({"outputs": out}).encode()


# ===================================================== shadow comparator
SHADOW_SCRIPTS = {
    "agree_to_pass": (dict(max_disagreement=0.0, min_samples=3),
                      [(_body(1), 200, _body(1), 0.01, 0.02, False)] * 3),
    "one_disagreement": (dict(max_disagreement=0.0, min_samples=2),
                         [(_body(1), 200, _body(1), 0.01, 0.01, False),
                          (_body(1), 200, _body(2), 0.01, 0.01, False)]),
    "tolerated_disagreement": (dict(max_disagreement=0.5, min_samples=4),
                               [(_body(1), 200, _body(1 + i % 2), 0.01, 0.015, False)
                                for i in range(4)]),
    "candidate_error": (dict(min_samples=100), [(_body(1), 500, b"", 0.01, 0.01, False)]),
    "corrupt": (dict(min_samples=100), [(_body(1), 200, _body(1), 0.01, 0.01, True)]),
    "unparsable": (dict(min_samples=1), [(_body(1), 200, b"not json", 0.01, 0.01, False)]),
    "shape_mismatch": (dict(min_samples=1),
                       [(_body(1), 200, json.dumps({"outputs": [[1.0, 0.0], [0.0, 1.0]]}).encode(),
                         0.01, 0.01, False)]),
    "scalar_outputs": (dict(min_samples=1),
                       [(_body(1), 200, json.dumps({"outputs": 3.0}).encode(), 0.01, 0.01,
                         False)]),
}


@pytest.mark.parametrize("case", sorted(SHADOW_SCRIPTS))
def test_shadow_comparator_verdicts_match_jax(case):
    kw, script = SHADOW_SCRIPTS[case]
    ours, theirs = delivery.ShadowComparator(**kw), jdelivery.ShadowComparator(**kw)
    assert ours.verdict() == theirs.verdict()
    for inc, st, cand, li, lc, corrupt in script:
        assert ours.observe(inc, st, cand, li, lc, corrupt=corrupt) == \
            theirs.observe(inc, st, cand, li, lc, corrupt=corrupt)
        assert ours.snapshot() == theirs.snapshot()
        assert ours.verdict() == theirs.verdict()
    assert delivery._top1([[0.1, 0.9]]).tolist() == jdelivery._top1([[0.1, 0.9]]).tolist()


# =================================================== delivery controller
def _fake_clock():
    t = [1000.0]
    return t, (lambda: t[0])


def _controllers(**cfg_kw):
    """The same controller in both packages on one shared fake clock."""
    t, now = _fake_clock()
    base = dict(shadow_fraction=1.0, shadow_min_samples=2, canary_fractions=(0.5, 1.0),
                canary_min_requests=4, canary_window_s=300, stage_timeout_s=60.0, now_fn=now)
    base.update(cfg_kw)
    out = []
    for mod, slo in ((delivery, None), (jdelivery, jslo)):
        kw = dict(base)
        target = (SLOTarget if slo is None else slo.SLOTarget)(
            availability=0.5, latency_ms=100.0, latency_target=0.5)
        kw.setdefault("canary_target", target)
        out.append(mod.DeliveryController("m", "model-v2.zip", 2, "w0",
                                          config=mod.DeliveryConfig(**kw),
                                          gate_report={"passed": True}))
    return t, out


def _shadow(dcs, n, cand=1, status=200):
    for dc in dcs:
        for _ in range(n):
            dc.observe_shadow(_body(1), status, _body(cand), 0.01, 0.01)


def _canary(dcs, n, ok=True, latency_s=0.005):
    for dc in dcs:
        for _ in range(n):
            dc.observe_canary(ok=ok, latency_s=latency_s)


def _tick(dcs):
    got = [dc.tick() for dc in dcs]
    assert got[0] == got[1]
    return got[0]


SCRIPTS = ["promote", "availability_burn", "latency_burn", "shadow_timeout", "canary_timeout",
           "shadow_divergence", "shadow_candidate_errors"]


@pytest.mark.parametrize("script", SCRIPTS)
def test_controller_stage_sequence_matches_jax(journals, script):
    ours_j, theirs_j = journals
    t, dcs = _controllers(stage_timeout_s=5.0 if "timeout" in script else 60.0)
    for dc in dcs:
        dc.transition("shadow")
    picks = [[dc.take_shadow() for _ in range(8)] for dc in dcs]
    assert picks[0] == picks[1]
    if script == "shadow_timeout":
        t[0] += 6.0
        assert _tick(dcs) == "rollback_pending"
    elif script in ("shadow_divergence", "shadow_candidate_errors"):
        _shadow(dcs, 2, cand=2, status=200 if script == "shadow_divergence" else 500)
        assert _tick(dcs) == "rollback_pending"
    else:
        _shadow(dcs, 2)
        assert _tick(dcs) == "canary"
        picks = [[dc.take_canary() for _ in range(8)] for dc in dcs]
        assert picks[0] == picks[1]
        if script == "promote":
            _canary(dcs, 4)
            t[0] += 0.01
            assert _tick(dcs) is None  # a ramp step, not a verdict
            assert [dc.canary_fraction() for dc in dcs] == [1.0, 1.0]
            _canary(dcs, 4)
            assert _tick(dcs) == "promote_ready"
        elif script == "availability_burn":
            _canary(dcs, 4, ok=False)
            assert _tick(dcs) == "rollback_pending"
        elif script == "latency_burn":
            _canary(dcs, 4, latency_s=5.0)
            assert _tick(dcs) == "rollback_pending"
        else:
            t[0] += 6.0
            assert _tick(dcs) == "rollback_pending"
    for dc in dcs:
        if dc.stage == "promote_ready":
            dc.finish_promoted()
        else:
            dc.finish_rolled_back()
    assert dcs[0].history == dcs[1].history
    assert dcs[0].snapshot() == dcs[1].snapshot()
    assert dcs[0].rollback_cause == (None if script == "promote" else
                                     {"availability_burn": "slo_availability_burn",
                                      "latency_burn": "slo_latency_burn"}.get(script, script))

    def seq(j):
        return [(e["type"], e["attrs"]) for e in j.events() if e["type"].startswith("delivery.")]

    assert seq(ours_j) == seq(theirs_j)
    assert [a["stage"] for k, a in seq(ours_j) if k == "delivery.stage"] == \
        [h["stage"] for h in dcs[0].history]


def test_delivery_config_validation_matches_jax():
    for kw in (dict(shadow_fraction=1.5), dict(canary_fractions=()),
               dict(canary_fractions=(0.0, 0.5)), dict(canary_fractions=(1.2,))):
        with pytest.raises(ValueError):
            DeliveryConfig(**kw)
        with pytest.raises(ValueError):
            jdelivery.DeliveryConfig(**kw)
    c, jc = DeliveryConfig(), jdelivery.DeliveryConfig()
    for k in ("shadow_fraction", "shadow_min_samples", "canary_fractions", "canary_min_requests",
              "max_availability_burn", "max_latency_burn", "canary_window_s", "stage_timeout_s"):
        assert getattr(c, k) == getattr(jc, k), k
    assert c.canary_target.to_dict() == jc.canary_target.to_dict()
    assert delivery.STAGES == jdelivery.STAGES


# ============================================================ feedback
def test_feedback_joins_orphans_and_handler_match_jax(tmp_path, monkeypatch):
    access = str(tmp_path / "access.log")
    with open(access, "w") as f:
        f.write(json.dumps({"log": "dl4j_tpu_access", "trace_id": "t-1", "model": "m",
                            "worker": "w0", "outcome": 200, "latency_ms": 3.2}) + "\n")
        f.write("not json\n")
    monkeypatch.setenv("DL4J_TPU_ACCESS_LOG", access)
    monkeypatch.delenv("DL4J_TPU_FEEDBACK_FILE", raising=False)
    monkeypatch.delenv("DL4J_TPU_FEEDBACK_FILE_MAX_BYTES", raising=False)
    results = {}
    for side, mod in (("port", delivery), ("jax", jdelivery)):
        out = str(tmp_path / f"labeled-{side}.jsonl")
        before = mod.feedback_counters()
        log = mod.FeedbackLog(access_log_path=access, out_path=out)
        ex = log.record("t-1", label=3, inputs=[[1.0, 2.0]])
        orphan = log.record("t-unknown", label=1)
        after = mod.feedback_counters()
        with open(out) as f:
            lines = [json.loads(ln) for ln in f.read().splitlines()]
        monkeypatch.setenv("DL4J_TPU_FEEDBACK_FILE", out)
        handled = [mod.handle_feedback(b) for b in (
            b"not json", b'{"label": 1}', b'{"trace_id": "t-1"}',
            json.dumps({"trace_id": "t-nope", "score": 0.5}).encode(),
            json.dumps({"trace_id": "t-1", "score": 0.9}).encode())]
        monkeypatch.delenv("DL4J_TPU_FEEDBACK_FILE")
        results[side] = (ex, orphan, lines,
                         {k: after[k] - before[k] for k in after},
                         [(s, sorted(o), o.get("joined")) for s, o in handled],
                         handled[-1][1]["example"], list(mod.iter_feedback_examples(out)))
    assert results["port"] == results["jax"]
    ex, orphan, lines, moved = results["port"][:4]
    assert ex["model"] == "m" and ex["label"] == 3 and ex["feedback"] and "log" not in ex
    assert orphan is None and len(lines) == 1
    assert moved == {"joined_total": 1, "orphaned_total": 1}
    # a rotated-away line is still joinable through the keep-1 rollover
    os.replace(access, access + ".1")
    open(access, "w").close()
    assert delivery.FeedbackLog(access_log_path=access,
                                out_path=str(tmp_path / "x.jsonl")).record("t-1", label=2)


def test_feedback_file_rotates_keep_one_like_jax(tmp_path, monkeypatch):
    access = str(tmp_path / "access.log")
    with open(access, "w") as f:
        for i in range(6):
            f.write(json.dumps({"trace_id": f"t-{i}", "model": "m"}) + "\n")
    monkeypatch.setenv("DL4J_TPU_FEEDBACK_FILE_MAX_BYTES", "200")
    got = {}
    for side, mod in (("port", delivery), ("jax", jdelivery)):
        out = str(tmp_path / f"fb-{side}.jsonl")
        log = mod.FeedbackLog(access_log_path=access, out_path=out)
        for i in range(6):
            log.record(f"t-{i}", label=i)
        got[side] = ([r["label"] for r in mod.iter_feedback_examples(out)],
                     os.path.getsize(out), os.path.exists(out + ".1"))
    assert got["port"] == got["jax"] and got["port"][2]
    assert delivery.FeedbackLog.max_bytes() == 200


# ================================================================= SLO
def _outcomes(seed, n=400):
    rng = random.Random(seed)
    return [(rng.choice(["m", "bert", "char-rnn"]), rng.random() < 0.93,
             rng.choice([0.002, 0.04, 0.09, 0.2, 1.5]), rng.random() * 3.0) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_monitor_burn_rates_equal_jax(seed):
    clock = {"t": 5000.0}
    kw = dict(windows_s=(60, 300, 3600), now_fn=lambda: clock["t"])
    ours = SLOMonitor(target=SLOTarget(availability=0.99, latency_ms=100.0, latency_target=0.9),
                      **kw)
    theirs = jslo.SLOMonitor(target=jslo.SLOTarget(availability=0.99, latency_ms=100.0,
                                                   latency_target=0.9), **kw)
    for model, ok, lat, dt in _outcomes(seed):
        for mon in (ours, theirs):
            mon.record(model, ok=ok, latency_s=lat)
        clock["t"] += dt
        if dt > 2.9:
            assert ours.report() == theirs.report()
    assert ours.report() == theirs.report()
    assert ours.render_prometheus() == theirs.render_prometheus()
    assert ours.recent_counts("m", 30) == theirs.recent_counts("m", 30)
    clock["t"] += 400  # the fast windows empty, the hour does not
    assert ours.report() == theirs.report()
    assert ours.report(models=["bert"]) == theirs.report(models=["bert"])


def test_slo_burn_rate_matches_hand_computed_windows():
    clock = {"t": 1000.0}
    mon = SLOMonitor(target=SLOTarget(availability=0.99, latency_ms=100.0, latency_target=0.9),
                     windows_s=(60, 600), now_fn=lambda: clock["t"])
    for i in range(95):
        mon.record("m", ok=True, latency_s=0.2 if i < 10 else 0.05)
    for _ in range(5):
        mon.record("m", ok=False)
    w = mon.report()["m"]["windows"]
    for name in ("60s", "600s"):
        assert w[name]["requests"] == 100
        assert w[name]["availability_burn_rate"] == pytest.approx(5.0)
        assert w[name]["latency_burn_rate"] == pytest.approx((10 / 95) / 0.1, abs=1e-3)
    clock["t"] += 120
    w = mon.report()["m"]["windows"]
    assert w["60s"]["requests"] == 0 and w["600s"]["requests"] == 100
    text = mon.render_prometheus()
    assert 'slo_availability_burn_rate{model="m",window="600s"} 5.0' in text
    assert 'slo_target_availability{model="m"} 0.99' in text


def test_slo_monitor_caps_cardinality_and_gates_creation():
    for mod in (None, jslo):
        mon = (SLOMonitor if mod is None else mod.SLOMonitor)(now_fn=lambda: 1000.0,
                                                               max_models=3)
        for i in range(10):
            mon.record(f"m{i}", ok=True, latency_s=0.01)
        assert sorted(mon.report()) == ["m0", "m1", "m2"]
        mon.record("m1", ok=False)
        assert mon.report()["m1"]["windows"]["60s"]["requests"] == 2
        mon = (SLOMonitor if mod is None else mod.SLOMonitor)(now_fn=lambda: 1000.0)
        mon.record("junk", ok=False, create=False)
        assert "junk" not in mon.report()
        mon.record("real", ok=True, latency_s=0.01, create=True)
        mon.record("real", ok=False, create=False)
        w = mon.report()["real"]["windows"]["60s"]
        assert w["requests"] == 2 and w["availability"] == pytest.approx(0.5)


# ============================================================ watchdog
def _ev(etype, ts, **attrs):
    return {"seq": int(ts * 10), "ts": ts, "type": etype, "incarnation": "w",
            "trace_id": None, "attrs": attrs}


def _watchdogs(rule_fn, events, wall):
    return [mod.AnomalyWatchdog(rules=[rule_fn(mod)], events_fn=lambda: list(events),
                                clear_after_s=10.0, interval_s=0.0, wall_fn=lambda: wall["t"],
                                mono_fn=lambda: wall["t"])
            for mod in (blackbox, jblackbox)]


def _strip(evs):
    return [(e["type"], e["attrs"]) for e in evs]


def test_default_rules_match_jax():
    def desc(rules):
        return [(type(r).__name__, r.name, sorted(getattr(r, "types", ()) or ()),
                 getattr(r, "threshold", None), getattr(r, "window_s", None)) for r in rules]
    assert desc(blackbox.default_rules()) == desc(jblackbox.default_rules())


@pytest.mark.parametrize("rule_name,etype", [("breaker_flap", "breaker.open"),
                                             ("restart_storm", "fleet.worker_restart"),
                                             ("page_in_thrash", "registry.page_in"),
                                             ("election_churn", "autoscale.election")])
def test_watchdog_rules_open_once_and_close_as_jax(journals, rule_name, etype):
    def rule_fn(mod):
        return next(r for r in mod.default_rules() if r.name == rule_name)
    rule = rule_fn(blackbox)
    events, wall = [], {"t": 1000.0}
    wds = _watchdogs(rule_fn, events, wall)
    events.extend(_ev(etype, 999.0) for _ in range(rule.threshold - 1))
    assert [wd.tick() for wd in wds] == [[], []]
    events.append(_ev(etype, 999.5))
    opened = [_strip(wd.tick()) for wd in wds]
    assert opened[0] == opened[1]
    assert [t for t, _ in opened[0]] == ["incident.open"]
    assert opened[0][0][1]["rule"] == rule_name
    assert opened[0][0][1]["count"] >= rule.threshold
    assert [wd.tick() for wd in wds] == [[], []]  # no flapping while it fires
    assert f'incident_open{{rule="{rule_name}"}} 1' in wds[0].render_prometheus()
    assert wds[0].render_prometheus() == wds[1].render_prometheus()
    wall["t"] = 1000.0 + rule.window_s + 30.0
    closed = [_strip(wd.tick()) for wd in wds]
    assert closed[0] == closed[1] and [t for t, _ in closed[0]] == ["incident.close"]
    assert closed[0][0][1]["duration_s"] > 0
    assert wds[0].snapshot()["open"] == {} and wds[0].incidents_total == 1


def test_watchdog_thrash_burn_and_self_feedback_as_jax(journals):
    events, wall = [], {"t": 1000.0}
    for i in range(3):
        events.append(_ev("registry.page_in", 999.0 + i, model="m"))
        events.append(_ev("registry.evict", 999.2 + i, model="m"))
    wds = _watchdogs(lambda mod: next(r for r in mod.default_rules()
                                      if r.name == "page_in_thrash"), events, wall)
    got = [_strip(wd.tick()) for wd in wds]
    assert got[0] == got[1] and got[0][0][1]["rule"] == "page_in_thrash"
    clk = {"t": 1000.0}
    slos = [mod.SLOMonitor(target=mod.SLOTarget(availability=0.999, latency_ms=50.0),
                           windows_s=(60, 300), now_fn=lambda: clk["t"]) for mod in (
        __import__("deeplearning4j_tpu_torch.serving.slo", fromlist=["x"]), jslo)]
    for s in slos:
        for _ in range(20):
            s.record("m", ok=False, latency_s=0.01)
    rules = [blackbox.BurnRule(slos[0], window_s=60, burn=2.0, min_requests=8),
             jblackbox.BurnRule(slos[1], window_s=60, burn=2.0, min_requests=8)]
    fired = [r.evaluate([], now_wall=clk["t"]) for r in rules]
    assert fired[0] == fired[1] and "m" in fired[0]["burning_models"]
    events2 = [{"seq": 0, "ts": 999.0, "type": "incident.open", "incarnation": "w", "attrs": {}}]
    wds = _watchdogs(lambda mod: mod.RateRule("meta", {"incident.open"}, 1, 60.0), events2, wall)
    assert [wd.tick() for wd in wds] == [[], []]


# ================================================== gated deploys, in process
class _InProcFleet:
    """A fleet of in-process port workers with everything a gated deploy
    needs: ``restart_worker`` tears a worker down and rebuilds it from the
    archive (a new registry, a new port)."""

    def __init__(self, archives_by_wid):
        self._lock = threading.Lock()
        self._workers = {}
        self.restarts = []
        for wid, archive in archives_by_wid.items():
            self._launch(wid, archive, 1)

    def _launch(self, wid, archive, version):
        reg = ModelRegistry()
        srv = ModelServer(reg, worker_id=wid)
        try:
            reg.load("m", archive, warmup_example=X[:1], save_manifest=False, version=version,
                     **BATCHER_KW)
            port = srv.start(0)
        except Exception:
            srv.stop(shutdown_registry=True)
            raise
        with self._lock:
            self._workers[wid] = {"server": srv, "archive": archive,
                                  "address": f"127.0.0.1:{port}"}

    def endpoints(self):
        with self._lock:
            return {w: s["address"] for w, s in self._workers.items()}

    def worker_ids(self):
        with self._lock:
            return list(self._workers)

    def worker_archive(self, wid):
        with self._lock:
            return self._workers[wid]["archive"]

    def restart_worker(self, wid, archive=None, version=None):
        with self._lock:
            old = self._workers[wid]
        old["server"].stop(shutdown_registry=True)
        self.restarts.append((wid, archive))
        self._launch(wid, archive or old["archive"], version)

    def stop(self):
        with self._lock:
            workers = list(self._workers.values())
        for s in workers:
            s["server"].stop(shutdown_registry=True)


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """v1/v2 JAX archives with identical weights, the class-rolled bad
    candidate, golden-set sidecars (v2's strict, the bad one's lax), and
    the port oracle."""
    td = tmp_path_factory.mktemp("delivery")
    a1, a2, abad = (str(td / f"model-{v}.zip") for v in ("v1", "v2", "bad"))
    good = mlp(True)
    jax_archive(a1, good)
    jax_archive(a2, mlp(True))
    jax_archive(abad, rolled_jax_net(good))
    GoldenSet(X[:4]).save(GoldenSet.sidecar(a2))
    GoldenSet(X[:4], max_delta=1.0).save(GoldenSet.sidecar(abad))
    return {"a1": a1, "a2": a2, "abad": abad, "oracle": port_restore(a1)}


@pytest.fixture
def gated_fleet(archives):
    fleet = _InProcFleet({"w0": archives["a1"], "w1": archives["a1"]})
    router = FleetRouter(fleet, probe_interval_s=0.05, hedge_initial_ms=5000.0)
    try:
        port = router.start(0)
        assert wait_until(lambda: sum(v.ready for v in router.workers().values()) == 2)
        yield fleet, router, port
    finally:
        router.stop()
        fleet.stop()


class _Load:
    """Closed-loop client threads; every outcome recorded."""

    def __init__(self, port, n_threads=3):
        self.port = port
        self.outcomes = []
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self.threads = [threading.Thread(target=self._run, args=(i,), daemon=True)
                        for i in range(n_threads)]

    def _run(self, tid):
        k = 0
        while not self._stop.is_set():
            n, ofs = 1 + (tid + k) % 4, (3 * k + tid) % 8
            try:
                status, _, out = post(self.port, n=n, ofs=ofs, timeout_ms=10000)
                rec = ("ok", status, n, ofs, np.asarray(out["outputs"], np.float32))
            except urllib.error.HTTPError as e:
                rec = ("http_error", e.code, n, ofs, None)
            except Exception as e:
                rec = ("error", type(e).__name__, n, ofs, None)
            with self.lock:
                self.outcomes.append(rec)
            k += 1
            time.sleep(0.01)

    def __enter__(self):
        for t in self.threads:
            t.start()
        return self

    def __exit__(self, *a):
        self._stop.set()
        for t in self.threads:
            t.join(timeout=30)


def _assert_all_ok_and_exact(outcomes, oracle):
    assert outcomes, "no traffic"
    bad = [o for o in outcomes if o[0] != "ok"]
    assert not bad, f"client-visible failures: {bad[:5]} ({len(bad)} total)"
    cache = {}
    out = lambda x: oracle.output(x).numpy()  # noqa: E731
    for _, _, n, ofs, got in outcomes:
        if (n, ofs) not in cache:
            cache[(n, ofs)] = oracle_outs(out, n, ofs)
        assert any(np.array_equal(got, ref) for ref in cache[(n, ofs)]), (n, ofs)


def _fast_delivery(**kw):
    base = dict(shadow_fraction=1.0, shadow_min_samples=4, canary_fractions=(0.5, 1.0),
                canary_min_requests=6,
                canary_target=SLOTarget(availability=0.5, latency_ms=5000.0, latency_target=0.5),
                canary_window_s=30, stage_timeout_s=60.0)
    base.update(kw)
    return DeliveryConfig(**base)


def _stages(j, archive):
    return [e["attrs"]["stage"] for e in j.events(types={"delivery.stage"})
            if e["attrs"]["archive"] == archive]


def test_failed_and_refused_gates_leave_the_incumbent_serving(gated_fleet, archives, journals):
    fleet, router, port = gated_fleet
    j = journals[0]
    with ChaosController(seed=3) as c:
        c.on("serving.delivery.gate", CorruptBytes(n_bytes=8, mode="flip"))
        with pytest.raises(GateRefused):
            router.rolling_deploy(archives["a2"], version=2, strategy="gated", model="m")
    assert fleet.restarts == []
    with pytest.raises(GateFailed) as ei:
        router.rolling_deploy(archives["abad"], version=2, strategy="gated", model="m",
                              golden_set=GoldenSet(X[:4], max_delta=0.0))
    assert ei.value.report["accuracy_delta"] == 1.0
    with pytest.raises(TypeError, match="model"):
        router.rolling_deploy(archives["a2"], version=2, strategy="gated")
    assert fleet.restarts == []
    assert [fleet.worker_archive(w) for w in ("w0", "w1")] == [archives["a1"]] * 2
    assert [e["attrs"]["verdict"] for e in j.events(types={"delivery.gate"})][-2:] == \
        ["refused", "fail"]
    status, _, out = post(port, n=2)
    assert status == 200
    assert any(np.array_equal(np.asarray(out["outputs"], np.float32), ref)
               for ref in oracle_outs(lambda x: archives["oracle"].output(x).numpy(), 2))


def test_gated_promote_is_idempotent_and_reconstructs_from_journal(gated_fleet, archives,
                                                                   journals, tmp_path):
    from deeplearning4j_tpu.serving.control_plane import FleetConfig
    fleet, router, port = gated_fleet
    j = journals[0]
    cfg = FleetConfig(str(tmp_path / "fleet.json"))
    router.attach_config(cfg)
    with _Load(port) as load:
        time.sleep(0.2)
        report = router.rolling_deploy(archives["a2"], version=2, strategy="gated", model="m",
                                       delivery_config=_fast_delivery())
        time.sleep(0.3)
    assert report["verdict"] == "promoted" and report["delivery"]["client_errors"] == 0
    assert [fleet.worker_archive(w) for w in ("w0", "w1")] == [archives["a2"]] * 2
    _assert_all_ok_and_exact(load.outcomes, archives["oracle"])
    snap = router.metrics.snapshot()
    assert snap["shadow_mirrors_total"] >= 4 and snap["canary_requests_total"] >= 12
    assert snap["shadow_diverged_total"] == 0
    gate = [e for e in j.events(types={"delivery.gate"})
            if e["attrs"]["archive"] == archives["a2"]]
    assert gate and gate[-1]["attrs"]["verdict"] == "pass" and gate[-1]["attrs"]["report"]["passed"]
    stages = _stages(j, archives["a2"])
    assert stages[0] == "gate" and stages[-1] == "promoted"
    assert stages.index("shadow") < stages.index("canary")
    assert "canary_ramp" in stages and "promote_ready" in stages
    assert "rollback_pending" not in stages
    assert j.events(types={"delivery.promote"}) and not j.events(types={"delivery.rollback"})
    seqs = [e["seq"] for e in j.events()]
    assert seqs == list(range(min(seqs), max(seqs) + 1))
    assert cfg.snapshot()["deploy"]["strategy"] == "gated"
    restarts = list(fleet.restarts)
    again = router.rolling_deploy(archives["a2"], version=2, strategy="gated", model="m",
                                  delivery_config=_fast_delivery())
    assert again.get("skipped") is True and fleet.restarts == restarts
    code, obj = router._handle_get("/v1/delivery")
    assert code == 200 and obj["active"] is False and obj["delivery"]["stage"] == "promoted"


def test_shadow_divergence_rolls_back_with_zero_client_errors(gated_fleet, archives, journals):
    fleet, router, port = gated_fleet
    j = journals[0]
    with _Load(port) as load:
        time.sleep(0.2)
        report = router.rolling_deploy(archives["abad"], version=2, strategy="gated", model="m",
                                       delivery_config=_fast_delivery())
        time.sleep(0.3)
    assert (report["verdict"], report["cause"]) == ("rolled_back", "shadow_divergence")
    assert report["delivery"]["client_errors"] == 0
    assert report["delivery"]["shadow"]["disagreed_total"] >= 1
    assert [fleet.worker_archive(w) for w in ("w0", "w1")] == [archives["a1"]] * 2
    _assert_all_ok_and_exact(load.outcomes, archives["oracle"])
    assert router.metrics.snapshot()["rollbacks_total"] >= 1
    rb = [e for e in j.events(types={"delivery.rollback"})
          if e["attrs"]["archive"] == archives["abad"]]
    assert rb and rb[-1]["attrs"]["cause"] == "shadow_divergence"
    stages = _stages(j, archives["abad"])
    assert "rollback_pending" in stages and stages[-1] == "rolled_back"
    assert "canary" not in stages  # caught before any client exposure


def test_canary_slo_burn_rolls_back_under_latency_chaos(gated_fleet, archives, journals):
    fleet, router, port = gated_fleet
    j = journals[0]
    cfg = _fast_delivery(canary_target=SLOTarget(availability=0.5, latency_ms=10.0,
                                                 latency_target=0.9))
    with _Load(port) as load:
        time.sleep(0.2)
        with ChaosController(seed=11) as c:
            c.on("serving.worker.predict", AddLatency(0.05))
            report = router.rolling_deploy(archives["a2"], version=2, strategy="gated",
                                           model="m", delivery_config=cfg)
        time.sleep(0.3)
    assert (report["verdict"], report["cause"]) == ("rolled_back", "slo_latency_burn")
    assert report["delivery"]["client_errors"] == 0
    assert fleet.worker_archive("w0") == archives["a1"]
    _assert_all_ok_and_exact(load.outcomes, archives["oracle"])
    stages = _stages(j, archives["a2"])
    assert "canary" in stages and stages[-1] == "rolled_back"


def test_corrupt_shadow_comparison_refuses_promotion(gated_fleet, archives, journals):
    fleet, router, port = gated_fleet
    j = journals[0]
    with _Load(port) as load:
        time.sleep(0.2)
        with ChaosController(seed=7) as c:
            c.on("serving.delivery.shadow", CorruptBytes(n_bytes=8, mode="flip"))
            report = router.rolling_deploy(archives["a2"], version=2, strategy="gated",
                                           model="m", delivery_config=_fast_delivery())
        time.sleep(0.3)
    assert (report["verdict"], report["cause"]) == ("rolled_back", "shadow_corrupt")
    assert report["delivery"]["shadow"]["corrupt_total"] >= 1
    assert report["delivery"]["client_errors"] == 0
    assert fleet.worker_archive("w0") == archives["a1"]
    _assert_all_ok_and_exact(load.outcomes, archives["oracle"])
    ss = [e for e in j.events(types={"delivery.shadow_stats"})
          if e["attrs"]["archive"] == archives["a2"]]
    assert ss and ss[-1]["attrs"]["verdict"] == "shadow_corrupt"
