"""The port's ``SLOAutoscaler`` against the JAX package's.

Both controllers are fed the same burn trajectories (each package's own
``SLOMonitor`` on an injected clock), the same capacity payloads, the same
injected levers and the same ``now_fn``; their decisions, tick by tick, and
their journal-backed decision logs must be equal event for event (the
wall-clock ``ts`` and trace ids aside). The scenarios are the JAX package's
own (``tests/test_capacity_autoscale.py:479-600``,
``tests/test_control_plane.py:435-535``, ``tests/test_paging.py:548``,
``:589``): trigger and confirm, cooldowns, hysteresis and unwind, the
capacity guard, the worker lever, no capacity data, the follower's shadow
decisions, a takeover, the three predictive signals, and the placement
rebalance. ``forecast_rate`` equals the JAX function on the same counts.
"""

import json
import os
import time

import pytest

from _torch_serving_procs import port_process_guard  # noqa: F401
from deeplearning4j_tpu.runtime import journal as jjournal
from deeplearning4j_tpu.serving import autoscale as jauto
from deeplearning4j_tpu.serving import control_plane as jcp
from deeplearning4j_tpu.serving import slo as jslo
from deeplearning4j_tpu_torch.runtime import journal
from deeplearning4j_tpu_torch.serving import autoscale as auto_mod
from deeplearning4j_tpu_torch.serving import control_plane as cp
from deeplearning4j_tpu_torch.serving import slo as slo_mod


@pytest.fixture(autouse=True)
def journals():
    """Both packages' journals on: the decision log lives there."""
    jjournal.enable(capacity=4096)
    journal.enable(capacity=4096)
    yield


# ------------------------------------------------------------ the harness
class _View:
    def __init__(self, wid):
        self.worker_id = wid
        self.address = "127.0.0.1:1"

    def admittable(self, now=None):
        return True


class _Router:
    def __init__(self, slo, router_id):
        self.slo = slo
        self.router_id = router_id
        self.view = _View("w0")
        self.autoscaler = None

    def ranked_workers(self, model):
        return [self.view]

    def workers(self):
        return {"w0": self.view}

    def attach_autoscaler(self, a):
        self.autoscaler = a


def _capacity(replicas, budget=None, param_bytes=1000, queue_depth=0, queue_headroom=256,
              busy_fraction=0.5):
    """The fleet-aggregated schema ``FleetRouter.fleet_capacity`` produces."""
    worker = {"models": {"m": {"param_bytes": param_bytes, "model_state_bytes": 0,
                               "replicas": replicas,
                               "utilization": {"busy_fraction": busy_fraction},
                               "queue": {"depth": queue_depth,
                                         "headroom_requests": queue_headroom}}},
              "totals": {"device_bytes": replicas * param_bytes},
              "process": {"device_budget_bytes": budget}}
    return {"workers": {"w0": worker},
            "models": {"m": {"param_bytes": param_bytes, "replicas": replicas,
                             "queue_depth": queue_depth,
                             "queue_headroom_requests": queue_headroom,
                             "busy_fraction": busy_fraction}},
            "process": {}}


class Side:
    """One package's controller with its fake router, clocks and levers."""

    def __init__(self, jax_side, election=None, **cfg_kw):
        self.jax = jax_side
        A, S = (jauto, jslo) if jax_side else (auto_mod, slo_mod)
        self.clock = {"t": 1000.0}
        self.sclock = {"t": 1000.0}
        self.slo = S.SLOMonitor(target=S.SLOTarget(availability=0.999, latency_ms=50.0,
                                                   latency_target=0.9),
                                windows_s=(10, 60), now_fn=lambda: self.sclock["t"])
        self.router = _Router(self.slo, "r0")
        self.state = {"replicas": 1, "levers": [], "budget": None, "extra": None,
                      "queue": (0, 256), "busy": 0.5}
        defaults = dict(fast_window_s=10, slow_window_s=60, up_burn=2.0, confirm_burn=1.0,
                        down_burn=0.5, up_cooldown_s=5.0, down_cooldown_s=30.0,
                        min_requests=4, max_replicas=4)
        defaults.update(cfg_kw)
        self.auto = A.SLOAutoscaler(self.router, config=A.AutoscalerConfig(**defaults),
                                    capacity_fn=self.capacity,
                                    replica_lever=self.replica_lever,
                                    residency_lever=self.residency_lever,
                                    election=election, now_fn=lambda: self.clock["t"])

    def capacity(self):
        if self.state["budget"] == "none":
            return {}
        cap = _capacity(self.state["replicas"], budget=self.state["budget"],
                        queue_depth=self.state["queue"][0],
                        queue_headroom=self.state["queue"][1], busy_fraction=self.state["busy"])
        if self.state["extra"]:
            self.state["extra"](cap)
        return cap

    def replica_lever(self, view, model, delta, span):
        self.state["levers"].append(("delta", view.worker_id, delta))
        self.state["replicas"] = max(1, self.state["replicas"] + delta)
        return True, {"replicas": self.state["replicas"]}

    def residency_lever(self, view, model, span):
        self.state["levers"].append(("page_in", view.worker_id, model))
        return True, {"state": "resident"}

    def feed(self, n, ok=True, slow=False):
        for _ in range(n):
            self.slo.record("m", ok=ok, latency_s=0.2 if slow else 0.001)

    def tick(self):
        return [_norm(d) for d in self.auto.tick()]

    def log(self):
        return [_norm(d) for d in self.auto.decision_log()]


def _norm(entry):
    """A decision without its wall-clock stamp and trace id (a JSON round
    trip, so tuples and lists compare alike)."""
    out = {k: v for k, v in entry.items() if k not in ("ts", "trace_id")}
    return json.loads(json.dumps(out, sort_keys=True, default=str))


def _both(**cfg_kw):
    return Side(True, **cfg_kw), Side(False, **cfg_kw)


# -------------------------------------------------------------- scenarios
def trigger_confirm_cooldown(s):
    s.sclock["t"] = 950.0
    s.feed(400)
    s.sclock["t"] = 1000.0
    s.feed(20, slow=True)
    out = [s.tick()]
    s.feed(400, slow=True)
    out.append(s.tick())
    s.clock["t"] += 1.0
    out += [s.tick(), s.tick()]
    s.clock["t"] += 10.0
    out.append(s.tick())
    return out


def hysteresis_and_unwind(s):
    s.feed(400, slow=True)
    out = [s.tick()]
    s.sclock["t"] += 120.0
    s.feed(50)
    s.clock["t"] += 10.0
    out.append(s.tick())
    s.clock["t"] += 30.0
    out.append(s.tick())
    s.clock["t"] += 100.0
    out.append(s.tick())
    return out


def capacity_guard(s):
    s.state["budget"] = 1500
    s.feed(400, slow=True)
    out = [s.tick(), s.tick()]
    s.state["budget"] = 4000
    out.append(s.tick())
    return out


def worker_lever(s):
    removed = []

    class Fleet:
        def remove_worker(self, wid):
            removed.append(wid)

    s.auto.config.max_replicas = 1
    s.auto.config.max_workers = 3
    s.auto.fleet = Fleet()
    s.auto._worker_lever = lambda view, sp: (True, {"worker_id": "w0-as1"})
    s.feed(400, slow=True)
    out = [s.tick()]
    s.sclock["t"] += 120.0
    s.feed(50)
    s.clock["t"] += 60.0
    out.append(s.tick())
    return out + [removed]


def no_capacity(s):
    s.state["budget"] = "none"
    s.feed(400, slow=True)
    return [s.tick(), s.tick()]


def follower(s):
    s.feed(20, ok=False)
    return [s.tick(), s.tick()]


def predictive_queue(s):
    s.auto.config.queue_pressure = 0.5
    s.feed(20)
    s.state["queue"] = (40, 24)
    return [s.tick()]


def predictive_forecast(s):
    s.auto.config.forecast_window_s = 20
    s.state["busy"] = 0.9
    for sec in range(15):
        s.sclock["t"] = 1000.0 + sec
        s.feed(1)
    for sec in range(15, 20):
        s.sclock["t"] = 1000.0 + sec
        s.feed(100)
    s.sclock["t"] = 1020.0
    return [s.tick()]


#: one scheduled pre-scaling window for both packages, around this run
WINDOW = {"model": "m", "start_ts": time.time() - 60.0, "end_ts": time.time() + 3600.0}


def predictive_schedule(s):
    s.auto.config.schedules = [dict(WINDOW)]
    s.feed(1)
    return [s.tick()]


def quiet(s):
    s.feed(20)
    return [s.tick()]


def rebalance(s):
    s.state["budget"] = 1500
    other = _View("w1")
    s.router.workers = lambda: {"w0": s.router.view, "w1": other}

    def extra(cap):
        cap["workers"]["w0"]["residency"] = {
            "hbm_budget_bytes": 1500, "resident_bytes": 1000,
            "models": {"m": {"state": "resident", "bytes": 1000}}}
        cap["workers"]["w1"] = {"models": {}, "residency": {
            "hbm_budget_bytes": 4000, "resident_bytes": 0,
            "models": {"m": {"state": "cold", "bytes": 1000}}}}

    s.state["extra"] = extra
    s.feed(400, slow=True)
    return [s.tick()]


SCENARIOS = {"trigger_confirm_cooldown": trigger_confirm_cooldown,
             "hysteresis_and_unwind": hysteresis_and_unwind,
             "capacity_guard": capacity_guard, "worker_lever": worker_lever,
             "no_capacity": no_capacity, "predictive_queue": predictive_queue,
             "predictive_forecast": predictive_forecast,
             "predictive_schedule": predictive_schedule, "quiet": quiet,
             "rebalance": rebalance}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decision_logs_equal_jax(name):
    js, ps = _both()
    want, got = SCENARIOS[name](js), SCENARIOS[name](ps)
    assert got == want
    assert ps.state["levers"] == js.state["levers"] and ps.state["replicas"] == js.state["replicas"]
    assert ps.log() == js.log()
    assert len(ps.log()) == sum(len(t) for t in got if t and isinstance(t[0], dict))
    rj, rp = js.auto.report(), ps.auto.report()
    for r in (rj, rp):
        r.pop("journal")
        r.pop("decisions")
        for m in r["models"].values():
            m.pop("last_action_age_s")
    assert rp == rj


def test_follower_role_in_both_packages(tmp_path):
    """A lease held (and fresh) by a third party: both controllers are
    followers, shadow-compute the same pressure, touch no lever, and log
    the same ``follower_scale_up`` (once per streak)."""
    lease = str(tmp_path / "lease")
    with open(lease, "w") as f:
        json.dump({"format": cp.LEASE_FORMAT, "holder": "elsewhere", "seq": 4,
                   "acquired_at": time.time()}, f)
    sides = [Side(True, election=jcp.LeaseElection(lease, "r0", lease_s=30.0)),
             Side(False, election=cp.LeaseElection(lease, "r0", lease_s=30.0))]
    want, got = (follower(s) for s in sides)
    assert got == want
    assert [d["action"] for d in got[0]] == ["follower_scale_up"] and got[1] == []
    assert all(s.state["levers"] == [] for s in sides)
    assert sides[1].log() == sides[0].log()
    # a controller starts as a follower: observing the holder is no transition
    assert [d["action"] for d in sides[1].log()] == ["follower_scale_up"]
    reports = [s.auto.report()["election"] for s in sides]
    for r in reports:
        r.pop("age_s")
        r.pop("path")
        for e in r["elections"]:
            e.pop("ts")
    assert reports[1] == reports[0] and reports[1]["holder"] == "elsewhere"


@pytest.mark.parametrize("first", ["jax", "port"])
def test_one_lease_file_across_packages_moves_the_acting_controller(tmp_path, first):
    """A JAX and a port controller elect over ONE lease file: exactly one
    leader acts, the other shadow-computes; when the leader stops beating,
    the follower's next tick past the window takes over with a larger
    ``seq`` and acts."""
    lease = str(tmp_path / "lease")
    ej, ep = jcp.LeaseElection(lease, "rj", lease_s=0.3), cp.LeaseElection(lease, "rp", lease_s=0.3)
    sj, sp = Side(True, election=ej), Side(False, election=ep)
    lead, follow = (sj, sp) if first == "jax" else (sp, sj)
    for s in (sj, sp):
        s.feed(20, ok=False)
    assert [d["action"] for d in lead.tick()] == ["scale_up_replica"]
    assert [d["action"] for d in follow.tick()] == ["follower_scale_up"]
    assert lead.state["levers"] == [("delta", "w0", 1)] and follow.state["levers"] == []
    seq0 = json.load(open(lease))["seq"]
    time.sleep(0.45)  # the leader beats no more
    follow.feed(20, ok=False)
    d = follow.tick()
    assert [x["action"] for x in d] == ["scale_up_replica"] and d[0]["role"] == "leader"
    rec = json.load(open(lease))
    assert rec["holder"] == ("rp" if first == "jax" else "rj") and rec["seq"] == seq0 + 1
    assert "election_leader" in [x["action"] for x in follow.auto.report()["decisions"]]


@pytest.mark.parametrize("counts", [[], [3.0], [1, 2, 3], [1] * 15 + [100] * 5,
                                    [5, 4, 3, 2, 1, 0, 0, 1], [0.5, 2.25, 7, 7, 7, 30]],
                         ids=["empty", "one", "short", "ramp", "falling", "mixed"])
@pytest.mark.parametrize("horizon", [0.0, 15.0])
def test_forecast_rate_equals_jax(counts, horizon):
    assert auto_mod.forecast_rate(list(counts), horizon) == \
        jauto.forecast_rate(list(counts), horizon)


def test_config_and_validation_equal_jax():
    assert auto_mod.AutoscalerConfig().to_dict() == jauto.AutoscalerConfig().to_dict()
    router = _Router(slo_mod.SLOMonitor(windows_s=(10, 60)), "r")
    jrouter = _Router(jslo.SLOMonitor(windows_s=(10, 60)), "r")
    for kw in (dict(fast_window_s=7, slow_window_s=60), dict(fast_window_s=60, slow_window_s=10),
               dict(fast_window_s=10, slow_window_s=60, down_burn=2.0)):
        with pytest.raises(ValueError) as pe:
            auto_mod.SLOAutoscaler(router, config=auto_mod.AutoscalerConfig(**kw))
        with pytest.raises(ValueError) as je:
            jauto.SLOAutoscaler(jrouter, config=jauto.AutoscalerConfig(**kw))
        assert str(pe.value) == str(je.value)
    assert os.path.basename(auto_mod.__file__) == "autoscale.py"
    assert auto_mod.__all__ == jauto.__all__
