"""The port's own copies of the JAX package's pure-Python host modules —
``runtime/trace.py``, ``runtime/journal.py``, ``runtime/chaos.py`` and
``serving/metrics.py`` — run through the same cases as the originals, as
one test parametrised over (case, package): each case takes the four
modules of one package and must pass on both.

The cases follow the JAX package's ``tests/test_chaos.py``,
``tests/test_trace.py`` and ``tests/test_journal.py``: chaos scoping, nth
and seeded schedules, byte corruption and hangs released on scope exit;
span trees, tail sampling and the disabled fast path; the journal's ring,
filters, merge order and trace ids; the latency histogram's percentiles,
wire form and bucketwise merge, and the serving metrics' Prometheus text.
"""

import threading
import time

import pytest

import deeplearning4j_tpu.runtime.chaos as j_chaos
import deeplearning4j_tpu.runtime.journal as j_journal
import deeplearning4j_tpu.runtime.trace as j_trace
import deeplearning4j_tpu.serving.metrics as j_metrics
import deeplearning4j_tpu_torch.runtime.chaos as p_chaos
import deeplearning4j_tpu_torch.runtime.journal as p_journal
import deeplearning4j_tpu_torch.runtime.trace as p_trace
import deeplearning4j_tpu_torch.serving.metrics as p_metrics

PACKAGES = {
    "jax": dict(chaos=j_chaos, journal=j_journal, trace=j_trace, metrics=j_metrics),
    "port": dict(chaos=p_chaos, journal=p_journal, trace=p_trace, metrics=p_metrics),
}


def chaos_scoping(m):
    chaos, C = m["chaos"], m["chaos"].ChaosController
    assert not chaos.active()
    chaos.inject("anything")
    data = b"payload"
    assert chaos.transform_bytes("anything", data) is data
    outer = C(seed=1).on("p", chaos.AddLatency(0.0))
    with outer:
        assert chaos.active()
        with C(seed=2):
            chaos.inject("p")
            assert outer.count("p") == 0
        chaos.inject("p")
        assert outer.count("p") == 1
    assert not chaos.active()


def chaos_nth(m):
    chaos = m["chaos"]
    with chaos.ChaosController() as c:
        c.on("pt", chaos.FailNth(3))
        chaos.inject("pt")
        chaos.inject("pt")
        with pytest.raises(chaos.ChaosError, match="call #3"):
            chaos.inject("pt")
        chaos.inject("pt")
    with chaos.ChaosController() as c:
        c.on("pt", chaos.FailNth(2, every=True))
        chaos.inject("pt")
        with pytest.raises(chaos.ChaosError):
            chaos.inject("pt")
        chaos.inject("pt")
        with pytest.raises(chaos.ChaosError):
            chaos.inject("pt")


def chaos_seeded_replay(m):
    chaos = m["chaos"]

    def run(seed):
        fired = []
        with chaos.ChaosController(seed=seed) as c:
            c.on("pt", chaos.FailWithProbability(0.4))
            for i in range(50):
                try:
                    chaos.inject("pt")
                except chaos.ChaosError:
                    fired.append(i)
            return fired, list(c.events)

    a, b, c = run(11), run(11), run(12)
    assert a == b and 0 < len(a[0]) < 50 and a[0] != c[0]
    return a[0]  # the schedule itself: the same in both packages


def chaos_bytes_and_latency(m):
    chaos = m["chaos"]
    data = bytes(range(256)) * 4
    with chaos.ChaosController(seed=3) as c:
        c.on("lat", chaos.AddLatency(0.02))
        t0 = time.monotonic()
        chaos.inject("lat")
        assert time.monotonic() - t0 >= 0.02
        c.on("bytes.flip", chaos.CorruptBytes(n_bytes=4, mode="flip"))
        c.on("bytes.cut", chaos.CorruptBytes(mode="truncate"))
        c.on("bytes.third", chaos.CorruptBytes(mode="flip", nth=3))
        flipped = chaos.transform_bytes("bytes.flip", data)
        assert flipped != data and len(flipped) == len(data)
        assert len(chaos.transform_bytes("bytes.cut", data)) < len(data)
        assert chaos.transform_bytes("bytes.third", data) is data
        assert chaos.transform_bytes("bytes.third", data) is data
        assert chaos.transform_bytes("bytes.third", data) != data
    with chaos.ChaosController(seed=3) as c:
        c.on("bytes.flip", chaos.CorruptBytes(n_bytes=4, mode="flip"))
        assert chaos.transform_bytes("bytes.flip", data) == flipped
    return flipped


def chaos_hang_released(m):
    chaos = m["chaos"]
    out = {}

    def victim():
        try:
            chaos.inject("hang")
        except chaos.ChaosCancelled:
            out["cancelled"] = True

    with chaos.ChaosController() as c:
        c.on("hang", chaos.HangUntilCancelled(timeout_s=10.0))
        t = threading.Thread(target=victim)
        t.start()
        time.sleep(0.05)
        assert t.is_alive()
    t.join(5.0)
    assert not t.is_alive() and out.get("cancelled")


def trace_span_tree(m):
    trace = m["trace"]
    trace.enable(rate=1.0, capacity=16)
    try:
        with trace.span("root") as r:
            r.set("model", "m")
            with trace.span("child-a") as a:
                a.event("mark", k=1)
            with trace.span("child-b"):
                pass
        recs = trace.collector().traces()
        assert len(recs) == 1
        roots = trace.span_tree(recs[0])
        assert len(roots) == 1 and roots[0]["name"] == "root"
        assert roots[0]["annotations"] == {"model": "m"}
        assert [c["name"] for c in roots[0]["children"]] == ["child-a", "child-b"]
        assert roots[0]["children"][0]["events"][0]["name"] == "mark"
    finally:
        trace.disable()
        trace.collector().clear()


def trace_tail_sampling(m):
    trace = m["trace"]
    trace.enable(rate=0.0, capacity=16)
    try:
        with trace.span("healthy"):
            pass
        with trace.span("bad") as s:
            s.flag("error")
        names = [r["spans"][0]["name"] for r in trace.collector().traces()]
        assert names == ["bad"]
    finally:
        trace.disable()
        trace.collector().clear()


def trace_disabled_fast_path(m):
    trace = m["trace"]
    trace.disable()
    with trace.span("a") as s1, trace.span("b") as s2:
        assert s1 is s2  # the shared no-op span
        trace.annotate_current("aot", "hit")
        trace.stage_event("step", 0.1)
    assert trace.current_trace_id() is None and trace.collector().traces() == []


def journal_ring(m):
    journal = m["journal"]
    j = journal.enable(capacity=8)
    try:
        for i in range(20):
            journal.emit("chaos.action", point="fixture", index=i, policy="FailNth",
                         action="raise")
        evs = j.events()
        assert [e["seq"] for e in evs] == list(range(12, 20))
        c = j.counters()
        assert (c["events_total"], c["overwritten_total"], c["live"]) == (20, 12, 8)
        assert all(e["type"] == "chaos.action" and e["attrs"]["policy"] == "FailNth"
                   for e in evs)
    finally:
        journal.enable(capacity=1024)


def journal_filters_and_merge(m):
    journal = m["journal"]
    evs = [{"seq": i, "ts": 1000.0 + i, "type": ("a" if i % 2 else "b"),
            "incarnation": "x", "attrs": {}} for i in range(10)]
    out, trunc = journal.bound_events(evs, types={"a"})
    assert [e["seq"] for e in out] == [1, 3, 5, 7, 9] and not trunc
    out, trunc = journal.bound_events(evs, limit=3)
    assert [e["seq"] for e in out] == [7, 8, 9] and trunc
    out, trunc = journal.bound_events(evs, max_bytes=1)
    assert [e["seq"] for e in out] == [9] and trunc
    old = [{"seq": i, "ts": 100.0 + i, "type": "fleet.worker_spawn", "incarnation": "old",
            "attrs": {}} for i in range(5)]
    new = [{"seq": i, "ts": 200.0 + i, "type": "fleet.worker_spawn", "incarnation": "new",
            "attrs": {}} for i in range(3)]
    merged = journal.merge_events([new, old, new])
    assert [e["incarnation"] for e in merged] == ["old"] * 5 + ["new"] * 3


def journal_trace_ids_and_training_events(m):
    journal, trace = m["journal"], m["trace"]
    journal.enable(capacity=64)
    trace.enable(rate=1.0, capacity=16)
    try:
        with trace.span("fixture.work") as sp:
            rec = journal.emit("chaos.action", point="p", index=1, policy="X", action="a")
            assert rec["trace_id"] == sp.trace_id
    finally:
        trace.disable()
        trace.collector().clear()
    for t, kw in (("train.checkpoint", dict(path="x.zip", size=3)),
                  ("train.resume", dict(checkpoint="x.zip")),
                  ("train.restart", dict(cause="RuntimeError", restarts=1)),
                  ("crash.report", dict(path=None, written=False, error=None))):
        assert journal.emit(t, **kw)["type"] == t
    journal.disable()
    try:
        assert journal.emit("chaos.action", point="p", index=0, policy="X", action="a") is None
    finally:
        journal.enable(capacity=1024)


def metrics_histogram(m):
    H = m["metrics"].LatencyHistogram
    h = H()
    for ms in range(1, 101):
        h.observe(ms / 1e3)
    p50, p99 = h.percentile(50), h.percentile(99)
    assert 0.04 < p50 < 0.06 and 0.09 < p99 < 0.12
    back = H.from_wire(h.to_wire())
    assert back.percentile(50) == p50
    other = H()
    other.observe(1.0)
    merged = H.from_wire(h.to_wire()).merge(other)
    assert merged.percentile(100) >= 1.0 > h.percentile(100)
    return p50, p99, round(h.mean, 9)


def metrics_serving(m):
    sm = m["metrics"].ServingMetrics()
    sm.record_admitted()
    sm.record_response(0.01)
    sm.record_rejection("queue_full")
    sm.record_batch(3, 4, 0.002)
    snap = sm.snapshot()
    assert snap["requests_total"] == 1
    text = sm.render_prometheus("m")
    return sorted(snap), sorted({line.split("{")[0].split(" ")[0] for line in text.splitlines()
                                 if line and not line.startswith("#")})


CASES = [chaos_scoping, chaos_nth, chaos_seeded_replay, chaos_bytes_and_latency,
         chaos_hang_released, trace_span_tree, trace_tail_sampling, trace_disabled_fast_path,
         journal_ring, journal_filters_and_merge, journal_trace_ids_and_training_events,
         metrics_histogram, metrics_serving]


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_host_module_case(case, package):
    got = case(PACKAGES[package])
    if package == "port":  # what a case returns is the same in both packages
        assert got == case(PACKAGES["jax"])
