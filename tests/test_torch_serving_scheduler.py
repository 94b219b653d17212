"""The port's background scheduler against the JAX package's.

- **Fine-tune**: a ``finetune`` job preempted by traffic and resumed lands on
  the uninterrupted run's losses and weights bit for bit (the JAX
  package's contract, ``tests/test_scheduler.py:119``), and its losses are
  within 1e-5 of the JAX run from the same JAX-written archive.
- **Runners**: ``eval`` through the registry's batcher gives the direct
  ``predict``'s accuracy and the JAX eval's; ``score`` writes the JAX
  outputs (1e-6); ``sweep``'s trial sequences and ``build_net_from_spec``'s
  configurations equal the JAX package's; ``flywheel`` trains from a
  ``FeedbackLog`` and hands its candidate to ``deploy_fn`` as the JAX run.
- **Store and journal**: one ``FleetConfig`` file shared by a JAX and a port
  scheduler: exactly one wins the claim and each unit runs once; a
  preempted-then-resumed job journals the JAX package's event sequence;
  ``render_prometheus`` prints the JAX text.
- **Worker**: ``GET /v1/scheduler``, the ``scheduler_*`` ``/metrics``
  families and the harvest in ``/v1/capacity`` answered as a JAX worker's.
- **The card's discipline** (port only): a job's device step holds
  ``CAPTURE_LOCK``; an eval, which goes through the batcher, does not.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from _torch_serving_host import (BATCHER_KW, _families, _keys, jax_archive,  # noqa: F401
                                 port_on_cpu, request)
from _torch_serving_procs import port_process_guard  # noqa: F401
from deeplearning4j_tpu.runtime import journal as jjournal
from deeplearning4j_tpu.serving import scheduler as jsched
from deeplearning4j_tpu.serving.control_plane import FleetConfig as JFleetConfig
from deeplearning4j_tpu_torch.runtime import journal
from deeplearning4j_tpu_torch.serving import scheduler as sched
from deeplearning4j_tpu_torch.serving.control_plane import FleetConfig

SLACK = {"busy_fraction": 0.0, "queue_depth": 0, "queue_headroom": 8, "fast_burn": 0.0}
BUSY = {"busy_fraction": 1.0, "queue_depth": 4, "queue_headroom": 0, "fast_burn": 9.0}
TERMINAL = ("completed", "failed", "cancelled")
#: fine-tune losses of the two packages from one archive (float32 on the CPU)
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """The JAX serving tests' MLP written by the JAX serializer, and a
    32-row dataset of its shape."""
    d = tmp_path_factory.mktemp("sched")
    archive = jax_archive(d / "base.zip")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    labels = rng.integers(0, 4, 32)
    data = str(d / "data.npz")
    np.savez(data, x=x, y=np.eye(4, dtype=np.float32)[labels], labels=labels)
    return {"dir": d, "archive": archive, "data": data, "x": x, "labels": labels}


def _mod(jax_side):
    return jsched if jax_side else sched


def _store(path, jax_side=False):
    mod = _mod(jax_side)
    return mod.JobStore((JFleetConfig if jax_side else FleetConfig)(str(path)))


def _scheduler(store, box, jax_side=False, worker_id="w0", **kw):
    mod = _mod(jax_side)
    return mod.Scheduler(store, signals=lambda: box["v"], worker_id=worker_id,
                         config=mod.SchedulerConfig(tick_s=0.01), **kw)


def _drain(s, store, job_ids, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        s.tick()
        if all(store.get(j)["state"] in TERMINAL for j in job_ids):
            with s._lock:
                t = s._job_thread
            if t is not None:
                t.join(10)
            return
        time.sleep(0.02)
    raise AssertionError({j: store.get(j)["state"] for j in job_ids})


def _count_run(jax_side):
    """A runner of N bounded units (no device), gated by a test event."""
    mod = _mod(jax_side)

    class CountRun(mod.JobRun):
        RUNS = []
        GATE = None

        def __init__(self, job, ctx):
            super().__init__(job, ctx)
            self.i = int(self.progress.get("i", 0))

        def step(self):
            if type(self).GATE is not None:
                type(self).GATE.wait(30)
            type(self).RUNS.append((self.job["id"], self.i))
            self.i += 1
            return self.i >= int(self.payload.get("units", 3))

        def checkpoint(self):
            self.progress = {"i": self.i}
            return dict(self.progress)

        def result(self):
            return {"units": self.i}

    return CountRun


# ============================================================ fine-tune
def _finetune(workload, tmp_path, tag, jax_side, preempt):
    """One ``finetune`` job of 6 steps; with ``preempt`` the traffic signal
    turns busy after the first step and slack again. Returns the losses and
    the output archive."""
    mod = _mod(jax_side)
    stepped = threading.Event()

    class SlowRun(mod.FineTuneRun):
        def step(self):
            done = super().step()
            stepped.set()
            time.sleep(0.05)  # hold the thread so the tick lands mid-run
            return done

    store = _store(tmp_path / f"fleet-{tag}.json", jax_side)
    out = str(tmp_path / f"out-{tag}.zip")
    jid = store.submit("finetune", {
        "archive": workload["archive"], "data": workload["data"], "steps": 6,
        "batch_size": 8, "seed": 3, "out": out, "checkpoint_dir": str(tmp_path / f"ck-{tag}")})
    box = {"v": SLACK}
    s = _scheduler(store, box, jax_side, runners={"finetune": SlowRun})
    assert s.tick() == "started"
    if preempt:
        assert stepped.wait(60)
        box["v"] = BUSY
        assert s.tick() == "preempted"
        rec = store.get(jid)
        assert rec["state"] == "preempted" and 0 < rec["progress"]["steps_done"] < 6
        assert s.tick() == "blocked"
        box["v"] = SLACK
        assert s.tick() == "resumed"
    _drain(s, store, [jid])
    rec = store.get(jid)
    assert rec["state"] == "completed", rec["error"]
    assert s.harvest_snapshot()["harvested_busy_s"] > 0
    return rec["result"]["losses"], out


def test_finetune_preempt_resume_bit_for_bit_and_matches_jax(workload, tmp_path):
    from deeplearning4j_tpu_torch.models import ModelSerializer
    losses_a, out_a = _finetune(workload, tmp_path, "a", False, preempt=False)
    losses_b, out_b = _finetune(workload, tmp_path, "b", False, preempt=True)
    assert losses_a == losses_b
    net_a = ModelSerializer.restore_model(out_a, device="cpu")
    net_b = ModelSerializer.restore_model(out_b, device="cpu")
    from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
    for la, lb in zip(tree_leaves(net_a._params), tree_leaves(net_b._params)):
        assert np.array_equal(la.numpy().view(np.uint8), lb.numpy().view(np.uint8))
    assert net_a._iteration == net_b._iteration == 6
    losses_j, _ = _finetune(workload, tmp_path, "j", True, preempt=False)
    np.testing.assert_allclose(losses_a, losses_j, rtol=0, atol=LOSS_TOL)


# ============================================================== runners
def _registries(workload):
    """The MLP served by each package's registry from the one archive."""
    from deeplearning4j_tpu.serving import ModelRegistry as JRegistry
    from deeplearning4j_tpu_torch.serving import ModelRegistry
    jreg, preg = JRegistry(), ModelRegistry()
    jreg.load("m", workload["archive"], save_manifest=False, **BATCHER_KW)
    preg.load("m", workload["archive"], save_manifest=False, device="cpu", **BATCHER_KW)
    return jreg, preg


def _one_job(jax_side, jtype, payload, tmp_path, **kw):
    store = _store(tmp_path / f"fleet-{jtype}-{int(jax_side)}.json", jax_side)
    jid = store.submit(jtype, payload)
    s = _scheduler(store, {"v": SLACK}, jax_side, **kw)
    _drain(s, store, [jid])
    rec = store.get(jid)
    assert rec["state"] == "completed", rec["error"]
    return rec["result"]


def test_eval_and_score_runs_match_jax(workload, tmp_path):
    jreg, preg = _registries(workload)
    try:
        payload = {"model": "m", "data": workload["data"], "batch_size": 4}
        rj = _one_job(True, "eval", payload, tmp_path, registry=jreg)
        rp = _one_job(False, "eval", payload, tmp_path, registry=preg)
        direct = np.asarray(preg.predict("m", workload["x"]))
        acc = round(float((direct.argmax(-1) == workload["labels"]).mean()), 6)
        assert rp == rj and rp["accuracy"] == acc and rp["examples"] == 32
    finally:
        jreg.shutdown()
        preg.shutdown()
    outs = {}
    for jax_side in (True, False):
        out = str(tmp_path / f"scores-{int(jax_side)}.npz")
        res = _one_job(jax_side, "score", {"archive": workload["archive"],
                                           "data": workload["data"], "batch_size": 5,
                                           "out": out}, tmp_path)
        assert res == {"examples": 32, "out": out}
        outs[jax_side] = np.load(out)["outputs"]
    assert outs[False].shape == (32, 4)
    np.testing.assert_allclose(outs[False], outs[True], rtol=1e-6, atol=1e-7)


SPECS = [{"nin": 8, "nout": 4},
         {"nin": 8, "nout": 4, "hidden": [12, 6], "activation": "relu", "seed": 3,
          "updater": "adam", "lr": 0.01},
         {"nin": 5, "nout": 3, "hidden": [7], "updater": "sgd", "lr": 0.5}]


@pytest.mark.parametrize("spec", SPECS, ids=["defaults", "adam", "sgd"])
def test_build_net_from_spec_conf_equals_jax(spec):
    jnet = jsched.build_net_from_spec(spec)
    pnet = sched.build_net_from_spec(spec)
    assert json.loads(pnet.conf.to_json()) == json.loads(jnet.conf.to_json())
    assert str(pnet.device) == "cpu"


@pytest.mark.parametrize("mode", ["grid", "random"])
def test_sweep_trial_sequence_equals_jax(mode):
    space = {"lr": [0.01, 0.1, 0.5], "hidden": [[4], [8, 4]], "activation": ["tanh", "relu"]}
    for seed in (0, 7):
        assert sched.SweepRun._trial_sequence(space, mode, 5, seed) == \
            jsched.SweepRun._trial_sequence(space, mode, 5, seed)


def test_sweep_and_flywheel_jobs_match_jax(workload, tmp_path):
    payload = {"data": workload["data"], "space": {"lr": [0.05, 0.2], "hidden": [[6]]},
               "mode": "grid", "steps": 3, "batch_size": 8, "base": {"updater": "sgd"}}
    rj = _one_job(True, "sweep", payload, tmp_path)
    rp = _one_job(False, "sweep", payload, tmp_path)
    # the trials are the JAX package's; each trial's net is initialised by
    # its own package's generator, so its score is held against the port's
    # own replay of that trial (the same batches, fit, score)
    assert [r["params"] for r in rp["results"]] == [r["params"] for r in rj["results"]]
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    x, y = np.load(workload["data"])["x"], np.load(workload["data"])["y"]
    for r in rp["results"]:
        net = sched.build_net_from_spec(r["params"])
        for i in range(3):
            idx = [(i * 8 + j) % 32 for j in range(8)]
            net.fit(x[idx], y[idx])
        assert r["score"] == round(float(net.score(DataSet(x, y))), 9)
    assert rp["best"] == min(rp["results"], key=lambda r: r["score"])

    from deeplearning4j_tpu_torch.serving.delivery import FeedbackLog
    access, labeled = tmp_path / "access.jsonl", tmp_path / "labeled.jsonl"
    with open(access, "w") as f:
        for i in range(12):
            f.write(json.dumps({"log": "dl4j_tpu_access", "trace_id": f"t{i}", "model": "m",
                                "outcome": 200}) + "\n")
    log = FeedbackLog(access_log_path=str(access), out_path=str(labeled))
    for i in range(12):
        assert log.record(f"t{i}", label=int(workload["labels"][i]),
                          inputs=workload["x"][i].tolist()) is not None
    results, deployed = {}, {}
    for jax_side in (True, False):
        def deploy(archive, p, jax_side=jax_side):
            deployed[jax_side] = archive
            return {"verdict": "promoted"}
        results[jax_side] = _one_job(jax_side, "flywheel", {
            "feedback_file": str(labeled), "model": "m", "base_archive": workload["archive"],
            "out_archive": str(tmp_path / f"fly-{int(jax_side)}.zip"), "max_epochs": 4,
            "patience": 2, "batch_size": 4, "lr": 0.1, "prefetch_buffer": 2},
            tmp_path, deploy_fn=deploy)
    rj, rp = results[True], results[False]
    assert rp["status"] == rj["status"] == "trained" and rp["deployed"] and rj["deployed"]
    assert (rp["examples"], rp["epochs"]) == (rj["examples"], rj["epochs"]) == (12, 4)
    assert abs(rp["best_score"] - rj["best_score"]) <= LOSS_TOL
    assert deployed[False] == rp["archive"] and os.path.exists(rp["archive"])


def test_flywheel_trains_on_token_ids_under_bf16(tmp_path):
    """Feedback rows of token ids fine-tune a BERT under a bf16 compute
    dtype on those ids: as float32 features they would be cast with the
    activations and name other tokens (bf16 spacing is 4 above 512). The
    job's best score is a replay's on the integer ids, not on float ids."""
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.models import (FineTuneConfiguration, MultiLayerNetwork,
                                                 TransferLearning)
    from deeplearning4j_tpu_torch.runtime.environment import get_environment
    from deeplearning4j_tpu_torch.serving.delivery import FeedbackLog
    from deeplearning4j_tpu_torch.train import Sgd
    from deeplearning4j_tpu_torch.zoo import Bert

    get_environment().set_compute_dtype("bfloat16")  # port_on_cpu restores it
    rng = np.random.default_rng(5)
    n, t, batch, epochs = 8, 8, 4, 2
    ids = rng.integers(513, 1000, (n, t))  # rounded, still under the vocabulary
    assert (torch.from_numpy(ids).float().bfloat16().long().numpy() != ids).mean() > 0.5
    labels = rng.integers(0, 2, n)
    y = np.eye(2, dtype=np.float32)[labels]
    base = str(tmp_path / "bert.zip")
    Bert(vocab_size=1024, d_model=16, n_layers=1, n_heads=2, ffn_size=32, max_len=t,
         dropout_rate=0.0).init(device="cpu").save(base)
    access, labeled = tmp_path / "access.jsonl", tmp_path / "labeled.jsonl"
    with open(access, "w") as f:
        for i in range(n):
            f.write(json.dumps({"log": "dl4j_tpu_access", "trace_id": f"t{i}", "model": "b",
                                "outcome": 200}) + "\n")
    log = FeedbackLog(access_log_path=str(access), out_path=str(labeled))
    for i in range(n):
        assert log.record(f"t{i}", label=int(labels[i]), inputs=ids[i].tolist()) is not None
    res = _one_job(False, "flywheel", {
        "feedback_file": str(labeled), "model": "b", "base_archive": base,
        "out_archive": str(tmp_path / "fly.zip"), "max_epochs": epochs, "patience": epochs,
        "batch_size": batch, "lr": 0.1, "prefetch_buffer": 2}, tmp_path)
    assert res["status"] == "trained" and (res["examples"], res["epochs"]) == (n, epochs)

    def replay(x):
        net = TransferLearning.builder(MultiLayerNetwork.load(base)).fine_tune_configuration(
            FineTuneConfiguration(updater=Sgd(0.1))).build()
        scores = []
        for _ in range(epochs):
            net.fit(ListDataSetIterator([DataSet(x[lo:lo + batch], y[lo:lo + batch])
                                         for lo in range(0, n, batch)], batch_size=batch),
                    epochs=1, prefetch_buffer=2)
            scores.append(float(net.score(DataSet(x, y))))
        return min(scores)

    assert res["best_score"] == replay(ids)
    assert res["best_score"] != replay(ids.astype(np.float32))


# ================================================ store, claims, journal
def test_one_config_file_one_claim_across_packages(tmp_path):
    """A JAX and a port scheduler race one job in one ``FleetConfig`` file:
    exactly one wins the claim and each unit runs exactly once."""
    path = tmp_path / "fleet.json"
    jrun, prun = _count_run(True), _count_run(False)
    jstore, pstore = _store(path, True), _store(path, False)
    jid = pstore.submit("count", {"units": 2})
    assert jstore.get(jid)["state"] == "submitted"
    js = _scheduler(jstore, {"v": SLACK}, True, worker_id="jw", runners={"count": jrun})
    ps = _scheduler(pstore, {"v": SLACK}, False, worker_id="pw", runners={"count": prun})
    results = {}
    threads = [threading.Thread(target=lambda k=k, s=s: results.update({k: s.tick()}))
               for k, s in (("jax", js), ("port", ps))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert sorted(results.values(), key=str) == sorted(["started", None], key=str)
    winner = js if results["jax"] == "started" else ps
    _drain(winner, pstore, [jid])
    assert sorted(jrun.RUNS + prun.RUNS) == [(jid, 0), (jid, 1)]
    assert jstore.get(jid)["owner"] == ("jw" if winner is js else "pw")
    won = js.harvest_snapshot()["claims_won_total"] + ps.harvest_snapshot()["claims_won_total"]
    assert won == 1


def _lifecycle(jax_side, tmp_path):
    """submit, start, preempt inside a gated step, block, resume, complete,
    a late lost claim and a cancel; returns the journal's scheduler events
    of the two jobs and the scheduler's snapshot."""
    j = (jjournal if jax_side else journal).enable(capacity=2048)
    store = _store(tmp_path / f"life-{int(jax_side)}.json", jax_side)
    run = _count_run(jax_side)
    run.GATE = threading.Event()
    jid = store.submit("count", {"units": 2}, job_id="job-a")
    box = {"v": SLACK}
    s = _scheduler(store, box, jax_side, runners={"count": run})
    assert s.tick() == "started"
    box["v"] = BUSY
    res = {}
    ticker = threading.Thread(target=lambda: res.update(r=s.tick()))
    ticker.start()
    time.sleep(0.1)
    run.GATE.set()
    ticker.join(30)
    assert res["r"] == "preempted"
    assert s.tick() == "blocked"
    box["v"] = SLACK
    assert s.tick() == "resumed"
    _drain(s, store, [jid])
    assert store.claim(jid, "late-worker") is False
    jid2 = store.submit("count", {"units": 1}, job_id="job-b")
    assert store.cancel(jid2)
    events = [(e["type"], {k: v for k, v in e["attrs"].items()})
              for e in j.events() if e["type"].startswith("scheduler.")
              and e["attrs"].get("job") in (jid, jid2)]
    return events, s.harvest_snapshot()


def test_job_lifecycle_journal_and_prometheus_equal_jax(tmp_path):
    ej, snap_j = _lifecycle(True, tmp_path)
    ep, snap_p = _lifecycle(False, tmp_path)
    assert ep == ej
    assert [t for t, _ in ep][:6] == ["scheduler.submit", "scheduler.claim", "scheduler.start",
                                      "scheduler.preempt", "scheduler.resume",
                                      "scheduler.complete"]
    for snap in (snap_j, snap_p):
        snap["harvested_busy_s"] = 0.0
        snap.pop("last_preempt_join_s", None)
    assert snap_p == snap_j
    assert sched.render_prometheus(snap_p) == jsched.render_prometheus(snap_j)
    blocked = dict(snap_p, harvested_busy_s=1.25, active_job="job-a")
    assert sched.render_prometheus(blocked) == jsched.render_prometheus(blocked)


# ================================================================ worker
def test_scheduler_endpoint_answers_as_a_jax_worker(workload, tmp_path):
    from deeplearning4j_tpu.serving import ModelServer as JServer
    from deeplearning4j_tpu_torch.serving import ModelServer
    jreg, preg = _registries(workload)
    servers = [JServer(jreg, worker_id="wj"), ModelServer(preg, worker_id="wp")]
    scheds = []
    try:
        ports = [srv.start(0) for srv in servers]
        for port in ports:
            status, _, body = request(port, "GET", "/v1/scheduler")
            assert status == 404 and json.loads(body) == {"error": "no scheduler attached"}
        for k, (srv, jax_side) in enumerate(zip(servers, (True, False))):
            store = _store(tmp_path / f"w{k}.json", jax_side)
            store.submit("count", {"units": 1}, job_id="job-w")
            s = _scheduler(store, {"v": SLACK}, jax_side, worker_id=srv.worker_id,
                           runners={"count": _count_run(jax_side)})
            s.start()
            scheds.append(s)
            srv.scheduler = s
            _drain(s, store, ["job-w"])
        answers = []
        for port in ports:
            status, _, body = request(port, "GET", "/v1/scheduler")
            assert status == 200
            answers.append(json.loads(body))
        (aj, ap) = answers
        assert _keys(ap) == _keys(aj)
        assert ap["jobs"]["job-w"]["state"] == aj["jobs"]["job-w"]["state"] == "completed"
        assert ap["scheduler"]["completed_total"] == aj["scheduler"]["completed_total"] == 1
        texts = [request(port, "GET", "/metrics")[2].decode() for port in ports]
        fam = [{f for f in _families(t) if f.startswith("scheduler_")} for t in texts]
        assert fam[1] == fam[0] and "scheduler_harvested_busy_s" in fam[1]
        caps = [json.loads(request(port, "GET", "/v1/capacity")[2]) for port in ports]
        for c in caps:
            assert c["scheduler"]["completed_total"] == 1
            assert c["utilization"]["harvested_busy_s"] == \
                round(c["scheduler"]["harvested_busy_s"], 6)
        assert sorted(caps[1]["scheduler"]) == sorted(caps[0]["scheduler"])
    finally:
        for s in scheds:
            s.stop()
        for srv in servers:
            srv.stop()
        jreg.shutdown()
        preg.shutdown()


# ===================================================== the card's discipline
def test_device_steps_hold_the_capture_lock(workload, tmp_path):
    """A job step that runs on the device itself holds ``CAPTURE_LOCK`` for
    its duration, so a serving capture waits for it; an eval goes through
    the batcher (whose captures take the lock) and holds nothing."""
    from deeplearning4j_tpu_torch.runtime.compile_cache import CAPTURE_LOCK

    seen = {}

    def probe(tag):
        got = {}

        def try_lock():
            got["free"] = CAPTURE_LOCK.acquire(blocking=False)
            if got["free"]:
                CAPTURE_LOCK.release()

        t = threading.Thread(target=try_lock)
        t.start()
        t.join(10)
        seen[tag] = not got["free"]

    class Probed(sched.ScoreRun):
        def step(self):
            probe("score")
            return super().step()

    class ProbedEval(sched.EvalRun):
        def step(self):
            probe("eval")
            return super().step()

    assert sched.ScoreRun.exclusive_device and not sched.EvalRun.exclusive_device
    _one_job(False, "score", {"archive": workload["archive"], "data": workload["data"],
                              "batch_size": 16}, tmp_path, runners={"score": Probed})
    jreg, preg = _registries(workload)
    try:
        _one_job(False, "eval", {"model": "m", "data": workload["data"], "batch_size": 16},
                 tmp_path, registry=preg, runners={"eval": ProbedEval})
    finally:
        jreg.shutdown()
        preg.shutdown()
    assert seen == {"score": True, "eval": False}
