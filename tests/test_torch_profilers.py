"""The port's two profilers on the CPU against the JAX package's: the same
report keys from ``TrainingProfiler`` after a profiled fit in each package,
from ``OpProfiler.timings`` and from ``ExchangeStats.report``; the
``trace(log_dir)`` context writing a Chrome trace through
``torch.profiler``; the provider registries; ``compile_cache_stats`` and
``device_memory_stats`` (empty without a GPU).
"""

import json
import os

import numpy as np
import pytest

import deeplearning4j_tpu.runtime.profiler as jprof
import deeplearning4j_tpu.train.profiler as jtprof
from deeplearning4j_tpu.data import NumpyDataSetIterator as JNumpyIt
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import DenseLayer as JDense
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import OutputLayer as JOutput
import deeplearning4j_tpu_torch.runtime.profiler as pprof
import deeplearning4j_tpu_torch.train.profiler as ptprof
from deeplearning4j_tpu_torch.data import NumpyDataSetIterator
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.train import CollectScoresListener


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = env.device
    env.set_device("cpu")
    yield
    env.device = saved


def _data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(64, 8)).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)])


@pytest.mark.parametrize("prefetch", [0, 2])
def test_training_profiler_report_keys_match_jax(prefetch):
    x, y = _data()
    net = MultiLayerNetwork(NeuralNetConfiguration.builder().seed(1).list()
                            .layer(DenseLayer(n_out=8, activation="tanh"))
                            .layer(OutputLayer(n_out=4, activation="softmax"))
                            .set_input_type(InputType.feed_forward(8)).build()).init()
    net.set_listeners(CollectScoresListener())
    prof = ptprof.TrainingProfiler()
    net.fit(NumpyDataSetIterator(x, y, batch_size=16), epochs=2, prefetch_buffer=prefetch,
            profiler=prof)
    jnet = JNet(JConf.builder().seed(1).list().layer(JDense(n_out=8, activation="tanh"))
                .layer(JOutput(n_out=4, activation="softmax"))
                .set_input_type(JInputType.feed_forward(8)).build()).init()
    jp = jtprof.TrainingProfiler()
    jnet.fit(JNumpyIt(x, y, batch_size=16), epochs=2, prefetch_buffer=prefetch, profiler=jp)
    r, jr = prof.report(), jp.report()
    assert sorted(r) == sorted(jr)
    assert r["iterations"] == jr["iterations"] == 8
    assert r["step_measured"] and 0.0 <= r["data_wait_fraction"] <= 1.0
    assert r["elapsed_s"] > 0 and r["dispatch_total_s"] > 0
    assert prof.summary().startswith("TrainingProfiler: 8 iterations")
    stats = pprof.ExchangeStats()
    stats.record("exchange", 0.001)
    stats.record_bytes(100, 10, 8)
    prof.attach_exchange(stats)
    assert "exchange" in prof.summary() and "exchange" in prof.report()


def test_op_profiler_and_exchange_stats_keys_match_jax():
    reports = []
    for mod in (pprof, jprof):
        p = mod.OpProfiler()
        for _ in range(3):
            with p.section("step"):
                pass
        with mod.OpProfiler(mod.ProfilerConfig(enabled=False)).section("off"):
            pass
        t = p.timings()
        assert t["step"]["count"] == 3 and "OpProfiler summary" in p.summary()
        e = mod.ExchangeStats()
        for s in e.STAGES:
            e.record(s, 0.002)
        e.record_bytes(4000, 400, 380)
        reports.append((sorted(t["step"]), sorted(e.report()), e.report()["compression_ratio"]))
        p.reset()
        assert p.timings() == {}
    assert reports[0] == reports[1]


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch
    with pprof.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    events = json.load(open(tmp_path / files[0]))["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_registries_and_stats():
    class _Metrics:
        def snapshot(self):
            return {"forwards": 3, "dtype_policy": "bf16", "requests_total": 5}

    pprof.attach_router(_Metrics())
    assert pprof.router_stats()["forwards"] == 3
    pprof.attach_quant_metrics("m", _Metrics())
    assert pprof.quant_split_stats()["m"]["dtype_policy"] == "bf16"
    pprof.detach_quant_metrics("m")
    assert pprof.quant_split_stats() == {}
    provider = lambda: {"models": 1}  # noqa: E731
    pprof.attach_capacity(provider)
    assert pprof.capacity_stats() == {"models": 1}
    pprof.detach_capacity(lambda: None)  # not the current one: stays
    assert pprof.capacity_stats() == {"models": 1}
    pprof.detach_capacity(provider)
    assert pprof.capacity_stats() == {}
    pprof.attach_router(None)
    s = pprof.compile_cache_stats()
    for k in ("hits", "misses", "corrupt_entries", "compiles", "aot_compiles", "aot_fallbacks",
              "aot_replays"):
        assert k in s
    assert pprof.device_memory_stats() == {}


def test_crash_report_and_resources(tmp_path, monkeypatch):
    import datetime
    import tarfile
    import zipfile

    import deeplearning4j_tpu.runtime.resources as jres
    from deeplearning4j_tpu_torch.runtime import journal
    from deeplearning4j_tpu_torch.runtime import resources as pres
    from deeplearning4j_tpu_torch.runtime.crash_reporting import CrashReportingUtil
    net = MultiLayerNetwork(NeuralNetConfiguration.builder().seed(1).list()
                            .layer(DenseLayer(n_out=8, activation="tanh"))
                            .layer(OutputLayer(n_out=4, activation="softmax"))
                            .set_input_type(InputType.feed_forward(8)).build()).init()
    monkeypatch.setattr(CrashReportingUtil, "crash_dump_dir", str(tmp_path))
    monkeypatch.setattr(CrashReportingUtil, "clock",
                        staticmethod(lambda: datetime.datetime(2026, 1, 2, 3, 4, 5)))
    journal.enable(capacity=64)
    with pytest.raises(RuntimeError, match="out of memory"):
        CrashReportingUtil.wrap(lambda: (_ for _ in ()).throw(RuntimeError("CUDA out of memory")),
                                net)
    path = tmp_path / "dl4j-tpu-memory-crash-dump-20260102-030405.txt"
    text = path.read_text()
    assert "layer_0" in text and "TOTAL" in text and "no CUDA device" in text
    assert journal.events()[-1]["type"] == "crash.report"
    assert CrashReportingUtil.wrap(lambda: 7) == 7
    # resources: the base directory knob and the path-traversal check, as in JAX
    for mod in (pres, jres):
        monkeypatch.setattr(mod.DL4JResources, "_base", str(tmp_path / mod.__name__))
        d = mod.DL4JResources.get_directory(mod.ResourceType.DATASET, "mnist")
        assert os.path.isdir(d) and d.endswith(os.path.join("datasets", "mnist"))
        bad = tmp_path / f"bad-{mod.__name__}.zip"
        with zipfile.ZipFile(bad, "w") as z:
            z.writestr("../escape.txt", "x")
        with pytest.raises(ValueError, match="escapes destination"):
            mod.ArchiveUtils.extract(str(bad), str(tmp_path / "out"))
        good = tmp_path / f"good-{mod.__name__}.tar.gz"
        src = tmp_path / "a.txt"
        src.write_text("hello")
        with tarfile.open(good, "w:gz") as t:
            t.add(src, arcname="dir/a.txt")
        got = mod.ArchiveUtils.extract(str(good), str(tmp_path / f"out-{mod.__name__}"))
        assert [os.path.basename(p) for p in got] == ["a.txt"]
        assert mod.ArchiveUtils.list_files(str(good)) == ["dir/a.txt"]
