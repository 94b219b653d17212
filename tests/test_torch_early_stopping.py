"""The port's early stopping on the CPU: the 7 cases of the JAX package's
``tests/test_early_stopping.py``, each run by both packages from one
archive. The termination reason and details, the epoch count, the best
epoch and the per-epoch validation scores agree with the live JAX run
(scores within ``_TOL``: float32, the two packages sum in other orders);
the best and last models are usable networks of the port.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import ListDataSetIterator as JList
from deeplearning4j_tpu.models import ComputationGraph as JGraph
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.nn import DenseLayer as JDense
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import OutputLayer as JOutput
from deeplearning4j_tpu.train import Adam as JAdam
import deeplearning4j_tpu.train as jtrain
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models import ModelSerializer
from deeplearning4j_tpu_torch.runtime.environment import get_environment
import deeplearning4j_tpu_torch.train as ptrain

_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _data(seed, n=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 6)).astype(np.float32)
    return x, np.eye(2, dtype=np.float32)[(x[:, 0] > 0).astype(int)]


def _archive(tmp_path, lr=5e-2, seed=0, graph=False):
    if graph:
        g = (JConf.builder().seed(seed).updater(JAdam(lr)).graph_builder().add_inputs("in")
             .add_layer("d", JDense(n_out=8, activation="tanh"), "in")
             .add_layer("out", JOutput(n_out=2, activation="softmax"), "d")
             .set_outputs("out"))
        g.set_input_types(JInputType.feed_forward(6))
        net = JGraph(g.build()).init()
    else:
        conf = (JConf.builder().seed(seed).updater(JAdam(lr)).list()
                .layer(JDense(n_out=12, activation="tanh"))
                .layer(JOutput(n_out=2, activation="softmax"))
                .set_input_type(JInputType.feed_forward(6)).build())
        net = JNet(conf).init()
    path = str(tmp_path / f"es-{seed}-{lr}-{graph}.zip")
    JSerializer.write_model(net, path)
    return path


def _run(pkg, path, build_cfg, seed=0, n=64, batch=32, val_batch=64):
    """The early-stopping run of package ``pkg`` (``ptrain`` or ``jtrain``)
    from the archive at ``path``: ``(result, net)``."""
    x, y = _data(seed, n)
    if pkg is ptrain:
        net = ModelSerializer.restore_model(path, device="cpu")
        mk = lambda b: ListDataSetIterator([DataSet(x, y)], batch_size=b)  # noqa: E731
    else:
        net = JSerializer.restore_model(path)
        mk = lambda b: JList([JDataSet(x, y)], batch_size=b)  # noqa: E731
    cfg = build_cfg(pkg, mk(val_batch))
    return pkg.EarlyStoppingTrainer(cfg, net, mk(batch)).fit(), net


def _agree(port, jax):
    assert port.termination_reason == jax.termination_reason
    assert port.termination_details == jax.termination_details
    assert port.total_epochs == jax.total_epochs
    assert port.best_model_epoch == jax.best_model_epoch
    assert sorted(port.score_vs_epoch) == sorted(jax.score_vs_epoch)
    np.testing.assert_allclose([port.score_vs_epoch[k] for k in sorted(port.score_vs_epoch)],
                               [jax.score_vs_epoch[k] for k in sorted(jax.score_vs_epoch)],
                               **_TOL)


def test_max_epochs_and_best_model(tmp_path):
    path = _archive(tmp_path)

    def cfg(pkg, val):
        return (pkg.EarlyStoppingConfiguration.builder()
                .score_calculator(pkg.DataSetLossCalculator(val))
                .epoch_termination_conditions(pkg.MaxEpochsTerminationCondition(8)).build())

    (result, net), (jres, _) = _run(ptrain, path, cfg), _run(jtrain, path, cfg)
    _agree(result, jres)
    assert result.termination_details == "MaxEpochsTerminationCondition"
    assert result.total_epochs == 8 and len(result.score_vs_epoch) == 8
    final = result.score_vs_epoch[max(result.score_vs_epoch)]
    assert result.best_model_score <= final + 1e-9
    # the best model is a copy: training went on after it, and it still works
    out = result.best_model.output(np.zeros((2, 6), np.float32))
    assert bool(torch.isfinite(out).all())
    if result.best_model_epoch < 7:
        assert not torch.equal(result.best_model.params()["layer_0"]["W"],
                               net.params()["layer_0"]["W"])
    x, y = _data(0)
    np.testing.assert_allclose(result.best_model.score(DataSet(x, y)), result.best_model_score,
                               rtol=1e-6)


def test_score_improvement_patience(tmp_path):
    path = _archive(tmp_path, lr=0.0)  # no learning -> no improvement

    def cfg(pkg, val):
        return (pkg.EarlyStoppingConfiguration.builder()
                .score_calculator(pkg.DataSetLossCalculator(val))
                .epoch_termination_conditions(pkg.ScoreImprovementEpochTerminationCondition(2),
                                              pkg.MaxEpochsTerminationCondition(50)).build())

    (result, _), (jres, _) = _run(ptrain, path, cfg), _run(jtrain, path, cfg)
    _agree(result, jres)
    assert result.termination_details == "ScoreImprovementEpochTerminationCondition"
    assert result.total_epochs <= 5


def test_best_score_target(tmp_path):
    path = _archive(tmp_path)

    def cfg(pkg, val):
        return (pkg.EarlyStoppingConfiguration.builder()
                .score_calculator(pkg.DataSetLossCalculator(val))
                .epoch_termination_conditions(pkg.BestScoreEpochTerminationCondition(10.0),
                                              pkg.MaxEpochsTerminationCondition(50)).build())

    (result, _), (jres, _) = _run(ptrain, path, cfg), _run(jtrain, path, cfg)
    _agree(result, jres)
    assert result.termination_details == "BestScoreEpochTerminationCondition"
    assert result.total_epochs == 1


def test_iteration_divergence_guard(tmp_path):
    path = _archive(tmp_path)

    def cfg(pkg, val):
        return (pkg.EarlyStoppingConfiguration.builder()
                .score_calculator(pkg.DataSetLossCalculator(val))
                .epoch_termination_conditions(pkg.MaxEpochsTerminationCondition(50))
                .iteration_termination_conditions(
                    pkg.MaxScoreIterationTerminationCondition(1e-9)).build())

    (result, net), (jres, _) = _run(ptrain, path, cfg), _run(jtrain, path, cfg)
    _agree(result, jres)
    assert result.termination_reason == "IterationTerminationCondition"
    assert result.termination_details == "MaxScoreIterationTerminationCondition"
    assert all(type(l).__name__ != "_IterGuard" for l in net.get_listeners())


def test_no_score_calculator_and_reuse(tmp_path):
    path = _archive(tmp_path)

    def cfg(pkg, val):
        return (pkg.EarlyStoppingConfiguration.builder()
                .epoch_termination_conditions(pkg.MaxEpochsTerminationCondition(3)).build())

    (result, _), (jres, _) = _run(ptrain, path, cfg), _run(jtrain, path, cfg)
    _agree(result, jres)
    assert result.total_epochs == 3
    # one condition instance across two runs: its state resets
    for pkg in (ptrain, jtrain):
        cond = pkg.ScoreImprovementEpochTerminationCondition(1)

        def cfg2(pkg_, val, cond=cond):
            return (pkg_.EarlyStoppingConfiguration.builder()
                    .score_calculator(pkg_.DataSetLossCalculator(val))
                    .epoch_termination_conditions(cond, pkg_.MaxEpochsTerminationCondition(10))
                    .build())

        _run(pkg, _archive(tmp_path, seed=1), cfg2, seed=1)
        r2, _ = _run(pkg, _archive(tmp_path, seed=2), cfg2, seed=2)
        assert r2.total_epochs >= 2
        if pkg is ptrain:
            port_r2 = r2
    _agree(port_r2, r2)


def test_evaluate_every_n_no_overshoot(tmp_path):
    path = _archive(tmp_path)

    def cfg(pkg, val):
        return (pkg.EarlyStoppingConfiguration.builder()
                .score_calculator(pkg.DataSetLossCalculator(val))
                .evaluate_every_n_epochs(3)
                .epoch_termination_conditions(pkg.MaxEpochsTerminationCondition(5)).build())

    (result, _), (jres, _) = _run(ptrain, path, cfg), _run(jtrain, path, cfg)
    _agree(result, jres)
    assert result.total_epochs == 5 and sorted(result.score_vs_epoch) == [2]


def test_save_last_model_and_computation_graph(tmp_path):
    path = _archive(tmp_path, graph=True)

    def cfg(pkg, val):
        return (pkg.EarlyStoppingConfiguration.builder()
                .score_calculator(pkg.DataSetLossCalculator(val))
                .epoch_termination_conditions(pkg.MaxEpochsTerminationCondition(4))
                .save_last_model().build())

    (result, net), (jres, _) = (_run(ptrain, path, cfg, n=32, val_batch=32),
                                _run(jtrain, path, cfg, n=32, val_batch=32))
    _agree(result, jres)
    assert result.total_epochs == 4 and result.last_model is not None
    x, _ = _data(0, 32)
    assert tuple(result.best_model.output(x).shape) == (32, 2)
    assert torch.equal(result.last_model.params()["d"]["W"], net.params()["d"]["W"])
    assert torch.equal(result.last_model.updater_state()["d"]["mu"]["W"],
                       net.updater_state()["d"]["mu"]["W"])
