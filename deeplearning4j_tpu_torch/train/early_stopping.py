"""Early stopping.

Counterpart of ``deeplearning4j_tpu/train/early_stopping.py``, for both
networks of the port. Rebuild of upstream ``org.deeplearning4j.earlystopping``: an
``EarlyStoppingConfiguration`` of termination conditions + score calculator,
driven by an ``EarlyStoppingTrainer`` that keeps the best model seen and
returns an ``EarlyStoppingResult``. Same decomposition as the reference:

- epoch termination: ``MaxEpochsTerminationCondition``,
  ``ScoreImprovementEpochTerminationCondition``,
  ``BestScoreEpochTerminationCondition``
- iteration termination: ``MaxTimeIterationTerminationCondition``,
  ``MaxScoreIterationTerminationCondition`` (NaN/explosion guard)
- score calculator: ``DataSetLossCalculator`` (validation loss) or any
  callable ``net -> float`` (lower is better, as in the reference)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional


class DataSetLossCalculator:
    """Validation loss over an iterator (reference ``DataSetLossCalculator``,
    average=true: example-weighted mean loss)."""

    def __init__(self, iterator):
        self.iterator = iterator

    def __call__(self, net) -> float:
        total, n = 0.0, 0
        self.iterator.reset()
        for batch in self.iterator:
            total += float(net.score(batch)) * len(batch)
            n += len(batch)
        return total / max(n, 1)


# ---- epoch termination conditions ----
class MaxEpochsTerminationCondition:
    requires_score = False  # checked every epoch, scored or not

    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch: int, score: float, best_score: float) -> bool:
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition:
    """Stop after ``max_epochs_without_improvement`` non-improving epochs
    (optionally requiring at least ``min_improvement``)."""

    requires_score = True

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self._best = float("inf")
        self._stale = 0

    def initialize(self) -> None:
        """Reset run-scoped state (called by the trainer at fit start so a
        condition instance can be reused across runs)."""
        self._best = float("inf")
        self._stale = 0

    def terminate(self, epoch: int, score: float, best_score: float) -> bool:
        if score < self._best - self.min_improvement:
            self._best = score
            self._stale = 0
        else:
            self._stale += 1
        return self._stale > self.patience


class BestScoreEpochTerminationCondition:
    """Stop once the score is at/below a target (reference semantics:
    'good enough')."""

    requires_score = True

    def __init__(self, target_score: float):
        self.target_score = target_score

    def terminate(self, epoch: int, score: float, best_score: float) -> bool:
        return score <= self.target_score


# ---- iteration termination conditions ----
class MaxTimeIterationTerminationCondition:
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start: Optional[float] = None

    def start(self) -> None:
        self._start = time.monotonic()

    def terminate(self, score: float) -> bool:
        return (time.monotonic() - (self._start or time.monotonic())) \
            >= self.max_seconds


class MaxScoreIterationTerminationCondition:
    """Abort if the minibatch score exceeds a bound or goes NaN (the
    reference's divergence guard)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def start(self) -> None:
        pass

    def terminate(self, score: float) -> bool:
        return not (score == score) or score > self.max_score


@dataclasses.dataclass
class EarlyStoppingConfiguration:
    score_calculator: Callable[[Any], float] = None
    epoch_termination_conditions: List[Any] = dataclasses.field(default_factory=list)
    iteration_termination_conditions: List[Any] = dataclasses.field(default_factory=list)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False

    class Builder:
        def __init__(self):
            self._kw = dict(epoch_termination_conditions=[],
                            iteration_termination_conditions=[])

        def score_calculator(self, calc):
            self._kw["score_calculator"] = calc
            return self

        def epoch_termination_conditions(self, *conds):
            self._kw["epoch_termination_conditions"] = list(conds)
            return self

        def iteration_termination_conditions(self, *conds):
            self._kw["iteration_termination_conditions"] = list(conds)
            return self

        def evaluate_every_n_epochs(self, n: int):
            self._kw["evaluate_every_n_epochs"] = int(n)
            return self

        def save_last_model(self, save: bool = True):
            self._kw["save_last_model"] = bool(save)
            return self

        def build(self) -> "EarlyStoppingConfiguration":
            return EarlyStoppingConfiguration(**self._kw)

    @staticmethod
    def builder() -> "EarlyStoppingConfiguration.Builder":
        return EarlyStoppingConfiguration.Builder()


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: str  # "EpochTerminationCondition" | "IterationTerminationCondition" | "Error"
    termination_details: str
    total_epochs: int
    best_model_epoch: int
    best_model_score: float
    score_vs_epoch: dict
    best_model: Any
    last_model: Any = None  # populated when config.save_last_model


class EarlyStoppingTrainer:
    """Reference ``EarlyStoppingTrainer``: epoch loop with score evaluation,
    best-model retention, and both condition families."""

    def __init__(self, config: EarlyStoppingConfiguration, net, train_iterator):
        self.config = config
        self.net = net
        self.iterator = train_iterator

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        needs_clone = cfg.save_last_model or cfg.score_calculator is not None
        if needs_clone and not hasattr(self.net, "clone"):
            raise ValueError(
                "best/last-model retention needs net.clone(); implement it, "
                "or drop the score calculator / save_last_model")
        if not hasattr(self.net, "set_listeners"):
            raise ValueError(
                "EarlyStoppingTrainer needs the TrainingListener API "
                "(set_listeners/get_listeners) on the network")
        if cfg.score_calculator is None:
            scored = [type(c).__name__ for c in cfg.epoch_termination_conditions
                      if getattr(c, "requires_score", True)]
            if scored:
                # score-gated conditions would be skipped every epoch -> the
                # loop could never terminate
                raise ValueError(
                    f"conditions {scored} need a score_calculator")
        best_score, best_epoch = float("inf"), -1
        best_params = None
        scores = {}
        for c in cfg.iteration_termination_conditions:
            c.start()

        class _IterGuard:
            """Listener checking iteration conditions on every minibatch."""

            details = ""

            def __init__(self, conds):
                self.conds = conds

            def on_epoch_start(self, net, epoch):
                pass

            def on_epoch_end(self, net, epoch):
                pass

            def iteration_done(self, net, iteration, epoch, score):
                for c in self.conds:
                    if c.terminate(float(score)):
                        self.details = type(c).__name__
                        raise StopIteration(self.details)

        for c in cfg.epoch_termination_conditions:
            if hasattr(c, "initialize"):
                c.initialize()

        guard = _IterGuard(cfg.iteration_termination_conditions)
        epoch = 0
        reason, details = "EpochTerminationCondition", ""
        old_listeners = list(self.net.get_listeners()) \
            if hasattr(self.net, "get_listeners") else []
        self.net.set_listeners(*(old_listeners + [guard]))  # checked above
        last_score = float("nan")
        try:
            while True:
                try:
                    self.net.fit(self.iterator, epochs=1)
                except StopIteration:
                    reason = "IterationTerminationCondition"
                    details = guard.details
                    break
                if cfg.score_calculator is not None and \
                        (epoch + 1) % cfg.evaluate_every_n_epochs == 0:
                    last_score = float(cfg.score_calculator(self.net))
                    scores[epoch] = last_score
                    if last_score < best_score:
                        best_score, best_epoch = last_score, epoch
                        # copy the tensors: the live state is updated in
                        # place by the next step
                        best_params = self._snapshot_state()
                # Score-free conditions (requires_score=False, e.g.
                # MaxEpochs) run EVERY epoch so they never overshoot; all
                # others — including user-defined ones — keep the original
                # contract of running only on fresh-score epochs (a stale/
                # NaN score would count as non-improvement).
                fresh = epoch in scores
                stop = False
                for c in cfg.epoch_termination_conditions:
                    if getattr(c, "requires_score", True) and not fresh:
                        continue
                    if c.terminate(epoch, last_score, best_score):
                        details = type(c).__name__
                        stop = True
                        break
                if stop:
                    break
                epoch += 1
        finally:
            self.net.set_listeners(*old_listeners)

        last_model = None
        if cfg.save_last_model:
            last_model = self._clone_with(self._snapshot_state())
        best_model = self.net
        if best_params is not None:
            best_model = self._clone_with(best_params)
        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            total_epochs=epoch + 1, best_model_epoch=best_epoch,
            best_model_score=best_score, score_vs_epoch=scores,
            best_model=best_model, last_model=last_model)

    def _snapshot_state(self):
        """Copies of the network's parameters, optimizer state and layer
        state: the fit goes on updating the live tensors in place."""
        import torch

        from deeplearning4j_tpu_torch.runtime.trees import tree_map
        return tree_map(lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t,
                        self.net._state_tree())

    def _clone_with(self, state):
        from deeplearning4j_tpu_torch.runtime.state_packing import assign_state
        model = self.net.clone()  # presence validated at fit() start
        model._ensure_init()
        model._set_state_tree(assign_state(model._state_tree(), state))
        return model
