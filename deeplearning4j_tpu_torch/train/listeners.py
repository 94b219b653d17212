"""Training listeners.

Counterpart of ``deeplearning4j_tpu/train/listeners.py`` (``:19-123``): the
``TrainingListener`` interface, ``ScoreIterationListener``,
``PerformanceListener``, ``EvaluativeListener`` and
``CollectScoresListener``. ``fit`` calls ``iteration_done`` once per
iteration (once per truncated-BPTT chunk) with the iteration's loss as a
0-d tensor; a listener that reads it with ``float`` waits for the device.
Before that it hands a ``PerformanceListener`` the batch's example count.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    """Subclass and override what you need (reference interface)."""

    def iteration_done(self, model, iteration: int, epoch: int, score) -> None:
        pass

    def on_epoch_start(self, model, epoch: int) -> None:
        pass

    def on_epoch_end(self, model, epoch: int) -> None:
        pass


class ScoreIterationListener(TrainingListener):
    """Log the score every N iterations (reference ``ScoreIterationListener``)."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, int(print_iterations))

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.print_iterations == 0:
            logger.info("Score at iteration %d (epoch %d) is %s", iteration, epoch,
                        float(score))


class PerformanceListener(TrainingListener):
    """Throughput on the host clock (reference ``PerformanceListener``):
    every ``frequency`` iterations, iterations/s and examples/s since the
    last report, logged and kept in ``reports`` as ``(iteration, it/s,
    samples/s, score)``. The first iteration starts the clock. Reading the
    score waits for the device, so a report's window ends when that
    iteration's step has finished."""

    def __init__(self, frequency: int = 10, report_samples: bool = True):
        self.frequency = max(1, int(frequency))
        self.report_samples = report_samples
        self.reports: list[tuple[int, float, float, float]] = []
        self._last_time: Optional[float] = None
        self._last_iter = 0
        self._samples = 0

    def record_batch(self, n_examples: int) -> None:
        self._samples += int(n_examples)

    def iteration_done(self, model, iteration, epoch, score):
        if self._last_time is None:
            float(score)
            self._last_time, self._last_iter, self._samples = (time.perf_counter(),
                                                               iteration, 0)
            return
        if iteration - self._last_iter >= self.frequency:
            value = float(score)
            now = time.perf_counter()
            dt = now - self._last_time
            it_s = (iteration - self._last_iter) / dt
            samples_s = self._samples / dt
            msg = f"iteration {iteration} (epoch {epoch}): {it_s:.1f} it/s"
            if self.report_samples and self._samples:
                msg += f", {samples_s:.1f} samples/s"
            msg += f", score={value:.5f}"
            logger.info(msg)
            self.reports.append((iteration, it_s, samples_s, value))
            self._last_time, self._last_iter, self._samples = now, iteration, 0


class EvaluativeListener(TrainingListener):
    """Every ``frequency`` iterations, ``model.evaluate`` on a held-out
    iterator (reference ``EvaluativeListener``); the result is kept in
    ``last_evaluation``. ``evaluation_factory`` is kept for the reference's
    signature and not used, as in the JAX package."""

    def __init__(self, iterator, frequency: int = 100, evaluation_factory=None):
        self.iterator = iterator
        self.frequency = max(1, int(frequency))
        self.evaluation_factory = evaluation_factory
        self.last_evaluation = None

    def iteration_done(self, model, iteration, epoch, score):
        if iteration > 0 and iteration % self.frequency == 0:
            self.iterator.reset()
            self.last_evaluation = model.evaluate(self.iterator)
            logger.info("Evaluation at iteration %d:\n%s", iteration,
                        self.last_evaluation.stats())


class CollectScoresListener(TrainingListener):
    """Collect (iteration, score) pairs in memory (reference
    ``CollectScoresIterationListener``)."""

    def __init__(self):
        self.scores: list[tuple[int, float]] = []

    def iteration_done(self, model, iteration, epoch, score):
        self.scores.append((iteration, float(score)))
