"""Training listeners.

Counterpart of ``deeplearning4j_tpu/train/listeners.py`` (``:19-61``,
``:113-123``): the ``TrainingListener`` interface, ``ScoreIterationListener``
and ``CollectScoresListener``. ``fit`` calls ``iteration_done`` once per
iteration (once per truncated-BPTT chunk) with the iteration's loss as a
0-d tensor; a listener that reads it with ``float`` waits for the device.
"""

from __future__ import annotations

import logging

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


class CollectScoresListener(TrainingListener):
    """Collect (iteration, score) pairs in memory (reference
    ``CollectScoresIterationListener``)."""

    def __init__(self):
        self.scores: list[tuple[int, float]] = []

    def iteration_done(self, model, iteration, epoch, score):
        self.scores.append((iteration, float(score)))
