"""Named, versioned served models, core path.

Counterpart of ``deeplearning4j_tpu/serving/registry.py``: a thread-safe
map from a name to a :class:`ServedModel` (the model and its
:class:`~.batcher.ContinuousBatcher`). :meth:`ModelRegistry.load` restores a
``ModelSerializer`` archive on the card (or on the CPU when the caller asks
for it) and serves it; :meth:`ModelRegistry.predict` routes one request
through the model's batcher. Re-registering a name swaps in the new version
and drains the old one.

Deadlines, circuit breakers, retries, paging, warm-up manifests, quantized
deploys, undeploy/describe and the HTTP server are later slices.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher

logger = logging.getLogger(__name__)


class ServedModel:
    """One registered (name, version): the model and its batcher."""

    def __init__(self, name: str, version: int, model, batcher: ContinuousBatcher):
        self.name = name
        self.version = int(version)
        self.model = model
        self.batcher = batcher

    def predict(self, x):
        return self.batcher.submit(x)


class ModelRegistry:
    """Thread-safe registry of served models."""

    def __init__(self):
        self._lock = threading.Lock()  # guards: _models
        self._models: Dict[str, ServedModel] = {}

    def register(self, name: str, model, version: Optional[int] = None,
                 **batcher_kw) -> ServedModel:
        """Serve ``model`` under ``name``; ``batcher_kw`` goes to
        :class:`ContinuousBatcher` (``max_batch_size``, ``batch_timeout_ms``,
        ``buckets``). Re-registering a name swaps versions (auto-bumped
        unless given) and drains the replaced batcher."""
        model._ensure_init()
        batcher = ContinuousBatcher(model, **batcher_kw)
        with self._lock:
            prev = self._models.get(name)
            if version is None:
                version = prev.version + 1 if prev else 1
            served = ServedModel(name, version, model, batcher)
            self._models[name] = served
        if prev is not None:
            try:
                prev.batcher.shutdown(drain=True)
            except Exception:
                logger.exception("register(%r): drain of replaced v%d failed",
                                 name, prev.version)
        return served

    def load(self, name: str, path: str, device=None, **kw) -> ServedModel:
        """Restore the archive at ``path`` on ``device`` (``cuda`` unless
        the caller or the environment asks for the CPU) and serve it."""
        from deeplearning4j_tpu_torch.models.serializer import ModelSerializer
        return self.register(name, ModelSerializer.restore_model(path, device=device), **kw)

    def get(self, name: str) -> ServedModel:
        with self._lock:
            served = self._models.get(name)
            have = sorted(self._models)
        if served is None:
            raise KeyError(f"no model registered under {name!r}; have {have}")
        return served

    def predict(self, name: str, x):
        """Route one request through ``name``'s batcher."""
        return self.get(name).predict(x)

    def shutdown(self, drain: bool = True) -> None:
        """Stop every batcher and join its thread."""
        with self._lock:
            served = list(self._models.values())
            self._models.clear()
        for s in served:
            s.batcher.shutdown(drain=drain)
