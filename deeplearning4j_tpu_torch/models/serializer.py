"""Single-file model archives, shared with the JAX package.

Counterpart of ``deeplearning4j_tpu/models/serializer.py`` and the function
that carries weights between the two packages. The zip is the same:
``configuration.json`` (the config tree), ``coefficients.npz`` (the
parameters), ``metadata.json`` and, optionally, ``updaterState.npz`` and
``normalizer.npz`` (a data normalizer's ``kind`` and arrays under the JAX
package's keys, :mod:`~..data.normalizers`).

A ``ComputationGraph`` archive is keyed by node name where a network's is
keyed by ``layer_<i>``; everything else is the same.

``coefficients.npz`` holds ``leaf_0 .. leaf_N`` in the JAX package's
``jax.tree.leaves`` order of ``{"params": ..., "model_state": ...}``: dict
keys sorted as strings, recursively. So ``"model_state"`` < ``"params"``,
``"layer_10"`` < ``"layer_2"``, ``"W"`` < ``"W_rec"`` < ``"b"`` <
``"b_rec"`` < ``"peephole"``, and a ``Bidirectional`` layer's ``"bwd"``
tree before its ``"fwd"`` tree. :func:`tree_leaves` reproduces that order
without JAX.

``updaterState.npz`` holds the optimizer's state in the leaf order of the
JAX package's ``jax.tree.leaves(opt_state)`` (JAX ``serializer.py:33-48``,
``:75``, ``:132``): per layer label in sorted order, that layer's leaves in
sorted, nested parameter order (``"attn"/...``, ``"stack"/...``). For
``RmsProp`` each layer's ``nu``; for ``Nesterovs`` each layer's ``trace``;
for ``Adam`` each layer's 0-d int32
``count``, then its ``mu`` leaves, then its ``nu`` leaves; nothing for
``Sgd``; a schedule's and a weight decay's int32 ``count`` after the
updater's leaves (:mod:`~..train.updaters`). So an archive written by
either package resumes training in the other with its optimizer state.
The port writes the file once its network has an optimizer (after ``fit``,
or after restoring one) unless ``save_updater=False``, and reads it into
the optimizer when that is built unless ``load_updater=False``.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import List

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_unflatten_like

_CONF = "configuration.json"
_COEFF = "coefficients.npz"
_UPDATER = "updaterState.npz"
_META = "metadata.json"
_NORM = "normalizer.npz"


def params_from_numpy(tree, device=None, dtype=None):
    """The JAX package's parameters, as nested dicts of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, net.train_state.params)``), as the port's
    nested dicts of tensors on ``device``; floating leaves cast to ``dtype``
    when given."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)  # numpy's bfloat16 extension has no torch view
        t = torch.from_numpy(np.array(a))  # a writable copy the tensor owns
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device) if device is not None else t

    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return conv(tree)


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):  # restored updater leaves written back as read
        return t
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        raise TypeError("bfloat16 parameters cannot be written to coefficients.npz "
                        "without a bfloat16 numpy type; keep default_dtype float32")
    return t.numpy()


def _save_leaves(tree) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf_{i}": _to_numpy(l) for i, l in enumerate(tree_leaves(tree))})
    return buf.getvalue()


def _read_leaves(data: bytes) -> List[np.ndarray]:
    z = np.load(io.BytesIO(data))
    return [z[f"leaf_{i}"] for i in range(len(z.files))]


def _load_leaves(data: bytes, like):
    return load_leaves_like(_read_leaves(data), like)


def load_leaves_like(leaves: List[np.ndarray], like):
    """``like``'s structure rebuilt from numpy ``leaves`` in
    :func:`tree_leaves` order, each on its reference leaf's device and in
    its dtype; raises on a count or shape mismatch."""
    like_leaves = tree_leaves(like)
    if len(leaves) != len(like_leaves):
        raise ValueError(f"Archive has {len(leaves)} arrays; model expects {len(like_leaves)}")
    coerced = []
    for a, ref in zip(leaves, like_leaves):
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"Archive array of shape {a.shape} where the model "
                             f"expects {tuple(ref.shape)}")
        coerced.append(params_from_numpy(a, device=ref.device, dtype=ref.dtype))
    return tree_unflatten_like(like, coerced)


class ModelSerializer:
    @staticmethod
    def write_model(net, path: str, save_updater: bool = True, normalizer=None) -> None:
        net._ensure_init()
        rng_state = net.rng.get_state()
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr(_CONF, net.conf.to_json())
            zf.writestr(_META, json.dumps({
                "model_type": type(net).__name__,
                "iteration": net._iteration,
                "epoch": net._epoch,
                "rng_seed": rng_state["seed"],
                "rng_key": rng_state["key"],
                "framework": "deeplearning4j_tpu_torch",
            }))
            # the arrays are stored, not deflated: float bits barely
            # compress (~7%) and deflate runs at tens of MB/s, which for
            # BERT-base's weights and Adam moments (1.3 GB) is a minute a
            # checkpoint; any zip reader, the JAX package's too, reads both
            zf.writestr(_COEFF, _save_leaves({"params": net.params(),
                                              "model_state": net._model_state}),
                        compress_type=zipfile.ZIP_STORED)
            if save_updater and net._optimizer is not None:
                zf.writestr(_UPDATER, _save_leaves(net._optimizer.state),
                            compress_type=zipfile.ZIP_STORED)
            elif save_updater and net._restored_updater_leaves is not None:
                zf.writestr(_UPDATER, _save_leaves(net._restored_updater_leaves),
                            compress_type=zipfile.ZIP_STORED)
            if normalizer is not None:
                buf = io.BytesIO()
                np.savez(buf, kind=type(normalizer).__name__, **normalizer._state())
                zf.writestr(_NORM, buf.getvalue())

    @staticmethod
    def restore_model(path: str, device=None, load_updater: bool = True):
        """Type-dispatching restore on the archive's ``model_type``: a
        ``MultiLayerNetwork`` or a ``ComputationGraph``; a quantized archive
        (``quantization.json``, written by either package's
        ``quantize_archive``) restores as a
        :class:`~..serving.quantize.QuantizedModel`."""
        with zipfile.ZipFile(path) as zf:
            names = zf.namelist()
            meta = json.loads(zf.read(_META).decode()) if _META in names else {}
        kind = meta.get("model_type", "MultiLayerNetwork")
        if "quantization.json" in names:
            from deeplearning4j_tpu_torch.serving.quantize import QuantizedModel
            return QuantizedModel.restore(path, device=device)
        if kind not in ("MultiLayerNetwork", "ComputationGraph"):
            raise NotImplementedError(f"restoring a {kind} archive is not ported to "
                                      "deeplearning4j_tpu_torch yet")
        if kind == "ComputationGraph":
            return ModelSerializer.restore_computation_graph(path, device, load_updater)
        return ModelSerializer.restore_multi_layer_network(path, device, load_updater)

    @staticmethod
    def restore_multi_layer_network(path: str, device=None, load_updater: bool = True):
        """Restore on ``device`` (``cuda`` unless the caller or the
        environment asks for the CPU)."""
        from deeplearning4j_tpu_torch.models.multi_layer_network import MultiLayerNetwork
        from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
        return ModelSerializer._restore(path, lambda js: MultiLayerNetwork(
            MultiLayerConfiguration.from_json(js), device=device), load_updater)

    @staticmethod
    def restore_computation_graph(path: str, device=None, load_updater: bool = True):
        """Restore a graph on ``device``: its leaves are keyed by node name
        in the JAX package's order, so a JAX archive (ResNet-50's, say)
        loads here."""
        from deeplearning4j_tpu_torch.models.computation_graph import (
            ComputationGraph, ComputationGraphConfiguration)
        return ModelSerializer._restore(path, lambda js: ComputationGraph(
            ComputationGraphConfiguration.from_json(js), device=device), load_updater)

    @staticmethod
    def _restore(path: str, build, load_updater: bool = True):
        with zipfile.ZipFile(path) as zf:
            net = build(zf.read(_CONF).decode()).init()
            coeff = _load_leaves(zf.read(_COEFF), {"params": net.params(),
                                                   "model_state": net._model_state})
            meta = json.loads(zf.read(_META).decode()) if _META in zf.namelist() else {}
            if load_updater and _UPDATER in zf.namelist():
                net._restored_updater_leaves = _read_leaves(zf.read(_UPDATER))
        net._params = coeff["params"]
        net._model_state = coeff["model_state"]
        net._iteration = int(meta.get("iteration", 0))
        net._epoch = int(meta.get("epoch", 0))
        if meta.get("rng_seed") is not None:
            net.rng.set_state({"seed": meta["rng_seed"], "key": meta.get("rng_key")})
        return net

    @staticmethod
    def restore_normalizer(path: str):
        """The data normalizer stored in the archive (``normalizer.npz``,
        written by either package), or None."""
        from deeplearning4j_tpu_torch.data.normalizers import Normalizer
        with zipfile.ZipFile(path) as zf:
            if _NORM not in zf.namelist():
                return None
            return Normalizer.load(io.BytesIO(zf.read(_NORM)))
