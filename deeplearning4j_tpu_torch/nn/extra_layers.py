"""YOLOv2 detection output.

Counterpart of ``deeplearning4j_tpu/nn/extra_layers.py``, holding only its
``Yolo2OutputLayer`` (``:260-318``, reference
``org.deeplearning4j.nn.layers.objdetect.Yolo2OutputLayer``). The file's
other layers (3-D convolutions, cropping, locally connected, center loss,
``ConvLSTM2D``, ...) are not ported yet; a configuration that names one
raises by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.inputs import InputType


@register_layer
@dataclasses.dataclass
class Yolo2OutputLayer(Layer):
    """YOLOv2 detection loss.

    Input: ``(batch, H, W, A * (5 + C))`` raw predictions for ``A`` anchor
    boxes. Labels: the same shape, where an anchor cell that holds an
    object carries ``[tx, ty, tw, th, 1, class one-hot...]`` and every
    other cell zeros (the label encoder assigns each object to one cell and
    one anchor). The loss, divided by the batch size only, is
    ``lambda_coord`` times the squared error of ``sigmoid(xy)`` and of the
    raw ``wh`` on the responsible cells, plus the logits-form binary cross
    entropy of the objectness (``lambda_noobj`` on the cells with no
    object), plus the log-softmax cross entropy of the classes on the
    responsible cells. :meth:`activate` returns the raw predictions,
    :meth:`activate_boxes` decodes them."""

    anchors: Any = ((1.0, 1.0),)
    n_classes: int = 0
    lambda_coord: float = 5.0
    lambda_noobj: float = 0.5

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        return x, state

    def activate(self, params, x):
        return x  # raw predictions; activate_boxes() decodes them

    def _split(self, x):
        b, h, w, _ = x.shape
        return x.reshape(b, h, w, len(self.anchors), 5 + self.n_classes)

    def activate_boxes(self, x):
        """``(xy, wh, objectness, class probabilities)`` per cell and anchor:
        ``sigmoid`` of xy and of the objectness, the raw wh, the softmax of
        the class logits."""
        p = self._split(x)
        cls = torch.softmax(p[..., 5:], dim=-1) if self.n_classes else p[..., 5:]
        return torch.sigmoid(p[..., 0:2]), p[..., 2:4], torch.sigmoid(p[..., 4:5]), cls

    def compute_loss(self, params, x, labels, mask=None, state=None):
        # bf16 predictions meet float32 labels in float32, as jnp promotes
        ct = torch.promote_types(x.dtype, labels.dtype)
        p, t = self._split(x.to(ct)), self._split(labels.to(ct))
        resp = t[..., 4]  # 1 where an object is assigned to this anchor
        xy_pred = torch.sigmoid(p[..., 0:2])
        coord = (resp[..., None] * ((xy_pred - t[..., 0:2]) ** 2
                                    + (p[..., 2:4] - t[..., 2:4]) ** 2)).sum()
        logit = p[..., 4]
        bce = torch.clamp(logit, min=0) - logit * resp + torch.log1p(torch.exp(-logit.abs()))
        obj = (resp * bce).sum() + self.lambda_noobj * ((1 - resp) * bce).sum()
        loss = self.lambda_coord * coord + obj
        if self.n_classes:
            logp = F.log_softmax(p[..., 5:], dim=-1)
            loss = loss - (resp[..., None] * t[..., 5:] * logp).sum()
        return loss / (x.shape[0] * 1.0)
