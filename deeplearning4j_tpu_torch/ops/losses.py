"""Loss functions.

Counterpart of ``deeplearning4j_tpu/ops/losses.py``: the reference's
``LossFunctions.LossFunction`` set with the same conventions — averaged over
the minibatch, per-output losses summed over the output dimension, masks
zero masked steps and renormalise by the mask sum, each loss takes
``(labels, preoutput, activation)`` and fuses the activation. Rank-3
(batch, time, out) outputs fold time into the example axis.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional, Union

import torch

from deeplearning4j_tpu_torch.ops.activations import get_activation

_EPS = 1e-7


class LossFunction(str, enum.Enum):
    MCXENT = "mcxent"
    XENT = "xent"
    MSE = "mse"
    L1 = "l1"
    L2 = "l2"
    MAE = "mae"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    POISSON = "poisson"
    COSINE_PROXIMITY = "cosine_proximity"
    KL_DIVERGENCE = "kl_divergence"
    MSLE = "msle"
    SPARSE_MCXENT = "sparse_mcxent"


def _act_name(act) -> str:
    return str(act.value if isinstance(act, enum.Enum) else act).lower()


def _apply_activation(preout, activation):
    return get_activation(activation)(preout) if activation is not None else preout


def _per_example(loss_per_elem, mask):
    per_ex = torch.sum(loss_per_elem, dim=-1)
    return per_ex * mask if mask is not None else per_ex


def _reduce(per_ex, mask):
    if mask is not None:
        return torch.sum(per_ex) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(per_ex) if per_ex.dim() == 1 else torch.sum(per_ex) / per_ex.shape[0]


def compute_loss(loss: Union[str, LossFunction, Callable], labels: torch.Tensor,
                 preoutput: torch.Tensor, activation=None,
                 mask: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar loss. ``mask``: (batch,) or (batch, time). Computed in at
    least float32 under a bfloat16 compute policy."""
    if callable(loss) and not isinstance(loss, (str, LossFunction)):
        return loss(labels, preoutput, mask)
    if preoutput.is_floating_point():
        ldt = torch.promote_types(preoutput.dtype, torch.float32)
        preoutput = preoutput.to(ldt)
        if labels.is_floating_point():
            labels = labels.to(ldt)
    fn = _LOSSES[_coerce(loss)]
    if preoutput.dim() == 3:
        b, t = preoutput.shape[0], preoutput.shape[1]
        preoutput = preoutput.reshape(b * t, -1)
        labels = labels.reshape(b * t, -1) if labels.dim() == 3 else labels.reshape(b * t)
        if mask is not None:
            mask = mask.reshape(b * t)
    return fn(labels, preoutput, activation, mask, weights)


def _mcxent(labels, preout, activation, mask, weights):
    act = "softmax" if activation is None else activation
    if _act_name(act) == "softmax":
        logp = torch.log_softmax(preout, dim=-1)
    else:
        logp = torch.log(torch.clamp(_apply_activation(preout, act), _EPS, 1.0))
    ll = labels * logp
    if weights is not None:
        ll = ll * weights
    return _reduce(_per_example(-ll, mask), mask)


def _sparse_mcxent(labels, preout, activation, mask, weights):
    logp = torch.log_softmax(preout, dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        ll = ll * mask
    return _reduce(-ll, mask)


def _xent(labels, preout, activation, mask, weights):
    act = "sigmoid" if activation is None else activation
    if _act_name(act) == "sigmoid":
        x, z = preout, labels
        per = torch.clamp(x, min=0) - x * z + torch.log1p(torch.exp(-torch.abs(x)))
    else:
        p = torch.clamp(_apply_activation(preout, act), _EPS, 1.0 - _EPS)
        per = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    if weights is not None:
        per = per * weights
    return _reduce(_per_example(per, mask), mask)


def _mse(labels, preout, activation, mask, weights):
    d = _apply_activation(preout, activation) - labels
    per = d * d
    if weights is not None:
        per = per * weights
    return _reduce(_per_example(per, mask), mask)


def _mae(labels, preout, activation, mask, weights):
    per = torch.abs(_apply_activation(preout, activation) - labels)
    if weights is not None:
        per = per * weights
    return _reduce(_per_example(per, mask), mask)


def _hinge(labels, preout, activation, mask, weights):
    y = torch.where(labels > 0, 1.0, -1.0)
    per = torch.clamp(1.0 - y * _apply_activation(preout, activation), min=0.0)
    return _reduce(_per_example(per, mask), mask)


def _squared_hinge(labels, preout, activation, mask, weights):
    y = torch.where(labels > 0, 1.0, -1.0)
    per = torch.clamp(1.0 - y * _apply_activation(preout, activation), min=0.0) ** 2
    return _reduce(_per_example(per, mask), mask)


def _poisson(labels, preout, activation, mask, weights):
    out = torch.clamp(_apply_activation(preout, activation), min=_EPS)
    return _reduce(_per_example(out - labels * torch.log(out), mask), mask)


def _cosine(labels, preout, activation, mask, weights):
    out = _apply_activation(preout, activation)
    num = torch.sum(labels * out, dim=-1)
    den = torch.linalg.norm(labels, dim=-1) * torch.linalg.norm(out, dim=-1)
    per = -num / torch.clamp(den, min=_EPS)
    if mask is not None:
        per = per * mask
    return _reduce(per, mask)


def _kld(labels, preout, activation, mask, weights):
    act = "softmax" if activation is None else activation
    out = torch.clamp(_apply_activation(preout, act), _EPS, 1.0)
    lab = torch.clamp(labels, _EPS, 1.0)
    return _reduce(_per_example(lab * (torch.log(lab) - torch.log(out)), mask), mask)


def _msle(labels, preout, activation, mask, weights):
    out = _apply_activation(preout, activation)
    per = (torch.log1p(torch.clamp(out, min=-1 + _EPS)) - torch.log1p(labels)) ** 2
    return _reduce(_per_example(per, mask), mask)


_LOSSES = {
    LossFunction.MCXENT: _mcxent,
    LossFunction.SPARSE_MCXENT: _sparse_mcxent,
    LossFunction.NEGATIVELOGLIKELIHOOD: _mcxent,
    LossFunction.XENT: _xent,
    LossFunction.MSE: _mse,
    LossFunction.L2: _mse,
    LossFunction.L1: _mae,
    LossFunction.MAE: _mae,
    LossFunction.HINGE: _hinge,
    LossFunction.SQUARED_HINGE: _squared_hinge,
    LossFunction.POISSON: _poisson,
    LossFunction.COSINE_PROXIMITY: _cosine,
    LossFunction.KL_DIVERGENCE: _kld,
    LossFunction.MSLE: _msle,
}


def _coerce(name: Union[str, LossFunction]) -> LossFunction:
    if isinstance(name, LossFunction):
        return name
    return LossFunction(str(name).lower())
