"""Named op registry of the declarative graph.

Counterpart of ``deeplearning4j_tpu/autodiff/ops_registry.py``: every graph
op is registered by name, so a graph is data (op name + attrs) and an
archive written by either package names the same ops. The callables take
tensors (and the attrs as keyword arguments) and compute what the JAX
package's do, under autograd.

Ported are the ops of the imported BERT fine-tuning path (the TF import of
``build_bert_graphdef`` and what ``graph_optimizer.optimize`` fuses it into),
those ``SDVariable``'s operators reach, the shape ops the graph optimizer
reads through (``expand_dims``; ``concat`` and ``strided_slice`` in shape
chains), and the ``nn``/``loss`` ops of the ported SameDiff scenarios
(``relu``, ``dropout``, ``split``, ``mean_squared_error``). Any other name — the JAX registry holds some 800 — raises
``NotImplementedError`` naming the op when a graph applies it
(:func:`get_op`).

Two dtype rules are the JAX package's, not PyTorch's. A binary op promotes
its operands as jnp does: every operand of a graph is an array, never a
weakly typed Python scalar, so ``bf16 * f32[0-d]`` is float32 in jnp, where
torch would keep bfloat16 (:func:`_promoted`). And an index operand is
taken as int64, as torch's index ops need.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from deeplearning4j_tpu_torch.ops.activations import (gelu_exact_recompute,
                                                      gelu_tanh_recompute,
                                                      single_pass_norm_stats)

OPS: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        OPS[name] = fn
        return fn
    return deco


def get_op(name: str) -> Callable:
    """The op's callable; ``NotImplementedError`` naming it when the port
    has no such op (the JAX package's unported ops among them)."""
    if name not in OPS:
        raise NotImplementedError(
            f"SameDiff op {name!r} is not ported to deeplearning4j_tpu_torch; "
            f"ported ops: {sorted(OPS)}")
    return OPS[name]


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` cast to their jnp result type (both are arrays in a
    graph, so the promotion lattice applies to 0-d operands too)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return (a if a.dtype == dt else a.to(dt)), (b if b.dtype == dt else b.to(dt))


def _binary(fn):
    def op(a, b):
        a, b = _promoted(a, b)
        return fn(a, b)
    return op


# ---- elementwise binary (JAX :37-45) ----
register("add")(_binary(torch.add))
register("sub")(_binary(torch.sub))
register("mul")(_binary(torch.mul))


@register("div")
def _div(a, b):
    a, b = _promoted(a, b)
    if not a.is_floating_point():  # jnp true division of integers: float32
        a, b = a.float(), b.float()
    return a / b


register("pow")(_binary(torch.pow))
register("squared_difference")(_binary(lambda a, b: (a - b) ** 2))

# comparisons: boolean outputs
register("gt")(_binary(torch.gt))
register("lt")(_binary(torch.lt))

# ---- elementwise unary (JAX :61-116) ----
register("neg")(torch.neg)
register("rsqrt")(torch.rsqrt)
register("tanh")(torch.tanh)
register("erf")(torch.erf)
register("relu")(torch.relu)


@register("gelu")
def _gelu(a, approximate=True):
    if approximate:
        return gelu_tanh_recompute(a)
    return gelu_exact_recompute(a)


# jnp.dtype names; 64-bit types are 32-bit with jax's x64 off, as in the JAX
# package
_CAST_DTYPES = {
    "float32": torch.float32, "float64": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int32": torch.int32, "int64": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}


def torch_dtype(name) -> torch.dtype:
    """A dtype name as ``jnp.dtype`` reads it, with jax's x64 off."""
    key = str(name).replace("torch.", "")
    if key not in _CAST_DTYPES:
        raise NotImplementedError(f"cast to {name!r} is not ported to deeplearning4j_tpu_torch")
    return _CAST_DTYPES[key]


register("cast")(lambda a, dtype="float32": a.to(torch_dtype(dtype)))
register("identity")(lambda a: a)


@register("dropout")
def _dropout(a, key=None, rate=0.5):
    """Inverted dropout (JAX ``:117-132``). With no ``key`` (``output``,
    ``eval``) the identity; in ``fit`` the executor passes a per-step,
    per-node ``torch.Generator`` as ``key``, and the mask is drawn on
    ``a``'s device from it."""
    if key is None:
        return a
    from deeplearning4j_tpu_torch.nn.base import keep_mask
    keep = 1.0 - rate
    return torch.where(keep_mask(a, keep, key), a / keep, torch.zeros_like(a))


# ---- matmul (JAX :136-146) ----
@register("matmul")
def _matmul(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    a, b = _promoted(a, b)
    return a @ b


register("batch_matmul")(lambda a, b, transpose_a=False, transpose_b=False:
                         _matmul(a, b, transpose_a, transpose_b))


# ---- reductions (JAX :155-174) ----
def _ax(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _reduce(fn, a, axis, keepdims):
    ax = _ax(axis)
    if ax is None:
        out = fn(a)
        return out.reshape((1,) * a.dim()) if keepdims else out
    return fn(a, dim=ax, keepdim=keepdims)


def _float(a):
    return a if a.is_floating_point() else a.float()


register("reduce_sum")(lambda a, axis=None, keepdims=False:
                       _reduce(torch.sum, a, axis, keepdims))
register("reduce_mean")(lambda a, axis=None, keepdims=False:
                        _reduce(torch.mean, _float(a), axis, keepdims))
register("reduce_std")(lambda a, axis=None, keepdims=False: _reduce(
    lambda t, **kw: torch.std(t, correction=0, **kw), _float(a), axis, keepdims))


# ---- shape (JAX :178-287) ----
register("reshape")(lambda a, shape=(): a.reshape(
    tuple(a.shape[i] if int(s) == 0 else int(s)  # 0 = copy the dim (ONNX/TF)
          for i, s in enumerate(shape))))
register("transpose")(lambda a, perm=None: a.permute(
    tuple(reversed(range(a.dim()))) if perm is None else tuple(int(p) for p in perm)))
register("expand_dims")(lambda a, axis=0: a.unsqueeze(int(axis)))
register("concat")(lambda *arrays, axis=0: torch.cat(arrays, dim=int(axis)))


@register("split")
def _split(a, num_splits=2, axis=0):
    n = a.shape[axis]
    if n % num_splits:
        raise ValueError(f"split: {n} is not divisible into {num_splits} equal parts")
    return tuple(torch.split(a, n // num_splits, dim=axis))


@register("strided_slice")
def _strided_slice(a, begin=(), end=(), strides=None, begin_mask=0, end_mask=0,
                   shrink_axis_mask=0, new_axis_mask=0, ellipsis_mask=0):
    """TF ``StridedSlice`` as numpy basic indexing, the index built as the
    JAX package builds it (``:205-228``). torch slices take positive steps
    only, so a dimension sliced with a negative step is flipped first and
    sliced forward (the same elements, in the same order)."""
    strides = strides or [1] * len(begin)
    idx = []
    for i in range(len(begin)):
        if ellipsis_mask & (1 << i):
            idx.append(Ellipsis)
            continue
        if new_axis_mask & (1 << i):
            idx.append(None)
            continue
        b = None if (begin_mask & (1 << i)) else int(begin[i])
        e = None if (end_mask & (1 << i)) else int(end[i])
        s = int(strides[i])
        if shrink_axis_mask & (1 << i):
            idx.append(int(begin[i]))
        else:
            idx.append(slice(b, e, s))
    # the input dim of each entry (numpy's rule: entries after an ellipsis
    # count from the end; None takes no input dim)
    dims = [None] * len(idx)
    if Ellipsis in idx:
        cut = idx.index(Ellipsis)
        d = 0
        for j in range(cut):
            if idx[j] is not None:
                dims[j], d = d, d + 1
        d = a.dim()
        for j in range(len(idx) - 1, cut, -1):
            if idx[j] is not None:
                d -= 1
                dims[j] = d
    else:
        d = 0
        for j, entry in enumerate(idx):
            if entry is not None:
                dims[j], d = d, d + 1
    for j, entry in enumerate(idx):
        if isinstance(entry, slice) and entry.step is not None and entry.step < 0:
            n = a.shape[dims[j]]
            picked = range(n)[entry]
            a = a.flip(dims[j])
            if len(picked) == 0:
                idx[j] = slice(0, 0)
            else:
                idx[j] = slice(n - 1 - picked[0], n - picked[-1], -entry.step)
    return a[tuple(idx)]


@register("gather")
def _gather(a, indices, axis=0):
    """``take`` along ``axis`` with int64 ids (negative ids wrap, as jnp's
    do). A table of at most 16 float rows is gathered as a one-hot product
    (JAX ``:231-251``): exact for in-range ids, its backward a small dense
    product instead of a scatter of colliding ids; an out-of-range id gives
    a zero row there, as in the JAX package. The table's gradient is dense
    either way. The gather is an advanced index, not ``index_select``: on a
    CUDA device its backward accumulates colliding ids in a sorted order,
    where ``index_select``'s atomic adds sum them in whatever order the
    threads arrive, so a fit repeats bit for bit (eager, captured or
    grouped alike)."""
    n = a.shape[axis]
    idx = indices.long()
    if (axis == 0 and a.dim() == 2 and n <= 16 and a.is_floating_point()):
        oh = (idx.unsqueeze(-1) == torch.arange(n, device=a.device)).to(a.dtype)
        return torch.einsum("...v,vd->...d", oh, a)
    idx = torch.where(idx < 0, idx + n, idx)
    out = a[(slice(None),) * axis + (idx.reshape(-1),)]
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


register("shape_of")(lambda a: torch.tensor(a.shape, dtype=torch.int32, device=a.device))


@register("reshape_dynamic")
def _reshape_dynamic(a, shape):
    """Reshape to the VALUES of a shape tensor (the importer's form for a
    computed shape; ``graph_optimizer.fold_shape_chains`` rewrites it to a
    static ``reshape``)."""
    return a.reshape(tuple(int(s) for s in shape.reshape(-1).tolist()))


# ---- nn (JAX :290-330) ----
register("softmax")(lambda a, axis=-1: torch.softmax(a, dim=int(axis)))


@register("layer_norm")
def _layer_norm(x, gain, bias=None, axis=-1, eps=1e-5):
    """LayerNorm; over one axis with the shifted single-pass float32
    statistics, the normalised value rounded to ``x``'s dtype before ``*
    gain + bias`` (JAX ``:294-309``)."""
    if isinstance(axis, (tuple, list)):  # several axes: the two-pass form
        ax = tuple(int(v) for v in axis)
        mean = x.mean(dim=ax, keepdim=True)
        var = x.var(dim=ax, keepdim=True, correction=0)
        out = _binary(torch.mul)((x - mean) * torch.rsqrt(var + eps), gain)
        return _binary(torch.add)(out, bias) if bias is not None else out
    mean, var = single_pass_norm_stats(x, int(axis))
    out = _binary(torch.mul)(((x.float() - mean) * torch.rsqrt(var + eps)).to(x.dtype), gain)
    return _binary(torch.add)(out, bias) if bias is not None else out


register("bias_add")(_binary(torch.add))


@register("linear")
def _linear(x, w, b=None):
    y = _matmul(x, w)
    return _binary(torch.add)(y, b) if b is not None else y


# ---- losses (JAX :372-390) ----
@register("softmax_cross_entropy")
def _sce(labels, logits, axis=-1):
    labels, lp = _promoted(labels, torch.log_softmax(logits, dim=int(axis)))
    return torch.mean(-torch.sum(labels * lp, dim=int(axis)))


@register("mean_squared_error")
def _mse(labels, pred):
    pred, labels = _promoted(pred, labels)
    return torch.mean(torch.sum((pred - labels) ** 2, dim=-1))


# ---- fused attention (JAX :1629-1660) ----
@register("scaled_dot_product_attention")
def _sdpa(q, k, v, bias=None, scale=None, boolean_bias=False):
    """``softmax(q @ k^T * scale + bias) @ v`` over ``(B, H, T, D)``
    operands: the graph optimizer's fusion of imported attention.

    With ``boolean_bias`` (set by the fuser only where it proved the bias
    the key-padding pattern ``(1 - mask) * -LARGE``) the bias becomes a
    boolean mask (a fully masked row unmasked, as softmax of a constant
    shift is the row unshifted) and the call goes to the port's
    :func:`~..nn.attention_layers.dot_product_attention`, which launches the
    flash-attention kernels on the card. A general additive bias, or
    operands of another rank, keep the exact softmax form."""
    from deeplearning4j_tpu_torch.nn.attention_layers import dot_product_attention
    d = q.shape[-1]
    nat = 1.0 / math.sqrt(d)
    s = nat if scale is None else float(scale)
    if q.dim() == 4 and (bias is None or boolean_bias):
        if not math.isclose(s, nat, rel_tol=1e-6):
            q = q * torch.full((), s / nat, dtype=q.dtype, device=q.device)
        mask = None
        if bias is not None:
            mask = bias > torch.full((), -1.0, dtype=bias.dtype, device=bias.device)
            mask = mask | ~mask.any(dim=-1, keepdim=True)
        return dot_product_attention(q, k, v, mask=mask)
    scores = torch.einsum("...qd,...kd->...qk", q, k) * torch.full((), s, dtype=q.dtype,
                                                                     device=q.device)
    if bias is not None:
        if boolean_bias:
            zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
            scores = scores + torch.where(bias > -1.0, zero, torch.full_like(zero, -1e9))
        else:
            scores, bias = _promoted(scores, bias)
            scores = scores + bias
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("...qk,...kd->...qd", weights, v)


# Ops that take an executor-injected ``key`` (a per-step, per-node
# ``torch.Generator``) in ``fit``: the JAX package's set (``:652-659``), so a
# graph that holds one of the unported ones raises by name when applied.
RNG_OPS = frozenset({
    "dropout", "alpha_dropout", "random_uniform", "random_normal",
    "random_bernoulli", "random_exponential", "random_shuffle",
    "random_gamma", "random_poisson", "random_gumbel", "random_laplace",
    "truncated_normal", "random_categorical", "multinomial",
    "random_binomial", "random_lognormal", "random_crop",
    "random_flip_left_right", "random_brightness", "random_contrast",
})
