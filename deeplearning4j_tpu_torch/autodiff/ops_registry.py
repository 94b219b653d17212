"""Named op registry of the declarative graph.

Counterpart of ``deeplearning4j_tpu/autodiff/ops_registry.py``: every graph
op is registered by name, so a graph is data (op name + attrs) and an
archive written by either package names the same ops. The callables take
tensors (and the attrs as keyword arguments) and compute what the JAX
package's do, under autograd.

Ported are the ops of the imported BERT fine-tuning path (the TF import of
``build_bert_graphdef`` and what ``graph_optimizer.optimize`` fuses it into),
those ``SDVariable``'s operators reach, the shape ops the graph optimizer
reads through, the ``nn``/``loss`` ops of the ported SameDiff scenarios, the
``quantize``/``dequantize`` pair serving's int8 archives are built with, and
every op the TF GraphDef importer (``imports/tf_import.py``) emits: the
elementwise math of its ``simple`` table, the reductions, the shape family,
NHWC/HWIO convolutions and pools, ``batch_norm``, the image resizes, the
linear algebra of its matrix ops, ``einsum``, ``gather_nd``, ``top_k`` and
the seeded random draws. Any other name — the JAX registry holds some 800 —
raises ``NotImplementedError`` naming the op when a graph applies it
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

import numpy as np
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


# ---- quantization (JAX :2273-2322) ----
def _as_tensor(v, dtype=None, device=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        t = v if device is None else v.to(device)
        return t if dtype is None else t.to(dtype)
    a = np.asarray(v)
    if a.dtype == np.float64 and dtype is None:
        a = a.astype(np.float32)  # jnp.asarray with 64-bit off
    return torch.as_tensor(a, dtype=dtype, device=device)


def _quant_broadcast(v: torch.Tensor, ndim: int, axis) -> torch.Tensor:
    """A per-channel scale/zero-point array reshaped to broadcast along
    ``axis`` of a rank-``ndim`` tensor (scalars pass through)."""
    if v.ndim == 0 or axis is None:
        return v
    if v.ndim != 1:
        raise ValueError(f"per-channel quantization expects a 1-D "
                         f"scale/zero-point array, got shape {tuple(v.shape)}")
    shape = [1] * ndim
    shape[axis % ndim] = v.shape[0]
    return v.reshape(shape)


@register("quantize")
def _quantize(a, scale=1.0, zero_point=0, dtype="int8", axis=None, narrow_range=False):
    """Affine quantization ``q = clip(round(a / scale) + zero_point)``:
    per-channel 1-D ``scale``/``zero_point`` broadcast along ``axis``,
    ``narrow_range`` drops the most negative code (``[-127, 127]`` for
    int8), rounding half to even. Integer inputs are cast to float32 and
    float64 ones to float32 (the JAX package runs with 64-bit off)."""
    a = _as_tensor(a)
    if not a.is_floating_point() or a.dtype == torch.float64:
        a = a.to(torch.float32)
    scale = _quant_broadcast(_as_tensor(scale, a.dtype, a.device), a.ndim, axis)
    zp = _quant_broadcast(_as_tensor(zero_point, device=a.device), a.ndim, axis)
    out = torch_dtype(dtype)
    info = torch.iinfo(out)
    lo = info.min + 1 if narrow_range else info.min
    return torch.clamp(torch.round(a / scale) + zp, lo, info.max).to(out)


@register("dequantize")
def _dequantize(q, scale=1.0, zero_point=0, axis=None, dtype="float32"):
    """Inverse affine map ``(q - zero_point) * scale`` in ``dtype``, with
    the per-channel broadcast of :func:`_quantize`."""
    q = _as_tensor(q)
    out = torch_dtype(dtype)
    scale = _quant_broadcast(_as_tensor(scale, out, q.device), q.ndim, axis)
    zp = _quant_broadcast(_as_tensor(zero_point, device=q.device), q.ndim, axis)
    return (q.to(out) - zp.to(out)) * scale


# ---- the TF importer's ops (JAX :37-116, :155-291, :312-350, :455-560,
# :662-730, :935-955, :1085-1100, :1111-1120, :1191-1270, :1384-1390,
# :1477-1490, :1938-1990, :2108-2112, :2168-2174, :2467) ----
def _unary_float(fn):
    """A transcendental: integer inputs are promoted to float32, as jnp's."""
    def op(a):
        return fn(_float(a))
    return op


def _keep_int(fn):
    """``floor``/``ceil``/``round``/``rint``: the identity on integers."""
    def op(a):
        return fn(a) if a.is_floating_point() else a
    return op


for _name, _fn in (("exp", torch.exp), ("log", torch.log), ("log1p", torch.log1p),
                   ("sqrt", torch.sqrt), ("sin", torch.sin), ("cos", torch.cos),
                   ("tan", torch.tan), ("asin", torch.asin), ("acos", torch.acos),
                   ("atan", torch.atan), ("sinh", torch.sinh), ("cosh", torch.cosh),
                   ("asinh", torch.asinh), ("acosh", torch.acosh), ("atanh", torch.atanh),
                   ("expm1", torch.expm1), ("erfc", torch.special.erfc),
                   ("gammaln", torch.lgamma), ("digamma", torch.digamma),
                   ("sigmoid", torch.sigmoid),
                   ("softplus", lambda a: torch.logaddexp(a, torch.zeros_like(a))),
                   ("softsign", lambda a: a / (1 + torch.abs(a))),
                   ("elu", torch.nn.functional.elu), ("selu", torch.selu)):
    register(_name)(_unary_float(_fn))
for _name, _fn in (("floor", torch.floor), ("ceil", torch.ceil),
                   ("round", torch.round), ("rint", torch.round)):  # half to even
    register(_name)(_keep_int(_fn))
register("abs")(torch.abs)
register("sign")(torch.sign)
register("square")(lambda a: a * a)
register("relu6")(lambda a: torch.clamp(a, 0, 6))
register("leaky_relu")(lambda a, alpha=0.01: torch.where(a >= 0, a, alpha * a))
register("log_softmax")(lambda a, axis=-1: torch.log_softmax(a, dim=int(axis)))
register("zeros_like")(torch.zeros_like)
register("ones_like")(torch.ones_like)
register("l2_loss")(lambda a: 0.5 * torch.sum(a * a))


@register("reciprocal")
def _reciprocal(a):
    return torch.reciprocal(_float(a))


register("maximum")(_binary(torch.maximum))
register("minimum")(_binary(torch.minimum))
register("atan2")(_binary(lambda a, b: torch.atan2(_float(a), _float(b))))
register("xlogy")(_binary(lambda a, b: torch.special.xlogy(_float(a), _float(b))))
register("gte")(_binary(torch.ge))
register("lte")(_binary(torch.le))
register("eq")(_binary(torch.eq))
register("neq")(_binary(torch.ne))
register("logical_and")(torch.logical_and)
register("logical_or")(torch.logical_or)
register("logical_not")(torch.logical_not)
# floor division and the remainder take the divisor's sign (jnp.floor_divide
# and jnp.mod, Python's rule); the truncating pair rounds toward zero through
# a true division, as the JAX package computes them
register("floordiv")(_binary(lambda a, b: torch.div(a, b, rounding_mode="floor")))
register("mod")(_binary(torch.remainder))


def _true_div(a, b):
    if not a.is_floating_point():  # jnp true division of integers: float32
        return a.float() / b.float()
    return a / b


register("truncate_div")(_binary(lambda a, b: torch.trunc(_true_div(a, b)).to(a.dtype)))
register("truncate_mod")(_binary(
    lambda a, b: a - torch.trunc(_true_div(a, b)).to(a.dtype) * b))


@register("div_no_nan")
def _div_no_nan(a, b):
    a, b = _promoted(a, b)
    zero = b == 0
    out = _true_div(a, torch.where(zero, torch.ones_like(b), b))
    return torch.where(zero, torch.zeros_like(out), out)


@register("multiply_no_nan")
def _multiply_no_nan(a, b):
    a, b = _promoted(a, b)
    out = a * b
    return torch.where(b == 0, torch.zeros_like(out), out)


@register("xdivy")
def _xdivy(a, b):
    a, b = _promoted(a, b)
    zero = a == 0
    out = _true_div(a, torch.where(zero, torch.ones_like(b), b))
    return torch.where(zero, torch.zeros_like(out), out)


@register("where")
def _where(cond, x, y):
    x, y = _promoted(x, y)
    return torch.where(cond.bool() if cond.dtype != torch.bool else cond, x, y)


@register("add_n")
def _add_n(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = _binary(torch.add)(out, x)
    return out


# reductions
def _amax(t, dim=None, keepdim=False):
    return torch.amax(t) if dim is None else torch.amax(t, dim=dim, keepdim=keepdim)


def _amin(t, dim=None, keepdim=False):
    return torch.amin(t) if dim is None else torch.amin(t, dim=dim, keepdim=keepdim)


def _prod(t, dim=None, keepdim=False):
    if dim is None:
        return torch.prod(t)
    for d in sorted((dim if isinstance(dim, tuple) else (dim,)),
                    key=lambda d: d % t.dim(), reverse=True):
        t = torch.prod(t, dim=d, keepdim=keepdim)
    return t


register("reduce_max")(lambda a, axis=None, keepdims=False: _reduce(_amax, a, axis, keepdims))
register("reduce_min")(lambda a, axis=None, keepdims=False: _reduce(_amin, a, axis, keepdims))
register("reduce_prod")(lambda a, axis=None, keepdims=False: _reduce(_prod, a, axis, keepdims))
register("argmax")(lambda a, axis=-1: torch.argmax(a, dim=int(axis)).to(torch.int32))
register("argmin")(lambda a, axis=-1: torch.argmin(a, dim=int(axis)).to(torch.int32))


def _cumulative(fn):
    def op(a, axis):
        out = fn(a, dim=int(axis))
        # jnp keeps an integer dtype (bool counts as int32); torch widens
        return out if a.is_floating_point() else out.to(
            torch.int32 if a.dtype == torch.bool else a.dtype)
    return op


register("cumsum")(lambda a, axis=0: _cumulative(torch.cumsum)(a, axis))
register("cumprod")(lambda a, axis=-1: _cumulative(torch.cumprod)(a, axis))


# shape
@register("squeeze")
def _squeeze(a, axis=None):
    if axis is None:
        return a.squeeze()
    axes = tuple(int(x) % a.dim() for x in (axis if isinstance(axis, (list, tuple)) else [axis]))
    for d in axes:
        if a.shape[d] != 1:
            raise ValueError(f"squeeze: dimension {d} of {tuple(a.shape)} is not 1")
    return a.squeeze(axes)


register("stack")(lambda *arrays, axis=0: torch.stack(_promoted_all(arrays), dim=int(axis)))


def _promoted_all(arrays):
    dt = arrays[0].dtype
    for t in arrays[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t if t.dtype == dt else t.to(dt) for t in arrays]


@register("unstack")
def _unstack(a, axis=0, num=None):
    n = num if num is not None else a.shape[axis]
    if a.shape[axis] != n:
        raise ValueError(f"unstack: {a.shape[axis]} is not {n} parts")
    return tuple(torch.unbind(a, dim=int(axis)))


register("tile")(lambda a, multiples=(): torch.tile(a, tuple(int(m) for m in multiples)))


@register("slice")
def _slice(a, begin=(), size=()):
    for d, (b, n) in enumerate(zip(begin, size)):
        a = a.narrow(d, int(b), int(n))
    return a


@register("gather_nd")
def _gather_nd(a, indices):
    idx = indices.long()
    return a[tuple(idx.unbind(-1))]


@register("one_hot")
def _one_hot(a, depth=2, on_value=1.0, off_value=0.0, axis=-1):
    """``jax.nn.one_hot`` (an index outside ``[0, depth)`` gives a zero
    row), scaled to ``on_value``/``off_value`` in float32."""
    idx = a.to(torch.int32)
    out_dim = idx.dim() + 1
    ax = int(axis) % out_dim
    shape = [1] * out_dim
    shape[ax] = int(depth)
    classes = torch.arange(int(depth), device=a.device, dtype=torch.int32).reshape(shape)
    hot = (idx.unsqueeze(ax) == classes).to(torch.float32)
    return hot * (on_value - off_value) + off_value


def _pad_index(n, lo, hi, mode, device):
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        period = 2 * (n - 1)
        i = torch.remainder(i, period)
        return torch.where(i > n - 1, period - i, i)
    raise ValueError(f"pad mode {mode!r}")


@register("pad")
def _pad(a, paddings=(), constant_value=0.0, mode="constant"):
    """``jnp.pad``: ``constant`` with a value, or numpy's ``reflect``,
    ``edge`` and ``wrap`` (gathers along each padded dimension)."""
    pads = [(int(p[0]), int(p[1])) for p in paddings]
    if mode == "constant":
        flat = []
        for lo, hi in reversed(pads):
            flat += [lo, hi]
        return torch.nn.functional.pad(a, flat, value=constant_value)
    for d, (lo, hi) in enumerate(pads):
        if lo or hi:
            a = a.index_select(d, _pad_index(a.shape[d], lo, hi, mode, a.device))
    return a


@register("reverse")
def _reverse(a, axis=0):
    return torch.flip(a, dims=tuple(int(x) for x in axis) if isinstance(axis, (list, tuple))
                      else (int(axis),))


@register("space_to_depth")
def _space_to_depth(x, block_size=2):
    n, h, w, c = x.shape
    bs = int(block_size)
    x = x.reshape(n, h // bs, bs, w // bs, bs, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // bs, w // bs, bs * bs * c)


@register("depth_to_space")
def _depth_to_space(x, block_size=2):
    n, h, w, c = x.shape
    bs = int(block_size)
    x = x.reshape(n, h, w, bs, bs, c // (bs * bs))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * bs, w * bs, c // (bs * bs))


@register("invert_permutation")
def _invert_permutation(p):
    return torch.argsort(p, stable=True).to(torch.int32)


@register("top_k")
def _top_k(a, k=1):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort), indices int32."""
    v, i = torch.sort(a, dim=-1, descending=True, stable=True)
    return v[..., :int(k)], i[..., :int(k)].to(torch.int32)


@register("einsum")
def _einsum(*operands, equation=""):
    return torch.einsum(equation, *_promoted_all(list(operands)))


# linear algebra
register("cholesky")(lambda a: torch.linalg.cholesky(a))
register("matrix_inverse")(lambda a: torch.linalg.inv(a))
register("matrix_determinant")(lambda a: torch.linalg.det(a))
register("matrix_diag_part")(lambda a: torch.diagonal(a, dim1=-2, dim2=-1))


@register("matrix_diag")
def _matrix_diag(a):
    return a[..., :, None] * torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)


@register("matrix_band_part")
def _matrix_band_part(a, num_lower=-1, num_upper=-1):
    m, n = a.shape[-2], a.shape[-1]
    i = torch.arange(m, device=a.device)[:, None]
    j = torch.arange(n, device=a.device)[None, :]
    keep = torch.ones((m, n), dtype=torch.bool, device=a.device)
    if num_lower >= 0:
        keep &= (i - j) <= num_lower
    if num_upper >= 0:
        keep &= (j - i) <= num_upper
    return torch.where(keep, a, torch.zeros((), dtype=a.dtype, device=a.device))


# convolution and pooling, NHWC activations and HWIO kernels
def _same_pads(size, k, s, d=1):
    """TF/XLA ``SAME`` padding of one spatial dimension: (before, after)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _spatial_pads(x_hw, k_hw, stride, dilation, padding):
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0), (0, 0)]
        if padding.upper() == "SAME":
            return [_same_pads(n, k, s, d) for n, k, s, d in zip(x_hw, k_hw, stride, dilation)]
        raise ValueError(f"padding {padding!r}")
    return [(int(p[0]), int(p[1])) for p in padding]


def _pad_nchw(x, pads, value=0.0):
    (t, b), (l, r) = pads
    if t or b or l or r:
        x = torch.nn.functional.pad(x, [l, r, t, b], value=value)
    return x


def _pair(v):
    return (int(v),) * 2 if isinstance(v, int) else tuple(int(s) for s in v)


@register("conv2d")
def _conv2d(x, w, b=None, stride=(1, 1), padding="SAME", dilation=(1, 1), groups=1):
    """``lax.conv_general_dilated`` over NHWC ``x`` and an HWIO kernel
    (``I`` = input channels / ``groups``), ``SAME``/``VALID`` or explicit
    (before, after) pads."""
    stride, dilation = _pair(stride), _pair(dilation)
    x, w = _promoted(x, w)
    kh, kw = w.shape[0], w.shape[1]
    pads = _spatial_pads(x.shape[1:3], (kh, kw), stride, dilation, padding)
    xc = _pad_nchw(x.permute(0, 3, 1, 2), pads)
    y = torch.nn.functional.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride,
                                   dilation=dilation, groups=int(groups))
    y = y.permute(0, 2, 3, 1)
    return _binary(torch.add)(y, b) if b is not None else y


@register("depthwise_conv2d")
def _depthwise_conv2d(x, w, stride=(1, 1), padding="SAME"):
    """Kernel ``(KH, KW, C, M)``: a grouped convolution of C groups."""
    kh, kw, c, m = w.shape
    return _conv2d(x, w.reshape(kh, kw, 1, c * m), stride=stride, padding=padding, groups=c)


def _transpose_pads(k, s, padding):
    """``lax._conv_transpose_padding``: the (before, after) pads of the
    stride-dilated input of a transposed convolution."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"padding {padding!r}")
    return pad_a, pad_len - pad_a


@register("conv2d_transpose")
def _conv2d_transpose(y, w, stride=(1, 1), padding="SAME", output_shape=None):
    """``lax.conv_transpose(..., transpose_kernel=True)`` (TF
    ``Conv2DBackpropInput``): the adjoint of ``conv2d`` with the HWIO
    kernel ``w``. Computed as the full transposed convolution, then cut
    (or zero-extended) to the window lax's padding rule gives."""
    stride = _pair(stride)
    y, w = _promoted(y, w)
    full = torch.nn.functional.conv_transpose2d(y.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                                stride=stride)
    for d, (n, k, s) in enumerate(zip(y.shape[1:3], w.shape[:2], stride)):
        pad_a, pad_b = _transpose_pads(int(k), s, padding)
        start = (k - 1) - pad_a
        length = (n - 1) * s + 1 + pad_a + pad_b - k + 1
        dim = 2 + d
        have = full.shape[dim]
        if start + length > have:  # beyond the full output the sum is zero
            extra = [0, 0, 0, 0]
            extra[2 * (1 - d) + 1] = start + length - have
            full = torch.nn.functional.pad(full, extra)
        full = full.narrow(dim, start, length)
    out = full.permute(0, 2, 3, 1)
    if output_shape is not None and tuple(int(s) for s in output_shape) != tuple(out.shape):
        raise NotImplementedError(
            f"conv2d_transpose: requested output shape {tuple(output_shape)} "
            f"!= computed {tuple(out.shape)} (non-standard TF deconv sizing)")
    return out


def _pool_window(x, kernel, stride, padding):
    kernel, stride = _pair(kernel), _pair(stride)
    pads = _spatial_pads(x.shape[1:3], kernel, stride, (1, 1), padding)
    return kernel, stride, pads


@register("max_pool2d")
def _max_pool2d(x, kernel=(2, 2), stride=(2, 2), padding="VALID"):
    """``lax.reduce_window`` max over NHWC, ``-inf`` padding."""
    kernel, stride, pads = _pool_window(x, kernel, stride, padding)
    xc = _pad_nchw(x.permute(0, 3, 1, 2), pads, value=float("-inf"))
    return torch.nn.functional.max_pool2d(xc, kernel, stride).permute(0, 2, 3, 1)


@register("avg_pool2d")
def _avg_pool2d(x, kernel=(2, 2), stride=(2, 2), padding="VALID", count_include_pad=False):
    """The window sum over the count of real (unpadded) elements, or over
    the window's size with ``count_include_pad``."""
    kernel, stride, pads = _pool_window(x, kernel, stride, padding)
    xc = _pad_nchw(x.permute(0, 3, 1, 2), pads)
    s = torch.nn.functional.avg_pool2d(xc, kernel, stride) * (kernel[0] * kernel[1])
    if count_include_pad:
        return (s / (kernel[0] * kernel[1])).permute(0, 2, 3, 1)
    ones = _pad_nchw(torch.ones_like(x[:1, :, :, :1]).permute(0, 3, 1, 2), pads)
    c = torch.nn.functional.avg_pool2d(ones, kernel, stride) * (kernel[0] * kernel[1])
    return (s / c).permute(0, 2, 3, 1)


@register("batch_norm")
def _batch_norm(x, mean, variance, gamma=None, beta=None, eps=1e-5):
    out = _binary(torch.mul)(_binary(torch.sub)(x, mean), torch.rsqrt(variance + eps))
    if gamma is not None:
        out = _binary(torch.mul)(out, gamma)
    if beta is not None:
        out = _binary(torch.add)(out, beta)
    return out


# image resizes (NHWC)
def _triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """``jax.image.scale_and_translate``'s bilinear weight matrix
    ``(n_in, n_out)`` in float32, antialiased (the triangle widened by the
    scale) when downsampling, as ``jax.image.resize`` computes it."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))  # a Python division, then float32
    kscale = max(inv, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.0) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kscale
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@register("resize_bilinear")
def _resize_bilinear(images, height=None, width=None, align_corners=False):
    """``jax.image.resize(..., "bilinear")``: half-pixel centres,
    antialiased when downsampling."""
    if align_corners:
        raise NotImplementedError(
            "resize_bilinear(align_corners=True) is not supported; "
            "jax.image.resize uses half-pixel alignment")
    x = _float(images)
    out = x
    for dim, n_out in ((1, int(height)), (2, int(width))):
        n_in = x.shape[dim]
        if n_in == n_out:
            continue
        wt = torch.as_tensor(_triangle_weights(n_in, n_out), device=x.device).to(x.dtype)
        out = torch.movedim(torch.tensordot(out, wt, dims=([dim], [0])), -1, dim)
    return out


@register("resize_nearest")
def _resize_nearest(images, height=None, width=None, half_pixel_centers=True):
    n, h, w, c = images.shape
    f32 = np.float32

    def index(n_in, n_out):
        if half_pixel_centers:  # jax.image.resize "nearest", in float32
            off = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(n_in) / f32(n_out)
            idx = np.floor(off.astype(f32)).astype(np.int64)
        else:  # legacy TF1: min(floor(dst * in / out), in - 1)
            idx = np.minimum((np.arange(n_out) * (n_in / n_out)).astype(np.int32), n_in - 1)
        return torch.as_tensor(idx, dtype=torch.long, device=images.device)

    return images[:, index(h, int(height))][:, :, index(w, int(width))]


# seeded random draws: the TF seed names the stream; in ``fit`` the executor
# passes a per-step generator as ``key``. The streams are the port's own
# (not JAX's threefry), so draws agree with the JAX package's only in law.
def _draw_device(shape_operand=None):
    if isinstance(shape_operand, torch.Tensor):
        return shape_operand.device
    from deeplearning4j_tpu_torch.runtime.environment import get_environment
    return get_environment().resolve_device(None)


def _shape_of(shape) -> tuple:
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    return tuple(int(s) for s in shape)


def _draw(fn, shape, seed, key):
    """``fn(shape, generator, device)`` on the draw's device, from ``key``
    (a generator on that device draws in place; a CPU one draws on the host)
    or from a generator on that device seeded with ``seed``."""
    device = _draw_device(shape)
    gen = key if key is not None else torch.Generator(device=device).manual_seed(
        int(seed) & 0x7FFFFFFFFFFFFFFF)
    where = gen.device if gen.device.type == device.type else torch.device("cpu")
    return fn(_shape_of(shape), gen, where).to(device)


@register("random_uniform")
def _random_uniform(shape=None, minval=0.0, maxval=1.0, seed=0, key=None):
    return _draw(lambda s, g, d: torch.rand(s, generator=g, device=d) * (maxval - minval)
                 + minval, shape, seed, key)


@register("random_normal")
def _random_normal(shape=None, mean=0.0, stddev=1.0, seed=0, key=None):
    return _draw(lambda s, g, d: mean + stddev * torch.randn(s, generator=g, device=d),
                 shape, seed, key)


@register("truncated_normal")
def _truncated_normal(shape=None, mean=0.0, stddev=1.0, seed=0, key=None):
    """A standard normal truncated to [-2, 2] (inverse-CDF draw), scaled."""
    def draw(s, g, d):
        t = torch.empty(s, device=d)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
        return mean + stddev * t
    return _draw(draw, shape, seed, key)


@register("random_categorical")
def _random_categorical(logits, num_samples=1, seed=0, key=None):
    """``num_samples`` class draws per row of ``logits`` (last axis), as
    ``(..., num_samples)`` int32."""
    probs = torch.softmax(_float(logits), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])

    def draw(s, g, d):
        return torch.multinomial(flat.to(d), int(num_samples), replacement=True, generator=g)

    out = _draw(draw, torch.zeros(0, device=logits.device), seed, key)
    return out.reshape(probs.shape[:-1] + (int(num_samples),)).to(torch.int32)


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
