"""Flash attention, forward and backward, as CUDA kernels for Hopper.

Counterpart of ``deeplearning4j_tpu/ops/pallas/flash_attention.py``:
``_flash_fwd`` (the ``pallas_call`` at :226) becomes ``csrc/flash_fwd.cu``,
and ``_flash_bwd`` (:633 dq, :655 dk/dv) and ``_flash_bwd_chunked`` (:542,
:575; T > 8192) become the two kernels of ``csrc/flash_bwd.cu``, which
stream their tiles from global memory at any length and so compute both.
Per (batch, head) the forward computes ``O = softmax(Q K^T / sqrt(d) + bias
[+ causal]) V`` tile by tile with the online softmax, never storing the
score matrix; its saving instance also writes the per-row logsumexp ``lse``
that the backward reads to recompute ``P = exp(S - lse)`` tile by tile.

Layout is the JAX package's: ``(batch, heads, time, d)``. A key-padding
mask (``(b, t_k)`` or ``(b, 1, 1, t_k)``, true = attend) becomes the
additive fp32 bias ``0 / -1e30`` shared by the heads; ``causal`` is the
top-left triangle and needs ``t_q == t_k``. A fully masked row gives the
mean of V; its backward takes ``P = 1`` for every key, as the Pallas
backward does (see ``flash_bwd.cu``). ``d`` and ``d_v`` may differ, each at
most 256; q, k and v share one dtype, float32 or bfloat16; ``t_q`` and
``t_k`` are any lengths >= 1.

:func:`flash_attention` and :func:`flash_attention_lse` launch the kernels
for CUDA tensors and raise on what they do not take; only CPU tensors take
the plain PyTorch versions, :func:`flash_attention_reference` and
:func:`flash_attention_backward_reference`. A call that autograd records
goes through :class:`FlashAttentionFunction` (the saving forward, then the
two backward kernels); under ``no_grad``/``inference_mode`` the inference
instance runs. On the card the kernels read their operands through their
strides (the last dimension must be contiguous), so a head split
``x.reshape(b, t, h, d).transpose(1, 2)`` costs no copy, and they write O,
dq, dk and dv into ``(b, t, h, d)`` buffers whose ``(b, h, t, d)`` views
they return, so the merge of the heads that follows costs none either.
The bf16 forward and backward run on the tensor cores (the backward at
``d`` and ``d_v`` up to 128; wider heads take its CUDA-core kernels) and
stage their operands with 16-byte ``cp.async`` copies where every row starts
on a 16-byte boundary (:func:`_vector_ok`), element by element otherwise;
the float32 kernels are the card's fp32 check of the algorithm, on the CUDA
cores.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops.kernels._native import (LaunchCounter,
                                                          NativeLibrary,
                                                          register_library)

# Additive bias of a masked key: large but finite, so a fully masked row
# keeps a finite running max (the mean of V) instead of NaN.
MASK_VALUE = -1e30
MAX_HEAD_DIM = 256
MAX_GRID_ROWS = 65535  # batch * heads: the y extent of the float32 and backward grids

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

counter = LaunchCounter("flash_attention")  # inference instance
lse_counter = LaunchCounter("flash_attention_lse")  # saving instance (writes lse)
bwd_dq_counter = LaunchCounter("flash_attention_bwd_dq")
bwd_dkv_counter = LaunchCounter("flash_attention_bwd_dkv")


def _declare_error_string(lib: ctypes.CDLL) -> None:
    lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # (dtype, q, k, v, bias, o, lse, B, H, Tq, Tk, D, Dv, strides x 12, scale,
    #  causal, vec, stream)
    lib.dl4j_flash_fwd.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i,
                                   *([ll] * 12), ctypes.c_float, i, i, p]
    lib.dl4j_flash_fwd.restype = i
    _declare_error_string(lib)


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (dtype, q, k, v, o, dout, lse, bias, delta, dq, B, H, Tq, Tk, D, Dv,
    #  strides, scale, causal, vec, stream)
    lib.dl4j_flash_bwd_dq.argtypes = [i, *([p] * 9), *([i] * 6), p, f, i, i, p]
    lib.dl4j_flash_bwd_dq.restype = i
    # (dtype, q, k, v, dout, lse, bias, delta, dk, dv, B, H, Tq, Tk, D, Dv,
    #  strides, scale, causal, vec, stream)
    lib.dl4j_flash_bwd_dkv.argtypes = [i, *([p] * 9), *([i] * 6), p, f, i, i, p]
    lib.dl4j_flash_bwd_dkv.restype = i
    _declare_error_string(lib)


LIBRARY = register_library(NativeLibrary("flash_fwd.cu", _declare))
BWD_LIBRARY = register_library(NativeLibrary("flash_bwd.cu", _declare_bwd))


def padding_mask_2d(mask, b: int, t_k: int) -> Optional[torch.Tensor]:
    """A broadcastable attention mask reduced to a ``(b, t_k)`` key-padding
    mask, or ``None`` when it is not of that family."""
    if mask is None:
        return None
    if mask.dim() == 2 and tuple(mask.shape) == (b, t_k):
        return mask
    if mask.dim() == 4 and tuple(mask.shape) == (b, 1, 1, t_k):
        return mask[:, 0, 0, :]
    return None


def flash_attention_compatible(q, k, v, mask=None, causal: bool = False) -> bool:
    """Whether the kernel takes the call (JAX ``flash_attention.py:100-125``
    without the TPU-only conditions: no tile multiple, no minimum length,
    no platform check): a key-padding mask or none, causal only when
    ``t_q == t_k``, ``d`` and ``d_v`` at most 256, one dtype, float32 or
    bfloat16."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return False
    b, _, t_q, d = q.shape
    t_k = k.shape[2]
    if mask is not None and padding_mask_2d(mask, b, t_k) is None:
        return False
    if causal and t_q != t_k:
        return False
    if d > MAX_HEAD_DIM or v.shape[-1] > MAX_HEAD_DIM:
        return False
    if q.dtype not in _DTYPE_CODES:
        return False
    return k.dtype == q.dtype and v.dtype == q.dtype


def _check(q, k, v, mask, causal) -> None:
    """Raise on anything the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (batch, heads, time, d), got {tuple(t.shape)}")
    b, h, t_q, d = q.shape
    t_k, d_v = k.shape[2], v.shape[3]
    if tuple(k.shape) != (b, h, t_k, d) or tuple(v.shape) != (b, h, t_k, d_v):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "do not share batch, heads, key length and d")
    if min(t_q, t_k, d, d_v) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, v {tuple(v.shape)}")
    if d > MAX_HEAD_DIM or d_v > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes d and d_v up to {MAX_HEAD_DIM}, got {d} and {d_v}")
    if mask is not None and padding_mask_2d(mask, b, t_k) is None:
        raise ValueError(f"flash attention takes key-padding masks (b, t_k) or (b, 1, 1, t_k) "
                         f"only, got {tuple(mask.shape)}")
    if causal and t_q != t_k:
        raise ValueError(f"causal flash attention needs t_q == t_k, got {t_q} and {t_k}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v), ("mask", mask)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if b * h > MAX_GRID_ROWS:
        raise ValueError(f"the kernel takes batch * heads up to {MAX_GRID_ROWS}, got {b * h}")


def key_bias(mask, b: int, t_k: int) -> Optional[torch.Tensor]:
    """The kernel's additive fp32 bias ``(b, t_k)``: 0 where the mask
    attends, :data:`MASK_VALUE` where not; ``None`` without a mask."""
    kmask = padding_mask_2d(mask, b, t_k)
    if kmask is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=kmask.device)
    return torch.where(kmask.bool(), zero, torch.full_like(zero, MASK_VALUE)).contiguous()


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              mask=None, causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: dense fp32 scores from the
    input-dtype operands, the same bias and causal rules (causally excluded
    keys weigh exactly 0), P rounded to the input dtype before ``P @ V``
    and the row sum of the unrounded P. Returns ``(o, lse)``: o
    ``(b, h, t_q, d_v)`` in the input dtype, lse ``(b, h, t_q)`` fp32.
    Differentiable by autograd."""
    b, _, t_q, d = q.shape
    t_k = k.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * (1.0 / math.sqrt(d))
    bias = key_bias(mask, b, t_k)
    if bias is not None:
        s = s + bias.to(ct)[:, None, None, :]
    if causal:
        keep = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-20)
    o = torch.matmul(p.to(q.dtype).to(ct), v.to(ct)) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def flash_attention_backward_reference(q, k, v, o, lse, do, mask=None, causal: bool = False
                                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels (JAX ``_flash_bwd``):
    ``P = exp(S - lse)`` recomputed from the forward's lse with dense fp32
    scores (the same bias and causal rules as the forward), ``delta =
    rowsum(dO * O)`` in fp32 from dO and O as stored, ``dS = P * (dP -
    delta) * scale`` rounded to the input dtype before both of its
    products, P rounded before ``P^T dO``, every product summed in fp32.
    Returns ``(dq, dk, dv)`` in the input dtype. A fully masked row gets
    ``P = 1`` for every key, as in the Pallas kernel (its scores and its
    lse are both -1e30)."""
    b, _, t_q, d = q.shape
    t_k = k.shape[2]
    dt = q.dtype
    ct = torch.promote_types(dt, torch.float32)
    scale = 1.0 / math.sqrt(d)
    qc, kc, vc, doc = (t.to(ct) for t in (q, k, v, do))
    s = torch.matmul(qc, kc.transpose(-1, -2)) * scale
    bias = key_bias(mask, b, t_k)
    if bias is not None:
        s = s + bias.to(ct)[:, None, None, :]
    if causal:
        keep = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - lse.to(ct)[..., None])
    delta = (doc * o.to(ct)).sum(dim=-1, keepdim=True)
    dp = torch.matmul(doc, vc.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(dt).to(ct)
    dq = torch.matmul(ds, kc)
    dk = torch.matmul(ds.transpose(-1, -2), qc)
    dv = torch.matmul(p.to(dt).to(ct).transpose(-1, -2), doc)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def _vector_ok(*tensors) -> bool:
    """Whether the bf16 kernels may stage these operands with 16-byte
    ``cp.async`` copies (their ``VEC`` flag): every base pointer on a
    16-byte boundary, and every stride of an extent above 1 and the width of
    the last dimension (whose stride is 1) whole multiples of 16 bytes, so
    that each row starts on a 16-byte boundary and holds whole 16-byte
    chunks. Otherwise (``d % 8 != 0`` in bf16, a view cut into its buffer)
    the same kernels stage element by element. A function of pointers,
    strides and element size only."""
    for t in tensors:
        size = t.element_size()
        if t.data_ptr() % 16 or (t.shape[-1] * size) % 16:
            return False
        if any(n > 1 and (s * size) % 16 for n, s in zip(t.shape[:-1], t.stride()[:-1])):
            return False
    return True


def _raise_launch(lib, err: int, what: str, q, k, v, causal) -> None:
    msg = lib.dl4j_cuda_error_string(err).decode()
    raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err}) at q {tuple(q.shape)} "
                       f"k {tuple(k.shape)} v {tuple(v.shape)} {q.dtype} causal={bool(causal)}")


def launch_flash_fwd(q, k, v, bias, causal: bool, launches: LaunchCounter,
                     save: bool = False):
    """Launch the kernel on CUDA tensors already checked by :func:`_check`;
    ``bias`` is :func:`key_bias`'s. Returns o, a ``(b, h, t_q, d_v)`` view
    of a ``(b, t_q, h, d_v)`` buffer, and with ``save`` also lse
    ``(b, h, t_q)`` fp32."""
    lib = LIBRARY.load()
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    b, h, t_q, d = q.shape
    t_k, d_v = k.shape[2], v.shape[3]
    o = torch.empty((b, t_q, h, d_v), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device) if save else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dl4j_flash_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, t_q, t_k, d, d_v,
            *_strides(q), *_strides(k), *_strides(v), *_strides(o),
            1.0 / math.sqrt(d), int(bool(causal)), int(_vector_ok(q, k, v, o)), stream)
    if err != 0:
        _raise_launch(lib, err, "flash attention kernel", q, k, v, causal)
    launches.add()
    return (o, lse) if save else o


def grad_buffers(q, k, v):
    """dq, dk and dv as the backward launcher allocates them: ``(b, h, t,
    d)`` views of ``(b, t, h, d)`` buffers in the input dtype, so that the
    merge of the heads that follows costs no copy."""
    b, h, t_q, d = q.shape
    t_k, d_v = k.shape[2], v.shape[3]

    def buffer(t, width):
        return torch.empty((b, t, h, width), dtype=q.dtype, device=q.device).transpose(1, 2)

    return buffer(t_q, d), buffer(t_k, d), buffer(t_k, d_v)


def launch_flash_bwd(q, k, v, o, lse, do, bias, causal: bool):
    """Launch the two backward kernels on CUDA tensors (shapes as
    :func:`_check` takes them; o, lse from the saving forward, dO shaped as
    o; ``bias`` is :func:`key_bias`'s): first the dq kernel, which also
    writes ``delta = rowsum(dO * O)``, then the dk/dv kernel, which reads
    it, on the same stream. The bf16 kernels stage by ``cp.async`` when
    :func:`_vector_ok` holds for all eight operands, dq, dk and dv
    included. Returns dq, dk, dv from :func:`grad_buffers`."""
    lib = BWD_LIBRARY.load()
    q, k, v, o, do = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, o, do))
    lse = lse.contiguous()
    b, h, t_q, d = q.shape
    t_k, d_v = k.shape[2], v.shape[3]
    if tuple(o.shape) != (b, h, t_q, d_v) or tuple(do.shape) != tuple(o.shape) or \
            tuple(lse.shape) != (b, h, t_q) or do.dtype != q.dtype or o.dtype != q.dtype or \
            lse.dtype != torch.float32:
        raise ValueError(f"flash backward: o {tuple(o.shape)} {o.dtype}, dO {tuple(do.shape)} "
                         f"{do.dtype} and lse {tuple(lse.shape)} {lse.dtype} do not fit q "
                         f"{tuple(q.shape)} {q.dtype} and v {tuple(v.shape)}")

    dq, dk, dv = grad_buffers(q, k, v)
    delta = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    operands = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*(x for t in operands for x in _strides(t)))
    bias_ptr = None if bias is None else bias.data_ptr()
    common = (b, h, t_q, t_k, d, d_v, strides, 1.0 / math.sqrt(d), int(bool(causal)),
              int(_vector_ok(*operands)))
    code = _DTYPE_CODES[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dl4j_flash_bwd_dq(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                    do.data_ptr(), lse.data_ptr(), bias_ptr, delta.data_ptr(),
                                    dq.data_ptr(), *common, stream)
        if err != 0:
            _raise_launch(lib, err, "flash attention backward dq kernel", q, k, v, causal)
        bwd_dq_counter.add()
        err = lib.dl4j_flash_bwd_dkv(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     do.data_ptr(), lse.data_ptr(), bias_ptr, delta.data_ptr(),
                                     dk.data_ptr(), dv.data_ptr(), *common, stream)
        if err != 0:
            _raise_launch(lib, err, "flash attention backward dk/dv kernel", q, k, v, causal)
        bwd_dkv_counter.add()
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention under autograd (JAX ``_flash`` with its custom VJP,
    ``:678-697``). Forward: the saving instance of the forward kernel on
    CUDA tensors, :func:`flash_attention_reference` on CPU tensors; returns
    ``(o, lse)`` with lse not differentiable. Backward: the two backward
    kernels on CUDA tensors, :func:`flash_attention_backward_reference` on
    CPU tensors. The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        bias = None
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, mask, causal)
        else:
            bias = key_bias(mask, q.shape[0], k.shape[2])
            o, lse = launch_flash_fwd(q, k, v, bias, causal, lse_counter, save=True)
        ctx.save_for_backward(q, k, v, o, lse, mask, bias)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, mask, bias = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_backward_reference(q, k, v, o, lse, do, mask,
                                                            ctx.causal)
        else:
            dq, dk, dv = launch_flash_bwd(q, k, v, o, lse, do, bias, ctx.causal)
        return dq, dk, dv, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _run(q, k, v, mask, causal: bool, save: bool):
    _check(q, k, v, mask, causal)
    if _needs_grad(q, k, v):
        o, lse = FlashAttentionFunction.apply(q, k, v, mask, causal)
    elif q.device.type == "cpu":
        o, lse = flash_attention_reference(q, k, v, mask, causal)
    else:
        bias = key_bias(mask, q.shape[0], k.shape[2])
        return launch_flash_fwd(q, k, v, bias, causal, lse_counter if save else counter, save)
    return (o, lse) if save else o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask=None,
                    causal: bool = False) -> torch.Tensor:
    """``(batch, heads, time, d)`` flash attention (JAX ``:700-717``).
    ``mask`` is a key-padding mask ``(b, t_k)`` or ``(b, 1, 1, t_k)``
    (true = attend); ``causal`` applies the top-left triangle. CUDA tensors
    launch the kernels (or the call raises); CPU tensors take the plain
    versions. Differentiable in q, k and v."""
    return _run(q, k, v, mask, causal, save=False)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask=None,
                        causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` that also returns the per-row logsumexp
    ``(b, h, t_q)`` fp32 (JAX ``_flash_fwd(save_residuals=True)``, whose
    lane-broadcast ``(b*h, t_q, 8)`` residual this keeps as one value per
    row): the saving instance of the kernel."""
    return _run(q, k, v, mask, causal, save=True)
