"""Multi-head attention for short sequences (t <= 512), forward and backward,
as CUDA kernels for Hopper.

.. deprecated::
   The JAX package keeps ``fused_attention_short.py`` only as a measured
   negative result: on its TPU the kernel never beat XLA's softmax path in
   a model, so no layer routes to it (``nn/attention_layers.py:49-59``).
   Those reasons are TPU measurements and carry no number here. The port
   keeps the same contract: nothing routes to this module either, and
   attention layers go through ``dot_product_attention``. Its entry points
   are public for callers that ask for them by name, as the JAX package's
   benchmark does (``bench.py:572-607``).

Counterpart of ``deeplearning4j_tpu/ops/pallas/fused_attention_short.py``:
rows 11 (``_short_fwd``, the ``pallas_call`` at :169, and ``_short_bwd_vjp``
at :197, on ``(b, h, t, d)``) and 12 (``_btd_fwd`` :320 and ``_btd_bwd_vjp``
:353, on ``(b, t, h*d)`` with the heads split inside the kernel) become the
kernels of ``csrc/short_attention.cu``: one forward and one backward (a dq
kernel, then a dk/dv kernel), which read and write through strides and so
take both layouts. ``short_attention_btd`` launches them on the ``(b, t, h,
d)`` view of its operands and writes ``(b, t, h*d)`` outputs directly: no
transpose, no copy.

What it computes, as the Pallas kernels (``_fwd_kernel`` :67, ``_bwd_kernel``
:79): scores ``(q . k) * scale`` in fp32, plus the fp32 key bias ``0 /
-1e30`` from a ``(b, t)`` or ``(b, 1, 1, t)`` mask (true = attend; masked
keys are not skipped, so a fully masked row gives the mean of V); the exact
softmax over the whole row; ``o = round(P) @ V``. The backward recomputes P
and saves nothing of the forward: ``dv = round(P)^T dO``, ``dp = dO V^T``,
``ds = round(P * (dp - rowsum(dp * P)) * scale)`` (the Pallas delta, not
flash's ``rowsum(dO * O)``), ``dq = ds K``, ``dk = ds^T Q``. Round means to
the input dtype; sums are fp32; outputs are in the input dtype. Not causal;
``t_q == t_k <= MAX_SEQ``; ``d <= 256``; float32 or bfloat16 on the card.

CUDA tensors launch the kernels (or the call raises); only CPU tensors take
the plain versions, :func:`short_attention_reference` and
:func:`short_attention_backward_reference`. A call that autograd records goes
through :class:`ShortAttentionFunction`, which saves q, k, v and the mask.
The bf16 kernels run on the tensor cores and, like flash attention's, stage
with 16-byte ``cp.async`` copies only where :func:`_vector_ok` says every
row of their operands starts on a 16-byte boundary: the forward over q, k,
v and o, the backward over q, k, v, dO and the dq, dk, dv buffers it
allocates. The backward is a pair chosen by dtype and width alone: bf16
with ``d <= 128`` takes ``short_bwd_dq_kernel_mma`` (the exact softmax of
each row with K and V resident at ``t <= 128``, in three passes over key
tiles beyond; it writes each row's max, sum and delta to fp32 scratch) and
then ``short_bwd_dkv_kernel_mma``, which recomputes the transposed scores
with the same products in the same order and so gets the same P and dS bit
for bit; float32 and wider bf16 heads take the CUDA-core pair. See
``csrc/short_attention.cu`` for the design and its times on an H100.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops.kernels._native import (LaunchCounter,
                                                          NativeLibrary,
                                                          register_library)
# The key bias (0 / MASK_VALUE = -1e30 from a (b, t) or (b, 1, 1, t) mask) is
# the flash kernels' (JAX ``_bias_from_mask`` builds the same one).
# So is the choice of the bf16 forward's staging (``_vector_ok``).
from deeplearning4j_tpu_torch.ops.kernels.flash_attention import (  # noqa: F401
    MASK_VALUE, _vector_ok, key_bias, padding_mask_2d)

MAX_SEQ = 512
MAX_HEAD_DIM = 256
MAX_GRID_ROWS = 65535  # batch * heads: the y extent of the CUDA-core kernels' grids

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

counter = LaunchCounter("short_attention")  # (b, h, t, d) forward
bwd_counter = LaunchCounter("short_attention_bwd")  # its backward (dq, then dk/dv kernel)
btd_counter = LaunchCounter("short_attention_btd")  # (b, t, h*d) forward
btd_bwd_counter = LaunchCounter("short_attention_btd_bwd")


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (dtype, q, k, v, bias, o, B, H, T, D, strides, scale, vec, stream)
    lib.dl4j_short_attention_fwd.argtypes = [i, p, p, p, p, p, i, i, i, i, p, f, i, p]
    lib.dl4j_short_attention_fwd.restype = i
    # (dtype, q, k, v, dO, bias, dq, dk, dv, m, l, delta, B, H, T, D, strides, scale, vec,
    #  stream)
    lib.dl4j_short_attention_bwd.argtypes = [i, *([p] * 11), i, i, i, i, p, f, i, p]
    lib.dl4j_short_attention_bwd.restype = i
    lib.dl4j_cuda_error_string.argtypes = [i]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p


LIBRARY = register_library(NativeLibrary("short_attention.cu", _declare))


def _semantic_ok(b: int, t_q: int, t_k: int, mask, causal: bool) -> bool:
    if causal or t_q != t_k or not 1 <= t_q <= MAX_SEQ:
        return False
    return mask is None or padding_mask_2d(mask, b, t_k) is not None


def short_attention_compatible(q, k, v, mask=None, causal: bool = False) -> bool:
    """Whether the kernels take ``(b, h, t, d)`` self-attention (JAX
    ``short_attention_compatible`` without the TPU's conditions: no tile
    multiple of t or d, no VMEM budget): not causal, one shape for q, k and
    v with ``t <= MAX_SEQ`` and ``d <= 256``, a ``(b, t)`` or ``(b, 1, 1,
    t)`` mask, one dtype, float32 or bfloat16."""
    if q.dim() != 4 or tuple(q.shape) != tuple(k.shape) or tuple(k.shape) != tuple(v.shape):
        return False
    b, _, t, d = q.shape
    if not _semantic_ok(b, t, k.shape[2], mask, causal) or not 1 <= d <= MAX_HEAD_DIM:
        return False
    return q.dtype in _DTYPE_CODES and k.dtype == q.dtype and v.dtype == q.dtype


def short_attention_btd_compatible(q, mask=None, heads: int = 0, causal: bool = False) -> bool:
    """The same for ``(b, t, heads * d)`` (JAX
    ``short_attention_btd_compatible`` without the TPU's conditions)."""
    if q.dim() != 3 or heads <= 0 or q.shape[2] % heads:
        return False
    b, t, hd = q.shape
    if not _semantic_ok(b, t, t, mask, causal) or not 1 <= hd // heads <= MAX_HEAD_DIM:
        return False
    return q.dtype in _DTYPE_CODES


def _check(q, k, v, mask) -> None:
    """Raise on anything the kernels do not take; q, k, v are ``(b, h, t,
    d)`` (the btd entry point checks its views)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4:
            raise ValueError(f"{name} must be (batch, heads, time, d), got {tuple(x.shape)}")
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"short attention takes q, k, v of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, d = q.shape
    if not 1 <= t <= MAX_SEQ:
        raise ValueError(f"short attention takes 1 <= t <= {MAX_SEQ}, got {t}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"short attention takes 1 <= d <= {MAX_HEAD_DIM}, got {d}")
    if mask is not None and padding_mask_2d(mask, b, t) is None:
        raise ValueError(f"short attention takes key masks (b, t) or (b, 1, 1, t) only, "
                         f"got {tuple(mask.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("k", k), ("v", v), ("mask", mask)):
        if x is not None and x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, expected {q.device}")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"short attention runs on CUDA or CPU tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernels take float32 or bfloat16, got {q.dtype}")
    if b * h > MAX_GRID_ROWS:
        raise ValueError(f"the kernels take batch * heads up to {MAX_GRID_ROWS}, got {b * h}")


def _scale(d: int, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else float(d) ** -0.5


def _probs(q, k, mask, scale):
    """fp32 scores plus bias and their exact row softmax."""
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * scale
    bias = key_bias(mask, q.shape[0], k.shape[2])
    if bias is not None:
        s = s + bias.to(ct)[:, None, None, :]
    return torch.softmax(s, dim=-1), ct


def short_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask=None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel on ``(b, h, t, d)``
    (Pallas ``_fwd_kernel``): P rounded to v's dtype before ``P @ V``, fp32
    sums, output in the input dtype. Differentiable by autograd."""
    p, ct = _probs(q, k, mask, _scale(q.shape[-1], scale))
    return torch.matmul(p.to(v.dtype).to(ct), v.to(ct)).to(q.dtype)


def short_attention_backward_reference(q, k, v, do, mask=None, scale: Optional[float] = None
                                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels (Pallas
    ``_bwd_kernel``): P recomputed, ``dv = round(P)^T dO``, ``dp = dO V^T``,
    ``ds = round(P * (dp - rowsum(dp * P)) * scale)``, ``dq = ds K``,
    ``dk = ds^T Q``, fp32 sums. Returns ``(dq, dk, dv)`` in the input dtype."""
    dt = q.dtype
    sc = _scale(q.shape[-1], scale)
    p, ct = _probs(q, k, mask, sc)
    qc, kc, vc, doc = (x.to(ct) for x in (q, k, v, do))
    dv = torch.matmul(p.to(do.dtype).to(ct).transpose(-1, -2), doc)
    dp = torch.matmul(doc, vc.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * sc).to(dt).to(ct)
    dq = torch.matmul(ds, kc)
    dk = torch.matmul(ds.transpose(-1, -2), qc)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _strides(x: torch.Tensor):
    return x.stride(0), x.stride(1), x.stride(2)


def _unit_last(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _raise_launch(lib, err: int, what: str, q) -> None:
    msg = lib.dl4j_cuda_error_string(err).decode()
    raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err}) at q {tuple(q.shape)} "
                       f"{q.dtype}")


def _buffers(q: torch.Tensor, btd: bool, n: int):
    """``n`` output tensors for ``(b, h, t, d)`` q: contiguous, or ``(b, h,
    t, d)`` views of ``(b, t, h, d)`` buffers for the btd layout."""
    b, h, t, d = q.shape
    if btd:
        return [torch.empty((b, t, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
                for _ in range(n)]
    return [torch.empty((b, h, t, d), dtype=q.dtype, device=q.device) for _ in range(n)]


def launch_short_fwd(q, k, v, bias, scale: float, launches: LaunchCounter, btd: bool = False):
    """Launch the forward kernel on ``(b, h, t, d)`` CUDA tensors (or views)
    checked by :func:`_check`; ``bias`` is :func:`key_bias`'s. Returns o
    ``(b, h, t, d)``, a view of a ``(b, t, h, d)`` buffer when ``btd``."""
    lib = LIBRARY.load()
    q, k, v = (_unit_last(x) for x in (q, k, v))
    b, h, t, d = q.shape
    (o,) = _buffers(q, btd, 1)
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, o) for s in _strides(x)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dl4j_short_attention_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), o.data_ptr(), b, h, t, d, strides,
            scale, int(_vector_ok(q, k, v, o)), stream)
    if err != 0:
        _raise_launch(lib, err, "short attention kernel", q)
    launches.add()
    return o


def launch_short_bwd(q, k, v, do, bias, scale: float, launches: LaunchCounter,
                     btd: bool = False):
    """Launch the backward pair (the dq kernel, which writes each row's m,
    l and delta, then the dk/dv kernel, which reads them, on one stream; one
    count on ``launches``) on ``(b, h, t, d)`` CUDA tensors; dO shaped as q.
    The bf16 pair stages by ``cp.async`` when :func:`_vector_ok` holds for
    all seven operands, the dq, dk and dv buffers it allocates included.
    Returns dq, dk, dv, views of ``(b, t, h, d)`` buffers when ``btd``."""
    lib = LIBRARY.load()
    q, k, v, do = (_unit_last(x) for x in (q, k, v, do))
    if tuple(do.shape) != tuple(q.shape) or do.dtype != q.dtype:
        raise ValueError(f"short attention backward: dO {tuple(do.shape)} {do.dtype} does not "
                         f"fit q {tuple(q.shape)} {q.dtype}")
    b, h, t, d = q.shape
    dq, dk, dv = _buffers(q, btd, 3)
    m, l, delta = torch.empty((3, b * h, t), dtype=torch.float32, device=q.device)
    operands = (q, k, v, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 21)(*(s for x in operands for s in _strides(x)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dl4j_short_attention_bwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            None if bias is None else bias.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(), b, h, t, d, strides,
            scale, int(_vector_ok(*operands)), stream)
    if err != 0:
        _raise_launch(lib, err, "short attention backward kernels", q)
    launches.add()
    return dq, dk, dv


def _forward(q, k, v, mask, scale: float, btd: bool):
    if q.device.type == "cpu":
        return short_attention_reference(q, k, v, mask, scale)
    return launch_short_fwd(q, k, v, key_bias(mask, q.shape[0], q.shape[2]), scale,
                            btd_counter if btd else counter, btd)


def _backward(q, k, v, do, mask, scale: float, btd: bool):
    if q.device.type == "cpu":
        return short_attention_backward_reference(q, k, v, do, mask, scale)
    return launch_short_bwd(q, k, v, do, key_bias(mask, q.shape[0], q.shape[2]), scale,
                            btd_bwd_counter if btd else bwd_counter, btd)


class ShortAttentionFunction(torch.autograd.Function):
    """Short attention under autograd (JAX ``short_attention`` /
    ``short_attention_btd`` with their custom VJPs) on ``(b, h, t, d)``
    tensors or views. Saves q, k, v and the mask, nothing else. Forward and
    backward launch the kernels on CUDA tensors (counted on the btd counters
    when ``btd``) and run the plain versions on CPU tensors. The mask gets
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, btd):
        ctx.save_for_backward(q, k, v, mask)
        ctx.scale, ctx.btd = scale, btd
        return _forward(q, k, v, mask, scale, btd)

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask = ctx.saved_tensors
        return (*_backward(q, k, v, do, mask, ctx.scale, ctx.btd), None, None, None)


def _run(q, k, v, mask, scale: float, btd: bool):
    _check(q, k, v, mask)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return ShortAttentionFunction.apply(q, k, v, mask, scale, btd)
    return _forward(q, k, v, mask, scale, btd)


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask=None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``softmax(q k^T * scale + bias) v`` on ``(b, h, t, d)``, t <= MAX_SEQ
    (JAX ``short_attention``); ``scale`` defaults to ``d ** -0.5``, ``mask``
    is ``(b, t)`` or ``(b, 1, 1, t)`` (true = attend). Differentiable in q,
    k and v."""
    return _run(q, k, v, mask, _scale(q.shape[-1], scale), btd=False)


def short_attention_btd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask=None,
                        heads: int = 12, scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention on ``(b, t, heads * d)`` (JAX
    ``short_attention_btd``): the kernels read the ``(b, t, h, d)`` views
    and write ``(b, t, h * d)`` outputs, with no transpose and no copy."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 3 or tuple(x.shape) != tuple(q.shape):
            raise ValueError(f"{name} must be (batch, time, heads * d) shaped as q, "
                             f"got {tuple(x.shape)}")
    b, t, hd = q.shape
    if heads <= 0 or hd % heads:
        raise ValueError(f"{hd} features do not split into {heads} heads")
    d = hd // heads
    q4, k4, v4 = (x.reshape(b, t, heads, d).transpose(1, 2) for x in (q, k, v))
    o4 = _run(q4, k4, v4, mask, _scale(d, scale), btd=True)
    return o4.transpose(1, 2).reshape(b, t, hd)
