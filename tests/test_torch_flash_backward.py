"""The port's flash-attention backward against the JAX package, on the CPU.

The autograd Function the port's attention runs under training
(:class:`FlashAttentionFunction`: the plain forward, then
:func:`flash_attention_backward_reference`, which the backward kernels
repeat) is held against ``jax.vjp`` of the JAX package's ``flash_attention``
with its Pallas kernels in interpret mode (``DL4J_TPU_PALLAS_INTERPRET=1``;
the kernels need ``t % 128`` there, so T is 128 or 256), unmasked, with a
key-padding mask that holds a fully masked row and a row of one key, and
causal. A fully masked row gets the Pallas kernel's gradient (P = 1 for
every key: its scores and its lse are both -1e30), not the dense softmax's.

Tolerances, as a bound on ``max |port - jax|`` over ``max(1, max |jax|)``:
float32 ``1e-5`` (both sides sum the same fp32 products in other orders;
a fully masked row's dk and dv sum up to 256 unit-weighted rows, which is
why the error is held relative to the largest gradient); bfloat16 two bf16
ulps of the largest gradient, ``2 * 2^-8`` (both round dS and P to bf16
before their products and round dq, dk, dv to bf16; a score summed in
another order can break one rounding tie the other way, and an fp32 sum a
few ulps apart can round to a neighbouring bf16 value).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from deeplearning4j_tpu.ops.pallas import flash_attention as jfa
from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa

B, H = 3, 2
TOL = {"float32": 1e-5, "bfloat16": 2 * 2.0 ** -8}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")


def _arrays(t_q, t_k, d, seed, d_v=None, batch=B):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, H, t_q, d)).astype(np.float32)
    k = rng.standard_normal((batch, H, t_k, d)).astype(np.float32)
    v = rng.standard_normal((batch, H, t_k, d_v or d)).astype(np.float32)
    do = rng.standard_normal((batch, H, t_q, d_v or d)).astype(np.float32)
    return q, k, v, do


def _padding_mask(t_k, seed):
    """Batch 0 fully masked, batch 1 attends one key, batch 2 a random two
    thirds of the keys."""
    m = np.ones((B, t_k), bool)
    m[0] = False
    m[1, 1:] = False
    m[2, np.random.default_rng(seed).permutation(t_k)[: t_k // 3]] = False
    return m


def _jax_grads(q, k, v, do, mask, causal, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, jmask, causal=causal),
                     *(jnp.asarray(x, jdt) for x in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, jdt))]


def _port_grads(q, k, v, do, mask, causal, dtype):
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, None if mask is None else torch.from_numpy(mask),
                             causal=causal)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(tdt))
    assert all(g.dtype == tdt for g in grads)
    return [g.float().numpy() for g in grads]


def _assert_close(got, want, tol, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert np.isfinite(g).all() and err <= tol * scale, \
            f"{what} {name}: max abs err {err:.3g} > {tol:g} x {scale:.3g}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", [(128, 64), (256, 128)], ids=["t128_d64", "t256_d128"])
@pytest.mark.parametrize("case", ["unmasked", "padding_mask", "causal"])
def test_backward_matches_jax_vjp_of_the_pallas_kernel(case, t, d, dtype):
    q, k, v, do = _arrays(t, t, d, seed=t + d)
    mask = _padding_mask(t, seed=d) if case == "padding_mask" else None
    causal = case == "causal"
    want = _jax_grads(q, k, v, do, mask, causal, dtype)
    got = _port_grads(q, k, v, do, mask, causal, dtype)
    _assert_close(got, want, TOL[dtype], f"{case} T={t} d={d} {dtype}")


def test_fully_masked_row_takes_the_pallas_kernels_gradient():
    """Every key of a fully masked row weighs P = 1 in the backward: dv of
    each key gets the row's whole dO, where the dense softmax gives it
    1/t_k of it."""
    q, k, v, do = _arrays(5, 7, 4, seed=1, batch=1)
    mask = torch.zeros(1, 7, dtype=torch.bool)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, mask)
    _, _, dv = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    want = torch.from_numpy(do).sum(dim=2, keepdim=True).expand(1, H, 7, 4)
    torch.testing.assert_close(dv, want, rtol=1e-6, atol=1e-6)


def test_backward_reference_is_the_plain_version_of_the_function():
    """The plain backward, called on the forward's o and lse, is what the
    autograd Function returns on the CPU, in float32 and bfloat16."""
    q, k, v, do = _arrays(9, 9, 8, seed=2)
    mask = torch.from_numpy(_padding_mask(9, seed=3))
    for dtype in (torch.float32, torch.bfloat16):
        args = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
        o, lse = fa.flash_attention_reference(*args, mask, True)
        want = fa.flash_attention_backward_reference(*args, o, lse,
                                                     torch.from_numpy(do).to(dtype), mask, True)
        leaves = [a.clone().requires_grad_() for a in args]
        got = torch.autograd.grad(fa.flash_attention(*leaves, mask, causal=True), leaves,
                                  torch.from_numpy(do).to(dtype))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_bfloat16_rounds_ds_and_p_before_their_products():
    """dS = P (dP - delta) scale is rounded to bf16 before dS K and dS^T Q,
    and P before P^T dO; the sums are fp32."""
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in _arrays(6, 10, 8, seed=4))
    o, lse = fa.flash_attention_reference(q, k, v)
    dq, dk, dv = fa.flash_attention_backward_reference(q, k, v, o, lse, do)
    f = [x.float() for x in (q, k, v, o, do)]
    s = f[0] @ f[1].transpose(-1, -2) / 8 ** 0.5
    p = torch.exp(s - lse[..., None])
    delta = (f[4] * f[3]).sum(-1, keepdim=True)
    ds = (p * (f[4] @ f[2].transpose(-1, -2) - delta) / 8 ** 0.5).bfloat16().float()
    torch.testing.assert_close(dq, (ds @ f[1]).bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(dk, (ds.transpose(-1, -2) @ f[0]).bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(dv, (p.bfloat16().float().transpose(-1, -2) @ f[4]).bfloat16(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "padding_mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_gradcheck_float64(masked, causal):
    q, k, v, _ = _arrays(7, 7, 5, seed=5, batch=2)
    leaves = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v)]
    mask = None
    if masked:  # every row keeps a key: the dense softmax's gradient holds
        mask = torch.ones(2, 7, dtype=torch.bool)
        mask[1, 3:] = False
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, mask, causal=causal), leaves)


SHAPES = {  # (t_q, t_k, d, d_v)
    "ragged": (77, 77, 16, 16),
    "cross_attention": (5, 33, 8, 8),
    "value_width_differs": (9, 12, 6, 20),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_function_matches_autograd_of_the_dense_reference(name):
    t_q, t_k, d, d_v = SHAPES[name]
    q, k, v, do = _arrays(t_q, t_k, d, seed=t_q + t_k, d_v=d_v)
    mask = torch.ones(B, t_k, dtype=torch.bool)
    mask[1, t_k // 2:] = False
    grads = []
    for run in (lambda *a: fa.flash_attention(*a, mask),
                lambda *a: fa.flash_attention_reference(*a, mask)[0]):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        grads.append(torch.autograd.grad(run(*leaves), leaves, torch.from_numpy(do)))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_inference_mode_takes_no_autograd_path():
    """Under no_grad/inference_mode the call returns a tensor with no graph
    (serving launches the inference instance on the card)."""
    q, k, v, _ = (torch.from_numpy(x).requires_grad_() for x in _arrays(4, 4, 4, seed=6))
    with torch.inference_mode():
        out = fa.flash_attention(q, k, v)
    assert out.grad_fn is None
    assert fa.flash_attention(q, k, v).grad_fn is not None


def _buffer_view(shape, offset=0):
    """A bf16 tensor of ``shape`` that starts ``offset`` elements into a
    buffer the allocator aligned."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(shape)


def _btd_heads(b, t, h, d):
    """The (b, h, t, d) view of a (b, t, h*d) tensor, as the attention
    layers hand it to the kernels."""
    return torch.zeros(b, t, h * d, dtype=torch.bfloat16).view(b, t, h, d).transpose(1, 2)


BWD_VECTOR_CASES = {
    # name: (a function making q, k, v and dO, whether the bf16 backward stages with cp.async)
    "contiguous_d64": (lambda: [_buffer_view((2, 3, 7, 64)) for _ in range(4)], True),
    "btd_views_d64": (lambda: [_btd_heads(2, 7, 12, 64) for _ in range(4)], True),
    "d64_dv24": (lambda: [_buffer_view((2, 3, 7, 64)), _buffer_view((2, 3, 9, 64)),
                          _buffer_view((2, 3, 9, 24)), _buffer_view((2, 3, 7, 24))], True),
    "d33": (lambda: [_buffer_view((2, 3, 7, 33)) for _ in range(4)], False),
    "offset_view_of_do": (lambda: [*(_buffer_view((2, 3, 7, 64)) for _ in range(3)),
                                   _buffer_view((2, 3, 7, 64), offset=1)], False),
}


@pytest.mark.parametrize("name", sorted(BWD_VECTOR_CASES))
def test_backward_vector_staging_covers_all_eight_operands(name):
    """The backward launcher's choice of the bf16 kernels' staging, over q,
    k, v, o, dO and the dq, dk, dv buffers it allocates: cp.async where
    every row of all eight starts on a 16-byte boundary and holds whole
    16-byte chunks, element by element otherwise. A function of pointers,
    strides and the element size, so CPU tensors reach it."""
    build, want = BWD_VECTOR_CASES[name]
    q, k, v, do = build()
    b, h, t_q, _ = q.shape
    d_v = v.shape[-1]
    # o, as the forward launcher allocates it: (b, t_q, h, d_v) seen as (b, h, t_q, d_v)
    o = torch.empty((b, t_q, h, d_v), dtype=q.dtype).transpose(1, 2)
    grads = fa.grad_buffers(q, k, v)
    for g, x in zip(grads, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert g.transpose(1, 2).is_contiguous()  # a (b, t, h, d) buffer
    assert fa._vector_ok(q, k, v, o, do, *grads) is want
