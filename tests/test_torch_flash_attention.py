"""The port's flash attention against the JAX package, on the CPU.

The plain version (:func:`flash_attention_reference`, which the wrapper runs
for CPU tensors) is held against the JAX package's Pallas kernel run in
interpret mode (``DL4J_TPU_PALLAS_INTERPRET=1``, as ``tests/test_pallas.py``
runs it): the output of ``flash_attention`` and the logsumexp residual of
``_flash_fwd(save_residuals=True)``. The JAX kernel needs ``t % 128`` there,
so T is 128 or 256. ``dot_product_attention``'s routing is held against the
JAX package's einsum form.

Float32 throughout. Tolerance ``atol=rtol=1e-5``: both sides take fp32
scores from the same fp32 operands; they differ only in summation order
(one 128- or 256-key tile against a dense softmax).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from deeplearning4j_tpu.nn import attention_layers as jattn
from deeplearning4j_tpu.ops.pallas import flash_attention as jfa
from deeplearning4j_tpu_torch.nn.attention_layers import dot_product_attention
from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa

TOL = 1e-5
B, H = 2, 2


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")


def _qkv(t_q, t_k, d, seed, d_v=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, t_q, d)).astype(np.float32)
    k = rng.standard_normal((B, H, t_k, d)).astype(np.float32)
    v = rng.standard_normal((B, H, t_k, d_v or d)).astype(np.float32)
    return q, k, v


def _padding_mask(t_k, seed):
    """Key-padding mask with a fully masked row (batch 0) and a row of
    random lengths' keys (batch 1)."""
    m = np.ones((B, t_k), bool)
    m[0] = False
    m[1, np.random.default_rng(seed).permutation(t_k)[: t_k // 3]] = False
    return m


def _jax_flash(q, k, v, mask, causal):
    """JAX ``flash_attention`` and the ``lse`` of ``_flash_fwd``."""
    o = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       None if mask is None else jnp.asarray(mask),
                                       causal=causal))
    t_k = k.shape[2]
    if mask is None:
        bias = jnp.zeros((B, t_k, 1), jnp.float32)
    else:
        bias = jnp.where(jnp.asarray(mask), 0.0, jfa.MASK_VALUE).astype(jnp.float32)[:, :, None]
    _, lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias,
                            1.0 / float(q.shape[-1]) ** 0.5, causal, mask is not None,
                            save_residuals=True)
    return o, np.asarray(lse)[..., 0].reshape(B, H, q.shape[2])


CASES = ["plain", "padding_mask", "causal", "cross"]


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_jax_kernel(case, t, d):
    t_k = {"cross": 384 - t}.get(case, t)  # 128 <-> 256 for cross attention
    q, k, v = _qkv(t, t_k, d, seed=t + d)
    mask = _padding_mask(t_k, seed=d) if case == "padding_mask" else None
    causal = case == "causal"
    want_o, want_lse = _jax_flash(q, k, v, mask, causal)
    tq = [torch.from_numpy(a) for a in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = fa.flash_attention_reference(*tq, tmask, causal)
    np.testing.assert_allclose(o.numpy(), want_o, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=TOL, atol=TOL)
    # the wrapper takes the plain version for CPU tensors, both instances
    np.testing.assert_array_equal(fa.flash_attention(*tq, tmask, causal=causal).numpy(),
                                  o.numpy())
    o2, lse2 = fa.flash_attention_lse(*tq, tmask, causal=causal)
    np.testing.assert_array_equal(o2.numpy(), o.numpy())
    np.testing.assert_array_equal(lse2.numpy(), lse.numpy())


def test_fully_masked_row_gives_mean_of_v_and_4d_mask_equals_2d():
    q, k, v = _qkv(5, 7, 8, seed=3)
    mask = torch.ones(B, 7, dtype=torch.bool)
    mask[0] = False
    mask[1, 0] = False
    args = [torch.from_numpy(a) for a in (q, k, v)]
    o = fa.flash_attention(*args, mask)
    want = torch.from_numpy(v[0]).mean(dim=1, keepdim=True).expand(H, 5, 8)
    torch.testing.assert_close(o[0], want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(fa.flash_attention(*args, mask[:, None, None, :]), o,
                               rtol=0, atol=0)


def test_ragged_lengths_and_different_value_width():
    """Any t_q, t_k >= 1 and d_v != d: held against the dense softmax."""
    q, k, v = _qkv(3, 77, 16, seed=4, d_v=40)
    mask = torch.from_numpy(_padding_mask(77, seed=5))
    mask[0] = True
    args = [torch.from_numpy(a).double() for a in (q, k, v)]
    o, lse = fa.flash_attention_reference(*args, mask)
    s = args[0] @ args[1].transpose(-1, -2) / 4.0
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    torch.testing.assert_close(o, torch.softmax(s, -1) @ args[2])
    torch.testing.assert_close(lse, torch.logsumexp(s, -1))


def test_bfloat16_rounds_p_before_the_value_product():
    """bf16 operands: scores and statistics in fp32, P rounded to bf16
    before ``P @ V``, the output rounded to bf16."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(9, 11, 8, seed=6))
    o, lse = fa.flash_attention_reference(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    s = q.float() @ k.float().transpose(-1, -2) * (1.0 / 8 ** 0.5)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = (p.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)
    torch.testing.assert_close(o, want.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6, atol=1e-6)


def test_cpu_gradients_flow_through_the_plain_version():
    q, k, v = (torch.from_numpy(a).double().requires_grad_() for a in _qkv(6, 6, 4, seed=7))
    mask = torch.ones(B, 6, dtype=torch.bool)
    mask[1, 4:] = False
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, mask, causal=True), (q, k, v))


def _jax_dpa(q, k, v, mask, causal, use_flash):
    return np.asarray(jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), use_flash=use_flash, causal=causal))


ROUTES = {
    # name: (t_q, t_k, mask kind, causal, port goes to the kernel)
    "key_padding_2d": (12, 12, "2d", False, True),
    "key_padding_4d": (12, 12, "4d", False, True),
    "causal": (12, 12, None, True, True),
    "general_4d_mask": (12, 12, "general", False, False),
    "decode_causal_bottom_right": (4, 12, None, True, False),
}


@pytest.mark.parametrize("use_flash", [True, False], ids=["use_flash", "einsum"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_dot_product_attention_routing_matches_jax_einsum_form(monkeypatch, route, use_flash):
    """JAX off interpret mode takes its einsum form on the CPU; the port
    takes the kernel's plain version wherever the kernel applies, and the
    einsum form elsewhere. Both agree with JAX."""
    monkeypatch.delenv("DL4J_TPU_PALLAS_INTERPRET")
    t_q, t_k, kind, causal, routed = ROUTES[route]
    q, k, v = _qkv(t_q, t_k, 8, seed=t_q + t_k)
    rng = np.random.default_rng(8)
    mask = {None: None,
            "2d": _padding_mask(t_k, 9),
            "4d": _padding_mask(t_k, 9)[:, None, None, :],
            "general": rng.random((B, 1, t_q, t_k)) > 0.3}[kind]
    if mask is not None:
        mask[..., 0] = True  # every row attends a key: -1e9 and -1e30 agree
    calls = []
    real = fa.flash_attention_reference
    monkeypatch.setattr(fa, "flash_attention_reference",
                        lambda *a: calls.append(1) or real(*a))
    got = dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                None if mask is None else torch.from_numpy(mask),
                                use_flash=use_flash, causal=causal).numpy()
    np.testing.assert_allclose(got, _jax_dpa(q, k, v, mask, causal, use_flash=False),
                               rtol=TOL, atol=TOL)
    assert bool(calls) == (routed and use_flash)


COMPATIBLE = {
    "no_mask": ((2, 3, 5, 8), (2, 3, 7, 8), (2, 3, 7, 8), None, False, True),
    "short_and_ragged": ((1, 1, 1, 1), (1, 1, 3, 1), (1, 1, 3, 2), None, False, True),
    "key_padding": ((2, 3, 5, 8), (2, 3, 7, 8), (2, 3, 7, 8), (2, 7), False, True),
    "causal_square": ((2, 3, 7, 8), (2, 3, 7, 8), (2, 3, 7, 8), None, True, True),
    "causal_cross": ((2, 3, 5, 8), (2, 3, 7, 8), (2, 3, 7, 8), None, True, False),
    "general_mask": ((2, 3, 5, 8), (2, 3, 7, 8), (2, 3, 7, 8), (2, 1, 5, 7), False, False),
    "head_dim_256": ((1, 1, 4, 256), (1, 1, 4, 256), (1, 1, 4, 256), None, False, True),
    "head_dim_257": ((1, 1, 4, 257), (1, 1, 4, 257), (1, 1, 4, 8), None, False, False),
    "value_dim_257": ((1, 1, 4, 8), (1, 1, 4, 8), (1, 1, 4, 257), None, False, False),
    "three_d": ((2, 5, 8), (2, 7, 8), (2, 7, 8), None, False, False),
}


@pytest.mark.parametrize("name", sorted(COMPATIBLE))
def test_kernel_takes_what_the_jax_kernel_takes_without_tpu_limits(name):
    qs, ks, vs, ms, causal, want = COMPATIBLE[name]
    mask = None if ms is None else torch.ones(ms, dtype=torch.bool)
    got = fa.flash_attention_compatible(torch.zeros(qs), torch.zeros(ks), torch.zeros(vs),
                                        mask, causal=causal)
    assert got is want


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_dtypes_are_not_routed_to_the_kernel(dtype):
    q = torch.zeros(1, 1, 4, 8, dtype=dtype)
    assert not fa.flash_attention_compatible(q, q, q)
    assert not fa.flash_attention_compatible(q.float(), q.float(), q)


@pytest.mark.parametrize("bad", ["general_mask", "causal_cross", "dtype_mix", "shapes"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    q = torch.zeros(2, 3, 5, 8)
    k = torch.zeros(2, 3, 7, 8)
    kwargs = {"general_mask": {"mask": torch.ones(2, 1, 5, 7, dtype=torch.bool)},
              "causal_cross": {"causal": True}}.get(bad, {})
    v = {"dtype_mix": k.bfloat16(), "shapes": torch.zeros(2, 2, 7, 8)}.get(bad, k)
    with pytest.raises(TypeError if bad == "dtype_mix" else ValueError):
        fa.flash_attention(q, k, v, **kwargs)


def _buffer_view(shape, dtype=torch.bfloat16, offset=0):
    """A tensor of ``shape`` that starts ``offset`` elements into a buffer
    the allocator aligned."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


def _btd_heads(b, t, h, d, dtype=torch.bfloat16):
    """The (b, h, t, d) view of a (b, t, h*d) tensor, as the attention
    layers hand it to the kernels."""
    return torch.zeros(b, t, h * d, dtype=dtype).view(b, t, h, d).transpose(1, 2)


def _odd_size_one_strides():
    """(1, 1, 5, 64) with strides of the two size-1 extents that are no
    multiple of 8: never applied, so they do not matter."""
    base = torch.zeros(5 * 64, dtype=torch.bfloat16)
    return base.as_strided((1, 1, 5, 64), (3, 5, 64, 1))


VECTOR_CASES = {
    # name: (a function making q, k and v, whether the bf16 forward stages with cp.async)
    "contiguous_d64": (lambda: [_buffer_view((2, 3, 7, 64)) for _ in range(3)], True),
    "btd_views_d64": (lambda: [_btd_heads(2, 7, 12, 64) for _ in range(3)], True),
    "d40_dv24": (lambda: [_buffer_view((2, 3, 7, 40)), _buffer_view((2, 3, 9, 40)),
                          _buffer_view((2, 3, 9, 24))], True),
    "size_one_extents": (lambda: [_odd_size_one_strides() for _ in range(3)], True),
    "float32_d4": (lambda: [_buffer_view((2, 3, 7, 4), torch.float32) for _ in range(3)], True),
    "d33": (lambda: [_buffer_view((2, 3, 7, 33)) for _ in range(3)], False),
    "dv20": (lambda: [_buffer_view((2, 3, 7, 64)), _buffer_view((2, 3, 7, 64)),
                      _buffer_view((2, 3, 7, 20))], False),
    "btd_views_d20": (lambda: [_btd_heads(2, 7, 12, 20) for _ in range(3)], False),
    "offset_view": (lambda: [_buffer_view((2, 3, 7, 64), offset=1), _buffer_view((2, 3, 7, 64)),
                             _buffer_view((2, 3, 7, 64))], False),
}


@pytest.mark.parametrize("name", sorted(VECTOR_CASES))
def test_vector_staging_needs_16_byte_rows(name):
    """The launcher's choice of the bf16 forward's staging: cp.async where
    every row starts on a 16-byte boundary and holds whole 16-byte chunks,
    element by element otherwise. A function of pointers, strides and the
    element size, so CPU tensors reach it."""
    build, want = VECTOR_CASES[name]
    tensors = build()
    assert fa._vector_ok(*tensors) is want
    # o, as the launcher allocates it: (b, t_q, h, d_v) seen as (b, h, t_q, d_v)
    b, h, t_q, _ = tensors[0].shape
    d_v = tensors[2].shape[-1]
    o = torch.empty((b, t_q, h, d_v), dtype=tensors[0].dtype).transpose(1, 2)
    assert fa._vector_ok(*tensors, o) is want
