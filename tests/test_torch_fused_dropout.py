"""The port's fused dropout against the JAX package, on the CPU.

The port draws its bits with Philox4x32-10 (``fused_dropout.py`` states the
counter/key layout); the JAX package's interpret mode (``DL4J_TPU_PALLAS_
INTERPRET=1``, as ``tests/test_pallas.py`` runs it) draws them from its rbg
stand-in, and its TPU kernel from the TPU's own generator. So the masks are
held only in distribution, and what the two packages compute from a mask is
held bit for bit: wherever both keep an element, ``x + h * inv_keep`` agrees
exactly, in float32 and bfloat16; where both drop it, ``x + 0`` does.

The generator is pinned by known answers of Philox4x32-10: the Random123
test vectors (counter = key = 0, and counter = key = all ones), which are
also the outputs of tensorflow's ``StatelessRandomUniformFullIntV2`` with
``alg=1`` (Philox) at key 0 and counter 0 and at all ones; and that op's next
four words at key 0 (counter 1), which pin the element layout (element i
takes word i % 4 of counter i // 4).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from deeplearning4j_tpu.ops.pallas import fused_dropout as jfd
from deeplearning4j_tpu_torch.ops.kernels import fused_dropout as fd

ONES = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")


def _within_binomial(n_kept, n, keep, sigmas=5.0):
    return abs(n_kept - n * keep) <= sigmas * math.sqrt(n * keep * (1 - keep)) + 1


@pytest.mark.parametrize("ctr, key, want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((ONES,) * 4, (ONES, ONES), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answers(ctr, key, want):
    got = tuple(int(w) for w in fd.philox4x32_10(*ctr, *key))
    assert got == want, [hex(w) for w in got]


def test_element_layout_takes_word_i_mod_4_of_counter_i_div_4():
    bits = [int(b) for b in fd.dropout_bits(10, 0)]
    assert bits[:8] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8,
                        0xF8E4CCA4, 0x5CB200DB, 0xB1A574EB, 0x097EFF67]
    # a count past 2**32 carries into the counter's second word
    j = torch.tensor([2 ** 32 + 5])
    words = fd.philox4x32_10(j & ONES, j >> 32, 0, 0, 9, 0)
    want = fd.philox4x32_10(5, 1, 0, 0, 9, 0)
    assert [int(w) for w in words] == [int(w) for w in want]


def test_negative_int32_seed_is_its_bit_pattern():
    assert torch.equal(fd.dropout_bits(37, -1), fd.dropout_bits(37, ONES))
    assert torch.equal(fd.dropout_bits(37, torch.tensor(-7, dtype=torch.int32)),
                       fd.dropout_bits(37, 2 ** 32 - 7))


@pytest.mark.parametrize("rate", [0.0, 1e-9, 0.1, 0.3, 0.5, 0.9, 0.999999])
def test_threshold_equals_jax(rate):
    assert fd.threshold(rate) == jfd._thresh(rate)
    assert fd.threshold(0.1) == 3865470566 and fd.threshold(0.0) == 4294967295


def test_inverse_keep_is_rounded_to_the_dtype_first():
    assert fd.inv_keep(0.1, torch.bfloat16) == 1.109375
    assert fd.inv_keep(0.1, torch.float32) == float(np.float32(1.0 / 0.9))


def _jax(x, h, seed, rate, dtype):
    jx = None if x is None else jnp.asarray(x, dtype)
    y = jfd.fused_dropout_add(jx, jnp.asarray(h, dtype), jnp.int32(seed), rate)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("with_x", [False, True])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kept_values_equal_jax_bitwise_and_masks_agree_in_distribution(dtype, rate, with_x):
    rng = np.random.default_rng(int(rate * 10) + with_x)
    h = rng.standard_normal((96, 64)).astype(np.float32)
    x = rng.standard_normal((96, 64)).astype(np.float32) if with_x else None
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    want = _jax(x, h, 11, rate, jdt)
    jkept = _jax(None, h, 11, rate, jdt) != 0
    tx = None if x is None else torch.from_numpy(x).to(tdt)
    got = fd.fused_dropout_add(tx, torch.from_numpy(h).to(tdt), 11, rate).float().numpy()
    tkept = fd.keep_mask(h.size, 11, rate).reshape(h.shape).numpy()
    both, neither = jkept & tkept, ~jkept & ~tkept
    assert both.sum() > 0.2 * h.size and neither.sum() > 0.005 * h.size
    np.testing.assert_array_equal(got[both], want[both])
    np.testing.assert_array_equal(got[neither], want[neither])
    for kept in (jkept, tkept):
        assert _within_binomial(int(kept.sum()), h.size, 1 - rate)


def test_deterministic_given_the_seed_and_sensitive_to_it():
    h = torch.from_numpy(np.random.default_rng(0).standard_normal((256, 32)).astype(np.float32))
    y = fd.fused_dropout(h, 5, 0.5)
    assert torch.equal(y, fd.fused_dropout(h, 5, 0.5))
    assert torch.equal(y, fd.fused_dropout(h, torch.tensor(5), 0.5))
    assert not torch.equal(y == 0, fd.fused_dropout(h, 6, 0.5) == 0)
    kept = y != 0
    torch.testing.assert_close(y[kept], h[kept] * 2.0, rtol=0, atol=0)
    assert _within_binomial(int(kept.sum()), h.numel(), 0.5)


def test_seed_from_key_draws_one_int32_from_the_generator():
    s1 = fd.seed_from_key(torch.Generator().manual_seed(3))
    s2 = fd.seed_from_key(torch.Generator().manual_seed(3))
    s3 = fd.seed_from_key(torch.Generator().manual_seed(4))
    assert s1.dtype == torch.int32 and s1.shape == () and int(s1) == int(s2) != int(s3)


@pytest.mark.parametrize("with_x", [False, True])
def test_gradient_mask_equals_forward_mask_and_dx_is_gy(with_x):
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.standard_normal((64, 40)).astype(np.float32)).requires_grad_()
    x = torch.from_numpy(rng.standard_normal((64, 40)).astype(np.float32)).requires_grad_() \
        if with_x else None
    y = fd.fused_dropout_add(x, h, 21, 0.3)
    gy = torch.from_numpy(rng.standard_normal((64, 40)).astype(np.float32))
    grads = torch.autograd.grad(y, [h] + ([x] if with_x else []), gy)
    kept = fd.fused_dropout(h.detach(), 21, 0.3) != 0
    assert torch.equal(grads[0] != 0, kept)
    assert torch.equal(grads[0], torch.where(kept, gy * fd.inv_keep(0.3, torch.float32),
                                             torch.zeros(())))
    if with_x:
        assert torch.equal(grads[1], gy)


def test_backward_returns_gy_itself_for_x_and_saves_only_the_seed():
    h = torch.randn(8, 4, requires_grad=True)
    x = torch.randn(8, 4, requires_grad=True)
    y = fd.FusedDropoutFunction.apply(x, h, 9, 0.2)
    assert not y.grad_fn.saved_tensors
    gy = torch.randn(8, 4)
    dx, dh, dseed, drate = y.grad_fn.apply(gy)
    assert dx is gy and dseed is None and drate is None
    assert torch.equal(dh, fd.fused_dropout(gy, 9, 0.2))


def test_gradient_matches_jax_vjp_where_masks_agree():
    import jax
    rng = np.random.default_rng(4)
    h, gy = (rng.standard_normal((48, 32)).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(lambda h: jfd.fused_dropout(h, jnp.int32(2), 0.25), jnp.asarray(h))
    (jdh,) = vjp(jnp.asarray(gy))
    jdh = np.asarray(jdh)
    th = torch.from_numpy(h).requires_grad_()
    (tdh,) = torch.autograd.grad(fd.fused_dropout(th, 2, 0.25), [th], torch.from_numpy(gy))
    tdh = tdh.numpy()
    both = (jdh != 0) & (tdh != 0)
    np.testing.assert_array_equal(tdh[both], jdh[both])


@pytest.mark.parametrize("shape", [(1,), (1, 1), (3,), (4 * 25 + 3,), (3, 130, 64), (7, 5, 3)])
def test_any_shape_and_a_ragged_tail(shape):
    n = int(np.prod(shape))
    h = torch.from_numpy(np.random.default_rng(n).standard_normal(shape).astype(np.float32))
    y = fd.fused_dropout(h, 1, 0.5)
    assert y.shape == h.shape
    kept = fd.keep_mask(n, 1, 0.5).reshape(shape)
    assert torch.equal(y, torch.where(kept, h * 2.0, torch.zeros(())))
    # a tail element takes word i % 4 of its own counter, as in a whole tensor
    assert torch.equal(fd.keep_mask(n, 1, 0.5), fd.keep_mask(n + 5, 1, 0.5)[:n])


def test_rate_zero_is_not_the_identity_but_keeps_all_but_the_top_bit_pattern():
    bits = fd.dropout_bits(4096, 123)
    assert torch.equal(fd.keep_mask(4096, 123, 0.0), bits < 4294967295)


@pytest.mark.parametrize("rate", [1.0, 1.5, -0.1])
def test_rate_outside_zero_one_raises(rate):
    with pytest.raises(ValueError, match="rate"):
        fd.fused_dropout(torch.ones(4, 4), 0, rate)
    if rate == 1.0:
        with pytest.raises(ZeroDivisionError):
            jfd.fused_dropout(jnp.ones((4, 4)), jnp.int32(0), rate)


@pytest.mark.parametrize("bad", ["shape", "dtype", "integer"])
def test_wrapper_raises_on_what_it_does_not_take(bad):
    h = torch.ones(4, 4)
    if bad == "integer":
        with pytest.raises(TypeError):
            fd.fused_dropout(torch.ones(4, 4, dtype=torch.int32), 0, 0.1)
        return
    x = torch.ones(4, 5) if bad == "shape" else torch.ones(4, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fd.fused_dropout_add(x, h, 0, 0.1)


def test_cuda_path_launches_the_kernel_forward_and_backward(monkeypatch):
    """A tensor off the CPU goes to the launcher (forward on ``counter``,
    backward on ``bwd_counter``), never to the plain version; a device that
    is not CUDA raises."""
    h = torch.empty(6, 4, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fd.fused_dropout(h, 0, 0.1)
    launched = []

    def launch(x, h_, seed, rate, launches):
        launched.append((x is None, launches.name, seed, rate))
        return torch.empty_like(h_)

    monkeypatch.setattr(fd, "_check", lambda *a: None)
    monkeypatch.setattr(fd, "launch_dropout", launch)
    monkeypatch.setattr(fd, "fused_dropout_reference",
                        lambda *a: pytest.fail("plain version ran for a meta tensor"))
    (grad,) = torch.autograd.grad(fd.fused_dropout(h, -1, 0.1).sum(), [h])
    assert grad.device.type == "meta"
    assert launched == [(True, "fused_dropout", ONES, 0.1), (True, "fused_dropout_bwd", ONES, 0.1)]
    with torch.no_grad():
        fd.fused_dropout_add(torch.empty(6, 4, device="meta"), h, 3, 0.5)
    assert launched[-1] == (False, "fused_dropout", 3, 0.5)
