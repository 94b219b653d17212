"""The port's short attention against the JAX package, on the CPU.

``short_attention`` and ``short_attention_btd`` (which on CPU tensors run the
plain versions, ``short_attention_reference`` and, under autograd,
``short_attention_backward_reference``) are held against the JAX package's
functions with their Pallas kernels in interpret mode
(``DL4J_TPU_PALLAS_INTERPRET=1``, as ``tests/test_pallas.py`` runs them):
the output, and dq, dk, dv from ``jax.vjp`` against the port's autograd on
the same cotangent. So the backward formula (``ds = P * (dP - rowsum(dP *
P)) * scale``) is held against ``_short_bwd_vjp``/``_btd_bwd_vjp``. The
interpreter takes odd shapes, so t = 40, d = 16 runs beside t = 128, d = 64.

Float32 at ``atol = rtol = 1e-5``: both sides take fp32 scores from the same
fp32 operands and differ only in summation order. Bfloat16 rounds P and dS to
bf16 at the same points on both sides; a value near a rounding tie can land
one bf16 ulp apart in P or dS, and the outputs are rounded to bf16, so the
limit is 2 bf16 ulps of each output's largest value (2 x 2^-7 relative).
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from deeplearning4j_tpu.ops.pallas import fused_attention_short as jsa
from deeplearning4j_tpu_torch.ops.kernels import fused_attention_short as sa

TOL = 1e-5
B, H = 2, 2


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")


def _mask(case, t, seed):
    """None, or a key mask with batch 0 of random lengths' keys masked and,
    for ``fully_masked``, every key of batch 0 masked."""
    if case in ("no_mask", "scale"):
        return None
    m = np.ones((B, t), bool)
    m[1, np.random.default_rng(seed).permutation(t)[: t // 3]] = False
    if case == "fully_masked":
        m[0] = False
    return m[:, None, None, :] if case == "mask_4d" else m


def _inputs(layout, t, d, seed):
    rng = np.random.default_rng(seed)
    shape = (B, H, t, d) if layout == "bhtd" else (B, t, H * d)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _jax(layout, q, k, v, do, mask, scale, dtype=jnp.float32):
    jm = None if mask is None else jnp.asarray(mask)
    if layout == "bhtd":
        fn = lambda q, k, v: jsa.short_attention(q, k, v, jm, scale)  # noqa: E731
    else:
        fn = lambda q, k, v: jsa.short_attention_btd(q, k, v, jm, H, scale)  # noqa: E731
    o, vjp = jax.vjp(fn, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _torch(layout, q, k, v, do, mask, scale, dtype=torch.float32):
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    if layout == "bhtd":
        o = sa.short_attention(*leaves, tm, scale=scale)
    else:
        o = sa.short_attention_btd(*leaves, tm, heads=H, scale=scale)
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(do).to(dtype))
    return [x.detach().float().numpy() for x in (o, *grads)]


CASES = [("no_mask", 128, 64), ("mask_2d", 40, 16), ("mask_4d", 128, 64),
         ("fully_masked", 40, 16), ("scale", 40, 16)]


@pytest.mark.parametrize("layout", ["bhtd", "btd"])
@pytest.mark.parametrize("case, t, d", CASES)
def test_output_and_gradients_match_jax_kernels(layout, case, t, d):
    q, k, v, do = _inputs(layout, t, d, seed=t + d + len(case))
    mask = _mask(case, t, seed=d)
    scale = 0.3 if case == "scale" else None
    want = _jax(layout, q, k, v, do, mask, scale)
    got = _torch(layout, q, k, v, do, mask, scale)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=f"{layout} {case} {name}")


@pytest.mark.parametrize("layout", ["bhtd", "btd"])
def test_bfloat16_rounds_p_and_ds_where_jax_does(layout):
    q, k, v, do = _inputs(layout, 128, 64, seed=5)
    mask = _mask("mask_2d", 128, seed=6)
    want = _jax(layout, q, k, v, do, mask, None, jnp.bfloat16)
    got = _torch(layout, q, k, v, do, mask, None, torch.bfloat16)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        err = float(np.abs(g - w).max()) / float(np.abs(w).max())
        assert err <= 2 * 2.0 ** -7, f"{layout} {name}: {err}"


def test_fully_masked_row_gives_mean_of_v_and_4d_mask_equals_2d():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs("bhtd", 40, 16, seed=1))
    m = torch.ones(B, 40, dtype=torch.bool)
    m[0] = False
    o = sa.short_attention(q, k, v, m)
    torch.testing.assert_close(o[0], v[0].mean(dim=1, keepdim=True).expand_as(o[0]),
                               atol=1e-6, rtol=1e-6)
    assert torch.equal(o, sa.short_attention(q, k, v, m[:, None, None, :]))


def test_btd_layout_is_the_head_split_of_bhtd():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs("btd", 40, 16, seed=2))
    split = [x.reshape(B, 40, H, 16).transpose(1, 2) for x in (q, k, v)]
    want = sa.short_attention(*split).transpose(1, 2).reshape(B, 40, H * 16)
    assert torch.equal(sa.short_attention_btd(q, k, v, heads=H), want)


COMPATIBLE = {  # q shape, mask shape, causal -> the kernel takes it
    "bert_base": ((2, 12, 128, 64), (2, 128), False, True),
    "odd_t_and_d": ((2, 2, 77, 48), (2, 1, 1, 77), False, True),
    "t_512": ((1, 1, 512, 64), None, False, True),
    "t_513": ((1, 1, 513, 64), None, False, False),
    "causal": ((1, 1, 128, 64), None, True, False),
    "general_mask": ((2, 2, 8, 8), (2, 1, 8, 8), False, False),
    "d_257": ((1, 1, 8, 257), None, False, False),
}


@pytest.mark.parametrize("name", sorted(COMPATIBLE))
def test_compatible_keeps_only_the_semantic_limits(name):
    qs, ms, causal, want = COMPATIBLE[name]
    q = torch.zeros(qs)
    mask = None if ms is None else torch.ones(ms, dtype=torch.bool)
    assert sa.short_attention_compatible(q, q, q, mask, causal=causal) is want
    b, h, t, d = qs
    assert sa.short_attention_btd_compatible(torch.zeros(b, t, h * d), mask, heads=h,
                                             causal=causal) is want


def test_compatible_refuses_other_dtypes_and_cross_attention():
    q = torch.zeros(1, 2, 8, 16)
    assert not sa.short_attention_compatible(q.double(), q.double(), q.double())
    assert not sa.short_attention_compatible(q, torch.zeros(1, 2, 9, 16), torch.zeros(1, 2, 9, 16))
    assert not sa.short_attention_btd_compatible(torch.zeros(1, 8, 30), heads=4)


@pytest.mark.parametrize("bad", ["t_513", "cross", "general_mask", "dtype_mix", "heads"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    t = 513 if bad == "t_513" else 8
    q = torch.zeros(1, 2, t, 16)
    k = torch.zeros(1, 2, 9, 16) if bad == "cross" else q
    v = q.bfloat16() if bad == "dtype_mix" else k
    mask = torch.ones(1, 1, t, t, dtype=torch.bool) if bad == "general_mask" else None
    with pytest.raises(TypeError if bad == "dtype_mix" else ValueError):
        if bad == "heads":
            sa.short_attention_btd(torch.zeros(1, 8, 30), torch.zeros(1, 8, 30),
                                   torch.zeros(1, 8, 30), heads=4)
        else:
            sa.short_attention(q, k, v, mask)


@pytest.mark.parametrize("layout", ["bhtd", "btd"])
def test_cuda_path_launches_the_kernels_and_saves_only_inputs(monkeypatch, layout):
    """A tensor off the CPU never runs the plain versions: a device that is
    not CUDA raises; past the check the forward and backward launchers run,
    on the counters of the layout."""
    shape = (2, 3, 5, 8) if layout == "bhtd" else (2, 5, 24)
    q = torch.empty(shape, device="meta", requires_grad=True)
    k, v = (torch.empty(shape, device="meta") for _ in range(2))
    call = (lambda *a: sa.short_attention(*a)) if layout == "bhtd" else \
        (lambda *a: sa.short_attention_btd(*a, heads=3))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        call(q, k, v)
    launched = []

    def fwd(q_, k_, v_, bias, scale, launches, btd=False):
        launched.append(("fwd", launches.name, btd, scale))
        return torch.empty(q_.shape, device="meta")

    def bwd(q_, k_, v_, do, bias, scale, launches, btd=False):
        launched.append(("bwd", launches.name, btd, tuple(do.shape)))
        return tuple(torch.empty(q_.shape, device="meta") for _ in range(3))

    monkeypatch.setattr(sa, "_check", lambda *a: None)
    monkeypatch.setattr(sa, "launch_short_fwd", fwd)
    monkeypatch.setattr(sa, "launch_short_bwd", bwd)
    for name in ("short_attention_reference", "short_attention_backward_reference"):
        monkeypatch.setattr(sa, name, lambda *a: pytest.fail("plain version ran off the CPU"))
    out = call(q, k, v)
    assert out.shape == q.shape
    (grad,) = torch.autograd.grad(out.sum(), [q])
    assert grad.shape == q.shape
    name = "short_attention" if layout == "bhtd" else "short_attention_btd"
    btd = layout == "btd"
    assert launched == [("fwd", name, btd, 8 ** -0.5), ("bwd", name + "_bwd", btd, (2, 3, 5, 8))]
    with torch.no_grad():
        call(q, k, v)
    assert launched[-1][:2] == ("fwd", name)
    saved = sa.ShortAttentionFunction.apply(q, k, v, None, 0.5, btd).grad_fn.saved_tensors
    assert len(saved) == 4 and saved[3] is None  # q, k, v and the mask, nothing else


@pytest.mark.parametrize("d", [24, 80])
@pytest.mark.parametrize("t", [1, 17, 129])
def test_plain_version_matches_jax_at_odd_lengths_and_widths(t, d):
    """Lengths and widths that are no tile multiple (t = 129 takes the bf16
    kernel's two-pass design on the card; d = 24 and 80 are padded to 32
    and 96 there): the plain version, which the CUDA kernels are held to,
    against the Pallas kernels in interpret mode, with a key mask."""
    q, k, v, do = _inputs("bhtd", t, d, seed=3 * t + d)
    mask = _mask("mask_2d", t, seed=t)
    want = _jax("bhtd", q, k, v, do, mask, None)
    got = _torch("bhtd", q, k, v, do, mask, None)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=f"t={t} d={d} {name}")


def _view(shape, offset=0, dtype=torch.bfloat16):
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


VECTOR_CASES = {  # (b, t, h*d) tensors or their views -> cp.async staging
    "contiguous_d64": (lambda: _view((2, 3, 16, 64)), True),
    "btd_views_d64": (lambda: _view((2, 16, 3 * 64)).view(2, 16, 3, 64).transpose(1, 2), True),
    "d24": (lambda: _view((2, 3, 17, 24)), True),
    "d33": (lambda: _view((2, 3, 17, 33)), False),
    "btd_views_d20": (lambda: _view((2, 16, 3 * 20)).view(2, 16, 3, 20).transpose(1, 2), False),
    "offset_view": (lambda: _view((2, 3, 16, 64), offset=1), False),
    "offset_16_bytes": (lambda: _view((2, 3, 16, 64), offset=8), True),
    "d128": (lambda: _view((2, 3, 9, 128)), True),
    "btd_views_offset": (lambda: _view((2, 16, 3 * 64), offset=1).view(2, 16, 3, 64)
                         .transpose(1, 2), False),
}


@pytest.mark.parametrize("name", sorted(VECTOR_CASES))
def test_vector_staging_choice_of_the_launcher(name):
    """``launch_short_fwd`` stages with cp.async only where every row of q,
    k, v and o starts on a 16-byte boundary and holds whole 16-byte chunks;
    otherwise the same kernel stages element by element. A function of
    pointers and strides, so CPU tensors reach it."""
    build, want = VECTOR_CASES[name]
    x = build()
    aligned = _view(tuple(x.shape))
    assert sa._vector_ok(x, aligned, aligned) is want
    assert sa._vector_ok(aligned, aligned, x) is want
    assert sa._vector_ok(aligned, aligned, aligned) is (x.shape[-1] % 8 == 0)


@pytest.mark.parametrize("btd", [False, True])
@pytest.mark.parametrize("where", ["q", "do"])
@pytest.mark.parametrize("name", sorted(VECTOR_CASES))
def test_backward_launcher_stages_by_its_seven_operands(monkeypatch, name, where, btd):
    """``launch_short_bwd`` hands the bf16 pair ``vec = _vector_ok`` over q,
    k, v, dO and the dq, dk, dv buffers it allocates (``(b, t, h, d)``
    buffers seen as ``(b, h, t, d)`` when ``btd``), with their strides. A
    stand-in library object takes the built one's place, so CPU tensors
    reach the launcher; the case's tensor is q or dO, the others aligned."""
    build, want = VECTOR_CASES[name]
    x = build()
    aligned = [_view(tuple(x.shape)) for _ in range(3)]
    operands = [x, *aligned] if where == "q" else [*aligned, x]
    calls, seen = [], []
    vector_ok = sa._vector_ok

    def spy(*tensors):
        seen.append(tensors)
        return vector_ok(*tensors)

    class Library:
        def dl4j_short_attention_bwd(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(sa, "_vector_ok", spy)
    monkeypatch.setattr(sa, "LIBRARY", SimpleNamespace(load=Library))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    launches = sa.LaunchCounter("short_attention_bwd_test")
    grads = sa.launch_short_bwd(*operands, None, 0.125, launches, btd)
    (args,) = calls
    (checked,) = seen
    assert [t.data_ptr() for t in checked] == [t.data_ptr() for t in (*operands, *grads)]
    assert list(args[16]) == [s for t in (*operands, *grads) for s in t.stride()[:3]]
    assert args[-2] == int(want)  # vec, just before the stream
    assert launches.value == 1
    for g in grads:
        assert g.shape == x.shape and g.dtype == x.dtype
        assert (g.transpose(1, 2) if btd else g).is_contiguous()
