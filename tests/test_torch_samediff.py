"""The port's SameDiff against the JAX package on the CPU.

Every ported registry op against the JAX registry's function on the same
inputs (made with numpy from a seed), forward and, for the differentiable
ones, the gradient of ``sum(out * w)``; the scenarios of
``tests/test_samediff.py`` that need no unported op, run in the port; a
small MLP graph built in the JAX package crossing to the port through its
archive (outputs, ``calculate_gradients``, five Adam steps, the updater
state both ways with an exact resume); and the refusals by name.

Float32. Ops: 1e-6 absolute and relative, forward and gradient, but the
fused attention (``scaled_dot_product_attention``): 2e-6, as the port's
path runs the flash kernel's plain version (fp32 scores and lse, then
``P @ V``) where the JAX package's CPU path is its einsum form. Graph
outputs and losses 1e-5; weights after five Adam steps 1e-5 (an update of
size lr carries last-bit differences of sqrt and division).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import ops_registry as jops
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff.samediff import TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.train.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.autodiff import ops_registry as tops
from deeplearning4j_tpu_torch.autodiff.samediff import History
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.train.updaters import Adam, Sgd


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


# --------------------------------------------------------------- op parity
def _f(rng, *shape, lo=None):
    if lo is not None:
        return rng.uniform(lo, 2.0, shape).astype(np.float32)
    return rng.normal(0.0, 1.0, shape).astype(np.float32)


def _ids(rng, n, *shape):
    return rng.integers(0, n, shape).astype(np.int32)


def _padding_bias(rng, b, t, full_row=None):
    mask = (np.arange(t)[None, :] < rng.integers(1, t + 1, b)[:, None]).astype(np.float32)
    if full_row is not None:
        mask[full_row] = 0.0
    return ((1.0 - mask) * -10000.0).reshape(b, 1, 1, t).astype(np.float32)


def _case(name, op, make, attrs=None, grad=True):
    return pytest.param(op, make, attrs or {}, grad, id=name)


OP_CASES = [
    _case("add", "add", lambda r: [_f(r, 3, 4), _f(r, 4)]),
    _case("add_0d", "add", lambda r: [_f(r, 3, 4), np.asarray(0.5, np.float32)]),
    _case("sub", "sub", lambda r: [_f(r, 3, 4), _f(r, 3, 4)]),
    _case("mul", "mul", lambda r: [_f(r, 2, 3, 4), _f(r, 4)]),
    _case("div", "div", lambda r: [_f(r, 3, 4), _f(r, 3, 4, lo=0.5)]),
    _case("div_int", "div", lambda r: [_ids(r, 9, 3, 4) + 1, _ids(r, 4, 3, 4) + 1], grad=False),
    _case("pow", "pow", lambda r: [_f(r, 3, 4, lo=0.5), _f(r, 3, 4)]),
    _case("squared_difference", "squared_difference", lambda r: [_f(r, 3, 4), _f(r, 3, 1)]),
    _case("gt", "gt", lambda r: [_f(r, 3, 4), _f(r, 3, 4)], grad=False),
    _case("lt", "lt", lambda r: [_f(r, 3, 4), _f(r, 4)], grad=False),
    _case("neg", "neg", lambda r: [_f(r, 3, 4)]),
    _case("rsqrt", "rsqrt", lambda r: [_f(r, 3, 4, lo=0.1)]),
    _case("tanh", "tanh", lambda r: [_f(r, 3, 4)]),
    _case("erf", "erf", lambda r: [2 * _f(r, 4, 8)]),
    _case("relu", "relu", lambda r: [_f(r, 3, 4)]),
    _case("gelu_tanh", "gelu", lambda r: [3 * _f(r, 4, 16)], {"approximate": True}),
    _case("gelu_erf", "gelu", lambda r: [3 * _f(r, 4, 16)], {"approximate": False}),
    _case("cast_to_int", "cast", lambda r: [5 * _f(r, 3, 4)], {"dtype": "int32"}, grad=False),
    _case("cast_to_float", "cast", lambda r: [_ids(r, 2, 3, 4)], {"dtype": "float32"},
          grad=False),
    _case("cast_to_bool", "cast", lambda r: [_ids(r, 2, 3, 4)], {"dtype": "bool"}, grad=False),
    _case("identity", "identity", lambda r: [_f(r, 3, 4)]),
    _case("dropout_inference", "dropout", lambda r: [_f(r, 3, 4)], {"rate": 0.5}),
    _case("matmul", "matmul", lambda r: [_f(r, 3, 4), _f(r, 4, 5)]),
    _case("matmul_transpose_a", "matmul", lambda r: [_f(r, 4, 3), _f(r, 4, 5)],
          {"transpose_a": True}),
    _case("matmul_transpose_b", "matmul", lambda r: [_f(r, 2, 3, 4), _f(r, 5, 4)],
          {"transpose_a": False, "transpose_b": True}),
    _case("batch_matmul", "batch_matmul", lambda r: [_f(r, 2, 3, 4, 5), _f(r, 2, 3, 6, 5)],
          {"transpose_a": False, "transpose_b": True}),
    _case("reduce_sum", "reduce_sum", lambda r: [_f(r, 3, 4, 5)], {"axis": 1}),
    _case("reduce_sum_all", "reduce_sum", lambda r: [_f(r, 3, 4)]),
    _case("reduce_mean", "reduce_mean", lambda r: [_f(r, 3, 4, 5)],
          {"axis": [-1], "keepdims": True}),
    _case("reduce_mean_all_keepdims", "reduce_mean", lambda r: [_f(r, 3, 4)],
          {"keepdims": True}),
    _case("reduce_std", "reduce_std", lambda r: [_f(r, 3, 4, 5)], {"axis": 2}),
    _case("reshape", "reshape", lambda r: [_f(r, 2, 3, 4)], {"shape": [0, -1]}),
    _case("reshape_heads", "reshape", lambda r: [_f(r, 6, 8)], {"shape": [2, 3, 2, 4]}),
    _case("transpose", "transpose", lambda r: [_f(r, 2, 3, 4, 5)], {"perm": [0, 2, 1, 3]}),
    _case("transpose_reversed", "transpose", lambda r: [_f(r, 2, 3, 4)]),
    _case("expand_dims", "expand_dims", lambda r: [_f(r, 2, 3)], {"axis": 1}),
    _case("concat", "concat", lambda r: [_f(r, 2, 3), _f(r, 2, 5)], {"axis": 1}),
    _case("split", "split", lambda r: [_f(r, 4, 3)], {"num_splits": 2, "axis": 0}),
    # strided_slice: each mask, and negative strides
    _case("strided_slice_cls", "strided_slice", lambda r: [_f(r, 2, 8, 4)],
          {"begin": [0, 0, 0], "end": [0, 1, 0], "strides": [1, 1, 1], "begin_mask": 5,
           "end_mask": 5, "shrink_axis_mask": 2, "new_axis_mask": 0, "ellipsis_mask": 0}),
    _case("strided_slice_ranges", "strided_slice", lambda r: [_f(r, 5, 9)],
          {"begin": [1, 2], "end": [4, 8], "strides": [1, 2]}),
    _case("strided_slice_begin_mask", "strided_slice", lambda r: [_f(r, 5, 9)],
          {"begin": [3, 2], "end": [4, 6], "strides": [1, 1], "begin_mask": 1}),
    _case("strided_slice_end_mask", "strided_slice", lambda r: [_f(r, 5, 9)],
          {"begin": [1, 2], "end": [0, 6], "strides": [2, 1], "end_mask": 1}),
    _case("strided_slice_negative_stride", "strided_slice", lambda r: [_f(r, 5, 9)],
          {"begin": [4, 0], "end": [0, 9], "strides": [-2, 3]}),
    _case("strided_slice_reverse", "strided_slice", lambda r: [_f(r, 5, 9)],
          {"begin": [0, -1], "end": [0, 0], "strides": [-1, -1], "begin_mask": 1,
           "end_mask": 3}),
    _case("strided_slice_shrink_negative", "strided_slice", lambda r: [_f(r, 5, 9)],
          {"begin": [-1, 1], "end": [0, 5], "strides": [1, 1], "shrink_axis_mask": 1}),
    _case("strided_slice_new_axis", "strided_slice", lambda r: [_f(r, 5, 9)],
          {"begin": [0, 0, 2], "end": [3, 0, 7], "strides": [1, 1, 2], "new_axis_mask": 2}),
    _case("strided_slice_ellipsis", "strided_slice", lambda r: [_f(r, 2, 3, 9)],
          {"begin": [0, 1], "end": [0, 8], "strides": [1, 3], "ellipsis_mask": 1}),
    _case("strided_slice_ellipsis_reverse", "strided_slice", lambda r: [_f(r, 2, 3, 9)],
          {"begin": [1, 0, 0], "end": [2, 0, 0], "strides": [1, 1, -1], "ellipsis_mask": 2,
           "begin_mask": 4, "end_mask": 4}),
    _case("gather_small_table", "gather", lambda r: [_f(r, 2, 8), _ids(r, 2, 4, 6)],
          {"axis": 0}),
    _case("gather_table", "gather", lambda r: [_f(r, 50, 8), _ids(r, 50, 2, 5)], {"axis": 0}),
    _case("gather_axis1", "gather", lambda r: [_f(r, 3, 10, 4), _ids(r, 10, 2, 3)],
          {"axis": 1}),
    _case("gather_negative_ids", "gather", lambda r: [_f(r, 30, 4), -1 - _ids(r, 30, 7)],
          {"axis": 0}),
    _case("shape_of", "shape_of", lambda r: [_f(r, 2, 3, 4)], grad=False),
    _case("reshape_dynamic", "reshape_dynamic",
          lambda r: [_f(r, 2, 3, 4), np.asarray([6, 4], np.int32)]),
    _case("softmax", "softmax", lambda r: [3 * _f(r, 3, 5)]),
    _case("softmax_axis0", "softmax", lambda r: [3 * _f(r, 3, 5)], {"axis": 0}),
    _case("layer_norm", "layer_norm",
          lambda r: [3 * _f(r, 4, 16) + 1, _f(r, 16, lo=0.5), _f(r, 16)],
          {"axis": -1, "eps": 1e-12}),
    _case("layer_norm_no_bias", "layer_norm", lambda r: [_f(r, 2, 3, 8), _f(r, 8, lo=0.5)]),
    _case("layer_norm_axes", "layer_norm",
          lambda r: [_f(r, 2, 3, 8), _f(r, 3, 8, lo=0.5), _f(r, 3, 8)], {"axis": [1, 2]}),
    _case("bias_add", "bias_add", lambda r: [_f(r, 3, 4), _f(r, 4)]),
    _case("linear", "linear", lambda r: [_f(r, 2, 3, 4), _f(r, 4, 5), _f(r, 5)]),
    _case("linear_no_bias", "linear", lambda r: [_f(r, 3, 4), _f(r, 4, 5)]),
    _case("softmax_cross_entropy", "softmax_cross_entropy",
          lambda r: [np.eye(3, dtype=np.float32)[_ids(r, 3, 4)], 2 * _f(r, 4, 3)]),
    _case("mean_squared_error", "mean_squared_error", lambda r: [_f(r, 4, 3), _f(r, 4, 3)]),
    _case("sdpa_padding_bias", "scaled_dot_product_attention",
          lambda r: [_f(r, 2, 2, 8, 4), _f(r, 2, 2, 8, 4), _f(r, 2, 2, 8, 4),
                     _padding_bias(r, 2, 8)], {"scale": 0.5, "boolean_bias": True}),
    _case("sdpa_fully_masked_row", "scaled_dot_product_attention",
          lambda r: [_f(r, 2, 2, 8, 4), _f(r, 2, 2, 8, 4), _f(r, 2, 2, 8, 4),
                     _padding_bias(r, 2, 8, full_row=1)], {"scale": 0.5, "boolean_bias": True}),
    _case("sdpa_scaled_q", "scaled_dot_product_attention",
          lambda r: [_f(r, 2, 2, 8, 4), _f(r, 2, 2, 8, 4), _f(r, 2, 2, 8, 6),
                     _padding_bias(r, 2, 8)], {"scale": 0.3, "boolean_bias": True}),
    _case("sdpa_no_bias", "scaled_dot_product_attention",
          lambda r: [_f(r, 1, 2, 8, 4), _f(r, 1, 2, 8, 4), _f(r, 1, 2, 8, 4)]),
    _case("sdpa_general_bias", "scaled_dot_product_attention",
          lambda r: [_f(r, 2, 2, 8, 4), _f(r, 2, 2, 8, 4), _f(r, 2, 2, 8, 4),
                     _f(r, 2, 2, 8, 8)], {"scale": 0.5, "boolean_bias": False}),
    _case("sdpa_rank3", "scaled_dot_product_attention",
          lambda r: [_f(r, 2, 8, 4), _f(r, 2, 8, 4), _f(r, 2, 8, 4)], {"scale": 0.5}),
    _case("sdpa_rank3_boolean_bias", "scaled_dot_product_attention",
          lambda r: [_f(r, 2, 8, 4), _f(r, 2, 8, 4), _f(r, 2, 8, 4),
                     _padding_bias(r, 2, 8).reshape(2, 1, 8)],
          {"scale": 0.5, "boolean_bias": True}),
    _case("quantize_narrow", "quantize", lambda r: [3 * _f(r, 4, 6)],
          {"scale": 0.05, "narrow_range": True}, grad=False),
    _case("quantize_per_channel_uint8", "quantize", lambda r: [_f(r, 4, 3, lo=0.0)],
          {"scale": np.array([0.01, 0.02, 0.03], np.float32),
           "zero_point": np.array([3, 0, 7], np.int32), "axis": -1, "dtype": "uint8"},
          grad=False),
    _case("dequantize", "dequantize", lambda r: [_ids(r, 255, 4, 6).astype(np.int8)],
          {"scale": 0.05}, grad=False),
    _case("dequantize_per_channel", "dequantize", lambda r: [_ids(r, 100, 3, 5).astype(np.int8)],
          {"scale": np.array([0.5, 0.25, 0.125], np.float32), "zero_point": 2, "axis": 0},
          grad=False),
]


def _as_list(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "") if isinstance(t, torch.Tensor) else \
        np.asarray(t).dtype.name


@pytest.mark.parametrize("op,make,attrs,grad", OP_CASES)
def test_op_matches_jax(op, make, attrs, grad, request):
    rng = np.random.default_rng(zlib.crc32(request.node.callspec.id.encode()))
    args = make(rng)
    tol = 2e-6 if op == "scaled_dot_product_attention" else 1e-6
    want = _as_list(jops.get_op(op)(*[jnp.asarray(a) for a in args], **attrs))
    got = _as_list(tops.get_op(op)(*[torch.from_numpy(np.array(a)) for a in args], **attrs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        assert _dtype_name(g) == _dtype_name(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)
    if not grad:
        return
    floats = [i for i, a in enumerate(args) if np.asarray(a).dtype == np.float32]
    weights = [rng.normal(0, 1, np.shape(w)).astype(np.float32) for w in want]

    def jloss(*xs):
        full = [jnp.asarray(a) for a in args]
        for i, x in zip(floats, xs):
            full[i] = x
        outs = _as_list(jops.get_op(op)(*full, **attrs))
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights))

    jgrads = jax.grad(jloss, argnums=tuple(range(len(floats))))(
        *[jnp.asarray(args[i]) for i in floats])
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(i in floats)
              for i, a in enumerate(args)]
    outs = _as_list(tops.get_op(op)(*leaves, **attrs))
    total = sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, weights))
    tgrads = torch.autograd.grad(total, [leaves[i] for i in floats], allow_unused=True)
    for i, tg, jg in zip(floats, tgrads, jgrads):
        tg = torch.zeros_like(leaves[i]) if tg is None else tg
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=tol, atol=tol,
                                   err_msg=f"gradient of input {i}")


def test_every_ported_op_is_held_against_jax():
    covered = {p.values[0] for p in OP_CASES}
    assert set(tops.OPS) <= covered, sorted(set(tops.OPS) - covered)
    assert set(tops.OPS) <= set(jops.OPS)  # the port adds no op
    assert tops.RNG_OPS == jops.RNG_OPS


def test_binary_ops_promote_as_jnp():
    """``bf16 * f32[0-d]`` is float32 in jnp (a graph's operands are all
    arrays), where torch would keep bfloat16; an int with a float too."""
    x = np.random.default_rng(0).normal(0, 1, (3, 4)).astype(np.float32)
    half = np.asarray(0.5, np.float32)
    for op in ("add", "sub", "mul", "div", "squared_difference", "pow"):
        want = jops.get_op(op)(jnp.asarray(x, jnp.bfloat16), jnp.asarray(half))
        got = tops.get_op(op)(torch.from_numpy(x).bfloat16(), torch.from_numpy(half))
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ids = np.arange(6, dtype=np.int32).reshape(2, 3)
    got = tops.get_op("mul")(torch.from_numpy(ids), torch.from_numpy(half))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.get_op("mul")(jnp.asarray(ids), jnp.asarray(half))))


def test_unported_ops_raise_by_name():
    sd = SameDiff.create()
    x = sd.placeholder("x", (2, 3))
    for call, name in ((lambda: sd.math.cholesky(x), "cholesky"),
                       (lambda: sd.invoke("conv2d", x, x), "conv2d"),
                       (lambda: sd.nn.batch_norm(x, x, x), "batch_norm"),
                       (lambda: sd.random.random_normal(shape=(2, 3)), "random_normal")):
        with pytest.raises(NotImplementedError, match=name):
            call()
    with pytest.raises(NotImplementedError, match="export_stablehlo"):
        sd.export_stablehlo({"x": np.zeros((2, 3), np.float32)}, "x")


def test_archive_with_an_unported_op_raises_by_name_when_run(tmp_path):
    jsd = JSameDiff.create()
    x = jsd.placeholder("x", (2, 3))
    jsd.math.cumsum(x, axis=1, name="c")
    path = str(tmp_path / "c.sdz")
    jsd.save(path)
    sd = SameDiff.load(path)  # loads: ops are data
    assert [n.op for n in sd.ops] == ["cumsum"]
    with pytest.raises(NotImplementedError, match="cumsum"):
        sd.output({"x": np.ones((2, 3), np.float32)}, "c")


# ------------------------------------------------- scenarios (port alone)
def _mlp_graph(sd_cls=SameDiff):
    sd = sd_cls.create()
    x = sd.placeholder("x", (None, 4))
    labels = sd.placeholder("labels", (None, 3))
    w0 = sd.var("w0", (4, 16))
    b0 = sd.var("b0", (16,), weight_init="zero")
    h = sd.nn.tanh(x @ w0 + b0, name="h")
    w1 = sd.var("w1", (16, 3))
    b1 = sd.var("b1", (3,), weight_init="zero")
    logits = sd.nn.linear(h, w1, b1, name="logits")
    sd.nn.softmax(logits, name="probs")
    sd.loss.softmax_cross_entropy("loss", labels, logits)
    sd.set_loss_variables("loss")
    return sd


def _toy(n=128, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 2.0, (3, 4))
    y = rng.integers(0, 3, n)
    x = (centers[y] + rng.normal(0, 0.5, (n, 4))).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[y]


def _config(updater, sd=None):
    return TrainingConfig(updater=updater, data_set_feature_mapping=["x"],
                          data_set_label_mapping=["labels"])


def test_forward_matches_numpy():
    sd = _mlp_graph()
    x, _ = _toy(8)
    probs = sd.output({"x": x}, "probs").numpy()
    w0, b0, w1, b1 = (sd.arrays[n].numpy() for n in ("w0", "b0", "w1", "b1"))
    logits = np.tanh(x @ w0 + b0) @ w1 + b1
    e = np.exp(logits - logits.max(-1, keepdims=True))
    np.testing.assert_allclose(probs, e / e.sum(-1, keepdims=True), rtol=1e-5)


def test_fit_learns():
    sd = _mlp_graph()
    sd.set_training_config(_config(Adam(5e-2)))
    x, y = _toy(256)
    history = sd.fit(x, y, epochs=60)
    assert history[-1] < history[0] * 0.3, f"{history[0]} -> {history[-1]}"
    acc = (sd.output({"x": x}, "probs").numpy().argmax(-1) == y.argmax(-1)).mean()
    assert acc > 0.9


def test_gradients_match_finite_differences():
    sd = _mlp_graph()
    x, y = _toy(16)
    grads = sd.calculate_gradients({"x": x, "labels": y}, "w1", "b1")

    def loss_at(w1):
        saved = sd.arrays["w1"]
        sd.arrays["w1"] = torch.from_numpy(w1)
        out = float(sd.output({"x": x, "labels": y}, "loss"))
        sd.arrays["w1"] = saved
        return out

    w1 = sd.arrays["w1"].numpy().copy()
    eps = 1e-3
    for idx in [(0, 0), (7, 2), (15, 1)]:
        wp, wm = w1.copy(), w1.copy()
        wp[idx] += eps
        wm[idx] -= eps
        fd = (loss_at(wp) - loss_at(wm)) / (2 * eps)
        an = float(grads["w1"][idx])
        assert abs(fd - an) < 1e-2 * max(1.0, abs(fd)), f"{idx}: fd={fd} an={an}"


def test_save_load_roundtrip(tmp_path):
    sd = _mlp_graph()
    x, _ = _toy(8)
    before = sd.output({"x": x}, "probs").numpy()
    path = str(tmp_path / "model.sdz")
    sd.save(path)
    np.testing.assert_array_equal(SameDiff.load(path).output({"x": x}, "probs").numpy(), before)


def test_op_sugar_and_eval():
    sd = SameDiff.create()
    a = sd.constant("a", np.array([1.0, 2.0, 3.0], np.float32))
    b = sd.constant("b", np.array([10.0, 20.0, 30.0], np.float32))
    c = (a + b) * 2.0 - 3.0
    np.testing.assert_allclose(c.eval().numpy(), [19.0, 41.0, 63.0])
    assert float(a.sum().eval()) == 6.0
    d = (1.0 - a) / 2.0
    np.testing.assert_allclose(d.eval().numpy(), [0.0, -0.5, -1.0])
    e = (-a) ** 2.0
    np.testing.assert_allclose(e.eval().numpy(), [1.0, 4.0, 9.0])
    assert (a > 1.5).eval().tolist() == [False, True, True]
    assert (a < 2.5).eval().tolist() == [True, True, False]
    np.testing.assert_allclose(a.mean().eval().numpy(), 2.0)
    np.testing.assert_allclose(a.std().eval().numpy(), np.std([1.0, 2.0, 3.0]), rtol=1e-6)
    m = sd.constant("m", np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_array_equal(m.transpose().eval().numpy(),
                                  np.arange(6, dtype=np.float32).reshape(2, 3).T)
    np.testing.assert_array_equal(m.reshape(3, 2).mmul(m).eval().numpy().shape, (3, 3))
    assert isinstance(a.get_arr(), torch.Tensor)


def test_multi_output_ops():
    sd = SameDiff.create()
    a = sd.constant("a", np.arange(12, dtype=np.float32).reshape(4, 3))
    parts = sd.invoke("split", a, num_splits=2, axis=0, n_outputs=2)
    np.testing.assert_allclose(parts[0].eval().numpy(),
                               np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_allclose(parts[1].eval().numpy(),
                               np.arange(6, 12, dtype=np.float32).reshape(2, 3))
    both = sd.output({}, [parts[0].name, parts[1].name])
    assert isinstance(both, dict) and both[parts[1].name].shape == (2, 3)


def test_fit_history_listeners_and_evaluate():
    from deeplearning4j_tpu_torch.data import NumpyDataSetIterator
    from deeplearning4j_tpu_torch.evaluation import Evaluation
    rng = np.random.default_rng(0)
    yc = rng.integers(0, 3, 120)
    x = (np.eye(3)[yc] @ rng.normal(0, 1, (3, 6)) * 2
         + rng.normal(0, 0.3, (120, 6))).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[yc]
    sd = SameDiff.create()
    xin = sd.placeholder("x", (None, 6))
    w = sd.var("w", (6, 3))
    b = sd.var("b", array=np.zeros(3, np.float32))
    logits = sd.invoke("linear", xin, w, b, name="logits")
    sd.nn.softmax(logits, name="probs")
    labels = sd.placeholder("labels", (None, 3))
    sd.loss.softmax_cross_entropy("loss", labels, logits)
    sd.set_loss_variables("loss")
    sd.set_training_config(_config(Adam(5e-2)))
    seen = []

    class L:
        def iteration_done(self, sd_, it, ep, loss):
            seen.append((it, ep))

    sd.set_listeners(L())
    it = NumpyDataSetIterator(x, y, batch_size=40)
    hist = sd.fit(it, epochs=4)
    assert isinstance(hist, History)
    assert len(hist) == 12 and len(hist.epoch_losses()) == 4
    assert hist.epoch_losses()[-1] < hist.epoch_losses()[0]
    assert hist.final_loss() == hist[-1] and hist.loss_curve() == list(hist)
    assert seen[-1] == (12, 3) and len(seen) == 12
    assert sd.evaluate(it, "probs", Evaluation()).accuracy() > 0.9


def _lr0_fit_losses(build, steps=3):
    sd, feed_name, label_name = build()
    sd.set_training_config(TrainingConfig(updater=Sgd(0.0), data_set_feature_mapping=[feed_name],
                                          data_set_label_mapping=[label_name]))
    x = np.random.default_rng(0).normal(0, 1, (16, 8)).astype(np.float32)
    y = np.zeros((16, 1), np.float32)
    losses = []
    for _ in range(steps):
        losses.extend(sd.fit(x, y, epochs=1))
    return losses


def test_dropout_active_in_fit_and_identity_at_inference():
    def build():
        sd = SameDiff.create()
        xin = sd.placeholder("x", (None, 8))
        w = sd.var("w", (8, 1))
        h = sd.nn.dropout(xin, rate=0.5, name="h")
        labels = sd.placeholder("labels", (None, 1))
        sd.loss.mean_squared_error("loss", labels, h.mmul(w))
        sd.set_loss_variables("loss")
        return sd, "x", "labels"

    losses = _lr0_fit_losses(build)
    assert len(set(np.round(losses, 10))) > 1 and all(np.isfinite(losses)), losses
    sd, _, _ = build()
    x = np.random.default_rng(1).normal(0, 1, (4, 8)).astype(np.float32)
    np.testing.assert_array_equal(sd.output({"x": x}, "h").numpy(), x)


def test_no_rng_deterministic_fit():
    def build():
        sd = SameDiff.create()
        xin = sd.placeholder("x", (None, 8))
        w = sd.var("w", (8, 1))
        labels = sd.placeholder("labels", (None, 1))
        sd.loss.mean_squared_error("loss", labels, xin.mmul(w))
        sd.set_loss_variables("loss")
        return sd, "x", "labels"

    losses = _lr0_fit_losses(build)
    assert len(set(np.round(losses, 8))) == 1, losses


def test_two_dropout_nodes_distinct_masks():
    sd = SameDiff.create()
    xin = sd.placeholder("x", (None, 64))
    d1 = sd.nn.dropout(xin, rate=0.5)
    d2 = sd.nn.dropout(xin, rate=0.5)
    diff = (d1 - d2) * (d1 - d2)
    labels = sd.placeholder("labels", (None, 64))
    sd.loss.mean_squared_error("loss", labels, diff)
    sd.set_loss_variables("loss")
    sd.set_training_config(TrainingConfig(updater=Sgd(0.0), data_set_feature_mapping=["x"],
                                          data_set_label_mapping=["labels"]))
    losses = sd.fit(np.ones((4, 64), np.float32), np.zeros((4, 64), np.float32), epochs=1)
    assert losses[0] > 0.0, losses


def test_control_flow_cond_and_while_loop():
    """``cond`` and ``while_loop`` as plain Python over tensors: the values
    of JAX's ``lax.cond``/``lax.while_loop``/masked scan on the same
    carries, the bounded loop differentiable, the unbounded one
    forward-only, as in JAX."""
    sd = SameDiff.create()
    p = sd.placeholder("p", ())
    x = sd.placeholder("x", (3,))
    c = sd.cond(p, lambda a: a * 2.0, lambda a: a - 1.0, x, name="c")
    i, acc = sd.while_loop(lambda i, a: i < 3, lambda i, a: (i + 1, a * 2.0),
                           sd.constant(0), x, name="w")
    _, bacc = sd.while_loop(lambda i, a: i < 2, lambda i, a: (i + 1, a * 3.0),
                            sd.constant(0), x, name="b", max_iterations=4)
    xv = np.array([1.0, 2.0, 3.0], np.float32)
    np.testing.assert_allclose(sd.output({"p": np.asarray(True), "x": xv}, c.name).numpy(),
                               xv * 2)
    np.testing.assert_allclose(sd.output({"p": np.asarray(False), "x": xv}, c.name).numpy(),
                               xv - 1)
    np.testing.assert_allclose(sd.output({"x": xv}, acc.name).numpy(), xv * 8)
    assert int(sd.output({"x": xv}, i.name)) == 3
    np.testing.assert_allclose(sd.output({"x": xv}, bacc.name).numpy(), xv * 9)
    v = sd.var("v", array=xv)
    _, vb = sd.while_loop(lambda i, a: i < 2, lambda i, a: (i + 1, a * 3.0),
                          sd.constant(0), v, name="vb", max_iterations=4)
    _, vw = sd.while_loop(lambda i, a: i < 2, lambda i, a: (i + 1, a * 3.0),
                          sd.constant(0), v, name="vw")
    sd.set_loss_variables(vb.name)
    np.testing.assert_allclose(sd.calculate_gradients({}, "v")["v"].numpy(), np.full(3, 9.0))
    sd.set_loss_variables(vw.name)
    with pytest.raises(ValueError, match="max_iterations"):
        sd.calculate_gradients({}, "v")
    with pytest.raises(ValueError, match="not serializable"):
        sd.to_dict()


def test_exact_resume_with_dropout(tmp_path):
    def build():
        sd = SameDiff.create()
        xin = sd.placeholder("x", (None, 8))
        w = sd.var("w", (8, 1))
        h = sd.nn.dropout(xin, rate=0.5)
        labels = sd.placeholder("labels", (None, 1))
        sd.loss.mean_squared_error("loss", labels, h.mmul(w))
        sd.set_loss_variables("loss")
        sd.set_training_config(_config(Adam(1e-2)))
        return sd

    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (16, 8)).astype(np.float32)
    y = rng.normal(0, 1, (16, 1)).astype(np.float32)
    full_sd = build()
    full = list(full_sd.fit(x, y, epochs=6))
    sd_a = build()
    first = list(sd_a.fit(x, y, epochs=3))
    path = str(tmp_path / "resume.sdz")
    sd_a.save(path, save_updater_state=True)
    sd_b = SameDiff.load(path)
    second = list(sd_b.fit(x, y, epochs=3))
    np.testing.assert_array_equal(np.asarray(first + second), np.asarray(full))
    np.testing.assert_array_equal(full_sd.arrays["w"].numpy(), sd_b.arrays["w"].numpy())


def test_save_without_updater_still_restores_rng_position(tmp_path):
    sd = _mlp_graph()
    sd.set_training_config(_config(Adam(5e-2)))
    x, y = _toy(32)
    sd.fit(x, y, epochs=4)
    path = str(tmp_path / "plain.sdz")
    sd.save(path)
    sd2 = SameDiff.load(path)
    assert sd2._train_iter == sd._train_iter == 4
    np.testing.assert_array_equal(sd2._rng_key, sd._rng_key)
    assert sd2._opt_state is None


def test_entry_points_resolve_to_cuda_unless_asked(monkeypatch):
    get_environment().set_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SameDiff.create()
    assert SameDiff.create(device="cpu").device.type == "cpu"


# ------------------------------------------- the JAX graph through archives
def _jax_mlp(tmp_path):
    jsd = _mlp_graph(JSameDiff)
    jsd.set_training_config(JTrainingConfig(updater=JAdam(5e-2), data_set_feature_mapping=["x"],
                                            data_set_label_mapping=["labels"]))
    path = str(tmp_path / "jax.sdz")
    jsd.save(path)
    return jsd, path


def _assert_arrays(sd, jsd, rtol=1e-5, atol=1e-5):
    assert list(sd.arrays) == list(jsd.arrays)
    for n, a in jsd.arrays.items():
        np.testing.assert_allclose(sd.arrays[n].numpy(), np.asarray(a), rtol=rtol, atol=atol,
                                   err_msg=n)


def test_jax_graph_outputs_and_gradients_in_the_port(tmp_path):
    jsd, path = _jax_mlp(tmp_path)
    sd = SameDiff.load(path)
    assert [(v.name, v.vtype.value, v.shape) for v in sd.vars.values()] == \
        [(v.name, v.vtype.value, v.shape) for v in jsd.vars.values()]
    assert [(n.op, n.inputs, n.outputs) for n in sd.ops] == \
        [(n.op, n.inputs, n.outputs) for n in jsd.ops]
    x, y = _toy(16, seed=5)
    for name in ("h", "logits", "probs"):
        np.testing.assert_allclose(sd.output({"x": x}, name).numpy(),
                                   np.asarray(jsd.output({"x": x}, name)), rtol=1e-5,
                                   atol=1e-5)
    got = sd.output({"x": x, "labels": y}, ["probs", "loss"])
    want = jsd.output({"x": x, "labels": y}, ["probs", "loss"])
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-6)
    tg = sd.calculate_gradients({"x": x, "labels": y})
    jg = jsd.calculate_gradients({"x": x, "labels": y})
    assert sorted(tg) == sorted(jg)
    for n in jg:
        np.testing.assert_allclose(tg[n].numpy(), np.asarray(jg[n]), rtol=1e-5, atol=1e-6)


def test_jax_graph_fits_alike_and_archives_resume_both_ways(tmp_path):
    """Five Adam steps from one JAX archive in both packages (losses,
    weights, Adam's count/mu/nu in optax's leaf order); then the port's
    archive resumes in JAX and JAX's in the port, each two more steps alike
    (l2 on, so the penalty's order is held too)."""
    from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
    jsd, _ = _jax_mlp(tmp_path)
    jsd.set_training_config(JTrainingConfig(updater=JAdam(5e-2), data_set_feature_mapping=["x"],
                                            data_set_label_mapping=["labels"], l2=1e-3))
    path = str(tmp_path / "l2.sdz")
    jsd.save(path)
    sd = SameDiff.load(path)
    assert sd.training_config.l2 == 1e-3
    batches = [_toy(32, seed=s) for s in range(7)]
    jl = [float(jsd.fit(x, y)[0]) for x, y in batches[:5]]
    tl = [float(sd.fit(x, y)[0]) for x, y in batches[:5]]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    _assert_arrays(sd, jsd)
    jleaves = jax.tree.leaves(jsd._opt_state)
    tleaves = tree_leaves(sd._opt_state)
    assert [(tuple(np.shape(a)), np.asarray(a).dtype.name) for a in jleaves] == \
        [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in tleaves]
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    p_port, p_jax = str(tmp_path / "port.sdz"), str(tmp_path / "jax5.sdz")
    sd.save(p_port, save_updater_state=True)
    jsd.save(p_jax, save_updater_state=True)
    j2, t2 = JSameDiff.load(p_port), SameDiff.load(p_jax)
    assert j2._train_iter == t2._train_iter == 5
    for x, y in batches[5:]:
        jl2 = float(j2.fit(x, y)[0])
        tl2 = float(t2.fit(x, y)[0])
        np.testing.assert_allclose(tl2, jl2, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(sd.fit(x, y)[0]), float(jsd.fit(x, y)[0]),
                                   rtol=1e-5, atol=1e-6)
    _assert_arrays(t2, j2)
    _assert_arrays(sd, j2)
