"""The port's graph optimizer against the JAX package's on the same graphs.

Each graph is a TF function frozen and imported by the JAX package's
``TFGraphMapper`` without optimization, saved with ``sd.save`` and loaded
by the port, so both packages start from one op list. Then the JAX
package's passes run on its graph and the port's on its own: the fusion
counts, the rewritten op sequence (op, inputs, outputs, attrs) and the
outputs must agree, and the port's outputs after its passes must equal its
outputs before them. The cases are ``tests/test_graph_optimizer.py``'s:
LayerNorm + gelu, extra consumers, the BERT block counts, attention with
the padding bias proven, a general bias kept additive, rank-3 single head,
a fully masked row, ``mul(const, qk)``, and the layout passes (2-D matmul
round trips, a reshape with two consumers, the attention chain, a dynamic
batch).

Float32; outputs 1e-5 between the packages (2e-5 relative for BERT's
pooler through two layers), the port before against after its passes as
the JAX tests hold the JAX package.
"""

import json

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from deeplearning4j_tpu.autodiff import graph_optimizer as jgo  # noqa: E402
from deeplearning4j_tpu.imports import TFGraphMapper  # noqa: E402
from deeplearning4j_tpu.imports.tf_oracles import (bert_synthetic_batch,  # noqa: E402
                                                   build_bert_graphdef)
from deeplearning4j_tpu_torch.autodiff import graph_optimizer as tgo  # noqa: E402
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff  # noqa: E402
from deeplearning4j_tpu_torch.runtime.environment import get_environment  # noqa: E402


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _frozen(fn, specs):
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    conc = tf.function(fn).get_concrete_function(*specs)
    frozen = convert_variables_to_constants_v2(conc)
    return (frozen.graph.as_graph_def(),
            [t.name.split(":")[0] for t in frozen.inputs],
            [t.name.split(":")[0] for t in frozen.outputs])


def _both(gd, tmp_path, loss=None):
    """The JAX import without optimization and the port's load of its
    archive."""
    jsd = TFGraphMapper.import_graph(gd, optimize=False)
    if loss is not None:
        jsd.set_loss_variables(loss)
    path = str(tmp_path / "imported.sdz")
    jsd.save(path)
    return jsd, SameDiff.load(path)


def _op_list(sd):
    return [(n.op, list(n.inputs), list(n.outputs),
             json.loads(json.dumps(n.attrs, default=lambda v: np.asarray(v).tolist())))
            for n in sd.ops]


def _optimize_both(jsd, sd, passes="optimize"):
    js = getattr(jgo, passes)(jsd)
    ts = getattr(tgo, passes)(sd)
    assert ts == js
    assert _op_list(sd) == _op_list(jsd)
    assert set(sd.vars) == set(jsd.vars)
    return ts


def _out(sd, feeds, name):
    o = sd.output(feeds, name)
    return o.numpy() if hasattr(o, "numpy") else np.asarray(o)


def test_layernorm_and_gelu_fusion(tmp_path):
    rng = np.random.default_rng(0)
    D = 16
    g = tf.constant(rng.normal(1, 0.1, (D,)).astype(np.float32))
    b = tf.constant(rng.normal(0, 0.1, (D,)).astype(np.float32))

    def model(x):
        mean = tf.reduce_mean(x, axis=-1, keepdims=True)
        var = tf.reduce_mean(tf.math.squared_difference(x, mean), axis=-1, keepdims=True)
        y = (x - mean) * tf.math.rsqrt(var + 1e-12) * g + b
        return 0.5 * y * (1.0 + tf.math.erf(y / np.float32(np.sqrt(2.0))))

    gd, inputs, outputs = _frozen(model, [tf.TensorSpec((4, D), tf.float32, name="x")])
    x = rng.normal(0, 2, (4, D)).astype(np.float32)
    jsd, sd = _both(gd, tmp_path)
    before = _out(sd, {inputs[0]: x}, outputs[0])
    n_before = len(sd.ops)
    stats = _optimize_both(jsd, sd)
    assert stats["layer_norm"] == 1 and stats["gelu_erf"] == 1, stats
    assert len(sd.ops) < n_before - 8
    after = _out(sd, {inputs[0]: x}, outputs[0])
    np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(after, _out(jsd, {inputs[0]: x}, outputs[0]), rtol=1e-5,
                               atol=1e-6)
    ops = [n.op for n in sd.ops]
    assert "layer_norm" in ops and "gelu" in ops and "erf" not in ops


def test_fusion_respects_extra_consumers(tmp_path):
    def model(x):
        mean = tf.reduce_mean(x, axis=-1, keepdims=True)
        var = tf.reduce_mean(tf.math.squared_difference(x, mean), axis=-1, keepdims=True)
        y = (x - mean) * tf.math.rsqrt(var + 1e-12) * 2.0 + 0.5
        return y, mean

    gd, _, outputs = _frozen(model, [tf.TensorSpec((2, 8), tf.float32, name="x")])
    jsd, sd = _both(gd, tmp_path, loss=outputs[1])
    assert sd.loss_variables == [outputs[1]]
    assert _optimize_both(jsd, sd)["layer_norm"] == 0


@pytest.fixture(scope="module")
def bert_graph():
    gd, inputs, _, _ = build_bert_graphdef(batch=2, seq_len=16, hidden=32, layers=2, heads=2,
                                           intermediate=64, vocab=50)
    ids, types, m, _ = bert_synthetic_batch(2, 16, 50)
    return gd, dict(zip(inputs, [ids, types, m]))


def test_bert_fusion_counts_op_sequence_and_outputs(bert_graph, tmp_path):
    gd, feeds = bert_graph
    jsd, sd = _both(gd, tmp_path)
    before = _out(sd, feeds, "pooled_output")
    np.testing.assert_allclose(before, _out(jsd, feeds, "pooled_output"), rtol=1e-5, atol=1e-5)
    stats = _optimize_both(jsd, sd)
    assert (stats["layer_norm"], stats["gelu_erf"], stats["attention"]) == (5, 2, 2), stats
    sdpa = [n for n in sd.ops if n.op == "scaled_dot_product_attention"]
    assert len(sdpa) == 2 and all(n.attrs["boolean_bias"] for n in sdpa)
    assert not any(n.op == "softmax" for n in sd.ops)
    for name in ("pooled_output", "sequence_output"):
        after = _out(sd, feeds, name)
        np.testing.assert_allclose(after, _out(jsd, feeds, name), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(_out(sd, feeds, "pooled_output"), before, rtol=1e-4, atol=1e-5)


def test_shape_inference_matches_jax(bert_graph, tmp_path):
    """``infer_shapes`` on meta tensors gives the JAX package's
    ``eval_shape`` shapes for every op output of the imported BERT, before
    and after the fusions."""
    gd, _ = bert_graph
    jsd, sd = _both(gd, tmp_path)
    for _ in range(2):
        js, ts = jgo.infer_shapes(jsd), tgo.infer_shapes(sd)
        outs = [o for n in jsd.ops for o in n.outputs]
        assert {o: tuple(js[o]) for o in outs} == {o: tuple(ts[o]) for o in outs}
        jgo.fuse_layer_norm(jsd), jgo.fuse_gelu_erf(jsd), jgo.fuse_attention(jsd)
        tgo.fuse_layer_norm(sd), tgo.fuse_gelu_erf(sd), tgo.fuse_attention(sd)


def test_attention_fusion_general_bias_stays_additive(tmp_path):
    rng = np.random.default_rng(0)
    B, H, T, D = 2, 2, 8, 4
    bias_c = tf.constant(rng.normal(0, 1, (B, H, T, T)).astype(np.float32))

    def model(q, k, v):
        s = tf.matmul(q, k, transpose_b=True) / np.float32(np.sqrt(D))
        return tf.matmul(tf.nn.softmax(s + bias_c, axis=-1), v)

    spec = [tf.TensorSpec((B, H, T, D), tf.float32, name=n) for n in "qkv"]
    gd, inputs, outputs = _frozen(model, spec)
    jsd, sd = _both(gd, tmp_path)
    feeds = dict(zip(inputs, (rng.normal(0, 1, (B, H, T, D)).astype(np.float32)
                              for _ in range(3))))
    before = _out(sd, feeds, outputs[0])
    assert _optimize_both(jsd, sd)["attention"] == 1
    sdpa = [n for n in sd.ops if n.op == "scaled_dot_product_attention"]
    assert len(sdpa) == 1 and not sdpa[0].attrs["boolean_bias"]
    after = _out(sd, feeds, outputs[0])
    np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(after, _out(jsd, feeds, outputs[0]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("spelling", ["rank3_div", "mul_const_first"])
def test_attention_fusion_other_spellings(spelling, tmp_path):
    rng = np.random.default_rng(1)
    shape = (2, 8, 4) if spelling == "rank3_div" else (1, 2, 8, 4)
    D = shape[-1]

    def model(q, k, v):
        if spelling == "rank3_div":
            s = tf.matmul(q, k, transpose_b=True) / np.float32(np.sqrt(D))
        else:
            s = np.float32(1.0 / np.sqrt(D)) * tf.matmul(q, k, transpose_b=True)
        return tf.matmul(tf.nn.softmax(s, axis=-1), v)

    gd, inputs, outputs = _frozen(model, [tf.TensorSpec(shape, tf.float32, name=n)
                                          for n in "qkv"])
    jsd, sd = _both(gd, tmp_path)
    feeds = dict(zip(inputs, (rng.normal(0, 1, shape).astype(np.float32) for _ in range(3))))
    before = _out(sd, feeds, outputs[0])
    assert _optimize_both(jsd, sd)["attention"] == 1
    after = _out(sd, feeds, outputs[0])
    np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(after, _out(jsd, feeds, outputs[0]), rtol=1e-5, atol=1e-6)


def test_attention_fusion_fully_masked_row(tmp_path):
    gd, inputs, _, _ = build_bert_graphdef(batch=2, seq_len=8, hidden=16, layers=1, heads=2,
                                           intermediate=32, vocab=30)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 30, (2, 8)).astype(np.int32)
    mask = np.stack([np.ones(8), np.zeros(8)]).astype(np.int32)  # row 2 all padding
    feeds = dict(zip(inputs, [ids, np.zeros((2, 8), np.int32), mask]))
    jsd, sd = _both(gd, tmp_path)
    before = _out(sd, feeds, "pooled_output")
    _optimize_both(jsd, sd)
    after = _out(sd, feeds, "pooled_output")
    assert np.isfinite(after).all()
    np.testing.assert_allclose(after, before, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(after, _out(jsd, feeds, "pooled_output"), rtol=1e-5, atol=1e-5)


def test_layout_passes_fold_2d_matmul_roundtrips(tmp_path):
    rng = np.random.default_rng(0)
    B, T, H, K = 2, 8, 16, 12
    W = rng.normal(0, 0.1, (H, K)).astype(np.float32)
    b = rng.normal(0, 0.1, (K,)).astype(np.float32)
    W2 = rng.normal(0, 0.1, (K, H)).astype(np.float32)

    def model(x):
        h = tf.nn.relu(tf.matmul(tf.reshape(x, (B * T, H)), W) + b)
        return tf.reshape(tf.matmul(h, W2), (B, T, H)) + x

    gd, _, outputs = _frozen(model, [tf.TensorSpec((B, T, H), tf.float32, name="x")])
    x = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    jsd, sd = _both(gd, tmp_path)
    before = _out(sd, {"x": x}, outputs[0])
    stats = _optimize_both(jsd, sd, "optimize_layout")
    assert stats["layout_folds"] == 2 and stats["reshape_sinks"] >= 2, stats
    after = _out(sd, {"x": x}, outputs[0])
    np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(after, _out(jsd, {"x": x}, outputs[0]), rtol=1e-5, atol=1e-6)


def test_layout_passes_keep_multi_consumer_reshapes(tmp_path):
    rng = np.random.default_rng(1)
    B, T, H = 2, 4, 8
    W = rng.normal(0, 0.1, (H, H)).astype(np.float32)

    def model(x):
        flat = tf.reshape(x, (B * T, H))  # two consumers
        return tf.matmul(flat, W) + flat

    gd, _, outputs = _frozen(model, [tf.TensorSpec((B, T, H), tf.float32, name="x")])
    x = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    jsd, sd = _both(gd, tmp_path)
    before = _out(sd, {"x": x}, outputs[0])
    _optimize_both(jsd, sd)
    np.testing.assert_allclose(_out(sd, {"x": x}, outputs[0]), before, rtol=1e-5, atol=1e-6)


def test_layout_passes_attention_chain(tmp_path):
    rng = np.random.default_rng(2)
    B, T, H, heads = 2, 8, 16, 4
    dk = H // heads
    Wq, Wk, Wv = (rng.normal(0, 0.1, (H, H)).astype(np.float32) for _ in range(3))

    def proj(x2, W):
        return tf.transpose(tf.reshape(tf.matmul(x2, W), (B, T, heads, dk)), (0, 2, 1, 3))

    def model(x):
        x2 = tf.reshape(x, (B * T, H))
        q, k, v = proj(x2, Wq), proj(x2, Wk), proj(x2, Wv)
        s = tf.matmul(q, k, transpose_b=True) / np.float32(np.sqrt(dk))
        ctx = tf.matmul(tf.nn.softmax(s, axis=-1), v)
        return tf.reshape(tf.transpose(ctx, (0, 2, 1, 3)), (B, T, H))

    gd, _, outputs = _frozen(model, [tf.TensorSpec((B, T, H), tf.float32, name="x")])
    x = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    jsd, sd = _both(gd, tmp_path)
    before = _out(sd, {"x": x}, outputs[0])
    _optimize_both(jsd, sd)
    assert "scaled_dot_product_attention" in [n.op for n in sd.ops]
    after = _out(sd, {"x": x}, outputs[0])
    np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(after, _out(jsd, {"x": x}, outputs[0]), rtol=1e-5, atol=1e-6)


def test_layout_passes_dynamic_batch_stays_dynamic(tmp_path):
    rng = np.random.default_rng(3)
    T, H = 4, 8
    W = rng.normal(0, 0.1, (H, H)).astype(np.float32)
    b = rng.normal(0, 0.1, (H,)).astype(np.float32)

    def model(x):
        return tf.reshape(tf.matmul(tf.reshape(x, (-1, H)), W) + b, (-1, T, H))

    gd, _, outputs = _frozen(model, [tf.TensorSpec((None, T, H), tf.float32, name="x")])
    jsd, sd = _both(gd, tmp_path)
    befores = {B: _out(sd, {"x": x}, outputs[0]) for B, x in
               ((B, rng.normal(0, 1, (B, T, H)).astype(np.float32)) for B in (2, 5))}
    xs = {B: rng.normal(0, 1, (B, T, H)).astype(np.float32) for B in (2, 5)}
    sd0 = SameDiff.load(str(tmp_path / "imported.sdz"))
    _optimize_both(jsd, sd)
    for B in (2, 5):
        np.testing.assert_allclose(_out(sd, {"x": xs[B]}, outputs[0]),
                                   _out(sd0, {"x": xs[B]}, outputs[0]), rtol=1e-5, atol=1e-6)
        assert befores[B].shape == (B, T, H)


def test_fold_shape_chains_rewrites_reshape_dynamic():
    """A computed reshape target (``shape_of`` arithmetic, the importer's
    ``reshape_dynamic``) folds to a static ``reshape``, with the
    batch-dependent entry as -1 (two inference runs with different
    substituted batch dims), in both packages alike."""
    from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff

    def build(cls):
        sd = cls.create()
        x = sd.placeholder("x", (None, 3, 4))
        s = sd.invoke("shape_of", x, name="s")
        tail = sd.constant("tail", np.asarray([12], np.int32))
        head = sd.invoke("strided_slice", s, name="head", begin=[0], end=[1], strides=[1])
        target = sd.invoke("concat", head, tail, name="target", axis=0)
        sd.invoke("reshape_dynamic", x, target, name="flat")
        return sd

    jsd, sd = build(JSameDiff), build(SameDiff)
    assert jgo.fold_shape_chains(jsd) == tgo.fold_shape_chains(sd) == 1
    assert _op_list(sd) == _op_list(jsd)
    flat = [n for n in sd.ops if n.outputs == ["flat"]][0]
    assert flat.op == "reshape" and flat.attrs == {"shape": [-1, 12]}
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    np.testing.assert_array_equal(_out(sd, {"x": x}, "flat"), x.reshape(2, 12))
