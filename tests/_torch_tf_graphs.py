"""The TF graphs of ``tests/test_imports.py``'s TensorFlow cases, built once
per process for the port's importer tests (``test_torch_tf_import.py``)
and its GraphDef reader's (``test_torch_graphdef_proto.py``).

Each builder makes the case's graph with tensorflow as the JAX package's
test does and returns a dict: ``gd`` (the GraphDef), ``out`` (the output
node names), ``feeds`` (numpy feed dicts) and ``want`` (TF's outputs for
each feed), plus ``kw`` (``import_graph`` keywords) where the case needs
them. The key names the ``test_imports.py`` line of the case."""

import functools

import numpy as np
import tensorflow as tf


def frozen_graphdef(fn, input_specs):
    """Trace ``fn`` to a frozen (constant-folded) GraphDef."""
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    conc = tf.function(fn).get_concrete_function(*input_specs)
    frozen = convert_variables_to_constants_v2(conc)
    return (frozen.graph.as_graph_def(), [t.name.split(":")[0] for t in frozen.inputs],
            [t.name.split(":")[0] for t in frozen.outputs])


def functional_graphdef(fn, input_specs):
    """Trace ``fn`` keeping functional control flow (While/If)."""
    conc = tf.function(fn).get_concrete_function(*input_specs)
    return (conc.graph.as_graph_def(), [t.name.split(":")[0] for t in conc.inputs],
            [t.name.split(":")[0] for t in conc.outputs])


def _case(model, gd, inputs, outputs, xs, **kw):
    feeds = [{inputs[0]: x} for x in xs]
    want = [[model(tf.constant(x)).numpy()] for x in xs]
    return dict(gd=gd, out=outputs[:1], feeds=feeds, want=want, **kw)


def mlp():  # test_imports.py:33
    w1 = tf.constant(np.random.default_rng(0).normal(0, 1, (8, 16)).astype(np.float32))
    b1 = tf.constant(np.zeros(16, np.float32))
    w2 = tf.constant(np.random.default_rng(1).normal(0, 1, (16, 3)).astype(np.float32))

    def model(x):
        h = tf.nn.relu(tf.matmul(x, w1) + b1)
        return tf.nn.softmax(tf.matmul(h, w2))

    gd, i, o = frozen_graphdef(model, [tf.TensorSpec((None, 8), tf.float32, name="x")])
    return _case(model, gd, i, o, [np.random.default_rng(2).normal(0, 1, (4, 8))
                                   .astype(np.float32)])


def attention_block():  # :52
    rng = np.random.default_rng(0)
    D, H = 16, 4
    wq, wk, wv = (tf.constant(rng.normal(0, 0.1, (D, D)).astype(np.float32)) for _ in range(3))
    gamma = tf.constant(np.ones(D, np.float32))
    beta = tf.constant(np.zeros(D, np.float32))

    def block(x):
        q = tf.transpose(tf.reshape(x @ wq, (2, 8, H, D // H)), (0, 2, 1, 3))
        k = tf.transpose(tf.reshape(x @ wk, (2, 8, H, D // H)), (0, 2, 1, 3))
        v = tf.transpose(tf.reshape(x @ wv, (2, 8, H, D // H)), (0, 2, 1, 3))
        s = tf.matmul(q, k, transpose_b=True) / tf.sqrt(float(D // H))
        a = tf.matmul(tf.nn.softmax(s, axis=-1), v)
        a = tf.reshape(tf.transpose(a, (0, 2, 1, 3)), (2, 8, D))
        y = x + a
        mean, var = tf.nn.moments(y, axes=[-1], keepdims=True)
        y = (y - mean) * tf.math.rsqrt(var + 1e-6) * gamma + beta
        return 0.5 * y * (1.0 + tf.math.erf(y / np.sqrt(2.0).astype(np.float32)))

    gd, i, o = frozen_graphdef(block, [tf.TensorSpec((2, 8, D), tf.float32, name="x")])
    return _case(block, gd, i, o, [np.random.default_rng(3).normal(0, 1, (2, 8, D))
                                   .astype(np.float32)])


def partitioned_call():  # :308
    w = tf.constant(np.random.default_rng(0).normal(0, 1, (6, 4)).astype(np.float32))

    @tf.function
    def inner(t):
        return tf.nn.relu(tf.matmul(t, w))

    def model(x):
        return inner(x) + inner(x * 2.0)

    gd, i, o = frozen_graphdef(model, [tf.TensorSpec((3, 6), tf.float32, name="x")])
    return _case(model, gd, i, o, [np.random.default_rng(1).normal(0, 1, (3, 6))
                                   .astype(np.float32)])


def while_loop():  # :331
    def model(x):
        def cond(i, acc):
            return i < 5

        def body(i, acc):
            return i + 1, acc * 1.5 + 1.0

        return tf.while_loop(cond, body, (tf.constant(0), x))[1]

    gd, i, o = functional_graphdef(model, [tf.TensorSpec((2, 3), tf.float32, name="x")])
    assert any(n.op in ("While", "StatelessWhile") for n in gd.node)
    return _case(model, gd, i, o, [np.random.default_rng(2).normal(0, 1, (2, 3))
                                   .astype(np.float32)])


def _cond_model(x):
    pred = tf.reduce_sum(x) > 0.0
    return tf.cond(pred, lambda: x * 2.0, lambda: x - 1.0)


def cond():  # :360 (freezing lowers tf.cond to Switch/Merge)
    gd, i, o = frozen_graphdef(_cond_model, [tf.TensorSpec((2, 4), tf.float32, name="x")])
    assert any(n.op == "Switch" for n in gd.node)
    return _case(_cond_model, gd, i, o,
                 [np.random.default_rng(s).normal(0.5, 1, (2, 4)).astype(np.float32)
                  for s in (3, 4)], lazy=True)


def cond_eager_optout():  # :449
    case = cond()
    case["kw"] = {"lazy_conditionals": False}
    case["lazy"] = False
    return case


def cond_branch_heavy():  # :380
    scale = tf.constant(np.linspace(0.5, 2.0, 4).astype(np.float32))

    def model(x):
        base = x * scale
        pred = tf.reduce_sum(x) > 0.0

        def true_branch():
            h = tf.nn.relu(base) + tf.sin(x)
            return tf.reduce_mean(h, axis=1, keepdims=True) * base

        def false_branch():
            return tf.nn.softplus(base - 1.0) * 0.25 + tf.cos(x)

        return tf.cond(pred, true_branch, false_branch) + base * 0.125

    gd, i, o = frozen_graphdef(model, [tf.TensorSpec((3, 4), tf.float32, name="x")])
    return _case(model, gd, i, o, [np.random.default_rng(s).normal(0, 1, (3, 4))
                                   .astype(np.float32) for s in (0, 1, 2, 9)], lazy=True)


def cond_static_fold():  # :420
    def model(x):
        pred = tf.reduce_sum(x) > 0.0
        return tf.cond(pred, lambda: tf.reduce_mean(x * 2.0, axis=1, keepdims=True),
                       lambda: tf.reshape(tf.reduce_sum(x - 1.0, axis=1), (3, 1)))

    gd, i, o = frozen_graphdef(model, [tf.TensorSpec((3, 4), tf.float32, name="x")])
    return _case(model, gd, i, o, [np.random.default_rng(s).normal(0, 1, (3, 4))
                                   .astype(np.float32) for s in (0, 3)], lazy=True)


def cond_untaken_branch():  # :474
    cvals = np.zeros((2, 3), np.float32)

    def model(x):
        c = tf.constant(cvals, name="w_const")
        pred = tf.reduce_sum(x) > 1e9
        out = tf.cond(pred, lambda: tf.sqrt(c) * x, lambda: c * 3.0 + x)
        return tf.reduce_sum(out, axis=1)

    gd, i, o = frozen_graphdef(model, [tf.TensorSpec((2, 3), tf.float32, name="x")])
    return _case(model, gd, i, o, [np.random.default_rng(0).normal(0, 1, (2, 3))
                                   .astype(np.float32)])


def functional_if():  # :529
    gd, i, o = functional_graphdef(_cond_model, [tf.TensorSpec((2, 4), tf.float32, name="x")])
    assert any(n.op in ("If", "StatelessIf") for n in gd.node)
    return _case(_cond_model, gd, i, o,
                 [np.random.default_rng(s).normal(0.5, 1, (2, 4)).astype(np.float32)
                  for s in (3, 4)])


def einsum_deconv_resize():  # :737
    rng = np.random.default_rng(0)
    B, H, W, C = 2, 8, 8, 4
    wd = rng.normal(0, 0.3, (3, 3, C, 2)).astype(np.float32)
    wt = rng.normal(0, 0.3, (3, 3, 6, C * 2)).astype(np.float32)
    we = rng.normal(0, 0.3, (6, 5)).astype(np.float32)

    def model(x):
        d = tf.nn.depthwise_conv2d(x, wd, (1, 1, 1, 1), "SAME")
        t = tf.nn.conv2d_transpose(d, wt, (B, 2 * H, 2 * W, 6), (1, 2, 2, 1), "SAME")
        r = tf.compat.v1.image.resize_nearest_neighbor(t, (H, W))
        e = tf.einsum("bhwc,cd->bhwd", r, we)
        return tf.reshape(e, tf.stack([tf.shape(e)[0], -1]))

    gd, i, o = frozen_graphdef(model, [tf.TensorSpec((B, H, W, C), tf.float32, name="x")])
    x = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    return dict(gd=gd, out=o, feeds=[{"x": x}], want=[[model(tf.constant(x)).numpy()]])


def simple_op_batch():  # :878
    rng = np.random.default_rng(0)

    def model(x, img):
        a = tf.math.asinh(x) + tf.math.atan2(x, x + 2.0)
        a = tf.nn.leaky_relu(a, alpha=0.3) + tf.math.expm1(x * 0.1)
        a = tf.cumsum(a, axis=1) + tf.math.xdivy(x, tf.math.rint(x))
        a = tf.reverse(a, axis=[1])
        vals, idx = tf.math.top_k(a, k=2)
        d = tf.nn.depth_to_space(img, 2)
        return a, vals, tf.cast(idx, tf.float32), d

    gd, i, o = frozen_graphdef(model, [tf.TensorSpec((3, 5), tf.float32, name="x"),
                                       tf.TensorSpec((2, 4, 4, 8), tf.float32, name="img")])
    x = rng.normal(0, 1, (3, 5)).astype(np.float32)
    img = rng.normal(0, 1, (2, 4, 4, 8)).astype(np.float32)
    want = [t.numpy() for t in model(tf.constant(x), tf.constant(img))]
    return dict(gd=gd, out=o, feeds=[{"x": x, "img": img}], want=[want])


def training_dropout():  # :916
    w = tf.constant(np.random.default_rng(0).normal(0, 1, (8, 8)).astype(np.float32))

    def model(x):
        return tf.nn.dropout(tf.matmul(x, w), rate=0.5)

    gd, i, o = frozen_graphdef(model, [tf.TensorSpec((16, 8), tf.float32, name="x")])
    assert any(n.op == "RandomUniform" for n in gd.node)
    return dict(gd=gd, inputs=i, out=o,
                x=np.random.default_rng(1).normal(0, 1, (16, 8)).astype(np.float32))


def _v1_graph(build, x_np):
    """A TF1 graph with classic control flow (frames): ``build(xin)``
    returns the output tensor."""
    tf.compat.v1.disable_control_flow_v2()
    g = tf.Graph()
    try:
        with g.as_default():
            with tf.compat.v1.Session() as sess:
                xin = tf.compat.v1.placeholder(tf.float32, x_np.shape, name="x")
                out = build(xin)
                gd = sess.graph.as_graph_def()
                want = sess.run(out, {xin: x_np})
    finally:
        tf.compat.v1.enable_control_flow_v2()
    assert any(n.op == "Enter" for n in gd.node)
    return dict(gd=gd, out=[out.name.split(":")[0]], feeds=[{"x": x_np}], want=[[want]])


def tf1_frames():  # :957
    def build(xin):
        w = tf.constant(np.full((4, 4), 0.5, np.float32))
        _, acc = tf.while_loop(lambda i, acc: i < 5,
                               lambda i, acc: (i + 1, tf.tanh(acc @ w) + xin),
                               (tf.constant(0), xin))
        return acc * 2.0
    return _v1_graph(build, np.random.default_rng(0).normal(0, 1, (3, 4)).astype(np.float32))


def tf1_invariant_multi_carry():  # :994
    def build(xin):
        scale = tf.constant(1.5, tf.float32)
        _, a_fin, b_fin = tf.while_loop(
            lambda i, a, b: i < 3, lambda i, a, b: (i + 1, a + b * scale, b + 1.0),
            (tf.constant(0), xin, tf.ones_like(xin)))
        return a_fin + b_fin
    return _v1_graph(build, np.random.default_rng(1).normal(0, 1, (2, 3)).astype(np.float32))


def tf1_nested():  # :1073
    def build(xin):
        def outer_body(i, acc):
            _, a_fin = tf.while_loop(lambda j, a: j < 2, lambda j, a: (j + 1, a * 0.5 + 1.0),
                                     (tf.constant(0), acc))
            return i + 1, a_fin + xin
        return tf.while_loop(lambda i, a: i < 3, outer_body, (tf.constant(0), xin))[1]
    return _v1_graph(build, np.random.default_rng(2).normal(0, 1, (2, 3)).astype(np.float32))


def while_max_iterations():  # :1026
    w = tf.constant(np.full((4, 4), 0.1, np.float32))

    def model(x):
        _, acc = tf.while_loop(lambda i, acc: i < 3,
                               lambda i, acc: (i + 1, tf.tanh(acc @ w) + x),
                               (tf.constant(0), x))
        return acc

    gd, i, o = frozen_graphdef(model, [tf.TensorSpec((2, 4), tf.float32, name="x")])
    case = _case(model, gd, i, o, [np.random.default_rng(0).normal(0, 1, (2, 4))
                                   .astype(np.float32)], kw={"while_max_iterations": 3})
    case["inputs"] = i
    return case


def saved_model(path):  # :505
    class M(tf.Module):
        def __init__(self):
            super().__init__()
            self.w = tf.Variable(np.random.default_rng(0).normal(0, 1, (5, 3)).astype(np.float32))

        @tf.function(input_signature=[tf.TensorSpec((None, 5), tf.float32)])
        def __call__(self, x):
            return tf.nn.softmax(tf.matmul(x, self.w))

    m = M()
    tf.saved_model.save(m, path)
    x = np.random.default_rng(5).normal(0, 1, (4, 5)).astype(np.float32)
    return x, m(tf.constant(x)).numpy()


BUILDERS = {
    "mlp": mlp, "attention_block": attention_block, "partitioned_call": partitioned_call,
    "while_loop": while_loop, "cond": cond, "cond_branch_heavy": cond_branch_heavy,
    "cond_static_fold": cond_static_fold, "cond_eager_optout": cond_eager_optout,
    "cond_untaken_branch": cond_untaken_branch, "functional_if": functional_if,
    "einsum_deconv_resize": einsum_deconv_resize, "simple_op_batch": simple_op_batch,
    "tf1_frames": tf1_frames, "tf1_invariant_multi_carry": tf1_invariant_multi_carry,
    "tf1_nested": tf1_nested, "while_max_iterations": while_max_iterations,
    "training_dropout": training_dropout,
}


@functools.lru_cache(maxsize=None)
def build(name):
    return BUILDERS[name]()
