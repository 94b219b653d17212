"""The registry ops the TF GraphDef importer emits, port against the JAX
package on the CPU.

One parametrised test over every op that ``TFGraphMapper`` maps onto and
the port did not hold before its importer: the same inputs (numpy from a
seed) through ``deeplearning4j_tpu.autodiff.ops_registry`` and the port's
``ops_registry``, forward and, for the differentiable ones, the gradient of
``sum(out * w)`` in each float input. Integer-domain traps are cases of
their own: floor and truncating division and remainder on negative
integers, rounding half to even, ``one_hot`` outside the depth, ``top_k``
ties, the legacy nearest-neighbour sampling. The seeded draws
(``random_*``, ``truncated_normal``, ``random_categorical``) cannot share
JAX's threefry stream: they are held by law (mean, spread, range, class
frequencies) and by their shape and dtype. A corner-aligned bilinear
resize is refused by both registries with one message.

Float32; forward and gradient within 1e-5 absolute and relative (1e-4 for
the linear-algebra ops, whose LAPACK paths differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import ops_registry as jops
from deeplearning4j_tpu_torch.autodiff import ops_registry as tops
from deeplearning4j_tpu_torch.runtime.environment import get_environment


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = env.device
    env.set_device("cpu")
    yield
    env.device = saved


def _rng(name):
    return np.random.default_rng(sum(map(ord, name)))


def _n(*shape, lo=None, hi=2.0):
    def make(rng):
        if lo is not None:
            return rng.uniform(lo, hi, shape).astype(np.float32)
        return rng.normal(0.0, 1.0, shape).astype(np.float32)
    return make


def _i(lo, hi, *shape):
    return lambda rng: rng.integers(lo, hi, shape).astype(np.int32)


def _c(value):
    return lambda rng: np.asarray(value)


def _spd(n):
    def make(rng):
        a = rng.normal(0, 1, (n, n)).astype(np.float32)
        return (a @ a.T + n * np.eye(n)).astype(np.float32)
    return make


X = _n(3, 5)
POS = _n(3, 5, lo=0.2)
UNIT = _n(3, 5, lo=-0.9, hi=0.9)
IMG = _n(2, 6, 6, 4)

# (case id, op, input makers, attrs, differentiable)
CASES = [(op, op, [X], {}, True) for op in (
    "exp", "sin", "cos", "tan", "atan", "sinh", "cosh", "asinh", "expm1", "erfc",
    "sigmoid", "softplus", "softsign", "elu", "selu", "abs", "square", "relu6",
    "l2_loss")]
CASES += [(op, op, [X], {}, False) for op in ("sign", "zeros_like", "ones_like")]
CASES += [(op, op, [POS], {}, True) for op in ("log", "log1p", "sqrt", "gammaln", "digamma",
                                                 "reciprocal")]
CASES += [(op, op, [UNIT], {}, True) for op in ("asin", "acos", "atanh")]
CASES += [
    ("acosh", "acosh", [_n(3, 5, lo=1.2, hi=3.0)], {}, True),
    ("floor", "floor", [X], {}, False),
    ("ceil", "ceil", [X], {}, False),
    ("round-half-even", "round", [_c(np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.3],
                                               np.float32))], {}, False),
    ("rint-half-even", "rint", [_c(np.array([-2.5, -0.5, 0.5, 1.5, 2.5, 3.7], np.float32))],
     {}, False),
    ("floor-int", "floor", [_i(-5, 5, 4)], {}, False),
    ("leaky_relu", "leaky_relu", [X], {"alpha": 0.3}, True),
    ("log_softmax", "log_softmax", [X], {"axis": 0}, True),
    ("maximum", "maximum", [X, _n(3, 5)], {}, True),
    ("minimum", "minimum", [X, _n(1, 5)], {}, True),
    ("atan2", "atan2", [X, _n(3, 5)], {}, True),
    ("xlogy", "xlogy", [_c(np.array([[0.0, 1.5, -2.0], [3.0, 0.0, 0.5]], np.float32)),
                        _n(2, 3, lo=0.5)], {}, True),
    ("xdivy", "xdivy", [_c(np.array([[0.0, 1.5, -2.0], [3.0, 0.0, 0.5]], np.float32)),
                        _c(np.array([[0.0, 2.0, 4.0], [0.0, 1.0, 3.0]], np.float32))], {}, True),
    ("div_no_nan", "div_no_nan", [X, _c(np.array([0.0, 2.0, -1.0, 0.0, 0.5], np.float32))],
     {}, True),
    ("multiply_no_nan", "multiply_no_nan",
     [_c(np.array([np.inf, 1.0, np.nan, 2.0], np.float32)),
      _c(np.array([0.0, 3.0, 0.0, -1.0], np.float32))], {}, False),
    ("floordiv-float", "floordiv", [X, _n(3, 5, lo=0.3)], {}, False),
    ("floordiv-int", "floordiv", [_c(np.array([7, -7, 7, -7, 0, -1], np.int32)),
                                  _c(np.array([2, 2, -2, -2, 3, 4], np.int32))], {}, False),
    ("mod-int", "mod", [_c(np.array([7, -7, 7, -7, 0, -1], np.int32)),
                        _c(np.array([2, 2, -2, -2, 3, 4], np.int32))], {}, False),
    ("mod-float", "mod", [_c(np.array([5.5, -5.5, 5.5, -5.5], np.float32)),
                          _c(np.array([2.0, 2.0, -2.0, -2.0], np.float32))], {}, False),
    ("truncate_div-int", "truncate_div", [_c(np.array([7, -7, 7, -7, -1], np.int32)),
                                          _c(np.array([2, 2, -2, -2, 4], np.int32))], {}, False),
    ("truncate_mod-int", "truncate_mod", [_c(np.array([7, -7, 7, -7, -1], np.int32)),
                                          _c(np.array([2, 2, -2, -2, 4], np.int32))], {}, False),
    ("truncate_div-float", "truncate_div", [X, _n(3, 5, lo=0.3)], {}, False),
    ("truncate_mod-float", "truncate_mod", [X, _n(3, 5, lo=0.3)], {}, False),
    ("gte", "gte", [X, _n(3, 5)], {}, False),
    ("lte", "lte", [X, _c(np.float32(0.0))], {}, False),
    ("eq", "eq", [_i(0, 3, 6), _i(0, 3, 6)], {}, False),
    ("neq", "neq", [_i(0, 3, 6), _i(0, 3, 6)], {}, False),
    ("logical_and", "logical_and", [_c(np.array([True, False, True])),
                                    _c(np.array([True, True, False]))], {}, False),
    ("logical_or", "logical_or", [_c(np.array([True, False, False])),
                                  _c(np.array([False, True, False]))], {}, False),
    ("logical_not", "logical_not", [_c(np.array([True, False]))], {}, False),
    ("where", "where", [_c(np.array([[True, False, True, False, True]] * 3)), X, _n(3, 5)],
     {}, True),
    ("add_n", "add_n", [X, _n(3, 5), _n(1, 5)], {}, True),
    ("reduce_max", "reduce_max", [X], {"axis": [1], "keepdims": True}, True),
    ("reduce_min", "reduce_min", [X], {"axis": [0]}, True),
    ("reduce_prod", "reduce_prod", [_n(2, 3, 4)], {"axis": [0, 2]}, True),
    ("reduce_prod-all", "reduce_prod", [_n(2, 3)], {}, True),
    ("argmax", "argmax", [X], {"axis": 1}, False),
    ("argmin", "argmin", [X], {"axis": 0}, False),
    ("cumsum", "cumsum", [X], {"axis": 1}, True),
    ("cumsum-int", "cumsum", [_i(-3, 3, 2, 4)], {"axis": 1}, False),
    ("cumprod", "cumprod", [X], {"axis": 0}, True),
    ("squeeze", "squeeze", [_n(3, 1, 5, 1)], {"axis": (1, 3)}, True),
    ("squeeze-all", "squeeze", [_n(1, 3, 1)], {}, True),
    ("stack", "stack", [X, _n(3, 5)], {"axis": 1}, True),
    ("unstack", "unstack", [_n(3, 4, 2)], {"axis": 1, "num": 4}, True),
    ("tile", "tile", [_n(2, 3)], {"multiples": [2, 3]}, True),
    ("slice", "slice", [_n(4, 5, 6)], {"begin": [1, 0, 2], "size": [2, 5, 3]}, True),
    ("gather_nd", "gather_nd", [_n(4, 5, 3), _c(np.array([[0, 1], [3, 4], [2, 2]], np.int32))],
     {}, True),
    ("one_hot", "one_hot", [_c(np.array([[0, 2], [3, -1]], np.int32))],
     {"depth": 3, "on_value": 5.0, "off_value": -1.0, "axis": -1}, False),
    ("one_hot-axis0", "one_hot", [_c(np.array([1, 0, 2], np.int32))], {"depth": 4, "axis": 0},
     False),
    ("pad", "pad", [_n(2, 3)], {"paddings": [[1, 2], [0, 1]], "constant_value": 0.5}, True),
    ("pad-reflect", "pad", [_n(3, 4)], {"paddings": [[2, 1], [3, 2]], "mode": "reflect"}, True),
    ("pad-edge", "pad", [_n(3, 4)], {"paddings": [[2, 1], [0, 2]], "mode": "edge"}, True),
    ("pad-wrap", "pad", [_n(3, 4)], {"paddings": [[1, 1], [5, 2]], "mode": "wrap"}, True),
    ("reverse", "reverse", [_n(2, 3, 4)], {"axis": [0, 2]}, True),
    ("space_to_depth", "space_to_depth", [IMG], {"block_size": 2}, True),
    ("depth_to_space", "depth_to_space", [IMG], {"block_size": 2}, True),
    ("invert_permutation", "invert_permutation", [_c(np.array([3, 0, 4, 1, 2], np.int32))],
     {}, False),
    ("top_k", "top_k", [X], {"k": 2}, True),
    ("top_k-ties", "top_k", [_c(np.array([[1.0, 3.0, 3.0, 2.0, 3.0]], np.float32))], {"k": 3},
     False),
    ("einsum", "einsum", [_n(2, 3, 4), _n(4, 5)], {"equation": "bij,jk->bik"}, True),
    ("cholesky", "cholesky", [_spd(4)], {}, True),
    ("matrix_inverse", "matrix_inverse", [_spd(4)], {}, True),
    ("matrix_determinant", "matrix_determinant", [_n(2, 3, 3)], {}, True),
    ("matrix_band_part", "matrix_band_part", [_n(2, 4, 5)], {"num_lower": 1, "num_upper": 2},
     True),
    ("matrix_diag", "matrix_diag", [_n(2, 4)], {}, True),
    ("matrix_diag_part", "matrix_diag_part", [_n(2, 4, 3)], {}, True),
    ("conv2d-same", "conv2d", [IMG, _n(3, 3, 4, 5)], {"stride": [1, 1], "padding": "SAME"}, True),
    ("conv2d-stride-dilation", "conv2d", [_n(2, 9, 8, 4), _n(3, 2, 4, 3)],
     {"stride": [2, 3], "padding": "SAME", "dilation": [2, 1]}, True),
    ("conv2d-valid-bias", "conv2d", [IMG, _n(2, 2, 4, 3), _n(3)],
     {"stride": [2, 2], "padding": "VALID"}, True),
    ("depthwise_conv2d", "depthwise_conv2d", [IMG, _n(3, 3, 4, 2)],
     {"stride": [1, 1], "padding": "SAME"}, True),
    ("depthwise_conv2d-stride", "depthwise_conv2d", [_n(2, 7, 7, 3), _n(2, 2, 3, 1)],
     {"stride": [2, 2], "padding": "VALID"}, True),
    ("conv2d_transpose-same", "conv2d_transpose", [_n(2, 4, 4, 5), _n(3, 3, 6, 5)],
     {"stride": [2, 2], "padding": "SAME"}, True),
    ("conv2d_transpose-valid", "conv2d_transpose", [_n(2, 3, 4, 5), _n(2, 3, 6, 5)],
     {"stride": [3, 1], "padding": "VALID"}, True),
    ("conv2d_transpose-same-k4s3", "conv2d_transpose", [_n(1, 3, 3, 2), _n(4, 4, 3, 2)],
     {"stride": [3, 3], "padding": "SAME", "output_shape": [1, 9, 9, 3]}, True),
    ("max_pool2d", "max_pool2d", [IMG], {"kernel": [2, 2], "stride": [2, 2], "padding": "VALID"},
     True),
    ("max_pool2d-same", "max_pool2d", [_n(2, 7, 7, 3)],
     {"kernel": [3, 3], "stride": [2, 2], "padding": "SAME"}, True),
    ("avg_pool2d-same", "avg_pool2d", [_n(2, 7, 7, 3)],
     {"kernel": [3, 3], "stride": [2, 2], "padding": "SAME"}, True),
    ("avg_pool2d-valid", "avg_pool2d", [IMG], {"kernel": [3, 2], "stride": [1, 2],
                                               "padding": "VALID"}, True),
    ("batch_norm", "batch_norm", [IMG, _n(4), _n(4, lo=0.5), _n(4), _n(4)], {"eps": 1e-3}, True),
    ("resize_bilinear-up", "resize_bilinear", [_n(2, 4, 5, 3)], {"height": 8, "width": 7}, True),
    ("resize_bilinear-down", "resize_bilinear", [_n(1, 9, 8, 2)], {"height": 4, "width": 3},
     True),
    ("resize_nearest", "resize_nearest", [_n(2, 4, 5, 3)], {"height": 7, "width": 3}, True),
    ("resize_nearest-legacy", "resize_nearest", [_n(2, 6, 5, 3)],
     {"height": 4, "width": 8, "half_pixel_centers": False}, True),
]


def _t(a, grad=False):
    t = torch.as_tensor(np.array(a))
    return t.requires_grad_(True) if grad and t.is_floating_point() else t


def _outs(r):
    return list(r) if isinstance(r, (tuple, list)) else [r]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    cid, op, makers, attrs, diff = case
    rng = _rng(cid)
    inputs = [m(rng) for m in makers]
    jfn = jops.get_op(op)
    want = _outs(jax.jit(lambda *xs: jfn(*xs, **attrs))(*[jnp.asarray(a) for a in inputs]))
    ts = [_t(a, grad=diff) for a in inputs]
    got = _outs(tops.get_op(op)(*ts, **attrs))
    tol = 1e-4 if op in ("cholesky", "matrix_inverse", "matrix_determinant") else 1e-5
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (cid, tuple(g.shape), w.shape)
        gn = g.detach().numpy()
        assert gn.dtype == w.dtype, (cid, gn.dtype, w.dtype)
        np.testing.assert_allclose(gn, w, rtol=tol, atol=tol, err_msg=cid)
    if not diff:
        return
    weights = [rng.normal(0, 1, np.asarray(w).shape).astype(np.float32) for w in want]
    floats = [i for i, a in enumerate(inputs) if np.asarray(a).dtype == np.float32]

    def loss(*xs):
        args = list(jnp.asarray(a) for a in inputs)
        for i, x in zip(floats, xs):
            args[i] = x
        outs = _outs(jfn(*args, **attrs))
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights)
                   if jnp.issubdtype(o.dtype, jnp.floating))

    jgrads = jax.jit(jax.grad(loss, argnums=tuple(range(len(floats)))))(
        *[jnp.asarray(inputs[i]) for i in floats])
    total = sum((o * torch.as_tensor(w)).sum() for o, w in zip(got, weights)
                if o.is_floating_point())
    tgrads = torch.autograd.grad(total, [ts[i] for i in floats], allow_unused=True)
    for i, tg, jg in zip(floats, tgrads, jgrads):
        tg = np.zeros_like(np.asarray(jg)) if tg is None else tg.numpy()
        np.testing.assert_allclose(tg, np.asarray(jg), rtol=tol, atol=tol,
                                   err_msg=f"{cid} gradient of input {i}")


# the seeded draws, held by law: their streams are not JAX's
BY_LAW = ("random_uniform", "random_normal", "truncated_normal", "random_categorical")


@pytest.mark.parametrize("op", BY_LAW[:3])
@pytest.mark.parametrize("computed_shape", [False, True])
def test_random_draws_by_law(op, computed_shape):
    """Same seed, same draw; another seed, another; the law's mean, spread
    and range; a computed (tensor) shape gives the same draw as a static
    one. ``key`` (the executor's per-step generator) overrides the seed."""
    n = 20000
    shape = torch.tensor([100, n // 100], dtype=torch.int32) if computed_shape else [100, n // 100]
    fn = tops.get_op(op)
    a, b, c = fn(shape, seed=7), fn(shape, seed=7), fn(shape, seed=8)
    assert tuple(a.shape) == (100, n // 100) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    k1 = fn(shape, seed=7, key=torch.Generator().manual_seed(1))
    k2 = fn(shape, seed=7, key=torch.Generator().manual_seed(2))
    assert not torch.equal(k1, a) and not torch.equal(k1, k2)
    x = a.double()
    if op == "random_uniform":
        assert 0.0 <= float(x.min()) and float(x.max()) < 1.0
        mean, std = 0.5, (1 / 12) ** 0.5
    elif op == "random_normal":
        mean, std = 0.0, 1.0
    else:
        assert -2.0 <= float(x.min()) and float(x.max()) <= 2.0
        # the standard normal truncated to [-2, 2]: its spread, as JAX's
        jx = np.asarray(jops.get_op(op)(shape=[n], seed=7))
        mean, std = 0.0, float(jx.std())
        assert abs(std - 0.8796) < 0.02
    sigma = std / n ** 0.5
    assert abs(float(x.mean()) - mean) < 5 * sigma
    assert abs(float(x.std()) - std) < 0.03 * std


def test_random_categorical_by_law():
    logits = np.log(np.array([[0.1, 0.6, 0.3], [0.5, 0.25, 0.25]], np.float32))
    got = tops.get_op("random_categorical")(torch.as_tensor(logits), num_samples=6000, seed=3)
    want = np.asarray(jops.get_op("random_categorical")(jnp.asarray(logits), num_samples=6000,
                                                        seed=3))
    assert tuple(got.shape) == want.shape == (2, 6000) and got.dtype == torch.int32
    freq = np.stack([np.bincount(r, minlength=3) / 6000 for r in got.numpy()])
    np.testing.assert_allclose(freq, np.exp(logits), atol=0.03)


def test_unmapped_ops_still_raise_by_name():
    with pytest.raises(NotImplementedError, match="'svd'"):
        tops.get_op("svd")


def test_corner_aligned_bilinear_resize_is_refused_as_jax():
    x = np.zeros((1, 3, 2, 2), np.float32)
    errors = []
    for get_op, arr in ((tops.get_op, torch.as_tensor(x)), (jops.get_op, jnp.asarray(x))):
        with pytest.raises(NotImplementedError, match="align_corners=True") as e:
            get_op("resize_bilinear")(arr, height=6, width=4, align_corners=True)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
