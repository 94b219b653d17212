"""The port's seven remaining conv-family layers against the JAX package on
the CPU: ``Convolution1DLayer`` (truncate, same and causal modes, strides,
dilation, and its mask reduction), ``LocalResponseNormalization``,
``Upsampling2D``, ``ZeroPaddingLayer``, ``SeparableConvolution2D`` (depth
multiplier 1 and 2), ``Deconvolution2D`` (odd and even kernels at strides
1-3 in both modes) and ``SpaceToDepthLayer``; forward, input and parameter
gradients against ``jax.grad``, output types and JSON.

Inputs and parameters are numpy from a seed. Float32: outputs ``rtol=1e-5,
atol=1e-5`` (the same products in another order); gradients ``rtol=1e-4,
atol=1e-5``; masks exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import base as jbase
from deeplearning4j_tpu.nn import conv_layers as jconv
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu_torch.nn import base as tbase
from deeplearning4j_tpu_torch.nn import conv_layers as tconv
from deeplearning4j_tpu_torch.nn.inputs import InputType as TInputType
from deeplearning4j_tpu_torch.runtime.environment import get_environment


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _pair(name, **kw):
    j, t = getattr(jconv, name)(**kw), getattr(tconv, name)(**kw)
    j._g, t._g = jbase.GlobalConfig(), tbase.GlobalConfig()
    return j, t


def _close(got, want, what, rtol=1e-5, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _hold(j, t, params, x, seed):
    """Forward and the gradients of ``sum(y * cot)`` in both packages."""
    rng = np.random.default_rng(seed)
    jy = j.forward(jax.tree.map(jnp.asarray, params), {}, jnp.asarray(x))[0]
    ty = t.forward({k: torch.from_numpy(v.copy()) for k, v in params.items()}, {},
                   torch.from_numpy(x.copy()))[0]
    assert tuple(ty.shape) == jy.shape
    _close(ty, jy, "y")
    cot = rng.normal(0, 1, jy.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(j.forward(p, {}, xx)[0] * cot)

    jg = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    (t.forward(tp, {}, tx)[0] * torch.from_numpy(cot)).sum().backward()
    for k in params:
        _close(tp[k].grad, jg[0][k], f"d{k}", rtol=1e-4)
    _close(tx.grad, jg[1], "dx", rtol=1e-4)
    assert json.loads(json.dumps(t.to_dict())) == json.loads(json.dumps(j.to_dict()))
    return ty


def _out_type(j, t, it_j, it_t):
    assert t.output_type(it_t).to_dict() == j.output_type(it_j).to_dict()


CONV1D_CASES = [
    dict(kernel_size=3),
    dict(kernel_size=3, convolution_mode="same"),
    dict(kernel_size=4, stride=2, convolution_mode="same"),
    dict(kernel_size=3, stride=2, padding=1),
    dict(kernel_size=3, dilation=2, padding=2, activation="tanh"),
    dict(kernel_size=3, convolution_mode="causal"),
    dict(kernel_size=2, dilation=3, convolution_mode="causal", has_bias=False),
    dict(kernel_size=3, stride=2, convolution_mode="causal"),
    dict(kernel_size=5, stride=3, dilation=2, convolution_mode="same"),
]


@pytest.mark.parametrize("kw", CONV1D_CASES, ids=lambda kw: json.dumps(kw, sort_keys=True))
def test_convolution1d_matches_jax(kw):
    rng = np.random.default_rng(len(json.dumps(kw)))
    j, t = _pair("Convolution1DLayer", n_out=5, **kw)
    k = t._geom1d()[0]
    x = rng.normal(0, 1, (3, 13, 4)).astype(np.float32)
    params = {"W": rng.normal(0, 0.3, (k, 1, 4, 5)).astype(np.float32)}
    if t.has_bias:
        params["b"] = rng.normal(0, 0.1, 5).astype(np.float32)
    y = _hold(j, t, params, x, 1)
    _out_type(j, t, JInputType.recurrent(4, 13), TInputType.recurrent(4, 13))
    assert t.output_type(TInputType.recurrent(4, 13)).timesteps == y.shape[1]
    mask = (rng.random((3, 13)) > 0.4).astype(np.float32)
    mask[1] = 0.0
    mask[2, :] = 1.0
    want = np.asarray(j.transform_mask(jnp.asarray(mask)))
    got = t.transform_mask(torch.from_numpy(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, y.shape[1])
    np.testing.assert_array_equal(got.numpy(), want)
    assert t.transform_mask(None) is None


def test_causal_convolution1d_sees_only_the_past():
    _, t = _pair("Convolution1DLayer", n_out=2, kernel_size=3, dilation=2,
                 convolution_mode="causal")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (1, 12, 3)).astype(np.float32))
    p = {"W": torch.from_numpy(rng.normal(0, 1, (3, 1, 3, 2)).astype(np.float32)),
         "b": torch.zeros(2)}
    y0 = t.forward(p, {}, x)[0]
    x2 = x.clone()
    x2[:, 7:] += 10.0
    y1 = t.forward(p, {}, x2)[0]
    _close(y1[:, :7], y0[:, :7], "steps before the change")
    assert not torch.allclose(y1[:, 7:], y0[:, 7:])


LRN_CASES = [dict(), dict(n=3, k=1.0, alpha=0.5, beta=0.5), dict(n=4, alpha=1e-2)]


@pytest.mark.parametrize("kw", LRN_CASES, ids=lambda kw: json.dumps(kw, sort_keys=True))
def test_local_response_normalization_matches_jax(kw):
    rng = np.random.default_rng(7)
    j, t = _pair("LocalResponseNormalization", **kw)
    x = (rng.normal(0, 3, (2, 5, 4, 7))).astype(np.float32)
    _hold(j, t, {}, x, 2)
    # not F.local_response_norm: alpha is not divided by n
    xt = torch.from_numpy(x)
    ours = t.forward({}, {}, xt)[0]
    lib = torch.nn.functional.local_response_norm(
        xt.permute(0, 3, 1, 2), t.n, t.alpha, t.beta, t.k).permute(0, 2, 3, 1)
    assert not torch.allclose(ours, lib, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("size", [(2, 2), (3, 1), 2], ids=str)
def test_upsampling2d_matches_jax(size):
    rng = np.random.default_rng(5)
    j, t = _pair("Upsampling2D", size=size)
    x = rng.normal(0, 1, (2, 3, 4, 5)).astype(np.float32)
    _hold(j, t, {}, x, 3)
    _out_type(j, t, JInputType.convolutional(3, 4, 5), TInputType.convolutional(3, 4, 5))


@pytest.mark.parametrize("padding", [(1, 1), (2, 0), 3, ((1, 2), (0, 3))], ids=str)
def test_zero_padding_matches_jax(padding):
    rng = np.random.default_rng(6)
    j, t = _pair("ZeroPaddingLayer", padding=padding)
    x = rng.normal(0, 1, (2, 3, 4, 5)).astype(np.float32)
    _hold(j, t, {}, x, 4)
    _out_type(j, t, JInputType.convolutional(3, 4, 5), TInputType.convolutional(3, 4, 5))


SEP_CASES = [
    dict(kernel_size=(3, 3)),
    dict(kernel_size=(3, 3), convolution_mode="same", depth_multiplier=2),
    dict(kernel_size=(3, 3), stride=(2, 2), convolution_mode="same", has_bias=False),
    dict(kernel_size=(2, 3), stride=(2, 1), padding=(1, 1), depth_multiplier=2,
         activation="relu"),
    dict(kernel_size=(3, 3), dilation=(2, 2), convolution_mode="same", depth_multiplier=3),
]


@pytest.mark.parametrize("kw", SEP_CASES, ids=lambda kw: json.dumps(kw, sort_keys=True))
def test_separable_convolution_matches_jax(kw):
    rng = np.random.default_rng(len(json.dumps(kw)))
    j, t = _pair("SeparableConvolution2D", n_out=6, **kw)
    (kh, kw_), dm = t._geom()[0], t.depth_multiplier
    x = rng.normal(0, 1, (2, 9, 8, 3)).astype(np.float32)
    params = {"W_depth": rng.normal(0, 0.5, (kh, kw_, 1, 3 * dm)).astype(np.float32),
              "W_point": rng.normal(0, 0.5, (1, 1, 3 * dm, 6)).astype(np.float32)}
    if t.has_bias:
        params["b"] = rng.normal(0, 0.1, 6).astype(np.float32)
    _hold(j, t, params, x, 5)
    _out_type(j, t, JInputType.convolutional(9, 8, 3), TInputType.convolutional(9, 8, 3))
    g = tbase.GlobalConfig()
    p, _ = t.init(torch.Generator().manual_seed(0), TInputType.convolutional(9, 8, 3), g)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in params.items()}


DECONV_CASES = [dict(kernel_size=(k, k), stride=(s, s), convolution_mode=m, padding=(p, p))
                for k in (2, 3, 4) for s in (1, 2, 3) for m in ("truncate", "same")
                for p in ((0, 1) if m == "truncate" and k > 2 else (0,))]
DECONV_CASES.append(dict(kernel_size=(3, 2), stride=(2, 3), convolution_mode="same"))
DECONV_CASES.append(dict(kernel_size=(1, 1), stride=(3, 2)))


@pytest.mark.parametrize("kw", DECONV_CASES, ids=lambda kw: json.dumps(kw, sort_keys=True))
def test_deconvolution_matches_jax(kw):
    rng = np.random.default_rng(len(json.dumps(kw)) + 11)
    j, t = _pair("Deconvolution2D", n_out=4, **kw)
    kh, kw_ = t._geom()[0]
    x = rng.normal(0, 1, (2, 5, 4, 3)).astype(np.float32)
    params = {"W": rng.normal(0, 0.5, (kh, kw_, 3, 4)).astype(np.float32),
              "b": rng.normal(0, 0.1, 4).astype(np.float32)}
    y = _hold(j, t, params, x, 6)
    out = t.output_type(TInputType.convolutional(5, 4, 3))
    assert tuple(y.shape[1:]) == (out.height, out.width, 4)
    _out_type(j, t, JInputType.convolutional(5, 4, 3), TInputType.convolutional(5, 4, 3))


@pytest.mark.parametrize("block", [2, 3])
def test_space_to_depth_matches_jax(block):
    rng = np.random.default_rng(block)
    j, t = _pair("SpaceToDepthLayer", block_size=block)
    x = rng.normal(0, 1, (2, 6, 12, 5)).astype(np.float32)
    y = _hold(j, t, {}, x, 7)
    _out_type(j, t, JInputType.convolutional(6, 12, 5), TInputType.convolutional(6, 12, 5))
    # channel order (bh, bw, c), not pixel_unshuffle's (c, bh, bw)
    xt = torch.from_numpy(x)
    assert torch.equal(y[0, 0, 0, :5], xt[0, 0, 0])
    assert torch.equal(y[0, 0, 0, 5:10], xt[0, 0, 1])


def test_subclasses_never_fuse():
    """Only a plain ``ConvolutionLayer`` runs as a conv_stats pair; a 1x1
    bias-free identity deconvolution, separable or 1-D convolution is no
    strided product."""
    one = dict(n_out=3, kernel_size=(1, 1), has_bias=False, activation="identity")
    for name in ("Deconvolution2D", "SeparableConvolution2D"):
        assert not _pair(name, stride=(2, 2), **one)[1].is_plain_1x1()
    assert not _pair("Convolution1DLayer", n_out=3, kernel_size=1, has_bias=False,
                     activation="identity")[1].is_plain_1x1()
    assert _pair("ConvolutionLayer", stride=(2, 2), **one)[1].is_plain_1x1()


def test_layers_read_jax_json():
    for name, kw in [("Convolution1DLayer", dict(n_out=4, kernel_size=5, convolution_mode="causal")),
                     ("LocalResponseNormalization", dict(n=3)),
                     ("Upsampling2D", dict(size=(2, 3))),
                     ("ZeroPaddingLayer", dict(padding=((1, 2), (3, 4)))),
                     ("SeparableConvolution2D", dict(n_out=4, depth_multiplier=2)),
                     ("Deconvolution2D", dict(n_out=4, stride=(2, 2))),
                     ("SpaceToDepthLayer", dict(block_size=4))]:
        d = json.loads(json.dumps(getattr(jconv, name)(**kw).to_dict()))
        layer = tbase.Layer.from_dict(d)
        assert type(layer).__name__ == name
        assert json.loads(json.dumps(layer.to_dict())) == d
