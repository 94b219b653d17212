"""The port's input preprocessors against the JAX package's, on the CPU.

Each of the six classes reshapes the same seeded input in both packages:
the results must be equal bit for bit (a reshape moves values, it computes
none), with three channels and height != width, where a flatten in the
wrong order shows, and on a channels_last view as the port's convolutions
return. ``output_type`` and the JSON agree both ways. The configuration
builder inserts the same preprocessors as the JAX package's (a flattened
image into a convolution, an image into a dense layer) and refuses a flat
input into a convolution with the same ``ValueError``. Networks that run
them, a ``MultiLayerNetwork`` and a ``ComputationGraph`` with a
``PreprocessorVertex``, are restored from JAX archives and give the JAX
output within ``rtol=atol=1e-5`` (float32 products summed in another order).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models.computation_graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn import (ConvolutionLayer, DenseLayer, InputType,
                                   NeuralNetConfiguration, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu.nn import preprocessors as jpp
from deeplearning4j_tpu.nn.graph_vertices import PreprocessorVertex as JPreprocessorVertex
from deeplearning4j_tpu.train.updaters import Sgd
from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import config as tconfig
from deeplearning4j_tpu_torch.nn import preprocessors as tpp
from deeplearning4j_tpu_torch.nn.inputs import InputType as TInputType
from deeplearning4j_tpu_torch.runtime.environment import get_environment

H, W, C, B, T = 4, 5, 3, 2, 6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _channels_last(x):
    """The NHWC view of channels_last memory that the port's convolutions
    return: not contiguous as NHWC."""
    t = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    return t


# (class name, constructor kwargs, input shape, input type, extra inputs)
CASES = [
    ("CnnToFeedForwardPreProcessor", {"height": H, "width": W, "channels": C}, (B, H, W, C),
     ("convolutional", (H, W, C))),
    ("FeedForwardToCnnPreProcessor", {"height": H, "width": W, "channels": C},
     (B, H * W * C), ("convolutional_flat", (H, W, C))),
    ("RnnToFeedForwardPreProcessor", {}, (B, T, C), ("recurrent", (C, T))),
    ("FeedForwardToRnnPreProcessor", {"timesteps": T}, (B * T, C), ("feed_forward", (C,))),
    ("CnnToRnnPreProcessor", {}, (B, H, W, C), ("convolutional", (H, W, C))),
    ("RnnToCnnPreProcessor", {"height": H, "width": W, "channels": C}, (B, T, H * W * C),
     ("recurrent", (H * W * C, T))),
]


@pytest.mark.parametrize("name,kw,shape,it", CASES, ids=[c[0] for c in CASES])
def test_preprocessor_matches_jax_bitwise(name, kw, shape, it):
    jp, tp = getattr(jpp, name)(**kw), getattr(tpp, name)(**kw)
    x = _x(shape)
    want = np.asarray(jp.pre_process(jnp.asarray(x)))
    got = tp.pre_process(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if len(shape) == 4:  # from a channels_last view, as the convolutions give it
        np.testing.assert_array_equal(tp.pre_process(_channels_last(x)).numpy(), want)
    kind, args = it
    jt, tt = getattr(InputType, kind)(*args), getattr(TInputType, kind)(*args)
    assert tp.output_type(tt).to_dict() == jp.output_type(jt).to_dict()
    d = json.loads(json.dumps(jp.to_dict()))
    assert json.loads(json.dumps(tp.to_dict())) == d
    assert tpp.InputPreProcessor.from_dict(d) == tp
    assert jpp.InputPreProcessor.from_dict(json.loads(json.dumps(tp.to_dict()))) == jp


def test_pass_through_inputs_match_jax():
    """FeedForwardToCnn leaves an image as it is, FeedForwardToRnn a
    sequence, and FeedForwardToRnn without timesteps its 2-D input."""
    img, seq = _x((B, H, W, C)), _x((B, T, C))
    for jp, tp, x in ((jpp.FeedForwardToCnnPreProcessor(H, W, C),
                       tpp.FeedForwardToCnnPreProcessor(H, W, C), img),
                      (jpp.FeedForwardToRnnPreProcessor(T), tpp.FeedForwardToRnnPreProcessor(T),
                       seq),
                      (jpp.FeedForwardToRnnPreProcessor(), tpp.FeedForwardToRnnPreProcessor(),
                       _x((B, C)))):
        got = tp.pre_process(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jp.pre_process(jnp.asarray(x))))
        np.testing.assert_array_equal(got, x)


def _lenet_like(input_type, **conv):
    return (NeuralNetConfiguration.builder().seed(3).updater(Sgd(0.05)).list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3), activation="relu", **conv))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(1, 1)))
            .layer(DenseLayer(n_out=6, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(input_type).build())


@pytest.mark.parametrize("flat", [True, False], ids=["convolutional_flat", "convolutional"])
def test_builder_inserts_the_jax_preprocessors(flat):
    """A flattened image gets FeedForwardToCnn before the first convolution
    (``convolutional_flat``), an image CnnToFeedForward before the dense
    layer; the port's builder writes the JAX builder's JSON, and reads it."""
    it = (InputType.convolutional_flat if flat else InputType.convolutional)(H, W, C)
    jconf = _lenet_like(it, convolution_mode="same")
    tconf = tconfig.MultiLayerConfiguration.from_json(jconf.to_json())
    want = json.loads(jconf.to_json())
    assert json.loads(tconf.to_json()) == want
    assert sorted(want["preprocessors"]) == (["0", "2"] if flat else ["2"])
    assert [t.to_dict() for t in tconf.layer_input_types] == \
        [t.to_dict() for t in jconf.layer_input_types]
    from deeplearning4j_tpu_torch.nn import (ConvolutionLayer as TConv, DenseLayer as TDense,
                                             NeuralNetConfiguration as TNN,
                                             OutputLayer as TOut, SubsamplingLayer as TSub)
    from deeplearning4j_tpu_torch.train.updaters import Sgd as TSgd
    built = (TNN.builder().seed(3).updater(TSgd(0.05)).list()
             .layer(TConv(n_out=4, kernel_size=(3, 3), activation="relu",
                          convolution_mode="same"))
             .layer(TSub(kernel_size=(2, 2), stride=(1, 1)))
             .layer(TDense(n_out=6, activation="relu"))
             .layer(TOut(n_out=3, activation="softmax"))
             .set_input_type((TInputType.convolutional_flat if flat
                              else TInputType.convolutional)(H, W, C)).build())
    assert json.loads(built.to_json()) == want


def test_explicit_preprocessor_is_kept_and_flat_input_into_a_convolution_is_refused():
    from deeplearning4j_tpu_torch.nn import (ConvolutionLayer as TConv, DenseLayer as TDense,
                                             NeuralNetConfiguration as TNN)
    conf = (TNN.builder().list().layer(TConv(n_out=2, kernel_size=(1, 1)))
            .layer(TDense(n_out=3))
            .input_pre_processor(0, tpp.FeedForwardToCnnPreProcessor(H, W, C))
            .set_input_type(TInputType.feed_forward(H * W * C)).build())
    assert conf.preprocessors[0] == tpp.FeedForwardToCnnPreProcessor(H, W, C)
    assert conf.preprocessors[1] == tpp.CnnToFeedForwardPreProcessor(H, W, 2)
    back = tconfig.MultiLayerConfiguration.from_json(conf.to_json())
    assert back.preprocessors == conf.preprocessors
    with pytest.raises(ValueError, match="convolutional_flat"):
        (TNN.builder().list().layer(TConv(n_out=2))
         .set_input_type(TInputType.feed_forward(16)).build())
    with pytest.raises(ValueError, match="convolutional_flat"):
        (NeuralNetConfiguration.builder().list().layer(ConvolutionLayer(n_out=2))
         .set_input_type(InputType.feed_forward(16)).build())


@pytest.mark.parametrize("flat", [True, False], ids=["convolutional_flat", "convolutional"])
def test_network_through_preprocessors_matches_jax(flat, tmp_path):
    """The JAX network restored in the port: output, each layer's
    activation (``feed_forward``), and one ``fit`` step's loss and
    weights; the dense layer's W lines up only if the flatten is (h, w, c)."""
    import jax
    it = (InputType.convolutional_flat if flat else InputType.convolutional)(H, W, C)
    jnet = JNet(_lenet_like(it)).init()
    path = str(tmp_path / "net.zip")
    jnet.save(path)
    net = MultiLayerNetwork.load(path, device="cpu")
    x = _x((B, H * W * C) if flat else (B, H, W, C), seed=1)
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=1e-5, atol=1e-5)
    for i, (a, b) in enumerate(zip(net.feed_forward(x), jnet.feed_forward(x), strict=True)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=f"activation {i}")
    y = np.eye(3, dtype=np.float32)[[0, 2]]
    jnet.fit(x, y)
    net.fit(x, y)
    np.testing.assert_allclose(float(net.score()), float(jnet.score()), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jnet.train_state.params),
                    [t for k in sorted(net.params()) for _, t in
                     sorted(net.params()[k].items())], strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def _graph(vertex: bool):
    """conv(4, 5, 3) -> [PreprocessorVertex(CnnToFeedForward) ->] dense ->
    softmax: with the vertex, or with the preprocessor the graph inserts."""
    g = (NeuralNetConfiguration.builder().seed(5).updater(Sgd(0.1)).graph_builder()
         .add_inputs("in")
         .add_layer("conv", ConvolutionLayer(n_out=2, kernel_size=(2, 2),
                                             activation="tanh"), "in"))
    src = "conv"
    if vertex:
        g.add_vertex("flat", JPreprocessorVertex(jpp.CnnToFeedForwardPreProcessor(3, 4, 2)),
                     "conv")
        src = "flat"
    g.add_layer("fc", DenseLayer(n_out=5, activation="relu"), src)
    g.add_layer("out", OutputLayer(n_out=3, activation="softmax"), "fc")
    return g.set_outputs("out").set_input_types(InputType.convolutional(H, W, C)).build()


@pytest.mark.parametrize("vertex", [True, False], ids=["preprocessor_vertex", "inserted"])
def test_graph_preprocessor_matches_jax(vertex, tmp_path):
    jnet = JGraph(_graph(vertex)).init()
    path = str(tmp_path / "graph.zip")
    jnet.save(path)
    net = ModelSerializer.restore_model(path, device="cpu")
    x = _x((B, H, W, C), seed=2)
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=1e-5, atol=1e-5)
    fc = net.conf.node("fc")
    assert (fc.inputs_preprocessor is None) == vertex
    assert net.conf.node_input_types["fc"] == TInputType.feed_forward(3 * 4 * 2)
    y = np.eye(3, dtype=np.float32)[[1, 2]]
    jnet.fit(x, y)
    net.fit(x, y)
    np.testing.assert_allclose(float(net.score()), float(jnet.score()), rtol=1e-5)
