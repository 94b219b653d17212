"""The port stands alone and never falls back to the CPU on its own.

- No file of ``deeplearning4j_tpu_torch/``, nor ``chip_smoke.py`` or
  ``chip_ab.py``, imports ``jax`` or anything of ``deeplearning4j_tpu`` (found by walking
  every ``import`` in their syntax trees, so a lazy import inside a function
  counts too).
- Nor does any worker script that the port, ``chip_smoke.py`` or the port's
  tests embed as a string and run in a subprocess (a module-level string
  constant whose name holds ``WORKER``, concatenations of such constants
  resolved).
- With no GPU and no request for the CPU, every entry point raises; with
  the request, the same calls run on the CPU.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.runtime.environment import get_environment

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "deeplearning4j_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py", REPO / "chip_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu", "optax", "flax")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax_and_nothing_of_the_jax_package(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _worker_sources(path):
    """``{name: source}`` of the module-level worker scripts of ``path``."""
    consts = {}

    def value(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            a, b = value(node.left), value(node.right)
            return a + b if a is not None and b is not None else None
        if isinstance(node, ast.Name):
            return consts.get(node.id)
        return None

    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            v = value(node.value)
            if v is not None:
                consts[node.targets[0].id] = v
    return {k: v for k, v in consts.items() if "WORKER" in k.upper()}


WORKER_FILES = [p for p in PORT_FILES + sorted((REPO / "tests").glob("test_torch_*.py"))
                if _worker_sources(p)]


def test_worker_scan_finds_the_embedded_workers():
    names = {str(p.relative_to(REPO)) for p in WORKER_FILES}
    assert {"chip_smoke.py", "tests/test_torch_distributed.py", "tests/test_torch_multihost.py",
            "tests/test_torch_native_codec.py"} <= names, names


@pytest.mark.parametrize("path", WORKER_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_embedded_worker_scripts_import_no_jax(path, tmp_path):
    for name, src in _worker_sources(path).items():
        probe = tmp_path / f"{name}.py"
        probe.write_text(src)
        bad = [m for m in _imported_modules(probe) if m.split(".")[0] in FORBIDDEN]
        assert not bad, f"{path.relative_to(REPO)}:{name} imports {bad}"


def test_scan_sees_lazy_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from deeplearning4j_tpu.nn import base\n"
                     "    import jax.numpy\n")
    assert [m.split(".")[0] for m in _imported_modules(probe)] == \
        ["deeplearning4j_tpu", "jax"]


@pytest.fixture
def no_gpu(monkeypatch):
    """No GPU, and nobody asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device(None).set_default_dtype("float32").set_compute_dtype("float32")
    yield env
    env.device, env.default_dtype, env.compute_dtype = saved


def _archive(tmp_path):
    from deeplearning4j_tpu_torch.models import ModelSerializer
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    net = TextGenerationLSTM(vocab_size=10, hidden=8, layers=1).init(device="cpu")
    path = str(tmp_path / "net.zip")
    ModelSerializer.write_model(net, path)
    return path


def _entry_points(path):
    from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
    from deeplearning4j_tpu_torch.runtime.mesh import create_mesh
    from deeplearning4j_tpu_torch.serving import ModelRegistry
    from deeplearning4j_tpu_torch.zoo import Bert, ResNet50, TextGenerationLSTM
    from deeplearning4j_tpu_torch.imports import TFGraphMapper
    from deeplearning4j_tpu_torch.imports.graphdef_proto import Message, tensor_proto
    x = np.zeros((1, 3, 10), np.float32)
    gd = Message("GraphDef", node=[
        Message("NodeDef", name="x", op="Placeholder"),
        Message("NodeDef", name="c", op="Const", attr={
            "value": Message("AttrValue", tensor=tensor_proto(np.ones(3, np.float32)))}),
        Message("NodeDef", name="y", op="AddV2", input=["x", "c"])])
    return {
        "TFGraphMapper.import_graph": lambda: TFGraphMapper.import_graph(gd),
        "zoo.init": lambda: TextGenerationLSTM(vocab_size=10, hidden=8, layers=1).init(),
        "zoo.Bert.init": lambda: Bert.small(vocab_size=10).init(),
        "zoo.ResNet50.init": lambda: ResNet50(num_classes=3, height=32, width=32).init(),
        "MultiLayerNetwork.init": lambda: MultiLayerNetwork(
            TextGenerationLSTM(vocab_size=10, hidden=8, layers=1).conf()).init(),
        "MultiLayerNetwork.output": lambda: MultiLayerNetwork(
            TextGenerationLSTM(vocab_size=10, hidden=8, layers=1).conf()).output(x),
        "MultiLayerNetwork.rnn_time_step": lambda: MultiLayerNetwork(
            TextGenerationLSTM(vocab_size=10, hidden=8, layers=1).conf()).rnn_time_step(x),
        "MultiLayerNetwork.fit": lambda: MultiLayerNetwork(
            TextGenerationLSTM(vocab_size=10, hidden=8, layers=1).conf()).fit(x, x),
        "MultiLayerNetwork.load": lambda: MultiLayerNetwork.load(path),
        "ModelSerializer.restore_model": lambda: ModelSerializer.restore_model(path),
        "ModelRegistry.load": lambda: ModelRegistry().load("m", path),
        "mesh.create_mesh": lambda: create_mesh(),
    }


ENTRY_POINTS = ["TFGraphMapper.import_graph", "zoo.init", "zoo.Bert.init", "zoo.ResNet50.init", "MultiLayerNetwork.init",
                "MultiLayerNetwork.output",
                "MultiLayerNetwork.rnn_time_step", "MultiLayerNetwork.fit",
                "MultiLayerNetwork.load",
                "ModelSerializer.restore_model", "ModelRegistry.load", "mesh.create_mesh"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_raises_without_gpu_or_cpu_request(no_gpu, tmp_path, name):
    path = _archive(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points(path)[name]()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_runs_on_cpu_when_asked(no_gpu, tmp_path, name):
    path = _archive(tmp_path)
    no_gpu.set_device("cpu")
    out = _entry_points(path)[name]()
    if hasattr(out, "shutdown"):  # the registry's batcher thread
        out.shutdown()
    elif hasattr(out, "batcher"):
        out.batcher.shutdown()


def test_device_argument_asks_for_the_cpu(no_gpu, tmp_path):
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    net = MultiLayerNetwork.load(_archive(tmp_path), device="cpu")
    assert net.device == torch.device("cpu")
    assert net.output(np.zeros((1, 2, 10), np.float32)).device.type == "cpu"


def test_kernel_wrappers_take_the_plain_version_only_for_cpu_tensors(monkeypatch):
    """A tensor on any device but the CPU goes to the kernel launcher (or
    the call raises); the wrappers hold no fallback."""
    from deeplearning4j_tpu_torch.ops.kernels import (flash_attention, fused_lstm,
                                                      fused_lstm_graves)
    launched = []
    for mod in (fused_lstm, fused_lstm_graves, flash_attention):
        monkeypatch.setattr(mod, "_check", lambda *a: None)
    monkeypatch.setattr(fused_lstm, "launch_lstm_fwd",
                        lambda *a: launched.append("plain") or "kernel")
    monkeypatch.setattr(fused_lstm_graves, "launch_lstm_fwd",
                        lambda *a: launched.append("graves") or "kernel")
    monkeypatch.setattr(flash_attention, "launch_flash_fwd",
                        lambda *a: launched.append("flash") or "kernel")
    meta = [torch.empty(s, device="meta") for s in ((2, 1, 8), (2, 8), (1, 2), (1, 2))]
    assert fused_lstm.fused_lstm(*meta) == "kernel"
    assert fused_lstm_graves.fused_graves_lstm(meta[0], meta[1], None, *meta[2:]) == "kernel"
    qkv = [torch.empty(2, 3, 5, 8, device="meta") for _ in range(3)]
    assert flash_attention.flash_attention(*qkv) == "kernel"
    assert flash_attention.flash_attention_lse(*qkv, causal=True) == "kernel"
    assert launched == ["plain", "graves", "flash", "flash"]
    for mod in (fused_lstm, fused_lstm_graves, flash_attention):
        src = pathlib.Path(mod.__file__).read_text()
        assert not [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Try)], \
            f"{mod.__name__} must not catch a kernel failure"


@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_lse"])
def test_flash_attention_needing_a_gradient_off_the_cpu_raises(monkeypatch, entry):
    """A call autograd records on a tensor off the CPU never runs the plain
    versions: on a device that is not CUDA it raises; past the check it
    launches the saving forward, and its backward launches the backward
    kernels. The same call without a gradient launches the inference
    instance."""
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention
    fn = getattr(flash_attention, entry)
    q = torch.empty(2, 3, 5, 8, device="meta", requires_grad=True)
    k, v = (torch.empty(2, 3, 5, 8, device="meta") for _ in range(2))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fn(q, k, v)
    launched = []

    def fwd(q_, k_, v_, bias, causal, launches, save=False):
        launched.append(("fwd", launches.name))
        o = torch.empty(q_.shape[:3] + v_.shape[3:], device="meta")
        return (o, torch.empty(q_.shape[:3], device="meta")) if save else o

    def bwd(q_, k_, v_, o, lse, do, bias, causal):
        launched.append(("bwd", tuple(do.shape)))
        return torch.empty_like(q_), torch.empty_like(k_), torch.empty_like(v_)

    monkeypatch.setattr(flash_attention, "_check", lambda *a: None)
    monkeypatch.setattr(flash_attention, "launch_flash_fwd", fwd)
    monkeypatch.setattr(flash_attention, "launch_flash_bwd", bwd)
    for name in ("flash_attention_reference", "flash_attention_backward_reference"):
        monkeypatch.setattr(flash_attention, name,
                            lambda *a: pytest.fail("plain version ran for a meta tensor"))
    out = fn(q, k, v)
    o = out[0] if entry == "flash_attention_lse" else out
    (grad,) = torch.autograd.grad(o.sum(), [q])
    assert grad.device.type == "meta"
    assert launched == [("fwd", "flash_attention_lse"), ("bwd", (2, 3, 5, 8))]
    with torch.no_grad():
        fn(q, k, v)
    assert launched[-1] == ("fwd", "flash_attention_lse" if entry == "flash_attention_lse"
                            else "flash_attention")
