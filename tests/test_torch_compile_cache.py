"""The port's cold-start layer on the CPU: the kernels' build cache, the
captured-graph cache's protocol, and the runtime switches of the
environment.

- ``compile_cache.enable`` moves the kernels' build directory under a
  framework-keyed subdirectory (the JAX package keys by jax version, the
  port by torch, CUDA and ``sm_90a``); ``disable`` gives ``_build/`` back.
- ``load_library`` counts loads (``hits``), builds (``misses``) and
  unloadable files (``corrupt_entries``): a truncated ``.so`` or a fault at
  the ``runtime.compile_cache.load`` chaos point is deleted and built
  again, never fatal. A build here copies the C math library, since the
  CPU has no nvcc.
- ``AotCache`` on CPU tensors: the static-buffer protocol, signature drift
  (eager call, ``aot_fallbacks``), ``clear``/``evict``/``len``, the
  ``aot_dispatch`` switch. The capture itself needs the card
  (``chip_smoke.py --runtime``).
- The environment reads ``DL4J_TPU_PACKED_STATE``, ``DL4J_TPU_DISPATCH_UNROLL``,
  ``DL4J_TPU_AOT_DISPATCH``, ``DL4J_TPU_NAN_PANIC`` and
  ``DL4J_TPU_COMPILE_CACHE`` as the JAX package's does; ``nan_panic`` fails
  a fit at its first non-finite loss.

The JAX package's own ``test_chaos_load_fault_falls_back_to_compile`` is
red on this machine and is no oracle here.
"""

import ctypes.util
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.runtime import environment as jax_environment
from deeplearning4j_tpu_torch.ops.kernels import _native, flash_attention  # noqa: F401
from deeplearning4j_tpu_torch.runtime import compile_cache, environment
from deeplearning4j_tpu_torch.runtime.chaos import ChaosController, FailNth
from deeplearning4j_tpu_torch.runtime.compile_cache import AotCache
from deeplearning4j_tpu_torch.runtime.environment import get_environment


@pytest.fixture(autouse=True)
def _clean():
    env = get_environment()
    saved = (env.device, env.aot_dispatch, env.nan_panic, env.cache_compiled)
    env.set_device("cpu")
    compile_cache.reset_stats()
    yield
    compile_cache.disable()
    env.device, env.aot_dispatch, env.nan_panic, env.cache_compiled = saved


def _libm() -> str:
    name = ctypes.util.find_library("m")
    for d in ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu", "/lib64", "/usr/lib64"):
        if name and os.path.exists(os.path.join(d, name)):
            return os.path.join(d, name)
    pytest.skip("no C math library to stand in for a built kernel")


def test_enable_moves_the_build_directory_under_a_framework_key(tmp_path):
    assert _native.build_dir() == _native.BUILD_DIR and not compile_cache.is_enabled()
    resolved = compile_cache.enable(str(tmp_path))
    key = f"dl4j-tpu-torch-v1-torch{torch.__version__}-cuda{torch.version.cuda}-sm_90a"
    assert resolved == str(tmp_path / key) and os.path.isdir(resolved)
    assert compile_cache.cache_dir() == resolved and _native.build_dir() == pathlib.Path(resolved)
    lib = next(iter(_native._LIBRARIES.values()))
    assert lib._target().parent == pathlib.Path(resolved)
    s = compile_cache.stats()
    assert s["enabled"] and s["cache_dir"] == resolved
    compile_cache.disable()
    assert _native.build_dir() == _native.BUILD_DIR
    with pytest.raises(ValueError, match="needs a directory"):
        compile_cache.enable(None)


def test_set_compile_cache_is_the_builder_form(tmp_path):
    env = get_environment()
    env.set_compile_cache(str(tmp_path))
    assert env.cache_compiled == compile_cache.cache_dir()
    assert env.to_dict()["cache_compiled"] == env.cache_compiled


def test_load_library_counts_hits_misses_and_rebuilds_a_corrupt_file(tmp_path):
    src = _libm()
    path = tmp_path / "kernel-0123.so"
    builds = []

    def build():
        builds.append(1)
        shutil.copy(src, path)

    compile_cache.load_library(path, build)  # absent: built
    compile_cache.load_library(path, build)  # present: loaded
    # a truncated library at a path this process never loaded (truncating a
    # mapped one in place would fault the process, as it would anywhere)
    path = tmp_path / "kernel-89ab.so"
    path.write_bytes(pathlib.Path(src).read_bytes()[:100])
    lib = compile_cache.load_library(path, build)
    assert lib.cos is not None and len(builds) == 2
    s = compile_cache.stats()
    assert (s["misses"], s["hits"], s["corrupt_entries"]) == (2, 1, 1)


def test_a_chaos_load_fault_is_a_corrupt_entry_not_a_crash(tmp_path):
    src = _libm()
    path = tmp_path / "kernel-4567.so"
    shutil.copy(src, path)
    with ChaosController(seed=1) as c:
        c.on("runtime.compile_cache.load", FailNth(1))
        compile_cache.load_library(path, lambda: shutil.copy(src, path))
    s = compile_cache.stats()
    assert (s["corrupt_entries"], s["misses"], s["hits"]) == (1, 1, 0)


def test_every_launch_counter_is_registered():
    from deeplearning4j_tpu_torch.ops.kernels import conv_stats, flash_attention, fused_lstm
    values = _native.counter_values()
    for c in (flash_attention.lse_counter, flash_attention.bwd_dq_counter,
              conv_stats.counter, fused_lstm.save_counter):
        assert c in values


def test_aot_cache_protocol_on_the_cpu():
    aot = AotCache("t")
    seen = []

    def fn(xs, scale):
        seen.append(xs)
        return [x * scale for x in xs]

    a = [torch.arange(4.0), torch.ones(2)]
    out = aot.call("k", fn, a, 2.0)
    assert torch.equal(out[0], a[0] * 2) and seen[0][0] is not a[0]
    b = [torch.arange(4.0) + 1, torch.zeros(2)]
    out = aot.call("k", fn, b, 3.0)
    assert torch.equal(out[0], b[0] * 3) and seen[1][0] is seen[0][0]
    assert compile_cache.stats()["aot_fallbacks"] == 0
    out = aot.call("k", fn, [torch.arange(4.0).double(), torch.ones(2)], 1.0)
    assert out[0].dtype == torch.float64 and len(aot) == 0
    assert compile_cache.stats()["aot_fallbacks"] == 1
    aot.call("k1", fn, a, 1.0)
    aot.call("k2", fn, a, 1.0)
    assert aot.evict(lambda k: k == "k1") == 1 and len(aot) == 1
    aot.clear()
    assert len(aot) == 0
    get_environment().set_aot_dispatch(False)
    aot.call("k", fn, a, 1.0)
    assert len(aot) == 0 and seen[-1] is a


@pytest.mark.parametrize("var,value,field,want", [
    ("PACKED_STATE", "0", "packed_state", False),
    ("PACKED_STATE", "1", "packed_state", True),
    ("DISPATCH_UNROLL", "4", "dispatch_unroll", 4),
    ("DISPATCH_UNROLL", "0", "dispatch_unroll", 1),
    ("AOT_DISPATCH", "false", "aot_dispatch", False),
    ("NAN_PANIC", "1", "nan_panic", True),
])
def test_environment_reads_the_jax_package_variables(monkeypatch, var, value, field, want):
    import jax
    monkeypatch.setenv("DL4J_TPU_" + var, value)
    debug_nans = jax.config.jax_debug_nans  # the JAX package's nan_panic sets it
    try:
        for mod in (environment, jax_environment):
            monkeypatch.setattr(mod, "_instance", None)
            got = getattr(mod.get_environment(), field)
            assert got == want, (mod.__name__, got)
    finally:
        jax.config.update("jax_debug_nans", debug_nans)


def test_environment_reads_the_compile_cache_variable(monkeypatch, tmp_path):
    monkeypatch.setenv("DL4J_TPU_COMPILE_CACHE", str(tmp_path))
    monkeypatch.setattr(environment, "_instance", None)
    env = environment.get_environment()
    assert env.cache_compiled == compile_cache.cache_dir()
    assert env.cache_compiled.startswith(str(tmp_path))


def test_dispatch_unroll_must_be_positive():
    with pytest.raises(ValueError, match=">= 1"):
        get_environment().set_dispatch_unroll(0)


def test_nan_panic_fails_the_fit_at_the_first_non_finite_loss():
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import (DenseLayer, InputType, NeuralNetConfiguration,
                                             OutputLayer)
    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(DenseLayer(n_out=4, activation="tanh"))
            .layer(OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(InputType.feed_forward(3)).build())
    x = np.ones((4, 3), np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1, 0, 1]]
    net = MultiLayerNetwork(conf).init()
    x[0, 0] = np.nan
    net.fit(x, y)  # off: the NaN trains through
    get_environment().set_nan_panic(True)
    with pytest.raises(FloatingPointError, match="nan_panic"):
        MultiLayerNetwork(conf).init().fit(x, y)
