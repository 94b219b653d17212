"""The port's int8 quantization ops, quantized archives, quantized serving
and the accuracy gate, against the JAX package.

Mirrors ``tests/test_ops_quantize.py`` (every case, with the port's op beside
the JAX op on the same inputs: codes byte for byte, half-way values and the
narrow range included) and ``tests/test_quantize_serving.py`` (all but the
fleet-router and HTTP-server cases, which come with serving's host side) on
``deeplearning4j_tpu_torch``. Against live JAX runs: one source archive and
one calibration set quantized by both packages give the same codes, scales,
float leaves, state and policy JSON byte for byte; an archive quantized by
either package serves in the other within 1e-5 relative in float32 for both
weight residencies; the two packages' gates report the same numbers.

The mixed-dtype and gate-pass cases are held against live JAX calls of the
same archives, and the port's own bit identity and zero captures on traffic
are asserted where it meets them.
"""

import io
import json
import os
import threading
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff.ops_registry import OPS as JOPS
from deeplearning4j_tpu.models import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.nn import DenseLayer as JDense
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import OutputLayer as JOutput
from deeplearning4j_tpu.serving import ModelRegistry as JRegistry
from deeplearning4j_tpu.serving import quantize as jq
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu_torch.autodiff.ops_registry import OPS
from deeplearning4j_tpu_torch.models import ModelSerializer
from deeplearning4j_tpu_torch.runtime import profiler
from deeplearning4j_tpu_torch.runtime.chaos import ChaosController, CorruptBytes, FailNth
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.serving import ModelRegistry, WarmupManifest
from deeplearning4j_tpu_torch.serving.quantize import (AccuracyGate, AccuracyGateFailed,
                                                       CalibrationError, DtypePolicy,
                                                       QuantizedModel, calibrate_inputs,
                                                       dequantize_weight, policy_path,
                                                       quantize_archive, quantize_requests,
                                                       quantize_weight)

quant = OPS["quantize"]
dequant = OPS["dequantize"]

RNG = np.random.default_rng(42)
X = RNG.normal(size=(16, 8)).astype(np.float32)
CALIB = RNG.normal(size=(64, 8)).astype(np.float32)
BATCHER_KW = dict(max_batch_size=4, buckets=[1, 4], batch_timeout_ms=1.0, pipeline_depth=1)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype, env.aot_dispatch)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    env.set_aot_dispatch(True)
    yield
    env.device, env.default_dtype, env.compute_dtype, env.aot_dispatch = saved


def _jax_conf(seed=7):
    return (JConf.builder().seed(seed).updater(JSgd(0.1)).list()
            .layer(JDense(n_out=16, activation="tanh"))
            .layer(JOutput(n_out=4, activation="softmax"))
            .set_input_type(JInputType.feed_forward(8)).build())


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """One f32 archive (written by the JAX package) and the port's int8 twin
    (+ policy sidecar)."""
    td = tmp_path_factory.mktemp("quant")
    src, dst = str(td / "model.zip"), str(td / "model.int8.zip")
    JSerializer.write_model(JMultiLayerNetwork(_jax_conf()).init(), src)
    policy, report = quantize_archive(src, dst, CALIB)
    return src, dst, policy, report


def _pad_rows(x, bucket):
    return np.concatenate([x, np.zeros((bucket - x.shape[0],) + x.shape[1:], x.dtype)])


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _roundtrip(x, **kw):
    dq_kw = {k: kw[k] for k in ("scale", "zero_point", "axis") if k in kw}
    q = quant(x, **kw)
    return _np(q), _np(dequant(q, **dq_kw))


def _same_as_jax(x, **kw):
    """The port's codes (and their dequantization) byte for byte the JAX
    op's on the same inputs."""
    dq_kw = {k: kw[k] for k in ("scale", "zero_point", "axis") if k in kw}
    got, want = _np(quant(x, **kw)), np.asarray(JOPS["quantize"](x, **kw))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    back, jback = _np(dequant(got, **dq_kw)), np.asarray(JOPS["dequantize"](want, **dq_kw))
    assert back.dtype == jback.dtype and back.tobytes() == jback.tobytes()


# ================================================================== the ops
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_roundtrip_error_bounded_per_tensor_symmetric(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (32, 16)).astype(np.float32)
    scale = float(np.abs(x).max()) / 127.0
    q, back = _roundtrip(x, scale=scale, zero_point=0, narrow_range=True)
    assert q.dtype == np.int8
    assert np.abs(back - x).max() <= scale / 2 + 1e-6
    _same_as_jax(x, scale=scale, zero_point=0, narrow_range=True)


@pytest.mark.parametrize("seed", [0, 7])
def test_roundtrip_error_bounded_per_channel(seed):
    rng = np.random.default_rng(seed)
    mags = np.array([0.01, 0.1, 1.0, 10.0], np.float32)
    x = rng.normal(0, 1, (64, 4)).astype(np.float32) * mags
    scale = np.abs(x).max(axis=0) / 127.0
    q, back = _roundtrip(x, scale=scale, zero_point=0, axis=-1, narrow_range=True)
    assert q.dtype == np.int8
    err = np.abs(back - x)
    for c in range(4):
        assert err[:, c].max() <= scale[c] / 2 + 1e-5 * mags[c]
    pt_scale = float(np.abs(x).max()) / 127.0
    _, back_pt = _roundtrip(x, scale=pt_scale, zero_point=0)
    assert err[:, 0].max() < np.abs(back_pt - x)[:, 0].max()
    _same_as_jax(x, scale=scale, zero_point=0, axis=-1, narrow_range=True)


def test_roundtrip_asymmetric_uint8():
    rng = np.random.default_rng(3)
    x = rng.uniform(0.5, 4.5, (128, 8)).astype(np.float32)
    lo, hi = float(x.min()), float(x.max())
    scale = (hi - lo) / 255.0
    zp = int(round(-lo / scale))
    q, back = _roundtrip(x, scale=scale, zero_point=zp, dtype="uint8")
    assert q.dtype == np.uint8
    assert np.abs(back - x).max() <= scale / 2 + 1e-5
    _same_as_jax(x, scale=scale, zero_point=zp, dtype="uint8")


def test_per_channel_zero_point_array():
    rng = np.random.default_rng(11)
    offs = np.array([0.0, 2.0, -3.0], np.float32)
    x = rng.uniform(-1, 1, (64, 3)).astype(np.float32) + offs
    lo = np.minimum(x.min(axis=0), 0.0)
    hi = np.maximum(x.max(axis=0), 0.0)
    scale = ((hi - lo) / 255.0).astype(np.float32)
    zp = np.clip(np.round(-lo / scale), 0, 255).astype(np.int32)
    q, back = _roundtrip(x, scale=scale, zero_point=zp, axis=-1, dtype="uint8")
    assert q.dtype == np.uint8
    assert np.abs(back - x).max() <= scale.max() / 2 + 1e-5
    _same_as_jax(x, scale=scale, zero_point=zp, axis=-1, dtype="uint8")


def test_f64_inputs_accepted():
    rng = np.random.default_rng(5)
    x64 = rng.normal(0, 1, (16, 4))
    scale = float(np.abs(x64).max()) / 127.0
    q = _np(quant(x64, scale=scale, narrow_range=True))
    assert q.dtype == np.int8
    back = _np(dequant(q, scale=scale, dtype="float64"))
    assert np.issubdtype(back.dtype, np.floating)
    assert np.abs(back - x64.astype(np.float32)).max() <= scale / 2 + 1e-6
    _same_as_jax(x64, scale=scale, narrow_range=True)


def test_narrow_range_never_emits_most_negative_code():
    x = np.array([-1e9, -4.0, 0.0, 4.0, 1e9], np.float32)
    q = _np(quant(x, scale=4.0 / 127.0, narrow_range=True))
    assert q.min() >= -127 and q.max() <= 127
    assert _np(quant(x, scale=4.0 / 127.0)).min() == -128
    _same_as_jax(x, scale=4.0 / 127.0, narrow_range=True)
    _same_as_jax(x, scale=4.0 / 127.0)


def test_half_way_values_round_to_even_as_jax():
    """Exact half-way quotients (x / scale = k + 0.5) round to even in
    both packages, signs and the narrow range's edge included."""
    x = np.array([-127.5, -126.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.5, 127.5],
                 np.float32)
    q = _np(quant(x, scale=1.0))
    assert list(q) == [-128, -126, -2, -2, 0, 0, 2, 2, 126, 127]
    assert list(_np(quant(x, scale=1.0, narrow_range=True)))[0] == -127
    for nr in (False, True):
        _same_as_jax(x, scale=1.0, narrow_range=nr)
        _same_as_jax(x * 0.25, scale=0.25, narrow_range=nr)


def test_out_of_range_saturates():
    x = np.array([-100.0, 100.0], np.float32)
    q = _np(quant(x, scale=1.0 / 127.0))
    assert q[0] == -128 and q[1] == 127
    qu = _np(quant(x, scale=1.0 / 255.0, zero_point=128, dtype="uint8"))
    assert qu[0] == 0 and qu[1] == 255
    _same_as_jax(x, scale=1.0 / 255.0, zero_point=128, dtype="uint8")


def test_integer_input_is_cast_not_rejected():
    q = _np(quant(np.array([1, 2, 3], np.int32), scale=0.5))
    assert q.dtype == np.int8 and list(q) == [2, 4, 6]


def test_bad_per_channel_scale_rank_raises():
    with pytest.raises(ValueError, match="per-channel"):
        quant(np.zeros((4, 4), np.float32), scale=np.ones((2, 2), np.float32), axis=-1)


def test_axis_broadcast_on_leading_axis():
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (3, 32)).astype(np.float32) * \
        np.array([[0.1], [1.0], [10.0]], np.float32)
    scale = np.abs(x).max(axis=1) / 127.0
    q, back = _roundtrip(x, scale=scale, zero_point=0, axis=0, narrow_range=True)
    err = np.abs(back - x)
    for r in range(3):
        assert err[r].max() <= scale[r] / 2 + 1e-5
    _same_as_jax(x, scale=scale, zero_point=0, axis=0, narrow_range=True)


@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_weight_roundtrip_bound(per_channel):
    """The per-output-channel (and per-tensor) weight quantizer: error at
    most scale/2, codes and scales byte for byte the JAX package's."""
    rng = np.random.default_rng(21 if per_channel else 22)
    w = (rng.normal(0, 1, (64, 16)).astype(np.float32)
         * rng.uniform(0.01, 5.0, 16).astype(np.float32))
    q, scale = quantize_weight(w, per_channel=per_channel)
    assert q.dtype == np.int8 and np.abs(q).max() <= 127
    assert scale.shape == ((16,) if per_channel else ())
    back = dequantize_weight(q, scale)
    assert (np.abs(back - w) <= np.broadcast_to(scale, w.shape) / 2 + 1e-6).all()
    jqw, jscale = jq.quantize_weight(w, per_channel=per_channel)
    assert q.tobytes() == np.asarray(jqw).tobytes()
    assert scale.tobytes() == np.asarray(jscale).tobytes()
    assert back.tobytes() == np.asarray(jq.dequantize_weight(jqw, jscale)).tobytes()


# ======================================================= archives across packages
def _members(path):
    with zipfile.ZipFile(path) as z:
        out = {m: json.loads(z.read(m)) for m in ("quantization.json", "metadata.json")}
        for m in ("qweights.npz", "qstate.npz"):
            with np.load(io.BytesIO(z.read(m))) as f:
                out[m] = {k: f[k] for k in f.files}
    out["quantization.json"]["policy"].pop("created_at")
    return out


@pytest.mark.parametrize("residency", ["dequantized", "int8"])
def test_archive_codes_scales_and_policy_match_jax_byte_for_byte(archives, tmp_path,
                                                                   residency):
    src = archives[0]
    pj, rj = jq.quantize_archive(src, str(tmp_path / "j.zip"), CALIB,
                                 weight_residency=residency)
    pp, rp = quantize_archive(src, str(tmp_path / "p.zip"), CALIB,
                              weight_residency=residency)
    a, b = _members(str(tmp_path / "j.zip")), _members(str(tmp_path / "p.zip"))
    for m in ("qweights.npz", "qstate.npz"):
        assert list(a[m]) == list(b[m])
        for k in a[m]:
            assert a[m][k].dtype == b[m][k].dtype and a[m][k].tobytes() == b[m][k].tobytes(), k
    assert a["quantization.json"] == b["quantization.json"]
    assert a["metadata.json"] == b["metadata.json"]
    assert "q|['layer_0']['W']" in b["qweights.npz"]
    sj, sp = (json.load(open(policy_path(str(tmp_path / n)))) for n in ("j.zip", "p.zip"))
    sj.pop("created_at"), sp.pop("created_at")
    assert sj == sp
    for r in (rj, rp):
        r.pop("archive_bytes_dst")
    assert rj == rp


@pytest.mark.parametrize("residency", ["dequantized", "int8"])
def test_quantized_archives_serve_across_packages(archives, tmp_path, residency):
    """A JAX-quantized archive restored and served by the port, and the
    reverse: outputs within 1e-5 relative in float32 on f32 and int8 rows."""
    src = archives[0]
    jdst, pdst = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    policy, _ = jq.quantize_archive(src, jdst, CALIB, weight_residency=residency)
    quantize_archive(src, pdst, CALIB, weight_residency=residency)
    port = ModelSerializer.restore_model(jdst, device="cpu")
    jax = JSerializer.restore_model(pdst)
    assert isinstance(port, QuantizedModel) and isinstance(jax, jq.QuantizedModel)
    if residency == "int8":
        leaf = port._params["layer_0"]["W"]
        assert leaf["__q__"].dtype == torch.int8 and leaf["__scale__"].dtype == torch.float32
    qx = quantize_requests(X, DtypePolicy.from_dict(policy.to_dict()))
    for x in (X, qx):
        np.testing.assert_allclose(port.output(x).numpy(), np.asarray(jax.output(x)),
                                   rtol=1e-5, atol=0)
    reg = ModelRegistry()
    try:
        served = reg.load("q", jdst, **BATCHER_KW, warmup_example=X[:1], save_manifest=False)
        assert served.batcher.dtype_policy is not None
        for x in (X[:3], qx[:3]):
            np.testing.assert_allclose(reg.predict("q", x), np.asarray(jax.output(x))[:3],
                                       rtol=1e-5, atol=0)
    finally:
        reg.shutdown()


def test_residencies_answer_alike_in_float32(archives, tmp_path):
    """In float32 the in-graph ``q * scale`` is the dequantized weight bit
    for bit, so both residencies answer alike."""
    src = archives[0]
    quantize_archive(src, str(tmp_path / "d.zip"), CALIB)
    quantize_archive(src, str(tmp_path / "i.zip"), CALIB, weight_residency="int8")
    d = ModelSerializer.restore_model(str(tmp_path / "d.zip"), device="cpu")
    i = ModelSerializer.restore_model(str(tmp_path / "i.zip"), device="cpu")
    assert np.array_equal(d.output(X).numpy(), i.output(X).numpy())


# ============================================================ archive round trip
def test_quantize_archive_restore_and_report(archives):
    src, dst, policy, report = archives
    assert os.path.exists(policy_path(dst))
    side = DtypePolicy.load(policy_path(dst))
    assert side.label() == policy.label()
    assert side.inputs.keys() == policy.inputs.keys()
    assert report["weights_quantized"] == 2
    assert report["params_bytes_quantized"] < report["params_bytes_f32"]
    qm = ModelSerializer.restore_model(dst, device="cpu")
    assert isinstance(qm, QuantizedModel)
    f32 = ModelSerializer.restore_model(src, device="cpu", load_updater=False)
    ref = f32.output(X).numpy()
    assert np.abs(qm.output(X).numpy() - ref).max() < 0.05
    qx = quantize_requests(X, policy)
    assert qx.dtype == np.int8
    assert np.abs(qm.output(qx).numpy() - ref).max() < 0.05


def test_double_quantization_refused(archives):
    _, dst, _, _ = archives
    with pytest.raises(ValueError, match="already a quantized archive"):
        quantize_archive(dst, dst + ".again", CALIB)


# ================================================ registry load + restart replay
def test_quantized_load_and_manifest_prewarmed_restart(archives, tmp_path):
    _, dst, policy, _ = archives
    qx = quantize_requests(X, policy)
    reg = ModelRegistry()
    try:
        served = reg.load("q", dst, warmup_example=X[:1], **BATCHER_KW)
        assert served.batcher.dtype_policy is not None
        warmed = served.batcher.compile_count()
        assert warmed == 2 * len(served.batcher.buckets) * served.batcher.replica_count
        out_q = reg.predict("q", qx[:3])
        out_f = reg.predict("q", X[:3])
        assert served.batcher.compile_count() == warmed
        man = served.batcher.warmup_manifest()
        assert {"float32", "int8"} <= {p[2] for p in man.pairs}
        assert man.policy is not None
        assert man.policy["inputs"].keys() == policy.inputs.keys()
    finally:
        reg.shutdown()
    assert WarmupManifest.load_for_archive(dst) is not None
    reg2 = ModelRegistry()
    try:
        served2 = reg2.load("q", dst)
        ready = served2.batcher.compile_count()
        out_q2 = reg2.predict("q", qx[:3])
        out_f2 = reg2.predict("q", X[:3])
        assert served2.batcher.compile_count() == ready
        assert np.array_equal(out_q, out_q2)
        assert np.array_equal(out_f, out_f2)
    finally:
        reg2.shutdown()


def test_per_bucket_policy_restricts_prewarm(archives):
    _, dst, _, _ = archives
    qm = ModelSerializer.restore_model(dst, device="cpu")
    qm.dtype_policy.quantized_buckets = [4]
    qx = quantize_requests(X, qm.dtype_policy)
    reg = ModelRegistry()
    try:
        served = reg.register("q", qm, warmup_example=X[:1], **BATCHER_KW)
        b = served.batcher
        warmed = b.compile_count()
        assert warmed == (len(b.buckets) + 1) * b.replica_count
        assert {p[0] for p in b._warmed_pairs if p[2] == "int8"} == {4}
        reg.predict("q", qx[:3])
        assert b.compile_count() == warmed
        reg.predict("q", qx[:1])
        assert b.compile_count() == warmed + 1
    finally:
        reg.shutdown()


# ==================================================== concurrent mixed load
def test_mixed_dtype_concurrent_load_bit_identical(archives):
    """8 threads of interleaved f32 and int8 traffic: every answer is bit
    for bit the port's own model at the padded bucket shape it was served
    at (alone or coalesced) and within
    1e-5 relative of the JAX package's ``QuantizedModel`` on the same rows,
    nothing is captured after warm-up (graphs and pad buffers per dtype),
    and the quantized share of traffic is counted."""
    _, dst, policy, _ = archives
    qm = ModelSerializer.restore_model(dst, device="cpu")
    jqm = JSerializer.restore_model(dst)
    qx_all = quantize_requests(X, policy)
    reg = ModelRegistry()
    try:
        served = reg.register("q", qm, warmup_example=X[:1], **BATCHER_KW)
        b = served.batcher
        warmed = b.compile_count()
        # the answer at each bucket a request of n rows may land in (alone,
        # or coalesced with others into a larger one)
        refs = {}
        for n in (1, 2, 3):
            for tag, xs in (("f32", X), ("int8", qx_all)):
                refs[(tag, n)] = [qm.output(_pad_rows(xs[:n], bk)).numpy()[:n]
                                  for bk in b.buckets if bk >= n]
                for ref in refs[(tag, n)]:
                    np.testing.assert_allclose(ref, np.asarray(jqm.output(xs[:n])),
                                               rtol=1e-5, atol=0)
        failures = []

        def client(tid):
            rng = np.random.default_rng(tid)
            for k in range(25):
                n = int(rng.integers(1, 4))
                quantized = bool((tid + k) % 2)
                x = qx_all[:n] if quantized else X[:n]
                out = reg.predict("q", x, timeout_ms=30000)
                if not any(np.array_equal(out, r)
                           for r in refs[("int8" if quantized else "f32", n)]):
                    failures.append((tid, k, quantized, n))

        threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not failures, f"non-bit-identical responses: {failures[:5]}"
        assert b.compile_count() == warmed
        dtypes = {k[3] for k in b._buf_pool}
        assert {np.dtype(np.float32).str, np.dtype(np.int8).str} <= dtypes
        snap = served.metrics.snapshot()
        assert snap["requests_total"] == 8 * 25
        assert snap["quantized_requests_total"] == 8 * 25 // 2
        assert snap["quant_responses"] + snap["float_responses"] == snap["responses_total"]
        assert snap["dtype_policy"] == policy.label()
        split = profiler.quant_split_stats()["q"]
        assert split["quantized_requests_total"] == 8 * 25 // 2
        assert split["latency_quant_p50_s"] is not None
    finally:
        reg.shutdown()


# ======================================================== accuracy gate
def test_accuracy_gate_pass_deploys_quantized(archives):
    """The JAX case's calls on both packages. Under the archive's declared
    bar (max_delta 0.02) both refuse, with the same report: 3 of the 64
    rows change their top-1 on this model, so the JAX case's expected pass
    does not hold in either package. Under a 0.1 bar both deploy with the
    same report, the candidate hot-swaps in and quantized traffic serves."""
    src, dst, _, _ = archives
    reg = ModelRegistry()
    jreg = JRegistry()
    try:
        reg.load("m", src, warmup_example=X[:1], **BATCHER_KW, save_manifest=False)
        jreg.load("m", src, warmup_example=X[:1], **BATCHER_KW, save_manifest=False)
        with pytest.raises(AccuracyGateFailed) as port_err:
            reg.deploy_quantized("m", dst, eval_inputs=CALIB, **BATCHER_KW)
        with pytest.raises(jq.AccuracyGateFailed) as jax_err:
            jreg.deploy_quantized("m", dst, eval_inputs=CALIB, **BATCHER_KW)
        assert port_err.value.report == jax_err.value.report
        assert reg.get("m").version == 1
        served = reg.deploy_quantized("m", dst, eval_inputs=CALIB,
                                      gate=AccuracyGate(max_delta=0.1), **BATCHER_KW)
        jserved = jreg.deploy_quantized("m", dst, eval_inputs=CALIB,
                                        gate=jq.AccuracyGate(max_delta=0.1), **BATCHER_KW)
        assert served.version == jserved.version == 2
        assert isinstance(served.model, QuantizedModel)
        assert served.gate_report == jserved.gate_report
        assert served.gate_report["passed"] is True
        assert served.gate_report["accuracy_delta"] <= served.gate_report["max_delta"]
        qx = quantize_requests(X, served.model.dtype_policy)
        reg.predict("m", qx[:2])
        assert served.metrics.snapshot()["quantized_requests_total"] == 1
    finally:
        reg.shutdown()
        jreg.shutdown()


def test_accuracy_gate_fail_leaves_f32_serving(archives):
    src, dst, _, _ = archives
    reg = ModelRegistry()
    try:
        reg.load("m", src, warmup_example=X[:1], **BATCHER_KW, save_manifest=False)
        before = reg.predict("m", X[:2])
        v1 = reg.get("m")
        with pytest.raises(AccuracyGateFailed) as ei:
            reg.deploy_quantized("m", dst, eval_inputs=CALIB,
                                 gate=AccuracyGate(max_delta=-1.0), **BATCHER_KW)
        assert ei.value.report["passed"] is False
        served = reg.get("m")
        assert served is v1 and served.version == 1
        assert not isinstance(served.model, QuantizedModel)
        assert np.array_equal(before, reg.predict("m", X[:2]))
        assert served.metrics.snapshot().get("quantized_requests_total", 0) == 0
    finally:
        reg.shutdown()


def test_gate_chaos_fault_also_rolls_back(archives):
    src, dst, _, _ = archives
    reg = ModelRegistry()
    try:
        reg.load("m", src, warmup_example=X[:1], **BATCHER_KW, save_manifest=False)
        with ChaosController(seed=5) as c:
            c.on("serving.quantize.gate", FailNth(1))
            with pytest.raises(Exception):
                reg.deploy_quantized("m", dst, eval_inputs=CALIB, **BATCHER_KW)
        assert reg.get("m").version == 1
        reg.predict("m", X[:2])
    finally:
        reg.shutdown()


# ==================================================== calibration chaos
def test_corrupt_calibration_refuses_deploy(archives, tmp_path):
    src = archives[0]
    out = str(tmp_path / "corrupt.int8.zip")
    with ChaosController(seed=3) as c:
        c.on("serving.quantize.calibrate", CorruptBytes(n_bytes=4, mode="flip"))
        with pytest.raises(CalibrationError, match="CRC"):
            quantize_archive(src, out, CALIB)
        assert any(ev[0] == "serving.quantize.calibrate" for ev in c.events)
    assert not os.path.exists(out) and not os.path.exists(policy_path(out))


def test_truncated_calibration_refuses_deploy(archives, tmp_path):
    src = archives[0]
    out = str(tmp_path / "trunc.int8.zip")
    with ChaosController(seed=4) as c:
        c.on("serving.quantize.calibrate", CorruptBytes(mode="truncate"))
        with pytest.raises(CalibrationError):
            quantize_archive(src, out, CALIB)
    assert not os.path.exists(out) and not os.path.exists(policy_path(out))


def test_nonfinite_and_empty_calibration_refused():
    bad = CALIB.copy()
    bad[3, 2] = np.nan
    with pytest.raises(CalibrationError, match="non-finite"):
        calibrate_inputs(bad)
    with pytest.raises(CalibrationError, match="empty"):
        calibrate_inputs(np.zeros((0, 8), np.float32))
    assert calibrate_inputs(CALIB) == jq.calibrate_inputs(CALIB)
    assert calibrate_inputs(CALIB, dtype="uint8") == jq.calibrate_inputs(CALIB, dtype="uint8")


def test_plain_integer_rows_are_not_dequantized(archives):
    _, dst, _, _ = archives
    qm = ModelSerializer.restore_model(dst, device="cpu")
    xi = RNG.integers(-3, 4, size=(4, 8))
    for dt in (np.int64, np.int32):
        assert np.array_equal(qm.output(xi.astype(dt)).numpy(),
                              qm.output(xi.astype(np.float32)).numpy())


def test_weights_only_quantization_leaves_rows_alone(archives, tmp_path):
    """``calibration=None``: no input spec, so no request row is ever read
    as codes and no int8 twin is warmed (token ids are indices)."""
    src = archives[0]
    policy, report = quantize_archive(src, str(tmp_path / "w.zip"), None,
                                      quantized_buckets=[])
    assert policy.inputs == {} and report["inputs"] == {}
    assert policy.quantized_zeros(X[:1]) is None
    assert np.array_equal(quantize_requests(X, policy), X)
    reg = ModelRegistry()
    try:
        served = reg.load("w", str(tmp_path / "w.zip"), warmup_example=X[:1], **BATCHER_KW)
        assert served.batcher.compile_count() == len(served.batcher.buckets)
    finally:
        reg.shutdown()


def test_quant_metrics_detached_on_undeploy_swap_and_shutdown(archives):
    src, dst, _, _ = archives
    reg = ModelRegistry()
    try:
        for name in ("gone", "swapped", "stays"):
            reg.load(name, dst, warmup_example=X[:1], **BATCHER_KW, save_manifest=False)
        assert {"gone", "swapped", "stays"} <= profiler.quant_split_stats().keys()
        reg.undeploy("gone")
        reg.load("swapped", src, warmup_example=X[:1], **BATCHER_KW, save_manifest=False)
        stats = profiler.quant_split_stats()
        assert "gone" not in stats and "swapped" not in stats and "stays" in stats
    finally:
        reg.shutdown()
    assert "stays" not in profiler.quant_split_stats()
