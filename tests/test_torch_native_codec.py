"""The port's threshold codec (``deeplearning4j_tpu_torch/native``) against
the JAX package's.

- The C library builds with g++, and a missing compiler raises by name
  (no quiet numpy fallback on the trainer's path).
- Encoded bytes, residuals and decodes equal the JAX codec's bit for bit on
  the same numpy input, sparse and bitmap, at every edge shape of the JAX
  tests (``tests/test_native.py:15-238``), and the port's numpy plain
  versions equal its C library bit for bit.
- The round-trip invariants (mass conservation, every decoded entry
  exactly +-threshold), the input checks, the residual's determinism across
  fresh processes, and ``TreeCodec``'s formats and payloads against the JAX
  ``TreeCodec`` over several steps.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from deeplearning4j_tpu.native import ThresholdCodec as JCodec
from deeplearning4j_tpu.native import TreeCodec as JTreeCodec
from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.native import NativeBuildError, ThresholdCodec, TreeCodec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_EDGE_CASES = [
    ("empty", lambda rng: np.empty(0, np.float32)),
    ("all_below", lambda rng: rng.uniform(-0.05, 0.05, 257).astype(np.float32)),
    ("all_above", lambda rng: np.where(rng.random(64) < 0.5, 1.0, -1.0).astype(np.float32)),
    ("mixed", lambda rng: rng.normal(0, 0.2, 1001).astype(np.float32)),
    ("f64", lambda rng: rng.normal(0, 0.2, 333)),
    ("noncontig", lambda rng: rng.normal(0, 0.2, (100, 6)).astype(np.float32)[:, ::2]),
    ("exact_ties", lambda rng: np.asarray([0.1, -0.1, 0.0, 0.05, -0.0] * 7, np.float32)),
]


def test_library_builds_into_the_ignored_build_directory():
    lib = native.get_lib()
    path = native.library_path()
    assert lib is not None and path.exists()
    assert path.parent.name == "_build" and path.parent.parent.name == "native"


def test_missing_compiler_raises_instead_of_falling_back(monkeypatch, tmp_path):
    def no_compiler(*a, **k):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "_build" / "lib.so")
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    with pytest.raises(NativeBuildError):
        ThresholdCodec(8, 0.1).encode(np.ones(8, np.float32))
    # the plain version needs no library
    assert ThresholdCodec(8, 0.1, plain=True).encode(np.ones(8, np.float32)).size == 8


@pytest.mark.parametrize("label,maker", _EDGE_CASES, ids=[l for l, _ in _EDGE_CASES])
@pytest.mark.parametrize("threshold", [0.1, 0.0])
def test_codec_bytes_equal_the_jax_codec(label, maker, threshold):
    """Sparse and bitmap: encoded bytes, residual and decode of the port's C
    library, its plain numpy version and the JAX codec agree bit for bit,
    three steps in a row (the residual carried)."""
    rng = np.random.default_rng(abs(hash(label)) % 2 ** 31)
    grads = [maker(rng) for _ in range(3)]
    n = int(np.prod(grads[0].shape))
    for encode, decode in (("encode", "decode"), ("encode_bitmap", "decode_bitmap")):
        j, c, p = JCodec(n, threshold), ThresholdCodec(n, threshold), \
            ThresholdCodec(n, threshold, plain=True)
        for g in grads:
            ej, ec, ep = (getattr(k, encode)(g) for k in (j, c, p))
            assert ej.dtype == ec.dtype == ep.dtype
            assert ej.tobytes() == ec.tobytes() == ep.tobytes()
            assert j.residual.tobytes() == c.residual.tobytes() == p.residual.tobytes()
            dj = getattr(j, decode)(ej)
            dc, dp = getattr(c, decode)(ec), getattr(p, decode)(ep)
            assert dj.tobytes() == dc.tobytes() == dp.tobytes()


@pytest.mark.parametrize("label,maker", _EDGE_CASES, ids=[l for l, _ in _EDGE_CASES])
@pytest.mark.parametrize("threshold", [0.1, 0.0])
def test_codec_roundtrip_properties(label, maker, threshold):
    """What was sent plus what stayed in the residual is the input; every
    decoded entry is exactly +-threshold; sparse and bitmap decode alike."""
    rng = np.random.default_rng(abs(hash(label)) % 2 ** 31)
    grad = maker(rng)
    n = int(np.prod(grad.shape))
    flat = np.ascontiguousarray(grad, np.float32).reshape(-1)
    c = ThresholdCodec(n, threshold)
    dec = c.decode(c.encode(grad))
    np.testing.assert_allclose(dec + c.residual, flat, rtol=1e-6, atol=1e-6)
    sent = dec[dec != 0]
    if threshold > 0 and sent.size:
        assert set(np.unique(np.abs(sent))) == {np.float32(threshold)}
    b = ThresholdCodec(n, threshold)
    np.testing.assert_array_equal(b.decode_bitmap(b.encode_bitmap(grad)), dec)
    np.testing.assert_array_equal(b.residual, c.residual)


def test_codec_roundtrip_and_residual_drain():
    n = 1000
    codec = ThresholdCodec(n, threshold=0.1)
    rng = np.random.default_rng(0)
    grad = rng.normal(0, 0.05, n).astype(np.float32)
    grad[:10] = 0.5
    grad[10:20] = -0.5
    encoded = codec.encode(grad)
    assert 20 <= len(encoded) <= n
    decoded = codec.decode(encoded)
    np.testing.assert_allclose(decoded[:10], 0.1)
    np.testing.assert_allclose(decoded[10:20], -0.1)
    np.testing.assert_allclose(codec.residual[:10], 0.4, rtol=1e-6)
    for _ in range(4):
        codec.decode(codec.encode(np.zeros(n, np.float32)), decoded)
    np.testing.assert_allclose(decoded[:10], 0.5, rtol=1e-5)


@pytest.mark.parametrize("plain", [False, True], ids=["native", "plain"])
def test_codec_bound_checks(plain):
    codec = ThresholdCodec(100, 0.1, plain=plain)
    for bad in (lambda: codec.encode(np.zeros(50, np.float32)),
                lambda: codec.encode(np.zeros(200, np.float32)),
                lambda: codec.encode_bitmap(np.zeros(99, np.float32)),
                lambda: codec.decode_bitmap(np.zeros(10, np.uint8)),
                lambda: codec.decode(np.asarray([1], np.int32), target=np.zeros(100, np.float64)),
                lambda: codec.decode(np.asarray([1], np.int32), target=np.zeros(50, np.float32))):
        with pytest.raises(ValueError):
            bad()
    # invalid indices are ignored, not wrapped
    out = codec.decode(np.asarray([0, 101, -101], np.int32))
    assert np.count_nonzero(out) == 0


_RESIDUAL_WORKER = r"""
import json
import numpy as np
from deeplearning4j_tpu_torch.native import ThresholdCodec
rng = np.random.default_rng(42)
codec = ThresholdCodec(2000, 1e-3)
encs = []
for step in range(5):
    g = rng.normal(0, 0.003, 2000).astype(np.float32)
    encs.append(codec.encode(g).tolist())
print(json.dumps({"encs": encs, "residual": codec.residual.tobytes().hex()}))
"""


def test_codec_residual_deterministic_across_processes():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", _RESIDUAL_WORKER], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(json.loads(r.stdout))
    assert outs[0] == outs[1]
    # and the JAX codec's stream from the same draws
    rng = np.random.default_rng(42)
    j = JCodec(2000, 1e-3)
    encs = [j.encode(rng.normal(0, 0.003, 2000).astype(np.float32)).tolist() for _ in range(5)]
    assert encs == outs[0]["encs"] and j.residual.tobytes().hex() == outs[0]["residual"]


def test_tree_codec_formats_and_payloads_equal_the_jax_tree_codec():
    rng = np.random.default_rng(5)
    leaves = [rng.normal(0, 0.01, (64, 32)).astype(np.float32),
              rng.normal(0, 0.01, (32,)).astype(np.float32),
              rng.normal(0, 0.01, (32, 8)).astype(np.float32)]
    tc, jtc = TreeCodec(leaves, threshold=5e-3), JTreeCodec(leaves, threshold=5e-3)
    flat = tc.flatten(leaves)
    assert flat.tobytes() == jtc.flatten(leaves).tobytes()
    for a, b in zip(leaves, tc.unflatten(flat)):
        np.testing.assert_array_equal(a, b)
    formats = set()
    for scale in (0.001, 0.01, 1.0, 0.002):  # sparse and bitmap rounds
        g = (rng.normal(0, scale, tc.size)).astype(np.float32)
        (f1, p1), (f2, p2) = tc.encode(g), jtc.encode(g)
        assert (f1, p1) == (f2, p2)
        formats.add(f1)
        t1, t2 = np.zeros(tc.size, np.float32), np.zeros(tc.size, np.float32)
        assert tc.decode_into(f1, p1, t1).tobytes() == jtc.decode_into(f2, p2, t2).tobytes()
    assert formats == {TreeCodec.FORMAT_SPARSE, TreeCodec.FORMAT_BITMAP}
    with pytest.raises(ValueError):
        tc.decode_into(99, p1, t1)
    with pytest.raises(ValueError):
        tc.flatten(leaves[:2])
