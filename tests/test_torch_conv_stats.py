"""The port's conv_stats (TPU row 13) against the JAX repository's kernel.

- The plain version against the Pallas body of
  ``experiments/resnet_megakernel_stage4.py`` (``kernel``, :46-62), run by a
  ``pallas_call`` in interpret mode built here at small shapes (M a multiple
  of the row block): y, s1 = sum(y), s2 = sum(y^2), float32 and bfloat16
  inputs. Under ``jax.default_matmul_precision("highest")``: at default
  precision the CPU product differs by about 2e-3 at K = 128.
- The plain version against ``xla_conv_stats`` (the experiment's XLA form)
  at ragged shapes, and with a shift against the shifted sums computed from
  float64.
- ``ConvStatsFunction``'s gradients against ``torch.autograd`` of the plain
  version in float64 (``rtol=1e-10``), and ``gradcheck``.
- The wrapper's routing: CPU tensors take the plain version and launch
  nothing; bad arguments raise.

Tolerances: float32 ``rtol=1e-5, atol=1e-5`` on y and the sums (the same
products in another summation order); bfloat16 y within one bf16 ulp
(``rtol=2**-7``), the sums in float32 from the same exact products
(``rtol=1e-5``).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops.kernels import conv_stats as cs

SHAPES = [(64, 32, 16, 16), (96, 40, 24, 32), (128, 128, 8, 64)]  # (M, K, N, row block)


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = (rng.normal(0, 1, (k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


def _pallas(x, w, block, out_dtype):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from experiments.resnet_megakernel_stage4 import kernel
    m, k = x.shape
    n = w.shape[1]
    call = pl.pallas_call(
        kernel, grid=(m // block,),
        in_specs=[pl.BlockSpec((block, k), lambda i: (i, 0)),
                  pl.BlockSpec((k, n), lambda i: (0, 0))],
        out_specs=[pl.BlockSpec((block, n), lambda i: (i, 0)),
                   pl.BlockSpec((1, n), lambda i: (0, 0)),
                   pl.BlockSpec((1, n), lambda i: (0, 0))],
        out_shape=[jax.ShapeDtypeStruct((m, n), out_dtype),
                   jax.ShapeDtypeStruct((1, n), jnp.float32),
                   jax.ShapeDtypeStruct((1, n), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((1, n), jnp.float32), pltpu.VMEM((1, n), jnp.float32)],
        interpret=True)
    with jax.default_matmul_precision("highest"):
        y, s1, s2 = call(x, w)
    return np.asarray(y.astype(jnp.float32)), np.asarray(s1)[0], np.asarray(s2)[0]


@pytest.mark.parametrize("m,k,n,block", SHAPES, ids=lambda v: str(v))
def test_plain_version_matches_the_pallas_body_float32(m, k, n, block):
    import jax.numpy as jnp
    x, w = _inputs(m, k, n, seed=m + k)
    py, ps1, ps2 = _pallas(jnp.asarray(x), jnp.asarray(w), block, jnp.float32)
    y, s1, s2 = cs.conv_stats(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(y.numpy(), py, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s1.numpy(), ps1, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), ps2, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,k,n,block", SHAPES, ids=lambda v: str(v))
def test_plain_version_matches_the_pallas_body_bfloat16(m, k, n, block):
    """bf16 operands, as row 13 runs: y stored in bf16 from the f32
    accumulator, the sums taken from the accumulator."""
    import jax.numpy as jnp
    x, w = _inputs(m, k, n, seed=2 * m + k)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    py, ps1, ps2 = _pallas(jx, jw, block, jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(torch.bfloat16)
    y, s1, s2 = cs.conv_stats(tx, tw)
    assert y.dtype == torch.bfloat16 and s1.dtype == s2.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), py, rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(s1.numpy(), ps1, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), ps2, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,k,n", [(37, 13, 5), (1, 3, 7), (130, 64, 200), (300, 9, 1)],
                         ids=lambda v: str(v))
def test_plain_version_matches_xla_conv_stats_at_ragged_shapes(m, k, n):
    import jax
    import jax.numpy as jnp

    from experiments.resnet_megakernel_stage4 import xla_conv_stats
    x, w = _inputs(m, k, n, seed=m * n + k)
    with jax.default_matmul_precision("highest"):
        jy, js1, js2 = xla_conv_stats(jnp.asarray(x), jnp.asarray(w))
    y, s1, s2 = cs.conv_stats(torch.from_numpy(x), torch.from_numpy(w))
    # xla_conv_stats stores y in bf16 whatever its inputs
    np.testing.assert_allclose(y.to(torch.bfloat16).float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1)[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2)[0], rtol=1e-5, atol=1e-5)


def test_shifted_sums_match_float64():
    """With BatchNormalization's shift (a large channel mean, as the running
    mean is): s1 = sum(acc - shift), s2 = sum((acc - shift)^2) against
    float64, and the statistics they give against numpy's mean and var."""
    m, k, n = 200, 24, 6
    x, w = _inputs(m, k, n, seed=5)
    x = x + 3.0
    shift = (x.mean(0) @ w + np.random.default_rng(6).normal(0, 0.1, n)).astype(np.float32)
    y, s1, s2 = cs.conv_stats(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(shift))
    acc = x.astype(np.float64) @ w.astype(np.float64)
    d = acc - shift
    np.testing.assert_allclose(s1.numpy(), d.sum(0), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), (d * d).sum(0), rtol=1e-5, atol=1e-4)
    dmean = s1.numpy() / m
    np.testing.assert_allclose(shift + dmean, acc.mean(0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2.numpy() / m - dmean ** 2, acc.var(0), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("with_shift", [True, False], ids=["shift", "no_shift"])
def test_function_gradients_match_autograd_of_the_plain_version_float64(with_shift):
    m, k, n = 23, 7, 5
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)))
    w = torch.from_numpy(rng.normal(0, 0.5, (k, n)))
    shift = torch.from_numpy(rng.normal(0, 1, n)) if with_shift else None
    cot = [torch.from_numpy(rng.normal(0, 1, s)) for s in ((m, n), (n,), (n,))]

    def grads(fn):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        outs = fn(xl, wl, shift)
        loss = sum((o * c).sum() for o, c in zip(outs, cot))
        return torch.autograd.grad(loss, [xl, wl])

    got = grads(cs.ConvStatsFunction.apply)
    want = grads(cs.conv_stats_reference)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-10, atol=1e-12)
    xl, wl = x[:6, :4].clone().requires_grad_(), w[:4, :3].clone().requires_grad_()
    sh = None if shift is None else shift[:3]
    assert torch.autograd.gradcheck(lambda a, b: cs.ConvStatsFunction.apply(a, b, sh),
                                    (xl, wl))


def test_conv_stats_records_the_function_only_under_autograd():
    x, w = (torch.from_numpy(a) for a in _inputs(9, 4, 3, seed=1))
    y, _, _ = cs.conv_stats(x, w)
    assert y.grad_fn is None
    y, s1, _ = cs.conv_stats(x, w.clone().requires_grad_())
    assert type(y.grad_fn).__name__ == "ConvStatsFunctionBackward"
    assert s1.grad_fn is not None


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    cs.counter.reset()
    x, w = (torch.from_numpy(a) for a in _inputs(10, 4, 3, seed=2))
    got = cs.conv_stats(x, w, torch.zeros(3))
    want = cs.conv_stats_reference(x, w, torch.zeros(3))
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert cs.counter.value == 0


@pytest.mark.parametrize("case", ["shape", "dtype", "shift", "empty_k"])
def test_bad_arguments_raise(case):
    x, w = (torch.from_numpy(a) for a in _inputs(10, 4, 3, seed=3))
    with pytest.raises((ValueError, TypeError)):
        if case == "shape":
            cs.conv_stats(x, w.t())
        elif case == "dtype":
            cs.conv_stats(x, w.double())
        elif case == "shift":
            cs.conv_stats(x, w, torch.zeros(4))
        else:
            cs.conv_stats(x[:, :0], w[:0])


def test_tensors_off_the_cpu_launch_the_kernel_or_raise(monkeypatch):
    """A tensor on any device but the CPU never takes the plain version: a
    device that is not CUDA raises; past the check the call launches the
    kernel, under autograd too (the Function's forward), and the module
    catches no kernel failure."""
    import ast
    import pathlib
    x = torch.empty(6, 4, device="meta")
    w = torch.empty(4, 3, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cs.conv_stats(x, w)
    launched = []

    def launch(x2d, w_, shift, launches=cs.counter):
        launched.append(tuple(x2d.shape))
        return (torch.empty(x2d.shape[0], w_.shape[1], device="meta"),
                torch.empty(w_.shape[1], device="meta"), torch.empty(w_.shape[1], device="meta"))

    monkeypatch.setattr(cs, "_check", lambda *a: None)
    monkeypatch.setattr(cs, "launch_conv_stats", launch)
    monkeypatch.setattr(cs, "conv_stats_reference",
                        lambda *a: pytest.fail("plain version ran for a meta tensor"))
    y, s1, s2 = cs.conv_stats(x, w)
    assert y.grad_fn is not None and launched == [(6, 4)]
    with torch.no_grad():
        cs.conv_stats(x, w)
    assert launched == [(6, 4), (6, 4)]
    src = pathlib.Path(cs.__file__).read_text()
    assert not [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Try)]


class _StandInLibrary:
    """Takes the launcher's C calls in place of the built library: records
    ``dl4j_conv_stats``'s arguments and returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls, self.blocks_asked = err, [], []

    def load(self):
        return self

    def dl4j_conv_stats_blocks(self, m):
        self.blocks_asked.append(m)
        return (m + 127) // 128

    def dl4j_conv_stats(self, *args):
        self.calls.append(args)
        return self.err

    def dl4j_cuda_error_string(self, err):
        return b"stand-in failure"


class _Stream:
    cuda_stream = 0x5EED


def _stand_in(monkeypatch, err=0):
    import contextlib
    lib = _StandInLibrary(err)
    monkeypatch.setattr(cs, "LIBRARY", lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("with_shift", [True, False], ids=["shift", "no_shift"])
@pytest.mark.parametrize("m,k,n", [(300, 16, 24), (37, 13, 5), (128, 64, 256)],
                         ids=lambda v: str(v))
def test_launcher_hands_the_c_side_its_arguments(monkeypatch, dtype, with_shift, m, k, n):
    """``launch_conv_stats`` calls ``dl4j_conv_stats(dtype, x, w, shift, y,
    part1, part2, s1, s2, M, K, N, stream)`` once, with contiguous operands,
    the outputs it returns, and part1/part2 two consecutive blocks of
    ``dl4j_conv_stats_blocks(M)`` rows of N floats: the C side picks the
    kernel, the wrapper only hands it the tensors."""
    lib = _stand_in(monkeypatch)
    x, w = (torch.from_numpy(a).to(dtype) for a in _inputs(m, k, n, seed=m + n))
    xt = x.t().contiguous().t()  # the same values, column-major: the launcher copies
    shift = torch.linspace(-1, 1, n) if with_shift else None
    counter = cs.LaunchCounter("stand-in")
    y, s1, s2 = cs.launch_conv_stats(xt, w, shift, launches=counter)
    assert counter.value == 1 and lib.blocks_asked == [m] and len(lib.calls) == 1
    (code, px, pw, pshift, py, p1, p2, ps1, ps2, mm, kk, nn, stream) = lib.calls[0]
    assert code == {torch.float32: 0, torch.bfloat16: 1}[dtype]
    assert (mm, kk, nn, stream) == (m, k, n, _Stream.cuda_stream)
    assert px != xt.data_ptr() and pw == w.data_ptr()
    assert pshift == (None if shift is None else shift.data_ptr())
    assert (py, ps1, ps2) == (y.data_ptr(), s1.data_ptr(), s2.data_ptr())
    assert p2 - p1 == (m + 127) // 128 * n * 4
    assert y.shape == (m, n) and y.dtype == dtype
    assert s1.shape == s2.shape == (n,) and s1.dtype == s2.dtype == torch.float32


def test_launcher_raises_on_a_launch_error_and_counts_nothing(monkeypatch):
    """A nonzero cudaError_t from the C side raises with its message: no
    fallback to the plain version, no launch counted."""
    _stand_in(monkeypatch, err=98)
    x, w = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(64, 16, 8, seed=4))
    counter = cs.LaunchCounter("stand-in")
    with pytest.raises(RuntimeError, match="stand-in failure.*cudaError 98"):
        cs.launch_conv_stats(x, w, None, launches=counter)
    assert counter.value == 0


def test_launcher_launches_nothing_for_no_rows(monkeypatch):
    lib = _stand_in(monkeypatch)
    x, w = torch.zeros(0, 16, dtype=torch.bfloat16), torch.ones(16, 8, dtype=torch.bfloat16)
    counter = cs.LaunchCounter("stand-in")
    y, s1, s2 = cs.launch_conv_stats(x, w, None, launches=counter)
    assert lib.calls == [] and counter.value == 0 and y.shape == (0, 8)
    assert torch.equal(s1, torch.zeros(8)) and torch.equal(s2, torch.zeros(8))
