"""The GRU launchers' hand-over to the C side, on the CPU.

``launch_gru_fwd`` and ``launch_gru_bwd`` hand ``dl4j_gru_fwd`` and
``dl4j_gru_bwd`` (``csrc/gru_fwd.cu``, ``csrc/gru_bwd.cu``) their operands;
the C side picks the kernel (the row-group kernels for bf16 with H % 8 == 0
and 16-byte aligned operands where a plan fits, the CUDA-core kernels
otherwise), so what the wrapper owes it is the right pointers and sizes, one
launch per group of at most ``ROWS_PER_LAUNCH`` batch rows, and the row-group
kernels' barrier counters zeroed. A stand-in object takes the C calls in
place of the built library (no card here), and stand-ins for
``torch.cuda.device`` and ``current_stream`` let CPU tensors reach the
launchers. The kernels themselves are held against their plain versions on
the card by ``chip_smoke.py``.
"""

import ast
import contextlib
import pathlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops.kernels import fused_gru as fgru
from deeplearning4j_tpu_torch.ops.kernels import fused_lstm as fl

SHAPES = [(3, 17, 8), (2, 64, 512), (2, 130, 16), (1, 1, 24)]  # (T, B, H)
SHAPE_IDS = ["ragged_row_group", "one_launch", "three_launches", "one_row"]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _StandInLibrary:
    """Takes the launchers' C calls: records each call's arguments and a
    copy of the counter scratch as the call found it, and returns ``err``."""

    def __init__(self, counters, err=0):
        self.err, self.calls, self.counters_seen = err, [], []
        self._counters = counters

    def load(self):
        return self

    def _record(self, args):
        self.calls.append(args)
        self.counters_seen.append(self._counters[-1].clone())
        return self.err

    def dl4j_gru_fwd(self, *args):
        return self._record(args)

    def dl4j_gru_bwd(self, *args):
        return self._record(args)

    def dl4j_cuda_error_string(self, err):
        return b"stand-in failure"


class _Stream:
    cuda_stream = 0x5EED


def _stand_in(monkeypatch, err=0):
    """The stand-in library for both sources; the counter tensors the
    launchers allocate are kept in the list it returns second."""
    made = []
    real = fgru._counters

    def counters(b, like):
        made.append(real(b, like))
        return made[-1]

    lib = _StandInLibrary(made, err)
    monkeypatch.setattr(fgru, "_counters", counters)
    monkeypatch.setattr(fgru, "LIBRARY", lib)
    monkeypatch.setattr(fgru, "BWD_LIBRARY", lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    return lib, made


def _inputs(t_len, b, hid, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = {"zx": rng.normal(0, 1, (t_len, b, 3 * hid)),
         "w_rec": rng.normal(0, hid ** -0.5, (hid, 3 * hid)),
         "h0": rng.normal(0, 1, (b, hid)),
         "dys": rng.normal(0, 1, (t_len, b, hid)), "dhT": rng.normal(0, 1, (b, hid)),
         "gates": rng.random((t_len, b, 3 * hid)), "zhn": rng.normal(0, 1, (t_len, b, hid)),
         "ys": rng.normal(0, 1, (t_len, b, hid))}
    return {k: torch.from_numpy(v).to(dtype) for k, v in a.items()}


def _check_launches(lib, made, t_len, b, hid, head):
    """One call per group of at most ROWS_PER_LAUNCH rows, in row order,
    each with ``head`` (the operand pointers), the zeroed counters of the
    call (one int32 per batch row, untouched before every launch), the
    sizes and the stream."""
    assert len(made) == 1
    counters = made[0]
    assert counters.dtype == torch.int32 and counters.shape == (b,)
    groups = [(r0, min(fl.ROWS_PER_LAUNCH, b - r0)) for r0 in range(0, b, fl.ROWS_PER_LAUNCH)]
    assert len(lib.calls) == len(groups) == -(-b // 64)
    for args, seen, (r0, rows) in zip(lib.calls, lib.counters_seen, groups):
        n = len(head)
        assert args[:n] == head
        assert args[n:] == (counters.data_ptr(), t_len, b, hid, r0, rows, _Stream.cuda_stream)
        assert torch.equal(seen, torch.zeros(b, dtype=torch.int32))


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("save", [False, True], ids=["inference", "saving"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_forward_launcher_hands_the_c_side_its_arguments(monkeypatch, dname, save, shape):
    """``launch_gru_fwd`` calls ``dl4j_gru_fwd(dtype, zx, w_rec, h0, ys, hT,
    gates, zhn, counters, T, B, H, r0, rows, stream)`` once per group of
    rows, with the outputs it returns and its zeroed counters; gates and zhn
    only for the saving instance."""
    lib, made = _stand_in(monkeypatch)
    t_len, b, hid = shape
    dtype = DTYPES[dname]
    a = _inputs(t_len, b, hid, dtype)
    counter = fgru.LaunchCounter("stand-in")
    out = fgru.launch_gru_fwd(a["zx"], a["w_rec"], a["h0"], counter, save=save)
    assert counter.value == -(-b // 64)
    assert len(out) == (4 if save else 2)
    ys, h_t = out[:2]
    gates, zhn = out[2:] if save else (None, None)
    assert ys.shape == (t_len, b, hid) and h_t.shape == (b, hid)
    assert all(x.dtype == dtype for x in out)
    if save:
        assert gates.shape == (t_len, b, 3 * hid) and zhn.shape == (t_len, b, hid)
    head = ({torch.float32: 0, torch.bfloat16: 1}[dtype], a["zx"].data_ptr(),
            a["w_rec"].data_ptr(), a["h0"].data_ptr(), ys.data_ptr(), h_t.data_ptr(),
            None if gates is None else gates.data_ptr(), None if zhn is None else zhn.data_ptr())
    _check_launches(lib, made, t_len, b, hid, head)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_backward_launcher_hands_the_c_side_its_arguments(monkeypatch, dname, shape):
    """``launch_gru_bwd`` calls ``dl4j_gru_bwd(dtype, dys, dhT, gates, zhn,
    ys, h0, w_rec, dzx, dh0, scratch, counters, T, B, H, r0, rows, stream)``
    once per group of rows, with the outputs it returns, a (2, B, H) scratch
    of the input dtype (the n-third ping-pong) and its zeroed counters."""
    lib, made = _stand_in(monkeypatch)
    t_len, b, hid = shape
    dtype = DTYPES[dname]
    a = _inputs(t_len, b, hid, dtype, seed=1)
    counter = fgru.LaunchCounter("stand-in")
    dzx, dh0 = fgru.launch_gru_bwd(a["dys"], a["dhT"], a["gates"], a["zhn"], a["ys"], a["h0"],
                                   a["w_rec"], counter)
    assert counter.value == -(-b // 64)
    assert dzx.shape == (t_len, b, 3 * hid) and dh0.shape == (b, hid)
    assert dzx.dtype == dh0.dtype == dtype
    scratch = lib.calls[0][10]
    assert isinstance(scratch, int) and scratch not in (dzx.data_ptr(), dh0.data_ptr())
    head = ({torch.float32: 0, torch.bfloat16: 1}[dtype], a["dys"].data_ptr(),
            a["dhT"].data_ptr(), a["gates"].data_ptr(), a["zhn"].data_ptr(), a["ys"].data_ptr(),
            a["h0"].data_ptr(), a["w_rec"].data_ptr(), dzx.data_ptr(), dh0.data_ptr(), scratch)
    _check_launches(lib, made, t_len, b, hid, head)


def test_backward_scratch_is_a_two_step_ping_pong(monkeypatch):
    """The scratch handed over is (2, B, H) of the input dtype, allocated per
    call: both kernels index it as two halves of B rows by step parity."""
    _stand_in(monkeypatch)
    seen = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        out = real_empty(*shape, **kw)
        seen.append((tuple(out.shape), out.dtype, out.data_ptr()))
        return out

    monkeypatch.setattr(fgru.torch, "empty", empty)
    a = _inputs(3, 70, 16, torch.bfloat16, seed=3)
    lib = fgru.BWD_LIBRARY
    fgru.launch_gru_bwd(a["dys"], a["dhT"], a["gates"], a["zhn"], a["ys"], a["h0"], a["w_rec"],
                        fgru.LaunchCounter("stand-in"))
    scratch = [s for s in seen if s[0] == (2, 70, 16)]
    assert len(scratch) == 1 and scratch[0][1] == torch.bfloat16
    assert all(call[10] == scratch[0][2] for call in lib.calls)


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_launcher_raises_on_a_launch_error_and_counts_nothing(monkeypatch, which):
    """A nonzero cudaError_t from the C side raises with its message: no
    fallback to the plain version, no launch counted."""
    _stand_in(monkeypatch, err=9)
    a = _inputs(2, 70, 8, torch.bfloat16, seed=2)
    counter = fgru.LaunchCounter("stand-in")
    with pytest.raises(RuntimeError, match=f"GRU {which} kernel launch failed: stand-in "
                                           "failure.*cudaError 9"):
        if which == "forward":
            fgru.launch_gru_fwd(a["zx"], a["w_rec"], a["h0"], counter, save=True)
        else:
            fgru.launch_gru_bwd(a["dys"], a["dhT"], a["gates"], a["zhn"], a["ys"], a["h0"],
                                a["w_rec"], counter)
    assert counter.value == 0


def test_wrapper_source_has_no_try():
    """For CUDA tensors the wrapper launches the kernels or raises: no
    ``try`` that could fall back to the plain versions."""
    src = pathlib.Path(fgru.__file__).read_text()
    assert not [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Try)]
