"""The LSTM launchers' hand-over to the C side, on the CPU.

``launch_lstm_fwd`` and ``launch_lstm_bwd`` hand ``dl4j_lstm_fwd`` and
``dl4j_lstm_bwd`` (``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``) their
operands; the C side picks the kernel (the row-group kernels for bf16 with
H % 8 == 0 and 16-byte aligned operands, the CUDA-core kernels otherwise),
so what the wrapper owes it is the right pointers and sizes, one launch per
group of at most ``ROWS_PER_LAUNCH`` batch rows, and the row-group kernels'
barrier counters zeroed. A stand-in object takes the C calls in place of the
built library (no card here), and stand-ins for ``torch.cuda.device`` and
``current_stream`` let CPU tensors reach the launchers. The kernels
themselves are held against their plain versions on the card by
``chip_smoke.py``.
"""

import ast
import contextlib
import pathlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops.kernels import fused_lstm as fl
from deeplearning4j_tpu_torch.ops.kernels import fused_lstm_graves as fg

SHAPES = [(3, 17, 8), (2, 64, 512), (2, 130, 16)]  # (T, B, H)
SHAPE_IDS = ["ragged_row_group", "one_launch", "three_launches"]
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

    def dl4j_lstm_fwd(self, *args):
        return self._record(args)

    def dl4j_lstm_bwd(self, *args):
        return self._record(args)

    def dl4j_cuda_error_string(self, err):
        return b"stand-in failure"


class _Stream:
    cuda_stream = 0x5EED


def _stand_in(monkeypatch, err=0):
    """The stand-in library for both sources; the counter tensors the
    launchers allocate are kept in the list it returns second."""
    made = []
    real = fl._counters

    def counters(b, like):
        made.append(real(b, like))
        return made[-1]

    lib = _StandInLibrary(made, err)
    monkeypatch.setattr(fl, "_counters", counters)
    monkeypatch.setattr(fl, "LIBRARY", lib)
    monkeypatch.setattr(fl, "BWD_LIBRARY", lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    return lib, made


def _inputs(t_len, b, hid, dtype, peep, mask, seed=0):
    rng = np.random.default_rng(seed)
    a = {"zx": rng.normal(0, 1, (t_len, b, 4 * hid)),
         "w_rec": rng.normal(0, 0.3, (hid, 4 * hid)),
         "peep": rng.normal(0, 0.3, (3 * hid,)) if peep else None,
         "h0": rng.normal(0, 1, (b, hid)), "c0": rng.normal(0, 1, (b, hid)),
         "mask": (rng.random((t_len, b)) > 0.3).astype(np.float64) if mask else None,
         "dys": rng.normal(0, 1, (t_len, b, hid)), "dhT": rng.normal(0, 1, (b, hid)),
         "dcT": rng.normal(0, 1, (b, hid)), "gates": rng.random((t_len, b, 4 * hid)),
         "cseq": rng.normal(0, 1, (t_len, b, hid))}
    return {k: None if v is None else torch.from_numpy(v).to(dtype) for k, v in a.items()}


def _ptr(t):
    return None if t is None else t.data_ptr()


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
@pytest.mark.parametrize("cell", ["plain", "graves_masked"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_forward_launcher_hands_the_c_side_its_arguments(monkeypatch, dname, save, cell,
                                                         shape):
    """``launch_lstm_fwd`` calls ``dl4j_lstm_fwd(dtype, zx, w_rec, peep, h0,
    c0, mask, ys, hT, cT, gates, cseq, counters, T, B, H, r0, rows,
    stream)`` once per group of rows, with the outputs it returns and its
    zeroed counters; gates and cseq only for the saving instance."""
    lib, made = _stand_in(monkeypatch)
    t_len, b, hid = shape
    dtype = DTYPES[dname]
    graves = cell == "graves_masked"
    a = _inputs(t_len, b, hid, dtype, peep=graves, mask=graves)
    counter = fl.LaunchCounter("stand-in")
    out = fl.launch_lstm_fwd(a["zx"], a["w_rec"], a["peep"], a["h0"], a["c0"], a["mask"],
                             counter, save=save)
    assert counter.value == -(-b // 64)
    ys, h_t, c_t = out[:3]
    gates, cseq = out[3:] if save else (None, None)
    assert len(out) == (5 if save else 3)
    assert ys.shape == (t_len, b, hid) and h_t.shape == c_t.shape == (b, hid)
    assert all(x.dtype == dtype for x in out)
    if save:
        assert gates.shape == (t_len, b, 4 * hid) and cseq.shape == (t_len, b, hid)
    head = ({torch.float32: 0, torch.bfloat16: 1}[dtype], a["zx"].data_ptr(),
            a["w_rec"].data_ptr(), _ptr(a["peep"]), a["h0"].data_ptr(), a["c0"].data_ptr(),
            _ptr(a["mask"]), ys.data_ptr(), h_t.data_ptr(), c_t.data_ptr(), _ptr(gates),
            _ptr(cseq))
    _check_launches(lib, made, t_len, b, hid, head)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("cell", ["plain", "graves_masked"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_backward_launcher_hands_the_c_side_its_arguments(monkeypatch, dname, cell, shape):
    """``launch_lstm_bwd`` calls ``dl4j_lstm_bwd(dtype, dys, dhT, dcT, gates,
    cseq, c0, w_rec, peep, mask, ds, dh0, dc0, counters, T, B, H, r0, rows,
    stream)`` once per group of rows, with the outputs it returns and its
    zeroed counters."""
    lib, made = _stand_in(monkeypatch)
    t_len, b, hid = shape
    dtype = DTYPES[dname]
    graves = cell == "graves_masked"
    a = _inputs(t_len, b, hid, dtype, peep=graves, mask=graves, seed=1)
    counter = fl.LaunchCounter("stand-in")
    ds, dh0, dc0 = fl.launch_lstm_bwd(a["dys"], a["dhT"], a["dcT"], a["gates"], a["cseq"],
                                      a["c0"], a["w_rec"], a["peep"], a["mask"], counter)
    assert counter.value == -(-b // 64)
    assert ds.shape == (t_len, b, 4 * hid) and dh0.shape == dc0.shape == (b, hid)
    assert all(x.dtype == dtype for x in (ds, dh0, dc0))
    head = ({torch.float32: 0, torch.bfloat16: 1}[dtype], a["dys"].data_ptr(),
            a["dhT"].data_ptr(), a["dcT"].data_ptr(), a["gates"].data_ptr(),
            a["cseq"].data_ptr(), a["c0"].data_ptr(), a["w_rec"].data_ptr(), _ptr(a["peep"]),
            _ptr(a["mask"]), ds.data_ptr(), dh0.data_ptr(), dc0.data_ptr())
    _check_launches(lib, made, t_len, b, hid, head)


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_launcher_raises_on_a_launch_error_and_counts_nothing(monkeypatch, which):
    """A nonzero cudaError_t from the C side raises with its message: no
    fallback to the plain version, no launch counted."""
    _stand_in(monkeypatch, err=9)
    a = _inputs(2, 70, 8, torch.bfloat16, peep=True, mask=True, seed=2)
    counter = fl.LaunchCounter("stand-in")
    with pytest.raises(RuntimeError, match=f"LSTM {which} kernel launch failed: stand-in "
                                           "failure.*cudaError 9"):
        if which == "forward":
            fl.launch_lstm_fwd(a["zx"], a["w_rec"], a["peep"], a["h0"], a["c0"], a["mask"],
                               counter, save=True)
        else:
            fl.launch_lstm_bwd(a["dys"], a["dhT"], a["dcT"], a["gates"], a["cseq"], a["c0"],
                               a["w_rec"], a["peep"], a["mask"], counter)
    assert counter.value == 0


@pytest.mark.parametrize("module", [fl, fg], ids=["fused_lstm", "fused_lstm_graves"])
def test_wrapper_source_has_no_try(module):
    """For CUDA tensors the wrappers launch the kernels or raise: no
    ``try`` that could fall back to the plain versions."""
    src = pathlib.Path(module.__file__).read_text()
    assert not [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Try)]
