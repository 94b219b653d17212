"""The port's LSTM backward (plain versions and autograd wrappers) against
``jax.vjp`` of the JAX package's Pallas kernels.

The CUDA kernels run only on an NVIDIA card (``chip_smoke.py`` holds them
against these plain versions there). On the CPU the wrappers' autograd
function takes the plain forward with residuals and the plain backward,
which must compute exactly what the Pallas kernels' custom VJPs compute. The
Pallas kernels run in interpret mode, as ``tests/test_pallas.py`` runs them.

Tolerances: float32 against JAX, ``rtol=1e-4, atol=1e-5`` (the two sides
sum ``h @ W_rec``, ``ds @ W_rec^T`` and ``h_prev^T @ ds`` in different
orders); float64 against ``torch.autograd`` of the plain forward,
``rtol=1e-10, atol=1e-12`` (the same function to rounding).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops.kernels import fused_lstm as port_plain
from deeplearning4j_tpu_torch.ops.kernels import fused_lstm_graves as port_graves
from deeplearning4j_tpu_torch.runtime.environment import get_environment

RTOL, ATOL = 1e-4, 1e-5
T, B, H = 12, 8, 128


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _inputs(seed, with_mask, t_len=T, b=B, hid=H, dtype=np.float32):
    rng = np.random.default_rng(seed)
    arrs = {
        "zx": rng.normal(0, 1, (t_len, b, 4 * hid)),
        "w_rec": rng.normal(0, 0.3, (hid, 4 * hid)),
        "peep": rng.normal(0, 0.3, (3 * hid,)),
        "h0": rng.normal(0, 1, (b, hid)),
        "c0": rng.normal(0, 1, (b, hid)),
        "dys": rng.normal(0, 1, (t_len, b, hid)),
        "dhT": rng.normal(0, 1, (b, hid)),
        "dcT": rng.normal(0, 1, (b, hid)),
    }
    mask = (np.arange(t_len)[:, None] < rng.integers(1, t_len + 1, b)[None, :])
    mask = mask.astype(np.float64)
    mask[:, 0] = 0.0  # a row whose every step is masked
    if t_len > 2 and b > 3:
        mask[1, 3] = 0.0  # a hole inside a row
    arrs["mask"] = mask if with_mask else np.ones((t_len, b))
    return {k: v.astype(dtype) for k, v in arrs.items()}


def _jax_vjp(fn, primals, cots):
    import jax
    out, vjp = jax.vjp(fn, *primals)
    return out, vjp(cots)


def _port_grads(wrapper, t, names):
    """Gradients of sum(ys*dys) + sum(hT*dhT) + sum(cT*dcT) through the
    autograd wrapper, for the inputs in ``names``."""
    leaves = {k: t[k].clone().requires_grad_() for k in names}
    args = {**t, **leaves}
    ys, h_t, c_t = wrapper(args)
    loss = (ys * t["dys"]).sum() + (h_t * t["dhT"]).sum() + (c_t * t["dcT"]).sum()
    return dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))


def _close(port, jax_val, what):
    np.testing.assert_allclose(np.asarray(port), np.asarray(jax_val), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def test_plain_backward_matches_jax_vjp():
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.pallas.fused_lstm import fused_lstm, fused_lstm_compatible
    a = _inputs(0, with_mask=False)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    assert fused_lstm_compatible(j["zx"], j["h0"])
    _, (dzx, dw, dh0, dc0) = _jax_vjp(fused_lstm, (j["zx"], j["w_rec"], j["h0"], j["c0"]),
                                      (j["dys"], j["dhT"], j["dcT"]))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    # the plain backward on the plain forward's residuals
    ys, _, _, gates, cseq = port_plain.lstm_reference(t["zx"], t["w_rec"], None, t["h0"],
                                                      t["c0"], None, save=True)
    ds, g_h0, g_c0 = port_plain.lstm_bwd_reference(t["dys"], t["dhT"], t["dcT"], gates,
                                                   cseq, t["c0"], t["w_rec"], None, None)
    g_w, g_p = port_plain.lstm_param_grads(ds, ys, t["h0"], gates, cseq, t["c0"],
                                           t["w_rec"], None)
    assert g_p is None
    for name, p, jv in (("dzx", ds, dzx), ("dW_rec", g_w, dw), ("dh0", g_h0, dh0),
                        ("dc0", g_c0, dc0)):
        _close(p, jv, name)
    # the autograd wrapper
    before = (port_plain.save_counter.value, port_plain.bwd_counter.value)
    got = _port_grads(lambda s: port_plain.fused_lstm(s["zx"], s["w_rec"], s["h0"], s["c0"]),
                      t, ["zx", "w_rec", "h0", "c0"])
    for name, jv in (("zx", dzx), ("w_rec", dw), ("h0", dh0), ("c0", dc0)):
        _close(got[name], jv, f"wrapper d{name}")
    assert (port_plain.save_counter.value, port_plain.bwd_counter.value) == before


@pytest.mark.parametrize("with_mask", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("with_peep", [True, False], ids=["peephole", "no_peephole"])
def test_graves_backward_matches_jax_vjp(with_mask, with_peep):
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.pallas.fused_lstm_graves import (
        fused_graves_lstm, fused_graves_lstm_compatible)
    a = _inputs(1, with_mask=with_mask)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    assert fused_graves_lstm_compatible(j["zx"], j["h0"])
    jax_peep = j["peep"] if with_peep else jnp.zeros((3 * H,), jnp.float32)
    _, (dzx, dw, dpeep, dh0, dc0, _) = _jax_vjp(
        fused_graves_lstm, (j["zx"], j["w_rec"], jax_peep, j["h0"], j["c0"], j["mask"]),
        (j["dys"], j["dhT"], j["dcT"]))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    peep = t["peep"] if with_peep else None
    mask = t["mask"] if with_mask else None
    ys, _, _, gates, cseq = port_plain.lstm_reference(t["zx"], t["w_rec"], peep, t["h0"],
                                                      t["c0"], mask, save=True)
    ds, g_h0, g_c0 = port_plain.lstm_bwd_reference(t["dys"], t["dhT"], t["dcT"], gates,
                                                   cseq, t["c0"], t["w_rec"], peep, mask)
    g_w, g_p = port_plain.lstm_param_grads(ds, ys, t["h0"], gates, cseq, t["c0"],
                                           t["w_rec"], peep)
    for name, p, jv in (("dzx", ds, dzx), ("dW_rec", g_w, dw), ("dh0", g_h0, dh0),
                        ("dc0", g_c0, dc0)):
        _close(p, jv, name)
    names = ["zx", "w_rec", "h0", "c0"] + (["peep"] if with_peep else [])
    got = _port_grads(lambda s: port_graves.fused_graves_lstm(
        s["zx"], s["w_rec"], s["peep"] if with_peep else None, s["h0"], s["c0"], mask),
        t, names)
    for name, jv in (("zx", dzx), ("w_rec", dw), ("h0", dh0), ("c0", dc0)):
        _close(got[name], jv, f"wrapper d{name}")
    if with_peep:
        _close(g_p, dpeep, "dpeep")
        _close(got["peep"], dpeep, "wrapper dpeep")
    else:
        assert g_p is None
    if with_mask:  # the all-masked row: no gradient reaches its inputs
        assert float(ds[:, 0].abs().max()) == 0.0


@pytest.mark.parametrize("with_mask", [True, False], ids=["masked", "unmasked"])
def test_saved_residuals_match_the_pallas_forward(with_mask):
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.pallas.fused_lstm_graves import _graves_fwd
    a = _inputs(2, with_mask=with_mask)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    _, _, _, (gates, cseq) = _graves_fwd(j["zx"], j["w_rec"], j["peep"], j["h0"], j["c0"],
                                         j["mask"], save_residuals=True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    out = port_plain.lstm_reference(t["zx"], t["w_rec"], t["peep"], t["h0"], t["c0"],
                                    t["mask"] if with_mask else None, save=True)
    _close(out[3], gates, "gates")
    _close(out[4], cseq, "cseq (carried cell)")


@pytest.mark.parametrize("shape", [(5, 3, 200), (3, 70, 16), (1, 4, 8), (6, 17, 8),
                                   (3, 17, 512)],
                         ids=["ragged", "over_one_launch", "one_step",
                              "ragged_row_group_h8", "ragged_row_group"])
@pytest.mark.parametrize("cell", ["plain", "graves_masked", "graves"])
def test_plain_backward_matches_float64_autograd(shape, cell):
    """Shapes the TPU kernels refused (B % 8, H % 128, T < 32, B > 64); B =
    17 and H = 8 are the edges of the card's row-group kernels (a row group
    of 16 and one of 1; a K of 4H = 32, one pair of k tiles)."""
    t_len, b, hid = shape
    t = {k: torch.from_numpy(v)
         for k, v in _inputs(3, cell == "graves_masked", t_len, b, hid, np.float64).items()}
    peep = None if cell == "plain" else t["peep"]
    mask = t["mask"] if cell == "graves_masked" else None
    names = ["zx", "w_rec", "h0", "c0"] + (["peep"] if peep is not None else [])
    leaves = {k: t[k].clone().requires_grad_() for k in names}
    ys, h_t, c_t = port_plain.lstm_reference(leaves["zx"], leaves["w_rec"],
                                             leaves.get("peep"), leaves["h0"],
                                             leaves["c0"], mask)
    loss = (ys * t["dys"]).sum() + (h_t * t["dhT"]).sum() + (c_t * t["dcT"]).sum()
    want = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
    ys, _, _, gates, cseq = port_plain.lstm_reference(t["zx"], t["w_rec"], peep, t["h0"],
                                                      t["c0"], mask, save=True)
    ds, g_h0, g_c0 = port_plain.lstm_bwd_reference(t["dys"], t["dhT"], t["dcT"], gates,
                                                   cseq, t["c0"], t["w_rec"], peep, mask)
    g_w, g_p = port_plain.lstm_param_grads(ds, ys, t["h0"], gates, cseq, t["c0"],
                                           t["w_rec"], peep)
    got = {"zx": ds, "w_rec": g_w, "h0": g_h0, "c0": g_c0, "peep": g_p}
    for k in names:
        torch.testing.assert_close(got[k], want[k], rtol=1e-10, atol=1e-12, msg=k)


def test_bfloat16_backward_rounding_points():
    """In bf16: ds is stored in bf16 and the recurrent product reads it
    rounded; dh/dc stay float32 inside; dW_rec is summed in float32."""
    t = {k: torch.from_numpy(v).to(torch.bfloat16)
         for k, v in _inputs(4, with_mask=False).items()}
    ys, _, _, gates, cseq = port_plain.lstm_reference(t["zx"], t["w_rec"], None, t["h0"],
                                                      t["c0"], None, save=True)
    assert gates.dtype == cseq.dtype == torch.bfloat16
    ds, dh0, dc0 = port_plain.lstm_bwd_reference(t["dys"], t["dhT"], t["dcT"], gates, cseq,
                                                 t["c0"], t["w_rec"], None, None)
    assert ds.dtype == dh0.dtype == dc0.dtype == torch.bfloat16
    dh = t["dhT"].float()
    dc = t["dcT"].float()
    for s in reversed(range(T)):
        i, f, g, o = gates[s].float().split(H, dim=1)
        cp = (t["c0"] if s == 0 else cseq[s - 1]).float()
        tc = torch.tanh(f * cp + i * g)
        dh = dh + t["dys"][s].float()
        d_o = dh * tc * o * (1 - o)
        dc = dc + dh * o * (1 - tc * tc)
        want = torch.cat([dc * g * i * (1 - i), dc * cp * f * (1 - f), dc * i * (1 - g * g),
                          d_o], dim=1).to(torch.bfloat16)
        torch.testing.assert_close(ds[s], want, rtol=0, atol=0)
        dh = ds[s].float() @ t["w_rec"].float().t()
        dc = dc * f
    torch.testing.assert_close(dh0, dh.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(dc0, dc.to(torch.bfloat16), rtol=0, atol=0)
    dw, _ = port_plain.lstm_param_grads(ds, ys, t["h0"], gates, cseq, t["c0"], t["w_rec"],
                                        None)
    h_prev = torch.cat([t["h0"][None], ys[:-1]]).reshape(-1, H).float()
    torch.testing.assert_close(dw, (h_prev.t() @ ds.reshape(-1, 4 * H).float()).to(
        torch.bfloat16), rtol=0, atol=0)


def test_no_gradient_needed_takes_the_inference_forward():
    """Under ``inference_mode`` (serving) or with no input needing a
    gradient, the wrapper returns plain outputs: no autograd node, so no
    saving forward and no backward."""
    t = {k: torch.from_numpy(v) for k, v in _inputs(5, with_mask=False).items()}
    w = t["w_rec"].clone().requires_grad_()
    with torch.inference_mode():
        ys, _, _ = port_plain.fused_lstm(t["zx"], w, t["h0"], t["c0"])
    assert ys.grad_fn is None
    ys, _, _ = port_graves.fused_graves_lstm(t["zx"], t["w_rec"], t["peep"], t["h0"],
                                             t["c0"], t["mask"])
    assert ys.grad_fn is None
    ys, _, _ = port_graves.fused_graves_lstm(t["zx"], w, t["peep"], t["h0"], t["c0"],
                                             t["mask"])
    assert ys.grad_fn is not None


def test_non_cpu_tensors_needing_a_gradient_go_to_the_kernel_launchers(monkeypatch):
    """On any device but the CPU the autograd function launches the
    saving forward and the backward kernel (here recorded on ``meta``
    tensors); there is no path to the plain versions."""
    calls = []

    def fwd(zx, w, p, h0, c0, m, launches, save=False):
        calls.append((launches.name, save))
        t_len, b, h4 = zx.shape
        e = lambda *s: torch.empty(s, device=zx.device)  # noqa: E731
        return e(t_len, b, h4 // 4), e(b, h4 // 4), e(b, h4 // 4), e(t_len, b, h4), \
            e(t_len, b, h4 // 4)

    def bwd(dys, dhT, dcT, gates, cseq, c0, w, p, m, launches):
        calls.append((launches.name, None))
        return torch.empty_like(gates), torch.empty_like(c0), torch.empty_like(c0)

    for name in ("lstm_reference", "lstm_bwd_reference"):
        monkeypatch.setattr(port_plain, name, lambda *a, **k: pytest.fail("plain version"))
    for mod in (port_plain, port_graves):  # meta tensors pass no device check
        monkeypatch.setattr(mod, "_check", lambda *a: None)
    monkeypatch.setattr(port_plain, "_check_bwd", lambda *a: None)
    monkeypatch.setattr(port_plain, "launch_lstm_fwd", fwd)
    monkeypatch.setattr(port_plain, "launch_lstm_bwd", bwd)
    meta = {k: torch.empty(s, device="meta", requires_grad=k != "mask")
            for k, s in (("zx", (3, 2, 16)), ("w", (4, 16)), ("p", (12,)), ("h0", (2, 4)),
                         ("c0", (2, 4)), ("mask", (3, 2)))}
    ys, _, _ = port_plain.fused_lstm(meta["zx"], meta["w"], meta["h0"], meta["c0"])
    ys.sum().backward()
    ys, _, _ = port_graves.fused_graves_lstm(*meta.values())
    ys.sum().backward()
    assert calls == [("fused_lstm_save", True), ("fused_lstm_bwd", None),
                     ("fused_graves_lstm_save", True), ("fused_graves_lstm_bwd", None)]
