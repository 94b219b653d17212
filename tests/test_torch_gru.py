"""The port's GRU (plain versions and autograd wrapper) against the JAX
package's Pallas GRU kernels (``fused_gru`` forward and ``jax.vjp``).

The CUDA kernels run only on an NVIDIA card (``chip_smoke.py`` holds them
against these plain versions there). On the CPU the wrapper takes the plain
forward (with residuals under autograd) and the plain backward, which must
compute exactly what the Pallas kernels and their custom VJP compute. The
Pallas kernels run in interpret mode, as ``tests/test_pallas.py`` runs them,
at T=12, B=8, H=128 (the TPU kernels take b % 8 == 0, h % 128 == 0).

Inputs are drawn with numpy from a seed; ``W_rec`` has the scale the layers
draw it at, std 1/sqrt(H). Tolerances: float32 against JAX, ``rtol=1e-4,
atol=1e-5`` (the two sides sum ``h @ W_rec``, ``ds_rec @ W_rec^T`` and
``h_prev^T @ ds_rec`` in different orders; at a recurrent gain of 3, std 0.3,
the gradients reach 50 and both packages sit ~4e-5 from a float64 run, so
the float64 check below takes that scale instead). bfloat16 against JAX:
both sides round h, the residuals and dzx to bf16 at the same points, so
only fp32 sums taken in another order can break a rounding tie the other
way; such a one-ulp difference carries along the sequence, so outputs are
held to 4 bf16 ulps of a value in [1, 2) (``atol=2**-6``) and gradients to
4 ulps relative to their largest value.
float64 against ``torch.autograd`` of the plain forward, ``rtol=1e-10``
(the same function to rounding).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops.kernels import fused_gru as port
from deeplearning4j_tpu_torch.runtime.environment import get_environment

RTOL, ATOL = 1e-4, 1e-5
BF16_ATOL = 2.0 ** -6
T, B, H = 12, 8, 128


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _inputs(seed, t_len=T, b=B, hid=H, dtype=np.float32, w_scale=None):
    """``W_rec`` at the scale the layers draw it, std 1/sqrt(H) (a recurrent
    gain near 1), unless ``w_scale`` is given."""
    rng = np.random.default_rng(seed)
    arrs = {
        "zx": rng.normal(0, 1, (t_len, b, 3 * hid)),
        "w_rec": rng.normal(0, w_scale or hid ** -0.5, (hid, 3 * hid)),
        "h0": rng.normal(0, 1, (b, hid)),
        "dys": rng.normal(0, 1, (t_len, b, hid)),
        "dhT": rng.normal(0, 1, (b, hid)),
    }
    return {k: v.astype(dtype) for k, v in arrs.items()}


def _jax(a, dtype=None):
    """The Pallas kernels' outputs and VJP: ``(ys, hT), (dzx, dW_rec, dh0)``,
    as float32 numpy arrays."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.pallas.fused_gru import fused_gru, fused_gru_compatible
    j = {k: jnp.asarray(v, dtype=dtype) for k, v in a.items()}
    assert fused_gru_compatible(j["zx"], j["h0"])
    out, vjp = jax.vjp(fused_gru, j["zx"], j["w_rec"], j["h0"])
    grads = vjp((j["dys"], j["dhT"]))
    f32 = lambda v: np.asarray(v.astype(jnp.float32))  # noqa: E731
    return [f32(v) for v in out], [f32(v) for v in grads]


def _port_grads(t):
    """Outputs and gradients of sum(ys*dys) + sum(hT*dhT) through the
    autograd wrapper."""
    leaves = [t[k].clone().requires_grad_() for k in ("zx", "w_rec", "h0")]
    ys, h_t = port.fused_gru(*leaves)
    loss = (ys * t["dys"]).sum() + (h_t * t["dhT"]).sum()
    return (ys.detach(), h_t.detach()), torch.autograd.grad(loss, leaves)


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol, atol=atol,
                               err_msg=what)


def test_plain_forward_matches_pallas_kernel():
    a = _inputs(0)
    (ys_j, h_j), _ = _jax(a)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    before = port.counter.value
    ys, h_t = port.fused_gru(t["zx"], t["w_rec"], t["h0"])
    _close(ys, ys_j, "ys")
    _close(h_t, h_j, "hT")
    assert port.counter.value == before  # CPU tensors launch nothing


def test_plain_backward_and_wrapper_match_jax_vjp():
    a = _inputs(1)
    (ys_j, h_j), (dzx_j, dw_j, dh0_j) = _jax(a)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    # the plain backward on the plain forward's residuals
    ys, _, gates, zhn = port.gru_reference(t["zx"], t["w_rec"], t["h0"], save=True)
    dzx, dh0 = port.gru_bwd_reference(t["dys"], t["dhT"], gates, zhn, ys, t["h0"],
                                      t["w_rec"])
    dw = port.gru_param_grads(dzx, ys, t["h0"], gates, t["w_rec"])
    for name, got, want in (("dzx", dzx, dzx_j), ("dW_rec", dw, dw_j), ("dh0", dh0, dh0_j)):
        _close(got, want, name)
    # the autograd wrapper
    before = (port.save_counter.value, port.bwd_counter.value)
    (ys_w, h_w), grads = _port_grads(t)
    _close(ys_w, ys_j, "wrapper ys")
    _close(h_w, h_j, "wrapper hT")
    for name, got, want in zip(("dzx", "dW_rec", "dh0"), grads, (dzx_j, dw_j, dh0_j)):
        _close(got, want, f"wrapper {name}")
    assert (port.save_counter.value, port.bwd_counter.value) == before


def test_saved_residuals_match_the_pallas_forward():
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.pallas.fused_gru import _gru_fwd
    a = _inputs(2)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    ys_j, h_j, (gates_j, zhn_j) = _gru_fwd(j["zx"], j["w_rec"], j["h0"],
                                           save_residuals=True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    ys, h_t, gates, zhn = port.gru_reference(t["zx"], t["w_rec"], t["h0"], save=True)
    for name, got, want in (("ys", ys, ys_j), ("hT", h_t, h_j), ("gates", gates, gates_j),
                            ("zh_n", zhn, zhn_j)):
        _close(got, np.asarray(want), name)


def test_bfloat16_matches_pallas_kernel_within_ulps():
    import jax.numpy as jnp
    a = _inputs(3)
    (ys_j, h_j), grads_j = _jax(a, dtype=jnp.bfloat16)
    t = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in a.items()}
    (ys, h_t), grads = _port_grads(t)
    assert ys.dtype == h_t.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    _close(ys, ys_j, "bf16 ys", rtol=0, atol=BF16_ATOL)
    _close(h_t, h_j, "bf16 hT", rtol=0, atol=BF16_ATOL)
    for name, got, want in zip(("dzx", "dW_rec", "dh0"), grads, grads_j):
        _close(got, want, f"bf16 {name}", rtol=0,
               atol=4 * 2.0 ** -8 * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", [(5, 3, 200), (3, 70, 16), (1, 4, 8), (T, B, H)],
                         ids=["ragged", "over_one_launch", "one_step", "parity_shape"])
def test_plain_backward_matches_float64_autograd(shape):
    """Shapes the TPU kernels refused (B % 8, H % 128, T < 32, B > 64)."""
    t_len, b, hid = shape
    t = {k: torch.from_numpy(v)
         for k, v in _inputs(4, t_len, b, hid, np.float64, w_scale=0.3).items()}
    leaves = [t[k].clone().requires_grad_() for k in ("zx", "w_rec", "h0")]
    ys, h_t = port.gru_reference(*leaves)
    loss = (ys * t["dys"]).sum() + (h_t * t["dhT"]).sum()
    want = torch.autograd.grad(loss, leaves)
    ys, _, gates, zhn = port.gru_reference(t["zx"], t["w_rec"], t["h0"], save=True)
    dzx, dh0 = port.gru_bwd_reference(t["dys"], t["dhT"], gates, zhn, ys, t["h0"],
                                      t["w_rec"])
    dw = port.gru_param_grads(dzx, ys, t["h0"], gates, t["w_rec"])
    for name, got, w in zip(("dzx", "dW_rec", "dh0"), (dzx, dw, dh0), want):
        torch.testing.assert_close(got, w, rtol=1e-10, atol=1e-12, msg=name)


def test_bfloat16_rounding_points():
    """In bf16: ys and the residuals are stored in bf16 and the forward's
    product reads h rounded (ys[t-1]) while the blend uses the fp32 carry;
    the backward reads h_prev from ys, feeds round(da * r) (da unrounded)
    to the recurrent product, and dW_rec rebuilds the n-third from the
    rounded dzx."""
    bf = torch.bfloat16
    t = {k: torch.from_numpy(v).to(bf) for k, v in _inputs(5).items()}
    ys, h_t, gates, zhn = port.gru_reference(t["zx"], t["w_rec"], t["h0"], save=True)
    w = t["w_rec"].float()
    h = t["h0"].float()
    for s in range(T):
        zh = h.to(bf).float() @ w
        z = t["zx"][s].float()
        r = torch.sigmoid(z[:, :H] + zh[:, :H])
        u = torch.sigmoid(z[:, H:2 * H] + zh[:, H:2 * H])
        n = torch.tanh(z[:, 2 * H:] + r * zh[:, 2 * H:])
        h = (1 - u) * n + u * h
        torch.testing.assert_close(ys[s], h.to(bf), rtol=0, atol=0)
        torch.testing.assert_close(gates[s], torch.cat([r, u, n], 1).to(bf), rtol=0, atol=0)
        torch.testing.assert_close(zhn[s], zh[:, 2 * H:].to(bf), rtol=0, atol=0)
    torch.testing.assert_close(h_t, h.to(bf), rtol=0, atol=0)
    dzx, dh0 = port.gru_bwd_reference(t["dys"], t["dhT"], gates, zhn, ys, t["h0"],
                                      t["w_rec"])
    dh = t["dhT"].float()
    for s in reversed(range(T)):
        r, u, n = gates[s].float().split(H, dim=1)
        hp = (t["h0"] if s == 0 else ys[s - 1]).float()
        dh = dh + t["dys"][s].float()
        du = dh * (hp - n) * u * (1 - u)
        da = dh * (1 - u) * (1 - n * n)
        ds_r = da * zhn[s].float() * r * (1 - r)
        torch.testing.assert_close(dzx[s], torch.cat([ds_r, du, da], 1).to(bf), rtol=0, atol=0)
        w_t = w.t()
        dh = (dh * u + ds_r.to(bf).float() @ w_t[:H] + du.to(bf).float() @ w_t[H:2 * H]
              + (da * r).to(bf).float() @ w_t[2 * H:])
    torch.testing.assert_close(dh0, dh.to(bf), rtol=0, atol=0)
    dw = port.gru_param_grads(dzx, ys, t["h0"], gates, t["w_rec"])
    h_prev = torch.cat([t["h0"][None], ys[:-1]]).reshape(-1, H).float()
    n_third = (dzx[..., 2 * H:].float() * gates[..., :H].float()).to(bf)
    ds_rec = torch.cat([dzx[..., :2 * H], n_third], -1).reshape(-1, 3 * H).float()
    torch.testing.assert_close(dw, (h_prev.t() @ ds_rec).to(bf), rtol=0, atol=0)


def test_no_gradient_needed_takes_the_inference_forward():
    """Under ``inference_mode`` (serving) or with no input needing a
    gradient, the wrapper returns plain outputs: no autograd node, so no
    saving forward and no backward."""
    t = {k: torch.from_numpy(v) for k, v in _inputs(6).items()}
    w = t["w_rec"].clone().requires_grad_()
    with torch.inference_mode():
        ys, _ = port.fused_gru(t["zx"], w, t["h0"])
    assert ys.grad_fn is None
    ys, _ = port.fused_gru(t["zx"], t["w_rec"], t["h0"])
    assert ys.grad_fn is None
    ys, _ = port.fused_gru(t["zx"], w, t["h0"])
    assert ys.grad_fn is not None


def test_non_cpu_tensors_go_to_the_kernel_launchers(monkeypatch):
    """On any device but the CPU the wrapper launches the kernels (here
    recorded on ``meta`` tensors): the inference forward without a
    gradient, the saving forward and the backward under autograd; there is
    no path to the plain versions."""
    calls = []

    def fwd(zx, w, h0, launches, save=False):
        calls.append((launches.name, save))
        t_len, b, h3 = zx.shape
        e = lambda *s: torch.empty(s, device=zx.device)  # noqa: E731
        out = (e(t_len, b, h3 // 3), e(b, h3 // 3))
        return out + (e(t_len, b, h3), e(t_len, b, h3 // 3)) if save else out

    def bwd(dys, dhT, gates, zhn, ys, h0, w, launches):
        calls.append((launches.name, None))
        return torch.empty_like(gates), torch.empty_like(h0)

    for name in ("gru_reference", "gru_bwd_reference"):
        monkeypatch.setattr(port, name, lambda *a, **k: pytest.fail("plain version"))
    monkeypatch.setattr(port, "_check", lambda *a: None)  # meta tensors pass no check
    monkeypatch.setattr(port, "_check_bwd", lambda *a: None)
    monkeypatch.setattr(port, "launch_gru_fwd", fwd)
    monkeypatch.setattr(port, "launch_gru_bwd", bwd)
    meta = [torch.empty(s, device="meta") for s in ((3, 2, 12), (4, 12), (2, 4))]
    port.fused_gru(*meta)
    ys, _ = port.fused_gru(*[m.requires_grad_() for m in meta])
    ys.sum().backward()
    assert calls == [("fused_gru", False), ("fused_gru_save", True), ("fused_gru_bwd", None)]


def test_wrong_shapes_and_devices_raise():
    t = {k: torch.from_numpy(v) for k, v in _inputs(7, 2, 2, 4).items()}
    with pytest.raises(ValueError, match="3H"):
        port.fused_gru(t["zx"][..., :-1], t["w_rec"], t["h0"])
    with pytest.raises(ValueError, match="w_rec"):
        port.fused_gru(t["zx"], t["w_rec"][:, :-3], t["h0"])
    with pytest.raises(TypeError, match="h0"):
        port.fused_gru(t["zx"], t["w_rec"], t["h0"].double())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        meta = [torch.empty(v.shape, device="meta") for v in (t["zx"], t["w_rec"], t["h0"])]
        port.fused_gru(*meta)
