"""The port's LSTM forward kernels against the JAX package's Pallas kernels.

The CUDA kernels themselves run only on an NVIDIA card (``chip_smoke.py``
holds them against their plain versions there). On the CPU the wrappers
take the plain PyTorch versions, which must compute exactly the Pallas
kernels' function. The Pallas kernels run in interpret mode, as
``tests/test_pallas.py`` runs them.

Tolerance: float32 throughout, ``rtol=1e-4, atol=1e-5``; the two sides sum
``h @ W_rec`` in different orders over T dependent steps.
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
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _inputs(seed, with_mask):
    rng = np.random.default_rng(seed)
    arrs = {
        "zx": rng.normal(0, 1, (T, B, 4 * H)),
        "w_rec": rng.normal(0, 0.3, (H, 4 * H)),
        "peep": rng.normal(0, 0.3, (3 * H,)),
        "h0": rng.normal(0, 1, (B, H)),
        "c0": rng.normal(0, 1, (B, H)),
    }
    if with_mask:
        lens = rng.integers(3, T + 1, B)
        mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float64)
        mask[:, 0] = 0.0  # a row whose every step is masked: h/c held throughout
        mask[5, 3] = 0.0  # a hole inside a row
        arrs["mask"] = mask
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _assert_outputs(port_out, jax_out):
    for name, p, j in zip(("ys", "hT", "cT"), port_out, jax_out):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_plain_lstm_matches_pallas_kernel(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.pallas.fused_lstm import (fused_lstm,
                                                          fused_lstm_compatible)
    a = _inputs(0, with_mask=False)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    assert fused_lstm_compatible(j["zx"], j["h0"])
    jax_out = fused_lstm(j["zx"], j["w_rec"], j["h0"], j["c0"])
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    before = port_plain.counter.value
    port_out = port_plain.fused_lstm(t["zx"], t["w_rec"], t["h0"], t["c0"])
    _assert_outputs(port_out, jax_out)
    assert port_plain.counter.value == before  # CPU tensors launch nothing


@pytest.mark.parametrize("with_mask", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("with_peep", [True, False], ids=["peephole", "no_peephole"])
def test_graves_lstm_matches_pallas_kernel(monkeypatch, with_mask, with_peep):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")
    import jax.numpy as jnp

    from deeplearning4j_tpu.ops.pallas.fused_lstm_graves import (
        fused_graves_lstm, fused_graves_lstm_compatible)
    a = _inputs(1, with_mask=with_mask)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    assert fused_graves_lstm_compatible(j["zx"], j["h0"])
    jax_peep = j["peep"] if with_peep else jnp.zeros((3 * H,), jnp.float32)
    jax_mask = j["mask"] if with_mask else jnp.ones((T, B), jnp.float32)
    jax_out = fused_graves_lstm(j["zx"], j["w_rec"], jax_peep, j["h0"], j["c0"], jax_mask)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    before = port_graves.counter.value
    port_out = port_graves.fused_graves_lstm(
        t["zx"], t["w_rec"], t["peep"] if with_peep else None, t["h0"], t["c0"],
        t["mask"] if with_mask else None)
    _assert_outputs(port_out, jax_out)
    assert port_graves.counter.value == before
    if with_mask:  # the all-masked row emits its h0 at every step
        np.testing.assert_array_equal(port_out[0][:, 0].numpy(),
                                      np.broadcast_to(a["h0"][0], (T, H)))


def test_explicit_zero_peepholes_and_ones_mask_equal_none():
    """``peep=None``/``mask=None`` are the zero peepholes and all-ones mask."""
    t = {k: torch.from_numpy(v) for k, v in _inputs(2, with_mask=False).items()}
    a = port_graves.fused_graves_lstm(t["zx"], t["w_rec"], None, t["h0"], t["c0"], None)
    b = port_graves.fused_graves_lstm(t["zx"], t["w_rec"], torch.zeros(3 * H), t["h0"],
                                      t["c0"], torch.ones(T, B))
    c = port_plain.fused_lstm(t["zx"], t["w_rec"], t["h0"], t["c0"])
    for x, y, z in zip(a, b, c):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        torch.testing.assert_close(x, z, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(5, 3, 200), (1, 64, 16), (7, 130, 8), (6, 17, 8),
                                   (4, 17, 512)],
                         ids=["ragged", "one_step", "over_one_launch",
                              "ragged_row_group_one_k_tile", "ragged_row_group"])
def test_plain_versions_match_a_float64_loop(shape):
    """Shapes the TPU kernels refused (B % 8, H % 128, T < 32) are taken;
    B = 17 and H = 8 are the edges of the card's row-group kernels (a row
    group of 16 and one of 1; one zero-padded k tile)."""
    t_len, b, hid = shape
    rng = np.random.default_rng(3)
    zx = rng.normal(0, 1, (t_len, b, 4 * hid))
    w = rng.normal(0, 0.3, (hid, 4 * hid))
    p = rng.normal(0, 0.3, (3 * hid,))
    h = rng.normal(0, 1, (b, hid))
    c = rng.normal(0, 1, (b, hid))
    m = (rng.random((t_len, b)) > 0.3).astype(np.float64)
    ys, hT, cT = port_graves.fused_graves_lstm(
        *(torch.from_numpy(v.astype(np.float32)) for v in (zx, w, p, h, c, m)))

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    want = []
    for s in range(t_len):
        z = zx[s] + h @ w
        i = sig(z[:, :hid] + c * p[:hid])
        f = sig(z[:, hid:2 * hid] + c * p[hid:2 * hid])
        c_til = f * c + i * np.tanh(z[:, 2 * hid:3 * hid])
        h_til = sig(z[:, 3 * hid:] + c_til * p[2 * hid:]) * np.tanh(c_til)
        mm = m[s][:, None]
        h, c = mm * h_til + (1 - mm) * h, mm * c_til + (1 - mm) * c
        want.append(h)
    np.testing.assert_allclose(ys.numpy(), np.stack(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(hT.numpy(), h, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cT.numpy(), c, rtol=RTOL, atol=ATOL)


def test_bfloat16_rounding_points():
    """In bf16 the carries stay float32 inside; ys/hT/cT are stored in bf16
    and the recurrent product reads h rounded to bf16."""
    t = {k: torch.from_numpy(v) for k, v in _inputs(4, with_mask=False).items()}
    bf = {k: v.to(torch.bfloat16) for k, v in t.items()}
    ys, hT, cT = port_plain.fused_lstm(bf["zx"], bf["w_rec"], bf["h0"], bf["c0"])
    assert ys.dtype == hT.dtype == cT.dtype == torch.bfloat16
    torch.testing.assert_close(ys[-1], hT, rtol=0, atol=0)
    h, c = bf["h0"].float(), bf["c0"].float()
    for s in range(T):
        z = bf["zx"][s].float() + h.to(torch.bfloat16).float() @ bf["w_rec"].float()
        i, f, g, o = z.split(H, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        torch.testing.assert_close(ys[s], h.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(cT, c.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["w_shape", "h0_shape", "peep_shape", "mask_shape",
                                 "dtype_mix", "rank", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    t = {k: torch.from_numpy(v) for k, v in _inputs(5, with_mask=True).items()}
    args = [t["zx"], t["w_rec"], t["peep"], t["h0"], t["c0"], t["mask"]]
    if bad == "w_shape":
        args[1] = args[1][:, :-4]
    elif bad == "h0_shape":
        args[3] = args[3][:-1]
    elif bad == "peep_shape":
        args[2] = args[2][:-1]
    elif bad == "mask_shape":
        args[5] = args[5][:-1]
    elif bad == "dtype_mix":
        args[1] = args[1].double()
    elif bad == "rank":
        args[0] = args[0][0]
    elif bad == "device":  # neither CUDA nor CPU: no kernel and no plain version
        args = [a.to("meta") for a in args]
    with pytest.raises((ValueError, TypeError)):
        port_graves.fused_graves_lstm(*args)
