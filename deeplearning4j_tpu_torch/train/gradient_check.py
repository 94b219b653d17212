"""Numerical gradient checking.

Counterpart of ``deeplearning4j_tpu/train/gradient_check.py`` (upstream
``org.deeplearning4j.gradientcheck.GradientCheckUtil``): the training
loss's analytic gradients (``torch.autograd`` through the composed network)
against central finite differences, parameter by parameter, in float64, on
the network's own device.

On the CPU every layer takes float64 through its plain version. On a CUDA
device a layer that launches a hand-written kernel (the LSTM and GRU
recurrences, flash attention) raises on float64 by the kernels' dtype rule
(``ops/kernels/fused_lstm.py:215-216``, ``flash_attention.py:127``): the
kernels are instantiated for float32 and bfloat16 only, and the check does
not swap in their plain versions behind the caller's back. That is the
intended behaviour; check such a network on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_map, tree_paths


class GradientCheckUtil:
    @staticmethod
    def check_gradients(net, features, labels, *, epsilon: float = 1e-4,
                        max_rel_error: float = 1e-2, abs_error_floor: float = 1e-6,
                        max_per_param: int = 5, fmask=None, lmask=None,
                        seed: int = 0, print_results: bool = False) -> bool:
        """Sample up to ``max_per_param`` coordinates of every parameter
        tensor; returns True iff all pass. The network is initialised if it
        is not. The check runs in float64 (the compute dtype is float64 for
        its duration, the parameters, layer state and inputs are float64
        copies), since float32 finite differences at eps=1e-4 swamp a 1e-2
        tolerance. A ``MultiLayerNetwork`` takes ``features``/``labels`` as
        arrays; a ``ComputationGraph`` takes lists (one per input/output)."""
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        env = get_environment()
        cdt_was = env.compute_dtype
        env.compute_dtype = torch.float64
        try:
            return GradientCheckUtil._check_f64(
                net, features, labels, epsilon=epsilon, max_rel_error=max_rel_error,
                abs_error_floor=abs_error_floor, max_per_param=max_per_param,
                fmask=fmask, lmask=lmask, seed=seed, print_results=print_results)
        finally:
            env.compute_dtype = cdt_was

    @staticmethod
    def _check_f64(net, features, labels, *, epsilon, max_rel_error, abs_error_floor,
                   max_per_param, fmask, lmask, seed, print_results) -> bool:
        net._ensure_init()
        dev = net.device

        def up(a):
            t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
            t = t.detach().to(dev, copy=True)
            return t.to(torch.float64) if t.is_floating_point() else t

        params = tree_map(up, net.params())
        model_state = tree_map(up, net._model_state)
        if hasattr(net, "conf") and hasattr(net.conf, "inputs"):  # a ComputationGraph
            xs = features if isinstance(features, (list, tuple)) else [features]
            ys = labels if isinstance(labels, (list, tuple)) else [labels]
            inputs = {n: up(x) for n, x in zip(net.conf.inputs, xs)}
            ys = [up(y) for y in ys]
            masks = None if lmask is None else {net.conf.outputs[0]: up(lmask)}

            def loss_fn(p):
                return net._loss(p, model_state, inputs, ys, None, masks, training=False)[0]
        else:
            x, y = up(features), up(labels)
            fm = None if fmask is None else up(fmask)
            lm = None if lmask is None else up(lmask)

            def loss_fn(p):
                # no dropout: the deterministic path has checkable gradients
                return net._loss(p, model_state, x, y, None, fm, lm, training=False)[0]

        leaves = tree_leaves(params)
        wrt = [t.requires_grad_(True) for t in leaves if t.is_floating_point()]
        with torch.enable_grad():
            analytic = torch.autograd.grad(loss_fn(params), wrt, allow_unused=True)
        for t in wrt:
            t.requires_grad_(False)
        grads = iter(analytic)
        rng = np.random.default_rng(seed)
        ok = True
        with torch.no_grad():
            for path, leaf in zip(tree_paths(params), leaves):
                if not leaf.is_floating_point():
                    continue
                g = next(grads)
                a_np = (np.zeros(tuple(leaf.shape)) if g is None
                        else g.detach().cpu().numpy().astype(np.float64))
                n = leaf.numel()
                picks = rng.choice(n, size=min(max_per_param, n), replace=False)
                flat = leaf.view(-1)
                for flat_idx in picks:
                    idx = np.unravel_index(flat_idx, tuple(leaf.shape))
                    orig = flat[flat_idx].item()
                    flat[flat_idx] = orig + epsilon
                    lp = float(loss_fn(params))
                    flat[flat_idx] = orig - epsilon
                    lm_ = float(loss_fn(params))
                    flat[flat_idx] = orig
                    fd = (lp - lm_) / (2 * epsilon)
                    an = float(a_np[idx])
                    denom = max(abs(fd), abs(an), 1e-10)
                    rel = abs(fd - an) / denom
                    passed = rel < max_rel_error or abs(fd - an) < abs_error_floor
                    if print_results or not passed:
                        print(f"  {'/'.join(map(str, path))}[{idx}]: analytic={an:.6g} "
                              f"fd={fd:.6g} rel={rel:.3g} {'OK' if passed else 'FAIL'}")
                    ok = ok and passed
        return ok
