"""Legacy line-search solvers (reference ``org.deeplearning4j.optimize.solvers``:
``LBFGS``, ``ConjugateGradient``, ``LineGradientDescent`` beside the default
``StochasticGradientDescent``).

Counterpart of ``deeplearning4j_tpu/train/solvers.py``, module for module:

- LBFGS: ``optax.lbfgs`` with the zoom line search (memory 10);
- CONJUGATE_GRADIENT: Polak-Ribiere+ nonlinear conjugate gradient with
  restart (``beta = max(g.(g - g_prev) / |g_prev|^2, 0)``);
- LINE_GRADIENT_DESCENT: steepest descent.

All three scale their direction by the zoom line search of
:mod:`.linesearch` (``scale_by_zoom_linesearch(max_linesearch_steps)`` with
its own defaults), capped at the builder's
``max_num_line_search_iterations``; the outer iteration count per batch is
``solver_iterations``. The rules are the JAX package's: frozen layers'
gradients are zeroed before the solver's update (so they do not move); the
batch's random draws (dropout, weight noise) come from ONE generator drawn
per batch and replayed at every evaluation, so the objective the line search
probes is deterministic; a final training-mode forward keeps the layers'
new state (BatchNormalization's running statistics); the step advances.

Where the JAX package compiles the K iterations into one program (a
``lax.scan`` over jitted iterations, with a ``lax.while_loop`` line search),
the port runs them eagerly: each value-and-gradient evaluation is one
forward and one backward (on the card, one launch of each recurrent
kernel), and the line search decides on the host. ``net._solver_log`` keeps
a record of each of the last 16 batches: the evaluations, the per-iteration
values, the accepted steps and the final loss.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime.state_packing import assign_state
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_unflatten_like
from deeplearning4j_tpu_torch.train.linesearch import LBFGS, ZoomLinesearch, _dtype, host_vdot

Leaves = List[torch.Tensor]


class _CGState(NamedTuple):
    prev_grad: Leaves
    direction: Leaves
    linesearch: Any


class _Solver:
    """An optax ``GradientTransformationExtraArgs``: ``init(params)`` and
    ``update(grads, state, params, value=..., value_and_grad=...)``."""

    def __init__(self, init, update):
        self.init = init
        self.update = update


def conjugate_gradient(max_linesearch_steps: int = 15) -> _Solver:
    """Polak-Ribiere+ nonlinear conjugate gradient (JAX ``:40-66``)."""
    ls = ZoomLinesearch(max_linesearch_steps)

    def init(params):
        zeros = [torch.zeros_like(p) for p in params]
        return _CGState(prev_grad=zeros, direction=zeros, linesearch=ls.init(params))

    def update(grads, state, params, *, value, value_and_grad):
        dt = _dtype(params)
        g_dot = host_vdot(state.prev_grad, state.prev_grad, dt)
        gg = host_vdot(grads, [g - pg for g, pg in zip(grads, state.prev_grad)], dt)
        with np.errstate(all="ignore"):
            beta = np.maximum(gg / np.maximum(g_dot, dt(1e-30)), dt(0.0)) if g_dot > 0 \
                else dt(0.0)
        direction = [-g + float(beta) * d for g, d in zip(grads, state.direction)]
        # the line search takes a DESCENT direction and scales it by the
        # accepted step
        updates, ls_state = ls.update(direction, state.linesearch, params, value=value,
                                      grad=grads, value_and_grad=value_and_grad)
        return updates, _CGState(prev_grad=grads, direction=direction, linesearch=ls_state)

    return _Solver(init, update)


def line_gradient_descent(max_linesearch_steps: int = 15) -> _Solver:
    """Steepest descent: the negated gradient scaled by the accepted step
    (``chain(scale(-1), scale_by_zoom_linesearch)``, JAX ``:69-76``)."""
    ls = ZoomLinesearch(max_linesearch_steps)

    def update(grads, state, params, *, value, value_and_grad):
        return ls.update([-1.0 * g for g in grads], state, params, value=value, grad=grads,
                         value_and_grad=value_and_grad)

    return _Solver(ls.init, update)


def lbfgs(max_linesearch_steps: int = 15) -> _Solver:
    """``optax.lbfgs(linesearch=scale_by_zoom_linesearch(...))``: the L-BFGS
    preconditioner, the negation, the line search."""
    memory, ls = LBFGS(), ZoomLinesearch(max_linesearch_steps)

    def init(params):
        return memory.init(params), ls.init(params)

    def update(grads, state, params, *, value, value_and_grad):
        precond, mem_state = memory.update(grads, state[0], params)
        updates, ls_state = ls.update([-1.0 * u for u in precond], state[1], params,
                                      value=value, grad=grads, value_and_grad=value_and_grad)
        return updates, (mem_state, ls_state)

    return _Solver(init, update)


def make_solver(algo: str, max_linesearch_steps: int = 15) -> _Solver:
    algo = algo.upper()
    if algo == "LBFGS":
        return lbfgs(max_linesearch_steps)
    if algo == "CONJUGATE_GRADIENT":
        return conjugate_gradient(max_linesearch_steps)
    if algo == "LINE_GRADIENT_DESCENT":
        return line_gradient_descent(max_linesearch_steps)
    raise ValueError(f"unknown optimization algorithm {algo!r}")


def _replay(generator: torch.Generator) -> Callable[[], torch.Generator]:
    """A factory of generators in ``generator``'s state: every evaluation
    of the batch draws the same masks (JAX reuses one key)."""
    state = generator.get_state()

    def fresh():
        g = torch.Generator(device=generator.device)
        g.set_state(state)
        return g
    return fresh


def _solver_core(net, frozen_keys, loss_fn, args) -> torch.Tensor:
    """The K-iteration inner loop shared by both networks (JAX
    ``:91-141``). ``loss_fn(params, generator, *args) -> (loss,
    new_state)`` runs a training-mode forward of ``params`` (nested as the
    network's) from the network's current layer state."""
    g = net.conf.global_conf
    algo = g.optimization_algo
    max_ls = max(1, int(g.max_num_line_search_iterations))
    iters = max(1, int(getattr(g, "solver_iterations", 10)))
    tx = make_solver(algo, max_ls)
    params = net._params
    leaves = tree_leaves(params)
    # the float leaves the solver moves; a frozen layer's stay where they are
    frozen = set()
    for k in frozen_keys:
        if k in params:
            frozen.update(id(t) for t in tree_leaves(params[k]))
    floats = [t for t in leaves if t.is_floating_point()]
    moving = [id(t) not in frozen for t in floats]
    draws = _replay(net.rng.next_generator())
    record = {"algorithm": algo, "evaluations": 0, "values": [], "steps": []}

    def rebuild(xs: List[torch.Tensor]):
        it = iter(xs)
        return tree_unflatten_like(params, [next(it) if t.is_floating_point() else t
                                            for t in leaves])

    def value_and_grad(xs: List[torch.Tensor]):
        record["evaluations"] += 1
        xs = [x.detach().requires_grad_(m) for x, m in zip(xs, moving)]
        with torch.enable_grad():
            loss, _ = loss_fn(rebuild(xs), draws(), *args)
            wrt = [x for x, m in zip(xs, moving) if m]
            gs = iter(torch.autograd.grad(loss, wrt, allow_unused=True)) if wrt else iter(())
        grads = []
        for x, m in zip(xs, moving):
            gr = next(gs) if m else None
            # frozen layers' gradients are zero (JAX ``mask_frozen``)
            grads.append(torch.zeros_like(x) if gr is None else gr.to(x.dtype).detach())
        return loss.detach(), grads

    xs = [t.detach() for t in floats]
    state = tx.init(xs)
    for _ in range(iters):
        value, grads = value_and_grad(xs)
        updates, state = tx.update(grads, state, xs, value=value, value_and_grad=value_and_grad)
        xs = [x + u.to(x.dtype) for x, u in zip(xs, updates)]  # optax.apply_updates
        record["values"].append(float(value))
        record["steps"].append(float(_accepted(state)))
    with torch.no_grad():
        for t, x in zip(floats, xs):
            t.copy_(x)
        # the final training-mode forward keeps the layers' new state
        loss, new_state = loss_fn(params, draws(), *args)
    net._model_state = assign_state(net._model_state, new_state)
    record["loss"] = float(loss)
    net._solver_log.append(record)
    return loss.detach()


def _accepted(state) -> float:
    """The line search's accepted step in a solver's state."""
    if isinstance(state, _CGState):
        return state.linesearch.learning_rate
    if isinstance(state, tuple):
        return state[1].learning_rate
    return state.learning_rate


def solver_fit_batch(net, x, y, fmask=None, lmask=None) -> torch.Tensor:
    """One reference ``Solver.optimize`` pass on this batch
    (MultiLayerNetwork, JAX ``:144-159``): the parameters and the layer
    state are updated in place; returns the final loss (0-d)."""
    def loss_fn(p, generator, x, y, fmask, lmask):
        loss, new_state, _ = net._loss(p, net._model_state, x, y, generator, fmask, lmask,
                                       training=True)
        return loss, new_state

    return _solver_core(net, net._frozen_keys(), loss_fn, (x, y, fmask, lmask))


def graph_solver_fit_batch(net, inputs, labels, masks=None) -> torch.Tensor:
    """ComputationGraph variant of :func:`solver_fit_batch` (JAX
    ``:162-173``)."""
    frozen_keys = [n.name for n in net.conf.nodes if n.kind == "layer" and n.obj.frozen]

    def loss_fn(p, generator, inputs, labels, masks):
        return net._loss(p, net._model_state, inputs, labels, generator, masks)

    return _solver_core(net, frozen_keys, loss_fn, (inputs, labels, masks))


__all__ = ["conjugate_gradient", "graph_solver_fit_batch", "lbfgs", "line_gradient_descent",
           "make_solver", "solver_fit_batch"]
