"""The line search and the L-BFGS preconditioner the legacy solvers use.

The JAX package's solvers (``train/solvers.py``) are built from optax 0.2.6:
``scale_by_zoom_linesearch`` (``optax/_src/linesearch.py:1331``, with the
``zoom_linesearch`` it instantiates, ``:576``) and ``scale_by_lbfgs``
(``optax/_src/transform.py:1573``) inside ``optax.lbfgs``. There is no
optax on the card's machine, so this module re-implements the pieces the
solvers reach, on lists of tensors (a parameter tree's leaves, in
``tree_leaves`` order), with the defaults the JAX solvers run:

- :class:`ZoomLinesearch`: ``scale_by_zoom_linesearch(max_linesearch_steps)``
  with that function's own defaults: no maximal step, ``tol=0``, the
  interval grown by 2, the sufficient-decrease tolerance ``1e-4`` (Armijo,
  with Hager-Zhang's approximate form near the minimum, ``1e-6`` of the
  value), the curvature tolerance ``0.9``, an interval threshold of
  ``1e-5``, and the ``"keep"`` initial guess (each search starts from the
  previous accepted step; the first from 1). The interval search
  (Nocedal-Wright 3.5) and the zoom (3.6) with its cubic, quadratic and
  bisection candidates and their safeguards, the safe step taken when the
  budget runs out, all as optax computes them.
- :class:`LBFGS`: ``optax.lbfgs``'s chain with a line search: the memory-10
  two-loop preconditioner, the identity scale from the newest pair
  (``scale_init_precond=True``; the first step capped to a unit norm), the
  negation, then the line search.

The line search's decisions are made on the host: each evaluation's value
and slope (the directional derivative) are read back, one synchronisation
per evaluation, and every scalar of the search is computed in the
parameters' floating dtype (numpy scalars of it), as optax's are in the
parameters' dtype. The preconditioner stays on the tensors' device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

Leaves = List[torch.Tensor]
ValueAndGrad = Callable[[Leaves], Tuple[torch.Tensor, Leaves]]


def host_vdot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor], dt) -> np.generic:
    """``optax.tree.vdot(a, b)`` on the host: per-leaf dot products summed
    in leaf order from 0, in ``dt``."""
    if not a:
        return dt(0.0)
    dots = torch.stack([torch.dot(x.reshape(-1), y.reshape(-1)) for x, y in zip(a, b)])
    total = dt(0.0)
    for d in dots.tolist():
        total = total + dt(d)
    return total


def device_vdot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.tree.vdot`` as a 0-d tensor (summed in leaf order)."""
    total = None
    for x, y in zip(a, b):
        d = torch.dot(x.reshape(-1), y.reshape(-1))
        total = d if total is None else total + d
    return total


def add_scale(x: Leaves, scalar, y: Leaves) -> Leaves:
    """``optax.tree.add_scale``: ``x + scalar * y`` leaf by leaf."""
    return [a + float(scalar) * b for a, b in zip(x, y)]


def scale(scalar, x: Leaves) -> Leaves:
    return [float(scalar) * a for a in x]


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """A critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope ``fpa`` at ``a`` (NaN when there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc ** 2 * r0 + -(db ** 2) * r1) / denom
    B = (-(dc ** 3) * r0 + db ** 3 * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope ``fpa`` at ``a``."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2.0 * B)


@dataclasses.dataclass
class _Search:
    """``ZoomLinesearchState``: the search's scalars (in the parameters'
    dtype) and the tensors it carries."""

    count: int
    params: Leaves
    updates: Leaves
    stepsize_guess: np.generic
    stepsize: np.generic
    value: np.generic
    grad: Leaves
    slope: np.generic
    value_init: np.generic
    slope_init: np.generic
    decrease_error: np.generic
    curvature_error: np.generic
    error: np.generic
    interval_found: bool
    done: bool
    failed: bool
    low: np.generic
    value_low: np.generic
    slope_low: np.generic
    high: np.generic
    value_high: np.generic
    slope_high: np.generic
    cubic_ref: np.generic
    value_cubic_ref: np.generic
    safe_stepsize: np.generic
    safe_value: np.generic
    safe_grad: Leaves


@dataclasses.dataclass
class LinesearchState:
    """``ScaleByZoomLinesearchState``: the accepted step, the value and
    gradient there, and the search's step count."""

    learning_rate: np.generic
    value: np.generic
    grad: Optional[Leaves]
    num_linesearch_steps: int = 0


class ZoomLinesearch:
    """``optax.scale_by_zoom_linesearch(max_linesearch_steps)`` with that
    function's defaults, the only ones the solvers use (see the module
    docstring). ``update`` scales a descent direction by the accepted
    step; ``value_and_grad`` evaluates the objective and its gradient at a
    list of leaves."""

    tol = 0.0  # on both criteria
    increase_factor = 2.0  # of the step while no interval is found
    slope_rtol = 1e-4  # sufficient decrease (Armijo)
    curv_rtol = 0.9  # small curvature
    approx_dec_rtol = 1e-6  # Hager-Zhang's approximate decrease
    interval_threshold = 1e-5  # stepsize_precision

    def __init__(self, max_linesearch_steps: int):
        self.max_steps = int(max_linesearch_steps)

    # ---- criteria
    def _decrease_error(self, stepsize, value_step, slope_step, value_init, slope_init):
        err = value_step - value_init - self.slope_rtol * stepsize * slope_init
        approx = slope_step - (2 * self.slope_rtol - 1.0) * slope_init
        delta = value_step - value_init - self.approx_dec_rtol * np.abs(value_init)
        err = np.maximum(np.minimum(np.maximum(approx, delta), err), 0.0)
        return np.inf * np.ones_like(err) if np.isnan(err) else err

    def _curvature_error(self, slope_step, slope_init):
        err = np.maximum(np.abs(slope_step) - self.curv_rtol * np.abs(slope_init), 0.0)
        return np.inf * np.ones_like(err) if np.isnan(err) else err

    def _on_line(self, vg: ValueAndGrad, s: _Search, stepsize):
        dt = type(s.value_init)
        value, grad = vg(add_scale(s.params, stepsize, s.updates))
        return dt(value.item()), grad, host_vdot(grad, s.updates, dt)

    # ---- the two phases
    def _search_interval(self, s: _Search, vg: ValueAndGrad) -> _Search:
        """Algorithm 3.5 of Nocedal and Wright: grow the step until an
        interval holding an acceptable one is found."""
        dt = type(s.value_init)
        new_stepsize = s.stepsize_guess if s.count == 0 else dt(self.increase_factor * s.stepsize)
        value, grad, slope = self._on_line(vg, s, new_stepsize)
        dec = self._decrease_error(new_stepsize, value, slope, s.value_init, s.slope_init)
        curv = self._curvature_error(slope, s.slope_init)
        err = np.maximum(dec, curv)
        if dec <= self.tol:
            safe = (new_stepsize, value, grad)
        else:
            safe = (s.safe_stepsize, s.safe_value, s.safe_grad)
        set_high = bool(dec > 0.0) or (bool(value >= s.value) and s.count > 0)
        set_low = bool(slope >= 0.0) and not set_high
        if set_low:
            low, v_low, sl_low = new_stepsize, value, slope
            high, v_high, sl_high = s.stepsize, s.value, s.slope
        else:
            low, v_low, sl_low = s.stepsize, s.value, s.slope
            high, v_high, sl_high = new_stepsize, value, slope
        found = set_high or set_low or bool(err <= self.tol)
        done = bool(err <= self.tol)  # no maximal step: an interval is always found
        failed = (s.count + 1 >= self.max_steps) and not done
        return dataclasses.replace(
            s, count=s.count + 1, stepsize=new_stepsize, value=value, grad=grad, slope=slope,
            decrease_error=dec, curvature_error=curv, error=err, interval_found=found,
            done=done, failed=failed, low=low, value_low=v_low, slope_low=sl_low, high=high,
            value_high=v_high, slope_high=sl_high, cubic_ref=low, value_cubic_ref=v_low,
            safe_stepsize=safe[0], safe_value=safe[1], safe_grad=safe[2])

    def _zoom_into_interval(self, s: _Search, vg: ValueAndGrad) -> _Search:
        """Algorithm 3.6 of Nocedal and Wright: shrink the interval by a
        safeguarded cubic, else quadratic, else bisection candidate."""
        low, value_low, slope_low = s.low, s.value_low, s.slope_low
        high, value_high, slope_high = s.high, s.value_high, s.slope_high
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
        too_small = bool(delta <= self.interval_threshold)
        middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high, s.cubic_ref,
                                 s.value_cubic_ref)
        use_cubic = bool((middle_cubic > left + cubic_chk) & (middle_cubic < right - cubic_chk))
        middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
        use_quad = not use_cubic and bool((middle_quad > left + quad_chk)
                                          & (middle_quad < right - quad_chk))
        if use_cubic:
            middle = middle_cubic
        elif use_quad:
            middle = middle_quad
        else:
            middle = (low + high) / 2.0
        value, grad, slope = self._on_line(vg, s, middle)
        dec = self._decrease_error(middle, value, slope, s.value_init, s.slope_init)
        curv = self._curvature_error(slope, s.slope_init)
        err = np.maximum(dec, curv)
        if dec <= self.tol and value < s.safe_value:
            safe = (middle, value, grad)
        else:
            safe = (s.safe_stepsize, s.safe_value, s.safe_grad)
        done = bool(err <= self.tol)
        set_high_to_middle = bool(dec > 0.0) or bool(value >= value_low)
        set_high_to_low = bool(slope * (high - low) >= 0.0) and not set_high_to_middle
        new_high = (middle, value, slope) if set_high_to_middle else (high, value_high, slope_high)
        if set_high_to_low:
            new_high = (low, value_low, slope_low)
        new_low = (middle, value, slope) if not set_high_to_middle else (low, value_low, slope_low)
        cubic = (high, value_high) if (set_high_to_middle or set_high_to_low) \
            else (low, value_low)
        presumably_failed = (s.count + 1 >= self.max_steps) or (too_small and safe[0] > 0.0)
        return dataclasses.replace(
            s, count=s.count + 1, stepsize=middle, value=value, grad=grad, slope=slope,
            decrease_error=dec, curvature_error=curv, error=err, done=done,
            failed=bool(presumably_failed and not done), low=new_low[0],
            value_low=new_low[1], slope_low=new_low[2], high=new_high[0],
            value_high=new_high[1], slope_high=new_high[2], cubic_ref=cubic[0],
            value_cubic_ref=cubic[1], safe_stepsize=safe[0], safe_value=safe[1],
            safe_grad=safe[2])

    @staticmethod
    def _try_safe_step(s: _Search) -> _Search:
        """Out of budget: take the best step with sufficient decrease found,
        if any (or if the last one left the domain)."""
        if s.safe_stepsize > 0.0 or np.isinf(s.decrease_error):
            return dataclasses.replace(s, stepsize=s.safe_stepsize, value=s.safe_value,
                                       grad=s.safe_grad)
        return s

    # ---- the transform
    def init(self, params: Leaves) -> LinesearchState:
        dt = _dtype(params)
        return LinesearchState(learning_rate=dt(1.0), value=dt(np.inf), grad=None)

    def update(self, updates: Leaves, state: LinesearchState, params: Leaves, *, value,
               grad: Leaves, value_and_grad: ValueAndGrad) -> Tuple[Leaves, LinesearchState]:
        """``updates`` (a descent direction) scaled by the accepted step;
        the new state."""
        dt = _dtype(params)
        with np.errstate(all="ignore"):
            value = dt(value.item() if isinstance(value, torch.Tensor) else value)
            slope = host_vdot(updates, grad, dt)
            guess = state.learning_rate  # the "keep" initial guess
            zero = dt(0.0)
            s = _Search(count=0, params=params, updates=updates, stepsize_guess=guess,
                        stepsize=zero, value=value, grad=grad, slope=slope, value_init=value,
                        slope_init=slope, decrease_error=dt(np.inf), curvature_error=dt(np.inf),
                        error=dt(np.inf), interval_found=False, done=False, failed=False,
                        low=zero, value_low=value, slope_low=slope, high=zero, value_high=value,
                        slope_high=slope, cubic_ref=zero, value_cubic_ref=value,
                        safe_stepsize=zero, safe_value=value, safe_grad=grad)
            while not (s.done or s.failed):
                s = (self._zoom_into_interval if s.interval_found else self._search_interval)(
                    s, value_and_grad)
                if s.failed:
                    s = self._try_safe_step(s)
        new = LinesearchState(learning_rate=dt(s.stepsize), value=s.value, grad=s.grad,
                              num_linesearch_steps=s.count)
        return scale(s.stepsize, updates), new


def _dtype(params: Leaves):
    """The numpy scalar type of the parameters' floating dtype."""
    return np.float64 if params and params[0].dtype == torch.float64 else np.float32


@dataclasses.dataclass
class LBFGSState:
    count: int
    params: Leaves
    updates: Leaves
    diff_params: Leaves  # per leaf (memory, *shape)
    diff_updates: Leaves
    weights: torch.Tensor  # (memory,)


class LBFGS:
    """``optax.scale_by_lbfgs(memory_size=10, scale_init_precond=True)``
    (``optax.lbfgs``'s): the update (a gradient) multiplied by the
    inverse-Hessian approximation of the last 10 parameter and gradient
    differences, its identity scale from the newest pair."""

    memory_size = 10

    def init(self, params: Leaves) -> LBFGSState:
        m = self.memory_size
        zeros = [torch.zeros((m,) + tuple(p.shape), dtype=p.dtype, device=p.device)
                 for p in params]
        device = params[0].device if params else "cpu"
        return LBFGSState(count=0, params=[torch.zeros_like(p) for p in params],
                          updates=[torch.zeros_like(p) for p in params], diff_params=zeros,
                          diff_updates=[z.clone() for z in zeros],
                          weights=torch.zeros(m, dtype=_torch_dtype(params), device=device))

    def update(self, updates: Leaves, state: LBFGSState, params: Leaves
               ) -> Tuple[Leaves, LBFGSState]:
        m = self.memory_size
        memory_idx = state.count % m
        prev_idx = (state.count - 1) % m
        diff_params = [p - q for p, q in zip(params, state.params)]
        diff_updates = [u - v for u, v in zip(updates, state.updates)]
        vdot_du_dp = device_vdot(diff_updates, diff_params)
        one = torch.ones((), dtype=state.weights.dtype, device=state.weights.device)
        weight = torch.where(vdot_du_dp == 0.0, torch.zeros_like(one), one / vdot_du_dp)
        if state.count == 0:
            diff_params = [torch.zeros_like(d) for d in diff_params]
            diff_updates = [torch.zeros_like(d) for d in diff_updates]
            weight = torch.zeros_like(weight)
        dp_mem = [mem.clone() for mem in state.diff_params]
        du_mem = [mem.clone() for mem in state.diff_updates]
        for mem, d in zip(dp_mem, diff_params):
            mem[prev_idx] = d
        for mem, d in zip(du_mem, diff_updates):
            mem[prev_idx] = d
        rhos = state.weights.clone()
        rhos[prev_idx] = weight.to(rhos.dtype)
        if state.count == 0:  # the first step capped to a unit norm
            identity_scale = torch.minimum(one, one / torch.sqrt(_sum_sq(updates)))
        else:
            numerator = device_vdot(diff_updates, diff_params)
            denominator = _sum_sq(diff_updates)
            identity_scale = torch.where(denominator > 0.0, numerator / denominator, one)
        precond = _precondition(updates, dp_mem, du_mem, rhos, identity_scale, memory_idx)
        return precond, LBFGSState(count=state.count + 1, params=list(params),
                                   updates=list(updates), diff_params=dp_mem,
                                   diff_updates=du_mem, weights=rhos)


def _sum_sq(leaves: Leaves) -> torch.Tensor:
    """``optax.tree.norm(..., squared=True)``: per-leaf sums of squares
    added in leaf order."""
    total = None
    for x in leaves:
        s = torch.sum(x * x)
        total = s if total is None else total + s
    return total


def _torch_dtype(params: Leaves) -> torch.dtype:
    return torch.float64 if params and params[0].dtype == torch.float64 else torch.float32


def _precondition(updates: Leaves, dp_mem: Leaves, du_mem: Leaves, rhos: torch.Tensor,
                  identity_scale: torch.Tensor, memory_idx: int) -> Leaves:
    """Nocedal and Wright's two-loop recursion (Algorithm 7.4), in the ring
    order of the memory starting at ``memory_idx``."""
    m = rhos.shape[0]
    indices = [(memory_idx + j) % m for j in range(m)]
    vec = list(updates)
    alphas = {}
    for idx in reversed(indices):
        alpha = rhos[idx] * device_vdot([d[idx] for d in dp_mem], vec)
        vec = [v + (-alpha) * d[idx] for v, d in zip(vec, du_mem)]
        alphas[idx] = alpha
    vec = [identity_scale * v for v in vec]
    for idx in indices:
        beta = rhos[idx] * device_vdot([d[idx] for d in du_mem], vec)
        vec = [v + (alphas[idx] - beta) * d[idx] for v, d in zip(vec, dp_mem)]
    return vec


__all__ = ["LBFGS", "LBFGSState", "LinesearchState", "ZoomLinesearch", "add_scale",
           "device_vdot", "host_vdot", "scale"]
