"""Small-leaf train-state packing and grouped dispatch for the fit loops.

Counterpart of ``deeplearning4j_tpu/runtime/state_packing.py``. There the
packed buffers are the boundary of a jitted step; here they are the static
memory a captured CUDA graph reads and writes in place
(:class:`~.compile_cache.AotCache`). :class:`LeafPacker` copies every leaf
of at most ``DEFAULT_MAX_LEAF_BYTES`` (and at most 2-d) into one flat
buffer per dtype, and the network's tensors become views into those
buffers, so a step that updates its parameters, optimizer moments and
layer state in place updates the buffers. A graph's validity then rests on
a few addresses (the buffers and the large leaves kept standalone), which
:class:`PackedStepLoop` checks once per fit instead of one per leaf per
step. Values are bit-identical: packing copies, the views alias.

:class:`GroupedDispatch` is the JAX package's buffer-and-flush protocol
(``:227-281``) for ``env.dispatch_unroll``: K same-shape batches run as
one dispatch, on a CUDA device one captured graph of K steps
(:func:`make_unrolled_packed_step`). Its snapshot-and-clear rule stands
against the bug its docstring records: a raising listener or iterator
must never leave an executed group buffered, or the exceptional-exit flush
trains it twice.

Unlike the JAX loop, ``sync(release=True)`` keeps the network's tensors as
views of the buffers: the next ``fit`` finds them packed and replays the
graphs it captured, where re-packing would move the state and capture anew.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_unflatten_like

# One packed segment: leaf index in tree_leaves order, original shape, dtype,
# offset (elements) into that dtype's flat buffer, element count.
_Spec = Tuple[int, Tuple[int, ...], torch.dtype, int, int]

#: Leaves at or below this byte size are packed.
DEFAULT_MAX_LEAF_BYTES = 1 << 20

#: Segment alignment in elements (as in the JAX package): every view starts
#: at least 2 KiB into its buffer from the previous one's start.
DEFAULT_ALIGN = 1024


class LeafPacker:
    """Packs all small tensor leaves of a tree into one flat buffer per
    dtype. ``pack`` copies (returns ``(buffers, kept)``: dtype name -> 1-D
    tensor, and the large leaves in tree order); ``unpack`` gives the tree
    back with the packed leaves as views into the buffers::

        packer = LeafPacker(state)
        packed = packer.pack(state)
        state = packer.unpack(packed)   # views: in-place updates land in the buffers
    """

    def __init__(self, template: Any, max_leaf_bytes: int = DEFAULT_MAX_LEAF_BYTES,
                 align: int = DEFAULT_ALIGN):
        leaves = tree_leaves(template)
        # the structure only: holding the template's tensors would keep the
        # state the packing replaced alive
        self._template = tree_unflatten_like(template, [0] * len(leaves))
        self._n_leaves = len(leaves)
        self._specs: List[_Spec] = []
        self._kept_idx: List[int] = []
        self._sizes: Dict[torch.dtype, int] = {}
        self._device = None
        for i, leaf in enumerate(leaves):
            if not isinstance(leaf, torch.Tensor):
                self._kept_idx.append(i)
                continue
            self._device = self._device or leaf.device
            nbytes = leaf.numel() * leaf.element_size()
            if nbytes <= max_leaf_bytes and leaf.dim() <= 2 and leaf.device == self._device:
                off = self._sizes.get(leaf.dtype, 0)
                n = leaf.numel()
                self._specs.append((i, tuple(leaf.shape), leaf.dtype, off, n))
                self._sizes[leaf.dtype] = off + ((n + align - 1) // align) * align
            else:
                self._kept_idx.append(i)

    @property
    def n_packed(self) -> int:
        return len(self._specs)

    @property
    def n_kept(self) -> int:
        return len(self._kept_idx)

    def stats(self) -> Dict[str, Any]:
        return {
            "leaves": self._n_leaves,
            "packed": self.n_packed,
            "kept": self.n_kept,
            "buffer_bytes": {str(dt).replace("torch.", ""): n * torch.empty((), dtype=dt)
                             .element_size() for dt, n in self._sizes.items()},
        }

    def _check(self, leaves) -> None:
        if len(leaves) != self._n_leaves:
            raise ValueError("LeafPacker: tree structure differs from the template "
                             f"({len(leaves)} leaves vs {self._n_leaves})")
        for i, shape, dt, _, _ in self._specs:
            t = leaves[i]
            if not isinstance(t, torch.Tensor) or t.dtype != dt or tuple(t.shape) != shape:
                raise ValueError(
                    f"LeafPacker: leaf {i} is {getattr(t, 'dtype', type(t))} "
                    f"{tuple(getattr(t, 'shape', ()))}, the template recorded {dt} {shape}: "
                    "rebuild the packer for the current state")

    def pack(self, tree: Any) -> Tuple[Dict[str, torch.Tensor], List[Any]]:
        leaves = tree_leaves(tree)
        self._check(leaves)
        buffers = {dt: torch.zeros(n, dtype=dt, device=self._device)
                   for dt, n in self._sizes.items()}
        with torch.no_grad():
            for i, shape, dt, off, n in self._specs:
                buffers[dt][off:off + n].copy_(leaves[i].reshape(n))
        return ({str(dt).replace("torch.", ""): b for dt, b in buffers.items()},
                [leaves[i] for i in self._kept_idx])

    def unpack(self, packed: Tuple[Dict[str, torch.Tensor], List[Any]]) -> Any:
        buffers, kept = packed
        leaves: List[Any] = [None] * self._n_leaves
        for i, shape, dt, off, n in self._specs:
            leaves[i] = buffers[str(dt).replace("torch.", "")][off:off + n].view(shape)
        for j, i in enumerate(self._kept_idx):
            leaves[i] = kept[j]
        return tree_unflatten_like(self._template, leaves)

    def is_packed(self, tree: Any, packed) -> bool:
        """Whether ``tree``'s small leaves are still the views of
        ``packed``'s buffers this packer made (nothing rebound them)."""
        buffers, kept = packed
        leaves = tree_leaves(tree)
        if len(leaves) != self._n_leaves:
            return False
        for i, shape, dt, off, n in self._specs:
            t, b = leaves[i], buffers[str(dt).replace("torch.", "")]
            if (not isinstance(t, torch.Tensor) or t.dtype != dt or tuple(t.shape) != shape
                    or t.data_ptr() != b.data_ptr() + off * b.element_size()):
                return False
        return all(leaves[i] is k for i, k in zip(self._kept_idx, kept))

    @staticmethod
    def signature(packed) -> tuple:
        """The addresses a captured step reads: every buffer and kept leaf."""
        buffers, kept = packed
        return (tuple((k, b.data_ptr(), b.numel()) for k, b in sorted(buffers.items()))
                + state_signature(kept))


def assign_state(old: Any, new: Any) -> Any:
    """The tree ``new`` written into the tree ``old`` (the same structure):
    a leaf of the same shape, dtype and device is copied in place (a step's
    new layer state, written where a captured graph reads it), any other
    takes ``new``'s leaf (as the JAX step's ``model_state=new_state``
    replaces it: a float32 running statistic stepped in float64 becomes
    float64, once). Returns the tree."""
    out = []
    with torch.no_grad():
        for o, n in zip(tree_leaves(old), tree_leaves(new), strict=True):
            if (isinstance(o, torch.Tensor) and isinstance(n, torch.Tensor)
                    and o.shape == n.shape and o.dtype == n.dtype and o.device == n.device):
                if n is not o:
                    o.copy_(n)
                out.append(o)
            else:
                out.append(n.detach() if isinstance(n, torch.Tensor) else n)
    return tree_unflatten_like(new, out)


def state_signature(leaves) -> tuple:
    """``(address, shape, dtype)`` of every tensor in ``leaves``: a graph
    captured over them stays valid while this does not change."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in leaves
                 if isinstance(t, torch.Tensor))


def make_unrolled_packed_step(raw_step, packer, k: int):
    """``k`` sequential train steps as one function of the per-step
    argument tuples (env.dispatch_unroll): on a CUDA device it is captured
    as ONE graph. ``raw_step(*args)`` updates the packed state in place and
    returns the step's loss; the losses come back stacked. ``packer`` is
    the state's packer (the steps run on its views), kept for the JAX
    package's signature."""
    del packer

    def unrolled(args_list):
        return torch.stack([raw_step(*args_list[i]) for i in range(k)])

    return unrolled


def make_unrolled_step(raw_step, k: int):
    """:func:`make_unrolled_packed_step` over per-leaf state."""
    return make_unrolled_packed_step(raw_step, None, k)


class GroupedDispatch:
    """Buffer-and-flush protocol for grouped dispatch, shared by the fit
    loops (a raising listener or iterator must never leave an executed
    group buffered — the exceptional-exit flush would train it twice, a
    bug reproduced in the JAX package's review before this class existed).

    - ``run_single(args) -> loss`` and ``run_group([args, ...]) -> [loss]``
      perform the dispatches;
    - ``compatible(a, b)`` says whether two buffered tuples may share one
      unrolled program (same shapes / mask presence);
    - ``deliver(args, loss)`` does the caller's per-step bookkeeping
      (score, iteration counters, listeners) in submission order.
    """

    def __init__(self, unroll: int, compatible, run_single, run_group, deliver):
        self._unroll = max(1, int(unroll))
        self._compatible = compatible
        self._run_single = run_single
        self._run_group = run_group
        self._deliver = deliver
        self._pending: list = []

    def submit(self, args) -> None:
        if self._unroll <= 1:
            self._deliver(args, self._run_single(args))
            return
        if self._pending and not self._compatible(self._pending[0], args):
            self.flush()
        self._pending.append(args)
        if len(self._pending) >= self._unroll:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        # snapshot-and-clear BEFORE dispatch/listeners (see class docstring)
        todo = list(self._pending)
        self._pending.clear()
        if len(todo) == self._unroll and self._unroll > 1:
            losses = self._run_group(todo)
        else:  # partial tail group: single steps avoid a fresh capture
            losses = [self._run_single(a) for a in todo]
        for args, loss in zip(todo, losses):
            self._deliver(args, loss)

    def drain_on_error(self) -> None:
        """Best-effort flush for exceptional exits: deliver batches that
        were buffered but never dispatched; if that raises too, drop them
        without masking the original exception."""
        try:
            self.flush()
        except Exception:
            self._pending.clear()


def step_args_signature(args) -> tuple:
    """Cheap structural signature of a step's per-batch arguments (shapes,
    dtypes and devices of tensors, None-ness of masks, dict/list
    structure): the :class:`~.compile_cache.AotCache` key of the fit
    loops. A generator signs by its type and device."""
    def leaf(a):
        if a is None:
            return None
        if isinstance(a, dict):
            return tuple(sorted((k, leaf(v)) for k, v in a.items()))
        if isinstance(a, (list, tuple)):
            return tuple(leaf(v) for v in a)
        if isinstance(a, torch.Tensor):
            return tuple(a.shape), a.dtype, a.device
        if isinstance(a, torch.Generator):
            return "Generator", a.device
        return type(a).__name__

    return tuple(leaf(a) for a in args)


def _step_mode() -> tuple:
    """The environment switches a captured step's program depends on
    (rematerialization), part of every graph's key."""
    from deeplearning4j_tpu_torch.runtime.environment import get_environment
    return ("remat", get_environment().remat_segments)


class PackedStepLoop:
    """Drives a network's train step inside ``fit``, packed and through its
    :class:`~.compile_cache.AotCache` (``net._runtime_cache["__aot__"]``,
    so repeated fits replay the graphs they captured).

    The network provides ``_train_step_fn()`` (a step ``(x, y, generator,
    fm, lm) -> loss`` for a MultiLayerNetwork, ``(inputs, labels, generator,
    masks) -> loss`` for a ComputationGraph, that updates the state in
    place), ``_state_tree()``/``_set_state_tree(tree)`` (parameters,
    optimizer state and layer state) and ``_device_generators()``.

    Packing happens at the first dispatch of a fit, unless the state is
    still packed from the last one. With packing off (``env.packed_state``
    or a listener that reads state) each step's key carries the addresses
    of every state leaf, read anew each step.
    """

    def __init__(self, net, enabled: bool):
        from deeplearning4j_tpu_torch.runtime.compile_cache import AotCache
        self._net = net
        self._enabled = enabled
        self._packed = None
        self._sig = None
        self._aot = net._runtime_cache.setdefault("__aot__", AotCache("fit-step"))
        self._aot.generators = net._device_generators()

    @classmethod
    def for_network(cls, net) -> "PackedStepLoop":
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.prefetch import stateless_listeners
        # same listener gate as async loss delivery: a state-reading
        # listener turns packing, grouping and async delivery off together
        return cls(net, get_environment().packed_state and stateless_listeners(net))

    @property
    def active(self) -> bool:
        return self._packed is not None

    @property
    def enabled(self) -> bool:
        """Whether packed stepping is in effect (env flag + listener gate);
        grouped dispatch gates on it too."""
        return self._enabled

    def _pack(self) -> None:
        net = self._net
        tree = net._state_tree()
        prev = net._runtime_cache.get("__packed__")
        if prev is not None and prev[0].is_packed(tree, prev[1]):
            self._packed = prev[1]
        else:
            packer = LeafPacker(tree)
            self._packed = packer.pack(tree)
            net._set_state_tree(packer.unpack(self._packed))
            net._runtime_cache["__packed__"] = (packer, self._packed)
        self._set_sig(("packed",) + LeafPacker.signature(self._packed))

    def _set_sig(self, sig) -> None:
        """Make ``sig`` the state's signature; graphs over any other (a
        moved state) are dropped."""
        if sig != self._sig:
            self._aot.evict(lambda k: k[1] != sig)
            self._sig = sig

    def _check(self, loss) -> None:
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        if get_environment().nan_panic and not bool(torch.isfinite(loss).all()):
            raise FloatingPointError(f"non-finite loss {loss.tolist()} (nan_panic)")

    def step(self, *rest_args):
        """One train step; returns ``(loss,)`` (the step's tail after the
        state, as in the JAX package)."""
        if not self._enabled:
            self._set_sig(("plain",) + state_signature(tree_leaves(self._net._state_tree())))
        elif self._packed is None:
            self._pack()
        loss = self._aot.call((self._sig[0], self._sig, step_args_signature(rest_args),
                               _step_mode()), self._net._train_step_fn(), *rest_args)
        self._check(loss)
        return (loss,)

    def step_group(self, group):
        """A list of per-step argument tuples as ONE dispatch (one graph of
        ``len(group)`` steps on a CUDA device). All tuples share shapes and
        mask presence. Returns the per-step losses."""
        if not self._enabled or len(group) == 1:
            return [self.step(*args)[0] for args in group]
        if self._packed is None:
            # packing needs no step here (the JAX loop runs the first batch
            # alone to pack): the whole group goes as one dispatch
            self._pack()
        k = len(group)
        fns = self._net._runtime_cache.setdefault("__unrolled__", {})
        if k not in fns:
            fns[k] = make_unrolled_packed_step(self._net._train_step_fn(), None, k)
        losses = self._aot.call(("packed-group", self._sig, k, step_args_signature(group[0]),
                                 _step_mode()), fns[k], [tuple(args) for args in group])
        self._check(losses)
        return [losses[i] for i in range(k)]

    def sync(self, release: bool = False) -> None:
        """The network's tensors are the packed views, so there is nothing
        to copy back; ``release`` forgets this loop's packing (the next
        step checks the state again)."""
        if release:
            self._packed = None
