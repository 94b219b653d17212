"""SameDiff: the declarative graph, executed eagerly in PyTorch.

Counterpart of ``deeplearning4j_tpu/autodiff/samediff.py`` (reference
``org.nd4j.autodiff.samediff.SameDiff``). The graph is the JAX package's: a
list of :class:`OpNode`\\ s (registry op name, input and output variable
names, attrs) over named :class:`SDVariable`\\ s (VARIABLE, PLACEHOLDER,
CONSTANT, ARRAY), with the same builders (``placeholder``, ``var``,
``constant``, ``convert_to_variable``, ``invoke``, the operator sugar and the
``math``/``nn``/``loss``/... namespaces) and the same archive. Where the JAX
package traces the graph into one jitted program, the port walks the ops
needed for the requested outputs in graph order (``_exec_graph``) and
takes gradients with ``torch.autograd``.

Training (``fit``, JAX ``:733-916``): in a step the floating constants,
the trainable masters and the placeholders are cast to the environment's
``compute_dtype`` (the masters stay float32 and the gradients come back
through the cast, JAX ``_make_train_step`` ``:641-672``), the loss is the
float32 sum of the loss variables plus the configuration's l1/l2, and the
configured updater (the port's optax-equivalent, ``train/updaters.py``)
steps the masters in place. With ``env.packed_state`` (and only stateless
listeners) the masters and the updater state are packed
(:class:`~..runtime.state_packing.LeafPacker`), ``env.dispatch_unroll``
steps go as one dispatch through a
:class:`~..runtime.state_packing.GroupedDispatch`, and each dispatch goes
through the graph's :class:`~..runtime.compile_cache.AotCache`: on a CUDA
device a captured graph of the step (or of K steps), replayed. A fit keeps
a host-to-device transfer cache of the feeds (JAX ``:792-821``), and
reads the losses back once, at its end. On the CPU every stochastic op gets
a generator of its own per step, folded from the graph's key, the global
iteration index and the op's position, so a resumed fit draws what an
uninterrupted one would; on a CUDA device they draw from the fit's device
generator (:mod:`~..runtime.rng`), seeded from the graph's key at the
start of each fit.
``output``/``calculate_gradients`` run on the arrays as stored, with no cast,
as the JAX package's do.

The archive (``save``/``load``, JAX ``:979-1037``) is the JAX package's zip
of ``graph.json``, ``arrays.npz``, ``training_state.npz`` and optionally
``updaterState.npz``, so a graph and its weights and optimizer state cross
between the packages both ways.

Not ported, and raising by name: ``export_stablehlo`` (JAX's own lowering).
The rematerialized train step of the JAX package is not ported (the port's
environment has no ``remat_segments``).
``cond`` and ``while_loop`` are plain Python over tensors; a ``while_loop``
without ``max_iterations`` is forward-only, as in JAX.
"""

from __future__ import annotations

import dataclasses
import enum
import io
import json
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.ops_registry import RNG_OPS, get_op
from deeplearning4j_tpu_torch.ops.initializers import WeightInit, init_weights
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.rng import _key_int, _splitmix64, generator_for
from deeplearning4j_tpu_torch.train.updaters import Adam, Updater

# numpy dtypes as jnp.asarray reads them with jax's x64 off
_CANONICAL = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}
_TORCH_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32}


def as_tensor(value, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``value`` (a tensor, numpy array or Python number) as a tensor on
    ``device`` in the dtype ``jnp.asarray`` would give it (64-bit types
    become 32-bit), or in ``dtype``."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
    else:
        a = np.asarray(value)
        if a.dtype in _CANONICAL:
            a = a.astype(_CANONICAL[a.dtype])
        t = torch.from_numpy(np.array(a))  # a copy the tensor owns
    if t.dtype in _TORCH_CANONICAL:
        t = t.to(_TORCH_CANONICAL[t.dtype])
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().to("cpu")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class VariableType(str, enum.Enum):
    VARIABLE = "variable"  # trainable
    PLACEHOLDER = "placeholder"
    CONSTANT = "constant"
    ARRAY = "array"  # op output


@dataclasses.dataclass
class OpNode:
    op: str  # registry name
    inputs: List[str]  # input variable names
    outputs: List[str]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    out_index: Optional[int] = None  # for multi-output ops: which output


class SDVariable:
    def __init__(self, sd: "SameDiff", name: str, vtype: VariableType,
                 shape: Optional[Tuple] = None, dtype=None):
        self.sd = sd
        self.name = name
        self.vtype = vtype
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype

    # ---- operator sugar (reference SDVariable methods) ----
    def _bin(self, op, other, reverse=False):
        other = self.sd._lift(other)
        a, b = (other, self) if reverse else (self, other)
        return self.sd._apply(op, [a, b])

    def __add__(self, o):
        return self._bin("add", o)
    __radd__ = __add__

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("sub", o, reverse=True)

    def __mul__(self, o):
        return self._bin("mul", o)
    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin("div", o)

    def __rtruediv__(self, o):
        return self._bin("div", o, reverse=True)

    def __pow__(self, o):
        return self._bin("pow", o)

    def __matmul__(self, o):
        return self._bin("matmul", o)

    def __neg__(self):
        return self.sd._apply("neg", [self])

    def __gt__(self, o):
        return self._bin("gt", o)

    def __lt__(self, o):
        return self._bin("lt", o)

    def add(self, o, name=None):
        return self.sd._apply("add", [self, self.sd._lift(o)], name=name)

    def mmul(self, o, name=None):
        return self.sd._apply("matmul", [self, self.sd._lift(o)], name=name)

    def reshape(self, *shape, name=None):
        return self.sd._apply("reshape", [self], attrs={"shape": shape}, name=name)

    def transpose(self, *perm, name=None):
        return self.sd._apply("transpose", [self], attrs={"perm": perm or None}, name=name)

    def sum(self, axis=None, keepdims=False, name=None):
        return self.sd._apply("reduce_sum", [self],
                              attrs={"axis": axis, "keepdims": keepdims}, name=name)

    def mean(self, axis=None, keepdims=False, name=None):
        return self.sd._apply("reduce_mean", [self],
                              attrs={"axis": axis, "keepdims": keepdims}, name=name)

    def std(self, axis=None, keepdims=False, name=None):
        return self.sd._apply("reduce_std", [self],
                              attrs={"axis": axis, "keepdims": keepdims}, name=name)

    def eval(self, placeholders: Optional[Dict[str, Any]] = None):
        """Evaluate this variable (reference ``SDVariable.eval()``)."""
        return self.sd.output(placeholders or {}, self.name)

    def get_arr(self):
        return self.sd.arrays.get(self.name)

    def set_arr(self, value) -> None:
        self.sd.arrays[self.name] = as_tensor(value, self.sd.device)

    def rename(self, new_name: str) -> "SDVariable":
        self.sd._rename(self.name, new_name)
        return self

    def __repr__(self):
        return f"SDVariable(name={self.name!r}, type={self.vtype.value}, shape={self.shape})"


class _Namespace:
    """Op namespace (``sd.math``, ``sd.nn``, ``sd.cnn``, ``sd.loss``, ...).
    ``ops`` is the JAX package's name list, or None for ``math``: every
    registry name but the three pooling/convolution ops. A name the port
    has not ported raises by name when applied."""

    def __init__(self, sd: "SameDiff", ops: Optional[Sequence[str]], loss_style: bool = False):
        self._sd = sd
        self._ops = None if ops is None else set(ops)
        self._loss_style = loss_style

    def __getattr__(self, op):
        if op.startswith("_") or (op not in self._ops if self._ops is not None
                                  else op in _NOT_MATH):
            raise AttributeError(op)

        def call(*args, name=None, **attrs):
            if self._loss_style and args and isinstance(args[0], str) and name is None:
                name, args = args[0], args[1:]
            vars_ = [self._sd._lift(a) for a in args]
            n_out = _MULTI_OUTPUT_OPS.get(op, 1)
            if op == "svd" and attrs.get("compute_uv") is False:
                n_out = 1  # singular values only
            return self._sd._apply(op, vars_, attrs=attrs, name=name, n_outputs=n_out)

        return call


# The JAX package's namespace lists (``samediff.py:189-227``)
_NOT_MATH = ("conv2d", "max_pool2d", "avg_pool2d")
_NN_OPS = ["relu", "relu6", "leaky_relu", "elu", "selu", "gelu", "sigmoid", "tanh",
           "softmax", "log_softmax", "softplus", "softsign", "swish", "mish",
           "hard_sigmoid", "layer_norm", "batch_norm", "bias_add", "linear",
           "dropout", "multi_head_dot_product_attention", "pad", "one_hot"]
_CNN_OPS = ["conv2d", "max_pool2d", "avg_pool2d", "batch_norm",
            "conv1d", "conv3d", "depthwise_conv2d", "max_pool1d",
            "avg_pool1d", "max_pool3d", "avg_pool3d",
            "local_response_normalization", "im2col", "space_to_depth",
            "depth_to_space", "space_to_batch", "batch_to_space",
            "dilation2d"]
_RNN_OPS = ["lstm_layer", "gru", "lstm_cell", "gru_cell"]
# ops whose registry callable returns a tuple (namespace calls unpack them)
_MULTI_OUTPUT_OPS = {"lstm_layer": 3, "gru": 2, "lstm_cell": 2,
                     "svd": 3, "qr": 2, "eigh": 2, "eig": 2,
                     "top_k": 2, "unique": 2, "non_max_suppression": 2,
                     "meshgrid": 2, "moments": 2, "normalize_moments": 2,
                     "lu": 2}
_LOSS_OPS = ["softmax_cross_entropy", "sparse_softmax_cross_entropy",
             "sigmoid_cross_entropy", "mean_squared_error", "mean_absolute_error",
             "l2_loss", "log_loss", "cosine_distance", "hinge_loss", "huber_loss",
             "kl_divergence", "poisson_loss", "mean_pairwise_squared_error",
             "mean_squared_log_error", "mean_absolute_percentage_error",
             "ctc_loss"]
_LINALG_OPS = ["cholesky", "solve", "triangular_solve", "lstsq",
               "matrix_inverse", "matrix_determinant", "logdet", "svd", "qr",
               "eigh", "eig", "matrix_band_part", "cross", "diag", "diag_part",
               "trace", "matmul"]
_BITWISE_OPS = ["bitwise_and", "bitwise_or", "bitwise_xor", "bit_shift",
                "bit_shift_right", "bit_rotl", "bit_rotr"]
_RANDOM_OPS = ["random_uniform", "random_normal", "random_bernoulli",
               "random_exponential", "random_shuffle", "random_gamma",
               "random_poisson", "random_gumbel", "random_laplace",
               "truncated_normal", "random_categorical", "multinomial"]
_IMAGE_OPS = ["resize_bilinear", "resize_nearest", "crop_to_box",
              "flip_left_right", "flip_up_down", "adjust_brightness",
              "adjust_contrast", "adjust_saturation", "rgb_to_grayscale",
              "hsv_to_rgb", "rgb_to_hsv", "crop_and_resize",
              "non_max_suppression"]


@dataclasses.dataclass
class TrainingConfig:
    """Reference ``org.nd4j.autodiff.samediff.TrainingConfig``."""

    updater: Updater = dataclasses.field(default_factory=lambda: Adam(1e-3))
    data_set_feature_mapping: List[str] = dataclasses.field(default_factory=list)
    data_set_label_mapping: List[str] = dataclasses.field(default_factory=list)
    l1: float = 0.0
    l2: float = 0.0

    def to_dict(self):
        return {"updater": self.updater.to_dict(),
                "data_set_feature_mapping": self.data_set_feature_mapping,
                "data_set_label_mapping": self.data_set_label_mapping,
                "l1": self.l1, "l2": self.l2}

    @staticmethod
    def from_dict(d):
        return TrainingConfig(
            updater=Updater.from_dict(d["updater"]),
            data_set_feature_mapping=list(d.get("data_set_feature_mapping", [])),
            data_set_label_mapping=list(d.get("data_set_label_mapping", [])),
            l1=d.get("l1", 0.0), l2=d.get("l2", 0.0))


class History(list):
    """``sd.fit``'s result (reference ``History``): the per-iteration
    losses, with the reference's curve accessors."""

    def __init__(self, losses, epoch_bounds):
        super().__init__(losses)
        self._bounds = list(epoch_bounds)  # iteration count at each epoch end

    def loss_curve(self):
        return list(self)

    def epoch_losses(self):
        out, start = [], 0
        for end in self._bounds:
            if end > start:
                out.append(sum(self[start:end]) / (end - start))
            start = end
        return out

    def final_loss(self):
        return self[-1] if self else None


def _split_key(key: np.ndarray) -> Tuple[np.ndarray, int]:
    """The next two-word key and a 63-bit seed for one draw (the port's
    counterpart of ``jax.random.split``; the numbers are the port's own)."""
    k = _key_int(key)
    nxt = _splitmix64(k ^ 0x5851F42D4C957F2D)
    sub = _splitmix64(k ^ 0x14057B7EF767814F)
    return np.array([nxt >> 32, nxt & 0xFFFFFFFF], np.uint32), sub & ((1 << 63) - 1)


class SameDiff:
    def __init__(self, device=None):
        self.device = get_environment().resolve_device(device)
        self.vars: Dict[str, SDVariable] = {}
        self.ops: List[OpNode] = []
        self.arrays: Dict[str, torch.Tensor] = {}  # VARIABLE + CONSTANT values
        self.loss_variables: List[str] = []
        self.training_config: Optional[TrainingConfig] = None
        self._name_counter = 0
        self._updater: Optional[Updater] = None
        self._opt_state = None
        # the graph's two-word key, as jax.random.PRNGKey(0) lays it out
        self._rng_key = np.zeros(2, np.uint32)
        self._train_iter = 0  # global step count (rng stream position)
        self._listeners: List[Any] = []
        # the training runtime's cache: the packed state, the constants'
        # casts, the captured graphs (``__aot__``), the fit's generator
        self._runtime_cache: Dict[str, Any] = {}
        self.math = _Namespace(self, None)
        self.nn = _Namespace(self, _NN_OPS)
        self.cnn = _Namespace(self, _CNN_OPS)
        self.rnn = _Namespace(self, _RNN_OPS)
        self.loss = _Namespace(self, _LOSS_OPS, loss_style=True)
        self.linalg = _Namespace(self, _LINALG_OPS)
        self.bitwise = _Namespace(self, _BITWISE_OPS)
        self.random = _Namespace(self, _RANDOM_OPS)
        self.image = _Namespace(self, _IMAGE_OPS)

    @staticmethod
    def create(device=None) -> "SameDiff":
        """A new graph whose arrays live on ``device`` (``cuda`` unless the
        caller asks for the CPU)."""
        return SameDiff(device)

    # ------------------------------------------------------------- variables
    def _unique(self, base: str) -> str:
        if base not in self.vars:
            return base
        while True:
            self._name_counter += 1
            cand = f"{base}_{self._name_counter}"
            if cand not in self.vars:
                return cand

    def placeholder(self, name: str, shape=None, dtype=torch.float32) -> SDVariable:
        v = SDVariable(self, self._unique(name), VariableType.PLACEHOLDER, shape, dtype)
        self.vars[v.name] = v
        return v

    place_holder = placeholder  # reference alias

    def var(self, name: str, shape=None, weight_init: Union[str, WeightInit] = WeightInit.XAVIER,
            array=None, dtype=torch.float32) -> SDVariable:
        """Trainable variable, from ``array`` or drawn by ``weight_init``
        (the port's own numbers, from the graph's key)."""
        v = SDVariable(self, self._unique(name), VariableType.VARIABLE, shape, dtype)
        self.vars[v.name] = v
        if array is not None:
            self.arrays[v.name] = as_tensor(array, self.device, dtype)
        else:
            if shape is None:
                raise ValueError("var() needs shape or array")
            self._rng_key, seed = _split_key(self._rng_key)
            gen = torch.Generator(device="cpu").manual_seed(seed)
            self.arrays[v.name] = init_weights(gen, shape, WeightInit(weight_init),
                                               dtype=dtype).to(self.device)
        return v

    def constant(self, name_or_value, value=None) -> SDVariable:
        if value is None:
            name, value = None, name_or_value
        else:
            name = name_or_value
        t = as_tensor(value, self.device)
        v = SDVariable(self, self._unique(name or "const"), VariableType.CONSTANT,
                       tuple(t.shape), t.dtype)
        self.vars[v.name] = v
        self.arrays[v.name] = t
        return v

    def _lift(self, x) -> SDVariable:
        if isinstance(x, SDVariable):
            return x
        return self.constant(None, x)

    def convert_to_variable(self, *names) -> None:
        """Make CONSTANTs trainable (reference ``sd.convertToVariable``):
        the fine-tuning path of an imported graph, whose weights come in as
        constants."""
        for n in names:
            n = n.name if isinstance(n, SDVariable) else n
            v = self.vars[n]
            if v.vtype == VariableType.VARIABLE:
                continue
            if v.vtype != VariableType.CONSTANT:
                raise ValueError(f"{n!r} is {v.vtype.value}, not a constant")
            v.vtype = VariableType.VARIABLE

    def convert_to_constant(self, *names) -> None:
        """Freeze VARIABLEs (reference ``sd.convertToConstant``)."""
        for n in names:
            n = n.name if isinstance(n, SDVariable) else n
            v = self.vars[n]
            if v.vtype == VariableType.VARIABLE:
                v.vtype = VariableType.CONSTANT

    def trainable_float_constants(self, min_size: int = 2) -> List[str]:
        """Names of float CONSTANTs big enough to be weights (everything but
        scalar- and axis-style constants)."""
        return [n for n, a in self.arrays.items()
                if self.vars[n].vtype == VariableType.CONSTANT and a.is_floating_point()
                and a.numel() >= min_size]

    def _rename(self, old: str, new: str) -> None:
        if new in self.vars:
            raise ValueError(f"Variable {new!r} already exists")
        v = self.vars.pop(old)
        v.name = new
        self.vars[new] = v
        if old in self.arrays:
            self.arrays[new] = self.arrays.pop(old)
        for node in self.ops:
            node.inputs = [new if i == old else i for i in node.inputs]
            node.outputs = [new if o == old else o for o in node.outputs]
        self.loss_variables = [new if n == old else n for n in self.loss_variables]

    # ------------------------------------------------------------------- ops
    def _apply(self, op: str, inputs: List[SDVariable], attrs=None, name=None,
               n_outputs: int = 1) -> Union[SDVariable, Tuple[SDVariable, ...]]:
        get_op(op)  # raises by name on an op the port has not ported
        attrs = {k: v for k, v in (attrs or {}).items() if v is not None}
        outs = []
        for j in range(n_outputs):
            base = name if (name and n_outputs == 1) else f"{name or op}_{j}" if name else op
            out = SDVariable(self, self._unique(base), VariableType.ARRAY)
            self.vars[out.name] = out
            outs.append(out)
        self.ops.append(OpNode(op=op, inputs=[v.name for v in inputs],
                               outputs=[o.name for o in outs], attrs=attrs))
        return outs[0] if n_outputs == 1 else tuple(outs)

    def invoke(self, op: str, *args, name=None, n_outputs: int = 1, **attrs):
        """Apply any registry op by name (escape hatch / importer path)."""
        return self._apply(op, [self._lift(a) for a in args], attrs=attrs,
                           name=name, n_outputs=n_outputs)

    # ---- control flow: plain Python over tensors ----
    def _apply_callable(self, fn, inputs: List[SDVariable], name: str, n_outputs: int = 1):
        outs = []
        for j in range(n_outputs):
            base = name if n_outputs == 1 else f"{name}_{j}"
            out = SDVariable(self, self._unique(base), VariableType.ARRAY)
            self.vars[out.name] = out
            outs.append(out)
        self.ops.append(OpNode(op="__callable__", inputs=[v.name for v in inputs],
                               outputs=[o.name for o in outs], attrs={"fn": fn}))
        return outs[0] if n_outputs == 1 else tuple(outs)

    def cond(self, pred, true_fn, false_fn, *operands, name: str = "cond",
             n_outputs: int = 1):
        """Run ``true_fn`` or ``false_fn`` on the operand tensors by the
        value of ``pred`` (JAX ``lax.cond``; reference If/Switch-Merge).
        Each returns ``n_outputs`` tensors."""
        def fn(p, *xs, key=None):
            branch = true_fn if bool(p.reshape(())) else false_fn
            if getattr(branch, "_accepts_rng", False):
                return branch(*xs, key=key)
            return branch(*xs)

        if any(getattr(f, "_accepts_rng", False) for f in (true_fn, false_fn)):
            fn._accepts_rng = True
        return self._apply_callable(
            fn, [self._lift(pred)] + [self._lift(o) for o in operands], name,
            n_outputs=n_outputs)

    def while_loop(self, cond_fn, body_fn, *init, name: str = "while",
                   max_iterations: Optional[int] = None):
        """A loop over an N-tensor carry (JAX ``lax.while_loop``; reference
        While frames): ``cond_fn(*carry) -> bool``, ``body_fn(*carry) ->
        carry``. Without ``max_iterations`` it is forward-only, as
        ``lax.while_loop`` is: a carry that needs a gradient raises. With it,
        ``max_iterations`` steps whose updates are masked by the predicate
        (JAX's ``lax.scan`` form), which is differentiable."""
        n = len(init)

        def fn(*xs, key=None):
            bf = ((lambda *a: body_fn(*a, key=key))
                  if getattr(body_fn, "_accepts_rng", False) else body_fn)
            cf = ((lambda *a: cond_fn(*a, key=key))
                  if getattr(cond_fn, "_accepts_rng", False) else cond_fn)
            c = tuple(xs)
            if max_iterations is None:
                if torch.is_grad_enabled() and any(t.requires_grad for t in c):
                    raise ValueError("Reverse-mode differentiation does not work for a "
                                     "while_loop without max_iterations (as for "
                                     "lax.while_loop); pass max_iterations")
                while bool(torch.as_tensor(cf(*c)).reshape(())):
                    c = tuple(bf(*c))
            else:
                for _ in range(int(max_iterations)):
                    pred = torch.as_tensor(cf(*c)).reshape(()).bool()
                    new = tuple(bf(*c))
                    c = tuple(torch.where(pred, b, a) for a, b in zip(c, new))
            return c if n > 1 else c[0]

        if any(getattr(f, "_accepts_rng", False) for f in (cond_fn, body_fn)):
            fn._accepts_rng = True
        return self._apply_callable(fn, [self._lift(i) for i in init], name, n_outputs=n)

    # --------------------------------------------------------------- execute
    def _needed_ops(self, outputs: Sequence[str]) -> List[OpNode]:
        """Ancestor subgraph of ``outputs``, in graph order (so executing
        'probs' never touches the loss op and its label placeholder)."""
        producer = {}
        for node in self.ops:
            for o in node.outputs:
                producer[o] = node
        needed: List[OpNode] = []
        seen = set()
        stack = list(outputs)
        marked = set()
        while stack:
            name = stack.pop()
            if name in marked:
                continue
            marked.add(name)
            node = producer.get(name)
            if node is not None and id(node) not in seen:
                seen.add(id(node))
                needed.append(node)
                stack.extend(node.inputs)
        order = {id(n): i for i, n in enumerate(self.ops)}
        needed.sort(key=lambda n: order[id(n)])
        return needed

    def _exec_graph(self, env: Dict[str, Any], outputs: Sequence[str]):
        """Run the ops ``outputs`` need, in graph order, on the tensors of
        ``env``. ``env["__rng__"]`` (reserved, never a variable name), given
        in ``fit``, is the step's 63-bit seed: each stochastic op then gets a
        generator folded from it and its position in ``self.ops`` (or, a
        CUDA generator, the fit's device stream that every stochastic op
        draws from). Without it (``output``, ``eval``) dropout is the
        identity."""
        rng = env.get("__rng__")
        pos = None
        device_gen = rng if isinstance(rng, torch.Generator) else None
        for node in self._needed_ops(outputs):
            if all(o in env for o in node.outputs):
                continue
            fn = node.attrs["fn"] if node.op == "__callable__" else get_op(node.op)
            args = [env[i] for i in node.inputs]
            attrs = {} if node.op == "__callable__" else node.attrs
            if rng is not None and (
                    node.op in RNG_OPS
                    or (node.op == "__callable__" and getattr(fn, "_accepts_rng", False))):
                attrs = dict(attrs)
                if device_gen is not None:
                    attrs["key"] = device_gen
                else:
                    if pos is None:
                        pos = {id(n): i for i, n in enumerate(self.ops)}
                    attrs["key"] = generator_for(rng, pos[id(node)])
            res = fn(*args, **attrs)
            if len(node.outputs) == 1:
                env[node.outputs[0]] = res
            else:
                for o, r in zip(node.outputs, res):
                    env[o] = r
        return [env[o] for o in outputs]

    def _feeds(self, placeholders: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: as_tensor(v, self.device) for k, v in placeholders.items()}

    def output(self, placeholders: Dict[str, Any], *outputs):
        """Execute and return the requested outputs (reference
        ``sd.output(Map, String...)``), without a gradient: one name gives
        one tensor, several a list; a LIST of names (reference
        ``output(Map, List<String>)``) gives a name -> numpy array dict."""
        as_map = len(outputs) == 1 and isinstance(outputs[0], (list, tuple))
        names = tuple(outputs[0]) if as_map else tuple(outputs)
        names = tuple(n.name if isinstance(n, SDVariable) else n for n in names)
        with torch.no_grad():
            env = dict(self.arrays)
            env.update(self._feeds(placeholders))
            res = self._exec_graph(env, names)
        if as_map:
            return {n: _numpy(r) for n, r in zip(names, res)}
        return res[0] if len(names) == 1 else res

    def batch_output(self, placeholders, outputs):
        return self.output(placeholders, *outputs)

    # -------------------------------------------------------------- training
    def set_loss_variables(self, *names) -> None:
        self.loss_variables = [n.name if isinstance(n, SDVariable) else n for n in names]

    def set_training_config(self, cfg: TrainingConfig) -> None:
        self.training_config = cfg
        # a new config means a new updater: its state is built at the next fit
        self._updater = None
        self._opt_state = None

    def set_listeners(self, *listeners) -> None:
        """Training listeners (reference ``sd.setListeners``): objects with
        ``iteration_done(sd, iteration, epoch, loss)``, called per batch
        with the loss as a 0-d tensor on the device (reading it waits for
        the step)."""
        self._listeners = list(listeners)

    def _trainable(self) -> Dict[str, torch.Tensor]:
        return {n: a for n, a in self.arrays.items()
                if self.vars[n].vtype == VariableType.VARIABLE}

    def _ensure_updater(self, trainable) -> Updater:
        if self._updater is None or self._opt_state is None:
            self._updater = self.training_config.updater
            self._opt_state = self._updater.init_state(trainable)
        return self._updater

    def _train_step(self, trainable: Dict[str, torch.Tensor], consts: Dict[str, torch.Tensor],
                    ph: Dict[str, torch.Tensor], rng) -> torch.Tensor:
        """One step (JAX ``_make_train_step``'s ``step``): the loss in
        ``compute_dtype`` over float32 masters, its gradients, and the
        updater's step on the masters in place. ``rng`` is the global step
        index (the stochastic ops' seeds fold it in) or the fit's CUDA
        generator. Returns the detached loss."""
        cfg = self.training_config
        cdt = get_environment().compute_dtype

        def _c(a):
            return a.to(cdt) if a.is_floating_point() and a.dtype != cdt else a

        names = sorted(trainable)  # the optimizer state's leaf order
        masters = [trainable[n] for n in names]
        leaves = [t.detach().requires_grad_(True) for t in masters]
        with torch.enable_grad():
            env = dict(consts)
            env.update({n: _c(t) for n, t in zip(names, leaves)})
            env.update({n: _c(a) for n, a in ph.items()})
            env["__rng__"] = rng if isinstance(rng, torch.Generator) else (
                _splitmix64(_key_int(self._rng_key) ^ _splitmix64(rng + 1)) & ((1 << 63) - 1))
            losses = self._exec_graph(env, self.loss_variables)
            total = sum(l.float().sum() for l in losses)
            # the penalties sum in sorted name order, as the jitted step sees
            # its (flattened and rebuilt) dict
            if cfg.l2:
                total = total + 0.5 * cfg.l2 * sum((w * w).sum() for w in leaves)
            if cfg.l1:
                total = total + cfg.l1 * sum(w.abs().sum() for w in leaves)
            grads = torch.autograd.grad(total, leaves, allow_unused=True) if leaves else []
        grads = [torch.zeros_like(t) if g is None else g.to(t.dtype)
                 for t, g in zip(masters, grads)]
        if masters:
            with torch.no_grad():
                updates = self._updater.update(grads, self._opt_state, masters)
                torch._foreach_add_(masters, updates)
        return total.detach()

    def _fit_consts(self) -> Dict[str, torch.Tensor]:
        """The constants cast to ``compute_dtype``, kept between fits while
        the constants and the dtype stay (a captured step reads them where
        the first fit put them)."""
        cdt = get_environment().compute_dtype
        raw = {n: a for n, a in self.arrays.items()
               if self.vars[n].vtype == VariableType.CONSTANT}
        from deeplearning4j_tpu_torch.runtime.state_packing import state_signature
        sig = (cdt, tuple(sorted(raw)), state_signature([raw[n] for n in sorted(raw)]))
        cached = self._runtime_cache.get("__consts__")
        if cached is None or cached[0] != sig:
            cached = (sig, {n: (a.to(cdt) if a.is_floating_point() and a.dtype != cdt else a)
                            for n, a in raw.items()})
            self._runtime_cache["__consts__"] = cached
        return cached[1]

    def _transfer_cache(self):
        """Host-to-device transfer cache for one fit (JAX ``:792-821``):
        iterators often hand back the SAME numpy arrays every epoch. A weak
        reference guards against ``id`` reuse, a content hash against an
        array refilled in place, and a size cap bounds the device memory it
        holds. ``staged`` (the prefetcher's path) copies a new array from
        pinned memory without waiting."""
        import hashlib
        import weakref
        h2d: Dict[int, Any] = {}

        def dev(a, staged=False):
            if isinstance(a, torch.Tensor):
                return as_tensor(a, self.device)
            arr = np.asarray(a)
            fp = hashlib.blake2b(np.ascontiguousarray(arr).tobytes(), digest_size=16).digest()
            ent = h2d.get(id(a))
            if ent is not None and ent[0]() is a and ent[2] == fp:
                return ent[1]
            if staged and self.device.type == "cuda":
                buf = as_tensor(arr, "cpu").pin_memory().to(self.device, non_blocking=True)
            else:
                buf = as_tensor(arr, self.device)
            if len(h2d) > 64:
                h2d.clear()
            try:
                h2d[id(a)] = (weakref.ref(a), buf, fp)
            except TypeError:
                pass
            return buf

        return dev

    def fit(self, data, labels=None, epochs: int = 1, batch_size: Optional[int] = None,
            prefetch_buffer: int = 0, profiler=None):
        """Train (reference ``sd.fit(DataSetIterator)``) on an iterator of
        DataSets or MultiDataSets, one MultiDataSet, or ``(features,
        labels)`` arrays. Features feed
        ``training_config.data_set_feature_mapping`` and labels
        ``data_set_label_mapping``, in order. Returns the :class:`History`
        of per-step losses. ``prefetch_buffer`` and ``profiler`` as in
        ``MultiLayerNetwork.fit`` (the JAX package's ``SameDiff.fit`` has
        neither; the listeners are called where the step ran, so the
        profiler's step stage is not measured)."""
        if self.training_config is None:
            raise ValueError("Call set_training_config first")
        if not self.loss_variables:
            raise ValueError("Call set_loss_variables first")
        cfg = self.training_config
        from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
        from deeplearning4j_tpu_torch.data.iterators import (ExistingDataSetIterator,
                                                             ListDataSetIterator)
        from deeplearning4j_tpu_torch.runtime.compile_cache import AotCache
        from deeplearning4j_tpu_torch.runtime.state_packing import (
            GroupedDispatch, LeafPacker, make_unrolled_packed_step, step_args_signature)
        from deeplearning4j_tpu_torch.train.prefetch import batch_source, stateless_listeners
        from deeplearning4j_tpu_torch.train.profiler import submit_timed
        if isinstance(data, MultiDataSet):
            iterator = ExistingDataSetIterator([data])
        elif labels is not None:
            iterator = ListDataSetIterator([DataSet(np.asarray(data), np.asarray(labels))],
                                           batch_size=batch_size or len(data))
        else:
            iterator = data
        trainable = self._trainable()
        self._ensure_updater(trainable)
        consts = self._fit_consts()
        env = get_environment()
        # packing keeps the masters as views of its buffers; only with
        # listeners that read no state (as MultiLayerNetwork.fit)
        use_packing = env.packed_state and stateless_listeners(self)
        unroll = max(1, int(env.dispatch_unroll)) if use_packing else 1
        packer, sig = None, None
        if use_packing:
            tree = (trainable, self._opt_state)
            prev = self._runtime_cache.get("__packed__")
            if prev is not None and prev[0].is_packed(tree, prev[1]):
                packer, packed = prev
            else:
                packer = LeafPacker(tree)
                packed = packer.pack(tree)
                trainable, self._opt_state = packer.unpack(packed)
                self.arrays.update(trainable)
                self._runtime_cache["__packed__"] = (packer, packed)
            # what a captured step closes over: the state's addresses, the
            # constants' casts, the op list, the losses and the updater
            sig = (LeafPacker.signature(packed), id(consts), tuple(map(id, self.ops)),
                   tuple(self.loss_variables), id(self._updater), cfg.l1, cfg.l2,
                   str(env.compute_dtype))
        cuda = self.device.type == "cuda"
        if cuda:
            gen = self._runtime_cache.get("__gen__")
            if gen is None:
                gen = self._runtime_cache["__gen__"] = torch.Generator(device=self.device)
            gen.manual_seed(_splitmix64(_key_int(self._rng_key) ^ _splitmix64(
                self._train_iter + 0x9E37)) & ((1 << 63) - 1))
        aot = self._runtime_cache.setdefault("__aot__", AotCache("sd-fit"))
        aot.generators = [gen] if cuda else []
        if use_packing:
            aot.evict(lambda k: k[1] != sig)

        def step(ph, rng):
            return self._train_step(trainable, consts, ph, rng)

        group_step = make_unrolled_packed_step(step, packer, unroll) if unroll > 1 else None
        history: List[torch.Tensor] = []
        bounds: List[int] = []
        it_count = 0
        cur_ep = 0
        dev = self._transfer_cache()

        def run_single(a):
            return aot.call(("single", sig, step_args_signature(a)), step, *a)

        def run_group(todo):
            losses = aot.call(("group", sig, unroll, step_args_signature(todo[0])),
                              group_step, [tuple(t) for t in todo])
            return [losses[i] for i in range(len(todo))]

        def deliver(args, loss):
            nonlocal it_count
            # the losses stay on the device until the fit reads them all
            history.append(loss)
            it_count += 1
            for lst in self._listeners:
                lst.iteration_done(self, it_count, cur_ep, loss)

        def feeds(batch, staged=False):
            feats = batch.features if isinstance(batch.features, list) else [batch.features]
            labs = batch.labels if isinstance(batch.labels, list) else [batch.labels]
            ph = {n: dev(a, staged) for n, a in zip(cfg.data_set_feature_mapping, feats)}
            ph.update({n: dev(a, staged) for n, a in zip(cfg.data_set_label_mapping, labs)})
            return ph

        gd = GroupedDispatch(
            unroll=unroll,
            compatible=lambda a, b: ({n: v.shape for n, v in a[0].items()}
                                     == {n: v.shape for n, v in b[0].items()}),
            run_single=(run_single if packer is not None
                        else lambda a: self._train_step(trainable, consts, *a)),
            run_group=run_group, deliver=deliver)
        if profiler is not None:
            profiler.start()
        try:
            for ep in range(int(epochs)):
                cur_ep = ep
                src = batch_source(iterator, feeds, prefetch_buffer, profiler,
                                   device=self.device,
                                   staged_prepare=lambda b: feeds(b, staged=True))
                try:
                    for ph in src:
                        submit_timed(gd, (ph, gen if cuda else self._train_iter), profiler)
                        self._train_iter += 1
                finally:
                    src.close()
                gd.flush()
                bounds.append(it_count)
        finally:
            gd.drain_on_error()  # deliver batches buffered before an error
            if profiler is not None:
                profiler.stop()
        losses = torch.stack(history).cpu().tolist() if history else []
        return History([float(v) for v in losses], bounds)

    def evaluate(self, iterator, output_name: str, evaluation=None, label_index: int = 0):
        """Evaluate a graph output against the iterator's labels (reference
        ``sd.evaluate(iterator, outputName, evaluation)``): features feed
        ``data_set_feature_mapping``; the labels go to the evaluation."""
        if evaluation is None:
            from deeplearning4j_tpu_torch.evaluation import Evaluation
            evaluation = Evaluation()
        cfg = self.training_config
        if cfg is None or not cfg.data_set_feature_mapping:
            raise ValueError("evaluate() needs a TrainingConfig with data_set_feature_mapping")
        iterator.reset()
        for batch in iterator:
            feats = batch.features if isinstance(batch.features, list) else [batch.features]
            labs = batch.labels if isinstance(batch.labels, list) else [batch.labels]
            pred = self.output(dict(zip(cfg.data_set_feature_mapping, feats)), output_name)
            evaluation.eval(np.asarray(labs[label_index]), _numpy(pred))
        return evaluation

    def calculate_gradients(self, placeholders: Dict[str, Any],
                            *wrt: str) -> Dict[str, torch.Tensor]:
        """Gradients of the summed loss variables with respect to the named
        variables, all trainable ones by default (reference
        ``sd.calculateGradients``), on the arrays as stored."""
        if not self.loss_variables:
            raise ValueError("Call set_loss_variables first")
        wrt = tuple(wrt) or tuple(self._trainable().keys())
        sub = {n: self.arrays[n].detach().requires_grad_(True) for n in wrt}
        with torch.enable_grad():
            env = {n: a for n, a in self.arrays.items()
                   if self.vars[n].vtype != VariableType.ARRAY}
            env.update(sub)
            env.update(self._feeds(placeholders))
            total = sum(l.sum() for l in self._exec_graph(env, self.loss_variables))
            grads = torch.autograd.grad(total, list(sub.values()), allow_unused=True)
        return {n: torch.zeros_like(sub[n]) if g is None else g for n, g in zip(sub, grads)}

    # ----------------------------------------------------------------- serde
    def to_dict(self) -> dict:
        if any(n.op == "__callable__" for n in self.ops):
            raise ValueError("Graphs containing python control-flow callables (cond/"
                             "while_loop) are not serializable")
        return {
            "vars": [{"name": v.name, "type": v.vtype.value,
                      "shape": list(v.shape) if v.shape else None}
                     for v in self.vars.values()],
            "ops": [{"op": n.op, "inputs": n.inputs, "outputs": n.outputs,
                     "attrs": _json_attrs(n.attrs)} for n in self.ops],
            "loss_variables": self.loss_variables,
            "training_config": (self.training_config.to_dict()
                                if self.training_config else None),
        }

    def save(self, path: str, save_updater_state: bool = False) -> None:
        """The JAX package's zip (reference ``sd.save(file,
        saveUpdaterState)``): ``graph.json``, ``arrays.npz``,
        ``training_state.npz`` (the rng stream position: ``train_iter`` and
        the key) and, with ``save_updater_state``, ``updaterState.npz`` (the
        optimizer state's leaves in optax's order), for an exact resume."""
        from deeplearning4j_tpu_torch.models.serializer import _save_leaves
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("graph.json", json.dumps(self.to_dict(), indent=2))
            buf = io.BytesIO()
            np.savez(buf, **{k: _numpy(v) for k, v in self.arrays.items()})
            zf.writestr("arrays.npz", buf.getvalue())
            buf = io.BytesIO()
            np.savez(buf, train_iter=np.asarray(self._train_iter, np.int64),
                     rng_key=np.asarray(self._rng_key, np.uint32))
            zf.writestr("training_state.npz", buf.getvalue())
            if save_updater_state and self._opt_state is not None:
                zf.writestr("updaterState.npz", _save_leaves(self._opt_state))

    @staticmethod
    def load(path: str, device=None) -> "SameDiff":
        """A graph from an archive either package wrote, its arrays on
        ``device`` (``cuda`` unless the caller asks for the CPU)."""
        from deeplearning4j_tpu_torch.models.serializer import _read_leaves, load_leaves_like
        sd = SameDiff(device)
        with zipfile.ZipFile(path) as zf:
            d = json.loads(zf.read("graph.json").decode())
            z = np.load(io.BytesIO(zf.read("arrays.npz")))
            for vd in d["vars"]:
                v = SDVariable(sd, vd["name"], VariableType(vd["type"]),
                               tuple(vd["shape"]) if vd["shape"] else None)
                sd.vars[v.name] = v
            for od in d["ops"]:
                sd.ops.append(OpNode(op=od["op"], inputs=od["inputs"],
                                     outputs=od["outputs"], attrs=od.get("attrs", {})))
            for k in z.files:
                sd.arrays[k] = as_tensor(z[k], sd.device)
            sd.loss_variables = d.get("loss_variables", [])
            if d.get("training_config"):
                sd.training_config = TrainingConfig.from_dict(d["training_config"])
            if "training_state.npz" in zf.namelist():
                ts = np.load(io.BytesIO(zf.read("training_state.npz")))
                sd._train_iter = int(ts["train_iter"])
                sd._rng_key = np.asarray(ts["rng_key"], np.uint32)
            if "updaterState.npz" in zf.namelist() and sd.training_config is not None:
                sd._updater = sd.training_config.updater
                template = sd._updater.init_state(sd._trainable())
                sd._opt_state = load_leaves_like(_read_leaves(zf.read("updaterState.npz")),
                                                 template)
        return sd

    def export_stablehlo(self, placeholders: Dict[str, Any], *outputs: str) -> str:
        raise NotImplementedError("SameDiff.export_stablehlo lowers the graph through JAX "
                                  "and is not ported to deeplearning4j_tpu_torch")

    def summary(self) -> str:
        """Variables and ops, one per line (reference ``sd.summary()``)."""
        lines = [f"SameDiff: {len(self.vars)} variables, {len(self.ops)} ops"]
        for v in self.vars.values():
            if v.vtype != VariableType.ARRAY:
                lines.append(f"  {v.vtype.value:12s} {v.name:24s} {v.shape}")
        for n in self.ops:
            lines.append(f"  op {n.op:24s} {n.inputs} -> {n.outputs}")
        return "\n".join(lines)


def _json_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().tolist()
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        elif isinstance(v, tuple):
            v = list(v)
        out[k] = v
    return out


__all__ = ["History", "OpNode", "SDVariable", "SameDiff", "TrainingConfig", "VariableType"]
