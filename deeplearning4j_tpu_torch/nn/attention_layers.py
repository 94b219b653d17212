"""Attention and transformer layers.

Counterpart of ``deeplearning4j_tpu/nn/attention_layers.py``: multi-head
self-attention whose inner product routes through the flash-attention
kernel (``ops/kernels/flash_attention.py``), the post-LN transformer encoder
block and its layer-stacked form, and BERT's embedding and [CLS] pooling.
Parameter names and nesting are the JAX package's (``"attn"/{W_q, b_q,
...}``, ``ln1_gamma``, ``W_ff1``; ``"stack"/...`` with a leading layer
axis), so archives cross between the packages both ways. In training the
attention runs under autograd through the flash kernels' Function (the
saving forward, then the backward kernels), the features mask still a
key-padding bias, and the dropout masks are drawn on the activations'
device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.base import GlobalConfig, Layer, keep_mask, register_layer
from deeplearning4j_tpu_torch.nn.core_layers import _param_dtype
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.ops.activations import get_activation, single_pass_norm_stats
from deeplearning4j_tpu_torch.ops.initializers import init_weights
from deeplearning4j_tpu_torch.ops.kernels.flash_attention import (flash_attention,
                                                                  flash_attention_compatible)
from deeplearning4j_tpu_torch.nn.tensor_shards import TensorShards, rank_sum, to_device


def layer_norm(x, gamma, beta, eps=1e-12):
    """LayerNorm over the last axis with shifted single-pass fp32 stats; the
    normalised value is rounded to ``x``'s dtype BEFORE ``* gamma + beta``,
    as in the JAX package."""
    mean, var = single_pass_norm_stats(x, -1)
    y = (x.float() - mean) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * gamma + beta


def dot_product_attention(q, k, v, mask=None, use_flash: bool = True, causal: bool = False):
    """``(batch, heads, time, d)`` attention. Every call the kernel takes
    (:func:`flash_attention_compatible`) goes to :func:`flash_attention`;
    the rest, and ``use_flash=False``, take the JAX package's einsum form
    (``:61-75``): scores divided by ``sqrt(d)`` in q's dtype, masked entries
    replaced by -1e9, a bottom-right causal triangle when ``t_q != t_k``."""
    if use_flash and flash_attention_compatible(q, k, v, mask, causal=causal):
        return flash_attention(q, k, v, mask, causal=causal)
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / torch.sqrt(
        torch.full((), d, dtype=q.dtype, device=q.device))
    # torch.full, not torch.tensor: no host-to-device copy (a CUDA graph
    # capture of the step allows none)
    neg = torch.full((), -1e9, dtype=scores.dtype, device=scores.device)
    if mask is not None:
        if mask.dim() == 2:  # (batch, t_k) key-padding form
            mask = mask[:, None, None, :]
        scores = torch.where(mask.bool(), scores, neg)
    if causal:
        t_q, t_k = q.shape[2], k.shape[2]
        # bottom-right aligned: with t_q < t_k (decoding against a cache) the
        # last query row attends every key
        tri = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril(t_k - t_q)
        scores = torch.where(tri[None, None], scores, neg)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def _dropout(x, rate: float, training: bool, generator):
    """Inverted dropout with drop probability ``rate`` (transformer
    convention), in training only; the mask is drawn on ``x``'s device
    (:func:`keep_mask`)."""
    if not training or generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(keep_mask(x, keep, generator), x / keep, torch.zeros_like(x)).to(x.dtype)


@register_layer
@dataclasses.dataclass
class SelfAttentionLayer(Layer):
    """Multi-head self-attention over (batch, time, size) (reference
    ``SelfAttentionLayer`` / ``multiHeadDotProductAttention``)."""

    n_heads: int = 8
    head_size: Optional[int] = None  # default size / n_heads
    n_out: Optional[int] = None  # projection output, default = input size
    with_projection: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out or input_type.size, input_type.timesteps)

    def init(self, generator, input_type, g: GlobalConfig):
        d_model = input_type.size
        inner = self.n_heads * (self.head_size or d_model // self.n_heads)
        out = self.n_out or d_model
        dt = _param_dtype(g)
        params = {}
        for name in ("W_q", "W_k", "W_v"):
            params[name] = init_weights(generator, (d_model, inner), self._winit(g),
                                        fan=(d_model, inner), dtype=dt)
        for name in ("b_q", "b_k", "b_v"):
            params[name] = torch.zeros((inner,), dtype=dt)
        if self.with_projection:
            params["W_o"] = init_weights(generator, (inner, out), self._winit(g),
                                         fan=(inner, out), dtype=dt)
            params["b_o"] = torch.zeros((out,), dtype=dt)
        return params, {}

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        if isinstance(params["W_q"], TensorShards):
            return self._forward_sharded(params, x, mask), state
        b, t, _ = x.shape
        h = self.n_heads
        # (b, t, h*d) -> (b, h, t, d) views: the kernel reads them through
        # their strides
        q = (x @ params["W_q"] + params["b_q"]).reshape(b, t, h, -1).transpose(1, 2)
        k = (x @ params["W_k"] + params["b_k"]).reshape(b, t, h, -1).transpose(1, 2)
        v = (x @ params["W_v"] + params["b_v"]).reshape(b, t, h, -1).transpose(1, 2)
        attn_mask = None if mask is None else mask[:, None, None, :].bool()  # key padding
        y = dot_product_attention(q, k, v, attn_mask)
        y = y.transpose(1, 2).reshape(b, t, -1)
        if self.with_projection:
            y = y @ params["W_o"] + params["b_o"]
        return y, state

    def _forward_sharded(self, params, x, mask):
        """Tensor-parallel attention: ``W_q``/``W_k``/``W_v`` (and their
        biases) split by columns, ``W_o`` by rows, in ``k`` pieces; piece
        ``j``'s device runs heads ``j * h/k .. (j+1) * h/k`` and its rows of
        the output projection, and the partial outputs are summed on ``x``'s
        device in piece order before ``b_o``."""
        b, t, _ = x.shape
        shards = params["W_q"]
        k = len(shards)
        if self.n_heads % k:
            raise ValueError(f"SelfAttentionLayer: {self.n_heads} heads do not split over a "
                             f"tensor-parallel group of {k}")
        h = self.n_heads // k
        parts = []
        for j, dev in enumerate(shards.devices):
            xj = to_device(x, dev)
            mj = None if mask is None else to_device(mask, dev)[:, None, None, :].bool()
            q, kk, v = ((xj @ params[f"W_{n}"].piece(j, x.dtype)
                         + params[f"b_{n}"].piece(j, x.dtype)).reshape(b, t, h, -1).transpose(1, 2)
                        for n in "qkv")
            y = dot_product_attention(q, kk, v, mj).transpose(1, 2).reshape(b, t, -1)
            parts.append(y @ params["W_o"].piece(j, x.dtype) if self.with_projection else y)
        if not self.with_projection:
            return torch.cat([p.to(x.device) for p in parts], dim=-1)
        return rank_sum(parts, x.device) + params["b_o"]


@register_layer
@dataclasses.dataclass
class TransformerEncoderBlock(Layer):
    """Post-LN transformer encoder block (BERT-style): MHA + residual + LN,
    FFN(gelu) + residual + LN."""

    n_heads: int = 12
    ffn_size: int = 3072
    dropout_rate: float = 0.1  # drop probability (transformer convention)
    layer_norm_eps: float = 1e-12

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def _attn(self) -> SelfAttentionLayer:
        attn = SelfAttentionLayer(n_heads=self.n_heads)
        attn._g = self._g
        return attn

    def init(self, generator, input_type, g: GlobalConfig):
        d = input_type.size
        attn_params, _ = self._attn().init(generator, input_type, g)
        dt = _param_dtype(g)
        params = {
            "attn": attn_params,
            "ln1_gamma": torch.ones((d,), dtype=dt), "ln1_beta": torch.zeros((d,), dtype=dt),
            "ln2_gamma": torch.ones((d,), dtype=dt), "ln2_beta": torch.zeros((d,), dtype=dt),
            "W_ff1": init_weights(generator, (d, self.ffn_size), self._winit(g),
                                  fan=(d, self.ffn_size), dtype=dt),
            "b_ff1": torch.zeros((self.ffn_size,), dtype=dt),
            "W_ff2": init_weights(generator, (self.ffn_size, d), self._winit(g),
                                  fan=(self.ffn_size, d), dtype=dt),
            "b_ff2": torch.zeros((d,), dtype=dt),
        }
        return params, {}

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        a, _ = self._attn().forward(params["attn"], {}, x, mask=mask)
        x = layer_norm(x + _dropout(a, self.dropout_rate, training, generator),
                       params["ln1_gamma"], params["ln1_beta"], self.layer_norm_eps)
        if isinstance(params["W_ff1"], TensorShards):
            h = self._ffn_sharded(params, x)
        else:
            h = get_activation("gelu")(x @ params["W_ff1"] + params["b_ff1"])
            h = h @ params["W_ff2"] + params["b_ff2"]
        x = layer_norm(x + _dropout(h, self.dropout_rate, training, generator),
                       params["ln2_gamma"], params["ln2_beta"], self.layer_norm_eps)
        return x, state

    def _ffn_sharded(self, params, x):
        """Tensor-parallel FFN: ``W_ff1``/``b_ff1`` split by columns,
        ``W_ff2`` by rows; the partial products summed in piece order on
        ``x``'s device before ``b_ff2``."""
        shards = params["W_ff1"]
        parts = []
        for j, dev in enumerate(shards.devices):
            hj = get_activation("gelu")(to_device(x, dev) @ shards.piece(j, x.dtype)
                                        + params["b_ff1"].piece(j, x.dtype))
            parts.append(hj @ params["W_ff2"].piece(j, x.dtype))
        return rank_sum(parts, x.device) + params["b_ff2"]

    def regularizable_params(self):
        return ("W_ff1", "W_ff2")


@register_layer
@dataclasses.dataclass
class TransformerEncoderStack(Layer):
    """``n_layers`` identical post-LN encoder blocks over layer-stacked
    parameters (``{"stack": {...}}``, each leaf with a leading layer axis).
    The JAX package runs them as one ``lax.scan``; here a Python loop over
    the layer axis runs the same math as a stack of
    :class:`TransformerEncoderBlock` s."""

    n_layers: int = 12
    n_heads: int = 12
    ffn_size: int = 3072
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-12

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def _block(self) -> TransformerEncoderBlock:
        blk = TransformerEncoderBlock(n_heads=self.n_heads, ffn_size=self.ffn_size,
                                      dropout_rate=self.dropout_rate,
                                      layer_norm_eps=self.layer_norm_eps)
        blk._g = self._g
        return blk

    def init(self, generator, input_type, g: GlobalConfig):
        blk = self._block()
        per_layer = [blk.init(generator, input_type, g)[0] for _ in range(self.n_layers)]

        def stack(trees):
            if isinstance(trees[0], dict):
                return {k: stack([t[k] for t in trees]) for k in trees[0]}
            return torch.stack(trees)

        return {"stack": stack(per_layer)}, {}

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        blk = self._block()

        def layer(tree, i):
            if isinstance(tree, dict):
                return {k: layer(v, i) for k, v in tree.items()}
            return tree[i]

        for i in range(self.n_layers):
            x, _ = blk.forward(layer(params["stack"], i), {}, x, training=training,
                               generator=generator, mask=mask)
        return x, state

    def regularizable_params(self):
        return ("W_ff1", "W_ff2")


def _check_len(t: int, max_len: int, layer: str) -> None:
    if t > max_len:
        raise ValueError(f"{layer}: sequence of {t} steps is longer than max_len={max_len}, "
                         "the size of its position table")


@register_layer
@dataclasses.dataclass
class BertEmbeddingLayer(Layer):
    """BERT input embeddings: token + learned position + segment-0
    embeddings, LayerNorm, dropout. Input: (batch, time) integer token ids,
    gathered as they are (no float cast)."""

    vocab_size: int = 30522
    d_model: int = 768
    max_len: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-12

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps if input_type is not None else None
        return InputType.recurrent(self.d_model, t)

    def init(self, generator, input_type, g: GlobalConfig):
        dt = _param_dtype(g)

        def table(rows):
            return init_weights(generator, (rows, self.d_model), self._winit(g),
                                fan=(rows, self.d_model), dtype=dt)

        return {"tok": table(self.vocab_size), "pos": table(self.max_len),
                "seg": table(self.type_vocab_size),
                "ln_gamma": torch.ones((self.d_model,), dtype=dt),
                "ln_beta": torch.zeros((self.d_model,), dtype=dt)}, {}

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        ids = x if not x.is_floating_point() else x.long()
        t = ids.shape[1]
        _check_len(t, self.max_len, "BertEmbeddingLayer")
        # the range check reads the ids back, which a CUDA graph capture
        # cannot do: a captured step checks nothing (an id out of range then
        # trips the gather's device assert)
        if not (ids.is_cuda and torch.cuda.is_current_stream_capturing()) and bool(
                ((ids < 0) | (ids >= self.vocab_size)).any()):
            raise ValueError(f"BertEmbeddingLayer: token ids must lie in [0, "
                             f"{self.vocab_size}), got {int(ids.min())}..{int(ids.max())}")
        y = params["tok"][ids] + params["pos"][None, :t, :] + params["seg"][0][None, None, :]
        y = layer_norm(y, params["ln_gamma"], params["ln_beta"], self.layer_norm_eps)
        return _dropout(y, self.dropout_rate, training, generator), state

    def regularizable_params(self):
        return ()


@register_layer
@dataclasses.dataclass
class ClsPoolingLayer(Layer):
    """One timestep (default 0, BERT's [CLS]) of (batch, time, d)."""

    index: int = 0

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.size)

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        return x[:, self.index], state


@register_layer
@dataclasses.dataclass
class LearnedPositionalEmbeddingLayer(Layer):
    """Adds learned positional embeddings (a BERT position table)."""

    max_len: int = 512

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def init(self, generator, input_type, g: GlobalConfig):
        d = input_type.size
        return {"P": init_weights(generator, (self.max_len, d), self._winit(g),
                                  fan=(self.max_len, d), dtype=_param_dtype(g))}, {}

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        t = x.shape[1]
        _check_len(t, self.max_len, "LearnedPositionalEmbeddingLayer")
        return x + params["P"][None, :t, :], state

