#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``deeplearning4j_tpu_torch`` (never the JAX package, never JAX) on
the card and exits nonzero if any phase fails:

1. build  : compiles every CUDA kernel source of the port with ``nvcc``
            (one process per source, all started together) and prints the
            build time and each kernel's register use;
2. kernels: every kernel against its plain PyTorch version on the card, in
            float32 and bfloat16, at the serving/training shape (B=64,
            T=256, H=512) and at ragged shapes and B > 64 (two launches),
            with a random mask holding all-zero rows for the peephole/mask
            cell: the inference forward, the saving forward (ys, hT, cT and
            the residuals), and the backward (ds, dh0, dc0, on the same
            residuals); then the whole autograd wrapper's float32 gradients
            against ``torch.autograd`` of the plain forward. Max error beside
            the tolerance. The flash-attention kernel, both instances
            (inference: o; saving: o and lse), against its plain version in
            float32 and bfloat16 at BERT-base serving's shape (with and
            without a key-padding mask holding a length-1 row and a fully
            masked row), at T=4096 causal, and at ragged, cross-attention,
            d_v != d and d=256 shapes. The flash backward kernels (dq;
            dk/dv) against the plain backward on the same o and lse, in
            float32 and bfloat16, at the same shapes and at T=16384 causal
            (the TPU's chunked-backward regime), max error relative to the
            largest plain gradient; the autograd Function's float32
            gradients against ``torch.autograd`` of the plain forward. The
            GRU kernels (inference forward; saving forward: ys, hT, gates,
            zh_n; backward: dzx, dh0 on the same residuals) against
            ``gru_reference``/``gru_bwd_reference`` in float32 and bfloat16
            at the same shapes, ``FusedGRUFunction``'s float32 gradients
            (dzx, dW_rec, dh0) against ``torch.autograd`` of
            ``gru_reference``, and one ``Bidirectional(GRU)`` forward against
            the plain loop (2 launches). The dropout kernel against its plain
            version, bitwise (the same Philox bits), forward, backward and
            the same seed again, in float32 and bfloat16, with and without
            the residual x, at rates 0.1, 0.5 and 0, at 8192 x 768, ragged
            shapes, one element and a 4k+3 tail, and through unaligned views;
            the backward's mask against the forward's, the keep fraction, and
            seed + 1 giving another mask. The short-attention forward and
            backward kernels against their plain versions in float32 and
            bfloat16, in both layouts, at BERT-base's shape (with a mask
            holding a length-1 and a fully masked row, and without), t = 512,
            t = 1, odd t and d of 32, 64 and 128, and the autograd Function's
            float32 gradients against ``torch.autograd`` of the plain forward;
3. slice  : the serving path at full width. ``TextGenerationLSTM(vocab 96,
            hidden 512, 2 layers)`` with random weights from a seed, in
            bf16 compute, is written to an archive, loaded by
            ``ModelRegistry.load`` and served to 8 client threads sending
            requests of 1-64 rows at T=256. Every answer is held against a
            forward pass built from the plain versions; the launch counts
            of the run must show the inference kernels ran; ``rnn_time_step``
            over 4 chunks of 64 steps must equal the whole-sequence output.
            Once with ``graves=True`` (GravesLSTM, kernels of
            ``fused_lstm_graves``) and once with ``graves=False`` (LSTM,
            kernels of ``fused_lstm``). Then ``slice bert``: ``Bert.base()``
            (L=12, H=768, A=12) with random weights from its zoo seed, bf16
            compute, through an archive and ``ModelRegistry.load``, serving
            8 client threads requests of 1-64 rows of T=128 token ids: every
            answer against the forward with the plain attention, 12 flash
            launches per batch, masked rows against the same rows cut to
            their tokens, p50 of a 64-row request and samples/s. Then
            ``slice gru``: the same char-RNN with GRU cells, built with the
            builder DSL, served the same way (2 ``fused_gru`` launches per
            batch and nothing else launched);
4. train  : the training path at full width. The same network with
            ``tbptt_length=256`` is trained by ``fit`` in bf16 compute on 20
            seeded batches of B=64, T=256 (``bench_char_rnn``'s shape); the
            launch counts must show one saving forward and one backward per
            layer per step and nothing of the other cell, and the loss must
            fall. It prints step ms and tokens/s. The first 3 steps' losses
            are held, in float32 and bfloat16, against the same training
            with the recurrences computed by the plain forward under
            autograd. Once per cell, as the slice phase. Then ``train
            bert``: ``Bert.base()`` fine-tuned by ``fit`` at B=64, T=128
            (an all-ones features mask, Adam(2e-5), dropout 0.1, bf16
            compute over fp32 weights) for 20 seeded steps of random ids:
            12 saving-forward, 12 dq and 12 dk/dv flash launches per step
            and no inference launch, the first 3 losses in float32 and
            bfloat16 against a
            trainer whose attention runs the plain forward and backward,
            step ms, samples/s, a device-busy breakdown of one step; then
            20 steps on balanced labels with each row made of its label's
            token, where the loss must fall below the first step's and
            chance and the trained net must label a fresh batch; and the
            statistics of the dropout masks drawn on the card. Then ``train
            gru``: the GRU char-RNN as the LSTM cells are trained (1 saving
            forward and 1 backward GRU launch per layer per step, nothing
            else launched).
            ``--label-rules`` runs the build and 20 steps under each of
            several label rules instead;
5. ops    : the entry points of the last three TPU kernels, which no layer
            routes to, driven under autograd as ``bench.py:572-626``
            (``verify_kernels``) drives the JAX package's:
            ``short_attention`` and ``short_attention_btd`` at (64, 12, 128,
            64) bf16, forward and gradient against a dense fp32 softmax, and
            ``fused_dropout`` at 8192 x 768 bf16, rate 0.1 (zero fraction,
            the gradient's mask); one forward and one backward launch of each;
6. times  : each kernel's time at B=64, T=256, H=512 bf16 (CUDA events,
            after warm-up) beside its bound, its plain version's time and,
            for the plain cell, ``torch.nn.LSTM`` (cuDNN) inference, training
            forward and backward as a yardstick the port never calls; the
            kernels' share of a training step. The GRU kernels the same way,
            beside ``torch.nn.GRU`` (cuDNN), with their share of a serving
            request and of a training step. The flash kernel in bf16 at
            BERT-base serving's shape (unmasked as served, and masked) and
            at T=4096 causal, beside its bound, its saving instance, its
            plain version and ``scaled_dot_product_attention`` (a yardstick
            the port never calls); attention's share of a BERT request. The
            backward pair at BERT-base's shape (masked, as trained, and
            unmasked), at T=4096 causal and at T=16384 causal, beside its
            bound, the plain backward, ``scaled_dot_product_attention``'s
            backward and each kernel's own device time (``torch.profiler``);
            attention's share of a BERT training step. The dropout kernel
            (forward, backward, and with x) beside ``F.dropout``, and the
            short-attention kernels in both layouts beside
            ``scaled_dot_product_attention``, at the ops phase's shapes.

Before the last line it prints one JSON object ``{"kernels": [...]}`` (one
row per kernel instance on a main path: the inference and saving forwards
and the backward of each LSTM cell and of the GRU, the inference and saving flash
forwards, the flash backward's dq and dk/dv kernels, whose plain and
library times are those of the whole backward, the dropout kernel's forward and
backward, and the short-attention forward and backward in each layout, whose
backward is a pair of kernels counted as one launch)
and the card's name and power limit as ``nvidia-smi`` gives them; the last
line is ``{"ok": true, "device": {...}}``. With no CUDA
device, or without the rest of the repository beside it, it prints no
result and exits nonzero.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SERVE_T, SERVE_B, HIDDEN, VOCAB, LAYERS = 256, 64, 512, 96, 2
# (T, B, H): the serving shape first, then the 1-row bucket, ragged widths, one
# step (rnn_time_step), and more rows than one launch takes
KERNEL_SHAPES = [(SERVE_T, SERVE_B, HIDDEN), (SERVE_T, 1, HIDDEN), (5, 3, 200),
                 (1, 64, 512), (3, 130, 64)]
# Kernel vs plain version, max abs error over ys/hT/cT. float32: the two sum
# h @ W_rec in different orders. bfloat16: both round h to bf16 at every
# step, so a tie broken the other way by that order carries one bf16 ulp
# (0.0078 at |c| in [1, 2)) down the sequence; 4 ulps of headroom.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 3.2e-2}
# Backward kernel vs plain version, max abs error over ds/dh0/dc0 divided by
# max(1, max |plain|): the dh carry grows along the reverse sequence, so the
# error is held relative to it. float32: summation order of ds @ W_rec^T.
# bfloat16: both round ds to bf16 at every step, so one rounding tie broken
# the other way carries a bf16 ulp (2^-8 relative) into dh; 8 ulps of headroom.
BWD_TOL = {"float32": 1e-4, "bfloat16": 3.2e-2}
# The autograd wrapper's float32 gradients vs torch.autograd of the plain
# forward, max abs error / max(1, max |plain|) per input: dW_rec and dpeep sum
# T*B products in another order on each side.
GRAD_TOL = 1e-3
# (cell, peepholes, mask) triples each kernel check runs
CELLS = (("fused_lstm", False, False), ("fused_graves_lstm", True, True),
         ("fused_graves_lstm", True, False))
# Shapes of the autograd check: the training shape, and two launches of rows
GRAD_SHAPES = [(SERVE_T, SERVE_B, HIDDEN), (3, 130, 64)]
# The char-RNNs the slice and train phases drive: cell -> log tag, the kernel
# wrapper its recurrent layers route to, and the offset of its seeds. "gru" is
# the same network as the zoo's with GRU cells, built with the builder DSL
# (the JAX package has no GRU zoo model).
CHAR_RNN_TAGS = {"graves": "graves=True", "lstm": "graves=False", "gru": "gru"}
CHAR_RNN_KERNELS = {"graves": "fused_graves_lstm", "lstm": "fused_lstm", "gru": "fused_gru"}
CHAR_RNN_SEEDS = {"graves": 1, "lstm": 0, "gru": 2}
# One Bidirectional(GRU) forward against the plain loop: (T, B, n_in), H = HIDDEN
BIDI_SHAPE = (64, 16, VOCAB)
# Served softmax probabilities vs the plain forward (bf16 compute).
SERVE_TOL = 1e-2
# rnn_time_step in 4 chunks vs the whole sequence: the chunks hand h/c over
# in bf16 where the whole sequence keeps c in fp32 inside the kernel.
CHUNK_TOL = 2e-2
CLIENTS, REQUESTS_PER_CLIENT = 8, 3
# Training: bench_char_rnn's shape (B=64, T=256 = one tBPTT chunk per batch),
# TRAIN_STEPS batches through fit; the first CMP_STEPS against the plain trainer.
TRAIN_B, TRAIN_T, TRAIN_STEPS, CMP_STEPS = 64, 256, 20, 3
# Per-step loss, kernels vs the plain trainer (the same network, optimizer and
# weights, with autograd through lstm_reference), max |difference| over the
# first CMP_STEPS steps. float32: summation order only. bfloat16: the two
# sides round differently placed values to bf16 (one-ulp differences in ys and
# ds), and RmsProp's first steps turn a near-zero gradient's sign into a full
# +-4.5e-3 weight step, so a few weights move apart.
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The mean loss of the last 3 steps must be below this share of the first
# step's (about ln 96 = 4.56 from random weights). The batches follow a seeded
# table of 4 successors per character, whose skewed character frequencies
# alone are worth about 3% of that; RmsProp at the zoo's 1e-3 learns them
# within TRAIN_STEPS steps, the successors themselves only later.
LOSS_FALL = 0.98
# Flash attention kernel checks: (b, h, t_q, t_k, d, d_v, key-padding mask,
# causal). BERT-base serving (with and without a mask that holds a length-1
# row and a fully masked row), the causal heads of
# examples/long_context_attention.py (12 x d=64) at T=4096, ragged lengths,
# cross attention, d_v != d, and the widest head the kernel takes.
FLASH_SHAPES = [(64, 12, 128, 128, 64, 64, False, False), (64, 12, 128, 128, 64, 64, True, False),
                (1, 12, 4096, 4096, 64, 64, False, True), (3, 2, 77, 77, 64, 64, True, False),
                (3, 2, 77, 77, 64, 64, True, True), (2, 4, 100, 300, 32, 32, True, False),
                (2, 2, 256, 256, 128, 128, True, False), (2, 2, 256, 256, 128, 128, False, True),
                (2, 3, 33, 47, 48, 160, True, False), (2, 2, 70, 70, 256, 256, True, True)]
# Flash kernel vs its plain version, max abs error of o and of lse. float32:
# summation order only (the online softmax rescales partial sums the dense
# softmax never forms). bfloat16: both round P to bf16 before P @ V, the
# kernel relative to the running max, the plain version relative to the
# final one, so a P value and then o can land one bf16 ulp apart (0.0078 at
# |o| in [1, 2)); 4 ulps of headroom. lse is fp32 on both sides from the same
# scores: summation order of up to 4096 terms of l.
FLASH_TOL = {"float32": (2e-5, 1e-3), "bfloat16": (3.2e-2, 1e-3)}
# The flash backward's long-context check: one head of T=16384 causal, the
# regime of the TPU's chunked backward (rows 9; T > 8192), which the same
# kernels take. Its plain version holds dense (T, T) fp32 matrices (~1 GB each).
FLASH_LONG_SHAPE = (1, 1, 16384, 16384, 64, 64, False, True)
# Backward kernels vs the plain backward on the same o, lse and dO, max abs
# error of dq, dk and dv divided by max |plain| of that gradient (no floor at
# 1: BERT's gradients are below 1). float32: summation order (up to 16384
# terms). bfloat16: the plain backward rounds dS and P at the kernel's points,
# so only fp32 sums formed in another order, then rounded to bf16, can land
# one bf16 ulp apart; on an H100 (700 W) that read <= 1.4e-7 at every
# FLASH_SHAPES entry and 1.2e-3 at T=16384 (then still divided by max(1,
# max |plain|)). The limit is 2^-8: one bf16 ulp of a value at the bottom of
# the largest gradient's binade, which a kernel that skipped the rounding of
# dS or P reaches wherever that moves a near-largest value by one ulp.
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -8}
# The autograd Function's float32 gradients vs torch.autograd of the plain
# forward, max abs error / max(1, max |plain|): summation order only (the
# shapes hold no fully masked row, whose flash gradient differs by design).
FLASH_GRAD_TOL = 1e-4
# Fused dropout (row 10): bench.py's verify_kernels shape (8192 x 768 bf16,
# rate 0.1) first, then ragged shapes, one element, and a 4k+3 tail. The
# kernel and its plain version draw the same Philox bits, so every check is
# bitwise, in float32 and bfloat16, with and without x, at every rate.
DROPOUT_SHAPES = [(8192, 768), (3, 130, 64), (1, 1), (4 * 1001 + 3,)]
DROPOUT_RATES = (0.1, 0.5, 0.0)
# The keep fraction of a mask must lie within this many binomial sigmas.
DROPOUT_SIGMAS = 5.0
# Short attention (rows 11-12): (b, h, t, d, key mask). BERT-base (with a
# mask holding a length-1 row and a fully masked row, and without), the
# longest t, t = 1, odd t, and d of 32, 64 and 128.
SHORT_SHAPES = [(64, 12, 128, 64, True), (64, 12, 128, 64, False), (2, 4, 512, 64, True),
                (3, 2, 1, 64, False), (3, 2, 77, 32, True), (2, 3, 77, 128, False),
                (2, 2, 512, 128, True)]
# Forward kernel vs its plain version, max abs error of o. float32: summation
# order only (d-term dots and the t-term row sum). bfloat16: both round P to
# bf16 before P @ V; the card's expf and the plain softmax's exp differ in the
# last fp32 bit, so a P near a rounding tie can round the other way and o
# move by one bf16 ulp (0.0078 at |o| in [1, 2)); 4 ulps of headroom.
SHORT_TOL = {"float32": 2e-5, "bfloat16": 3.2e-2}
# Backward kernels vs the plain backward, max abs error of dq, dk, dv over
# max |plain| of that gradient. float32: summation order. bfloat16: both round
# P and dS at the same points, so a value near a tie (as above) or an fp32
# sum in another order can move an output by one bf16 ulp: at most 2^-7 of a
# value in the largest gradient's binade, the limit.
SHORT_BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# ShortAttentionFunction's float32 gradients vs torch.autograd of the plain
# forward, max abs error / max(1, max |plain|): summation order only.
SHORT_GRAD_TOL = 1e-4
# The ops phase: bench.py:572-626 (verify_kernels) through the entry points
# under autograd, bf16, against a dense fp32 softmax, with the bench's limits:
# forward max abs error <= 0.05, gradient <= 0.05 * max(max |g|, 1); dropout's
# zero fraction in (0.08, 0.12) at rate 0.1.
OPS_SHORT = (64, 12, 128, 64)
OPS_FWD_TOL, OPS_GRAD_TOL, OPS_ZERO_FRAC = 0.05, 0.05, (0.08, 0.12)
# BERT-base serving: Bert.base() (L=12, H=768, A=12), bf16 compute over fp32
# weights, requests of 1-64 rows of T=128 token ids, as bench_zoo_bert.
BERT_T, BERT_B, BERT_LAYERS, BERT_VOCAB = 128, 64, 12, 30522
# Served class probabilities vs the forward built from the plain versions,
# and masked rows vs the same rows cut to their tokens: bf16 compute, where a
# one-ulp difference in an attention output (see FLASH_TOL) or in a product
# of another shape passes through 12 residual + LayerNorm layers into the
# pooler and the softmax.
BERT_TOL = 2e-2
# BERT-base fine-tuning: bench_zoo_bert's step (B=64, T=128, Adam(2e-5), bf16
# compute over fp32 weights, dropout 0.1 as the zoo sets it) through fit,
# BERT_TRAIN_STEPS seeded batches; the first BERT_CMP_STEPS against a trainer
# whose attention runs the plain forward and plain backward.
BERT_TRAIN_STEPS, BERT_CMP_STEPS = 20, 3
# The main path trains on bench_zoo_bert's data, random ids (whose labels it
# cannot learn), so that its step time is that workload's. A second fit from
# the same weights shows learning, on balanced labels with every token of a
# row its label's marker id (every_token). From random weights at lr 2e-5, 20
# steps learn no subtler rule of LABEL_RULES (``python3 chip_smoke.py
# --label-rules`` trains each): on an H100 (700 W) the others left the last 3
# losses at 0.65-0.74; every_token reached 0.604 and accuracy 1.0.
BERT_MARKERS = (1000, 2000)
# The loss falls in that fit: the mean of the last 3 steps must be below
# BERT_LOSS_FALL x the lower of the first step's loss and ln 2 = 0.693 (chance
# on balanced labels, and what learning the prior alone scores), and the
# trained net must label a fresh seeded batch with accuracy >= BERT_MIN_ACC
# (chance 0.5). Adam's first steps move each of the 110 M weights by about lr
# along its gradient's sign, which shifts every output by several logits, so
# steps 2-5 overshoot (to 3.2 on that run) before the loss settles; the first
# step alone is the baseline, not the mean of the first 3. That run: first
# 0.815, last 3 0.604.
BERT_LOSS_FALL, BERT_MIN_ACC = 0.95, 0.9
# Per-step loss, kernels vs the plain trainer (the same weights, batches and
# dropout masks: the masks are drawn on the card from the same RngManager
# stream), max |difference| over the first BERT_CMP_STEPS. float32: summation
# order only; Adam's first steps move a weight by about +-lr whatever its
# gradient's size, so gradients that are rounding noise (the key bias's) step
# apart by up to 2 lr, which moves the loss by far less than 1e-4. bfloat16:
# the two sides round differently placed values to bf16 (attention outputs
# one ulp apart, see FLASH_TOL), and those pass through 12 layers.
BERT_TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Published peaks of one H100 SXM (dense): bf16 tensor cores, fp32 without
# tensor cores, memory rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def char_rnn_conf(cell, tbptt_length):
    """The 2x512 char-RNN of ``cell``: ``TextGenerationLSTM(vocab 96,
    hidden 512, 2 layers)`` for the LSTM cells, and for "gru" the same
    network built with the builder DSL as ``zoo/textgen_lstm.py`` builds it,
    GRU cells in place of the LSTMs (RmsProp(1e-3), seed 123)."""
    from deeplearning4j_tpu_torch.nn import (GRU, InputType, NeuralNetConfiguration,
                                             RnnOutputLayer)
    from deeplearning4j_tpu_torch.train.updaters import RmsProp
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    if cell != "gru":
        return TextGenerationLSTM(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS,
                                  tbptt_length=tbptt_length, graves=cell == "graves").conf()
    b = NeuralNetConfiguration.builder().seed(123).updater(RmsProp(1e-3)).list()
    for _ in range(LAYERS):
        b.layer(GRU(n_out=HIDDEN, activation="tanh"))
    return (b.layer(RnnOutputLayer(n_out=VOCAB, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.recurrent(VOCAB))
            .tbptt_fwd_length(tbptt_length).tbptt_back_length(tbptt_length).build())


def all_counters():
    """Every kernel wrapper's launch counter."""
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.ops.kernels import fused_attention_short as sa
    from deeplearning4j_tpu_torch.ops.kernels import (fused_dropout, fused_gru, fused_lstm,
                                                      fused_lstm_graves)
    return [c for m in (fused_lstm, fused_lstm_graves, fused_gru)
            for c in (m.counter, m.save_counter, m.bwd_counter)] + \
        [fa.counter, fa.lse_counter, fa.bwd_dq_counter, fa.bwd_dkv_counter,
         fused_dropout.counter, fused_dropout.bwd_counter,
         sa.counter, sa.bwd_counter, sa.btd_counter, sa.btd_bwd_counter]


def gru_inputs(T, B, H, dtype, device, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    a = {"zx": torch.randn(T, B, 3 * H, generator=g),
         "w_rec": torch.randn(H, 3 * H, generator=g) * (1.0 / H) ** 0.5,
         "h0": torch.randn(B, H, generator=g) * 0.5}
    return {k: v.to(dtype).to(device).contiguous() for k, v in a.items()}


def lstm_inputs(T, B, H, dtype, device, seed, peep, mask):
    import torch
    g = torch.Generator().manual_seed(seed)
    a = {"zx": torch.randn(T, B, 4 * H, generator=g),
         "w_rec": torch.randn(H, 4 * H, generator=g) * (1.0 / H) ** 0.5,
         "peep": torch.randn(3 * H, generator=g) * 0.3 if peep else None,
         "h0": torch.randn(B, H, generator=g) * 0.5,
         "c0": torch.randn(B, H, generator=g)}
    if mask:
        m = (torch.rand(T, B, generator=g) > 0.25).float()
        m[:, 0] = 0.0  # a row with every step masked
        if B > 2:
            m[:, B // 2] = 0.0
        a["mask"] = m
    else:
        a["mask"] = None
    return {k: None if v is None else v.to(dtype).to(device).contiguous()
            for k, v in a.items()}


def flash_inputs(b, h, t_q, t_k, d, d_v, dtype, device, seed, mask):
    """q, k, v in the JAX layout and, with ``mask``, a key-padding mask of
    random lengths (with 3 rows or more: row 0 attends one key, row 1
    none)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(b, h, t, d, generator=g) for t in (t_q, t_k))
    v = torch.randn(b, h, t_k, d_v, generator=g)
    m = None
    if mask:
        lengths = torch.randint(1, t_k + 1, (b,), generator=g)
        if b >= 3:
            lengths[0], lengths[1] = 1, 0
        m = (torch.arange(t_k)[None, :] < lengths[:, None]).to(device)
    return [t.to(dtype).to(device) for t in (q, k, v)], m


def btd_views(tensors, heads):
    """``(b, h, t, d)`` tensors copied into ``(b, t, h*d)`` layout, and the
    ``(b, h, t, d)`` views of those copies that short_attention_btd hands the
    kernels."""
    b, h, t, d = tensors[0].shape
    flat = [x.transpose(1, 2).reshape(b, t, h * d).contiguous() for x in tensors]
    return flat, [x.view(b, t, heads, d).transpose(1, 2) for x in flat]


def bits_equal(a, b):
    """Bitwise equality of two float tensors (so -0.0 differs from +0.0)."""
    import torch
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(a.view(as_int[a.dtype]), b.view(as_int[b.dtype]))


def attention_pairs(b, h, t_q, t_k, mask, causal):
    """(query, key) pairs the function needs on these inputs: the keys a
    row attends (every key for a fully masked row, whose answer is the mean
    of V), or those on and below the diagonal when causal (not both)."""
    if mask is not None and causal:
        raise ValueError("attention_pairs counts a mask or the causal triangle, not both")
    per_row = t_q * (t_q + 1) // 2 if causal else t_q * t_k
    if mask is None:
        return b * h * per_row
    keys = mask.sum(dim=1).tolist()
    return h * sum(t_q * (n if n else t_k) for n in keys)


def max_err(got, want, relative=False):
    """Max abs difference over paired tensors; ``relative`` divides it by
    max(1, max |want|)."""
    err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(got, want))
    if not relative:
        return err
    return err / max(1.0, max(float(y.float().abs().max()) for y in want))


def bound(tensors, flops, dtype):
    """Least time the card could take: each input read once and each output
    written once at the memory rate, vs ``flops`` (the recurrent product) at
    the peak rate of ``dtype``. Returns (ms, 'bytes'|'operations')."""
    moved = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    rate = PEAK_FLOPS[str(dtype).replace("torch.", "")]
    t_bytes, t_ops = moved / PEAK_BYTES * 1e3, flops / rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def char_batches(n, seed):
    """``n`` one-hot (x, y) batches of next-character prediction, B=TRAIN_B,
    T=TRAIN_T: sequences drawn from a seeded table that gives each of the
    VOCAB characters 4 possible successors."""
    import numpy as np
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, VOCAB, (VOCAB, 4))
    eye = np.eye(VOCAB, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = np.empty((TRAIN_B, TRAIN_T + 1), np.int64)
        ids[:, 0] = rng.integers(0, VOCAB, TRAIN_B)
        pick = rng.integers(0, 4, (TRAIN_B, TRAIN_T))
        for t in range(TRAIN_T):
            ids[:, t + 1] = succ[ids[:, t], pick[:, t]]
        out.append((eye[ids[:, :-1]], eye[ids[:, 1:]]))
    return out


def clone_tree(tree):
    from deeplearning4j_tpu_torch.runtime.trees import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


def label_batches(n, seed, rule, prior=0.5, repeat=False):
    """``n`` (token ids, one-hot labels) batches of BERT_B rows of BERT_T
    ids: a row's label is 1 with probability ``prior``; ``rule(rng, m)``
    makes the ids from the rows' markers ``m`` (BERT_MARKERS[label]).
    ``repeat``: ``n`` copies of one batch."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(1 if repeat else n):
        label = (rng.random(BERT_B) < prior).astype(np.int64)
        ids = rule(rng, np.asarray(BERT_MARKERS)[label][:, None])
        out.append((ids, np.eye(2, dtype=np.float32)[label]))
    return out * n if repeat else out


def marked(positions):
    """Random ids with the row's marker in its first ``positions`` tokens."""
    def rule(rng, m):
        import numpy as np
        ids = rng.integers(0, BERT_VOCAB, (BERT_B, BERT_T))
        ids[:, :positions] = m
        return ids
    return rule


def bag(k):
    """Every token one of ``k`` ids that belong to the row's label."""
    return lambda rng, m: m + rng.integers(0, k, (BERT_B, BERT_T))


def every_token(rng, m):
    """Every token the row's marker: the rule bert_train_phase trains on."""
    return m.repeat(BERT_T, axis=1)


# --label-rules: (name, rule, prior, one batch repeated)
LABEL_RULES = [("marker in token 0, 3:1", marked(1), 0.75, False),
               ("marker in token 0", marked(1), 0.5, False),
               ("marker in token 0, one batch repeated", marked(1), 0.5, True),
               ("marker in tokens 0-15", marked(16), 0.5, False),
               ("marker in tokens 0-63", marked(64), 0.5, False),
               ("every token from 64 label ids", bag(64), 0.5, False),
               ("every token from 8 label ids", bag(8), 0.5, False),
               ("every token the marker", every_token, 0.5, False)]


def random_ids(rng, m):
    """bench_zoo_bert's data: random ids; the label is not in them."""
    return rng.integers(0, BERT_VOCAB, (BERT_B, BERT_T))


class StepStamps:
    """A listener that records the host clock when each iteration is done;
    it reads the loss first, which waits for the device."""

    def __init__(self, stamps):
        self.stamps = stamps

    def iteration_done(self, model, iteration, epoch, score):
        float(score)
        self.stamps.append(time.perf_counter())

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass


class plain_recurrences:
    """Within the block the recurrent layers run the plain forward under
    autograd (``lstm_reference``, ``gru_reference``) in place of the
    kernels' wrappers: the forward and the trainer built from the plain
    versions, for comparison only."""

    def __enter__(self):
        from deeplearning4j_tpu_torch.nn import recurrent_layers as rl
        from deeplearning4j_tpu_torch.ops.kernels.fused_gru import gru_reference
        from deeplearning4j_tpu_torch.ops.kernels.fused_lstm import lstm_reference
        self.rl, self.saved = rl, (rl.fused_lstm, rl.fused_graves_lstm, rl.fused_gru)
        rl.fused_lstm = lambda zx, w, h0, c0: lstm_reference(zx, w, None, h0, c0, None)
        rl.fused_graves_lstm = lambda zx, w, p, h0, c0, m=None: lstm_reference(
            zx, w, p, h0, c0, m)
        rl.fused_gru = gru_reference
        return self

    def __exit__(self, *exc):
        self.rl.fused_lstm, self.rl.fused_graves_lstm, self.rl.fused_gru = self.saved
        return False


def plain_flash_function():
    """An autograd Function over the flash kernel's plain versions:
    ``flash_attention_reference`` forward, ``flash_attention_backward_reference``
    backward (what the kernels compute, with the same lse and rounding
    points)."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask, causal):
            o, lse = fa.flash_attention_reference(q, k, v, mask, causal)
            ctx.save_for_backward(q, k, v, o, lse, mask)
            ctx.causal = causal
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse, mask = ctx.saved_tensors
            grads = fa.flash_attention_backward_reference(q, k, v, o, lse, do, mask, ctx.causal)
            return (*grads, None, None)

    return PlainFlash


class plain_attention:
    """Within the block every attention layer runs the flash kernel's plain
    versions in place of the kernels' wrapper: ``flash_attention_reference``
    for the forward and, where autograd records, its plain backward. The
    forward and the trainer built from the plain versions, for comparison
    only."""

    def __enter__(self):
        import torch
        from deeplearning4j_tpu_torch.nn import attention_layers as al
        from deeplearning4j_tpu_torch.ops.kernels.flash_attention import \
            flash_attention_reference
        plain = plain_flash_function()

        def attention(q, k, v, mask=None, causal=False):
            if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
                return plain.apply(q, k, v, mask, causal)
            return flash_attention_reference(q, k, v, mask, causal)[0]

        self.al, self.saved = al, al.flash_attention
        al.flash_attention = attention
        return self

    def __exit__(self, *exc):
        self.al.flash_attention = self.saved
        return False


class Smoke:
    def __init__(self, device):
        import torch
        self.torch = torch
        self.device = device
        self.failures = []
        self.kernels = {}  # name -> JSON row
        self.train_step_ms = {}  # cell -> median step ms of the train phase
        self.serve_p50_ms = {}  # cell -> p50 of one 64-row request
        self.bert_train_step_ms = None  # median step ms of the bert train phase
        self.flash_lse_ms = None  # the saving forward at BERT-base's shape, masked
        self.bert_p50_ms = None  # one 64-row BERT-base request, p50

    def check(self, ok, what):
        log(("ok   " if ok else "FAIL ") + what)
        if not ok:
            self.failures.append(what)

    # ------------------------------------------------------------ phases
    def phase(self, name, fn):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # record, keep going, fail at the end
            import traceback
            traceback.print_exc()
            self.failures.append(f"{name}: {type(e).__name__}: {e}")
        log(f"== {name} took {time.perf_counter() - t0:.1f} s")

    def build(self):
        from deeplearning4j_tpu_torch.ops.kernels import (  # noqa: F401
            _native, flash_attention, fused_attention_short, fused_dropout, fused_gru, fused_lstm)
        t0 = time.perf_counter()
        seconds = _native.build_all()
        log(f"kernel build: {time.perf_counter() - t0:.2f} s wall; per source {seconds}")
        for lib in _native._LIBRARIES.values():
            kernel = ""
            for line in lib.build_log.splitlines():
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1] if "'" in line else line
                    # lstm_fwd_kernel<T, PEEP, MASK, SAVE>, gru_fwd_kernel<T, SAVE>
                    # or flash_fwd_kernel<T, DMAX, CAUSAL, SAVE> from its mangled name
                    # (dropout_kernel<T> has no flag)
                    m = re.search(r"\d+([a-z_]+_kernel)I\d*(\w+?)((?:L[ib]\d+E)*)E", kernel)
                    if m:
                        flags = "".join(", " + f for f in re.findall(r"L[ib](\d+)E", m[3]))
                        kernel = f"{m[1]}<{m[2]}{flags}>"
                elif "Used" in line and "registers" in line:
                    log(f"  {lib.source.name} {kernel}: {line.split(':', 1)[1].strip()}")

    def kernel_phase(self):
        torch = self.torch
        for dtype in (torch.float32, torch.bfloat16):
            for T, B, H in KERNEL_SHAPES:
                for cell, peep, mask in CELLS:
                    self.check_kernels(cell, T, B, H, dtype, peep, mask)
        for T, B, H in GRAD_SHAPES:
            for cell, peep, mask in CELLS:
                self.check_autograd(cell, T, B, H, peep, mask)
        for dtype in (torch.float32, torch.bfloat16):
            for T, B, H in KERNEL_SHAPES:
                self.check_gru(T, B, H, dtype)
        for T, B, H in GRAD_SHAPES:
            self.check_gru_autograd(T, B, H)
        self.check_bidirectional_gru()
        for dtype in (torch.float32, torch.bfloat16):
            for shape in FLASH_SHAPES:
                self.check_flash(shape, dtype)
        self.flash_backward_checks()
        self.dropout_checks()
        self.short_attention_checks()

    def flash_backward_checks(self):
        torch = self.torch
        for dtype in (torch.float32, torch.bfloat16):
            for shape in FLASH_SHAPES + [FLASH_LONG_SHAPE]:
                self.check_flash_bwd(shape, dtype)
        for shape in FLASH_SHAPES:
            if not (shape[6] and shape[0] >= 3):  # no fully masked row
                self.check_flash_autograd(shape)

    def check_flash_bwd(self, shape, dtype):
        """The two backward kernels against the plain backward on the same
        inputs: o and lse from the saving forward kernel, a random dO."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        b, h, t_q, t_k, d, d_v, masked, causal = shape
        dname = str(dtype).replace("torch.", "")
        (q, k, v), mask = flash_inputs(b, h, t_q, t_k, d, d_v, dtype, self.device,
                                       seed=t_q + 5 * t_k + d, mask=masked)
        bias = fa.key_bias(mask, b, t_k)
        g = torch.Generator().manual_seed(t_q + d_v)
        with torch.no_grad():
            o, lse = fa.launch_flash_fwd(q, k, v, bias, causal, fa.lse_counter, save=True)
            do = torch.randn(b, h, t_q, d_v, generator=g).to(dtype).to(self.device)
            got = fa.launch_flash_bwd(q, k, v, o, lse, do, bias, causal)
            torch.cuda.synchronize()
            want = fa.flash_attention_backward_reference(q, k, v, o, lse, do, mask, causal)
            torch.cuda.synchronize()
        tol = FLASH_BWD_TOL[dname]
        peaks = [float(y.float().abs().max()) for y in want]
        errs = [max_err([x], [y]) / (p or 1.0) for x, y, p in zip(got, want, peaks)]
        finite = all(bool(torch.isfinite(x.float()).all()) for x in got)
        self.check(finite and max(errs) <= tol,
                   f"flash_attention_bwd   {dname:8s} b={b:2d} h={h:2d} t_q={t_q:5d} "
                   f"t_k={t_k:5d} d={d:3d} d_v={d_v:3d} mask={'yes' if masked else 'no '} "
                   f"causal={'yes' if causal else 'no '} max_rel_err dq={errs[0]:.3g} "
                   f"dk={errs[1]:.3g} dv={errs[2]:.3g} tol={tol:g} (max |plain| "
                   + " ".join(f"{p:.3g}" for p in peaks) + ")")
        if shape == FLASH_SHAPES[1] and dtype == torch.bfloat16:  # masked, as trained
            self.kernels.setdefault(fa.bwd_dq_counter.name, {})["max_abs_err"] = errs[0]
            self.kernels.setdefault(fa.bwd_dkv_counter.name, {})["max_abs_err"] = max(errs[1:])
        del q, k, v, o, lse, do, got, want
        torch.cuda.empty_cache()

    def check_flash_autograd(self, shape):
        """``flash_attention`` under autograd (saving forward + backward
        kernels) against ``torch.autograd`` of the plain forward, float32."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        b, h, t_q, t_k, d, d_v, masked, causal = shape
        (q, k, v), mask = flash_inputs(b, h, t_q, t_k, d, d_v, torch.float32, self.device,
                                       seed=7 * t_q + d, mask=masked)
        g = torch.Generator().manual_seed(t_k + d)
        do = torch.randn(b, h, t_q, d_v, generator=g).to(self.device)
        before = (fa.bwd_dq_counter.value, fa.bwd_dkv_counter.value)
        grads = []
        for run in (fa.flash_attention,
                    lambda *a, causal: fa.flash_attention_reference(*a, causal=causal)[0]):
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = run(*leaves, mask, causal=causal)
            grads.append(torch.autograd.grad(out, leaves, do))
        torch.cuda.synchronize()
        launched = (fa.bwd_dq_counter.value - before[0], fa.bwd_dkv_counter.value - before[1])
        errs = [max_err([x], [y], relative=True) for x, y in zip(*grads)]
        self.check(max(errs) <= FLASH_GRAD_TOL and launched == (1, 1),
                   f"flash_attention autograd vs plain float32 b={b:2d} h={h:2d} t_q={t_q:4d} "
                   f"t_k={t_k:4d} d={d:3d} d_v={d_v:3d} mask={'yes' if masked else 'no '} "
                   f"causal={'yes' if causal else 'no '} max_rel_err dq={errs[0]:.3g} "
                   f"dk={errs[1]:.3g} dv={errs[2]:.3g} tol={FLASH_GRAD_TOL:g}; backward "
                   f"launches {launched} (expected (1, 1))")

    def check_flash(self, shape, dtype):
        """Both flash instances (inference: o; saving: o and lse) against
        the plain version on the same inputs."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        b, h, t_q, t_k, d, d_v, masked, causal = shape
        dname = str(dtype).replace("torch.", "")
        (q, k, v), mask = flash_inputs(b, h, t_q, t_k, d, d_v, dtype, self.device,
                                       seed=t_q + 3 * t_k + d_v, mask=masked)
        bias = fa.key_bias(mask, b, t_k)
        with torch.no_grad():
            got = fa.launch_flash_fwd(q, k, v, bias, causal, fa.counter)
            got_o, got_lse = fa.launch_flash_fwd(q, k, v, bias, causal, fa.lse_counter, save=True)
            torch.cuda.synchronize()
            want_o, want_lse = fa.flash_attention_reference(q, k, v, mask, causal)
        torch.cuda.synchronize()
        tol_o, tol_lse = FLASH_TOL[dname]
        tag = (f"{dname:8s} b={b:2d} h={h:2d} t_q={t_q:4d} t_k={t_k:4d} d={d:3d} d_v={d_v:3d} "
               f"mask={'yes' if masked else 'no '} causal={'yes' if causal else 'no '}")
        err = max_err([got], [want_o])
        err_o, err_lse = max_err([got_o], [want_o]), max_err([got_lse], [want_lse])
        finite = all(bool(torch.isfinite(x.float()).all()) for x in (got, got_o))
        self.check(finite and err <= tol_o,
                   f"{fa.counter.name:22s} {tag} o max_abs_err={err:.3g} tol={tol_o:g}")
        self.check(finite and err_o <= tol_o and err_lse <= tol_lse,
                   f"{fa.lse_counter.name:22s} {tag} o max_abs_err={err_o:.3g} tol={tol_o:g}, "
                   f"lse max_abs_err={err_lse:.3g} tol={tol_lse:g}")
        if shape == FLASH_SHAPES[0] and dtype == torch.bfloat16:
            self.kernels.setdefault(fa.counter.name, {})["max_abs_err"] = err
        if shape == FLASH_SHAPES[1] and dtype == torch.bfloat16:  # masked, as trained
            self.kernels.setdefault(fa.lse_counter.name, {})["max_abs_err"] = max(err_o, err_lse)

    def dropout_checks(self):
        torch = self.torch
        for dtype in (torch.float32, torch.bfloat16):
            for shape in DROPOUT_SHAPES:
                for rate in DROPOUT_RATES:
                    for with_x in (False, True):
                        self.check_dropout(shape, dtype, rate, with_x)
        self.check_dropout((4 * 1001 + 3,), torch.bfloat16, 0.1, True, offset=1)

    def check_dropout(self, shape, dtype, rate, with_x, offset=0):
        """The dropout kernel against its plain version, bitwise: the
        forward (with ``x`` when ``with_x``), the backward launch on a
        random gy (its mask must be the forward's), the same seed again
        (same bits) and seed + 1 (another mask), and the keep fraction.
        ``offset`` > 0 reads views that start that many elements into their
        buffers, which the kernel takes element by element."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_dropout as fd
        dname = str(dtype).replace("torch.", "")
        n = math.prod(shape)
        seed = n + int(rate * 100) - 2 ** 31  # negative: the bit pattern is the key
        g = torch.Generator().manual_seed(n + with_x)

        def tensor():
            t = torch.randn(n + offset, generator=g)
            t = torch.where(t == 0, torch.ones(()), t)  # a kept 0 would read as dropped
            return t.to(dtype).to(self.device)[offset:].view(shape)

        h, gy = tensor(), tensor()
        x = tensor() if with_x else None
        with torch.no_grad():
            got = fd.launch_dropout(x, h, seed, rate, fd.counter)
            fwd_mask = fd.launch_dropout(None, h, seed, rate, fd.counter) != 0
            dh = fd.launch_dropout(None, gy, seed, rate, fd.bwd_counter)
            again = fd.launch_dropout(x, h, seed, rate, fd.counter)
            other = fd.launch_dropout(None, h, seed + 1, rate, fd.counter) != 0
            torch.cuda.synchronize()
            want = fd.fused_dropout_reference(x, h, seed, rate)
            want_dh = fd.fused_dropout_reference(None, gy, seed, rate)
            kept = fd.keep_mask(n, seed, rate, self.device).view(shape)
        torch.cuda.synchronize()
        keep = 1.0 - rate
        n_kept = int(kept.sum())
        in_bounds = abs(n_kept - n * keep) <= DROPOUT_SIGMAS * math.sqrt(n * keep * rate) + 1
        differs = bool((other != fwd_mask).any()) if rate > 0 and n >= 64 else True
        ok = (bits_equal(got, want) and bits_equal(dh, want_dh) and bits_equal(again, got)
              and torch.equal(fwd_mask, kept) and torch.equal(dh != 0, kept) and in_bounds
              and differs)
        err = max_err([got], [want])
        self.check(ok, f"{fd.counter.name:22s} {dname:8s} shape={str(shape):13s} rate={rate:.1f} "
                       f"x={'yes' if with_x else 'no '}{f' offset={offset}' if offset else ''}: "
                       f"fwd, bwd, same seed bitwise = plain; bwd mask = fwd mask; kept "
                       f"{n_kept / n:.4f} (keep {keep:.1f}, {DROPOUT_SIGMAS:g} sigma: "
                       f"{in_bounds}); seed+1 differs: {differs}; max abs err {err:g}")
        if shape == DROPOUT_SHAPES[0] and dtype == torch.bfloat16 and rate == 0.1 and not with_x:
            self.kernels.setdefault(fd.counter.name, {})["max_abs_err"] = err
            self.kernels.setdefault(fd.bwd_counter.name, {})["max_abs_err"] = \
                max_err([dh], [want_dh])

    def short_attention_checks(self):
        torch = self.torch
        for dtype in (torch.float32, torch.bfloat16):
            for shape in SHORT_SHAPES:
                for btd in (False, True):
                    self.check_short(shape, dtype, btd)
        for shape in (SHORT_SHAPES[1], SHORT_SHAPES[4]):
            for btd in (False, True):
                self.check_short_autograd(shape, btd)

    def check_short(self, shape, dtype, btd):
        """The short-attention forward and backward kernels against their
        plain versions on the same inputs and dO, in the (b, h, t, d) layout
        or through the (b, h, t, d) views of (b, t, h*d) tensors."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_attention_short as sa
        b, h, t, d, masked = shape
        dname = str(dtype).replace("torch.", "")
        (q, k, v), mask = flash_inputs(b, h, t, t, d, d, dtype, self.device,
                                       seed=t + 11 * d + btd, mask=masked)
        g = torch.Generator().manual_seed(t + d)
        do = torch.randn(b, h, t, d, generator=g).to(dtype).to(self.device)
        if btd:
            _, (q, k, v, do) = btd_views([q, k, v, do], h)
        bias, scale = sa.key_bias(mask, b, t), d ** -0.5
        fwd_c, bwd_c = (sa.btd_counter, sa.btd_bwd_counter) if btd else (sa.counter,
                                                                            sa.bwd_counter)
        with torch.no_grad():
            o = sa.launch_short_fwd(q, k, v, bias, scale, fwd_c, btd)
            grads = sa.launch_short_bwd(q, k, v, do, bias, scale, bwd_c, btd)
            torch.cuda.synchronize()
            want_o = sa.short_attention_reference(q, k, v, mask, scale)
            want = sa.short_attention_backward_reference(q, k, v, do, mask, scale)
        torch.cuda.synchronize()
        err_o = max_err([o], [want_o])
        peaks = [float(y.float().abs().max()) for y in want]
        errs = [max_err([x], [y]) / (p or 1.0) for x, y, p in zip(grads, want, peaks)]
        finite = all(bool(torch.isfinite(x.float()).all()) for x in (o, *grads))
        tol, tol_b = SHORT_TOL[dname], SHORT_BWD_TOL[dname]
        tag = (f"{dname:8s} {'btd ' if btd else 'bhtd'} b={b:2d} h={h:2d} t={t:3d} d={d:3d} "
               f"mask={'yes' if masked else 'no '}")
        self.check(finite and err_o <= tol,
                   f"{fwd_c.name:23s} {tag} o max_abs_err={err_o:.3g} tol={tol:g}")
        self.check(finite and max(errs) <= tol_b,
                   f"{bwd_c.name:23s} {tag} max_rel_err dq={errs[0]:.3g} dk={errs[1]:.3g} "
                   f"dv={errs[2]:.3g} tol={tol_b:g} (max |plain| "
                   + " ".join(f"{p:.3g}" for p in peaks) + ")")
        if shape == SHORT_SHAPES[1] and dtype == torch.bfloat16:  # unmasked, as the ops phase
            self.kernels.setdefault(fwd_c.name, {})["max_abs_err"] = err_o
            self.kernels.setdefault(bwd_c.name, {})["max_abs_err"] = max(errs)

    def check_short_autograd(self, shape, btd):
        """``short_attention`` (or ``short_attention_btd``) under autograd
        against ``torch.autograd`` of the plain forward, float32, with the
        launch counts of the call (one forward, one backward)."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_attention_short as sa
        b, h, t, d, masked = shape
        (q, k, v), mask = flash_inputs(b, h, t, t, d, d, torch.float32, self.device,
                                       seed=3 * t + d, mask=masked)
        g = torch.Generator().manual_seed(5 * t + d)
        do = torch.randn(b, h, t, d, generator=g).to(self.device)
        if btd:
            (q, k, v, do), _ = btd_views([q, k, v, do], h)
        counters = (sa.btd_counter, sa.btd_bwd_counter) if btd else (sa.counter, sa.bwd_counter)
        before = [c.value for c in counters]
        grads = []
        for plain in (False, True):
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            if btd:
                args = [x.view(b, t, h, d).transpose(1, 2) for x in leaves]
                out = sa.short_attention_reference(*args, mask).transpose(1, 2).reshape(
                    b, t, h * d) if plain else sa.short_attention_btd(*leaves, mask, heads=h)
            else:
                out = sa.short_attention_reference(*leaves, mask) if plain else \
                    sa.short_attention(*leaves, mask)
            grads.append(torch.autograd.grad(out, leaves, do))
        torch.cuda.synchronize()
        launched = tuple(c.value - n for c, n in zip(counters, before))
        errs = [max_err([x], [y], relative=True) for x, y in zip(*grads)]
        self.check(max(errs) <= SHORT_GRAD_TOL and launched == (1, 1),
                   f"{counters[0].name} autograd vs plain float32 b={b:2d} h={h:2d} t={t:3d} "
                   f"d={d:3d} mask={'yes' if masked else 'no '} max_rel_err dq={errs[0]:.3g} "
                   f"dk={errs[1]:.3g} dv={errs[2]:.3g} tol={SHORT_GRAD_TOL:g}; launches "
                   f"{launched} (expected (1, 1))")

    def ops_phase(self):
        """The entry points of rows 10-12 driven under autograd as
        ``bench.py:572-626`` (``verify_kernels``) drives the JAX package's:
        ``short_attention`` and ``short_attention_btd`` at (64, 12, 128, 64)
        bf16, forward and the gradient of sum(o^2) in q, against a dense
        fp32 softmax; ``fused_dropout`` at 8192 x 768 bf16, rate 0.1, with
        its zero fraction and the gradient's mask. The launch counts of the
        run must be one forward and one backward of each kernel, nothing
        else."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_attention_short as sa
        from deeplearning4j_tpu_torch.ops.kernels import fused_dropout as fd
        b, h, t, d = OPS_SHORT
        dt = torch.bfloat16
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(b, h, t, d, generator=g).to(dt).to(self.device) for _ in range(3))
        (q3, k3, v3), _ = btd_views([q, k, v], h)
        hd = torch.randn(*DROPOUT_SHAPES[0], generator=g).to(dt).to(self.device)
        seed = fd.seed_from_key(torch.Generator().manual_seed(3))

        def dense(q_, k_, v_):  # bench.py's xla_short, on (b, h, t, d)
            s = torch.matmul(q_.float(), k_.float().transpose(-1, -2)) / math.sqrt(d)
            return torch.matmul(torch.softmax(s, -1), v_.float()).to(q_.dtype)

        def heads(x):
            return x.view(b, t, h, d).transpose(1, 2)

        def merge(x):
            return x.transpose(1, 2).reshape(b, t, h * d)

        def bench(fn, q_):  # the output and the gradient of sum(o^2) in q
            leaf = q_.detach().clone().requires_grad_()
            out = fn(leaf)
            (grad,) = torch.autograd.grad((out.float() ** 2).sum(), [leaf])
            return out.detach(), grad

        counters = all_counters()
        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        o_k, g_k = bench(lambda x: sa.short_attention(x, k, v), q)
        o_b, g_b = bench(lambda x: sa.short_attention_btd(x, k3, v3, heads=h), q3)
        hl = hd.detach().clone().requires_grad_()
        yd = fd.fused_dropout(hl, seed, 0.1)
        (gd,) = torch.autograd.grad(yd.float().sum(), [hl])
        torch.cuda.synchronize()
        counts = {c.name: c.value for c in counters}
        # ----
        want = {c.name: 0 for c in counters}
        for c in (sa.counter, sa.bwd_counter, sa.btd_counter, sa.btd_bwd_counter, fd.counter,
                  fd.bwd_counter):
            want[c.name] = 1
            self.kernels.setdefault(c.name, {})["launches"] = counts[c.name]
        self.check(counts == want, f"ops launch counts: {counts} (expected one forward and one "
                                   "backward of each of short_attention, short_attention_btd "
                                   "and fused_dropout, nothing else)")
        for name, (o, gq), (o_x, g_x) in (
                ("short_attention", (o_k, g_k), bench(lambda x: dense(x, k, v), q)),
                ("short_attention_btd", (o_b, g_b),
                 bench(lambda x: merge(dense(heads(x), heads(k3), heads(v3))), q3))):
            err_f = max_err([o], [o_x])
            gscale = float(g_x.float().abs().max())
            err_b = max_err([gq], [g_x])
            self.check(err_f <= OPS_FWD_TOL and err_b <= OPS_GRAD_TOL * max(gscale, 1.0),
                       f"ops {name} b={b} h={h} t={t} d={d} bf16 vs dense fp32 softmax: "
                       f"fwd max_abs_err={err_f:.4f} (limit {OPS_FWD_TOL}), grad max_abs_err="
                       f"{err_b:.4f} (limit {OPS_GRAD_TOL} x max(max |g| = {gscale:.3g}, 1))")
        frac = float((yd == 0).float().mean())
        mask_match = bool(torch.equal(gd != 0, yd != 0))
        lo, hi = OPS_ZERO_FRAC
        self.check(lo < frac < hi and mask_match,
                   f"ops fused_dropout {tuple(hd.shape)} bf16 rate 0.1 seed {int(seed)}: zero "
                   f"fraction {frac:.4f} (limits {lo}, {hi}); backward mask regenerated "
                   f"identically: {mask_match}")

    def check_kernels(self, cell, T, B, H, dtype, peep, mask):
        """The inference forward, the saving forward and the backward kernel
        of one cell against their plain versions, on the same inputs; the
        backward of both sides reads the plain forward's residuals."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm as fl
        mod = self.cell_module(cell)
        dname = str(dtype).replace("torch.", "")
        a = lstm_inputs(T, B, H, dtype, self.device, seed=T * 7 + B, peep=peep, mask=mask)
        fwd = (a["zx"], a["w_rec"], a["peep"], a["h0"], a["c0"], a["mask"])
        with torch.no_grad():
            got = fl.launch_lstm_fwd(*fwd, mod.counter)
            got_save = fl.launch_lstm_fwd(*fwd, mod.save_counter, save=True)
            want_save = fl.lstm_reference(*fwd, save=True)
            g = torch.Generator().manual_seed(T * 11 + B)
            cot = [torch.randn(s, generator=g).to(dtype).to(self.device)
                   for s in ((T, B, H), (B, H), (B, H))]
            gates, cseq = want_save[3], want_save[4]
            bwd = (*cot, gates, cseq, a["c0"], a["w_rec"], a["peep"], a["mask"])
            got_bwd = fl.launch_lstm_bwd(*bwd, mod.bwd_counter)
            torch.cuda.synchronize()
            want_bwd = fl.lstm_bwd_reference(*bwd)
        torch.cuda.synchronize()
        tag = f"{dname:8s} T={T:3d} B={B:3d} H={H:3d} mask={'yes' if mask else 'no '}"
        for name, got_, want_, tol, rel in (
                (mod.counter.name, got, want_save[:3], KERNEL_TOL[dname], False),
                (mod.save_counter.name, got_save, want_save, KERNEL_TOL[dname], False),
                (mod.bwd_counter.name, got_bwd, want_bwd, BWD_TOL[dname], True)):
            err = max_err(got_, want_, relative=rel)
            finite = all(bool(torch.isfinite(x.float()).all()) for x in got_)
            self.check(finite and err <= tol,
                       f"{name:22s} {tag} max_{'rel' if rel else 'abs'}_err={err:.3g} "
                       f"tol={tol:g}")
            if (T, B, H) == KERNEL_SHAPES[0] and dtype == torch.bfloat16 and not mask:
                self.kernels.setdefault(name, {})["max_abs_err"] = err
        if mask:  # an all-masked row: no gradient reaches its inputs
            zero = float(got_bwd[0][:, 0].float().abs().max())
            self.check(zero == 0.0, f"{mod.bwd_counter.name:22s} {tag} all-masked row: "
                                    f"max |ds| = {zero:g} (expected 0)")

    def check_autograd(self, cell, T, B, H, peep, mask):
        """The whole autograd wrapper in float32: gradients of every
        differentiable input against ``torch.autograd`` of the plain
        forward."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm as fl
        mod = self.cell_module(cell)
        a = lstm_inputs(T, B, H, torch.float32, self.device, seed=T + B, peep=peep, mask=mask)
        names = [k for k in ("zx", "w_rec", "peep", "h0", "c0") if a[k] is not None]
        g = torch.Generator().manual_seed(T * 13 + B)
        cot = [torch.randn(s, generator=g).to(self.device) for s in ((T, B, H), (B, H), (B, H))]
        grads = []
        for run in (self.run_wrapper(cell, mod), fl.lstm_reference):
            leaves = {k: a[k].detach().clone().requires_grad_() for k in names}
            args = {**a, **leaves}
            ys, h_t, c_t = run(args["zx"], args["w_rec"], args["peep"], args["h0"],
                               args["c0"], args["mask"])
            loss = (ys * cot[0]).sum() + (h_t * cot[1]).sum() + (c_t * cot[2]).sum()
            grads.append(torch.autograd.grad(loss, [leaves[k] for k in names]))
        torch.cuda.synchronize()
        errs = {k: max_err([x], [y], relative=True) for k, x, y in zip(names, *grads)}
        worst = max(errs.values())
        self.check(worst <= GRAD_TOL,
                   f"{cell:18s} autograd vs plain float32 T={T:3d} B={B:3d} H={H:3d} "
                   f"mask={'yes' if mask else 'no '} max_rel_err "
                   + " ".join(f"{k}={v:.3g}" for k, v in errs.items()) + f" tol={GRAD_TOL:g}")

    @staticmethod
    def cell_module(cell):
        from deeplearning4j_tpu_torch.ops.kernels import fused_gru
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm as fl
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm_graves as fg
        return {"fused_lstm": fl, "fused_graves_lstm": fg, "fused_gru": fused_gru}[cell]

    def check_gru(self, T, B, H, dtype):
        """The GRU's inference forward, saving forward (ys, hT, gates, zh_n)
        and backward (dzx, dh0) kernels against their plain versions on the
        same inputs; the backward of both sides reads the plain forward's
        residuals and ys."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_gru as fgru
        dname = str(dtype).replace("torch.", "")
        a = gru_inputs(T, B, H, dtype, self.device, seed=T * 5 + B)
        fwd = (a["zx"], a["w_rec"], a["h0"])
        with torch.no_grad():
            got = fgru.launch_gru_fwd(*fwd, fgru.counter)
            got_save = fgru.launch_gru_fwd(*fwd, fgru.save_counter, save=True)
            want_save = fgru.gru_reference(*fwd, save=True)
            g = torch.Generator().manual_seed(T * 17 + B)
            cot = [torch.randn(s, generator=g).to(dtype).to(self.device)
                   for s in ((T, B, H), (B, H))]
            ys, _, gates, zhn = want_save
            bwd = (*cot, gates, zhn, ys, a["h0"], a["w_rec"])
            got_bwd = fgru.launch_gru_bwd(*bwd, fgru.bwd_counter)
            torch.cuda.synchronize()
            want_bwd = fgru.gru_bwd_reference(*bwd)
        torch.cuda.synchronize()
        tag = f"{dname:8s} T={T:3d} B={B:3d} H={H:3d}"
        for name, got_, want_, tol, rel in (
                (fgru.counter.name, got, want_save[:2], KERNEL_TOL[dname], False),
                (fgru.save_counter.name, got_save, want_save, KERNEL_TOL[dname], False),
                (fgru.bwd_counter.name, got_bwd, want_bwd, BWD_TOL[dname], True)):
            err = max_err(got_, want_, relative=rel)
            finite = all(bool(torch.isfinite(x.float()).all()) for x in got_)
            self.check(finite and err <= tol,
                       f"{name:22s} {tag} max_{'rel' if rel else 'abs'}_err={err:.3g} "
                       f"tol={tol:g}")
            if (T, B, H) == KERNEL_SHAPES[0] and dtype == torch.bfloat16:
                self.kernels.setdefault(name, {})["max_abs_err"] = err

    def check_gru_autograd(self, T, B, H):
        """``fused_gru`` under autograd in float32 (``FusedGRUFunction``:
        saving forward + backward kernel + the dW_rec product): dzx, dW_rec
        and dh0 against ``torch.autograd`` of the plain forward."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_gru as fgru
        a = gru_inputs(T, B, H, torch.float32, self.device, seed=T + 3 * B)
        names = ["zx", "w_rec", "h0"]
        g = torch.Generator().manual_seed(T * 19 + B)
        cot = [torch.randn(s, generator=g).to(self.device) for s in ((T, B, H), (B, H))]
        before = (fgru.save_counter.value, fgru.bwd_counter.value)
        grads = []
        for run in (fgru.fused_gru, fgru.gru_reference):
            leaves = [a[k].detach().clone().requires_grad_() for k in names]
            ys, h_t = run(*leaves)
            loss = (ys * cot[0]).sum() + (h_t * cot[1]).sum()
            grads.append(torch.autograd.grad(loss, leaves))
        torch.cuda.synchronize()
        launched = (fgru.save_counter.value - before[0], fgru.bwd_counter.value - before[1])
        n_launch = -(-B // 64)  # one launch per group of at most 64 rows
        errs = {k: max_err([x], [y], relative=True) for k, x, y in zip(names, *grads)}
        self.check(max(errs.values()) <= GRAD_TOL and launched == (n_launch, n_launch),
                   f"fused_gru          autograd vs plain float32 T={T:3d} B={B:3d} H={H:3d} "
                   "max_rel_err " + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
                   + f" tol={GRAD_TOL:g}; launches (save, bwd) {launched} (expected "
                   f"{(n_launch, n_launch)})")

    def check_bidirectional_gru(self):
        """One ``Bidirectional(GRU)`` forward (float32, inference) against
        the same layer with the plain loop in place of the kernel: two
        launches, one per direction."""
        torch = self.torch
        from deeplearning4j_tpu_torch.nn import GRU, Bidirectional, GlobalConfig, InputType
        from deeplearning4j_tpu_torch.ops.kernels import fused_gru as fgru
        T, B, n_in = BIDI_SHAPE
        layer = Bidirectional(layer=GRU(n_out=HIDDEN))
        layer._g = GlobalConfig()
        params, _ = layer.init(torch.Generator().manual_seed(11),
                               InputType.recurrent(n_in, T), layer._g)
        params = {d: {k: v.to(self.device) for k, v in p.items()} for d, p in params.items()}
        x = torch.randn(B, T, n_in, generator=torch.Generator().manual_seed(12)).to(self.device)
        with torch.inference_mode():
            before = fgru.counter.value
            got, _ = layer.forward(params, {}, x)
            torch.cuda.synchronize()
            launched = fgru.counter.value - before
            with plain_recurrences():
                want, _ = layer.forward(params, {}, x)
        err = max_err([got], [want])
        self.check(got.shape == (B, T, 2 * HIDDEN) and err <= KERNEL_TOL["float32"]
                   and launched == 2,
                   f"Bidirectional(GRU) float32 T={T} B={B} H={HIDDEN} vs plain loop: "
                   f"max_abs_err={err:.3g} tol={KERNEL_TOL['float32']:g}; {launched} "
                   "launches (expected 2)")

    @staticmethod
    def run_wrapper(cell, mod):
        """The public wrapper with the (zx, w_rec, peep, h0, c0, mask)
        argument list."""
        if cell == "fused_lstm":
            return lambda zx, w, p, h0, c0, m: mod.fused_lstm(zx, w, h0, c0)
        return mod.fused_graves_lstm

    def plain_forward(self, net, x):
        """The network's forward with every kernel replaced by its plain
        version: the reference the served answers are held against."""
        torch = self.torch
        from deeplearning4j_tpu_torch.nn.base import cast_floating
        from deeplearning4j_tpu_torch.nn.recurrent_layers import GRU, LSTM
        from deeplearning4j_tpu_torch.ops.kernels.fused_gru import gru_reference
        from deeplearning4j_tpu_torch.ops.kernels.fused_lstm import lstm_reference
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        cdt = get_environment().compute_dtype
        h = torch.as_tensor(x, device=net.device).to(cdt)
        params = cast_floating(net.params(), cdt)
        with torch.inference_mode():
            for i, layer in enumerate(net.layers):
                p = params[layer.name or f"layer_{i}"]
                if isinstance(layer, LSTM):
                    zx = torch.matmul(h.transpose(0, 1), p["W"]) + p["b"]
                    zero = torch.zeros(h.shape[0], layer.n_out, dtype=cdt, device=h.device)
                    ys, _, _ = lstm_reference(zx, p["W_rec"], p.get("peephole"), zero,
                                              zero, None)
                    h = ys.transpose(0, 1)
                elif isinstance(layer, GRU):
                    zx = torch.matmul(h.transpose(0, 1), p["W"]) + p["b"]
                    zero = torch.zeros(h.shape[0], layer.n_out, dtype=cdt, device=h.device)
                    h = gru_reference(zx, p["W_rec"], zero)[0].transpose(0, 1)
                else:
                    h = layer.activate(p, h)
        return h.float().cpu().numpy()

    def slice_phase(self, cell, workdir):
        """The char-RNN of ``cell`` (``CHAR_RNN_TAGS``) served at full width:
        random weights from the seed, bf16 compute, written to an archive,
        loaded by ``ModelRegistry.load`` and served to 8 client threads;
        every answer against the plain forward, the launch counts, chunked
        ``rnn_time_step``, and the p50 of one 64-row request."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.serving import ModelRegistry

        get_environment().allow_bfloat16()
        kernel = self.cell_module(CHAR_RNN_KERNELS[cell])
        tag = CHAR_RNN_TAGS[cell]
        net = MultiLayerNetwork(char_rnn_conf(cell, SERVE_T), device=self.device).init()
        path = os.path.join(workdir, f"char-rnn-{cell}.zip")
        ModelSerializer.write_model(net, path)
        reg = ModelRegistry()
        served = reg.load("char-rnn", path, device=self.device, max_batch_size=SERVE_B,
                          batch_timeout_ms=5.0)
        rng = np.random.default_rng(CHAR_RNN_SEEDS[cell] + 1234)
        rows = rng.integers(1, SERVE_B + 1, (CLIENTS, REQUESTS_PER_CLIENT))
        rows[0, 0], rows[1, 0] = 1, SERVE_B
        eye = np.eye(VOCAB, dtype=np.float32)
        reqs = [[eye[rng.integers(0, VOCAB, (int(n), SERVE_T))] for n in r] for r in rows]
        answers = [[None] * REQUESTS_PER_CLIENT for _ in range(CLIENTS)]
        lat = []
        errors = []
        lat_lock = threading.Lock()

        def client(c):
            try:
                for k, x in enumerate(reqs[c]):
                    t0 = time.perf_counter()
                    answers[c][k] = reg.predict("char-rnn", x)
                    with lat_lock:
                        lat.append(time.perf_counter() - t0)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,), name=f"smoke-client-{c}")
                   for c in range(CLIENTS)]
        counters = all_counters()
        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.name: c.value for c in counters}
        # ----
        batches = served.batcher.batches
        launched = counts[kernel.counter.name]
        self.check(not errors, f"{tag} serving: {len(lat)} requests answered, errors={errors}")
        want = {c.name: 0 for c in counters}
        want[kernel.counter.name] = LAYERS * batches
        self.check(counts == want,
                   f"{tag} launch counts over the serving run: {kernel.counter.name}="
                   f"{launched} (expected {LAYERS} layers x {batches} batches), every other "
                   f"kernel 0: {counts}")
        self.kernels.setdefault(kernel.counter.name, {})["launches"] = launched
        log(f"{tag} {kernel.counter.name}: {launched / max(1, len(lat)):.2f} launches per "
            f"request, {launched / max(1, batches):.2f} per batch")
        worst = 0.0
        for c in range(CLIENTS):
            for k, x in enumerate(reqs[c]):
                got = answers[c][k]
                n = x.shape[0]
                bucket = next(b for b in served.batcher.buckets if b >= n)
                padded = np.zeros((bucket,) + x.shape[1:], np.float32)
                padded[:n] = x
                want = self.plain_forward(served.model, padded)[:n]
                ok = got is not None and got.shape == (n, SERVE_T, VOCAB) and \
                    bool(np.isfinite(got).all())
                worst = max(worst, float(np.abs(got - want).max()) if ok else float("inf"))
        self.check(worst <= SERVE_TOL,
                   f"{tag} {CLIENTS * REQUESTS_PER_CLIENT} served answers vs plain forward: "
                   f"max_abs_err={worst:.3g} tol={SERVE_TOL:g}")
        total_rows = int(rows.sum())
        lat_ms = sorted(1e3 * v for v in lat)
        log(f"{tag} serving: {len(lat)} requests, {total_rows} rows x {SERVE_T} steps in "
            f"{wall:.3f} s over {batches} batches (buckets {served.batcher.bucket_counts}); "
            f"latency p50 {lat_ms[len(lat_ms) // 2]:.2f} ms, max {lat_ms[-1]:.2f} ms; "
            f"{total_rows * SERVE_T / wall:.0f} tokens/s")

        # rnn_time_step in 4 chunks of 64 steps == the whole sequence
        model = served.model
        x = reqs[1][0][:8]
        whole = model.output(x).float().cpu().numpy()
        model.rnn_clear_previous_state()
        before = kernel.counter.value
        chunks = [model.rnn_time_step(x[:, s:s + 64]).float().cpu().numpy()
                  for s in range(0, SERVE_T, 64)]
        model.rnn_clear_previous_state()
        err = float(np.abs(np.concatenate(chunks, axis=1) - whole).max())
        self.check(err <= CHUNK_TOL and kernel.counter.value - before == LAYERS * 4,
                   f"{tag} rnn_time_step 4 x 64 steps vs whole sequence: "
                   f"max_abs_err={err:.3g} tol={CHUNK_TOL:g}; "
                   f"{kernel.counter.value - before} launches (expected {LAYERS * 4})")

        # one full-bucket request alone: latency and tokens/s
        x = reqs[1][0]  # SERVE_B rows
        reg.predict("char-rnn", x)  # warm-up
        ms = []
        for _ in range(20):
            t0 = time.perf_counter()
            reg.predict("char-rnn", x)
            ms.append(1e3 * (time.perf_counter() - t0))
        ms.sort()
        p50 = ms[len(ms) // 2]
        self.serve_p50_ms[cell] = p50
        log(f"{tag} one {SERVE_B}-row request at a time, {len(ms)} requests: p50 "
            f"{p50:.2f} ms (min {ms[0]:.2f}, max {ms[-1]:.2f}), "
            f"{SERVE_B * SERVE_T / p50 * 1e3:.0f} tokens/s at p50")
        reg.shutdown()
        self.check(not served.batcher._worker.is_alive(), f"{tag} registry shut down")

    def bert_phase(self, workdir):
        """BERT-base serving at full width: ``Bert.base()`` from its zoo
        seed, bf16 compute over fp32 weights, written to an archive, loaded
        by ``ModelRegistry.load`` and served to 8 client threads sending
        1-64 rows of T=128 token ids. Every answer against the forward built
        from the plain versions; 12 flash launches per batch; masked rows
        against the same rows cut to their tokens; p50 of one 64-row request
        and samples/s."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ModelSerializer
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.serving import ModelRegistry
        from deeplearning4j_tpu_torch.zoo import Bert

        get_environment().allow_bfloat16()
        t0 = time.perf_counter()
        net = Bert.base().init(device=self.device)
        path = os.path.join(workdir, "bert-base.zip")
        ModelSerializer.write_model(net, path)
        del net
        t1 = time.perf_counter()
        reg = ModelRegistry()
        served = reg.load("bert", path, device=self.device, max_batch_size=BERT_B,
                          batch_timeout_ms=5.0)
        log(f"bert: init + write_model {t1 - t0:.1f} s ({os.path.getsize(path) / 1e6:.0f} MB "
            f"archive), ModelRegistry.load {time.perf_counter() - t1:.1f} s")
        rng = np.random.default_rng(4321)
        rows = rng.integers(1, BERT_B + 1, (CLIENTS, REQUESTS_PER_CLIENT))
        rows[0, 0], rows[1, 0] = 1, BERT_B
        reqs = [[rng.integers(0, BERT_VOCAB, (int(n), BERT_T)) for n in r] for r in rows]
        answers = [[None] * REQUESTS_PER_CLIENT for _ in range(CLIENTS)]
        lat, errors = [], []
        lat_lock = threading.Lock()

        def client(c):
            try:
                for k, x in enumerate(reqs[c]):
                    t_req = time.perf_counter()
                    answers[c][k] = reg.predict("bert", x)
                    with lat_lock:
                        lat.append(time.perf_counter() - t_req)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,), name=f"smoke-bert-{c}")
                   for c in range(CLIENTS)]
        counters = all_counters()
        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.name: c.value for c in counters}
        # ----
        batches = served.batcher.batches
        self.check(not errors, f"bert serving: {len(lat)} requests answered, errors={errors}")
        want = {c.name: 0 for c in counters}
        want[fa.counter.name] = BERT_LAYERS * batches
        self.check(counts == want, f"bert launch counts over the serving run: {counts} "
                                   f"(expected {BERT_LAYERS} layers x {batches} batches of "
                                   f"{fa.counter.name}, nothing else)")
        self.kernels.setdefault(fa.counter.name, {})["launches"] = counts[fa.counter.name]
        model = served.model
        worst = 0.0
        with plain_attention():
            for c in range(CLIENTS):
                for k, x in enumerate(reqs[c]):
                    got, n = answers[c][k], x.shape[0]
                    bucket = next(b for b in served.batcher.buckets if b >= n)
                    padded = np.zeros((bucket, BERT_T), x.dtype)
                    padded[:n] = x
                    want_p = model.output(padded).float().cpu().numpy()[:n]
                    ok = got is not None and got.shape == (n, 2) and bool(np.isfinite(got).all())
                    worst = max(worst, float(np.abs(got - want_p).max()) if ok else float("inf"))
        self.check(worst <= BERT_TOL,
                   f"bert {CLIENTS * REQUESTS_PER_CLIENT} served answers vs plain forward: "
                   f"max_abs_err={worst:.3g} tol={BERT_TOL:g}")
        total_rows = int(rows.sum())
        lat_ms = sorted(1e3 * v for v in lat)
        log(f"bert serving: {len(lat)} requests, {total_rows} rows x {BERT_T} tokens in "
            f"{wall:.3f} s over {batches} batches (buckets {served.batcher.bucket_counts}); "
            f"latency p50 {lat_ms[len(lat_ms) // 2]:.2f} ms, max {lat_ms[-1]:.2f} ms; "
            f"{total_rows / wall:.0f} samples/s")

        # masked rows == the same rows cut to their tokens
        lengths = [1, 2, 7, 31, 64, 100, 127, BERT_T]
        x = reqs[1][0][:len(lengths)]
        m = (np.arange(BERT_T)[None, :] < np.array(lengths)[:, None]).astype(np.float32)
        before = fa.counter.value
        full = model.output(x, mask=m).float().cpu().numpy()
        err = max(float(np.abs(full[i] - model.output(x[i:i + 1, :n]).float().cpu().numpy()[0])
                        .max()) for i, n in enumerate(lengths))
        launched = fa.counter.value - before
        self.check(err <= BERT_TOL and launched == BERT_LAYERS * (1 + len(lengths)),
                   f"bert masked output vs rows cut to lengths {lengths}: max_abs_err={err:.3g} "
                   f"tol={BERT_TOL:g}; {launched} launches (expected "
                   f"{BERT_LAYERS * (1 + len(lengths))})")

        # one full-bucket request at a time: latency and samples/s
        x = reqs[1][0]  # BERT_B rows
        reg.predict("bert", x)  # warm-up
        ms = []
        for _ in range(20):
            t_req = time.perf_counter()
            reg.predict("bert", x)
            ms.append(1e3 * (time.perf_counter() - t_req))
        ms.sort()
        self.bert_p50_ms = ms[len(ms) // 2]
        log(f"bert one {BERT_B}-row T={BERT_T} request at a time, {len(ms)} requests: p50 "
            f"{self.bert_p50_ms:.2f} ms (min {ms[0]:.2f}, max {ms[-1]:.2f}), "
            f"{BERT_B / self.bert_p50_ms * 1e3:.0f} samples/s at p50")
        self.device_breakdown(lambda: model.output(x), f"bert {BERT_B}-row output")
        reg.shutdown()
        self.check(not served.batcher._worker.is_alive(), "bert registry shut down")

    def profile_kernels(self, fn, reps):
        """``torch.profiler`` over ``reps`` calls of ``fn`` (after one
        warm-up call): ``{kernel name: (device ms per call, launches per
        call)}`` and the host wall ms per call under the profiler."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        per = {}
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                dev = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                per[e.key] = (dev / 1e3 / reps, e.count // reps)
        return per, wall

    def device_breakdown(self, fn, what, reps=5, step_ms=None):
        """Device busy time per call of ``fn`` (the sum of its kernels'
        device time, so idle gaps between kernels are not in it), the
        kernels that take most of it, and the busy share of the host wall
        time of the same calls under the profiler (whose own host cost is
        in that wall time) and, given ``step_ms``, of that wall time
        measured without the profiler."""
        per, wall = self.profile_kernels(fn, reps)
        busy = sum(ms for ms, _ in per.values())
        if busy <= 0:
            log(f"{what}: the profiler saw no device time (not measured)")
            return
        top = sorted(per.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
        share = "" if step_ms is None else \
            f"; busy {100 * busy / step_ms:.0f}% of the {step_ms:.2f} ms step measured without it"
        log(f"{what}: device busy {busy:.3f} ms per call over {reps} calls, "
            f"{sum(n for _, n in per.values())} kernels per call; host wall under the "
            f"profiler {wall:.3f} ms per call (busy {100 * busy / wall:.0f}%){share}; top kernels: "
            + "; ".join(f"{k[:60]} {ms:.3f} ms x{n}" for k, (ms, n) in top))

    def train_phase(self, cell):
        """``fit`` of the full-width char-RNN of ``cell`` in bf16 through the
        kernels (the main path, counted), then the first steps again in
        float32 and bfloat16 against a trainer built from the plain
        versions."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        env = get_environment()
        kernel = self.cell_module(CHAR_RNN_KERNELS[cell])
        tag = CHAR_RNN_TAGS[cell]
        conf = lambda: char_rnn_conf(cell, TRAIN_T)  # noqa: E731
        init = MultiLayerNetwork(conf(), device=self.device).init().params()
        batches = char_batches(TRAIN_STEPS, seed=77 + CHAR_RNN_SEEDS[cell])
        counters = all_counters()

        def fit(steps, dtype):
            env.set_compute_dtype(dtype)
            net = MultiLayerNetwork(conf(), device=self.device).init(params=clone_tree(init))
            scores, stamps = CollectScoresListener(), []
            net.set_listeners(scores, StepStamps(stamps))
            net.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches[:steps]]))
            return [v for _, v in scores.scores], stamps

        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        losses, stamps = fit(TRAIN_STEPS, torch.bfloat16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.name: c.value for c in counters}
        # ----
        want = {c.name: 0 for c in counters}
        want[kernel.save_counter.name] = want[kernel.bwd_counter.name] = LAYERS * TRAIN_STEPS
        self.check(counts == want, f"{tag} train launch counts over {TRAIN_STEPS} steps: "
                                   f"{counts} (expected {want})")
        for c in (kernel.save_counter, kernel.bwd_counter):
            self.kernels.setdefault(c.name, {})["launches"] = counts[c.name]
        finite = all(np.isfinite(v) for v in losses)
        tail = sum(losses[-3:]) / 3
        self.check(finite and len(losses) == TRAIN_STEPS and tail < LOSS_FALL * losses[0],
                   f"{tag} bf16 loss {losses[0]:.4f} -> mean of the last 3 {tail:.4f} over "
                   f"{len(losses)} steps (must fall below {LOSS_FALL} x the first): "
                   + " ".join(f"{v:.4f}" for v in losses))
        step_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
        med = step_ms[len(step_ms) // 2]
        self.train_step_ms[cell] = med
        log(f"{tag} train: {TRAIN_STEPS} steps of B={TRAIN_B} T={TRAIN_T} in {wall:.3f} s; "
            f"step ms after the first: median {med:.2f} (min {step_ms[0]:.2f}, max "
            f"{step_ms[-1]:.2f}); {TRAIN_B * TRAIN_T / med * 1e3:.0f} tokens/s at the median; "
            f"first step {1e3 * (stamps[0] - t0):.1f} ms")

        # ---- kernels vs the plain trainer, the first CMP_STEPS steps
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            got = losses[:CMP_STEPS] if dtype == torch.bfloat16 else fit(CMP_STEPS, dtype)[0]
            with plain_recurrences():
                want_l = fit(CMP_STEPS, dtype)[0]
            err = max(abs(a - b) for a, b in zip(got, want_l))
            self.check(err <= TRAIN_TOL[dname],
                       f"{tag} {dname} first {CMP_STEPS} losses, kernels "
                       f"{' '.join(f'{v:.5f}' for v in got)} vs plain "
                       f"{' '.join(f'{v:.5f}' for v in want_l)}: max_abs_err={err:.3g} "
                       f"tol={TRAIN_TOL[dname]:g}")
        env.allow_bfloat16()

    def bert_train_phase(self):
        """``fit`` of ``Bert.base()`` at bench_zoo_bert's step (B=64, T=128,
        an all-ones features mask, Adam(2e-5), dropout 0.1, bf16 compute
        over fp32 weights, random ids) through the kernels: the main path,
        counted. Then a device-busy breakdown of one step, the first steps
        again in float32 and bfloat16 against a trainer whose attention runs
        the plain versions, a fit on labels the net can learn in 20 steps,
        and the statistics of the dropout masks the card draws."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.nn.base import keep_mask
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.zoo import Bert
        env = get_environment()
        t0 = time.perf_counter()
        init = Bert.base().init(device=self.device).params()
        torch.cuda.synchronize()
        log(f"bert train: Bert.base() init {time.perf_counter() - t0:.1f} s")
        batches = label_batches(BERT_TRAIN_STEPS, 99, random_ids)
        fmask = np.ones((BERT_B, BERT_T), np.float32)
        counters = all_counters()

        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        losses, stamps, net = self.bert_fit(init, batches, torch.bfloat16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.name: c.value for c in counters}
        # ----
        want = {c.name: 0 for c in counters}
        for c in (fa.lse_counter, fa.bwd_dq_counter, fa.bwd_dkv_counter):
            want[c.name] = BERT_LAYERS * BERT_TRAIN_STEPS
            self.kernels.setdefault(c.name, {})["launches"] = counts[c.name]
        self.check(counts == want, f"bert train launch counts over {BERT_TRAIN_STEPS} steps: "
                                   f"{counts} (expected {want})")
        finite = all(np.isfinite(v) for v in losses) and len(losses) == BERT_TRAIN_STEPS
        step_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
        med = step_ms[len(step_ms) // 2]
        self.bert_train_step_ms = med
        log(f"bert train: {BERT_TRAIN_STEPS} steps of B={BERT_B} T={BERT_T} in {wall:.3f} s; "
            f"losses " + " ".join(f"{v:.4f}" for v in losses) + "; "
            f"step ms after the first: median {med:.2f} (min {step_ms[0]:.2f}, max "
            f"{step_ms[-1]:.2f}); {BERT_B / med * 1e3:.0f} samples/s at the median; first step "
            f"{1e3 * (stamps[0] - t0):.1f} ms; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
        x, y = batches[0]
        self.device_breakdown(lambda: net.fit(x, y, mask=fmask), "bert train step", reps=3,
                              step_ms=med)
        del net
        torch.cuda.empty_cache()

        # ---- kernels vs the plain trainer, the first BERT_CMP_STEPS steps
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            got = losses[:BERT_CMP_STEPS] if dtype == torch.bfloat16 else \
                self.bert_fit(init, batches[:BERT_CMP_STEPS], dtype)[0]
            with plain_attention():
                want_l = self.bert_fit(init, batches[:BERT_CMP_STEPS], dtype)[0]
            torch.cuda.empty_cache()
            err = max(abs(a - b) for a, b in zip(got, want_l))
            self.check(err <= BERT_TRAIN_TOL[dname],
                       f"bert train {dname} first {BERT_CMP_STEPS} losses, kernels "
                       f"{' '.join(f'{v:.5f}' for v in got)} vs plain "
                       f"{' '.join(f'{v:.5f}' for v in want_l)}: max_abs_err={err:.3g} "
                       f"tol={BERT_TRAIN_TOL[dname]:g}")

        # ---- learning: a second fit, on every_token's labels
        losses_l, _, net = self.bert_fit(init, label_batches(BERT_TRAIN_STEPS, 99, every_token),
                                         torch.bfloat16)
        tail = sum(losses_l[-3:]) / 3
        limit = BERT_LOSS_FALL * min(losses_l[0], math.log(2))
        acc = self.accuracy(net, label_batches(1, 7, every_token)[0])
        self.check(finite and all(np.isfinite(v) for v in losses_l) and tail < limit
                   and acc >= BERT_MIN_ACC,
                   f"bert train bf16 loss (main path finite over {len(losses)} steps): "
                   f"every_token's first {losses_l[0]:.4f} -> mean of the last 3 {tail:.4f} "
                   f"(must fall below {BERT_LOSS_FALL} x min(first, ln 2) = {limit:.4f}); "
                   f"accuracy on a fresh batch {acc:.3f} (must be >= {BERT_MIN_ACC}): "
                   + " ".join(f"{v:.4f}" for v in losses_l))
        del net
        torch.cuda.empty_cache()
        env.allow_bfloat16()

        # ---- dropout masks drawn on the card: keep share and determinism
        act = torch.ones(BERT_B, BERT_T, 768, device=self.device)
        masks = [keep_mask(act, 0.9, torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
        share = float(masks[0].float().mean())
        self.check(masks[0].device.type == "cuda" and abs(share - 0.9) < 1e-3
                   and bool(torch.equal(masks[0], masks[1]))
                   and not bool(torch.equal(masks[0], masks[2])),
                   f"dropout keep mask on the card: keep share {share:.5f} (expected 0.9 +- "
                   f"1e-3 over {act.numel()} draws), same seed same mask, other seed another")

    def bert_fit(self, init, batches, dtype):
        """``fit`` of ``Bert.base()`` from the parameters ``init`` over
        ``batches`` (all-ones features mask) with ``dtype`` compute: the
        per-step losses, the host clock at each step's end, the network."""
        import numpy as np
        from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        from deeplearning4j_tpu_torch.zoo import Bert
        get_environment().set_compute_dtype(dtype)
        net = MultiLayerNetwork(Bert.base().conf(), device=self.device).init(
            params=clone_tree(init))
        scores, stamps = CollectScoresListener(), []
        net.set_listeners(scores, StepStamps(stamps))
        fmask = np.ones((BERT_B, BERT_T), np.float32)
        net.fit(ListDataSetIterator([DataSet(x, y, features_mask=fmask) for x, y in batches]))
        return [v for _, v in scores.scores], stamps, net

    def accuracy(self, net, batch):
        """Share of ``batch``'s rows whose label ``net`` predicts."""
        import numpy as np
        x, y = batch
        with self.torch.inference_mode():
            out = net.output(x, mask=np.ones(x.shape, np.float32))
        return float((out.float().argmax(1).cpu().numpy() == y.argmax(1)).mean())

    def label_rules_phase(self):
        """BERT_TRAIN_STEPS bf16 steps of ``Bert.base()`` from one init under
        each of LABEL_RULES: the first loss, the mean of the last 3, and the
        trained net's accuracy on a fresh batch of the same rule."""
        from deeplearning4j_tpu_torch.zoo import Bert
        init = Bert.base().init(device=self.device).params()
        for name, rule, prior, repeat in LABEL_RULES:
            batches = label_batches(BERT_TRAIN_STEPS, 99, rule, prior, repeat)
            losses, _, net = self.bert_fit(init, batches, self.torch.bfloat16)
            acc = self.accuracy(net, label_batches(1, 7, rule, prior)[0])
            log(f"label rule '{name}' (prior {prior}): first {losses[0]:.4f}, mean of the "
                f"last 3 {sum(losses[-3:]) / 3:.4f}, accuracy on a fresh batch {acc:.3f}: "
                + " ".join(f"{v:.4f}" for v in losses))
            del net
            self.torch.cuda.empty_cache()
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        get_environment().allow_bfloat16()

    def times_phase(self):
        """Each kernel's time at the serving/training shape, bf16, with the
        main path's arguments (GravesLSTM: peepholes, no mask), beside its
        bound, its plain version's time and, for the plain cell, cuDNN's."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm as fl
        T, B, H = KERNEL_SHAPES[0]
        dt = torch.bfloat16
        cudnn = self.cudnn_ms(torch.nn.LSTM, T, B, H, dt)
        log(f"torch.nn.LSTM (cuDNN), layer 0's work incl. its input projection, T={T} B={B} "
            f"H={H} bf16: inference {cudnn['infer']:.3f} ms, training forward "
            f"{cudnn['fwd']:.3f} ms + backward {cudnn['bwd']:.3f} ms = "
            f"{cudnn['fwd'] + cudnn['bwd']:.3f} ms")
        pallas = "deeplearning4j_tpu/ops/pallas/"
        specs = [("fused_graves_lstm", True, pallas + "fused_lstm_graves.py:146",
                  pallas + "fused_lstm_graves.py:241"),
                 ("fused_lstm", False, pallas + "fused_lstm.py:162", pallas + "fused_lstm.py:242")]
        csrc = "deeplearning4j_tpu_torch/ops/kernels/csrc/"
        for cell, peep, fwd_line, bwd_line in specs:
            mod = self.cell_module(cell)
            a = lstm_inputs(T, B, H, dt, self.device, seed=5, peep=peep, mask=False)
            fwd = (a["zx"], a["w_rec"], a["peep"], a["h0"], a["c0"], None)
            outs = fl.launch_lstm_fwd(*fwd, mod.save_counter, save=True)
            g = torch.Generator().manual_seed(6)
            cot = [torch.randn(s_, generator=g).to(dt).to(self.device)
                   for s_ in ((T, B, H), (B, H), (B, H))]
            bwd = (*cot, outs[3], outs[4], a["c0"], a["w_rec"], a["peep"], None)
            grads = fl.launch_lstm_bwd(*bwd, mod.bwd_counter)
            rows = [
                (mod.counter.name, "lstm_fwd.cu", fwd_line, fwd, outs[:3],
                 lambda: fl.launch_lstm_fwd(*fwd, mod.counter),
                 lambda: fl.lstm_reference(*fwd), cudnn["infer"]),
                (mod.save_counter.name, "lstm_fwd.cu", fwd_line, fwd, outs,
                 lambda: fl.launch_lstm_fwd(*fwd, mod.save_counter, save=True),
                 lambda: fl.lstm_reference(*fwd, save=True), cudnn["fwd"]),
                (mod.bwd_counter.name, "lstm_bwd.cu", bwd_line, bwd, grads,
                 lambda: fl.launch_lstm_bwd(*bwd, mod.bwd_counter),
                 lambda: fl.lstm_bwd_reference(*bwd), cudnn["bwd"]),
            ]
            for name, src, replaces, ins, outs_, kern, plain, lib in rows:
                ms = cuda_ms(kern, reps=10)
                plain_ms = cuda_ms(plain, reps=3, warmup=1)
                bound_ms, bound_by = bound(list(ins) + list(outs_), 2.0 * T * B * H * 4 * H, dt)
                library_ms = None if peep else lib
                self.kernels.setdefault(name, {}).update({
                    "name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms})
                log(f"{name}: {ms:.3f} ms per launch at T={T} B={B} H={H} bf16; bound "
                    f"{bound_ms:.4f} ms ({bound_by}); plain version {plain_ms:.3f} ms; "
                    f"library {'n/a' if library_ms is None else f'{library_ms:.3f} ms'}")
            step = self.train_step_ms.get("graves" if peep else "lstm")
            if step is not None:
                kms = LAYERS * (self.kernels[mod.save_counter.name]["ms"]
                                + self.kernels[mod.bwd_counter.name]["ms"])
                log(f"graves={peep} training step: the recurrent kernels take {LAYERS} x "
                    f"(forward + backward) = {kms:.2f} ms of the {step:.2f} ms median step "
                    f"({100 * kms / step:.0f}%)")
        self.gru_times()
        self.flash_times()
        self.dropout_times()
        self.short_times()

    def gru_times(self):
        """The GRU kernels' time at B=64, T=256, H=512 bf16 (CUDA events,
        after warm-up) beside the bound, the plain versions and
        ``torch.nn.GRU`` (cuDNN, the same reset-after cell; a yardstick the
        port never calls); their share of a serving request and of a
        training step."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_gru as fgru
        T, B, H = KERNEL_SHAPES[0]
        dt = torch.bfloat16
        cudnn = self.cudnn_ms(torch.nn.GRU, T, B, H, dt)
        log(f"torch.nn.GRU (cuDNN), layer 0's work incl. its input projection, T={T} B={B} "
            f"H={H} bf16: inference {cudnn['infer']:.3f} ms, training forward "
            f"{cudnn['fwd']:.3f} ms + backward {cudnn['bwd']:.3f} ms = "
            f"{cudnn['fwd'] + cudnn['bwd']:.3f} ms")
        a = gru_inputs(T, B, H, dt, self.device, seed=5)
        fwd = (a["zx"], a["w_rec"], a["h0"])
        outs = fgru.launch_gru_fwd(*fwd, fgru.save_counter, save=True)
        g = torch.Generator().manual_seed(6)
        cot = [torch.randn(s_, generator=g).to(dt).to(self.device) for s_ in ((T, B, H), (B, H))]
        bwd = (*cot, outs[2], outs[3], outs[0], a["h0"], a["w_rec"])
        grads = fgru.launch_gru_bwd(*bwd, fgru.bwd_counter)
        pallas = "deeplearning4j_tpu/ops/pallas/fused_gru.py"
        csrc = "deeplearning4j_tpu_torch/ops/kernels/csrc/"
        rows = [(fgru.counter.name, "gru_fwd.cu", f"{pallas}:147", fwd, outs[:2],
                 lambda: fgru.launch_gru_fwd(*fwd, fgru.counter),
                 lambda: fgru.gru_reference(*fwd), cudnn["infer"]),
                (fgru.save_counter.name, "gru_fwd.cu", f"{pallas}:147", fwd, outs,
                 lambda: fgru.launch_gru_fwd(*fwd, fgru.save_counter, save=True),
                 lambda: fgru.gru_reference(*fwd, save=True), cudnn["fwd"]),
                (fgru.bwd_counter.name, "gru_bwd.cu", f"{pallas}:224", bwd, grads,
                 lambda: fgru.launch_gru_bwd(*bwd, fgru.bwd_counter),
                 lambda: fgru.gru_bwd_reference(*bwd), cudnn["bwd"])]
        for name, src, replaces, ins, outs_, kern, plain, lib in rows:
            ms = cuda_ms(kern, reps=10)
            plain_ms = cuda_ms(plain, reps=3, warmup=1)
            bound_ms, bound_by = bound(list(ins) + list(outs_), 2.0 * T * B * H * 3 * H, dt)
            self.kernels.setdefault(name, {}).update({
                "name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib})
            log(f"{name}: {ms:.3f} ms per launch at T={T} B={B} H={H} bf16; bound "
                f"{bound_ms:.4f} ms ({bound_by}); plain version {plain_ms:.3f} ms; "
                f"torch.nn.GRU {lib:.3f} ms")
        infer = LAYERS * self.kernels[fgru.counter.name]["ms"]
        if "gru" in self.serve_p50_ms:
            p50 = self.serve_p50_ms["gru"]
            log(f"gru one {SERVE_B}-row request: the {LAYERS} GRU launches take {infer:.2f} ms "
                f"of the {p50:.2f} ms p50 ({100 * infer / p50:.0f}%)")
        if "gru" in self.train_step_ms:
            step = self.train_step_ms["gru"]
            kms = LAYERS * (self.kernels[fgru.save_counter.name]["ms"]
                            + self.kernels[fgru.bwd_counter.name]["ms"])
            log(f"gru training step: the GRU kernels take {LAYERS} x (forward + backward) = "
                f"{kms:.2f} ms of the {step:.2f} ms median step ({100 * kms / step:.0f}%)")

    def flash_times(self):
        """The flash kernel's time in bf16 at BERT-base serving's shape
        without a mask (the main path's arguments: served requests carry
        none) and with one, and at the long-context causal shape: beside
        its bound, the saving instance, the plain version and
        ``scaled_dot_product_attention`` with the same mask or
        ``is_causal`` (a yardstick the port never calls); then attention's
        share of one 64-row request."""
        torch = self.torch
        import torch.nn.functional as F
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        dt = torch.bfloat16
        main = None
        for shape in (FLASH_SHAPES[0], FLASH_SHAPES[1], FLASH_SHAPES[2]):
            b, h, t_q, t_k, d, d_v, masked, causal = shape
            (q, k, v), mask = flash_inputs(b, h, t_q, t_k, d, d_v, dt, self.device, seed=9,
                                           mask=masked)
            bias = fa.key_bias(mask, b, t_k)
            with torch.no_grad():
                o = fa.launch_flash_fwd(q, k, v, bias, causal, fa.counter)
                ms = cuda_ms(lambda: fa.launch_flash_fwd(q, k, v, bias, causal, fa.counter),
                             reps=20)
                lse_ms = cuda_ms(lambda: fa.launch_flash_fwd(q, k, v, bias, causal,
                                                             fa.lse_counter, save=True), reps=20)
                plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, mask, causal),
                                   reps=3, warmup=1)
                sdpa_mask = None if mask is None else mask[:, None, None, :]
                sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=sdpa_mask, is_causal=causal), reps=20)
            flops = 2.0 * attention_pairs(b, h, t_q, t_k, mask, causal) * (d + d_v)
            bound_ms, bound_by = bound([q, k, v, o, bias], flops, dt)
            log(f"{fa.counter.name}: {ms:.4f} ms per launch at b={b} h={h} t_q={t_q} t_k={t_k} "
                f"d={d} bf16 mask={'yes' if masked else 'no'} causal={'yes' if causal else 'no'}; "
                f"bound {bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.2f} GFLOP); saving instance "
                f"{lse_ms:.4f} ms; plain version {plain_ms:.3f} ms; "
                f"scaled_dot_product_attention {sdpa_ms:.4f} ms")
            if main is None:
                main = ms
                self.kernels.setdefault(fa.counter.name, {}).update({
                    "name": fa.counter.name, "route": "cuda",
                    "source": "deeplearning4j_tpu_torch/ops/kernels/csrc/flash_fwd.cu",
                    "replaces": "deeplearning4j_tpu/ops/pallas/flash_attention.py:226",
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": sdpa_ms})
            if shape == FLASH_SHAPES[1]:  # masked: the saving instance as trained
                with torch.no_grad():
                    saved = fa.launch_flash_fwd(q, k, v, bias, causal, fa.lse_counter, save=True)
                lse_bound, lse_by = bound([q, k, v, bias, *saved], flops, dt)
                self.flash_lse_ms = lse_ms
                self.kernels.setdefault(fa.lse_counter.name, {}).update({
                    "name": fa.lse_counter.name, "route": "cuda",
                    "source": "deeplearning4j_tpu_torch/ops/kernels/csrc/flash_fwd.cu",
                    "replaces": "deeplearning4j_tpu/ops/pallas/flash_attention.py:226",
                    "ms": lse_ms, "plain_ms": plain_ms, "bound_ms": lse_bound,
                    "bound_by": lse_by, "library_ms": sdpa_ms})
        if self.bert_p50_ms is not None:
            share = BERT_LAYERS * main
            log(f"bert one {BERT_B}-row request: the {BERT_LAYERS} flash launches take "
                f"{share:.3f} ms of the {self.bert_p50_ms:.2f} ms p50 "
                f"({100 * share / self.bert_p50_ms:.1f}%)")
        self.flash_bwd_times()

    def flash_bwd_times(self):
        """The backward pair's time in bf16 (CUDA events) at BERT-base's
        shape with a mask (as trained: the features mask makes a bias) and
        without, at the long-context causal shape, and at T=16384 causal
        (row 9's regime), beside its bound,
        the plain backward and ``scaled_dot_product_attention``'s backward
        (``autograd.grad`` through it minus its forward; a yardstick the
        port never calls); each kernel's own device time from
        ``torch.profiler``; then attention's share of a BERT training
        step. The JSON rows of the two kernels carry their own time and
        bound, and the pair's plain and library times."""
        torch = self.torch
        import torch.nn.functional as F
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        dt = torch.bfloat16
        csrc = "deeplearning4j_tpu_torch/ops/kernels/csrc/flash_bwd.cu"
        pallas = "deeplearning4j_tpu/ops/pallas/flash_attention.py"
        pair_main = None
        for shape in (FLASH_SHAPES[1], FLASH_SHAPES[0], FLASH_SHAPES[2], FLASH_LONG_SHAPE):
            b, h, t_q, t_k, d, d_v, masked, causal = shape
            (q, k, v), mask = flash_inputs(b, h, t_q, t_k, d, d_v, dt, self.device, seed=9,
                                           mask=masked)
            bias = fa.key_bias(mask, b, t_k)
            with torch.no_grad():
                o, lse = fa.launch_flash_fwd(q, k, v, bias, causal, fa.lse_counter, save=True)
                do = torch.randn_like(o)
                run = lambda: fa.launch_flash_bwd(q, k, v, o, lse, do, bias, causal)  # noqa: E731
                grads = run()
                pair_ms = cuda_ms(run, reps=20)
                plain_ms = cuda_ms(lambda: fa.flash_attention_backward_reference(
                    q, k, v, o, lse, do, mask, causal), reps=3, warmup=1)
                per, _ = self.profile_kernels(run, reps=5)
            sdpa_mask = None if mask is None else mask[:, None, None, :]
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                *leaves, attn_mask=sdpa_mask, is_causal=causal)
            sdpa_fwd = cuda_ms(sdpa, reps=20)
            sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa(), leaves, do), reps=20) - sdpa_fwd
            pairs = attention_pairs(b, h, t_q, t_k, mask, causal)
            delta = torch.empty(b, h, t_q, dtype=torch.float32, device=self.device)
            ins = [q, k, v, o, do, lse, bias]
            rows = {fa.bwd_dq_counter.name: (ins + [grads[0], delta], 2.0 * pairs * (2 * d + d_v),
                                             "flash_bwd_dq_kernel", f"{pallas}:633"),
                    fa.bwd_dkv_counter.name: ([q, k, v, do, lse, delta, bias, *grads[1:]],
                                              2.0 * pairs * (2 * d + 2 * d_v),
                                              "flash_bwd_dkv_kernel", f"{pallas}:655")}
            pair_bound, pair_by = bound(ins + list(grads), 2.0 * pairs * (3 * d + 2 * d_v), dt)
            tag = (f"b={b} h={h} t_q={t_q} t_k={t_k} d={d} bf16 mask={'yes' if masked else 'no'} "
                   f"causal={'yes' if causal else 'no'}")
            kernel_ms = {}
            for name, (tensors, flops, key, replaces) in rows.items():
                kms = sum(ms for k_, (ms, _) in per.items() if key in k_)
                kernel_ms[name] = kms
                kb, kby = bound(tensors, flops, dt)
                log(f"{name}: {kms:.4f} ms per launch (profiler) at {tag}; bound {kb:.4f} ms "
                    f"({kby}, {flops / 1e9:.2f} GFLOP)")
                if pair_main is None:
                    self.kernels.setdefault(name, {}).update({
                        "name": name, "route": "cuda", "source": csrc,
                        "replaces": f"{replaces} (row 8); {pallas}:542, :575 (row 9, T > 8192)",
                        "ms": kms, "plain_ms": plain_ms, "bound_ms": kb, "bound_by": kby,
                        "library_ms": sdpa_bwd})
            log(f"flash backward pair: {pair_ms:.4f} ms (CUDA events; dq "
                f"{kernel_ms[fa.bwd_dq_counter.name]:.4f} + dk/dv "
                f"{kernel_ms[fa.bwd_dkv_counter.name]:.4f} ms by the profiler) at {tag}; bound "
                f"{pair_bound:.4f} ms ({pair_by}); plain backward {plain_ms:.3f} ms; "
                f"scaled_dot_product_attention backward {sdpa_bwd:.4f} ms (forward {sdpa_fwd:.4f})")
            if pair_main is None:
                pair_main = pair_ms
            del q, k, v, o, lse, do, grads, leaves
            torch.cuda.empty_cache()
        step = self.bert_train_step_ms
        if step is not None and self.flash_lse_ms is not None:
            share = BERT_LAYERS * (self.flash_lse_ms + pair_main)
            log(f"bert train step: attention (the {BERT_LAYERS} saving forwards + backward pairs, "
                f"masked) takes {share:.3f} ms of the {step:.2f} ms median step "
                f"({100 * share / step:.1f}%)")

    def dropout_times(self):
        """The dropout kernel at 8192 x 768 bf16, rate 0.1 (the ops phase's
        call): forward (``fused_dropout``, no x) and backward (the same
        kernel on gy), beside the bound, the plain version and
        ``torch.nn.functional.dropout`` (forward; its backward by
        ``autograd.grad``), a yardstick the port never calls; then the
        residual form beside ``x + F.dropout(h)``. A launch takes about as
        long as the wrapper's host time, so each call is timed after a pass
        that evicts the L2 cache (as a real caller finds its 12.6 MB input:
        cold) and the pass's own time is taken off (``cold_ms``)."""
        torch = self.torch
        import torch.nn.functional as F
        from deeplearning4j_tpu_torch.ops.kernels import fused_dropout as fd
        dt = torch.bfloat16
        g = torch.Generator().manual_seed(7)
        h, x, gy = (torch.randn(*DROPOUT_SHAPES[0], generator=g).to(dt).to(self.device)
                    for _ in range(3))
        seed, rate = 7, 0.1
        hl = h.detach().clone().requires_grad_()
        y_lib = F.dropout(hl, rate, training=True)
        library = {fd.counter.name: self.cold_ms(lambda: F.dropout(h, rate, training=True)),
                   fd.bwd_counter.name: self.cold_ms(lambda: torch.autograd.grad(
                       y_lib, [hl], gy, retain_graph=True))}
        plain_ms = cuda_ms(lambda: fd.fused_dropout_reference(None, h, seed, rate), reps=5,
                           warmup=1)
        for c, ins in ((fd.counter, h), (fd.bwd_counter, gy)):
            with torch.no_grad():
                out = fd.launch_dropout(None, ins, seed, rate, c)
                ms = self.cold_ms(lambda: fd.launch_dropout(None, ins, seed, rate, c))
                warm = cuda_ms(lambda: fd.launch_dropout(None, ins, seed, rate, c), reps=50)
            bound_ms, bound_by = bound([ins, out], 0.0, dt)
            self.kernels.setdefault(c.name, {}).update({
                "name": c.name, "route": "cuda",
                "source": "deeplearning4j_tpu_torch/ops/kernels/csrc/dropout.cu",
                "replaces": "deeplearning4j_tpu/ops/pallas/fused_dropout.py:124",
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library[c.name]})
            log(f"{c.name}: {ms:.4f} ms per launch, L2 cold ({warm:.4f} ms per call back to "
                f"back, host-bound) at {tuple(h.shape)} bf16 rate {rate}; bound {bound_ms:.4f} "
                f"ms ({bound_by}); plain version {plain_ms:.3f} ms; F.dropout"
                f"{' backward' if c is fd.bwd_counter else ''} {library[c.name]:.4f} ms")
        with torch.no_grad():
            add_ms = self.cold_ms(lambda: fd.launch_dropout(x, h, seed, rate, fd.counter))
            add_lib = self.cold_ms(lambda: x + F.dropout(h, rate, training=True))
            add_bound, _ = bound([x, h, h], 0.0, dt)
        log(f"fused_dropout_add (x + dropout(h)): {add_ms:.4f} ms per launch, L2 cold; bound "
            f"{add_bound:.4f} ms (bytes); x + F.dropout(h) {add_lib:.4f} ms")

    def cold_ms(self, fn, reps=20):
        """Milliseconds of ``fn`` with the L2 cache evicted before each call:
        CUDA events over ``reps`` of (zero a 256 MB buffer, ``fn``) less the
        same over the zeroing alone. The zeroing (~0.08 ms on an H100) also
        outlasts the wrapper's host time, so the card never waits on it."""
        torch = self.torch
        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=self.device)
        both = cuda_ms(lambda: (flush.zero_(), fn()), reps=reps)
        alone = cuda_ms(flush.zero_, reps=reps)
        del flush
        return both - alone

    def short_times(self):
        """The short-attention kernels at BERT-base's shape (64, 12, 128, 64)
        bf16 without a mask (the ops phase's call), in both layouts: the
        forward and the backward pair by CUDA events beside the bound, the
        plain versions and ``scaled_dot_product_attention`` on the same
        tensors or views (its backward: ``autograd.grad`` minus its
        forward; a yardstick the port never calls)."""
        torch = self.torch
        import torch.nn.functional as F
        from deeplearning4j_tpu_torch.ops.kernels import fused_attention_short as sa
        b, h, t, d = OPS_SHORT
        dt = torch.bfloat16
        g = torch.Generator().manual_seed(9)
        bhtd = [torch.randn(b, h, t, d, generator=g).to(dt).to(self.device) for _ in range(4)]
        _, views = btd_views(bhtd, h)
        csrc = "deeplearning4j_tpu_torch/ops/kernels/csrc/short_attention.cu"
        pallas = "deeplearning4j_tpu/ops/pallas/fused_attention_short.py"
        scale = d ** -0.5
        pairs = b * h * t * t
        for btd, (q, k, v, do) in ((False, bhtd), (True, views)):
            fwd_c, bwd_c = (sa.btd_counter, sa.btd_bwd_counter) if btd else (sa.counter,
                                                                                sa.bwd_counter)
            lines = (":320", ":353") if btd else (":169", ":197")
            with torch.no_grad():
                o = sa.launch_short_fwd(q, k, v, None, scale, fwd_c, btd)
                grads = sa.launch_short_bwd(q, k, v, do, None, scale, bwd_c, btd)
                ms = cuda_ms(lambda: sa.launch_short_fwd(q, k, v, None, scale, fwd_c, btd),
                             reps=20)
                bwd_ms = cuda_ms(lambda: sa.launch_short_bwd(q, k, v, do, None, scale, bwd_c,
                                                             btd), reps=20)
                plain_ms = cuda_ms(lambda: sa.short_attention_reference(q, k, v), reps=5,
                                   warmup=1)
                plain_bwd = cuda_ms(lambda: sa.short_attention_backward_reference(q, k, v, do),
                                    reps=5, warmup=1)
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            sdpa = lambda: F.scaled_dot_product_attention(*leaves)  # noqa: E731
            sdpa_fwd = cuda_ms(sdpa, reps=20)
            sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa(), leaves, do), reps=20) - sdpa_fwd
            for c, kms, pms, lib, tensors, flops, line in (
                    (fwd_c, ms, plain_ms, sdpa_fwd, [q, k, v, o], 2.0 * pairs * 2 * d, lines[0]),
                    (bwd_c, bwd_ms, plain_bwd, sdpa_bwd, [q, k, v, do, *grads],
                     2.0 * pairs * 5 * d, lines[1])):
                kb, kby = bound(tensors, flops, dt)
                self.kernels.setdefault(c.name, {}).update({
                    "name": c.name, "route": "cuda", "source": csrc, "replaces": pallas + line,
                    "ms": kms, "plain_ms": pms, "bound_ms": kb, "bound_by": kby,
                    "library_ms": lib})
                log(f"{c.name}: {kms:.4f} ms per launch at b={b} h={h} t={t} d={d} bf16 "
                    f"{'(b, t, h*d) views' if btd else '(b, h, t, d)'}; bound {kb:.4f} ms "
                    f"({kby}, {flops / 1e9:.2f} GFLOP); plain version {pms:.3f} ms; "
                    f"scaled_dot_product_attention{' backward' if c is bwd_c else ''} {lib:.4f} ms")
            del leaves, o, grads

    def cudnn_ms(self, module, T, B, H, dtype):
        """``torch.nn.LSTM`` or ``torch.nn.GRU`` (cuDNN) on layer 0's work:
        the input projection from the 96-wide one-hot plus the recurrence.
        Inference, training forward, and the backward alone (on a retained
        graph). A yardstick only: the port never calls it."""
        torch = self.torch
        rnn = module(VOCAB, H).to(self.device, dtype)
        rnn.flatten_parameters()
        x = torch.randn(T, B, VOCAB, device=self.device, dtype=dtype)
        with torch.inference_mode():
            infer = cuda_ms(lambda: rnn(x), reps=10)
        xg = x.clone().requires_grad_()
        fwd = cuda_ms(lambda: rnn(xg), reps=10)
        out, _ = rnn(xg)
        dy = torch.randn_like(out)
        wrt = list(rnn.parameters()) + [xg]
        bwd = cuda_ms(lambda: torch.autograd.grad(out, wrt, dy, retain_graph=True), reps=10)
        return {"infer": infer, "fwd": fwd, "bwd": bwd}


def nvidia_smi():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
            f"nvidia-smi gave nothing (exit {out.returncode})"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    card = nvidia_smi()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    smoke = Smoke(device)
    t0 = time.perf_counter()
    smoke.phase("build", smoke.build)
    if smoke.failures:
        log("FAILED:", smoke.failures)
        return 1
    if sys.argv[1:] == ["--label-rules"]:
        smoke.phase("label rules", smoke.label_rules_phase)
        return 1 if smoke.failures else 0
    smoke.phase("kernels", smoke.kernel_phase)
    workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
    try:
        smoke.phase("slice graves=True", lambda: smoke.slice_phase("graves", workdir))
        smoke.phase("slice graves=False", lambda: smoke.slice_phase("lstm", workdir))
        smoke.phase("slice bert", lambda: smoke.bert_phase(workdir))
        smoke.phase("slice gru", lambda: smoke.slice_phase("gru", workdir))
        smoke.phase("train graves=True", lambda: smoke.train_phase("graves"))
        smoke.phase("train graves=False", lambda: smoke.train_phase("lstm"))
        smoke.phase("train bert", smoke.bert_train_phase)
        smoke.phase("train gru", lambda: smoke.train_phase("gru"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    smoke.phase("ops", smoke.ops_phase)
    smoke.phase("times", smoke.times_phase)
    log(f"total {time.perf_counter() - t0:.1f} s")
    if smoke.failures:
        log("FAILED:")
        for f in smoke.failures:
            log("  " + f)
        return 1
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    rows = [{k: r.get(k) for k in keys} for r in smoke.kernels.values()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
