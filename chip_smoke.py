"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``speech_recognition_tpu_torch/csrc``
(one ``nvcc`` per source, all at once; the native WAV decoder is built
with the host compiler at its first use) and drives these paths:

- decode+augment (``[kernel]``): holds the kernel against its plain
  PyTorch version at the train step's shapes, on a step's draws with the
  edge cases written in (``edge_case_draws``), at both index dtypes, to
  the last bit; prints its ``ptxas -v`` line, its device time by
  ``torch.profiler`` over 50 launches cold (the L2 flushed by a 64 MB
  write before each, as the step leaves it) and warm (back to back), the
  CUDA events per wrapper call (host included), its bound and share, the
  plain version's time, and the device time of ``copy_`` of a tensor of
  the output's shape (a yardstick the port never calls); holds the
  flagship's logits on the card against the CPU, then runs the port's
  main path — 20 bf16 train steps of
  ``conv_1d_time_sliced_with_attention`` at batch 384 on a synthetic
  bank the size of the full Speech Commands corpus, and one validation
  sweep — and checks that every train step launched the kernel;
- the zoo (``[zoo]``), on the same bank: each of the 23 zoo models other
  than the flagship and ``conv_1d_spec`` (the 1-D ladders, the grouped
  models, the Inceptions, the residual family, the MFCC MLPs and 2-D
  convs, and the BiGRU models), at its golden's feature geometry,
  against its parameter-count golden, its f32 logits on the card against
  the CPU on the same ``Frontend`` features, then 6 bf16 train steps
  through ``Trainer`` at batch 384 (ms/step and clips/s by CUDA events,
  peak memory), checking finite losses, one decode+augment run per
  step (a launch, or a replay of the step's CUDA graph) and the kernel
  against its plain version on one of the model's draws, and listing
  the models whose capture of the step failed;
- separable block (``[separable]``): holds the fused forward kernel, in
  its ``fuse`` and ``fold`` variants, against its plain version at the
  flagship's 11 trunk shapes at batch 384 in bf16 and f32 (a y element
  out of tolerance is printed with both values and the plain version's
  f32, f64 and absolute sums), runs the T=11 512->512 bf16 case 200
  times in each variant and checks that the kernel's y is the same bit
  for bit in every run (printing how often the plain version's is not,
  and both y's sha256), then runs the
  block benchmark (``benchmark_separable_blocks``) and checks that it
  launched both variants; prints each shape's ``fuse`` and ``fold`` time
  against its bound, the time of the pointwise product alone in cuBLAS
  (a yardstick the port never calls), a ``torch.profiler`` account of
  the forward's kernels and ``ptxas -v``'s registers, shared memory and
  spills for each build;
- separable block backward (``[separable-bwd]``): holds the backward
  kernel against its plain version at the same shapes and dtypes, and
  without the prologue and at a VALID stride-2 shape with T - k odd;
  holds the gradients of ``fused_separable_block_vjp`` against autograd
  of the ATen block; then runs the forward+backward benchmark
  (``benchmark_separable_block_grads``) and checks that it launched the
  backward and ``fold`` kernels as often as it called them; prints each
  shape's backward time against its bound, the time of the backward's
  two products alone in cuBLAS (a yardstick the port never calls), a
  ``torch.profiler`` account of the backward's kernels and of a
  ``vjp_grad`` call's, ``vjp_grad``'s host time split into autograd's
  own, the forward's and the backward wrapper's, and ``ptxas -v``'s
  registers, shared memory and spills for each kernel;
- the GRU recurrence (``[gru]``): holds the forward and backward kernels
  (``ops/kernels/gru.py``) against their plain twin at the zoo's two
  BiGRU shapes, batch 384, both directions with masks, bf16 operands over
  f32 projections (the train step's); prints ``ptxas -v``'s lines and
  ``benchmark_gru``: the layer's train forward and backward through the
  kernels and through the loop over time, each kernel alone and the
  Predictor's f32 forward, against the kernels' bound;
- train-mode BatchNorm (``[bn]``): holds its four kernels
  (``ops/kernels/batchnorm.py``) against their plain twin at every
  BatchNorm input of the benchmark's three models (the flagship,
  ``steffeNet``, ``xception_with_attention``) at batch 384 in bf16, then
  prints, for each model, the device ms of one step's BatchNorms forward
  and backward through each kernel, beside the bytes the function has to
  move (10 B an element) and the kernels' two-pass design (16 B), the
  plain twin's, ATen ``F.batch_norm``'s and the layer's before the
  kernels (``var_mean`` of an f32 copy, then ``F.batch_norm``); ``[slice]`` and
  ``[zoo]`` check that every train step, launched or replayed, runs each
  kernel once a BatchNorm of the model (12 for the flagship, 32 for
  ``steffeNet``, 27 for ``xception_with_attention``);
- the depthwise conv (``[dwconv]``): holds its kernels
  (``ops/kernels/dwconv1d.py``) against the float64 plain twin at every
  depthwise conv of the benchmark's five models at batch 384 (bf16 x and
  dy, the f32 weight), then prints, for each model, the device ms of one
  step's convs forward and backward through the kernels beside their byte
  floor, the plain twin's, ATen's depthwise kernels' (``library_ms``) and
  the layer's before the kernels (``F.pad`` and ``F.conv1d`` with their
  autograd); ``[slice]`` and ``[zoo]`` check that every train step runs
  each kernel once a depthwise conv (11 for the flagship; 13 zoo models
  have such convs), and ``[slice]`` that each batch of its validation
  sweep runs the forward kernel once more a conv;
- data-parallel training (``[dp]``): two ranks, spawned processes joined
  by NCCL when each has a card of its own and by gloo when they share
  one. Each rank builds and replicates the full-corpus bank, holds
  ``decode_augment_sharded`` against its plain version on its rows (to
  the last bit) and takes the ``[kernel]`` phase's readings of it at
  [192, 16000], one rank at a time,
  holds a 2-rank step in f32 and in f64 against one process on the batch,
  and a 2-rank streamed step in f32 (each rank's int16 rows its bank:
  decode+augment on them against its plain version to the last bit, the
  features equal to the one process's rows), trains 20 bf16 steps at
  global batch 384 and sweeps validation; the parent checks that the
  kernel launched once per step on every rank, that the losses and the
  parameters are the same on both ranks;
- the accuracy signal (``[fit]``): holds the ``Frontend`` (f32, TF32
  off) and ``conv_1d_spec``'s logits on the card against the CPU, writes
  the hard corpus at the calibration defaults to a temporary directory
  and runs the calibration (``tools/calibrate_accuracy.py``: 12 epochs of
  ``conv_1d_spec`` at batch 128 in bf16, BN re-estimation over 16
  batches, ReduceLROnPlateau) for seeds 0 and 1; prints each epoch's
  validation accuracy and clips/s and each record, checks that
  decode+augment launched once per train step and per BN batch and holds
  it against its plain version on a batch drawn from the trainer (to the
  last bit), and fails if the seed mean of ``val_acc_best`` is below
  0.8309 (the JAX band's mean less two standard deviations); seed 0 runs
  with ``--eval_int8`` and prints the float32 and int8 archives'
  validation accuracy and their difference;
- training from the CLI (``[train]``), on ``[fit]``'s corpus:
  ``tools.train`` (the flagship at batch 384) for two epochs in bank
  mode, then with ``--stream`` and BN re-estimation over 8 batches, then
  with ``--resume`` from the bank run's best checkpoint; checks each
  run's steps and decode+augment's launches (one per train step and per
  streamed BN batch) and reads its TensorBoard events back; freezes the
  streamed run's best checkpoint (BN re-estimated) in float32 and int8
  (``tools.freeze``), runs
  ``tools.run_edge_inference --benchmark`` on the card over the
  validation WAVs (archive bytes, batch-1 ms/sample) and holds the float32
  archive's probabilities against the eager ``Predictor`` (f32, TF32 off)
  to 1e-5 and the int8 archive's against the float32 one's to 0.05;
- training over ranks (``[dp-train]``, after ``[train]`` on its corpus):
  ``torchrun --nproc_per_node 2 -m speech_recognition_tpu_torch.tools.
  train`` (the flagship at global batch 384) in bank mode, then with
  ``--stream`` and BN re-estimation, 2 epochs of 2 steps each; checks
  that both ranks print the same figures every epoch, each rank's
  decode+augment launches, and that rank 0 alone wrote the jsonl log,
  the reports, the TensorBoard file and a checkpoint that loads;
- the serving path (``[infer]``): holds the TTA ``Predictor`` of the
  flagship and ``conv_1d_spec``, in its three modes, and ``time_stretch``
  on the card against the CPU (f32; the Predictor turns TF32 off);
  trains ``conv_1d_spec`` by ``[fit]``'s recipe (seed 0) with the
  classes in the submission's order and a best-only checkpoint, gathers
  the validation clips into a flat test directory and runs
  ``tools.create_tta_set`` and ``tools.make_submission`` without TTA,
  with TTA and with speed TTA; checks the CSVs and memmaps (rows in
  sorted order, sums, argmax labels, the memmap's truncation), the no-TTA
  probabilities against the Predictor on the same batches, and prints
  each mode's accuracy on these labelled clips; runs
  ``tools.pseudo_labels`` threshold, agreement and vote, retrains a few
  epochs on train plus the pseudo-labels and checks that pseudo rows
  were drawn and that decode+augment launched once per train step and
  per BN batch, and holds it against its plain version on the draw with
  the most pseudo rows (to the last bit); ``[dp-infer]``: the TTA
  submission again over 2 ranks (``torchrun ... tools.make_submission
  --data_parallel on``), its files checked and its probabilities held
  against one process's to 1e-5; then runs
  ``tools.bench_infer`` on the flagship at batch 384 over 7,777 WAVs,
  with TTA and without, and with TTA over 2 ranks under torchrun (the
  sweep sharded), and echoes its line; then times the native batch
  WAV decoder (``csrc/wavio.cc``, on its default threads and on one)
  against its numpy version over those files and checks that the rows
  are equal;
- streaming (``[stream]``): ``tools.bench_streaming``, the flagship at
  batch 384 streamed from 2,048 WAVs on disk through the host prefetch
  loader (2 warm-up, 30 timed and 5 traced steps): clips/s, the loader's
  host seconds by part, the device's busy and idle share and the peak
  memory; checks finite losses and one decode+augment launch per step,
  and holds the kernel against its plain version on a streamed batch,
  its own bank (to the last bit); then the same bench over 2 ranks under
  torchrun (each rank's loader over its shard, 192 rows a rank), its
  clips/s beside the one rank's;
- profiling (``[profile]``): ``tools.profile_step`` on the flagship, its
  ``torch.profiler`` trace read back by ``summarize_trace``: device busy
  per step, the op classes and the top kernels, one decode+augment per
  traced step;
- the tools (``[tools]``): ``tools.model_info`` over all 25 models on the
  card (parameters, bytes, FLOPs by ``FlopCounterMode``) and
  ``tools.bench_zoo`` over two models;
- the bench (``[bench]``): runs ``python -m
  speech_recognition_tpu_torch.bench`` in a child at the full-corpus
  scale (3 reps of 100 steps, no accuracy signal), checks that its first
  stdout line is the metric JSON with a finite positive value and that
  it launched decode+augment once per train step, and echoes the line
  and its diagnostics.

When the ranks share one card (gloo), no time of the phases over ranks
is a measure of scaling, and the log says so. Any failure, on any rank,
raises and exits non-zero; without a CUDA
device it exits non-zero before printing any result. The last two lines
of standard output are a JSON record of the kernels (each with its
bound: the larger of its bytes over 3.35 TB/s and its operations over
the peak rate of its type, the H100 SXM data sheet's) and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import hashlib
import json
import os
import re
import socket
import subprocess
import sys
import time
import types

import numpy as np
import torch

from speech_recognition_tpu_torch.ops.kernels import launch

MODEL = "conv_1d_time_sliced_with_attention"
BATCH = 384
T = 16000
STEPS, WARMUP = 15, 5             # 20 train steps in all
# bench.py's full_corpus scale: 75,621 clips = 2.42 GB of int16
NUM_TRAIN, NUM_VAL, NUM_PSEUDO = 64_727, 6_798, 4_096
NUM_BACKGROUND, BACKGROUND_LEN = 6, 16000 * 60
# decode+augment rounds as its plain version does, one operation at a
# time: equal up to the sign of an exact zero
KERNEL_ATOL = 0.0
LOGITS_ATOL = 1e-3
# decode+augment's device time: launches per reading, traces taken until
# one holds every launch, and the scratch write (more than the 50 MB L2)
# that makes a reading cold
DEVICE_ITERS = 50
DEVICE_TRACES = 3
L2_FLUSH_BYTES = 64 << 20
DECODE_KERNEL = r"decode_augment_kernel"
KERNEL_SOURCES = ("decode_augment", "separable_block", "separable_block_bwd",
                  "gru_recurrence", "batchnorm", "maxpool", "dwconv1d")
# the [dwconv] phase: the benchmark's five models (every depthwise conv of
# a step at batch 384), the kernels' names; the kernels against the
# float64 twin: y and dx one rounding to bf16 of an f32 sum of k terms,
# dw f32 sums in a fixed tree (see tests/test_torch_dwconv1d.py)
DWCONV_MODELS = (MODEL, "steffeNet", "xception_with_attention",
                 "conv_1d_mfcc_and_raw", "conv_1d_simple")
DWCONV_KERNELS = ("dwconv1d_fw", "dwconv1d_bw")
DWCONV_TOL = {"y": 2.0 ** -20, "dx": 2.0 ** -20, "dw": 2.0 ** -16}
# the [maxpool] phase: the two benchmark models that pool (every pool of
# a step at batch 384), the kernels' names
MAXPOOL_MODELS = ("xception_with_attention", "conv_1d_mfcc_and_raw")
MAXPOOL_KERNELS = ("maxpool1d_fw", "maxpool1d_bw")
# the [bn] phase: the benchmark's three models (their BatchNorm inputs at
# batch 384), the kernels' names, the traced calls a reading averages.
# Kernels and twin sum in f32 in other orders, over up to 153,216 terms
# a channel: each sum within about sqrt(N) u = 2.3e-5 of its terms'
# magnitudes, which for these inputs (means of 0.5 at a spread of 2)
# stay within a few times the largest sum
BN_MODELS = (MODEL, "steffeNet", "xception_with_attention")
BN_KERNELS = ("bn_fw_stats", "bn_fw_apply", "bn_bw_reduce", "bn_bw_dx")
BN_ITERS = 5
BN_STATS_RTOL = 1e-4
# GRU recurrence, kernels against their plain twin: the largest gap over
# the largest value. bf16 operands: a sum in another order may round one
# operand the other way, and 50 steps carry it on.
GRU_RTOL = 2e-2
# separable block, kernel against its plain version on the same inputs:
# y (rtol of |plain|, atol). y in f32 (TF32 off) differs only in the order
# of the f32 sums of up to 3 x 512 products, |y| < ~10. In bf16 the two f32
# sums may round to neighbouring bf16 values, one step apart, which rtol
# 2^-7 always admits; more than one step is a miss, whose elements are
# printed with both values and the plain version's sums (ROADMAP C5).
SEP_Y_TOL = {torch.bfloat16: (2.0 ** -7, 1e-5), torch.float32: (0.0, 1e-4)}
# the case of ROADMAP C5 (T=11, 512->512, s1, VALID, bf16, both variants)
# run again and again: every run's y the first run's, bit for bit, and
# within the tolerance
SEP_REPEAT_SHAPE = (11, 512, 512, 1, "VALID")
SEP_REPEATS = 200
# s1, s2: f32 sums over 384 x To rows taken with atomics in another
# order, per channel relative to sum|y| (s1) and to s2.
SEP_STATS_RTOL = 1e-4
# separable block backward, kernel against its plain version on the same
# inputs, each output relative to its largest |value|. dx (rtol, atol): in
# f32 it differs only by ddw's f32 sum order; in bf16 a different f32 sum
# can flip ddw to the neighbouring bf16 value, which moves one tap piece
# of dx by a bf16 step (measured up to 8.6e-4 of max|dx|, at T=11
# 512->512). The f32 sums dw_dw, dw_pw, da, db are taken over up to 152k
# rows with atomics in another order (f32: measured up to 2.1e-6); in bf16
# a flipped ddw also moves one term of a sum by a bf16 step (measured up
# to 1.5e-4).
SEP_BWD_DX_TOL = {torch.float32: (0.0, 1e-5),
                  torch.bfloat16: (2.0 ** -6, 2.0 ** -8)}
SEP_BWD_SUM_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
# the VJP's gradients against autograd of the ATen block, f32 (the JAX
# test's bound: the kernel recomputes the depthwise chain in another order)
VJP_GRAD_RTOL = 5e-4
BWD_NAMES = ("dx", "dw_dw", "dw_pw", "da", "db")
# the [dp] phase
DP_RANKS = 2
DP_TIMEOUT_S = 600
# one 2-rank step against one process on the same global batch, weights
# and dropout masks (TF32 off): (loss relative to its value, median and
# max over a gradient's entries of the error relative to its max |value|).
# The two take the BN statistics and the gradient sums in another order
# (two halves, then the all-reduce), and cuDNN may pick other algorithms
# at batch 192 than at 384. f32 itself is only so accurate here: on one
# process its gradients differ from f64's by a median of up to 9e-4 of
# max |g| in the first layers (the BN backward's sums cancel) and by up
# to 1.9e-2 in the row of an output channel where a BN output lies within
# f32 rounding of relu6's clamp and takes its gradient on one side only
# (CPU, batch 48). So the f32 bounds are f32's own error, several times
# over; per-rank BN statistics miss them by far (CPU, batch 48: loss 3e-3,
# median 0.24). In f64 no clamp is that close and the sums keep ~1e-16, so
# the f64 bounds are tight.
DP_TOL = {torch.float32: (1e-5, 1e-2, 1e-1),
          torch.float64: (1e-12, 1e-12, 1e-9)}
# the [fit] phase: the accuracy signal's calibration (bench.py's ACC_ARGS
# at calibrate_accuracy.py's defaults: 100 clips per word, corpus seed 0,
# batch 128, BN re-estimation over 16 batches, plateau 0.5/4/1e-5), in bf16
FIT_MODEL = "conv_1d_spec"
FIT_SEEDS = (0, 1)
FIT_ARGS = ["--model", FIT_MODEL, "--epochs", "12", "--steps_per_dispatch",
            "8", "--compute_dtype", "bfloat16"]
# the seed mean of val_acc_best must reach the band's mean less two sd:
# 0.8571 - 2 x 0.0131 (bench.py:162-166)
FIT_ACC_GATE = 0.8309
# the frontend and conv_1d_spec, card against CPU in f32 with TF32 off:
# relative to the largest |value| (the log-mel where mel > 1e-3)
FRONTEND_RTOL = {"spectrogram": 1e-5, "log_mel": 1e-4, "mfcc": 1e-4}
SPEC_LOGITS_RTOL = 1e-3
# the [bench] phase: the port's bench at the full-corpus scale, 3 reps of
# 100 steps (the least it takes), without the accuracy signal
BENCH_ENV = {"BENCH_SCALE_ORDER": "full_corpus", "BENCH_SMALL": "1",
             "BENCH_SPD": "100", "BENCH_SKIP_ACC": "1"}
BENCH_TIMEOUT_S = 600
# the [infer] phase. The Predictor, card against CPU in f32 with TF32 off:
# probabilities, absolute; the time stretch relative to max |CPU|, at the
# CPU tests' end-to-end bounds (broadband noise has no silent bins; on
# tonal signals near-silent bins carry float32 phase noise that the
# accumulation keeps)
INFER_PROB_ATOL = 1e-4
STRETCH_RTOL = {"noise": 5e-5, "chirp": 0.15, "tones": 0.15, "burst": 0.15}
STRETCH_RATES = (0.9, 1.1, 0.8)
# the submission chain on the hard corpus's 240 validation clips: the
# batch (one full batch and a partial tail), the no-TTA probabilities
# against the Predictor on the same decoded batches, and the retrain on
# train plus the pseudo-labels
INFER_BATCH = 128
INFER_DIRECT_ATOL = 1e-6
RETRAIN_EPOCHS, RETRAIN_PSEUDO_FREQUENCY = 3, 0.5
# tools.bench_infer on the flagship: 20 batches of 384 and a tail of 97
BENCH_INFER_FILES = 7_777
# the [zoo] phase: the 23 zoo models other than the flagship and
# conv_1d_spec, each with its parameter-count golden (the JAX package's,
# tests/test_zoo_param_goldens.py) at the golden's geometry (98 frames,
# 60 mel features but 40 for ZOO_MEL_40, 257 bins), trained at batch 384
# in bf16 on [slice]'s full-corpus bank for ZOO_WARMUP + ZOO_STEPS steps
ZOO_PARAMS = {
    "conv_1d_time_sliced": 1_271_008,
    "conv_1d_time_stacked": 843_660,
    "conv_1d_heavy": 1_588_800,
    "conv_1d_gru": 950_539,
    "conv_1d_fast": 540_000,
    "conv_1d_learned_spec": 1_555_932,
    "conv_1d_multi_time_sliced": 437_522,
    "conv_1d_time_sliced_group": 686_340,
    "conv_1d_top_down": 651_612,
    "inception": 7_966_236,
    "inception_d1": 2_122_060,
    "conv_1d_residual": 6_472_332,
    "steffeNet": 20_056_448,
    "conv_1d_log_mfcc": 774_990,
    "conv_1d_spectrogram": 812_814,
    "conv_1d_mfcc_and_raw": 1_911_084,
    "simple": 47_052,
    "snn": 2_180_812,
    "conv_2d": 706_764,
    "conv_2d_mobile": 1_176_684,
    "conv_2d_fast": 102_988,
    "conv_1d_simple": 540_587,
    "xception_with_attention": 2_264_654,
}
ZOO_MEL_40 = ("simple", "snn", "conv_2d", "conv_2d_mobile", "conv_2d_fast")
# cut from 2 + 8 steps and 3 traced for the phases over ranks; the
# warm-up is the eager step and the capture of the step's CUDA graph
ZOO_WARMUP, ZOO_STEPS = 2, 4
ZOO_TRACED = 2      # steps traced by torch.profiler after the timed ones
# NVIDIA H100 SXM data sheet: HBM bytes/s; dense FLOP/s in f32 (CUDA
# cores) and bf16 (tensor cores)
# [stream]: tools.bench_streaming at its defaults (2,048 WAVs written as
# the JAX script writes them), 2 warm-up + 30 timed + 5 traced steps
STREAM_ARGS = ["--batch_size", str(BATCH), "--warmup", "2", "--steps", "30",
               "--trace_steps", "5"]
# and over 2 ranks under torchrun, shorter and untraced
STREAM_DP_ARGS = ["--batch_size", str(BATCH), "--warmup", "1", "--steps",
                  "10", "--trace_steps", "0"]
# [train]: tools.train on [fit]'s corpus, then the edge export
TRAIN_EPOCHS = 2
TRAIN_BN_BATCHES = 8
TRAIN_VALIDATION_PCT = 20
EDGE_BYTES = 5_000_000          # the reference's Pi budget (README.md:14)
EDGE_INT8_BYTES = 2_000_000     # tests/test_edge_budget.py's int8 bound
EDGE_CHECK_CLIPS = 32
EDGE_PROB_ATOL = 1e-5           # an archive vs the eager Predictor
EDGE_INT8_ATOL = 0.05           # int8 archive vs the f32 one

# the phases over ranks under torchrun ([dp-train], [stream]'s and
# [infer]'s runs over 2 ranks, [dp-infer]): the ranks and their limit
TORCHRUN_RANKS = 2
TORCHRUN_TIMEOUT_S = 400
# [dp-train]: tools.train over 2 ranks on [fit]'s corpus, 2 epochs of 2
# steps at global batch 384, bank then --stream with BN re-estimation
DP_TRAIN_ARGS = ["--epochs", "2", "--steps_per_epoch", "2"]
DP_TRAIN_BN_BATCHES = 2
# [dp-infer]: the 2-rank submission's probabilities against one
# process's (the JAX mesh test's atol)
DP_INFER_ATOL = 1e-5
# [profile]: tools.profile_step on the flagship; [tools]: bench_zoo
PROFILE_ARGS = ["--warmup", "5", "--steps", "10"]
TOOLS_ZOO_MODELS = [MODEL, "conv_2d_fast"]
TOOLS_ZOO_ARGS = ["--steps", "10", "--warmup", "3"]
REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def separable_runs() -> dict:
    """The separable block's kernels' runs (``launch.runs``) by variant:
    the forward's ``fuse`` and ``fold``, the backward's ``bwd``."""
    runs = launch.runs()
    return {"fuse": runs["separable_block.fuse"],
            "fold": runs["separable_block.fold"],
            "bwd": runs["separable_block_bwd"]}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    to move ``nbytes`` and do ``flops`` operations of ``dtype``."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def decode_augment_bound(bank, bg_flat, file_ids, shifts, fg_vol, bg_pos,
                         bg_vol):
    """(ms, bound_by, bytes) of one decode+augment call on these inputs:
    the bank rows that a row with fg_vol != 0 reads (each distinct row
    once), the background samples that a row with bg_vol != 0 reads (the
    union of their windows), the five [B] vectors and the [B, T] f32
    output; 3 f32 operations per output sample."""
    b, t = file_ids.shape[0], bank.shape[1]
    bank_rows = torch.unique(file_ids[fg_vol != 0]).numel()
    pos = bg_pos[bg_vol != 0].long()
    edges = torch.zeros(bg_flat.shape[0] + 1, dtype=torch.int64,
                        device=pos.device)
    edges.index_add_(0, pos, torch.ones_like(pos))
    edges.index_add_(0, pos + t, -torch.ones_like(pos))
    bg_samples = int((edges.cumsum(0)[:-1] > 0).sum())
    nbytes = (bank_rows * t * bank.element_size()
              + bg_samples * bg_flat.element_size()
              + sum(v.numel() * v.element_size()
                    for v in (file_ids, shifts, fg_vol, bg_pos, bg_vol))
              + b * t * 4)
    return (*bound(nbytes, 3 * b * t, torch.float32), nbytes)


def device_ms(fn, pattern: str, flush=None, iters: int = DEVICE_ITERS):
    """Mean device time, ms, of the kernels whose name matches the regex
    ``pattern`` in a ``torch.profiler`` trace of ``iters`` calls of
    ``fn`` (after one untimed call), each call preceded by ``flush()``
    when one is given (its kernels must not match). Only a trace with
    exactly one matching kernel per call is read: the profiler can lose
    a record of back-to-back launches (one of 50 on a [dp] rank sharing
    the card, NVIDIA H100 80GB HBM3), so a trace that lacks one is taken
    again, and the call raises if none of ``DEVICE_TRACES`` is whole."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(DEVICE_TRACES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == cuda
                   and not e.is_user_annotation]
        hits = [e for e in kernels if re.search(pattern, e.name)]
        if len(hits) == iters:
            return sum(e.time_range.end - e.time_range.start
                       for e in hits) / iters / 1e3
    raise RuntimeError(f"profiler: {len(hits)} kernels match {pattern!r} "
                       f"in {iters} calls, in each of {DEVICE_TRACES} "
                       f"traces; seen "
                       f"{sorted({e.name[:80] for e in kernels})}")


def decode_augment_timings(call, plain, shape, device) -> dict:
    """The times, ms, of the decode+augment kernel whose wrapper call is
    ``call`` (on one step's draws, output ``shape``): ``device_ms`` its
    device time with the L2 cold (a 64 MB scratch write before each
    launch, as the train step's other work leaves it), ``device_ms_warm``
    back to back, both by
    ``torch.profiler`` over 50 launches; ``ms`` and ``plain_ms`` the CUDA
    events per wrapper call of ``call`` and ``plain`` (host included;
    best of two runs of 50 in turns); ``yardstick_ms`` the device time of
    ``copy_`` of a tensor of the output's shape, L2 cold (one read and
    one write of its bytes: the card's practical ceiling for this
    traffic; the port never calls it)."""
    from speech_recognition_tpu_torch.export.benchmark import time_calls

    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                          device=device)
    flush = functools.partial(scratch.fill_, 1.0)
    out = {"device_ms": device_ms(call, DECODE_KERNEL, flush),
           "device_ms_warm": device_ms(call, DECODE_KERNEL)}
    plain_ms, kernel_ms, plain_ms2, kernel_ms2 = (
        time_calls(fn, DEVICE_ITERS, runs=1) for fn in 2 * (plain, call))
    out["ms"], out["plain_ms"] = (min(kernel_ms, kernel_ms2),
                                  min(plain_ms, plain_ms2))
    src = torch.rand(shape, device=device)
    dst = torch.empty_like(src)
    out["yardstick_ms"] = device_ms(functools.partial(dst.copy_, src),
                                    r"Memcpy|copy", flush)
    return out


def decode_augment_line(t: dict, bound_ms: float, bound_by: str,
                        nbytes: float, card: str) -> str:
    """The timings of ``decode_augment_timings`` against the bound."""
    return (f"device time cold {t['device_ms']:.4f} ms (L2 flushed by a "
            f"{L2_FLUSH_BYTES >> 20} MB write before each of {DEVICE_ITERS} "
            f"launches; {nbytes / 1e6 / t['device_ms']:.0f} GB/s of "
            f"{nbytes / 1e6:.1f} MB), warm {t['device_ms_warm']:.4f} ms (back "
            f"to back); events per wrapper call {t['ms']:.4f} ms (host "
            f"included); bound {bound_ms:.4f} ms ({bound_by}): share cold "
            f"{100 * bound_ms / t['device_ms']:.1f} %, warm "
            f"{100 * bound_ms / t['device_ms_warm']:.1f} %; plain "
            f"{t['plain_ms']:.4f} ms per call; yardstick copy_ of the "
            f"output's shape in f32, device time cold "
            f"{t['yardstick_ms']:.4f} ms | {card}")


def separable_bound(shape, batch: int, backward: bool):
    """(ms, bound_by, bytes, FLOP) of the separable block in bf16 with the
    prologue and the statistics at one ``(T, Cin, Cout, stride,
    padding)``. Forward: x, the weights, a and b in; y, s1 and s2 out;
    the pointwise product (2 B To Cin Cout) plus the depthwise taps, the
    prologue and the statistics. Backward: x, y, dy, ds1, ds2, the
    weights, a and b in; dx, dw_dw, dw_pw, da and db out; the two
    products (4 B To Cin Cout) plus the recomputed taps, the taps of ddw
    into dx and dw_dw, the prologue and its gradient, and dy's
    statistics terms."""
    from speech_recognition_tpu_torch.ops.kernels.separable_block import (
        out_len,
    )
    t, cin, cout, stride, padding = shape
    to = out_len(t, 3, stride, padding)[0]
    x, y = batch * t * cin * 2, batch * to * cout * 2
    weights = 3 * cin * 2 + cin * cout * 2 + 2 * cin * 4
    taps = 2 * 3 * batch * to * cin
    if backward:
        nbytes = 2 * x + 2 * y + weights + 2 * cout * 4 \
            + (3 * cin + cin * cout + 2 * cin) * 4
        flops = (4 * batch * to * cin * cout + 3 * taps
                 + 4 * batch * t * cin + 3 * batch * to * cout)
    else:
        nbytes = x + y + weights + 2 * cout * 4
        flops = (2 * batch * to * cin * cout + taps
                 + 2 * batch * t * cin + 3 * batch * to * cout)
    return (*bound(nbytes, flops, torch.bfloat16), nbytes, flops)


def separable_bounds(shapes, batch: int, backward: bool):
    """(ms, bound_by) of the separable block summed over ``shapes`` (see
    ``separable_bound``)."""
    parts = [separable_bound(s, batch, backward) for s in shapes]
    return (sum(p[0] for p in parts),
            "/".join(sorted({p[1] for p in parts})))


def timed_build(name: str):
    from speech_recognition_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    lib = build.build(name)
    return lib, time.perf_counter() - t0


def compare_block(got, want, dtype):
    """(max abs err of y, the y elements out of tolerance as a bool mask,
    worst relative error of s1, of s2) of the kernel's ``got`` against
    ``want``."""
    y, s1, s2 = got
    yw, s1w, s2w = want
    if y.shape != yw.shape or y.dtype != dtype or not torch.isfinite(y).all():
        raise RuntimeError(f"separable kernel output {y.dtype} "
                           f"{tuple(y.shape)} (want {tuple(yw.shape)}), or "
                           f"non-finite values")
    rtol, atol = SEP_Y_TOL[dtype]
    d = (y.float() - yw.float()).abs()
    bad = d > atol + rtol * yw.float().abs()
    scale1 = yw.float().abs().sum((0, 1)).clamp_min(1e-30)
    e1 = float(((s1 - s1w).abs() / scale1).max())
    e2 = float(((s2 - s2w).abs() / s2w.clamp_min(1e-30)).max())
    return float(d.max()), bad, e1, e2


def y_misses(y, yw, bad, ins, limit: int = 8, **kw) -> list:
    """The first ``limit`` y elements that ``bad`` marks: for each its
    index, the kernel's and the plain version's value, and the plain
    version's sum before its rounding (f32), in float64 and of its terms'
    magnitudes (``sum_terms`` on the same inputs ``ins`` and flags)."""
    from speech_recognition_tpu_torch.ops.kernels import (
        separable_block as S,
    )

    kw = {k: v for k, v in kw.items() if k != "emit_stats"}
    s_plain, abs_sum, exact, n = S.sum_terms(*ins, **kw)
    out = []
    for at in torch.nonzero(bad)[:limit].tolist():
        at = tuple(at)
        out.append({"at": list(at), "y": float(y[at]),
                    "y_plain": float(yw[at]),
                    "plain_f32_sum": float(s_plain[at]),
                    "f64_sum": float(exact[at]),
                    "abs_sum": float(abs_sum[at]), "n": n})
    return out


def separable_phase(device, card: str, build_s: float, ptxas: list[str]):
    """The separable block: kernel against plain at the 11 trunk shapes,
    two extra cases, then the benchmark, each shape's time against its
    bound and the cuBLAS yardstick (``profile_separable`` profiles the
    forward's kernels after the backward's phase). Returns the
    ``kernels`` entries."""
    from speech_recognition_tpu_torch.export.benchmark import (
        SEPARABLE_ITERS, SEPARABLE_RUNS, SEPARABLE_SHAPES,
        benchmark_separable_blocks, separable_block_inputs,
    )
    from speech_recognition_tpu_torch.ops.kernels import (
        separable_block as S,
    )

    phase_t0 = time.perf_counter()
    log(f"[separable] library built in {build_s:.2f} s | tolerances: y "
        f"bf16 rtol 2^-7 atol 1e-5, f32 atol 1e-4 (TF32 off); s1, s2 "
        f"relative {SEP_STATS_RTOL}")
    for line in ptxas:
        log(f"[separable] ptxas -v {line}")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    before = separable_runs()
    calls = {"fuse": 0, "fold": 0}
    worst = {"fuse": 0.0, "fold": 0.0}
    failures = []

    def check(label, variant, dtype, ins, **kw):
        """(y max abs err, s1 err, s2 err, the kernel's y, the plain
        version's y); a miss goes to ``failures`` with its elements."""
        fold = variant == "fold"
        got = S.fused_separable_block(*ins, fold_weights=fold, **kw)
        want = S.separable_block_plain(*ins, fold_weights=fold, **kw)
        calls[variant] += 1
        if not kw.get("emit_stats", True):
            if not isinstance(got, torch.Tensor):
                raise RuntimeError("emit_stats=False returned more than y")
            none = torch.zeros(1, device=device)
            got, want = (got, none, none), (want, none, none)
        err, bad, e1, e2 = compare_block(got, want, dtype)
        worst[variant] = max(worst[variant], err)
        n_bad = int(bad.sum())
        if n_bad or e1 > SEP_STATS_RTOL or e2 > SEP_STATS_RTOL:
            misses = y_misses(got[0], want[0], bad, ins, fold_weights=fold,
                              **kw) if n_bad else []
            failures.append(f"{label} {variant} {dtype}: y max abs err "
                            f"{err:.3g} ({n_bad} out of tolerance: "
                            f"{misses}), s1 {e1:.3g}, s2 {e2:.3g}")
        return err, e1, e2, got[0], want[0]

    for t, cin, cout, stride, padding in SEPARABLE_SHAPES:
        x, w_dw, w_pw, a, b = separable_block_inputs(
            t, cin, cout, batch=BATCH, dtype=torch.float32, device=device)
        parts = []
        for dtype in (torch.bfloat16, torch.float32):
            ins = [v.to(dtype) for v in (x, w_dw, w_pw)] + [a, b]
            for variant in ("fuse", "fold"):
                err, e1, e2, _, _ = check(
                    f"T={t} {cin}->{cout} s{stride}", variant, dtype, ins,
                    stride=stride, padding=padding)
                parts.append(f"{variant} {str(dtype)[6:]} {err:.3g}"
                             f"/{max(e1, e2):.2g}")
        torch.cuda.synchronize()
        log(f"[separable] T={t:3d} {cin}->{cout} s{stride} {padding:5s} "
            f"B={BATCH}: y max abs err / stats rel err: " + ", ".join(parts))
    # the case of ROADMAP C5 again and again, each run held to the
    # tolerance: a race in the kernel, or a plain version whose cuBLAS
    # sums change from run to run, would show as a y that is not the
    # first run's
    t, cin, cout, stride, padding = SEP_REPEAT_SHAPE
    ins = separable_block_inputs(t, cin, cout, batch=BATCH,
                                 dtype=torch.bfloat16, device=device)
    label = f"repeat T={t} {cin}->{cout} s{stride}"
    for variant in ("fuse", "fold"):
        first, differ = None, {"kernel": 0, "plain": 0}
        for _ in range(SEP_REPEATS):
            *_, y, yw = check(label, variant, torch.bfloat16, ins,
                              stride=stride, padding=padding)
            if first is None:
                first = (y, yw)
            differ["kernel"] += not torch.equal(y, first[0])
            differ["plain"] += not torch.equal(yw, first[1])
        torch.cuda.synchronize()
        sha = [hashlib.sha256(v.view(torch.int16).cpu().numpy().tobytes())
               .hexdigest()[:16] for v in first]
        log(f"[separable] {label} {padding} B={BATCH} {variant} bf16, "
            f"{SEP_REPEATS} runs: the kernel's y differs from its first "
            f"run's in {differ['kernel']}, the plain version's in "
            f"{differ['plain']}; sha256 of the first y: kernel {sha[0]}, "
            f"plain {sha[1]}")
        if differ["kernel"]:
            failures.append(f"{label} {variant}: the kernel's y differs "
                            f"from its first run's in {differ['kernel']} "
                            f"of {SEP_REPEATS} runs on the same inputs")
    # a stride-2 SAME shape without the prologue, and without the
    # statistics
    t, cin, cout, stride, padding = SEPARABLE_SHAPES[1]
    x, w_dw, w_pw, _, _ = separable_block_inputs(
        t, cin, cout, batch=BATCH, device=device)
    for variant in ("fuse", "fold"):
        check("no prologue", variant, torch.bfloat16, (x, w_dw, w_pw),
              stride=stride, padding=padding)
        check("emit_stats=False", variant, torch.bfloat16, (x, w_dw, w_pw),
              stride=stride, padding=padding, emit_stats=False)
    torch.cuda.synchronize()
    log(f"[separable] T={t} {cin}->{cout} s{stride} {padding} bf16 without "
        f"the prologue and with emit_stats=False: checked")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    after = separable_runs()
    rose = {v: after[v] - before[v] for v in calls}
    if rose != calls:
        raise RuntimeError(f"separable runs rose by {rose} in {calls} "
                           f"calls")
    if failures:
        raise RuntimeError("separable kernel against its plain version: "
                           + "; ".join(failures))

    # the path: the block benchmark, with the counts set to 0 just before
    launch.reset_runs()
    records = benchmark_separable_blocks(device)
    launches = separable_runs()
    expected = len(SEPARABLE_SHAPES) * (1 + SEPARABLE_ITERS * SEPARABLE_RUNS)
    if launches != {"fuse": expected, "fold": expected, "bwd": 0}:
        raise RuntimeError(f"the block benchmark launched {launches}, "
                           f"expected {expected} of each")
    totals = {v: sum(r[f"{v}_ms"] for r in records)
              for v in ("plain", "fuse", "fold")}
    for r in records:
        if not all(np.isfinite(r[f"{v}_ms"]) and r[f"{v}_ms"] > 0
                   for v in totals):
            raise RuntimeError(f"benchmark record {r}")
        log(f"[separable] bench T={r['T']:3d} {r['Cin']}->{r['Cout']} "
            f"s{r['stride']} {r['padding']:5s} B={r['batch']} bf16: plain "
            f"{r['plain_ms']:.4f} ms, fuse {r['fuse_ms']:.4f} ms, fold "
            f"{r['fold_ms']:.4f} ms | {card}")
    log(f"[separable] total over {len(records)} shapes: plain "
        f"{totals['plain']:.4f} ms, fuse {totals['fuse']:.4f} ms, fold "
        f"{totals['fold']:.4f} ms (best of {SEPARABLE_RUNS} x "
        f"{SEPARABLE_ITERS} calls); "
        f"launches in the benchmark {launches}; phase "
        f"{time.perf_counter() - phase_t0:.1f} s | {card}")
    bound_ms, bound_by = separable_bounds(SEPARABLE_SHAPES, BATCH,
                                          backward=False)
    log(f"[separable] bound over the {len(records)} shapes: "
        f"{bound_ms:.4f} ms ({bound_by}); fuse at "
        f"{100 * bound_ms / totals['fuse']:.1f} %, fold at "
        f"{100 * bound_ms / totals['fold']:.1f} % of it")
    gemm_ms = gemm_yardstick(device, backward=False)
    for r, shape, lib_ms in zip(records, SEPARABLE_SHAPES, gemm_ms):
        ms, by, nbytes, flops = separable_bound(shape, BATCH, backward=False)
        label = (f"T={r['T']:3d} {r['Cin']}->{r['Cout']} s{r['stride']} "
                 f"{r['padding']:5s}")
        log(f"[separable] {label} bound {ms:.4f} ms ({by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); fuse "
            f"{r['fuse_ms']:.4f} ms, share {100 * ms / r['fuse_ms']:.1f} %; "
            f"fold {r['fold_ms']:.4f} ms, share "
            f"{100 * ms / r['fold_ms']:.1f} %; plain {r['plain_ms']:.4f} ms; "
            f"yardstick, the pointwise product alone in cuBLAS (torch.matmul "
            f"of a precomputed bf16 dw by w_pw) {lib_ms:.4f} ms | {card}")
    log(f"[separable] yardstick total {sum(gemm_ms):.4f} ms; no single "
        f"library call computes the block, so library_ms is null")
    return [{
        "name": f"separable_block/{variant}",
        "route": "cuda",
        "source": "speech_recognition_tpu_torch/csrc/separable_block.cu",
        "replaces": "speech_recognition_tpu/ops/pallas/experiments/"
                    "separable_kernel.py:167",
        "launches": launches[variant],
        "max_abs_err": worst[variant],
        "ms": totals[variant],
        "plain_ms": totals["plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    } for variant in ("fuse", "fold")]


def bwd_operands(shape, device):
    """The inputs of the backward at ``shape``, batch 384, bf16, with the
    cotangents and the prologue: ``(args, kw)`` for
    ``separable_block_bwd``."""
    from speech_recognition_tpu_torch.export.benchmark import (
        separable_block_cotangents, separable_block_inputs,
    )
    from speech_recognition_tpu_torch.ops.kernels import (
        separable_block as S,
    )
    t, cin, cout, stride, padding = shape
    x, w_dw, w_pw, a, b = separable_block_inputs(t, cin, cout, batch=BATCH,
                                                 device=device)
    kw = dict(stride=stride, padding=padding)
    y = S.separable_block_plain(x, w_dw, w_pw, a, b, **kw)[0]
    dy, ds1, ds2 = separable_block_cotangents(y.shape[1], cout, batch=BATCH,
                                              device=device)
    return (x, y, dy, ds1, ds2, w_dw, w_pw, a, b), kw


def fwd_operands(shape, device):
    """The forward's inputs at ``shape``, batch 384, bf16, with the
    prologue: ``(args, kw)`` for ``fused_separable_block``."""
    from speech_recognition_tpu_torch.export.benchmark import (
        separable_block_inputs,
    )
    t, cin, cout, stride, padding = shape
    return (separable_block_inputs(t, cin, cout, batch=BATCH, device=device),
            dict(stride=stride, padding=padding))


def gemm_yardstick(device, backward: bool):
    """ms per shape of the block's pointwise products alone by
    ``torch.matmul`` (cuBLAS) on bf16 operands computed beforehand with
    the plain version's arithmetic: forward dw @ w_pw; backward dw^T @
    dyt and dyt @ w_pw^T. What a library gives for the GEMM part; the
    port never calls it."""
    from speech_recognition_tpu_torch.export.benchmark import (
        SEPARABLE_ITERS, SEPARABLE_RUNS, SEPARABLE_SHAPES, time_calls,
    )
    from speech_recognition_tpu_torch.ops.kernels import (
        separable_block as S,
    )
    out = []
    for shape in SEPARABLE_SHAPES:
        (x, y, dy, ds1, ds2, w_dw, w_pw, a, b), kw = bwd_operands(shape,
                                                                  device)
        t, cin, cout = shape[:3]
        t_out, pad_lo = S.out_len(t, 3, kw["stride"], kw["padding"])
        xin = torch.clamp(x * a.bfloat16() + b.bfloat16(), 0, 6)
        dw = S._depthwise_fuse(xin, w_dw, kw["stride"], pad_lo,
                               t_out).reshape(-1, cin)
        wpw = w_pw.reshape(cin, cout)
        if backward:
            dyt = (dy.float() + ds1 + 2 * y.float() * ds2).bfloat16() \
                .reshape(-1, cout)
            out.append(time_calls(lambda: (torch.matmul(dw.T, dyt),
                                           torch.matmul(dyt, wpw.T)),
                                  SEPARABLE_ITERS, SEPARABLE_RUNS))
        else:
            out.append(time_calls(lambda: torch.matmul(dw, wpw),
                                  SEPARABLE_ITERS, SEPARABLE_RUNS))
    return out


def profile_kernels(groups) -> None:
    """Device time by kernel by ``torch.profiler``, in one session for
    every ``(tag, what, calls)`` group: the calls (one per trunk shape,
    each after a warm-up call) run inside a ``record_function`` range of
    their group that ends in a synchronize, so each kernel counts for the
    group whose range holds its start (kernels launched through ctypes
    are linked to no torch op, so the profiler's own attribution misses
    them). Logs per group the sums over its calls."""
    for _, _, calls in groups:
        for fn in calls:
            fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    label = "profiled group "
    with torch.profiler.profile(activities=acts) as prof:
        for i, (_, _, calls) in enumerate(groups):
            with torch.profiler.record_function(f"{label}{i}"):
                for fn in calls:
                    fn()
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ranges = {int(e.name[len(label):]): e.time_range for e in prof.events()
              if e.device_type != cuda and e.name.startswith(label)}
    sums = [{} for _ in groups]
    for e in prof.events():
        if e.device_type != cuda or e.is_user_annotation \
                or e.name.startswith(label):
            continue
        i = next((i for i, r in ranges.items()
                  if r.start <= e.time_range.start <= r.end), None)
        if i is None:
            continue
        found = re.search(r"\w+_kernel\b", e.name)
        name = found.group(0) if found else e.name.split("(")[0].strip()
        sums[i][name] = sums[i].get(name, 0.0) \
            + (e.time_range.end - e.time_range.start) / 1e3
    for (tag, what, calls), kernels in zip(groups, sums):
        if not kernels:
            log(f"{tag} profiler, {what}: no device time recorded")
            continue
        busy = sum(kernels.values())
        log(f"{tag} profiler, {what}, device ms summed over the {len(calls)} "
            f"shapes: busy {busy:.4f}; " + ", ".join(
                f"{n} {ms:.4f} ({100 * ms / busy:.0f} %)" for n, ms in
                sorted(kernels.items(), key=lambda kv: -kv[1])))


def vjp_grad_call(shape, device):
    """One ``vjp_grad`` call of the gradient benchmark at ``shape`` as a
    callable: autograd.grad through ``fused_separable_block_vjp`` to its
    five leaves (bf16 x, w_dw, w_pw; f32 a, b). Returns ``(call, leaves,
    cotangents, kw)``."""
    from speech_recognition_tpu_torch.ops.kernels import (
        separable_block as S,
    )
    (x, _, dy, ds1, ds2, w_dw, w_pw, a, b), kw = bwd_operands(shape, device)
    leaves = [v.detach().requires_grad_() for v in (x, a, b, w_dw, w_pw)]
    cts = (dy, ds1, ds2)
    return (lambda: torch.autograd.grad(S.fused_separable_block_vjp(
        *leaves, kw["stride"], kw["padding"]), leaves, cts),
        leaves, cts, kw)


def profile_separable(device) -> None:
    """The profiler's account of the separable block's kernels: one
    ``fuse``, one ``fold``, one backward and one ``vjp_grad`` call per
    trunk shape."""
    from speech_recognition_tpu_torch.export.benchmark import (
        SEPARABLE_SHAPES,
    )
    from speech_recognition_tpu_torch.ops.kernels import (
        separable_block as S,
    )
    devices = [device] * len(SEPARABLE_SHAPES)
    fwd = list(map(fwd_operands, SEPARABLE_SHAPES, devices))
    profile_kernels([
        ("[separable]", f"one {variant} call per shape", [
            functools.partial(S.fused_separable_block, *ins,
                              fold_weights=variant == "fold", **kw)
            for ins, kw in fwd])
        for variant in ("fuse", "fold")] + [
        ("[separable-bwd]", "one bwd call per shape", [
            functools.partial(S.separable_block_bwd, *args, **kw)
            for args, kw in map(bwd_operands, SEPARABLE_SHAPES, devices)]),
        ("[separable-bwd]", "one vjp_grad call per shape", [
            vjp_grad_call(shape, device)[0] for shape in SEPARABLE_SHAPES])])


class _NoLaunch(torch.autograd.Function):
    """The VJP's leaves and outputs with nothing launched: ``apply(x, a, b,
    w_dw, w_pw, zeros, outs)`` returns empty tensors like ``outs`` and
    takes ``zeros`` as the leaves' gradients. What autograd costs alone."""

    @staticmethod
    def forward(ctx, x, a, b, w_dw, w_pw, zeros, outs):
        ctx.zeros = zeros
        return tuple(torch.empty_like(o) for o in outs)

    @staticmethod
    def backward(ctx, *cts):
        return (*ctx.zeros, None, None)


def vjp_host_account(device, card: str) -> None:
    """Where ``vjp_grad``'s time goes when the host sets its pace: ms per
    call on the host clock, summed over the 11 trunk shapes, of
    autograd.grad through a Function that launches nothing (autograd's
    own cost, with the VJP's leaves and outputs), of the forward alone
    (``fused_separable_block_vjp``, recording the graph), of the backward
    wrapper alone, of ``SeparableBlockFunction.backward`` called on this
    thread, of autograd.grad through the real forward whose backward
    returns gradients made beforehand, and of the whole ``vjp_grad``
    call. Each is the best of 3 runs of 20 calls after one call, with no
    synchronize inside a run, so it is host time: the card's queue never
    fills."""
    from speech_recognition_tpu_torch.export.benchmark import (
        SEPARABLE_ITERS, SEPARABLE_RUNS, SEPARABLE_SHAPES,
    )
    from speech_recognition_tpu_torch.ops.kernels import (
        separable_block as S,
    )

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(SEPARABLE_RUNS):
            t0 = time.perf_counter()
            for _ in range(SEPARABLE_ITERS):
                fn()
            best = min(best, (time.perf_counter() - t0) / SEPARABLE_ITERS)
            torch.cuda.synchronize()
        return 1e3 * best

    class ForwardOnly(S.SeparableBlockFunction):
        """The VJP's forward; its backward returns ``grads``."""
        grads = None

        @staticmethod
        def backward(ctx, *cts):
            return ForwardOnly.grads

    parts = {"autograd.grad through a Function that launches nothing": 0.0,
             "the forward (fused_separable_block_vjp)": 0.0,
             "the backward wrapper (separable_block_bwd)": 0.0,
             "SeparableBlockFunction.backward on the calling thread": 0.0,
             "autograd.grad through the forward with a backward that "
             "launches nothing": 0.0,
             "the whole vjp_grad call": 0.0}
    names = list(parts)
    for shape in SEPARABLE_SHAPES:
        call, leaves, cts, kw = vjp_grad_call(shape, device)
        x, a, b, w_dw, w_pw = leaves
        y, s1, s2 = (v.detach() for v in S.fused_separable_block(
            x, w_dw, w_pw, a, b, **kw))
        zeros = tuple(torch.zeros_like(v) for v in leaves)
        ForwardOnly.grads = (*zeros, None, None)
        args = [v.detach() for v in (x, y, *cts, w_dw, w_pw, a, b)]
        ctx = types.SimpleNamespace(
            saved_tensors=(*(v.detach() for v in leaves), y), conv=kw)
        fns = (lambda: torch.autograd.grad(_NoLaunch.apply(
                   *leaves, zeros, (y, s1, s2)), leaves, cts),
               lambda: S.fused_separable_block_vjp(*leaves, kw["stride"],
                                                   kw["padding"]),
               lambda: S.separable_block_bwd(*args, **kw),
               lambda: S.SeparableBlockFunction.backward(ctx, *cts),
               lambda: torch.autograd.grad(ForwardOnly.apply(
                   *leaves, kw["stride"], kw["padding"]), leaves, cts),
               call)
        for name, fn in zip(names, fns):
            parts[name] += host_ms(fn)
    log(f"[separable-bwd] vjp_grad on the host clock, ms per call summed "
        f"over the {len(SEPARABLE_SHAPES)} shapes: " + ", ".join(
            f"{n} {ms:.4f}" for n, ms in parts.items()) + f" | {card}")


def compare_bwd(got, want, dtype):
    """Per output of the backward (dx, dw_dw, dw_pw, da, db; da and db
    only with the prologue): (max abs err, max abs err relative to the
    output's largest |value|, elements out of tolerance) of the kernel's
    ``got`` against ``want``."""
    errs = {}
    for name, g, w in zip(BWD_NAMES, got, want):
        if (g is None) != (w is None):
            raise RuntimeError(f"backward {name}: {g} against {w}")
        if w is None:
            continue
        want_dtype = dtype if name == "dx" else torch.float32
        if g.shape != w.shape or g.dtype != want_dtype \
                or not torch.isfinite(g).all():
            raise RuntimeError(f"backward {name} {g.dtype} {tuple(g.shape)}"
                               f" (want {want_dtype} {tuple(w.shape)}), or "
                               f"non-finite values")
        d = (g.float() - w.float()).abs()
        scale = float(w.float().abs().max())
        rtol, atol = (SEP_BWD_DX_TOL[dtype] if name == "dx"
                      else (0.0, SEP_BWD_SUM_RTOL[dtype]))
        bad = int((d > rtol * w.float().abs() + atol * scale).sum())
        errs[name] = (float(d.max()), float(d.max()) / max(scale, 1e-30), bad)
    return errs


def separable_bwd_phase(device, card: str, build_s: float,
                        ptxas: list[str]):
    """The separable block's backward: kernel against plain at the 11
    trunk shapes and two extra cases, the VJP against autograd of the
    ATen block, then the forward+backward benchmark, each shape's time
    against its bound, the cuBLAS yardstick and a profile of the
    backward's kernels. Returns the ``kernels`` entry."""
    from speech_recognition_tpu_torch.export.benchmark import (
        SEPARABLE_ITERS, SEPARABLE_RUNS, SEPARABLE_SHAPES,
        benchmark_separable_block_grads, separable_block_cotangents,
        separable_block_inputs,
    )
    from speech_recognition_tpu_torch.ops.kernels import (
        separable_block as S,
    )

    phase_t0 = time.perf_counter()
    log(f"[separable-bwd] library built in {build_s:.2f} s | tolerances, "
        f"relative to each output's max |value|: dx f32 atol 1e-5 (TF32 "
        f"off), bf16 rtol 2^-6 atol 2^-8; dw_dw, dw_pw, da, db f32 "
        f"{SEP_BWD_SUM_RTOL[torch.float32]}, bf16 "
        f"{SEP_BWD_SUM_RTOL[torch.bfloat16]}; VJP against autograd "
        f"{VJP_GRAD_RTOL}")
    for line in ptxas:
        log(f"[separable-bwd] ptxas -v {line}")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    before = separable_runs()
    calls = 0
    worst = 0.0
    failures = []

    def check(label, dtype, x, w_dw, w_pw, a, b, **kw):
        nonlocal calls, worst
        y = S.separable_block_plain(x, w_dw, w_pw, a, b, **kw)[0]
        cts = separable_block_cotangents(y.shape[1], w_pw.shape[2],
                                         batch=x.shape[0], dtype=dtype,
                                         device=device)
        args = (x, y, *cts, w_dw, w_pw, a, b)
        got = S.separable_block_bwd(*args, **kw)
        calls += 1
        errs = compare_bwd(got, S.separable_block_bwd_plain(*args, **kw),
                           dtype)
        worst = max([worst] + [e[0] for e in errs.values()])
        bad = {n: e[2] for n, e in errs.items() if e[2]}
        if bad:
            failures.append(f"{label} {dtype}: out of tolerance {bad}; "
                            f"{errs}")
        return got, errs

    for t, cin, cout, stride, padding in SEPARABLE_SHAPES:
        x, w_dw, w_pw, a, b = separable_block_inputs(
            t, cin, cout, batch=BATCH, dtype=torch.float32, device=device)
        parts = []
        for dtype in (torch.bfloat16, torch.float32):
            _, errs = check(f"T={t} {cin}->{cout} s{stride}", dtype,
                            *(v.to(dtype) for v in (x, w_dw, w_pw)), a, b,
                            stride=stride, padding=padding)
            parts.append(f"{str(dtype)[6:]} " + " ".join(
                f"{n} {e[1]:.2g}" for n, e in errs.items()))
        torch.cuda.synchronize()
        log(f"[separable-bwd] T={t:3d} {cin}->{cout} s{stride} "
            f"{padding:5s} B={BATCH}: max abs err / max |value|: "
            + "; ".join(parts))
    # a stride-2 SAME shape without the prologue, and a VALID stride-2
    # shape with T - k odd (its last input row feeds no output)
    t, cin, cout, stride, padding = SEPARABLE_SHAPES[1]
    x, w_dw, w_pw, _, _ = separable_block_inputs(t, cin, cout, batch=BATCH,
                                                 device=device)
    check("no prologue", torch.bfloat16, x, w_dw, w_pw, None, None,
          stride=stride, padding=padding)
    x, w_dw, w_pw, a, b = separable_block_inputs(t + 1, cin, cout,
                                                 batch=BATCH, device=device)
    got, _ = check("odd VALID", torch.bfloat16, x, w_dw, w_pw, a, b,
                   stride=2, padding="VALID")
    if not (got[0][:, -1] == 0).all():
        failures.append(f"T={t + 1} s2 VALID: the last input row has a "
                        f"gradient")
    torch.cuda.synchronize()
    log(f"[separable-bwd] T={t} {cin}->{cout} s{stride} {padding} bf16 "
        f"without the prologue, and T={t + 1} s2 VALID (last row dx 0): "
        f"checked")

    # the VJP in f32 against autograd of the ATen block
    vjp_before = separable_runs()
    leaves = [v.float().requires_grad_() for v in separable_block_inputs(
        t, cin, cout, batch=BATCH, device=device)]
    x, w_dw, w_pw, a, b = leaves
    cts = separable_block_cotangents(S.out_len(t, 3, stride, padding)[0],
                                     cout, batch=BATCH, dtype=torch.float32,
                                     device=device)
    got = torch.autograd.grad(S.fused_separable_block_vjp(
        x, a, b, w_dw, w_pw, stride, padding), leaves, cts)
    after = separable_runs()
    rose = {v: after[v] - vjp_before[v] for v in after}
    if rose != {"fuse": 0, "fold": 1, "bwd": 1}:
        raise RuntimeError(f"the VJP launched {rose}")
    want = torch.autograd.grad(S.reference_block(
        x, w_dw, w_pw, a, b, stride=stride, padding=padding), leaves, cts)
    vjp_errs = {}
    for name, g, w in zip(("dx", "dw_dw", "dw_pw", "da", "db"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise RuntimeError(f"VJP {name} {g.dtype} {tuple(g.shape)}")
        vjp_errs[name] = float((g - w).abs().max()) / float(w.abs().max())
    if max(vjp_errs.values()) > VJP_GRAD_RTOL:
        failures.append(f"VJP against autograd: {vjp_errs}")
    log(f"[separable-bwd] VJP T={t} {cin}->{cout} s{stride} {padding} "
        f"B={BATCH} f32, gradients against autograd of reference_block, "
        f"max abs err / max |value|: " + ", ".join(
            f"{n} {e:.2g}" for n, e in vjp_errs.items()))
    del leaves, x, w_dw, w_pw, a, b, got, want
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    after = separable_runs()
    rose = {v: after[v] - before[v] for v in after}
    if rose != {"fuse": 0, "fold": 1, "bwd": calls + 1}:
        raise RuntimeError(f"separable runs rose by {rose} in {calls} "
                           f"backward calls and one VJP")
    if failures:
        raise RuntimeError("separable backward: " + "; ".join(failures))

    # the path: the gradient benchmark, with the counts set to 0 just before
    launch.reset_runs()
    records = benchmark_separable_block_grads(device)
    launches = separable_runs()
    per_variant = 1 + SEPARABLE_ITERS * SEPARABLE_RUNS
    # per shape: one forward for y, then vjp_grad (fold + bwd) and bwd
    expected = {"fuse": 0,
                "fold": len(SEPARABLE_SHAPES) * (1 + per_variant),
                "bwd": len(SEPARABLE_SHAPES) * 2 * per_variant}
    if launches != expected:
        raise RuntimeError(f"the gradient benchmark launched {launches}, "
                           f"expected {expected}")
    names = ("plain_grad", "vjp_grad", "bwd", "bwd_plain")
    totals = {v: sum(r[f"{v}_ms"] for r in records) for v in names}
    for r in records:
        if not all(np.isfinite(r[f"{v}_ms"]) and r[f"{v}_ms"] > 0
                   for v in names):
            raise RuntimeError(f"benchmark record {r}")
        log(f"[separable-bwd] bench T={r['T']:3d} {r['Cin']}->{r['Cout']} "
            f"s{r['stride']} {r['padding']:5s} B={r['batch']} bf16: "
            + ", ".join(f"{v} {r[f'{v}_ms']:.4f} ms" for v in names)
            + f" | {card}")
    log(f"[separable-bwd] total over {len(records)} shapes: " + ", ".join(
        f"{v} {totals[v]:.4f} ms" for v in names)
        + f" (best of {SEPARABLE_RUNS} x {SEPARABLE_ITERS} calls); launches "
        f"in the benchmark {launches}; phase "
        f"{time.perf_counter() - phase_t0:.1f} s | {card}")
    bound_ms, bound_by = separable_bounds(SEPARABLE_SHAPES, BATCH,
                                          backward=True)
    log(f"[separable-bwd] bound over the {len(records)} shapes: "
        f"{bound_ms:.4f} ms ({bound_by}); bwd at "
        f"{100 * bound_ms / totals['bwd']:.1f} % of it")
    gemm_ms = gemm_yardstick(device, backward=True)
    for r, shape, lib_ms in zip(records, SEPARABLE_SHAPES, gemm_ms):
        ms, by, nbytes, flops = separable_bound(shape, BATCH, backward=True)
        label = (f"T={r['T']:3d} {r['Cin']}->{r['Cout']} s{r['stride']} "
                 f"{r['padding']:5s}")
        log(f"[separable-bwd] {label} bwd {r['bwd_ms']:.4f} ms, bound "
            f"{ms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
            f"GFLOP), share {100 * ms / r['bwd_ms']:.1f} % | {card}")
        log(f"[separable-bwd] {label} yardstick, the two products alone in "
            f"cuBLAS (torch.matmul on precomputed bf16 dw, dyt, w_pw): "
            f"{lib_ms:.4f} ms | {card}")
    log(f"[separable-bwd] yardstick total {sum(gemm_ms):.4f} ms; no single "
        f"library call computes the backward, so library_ms is null")
    return {
        "name": "separable_block/bwd",
        "route": "cuda",
        "source": "speech_recognition_tpu_torch/csrc/separable_block_bwd.cu",
        "replaces": "speech_recognition_tpu/ops/pallas/experiments/"
                    "separable_kernel.py:391",
        "launches": launches["bwd"],
        "max_abs_err": worst,
        "ms": totals["bwd"],
        "plain_ms": totals["bwd_plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def gru_phase(device, card: str, build_s: float, ptxas: list[str]) -> dict:
    """The [gru] phase: the recurrence kernels against their plain twin at
    ``GRU_SHAPES``, then ``benchmark_gru``. The bound of the two kernels
    (``bound_ms``) is the larger of the bytes the recurrence has to move
    over 3.35 TB/s (its inputs read once: the projections, the last
    state's gradient, the recurrent weights and masks; its outputs
    written once: the last state and the projections' gradient) and its
    products' FLOPs over 989 TFLOP/s. The forward's saves (yz, yr, hh and
    the states in f32, written and read back; the products' A operands,
    written for the weights' gradients) are the design's own traffic,
    logged beside it and left out of the bound. The record's launches
    are filled in by ``[zoo]``'s BiGRU train steps (``launch.runs``)."""
    from speech_recognition_tpu_torch.export.benchmark import (
        GRU_BATCH, GRU_SHAPES, benchmark_gru,
    )
    from speech_recognition_tpu_torch.ops.kernels import gru as G

    for line in ptxas:
        log(f"[gru] ptxas -v {line}")
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max())
    worst, bounds = 0.0, {}
    for name, (_, u, t) in GRU_SHAPES.items():
        g = torch.Generator().manual_seed(4)
        xws = [torch.randn(GRU_BATCH, t, 3 * u, generator=g).to(device)
               for _ in range(2)]
        wzr, wh = ((torch.randn(2, n * u, u, generator=g) / u ** 0.5).to(
            device, torch.bfloat16) for n in (2, 1))
        rm = ((torch.rand(2, 3, GRU_BATCH, u, generator=g) > 0.2).float()
              / 0.8).to(device)
        reverse = (False, True)
        got = G.gru_forward(xws, wzr, wh, rm, reverse)
        want = G.gru_forward_plain(xws, wzr, wh, rm, reverse)
        dlast = torch.randn(got[0].shape, generator=g).to(device)
        dxw = G.gru_backward(dlast, None, wzr, wh, rm, reverse, want[1],
                             *want[2][:3], torch.float32)
        dxw_plain = G.gru_backward_plain(dlast, None, wzr, wh, rm, reverse,
                                         want[1], *want[2][:3],
                                         torch.float32)
        errs = [rel(got[0], want[0]), rel(got[1], want[1]),
                rel(dxw, dxw_plain)]
        torch.cuda.synchronize()
        if not max(errs) <= GRU_RTOL:
            raise RuntimeError(f"[gru] {name}: kernels against the plain "
                               f"twin (last, states, dxw): {errs}")
        worst = max(worst, *errs)
        rows = 2 * GRU_BATCH * t
        io, op = xws[0].element_size(), wzr.element_size()
        nbytes = (2 * rows * 3 * u * io                     # xw, dxw
                  + 2 * got[0].numel() * io                 # last, dlast
                  + (wzr.numel() + wh.numel()) * op + rm.numel() * 4)
        saves = rows * 4 * u * 4 * 2 + rows * 3 * u * op
        flops = 2 * 2 * rows * 3 * u * u
        bounds[name] = max(nbytes / 3.35e12, flops / 989e12) * 1e3
        log(f"[gru] {name} B={GRU_BATCH} T={t} u={u}: kernels against the "
            f"plain twin, largest gap over largest value: last {errs[0]:.3g}"
            f", states {errs[1]:.3g}, dxw {errs[2]:.3g} (tol {GRU_RTOL}); "
            f"bound {bounds[name]:.4f} ms ({nbytes / 1e6:.1f} MB in and "
            f"out, {flops / 1e9:.2f} GFLOP); the saves' own traffic "
            f"{saves / 1e6:.1f} MB, {saves / 3.35e9:.4f} ms more")
    records = benchmark_gru(device)
    for r in records:
        log(f"[gru] {r['shape']} batch {r['batch']}: train forward+backward "
            f"{r['train_kernel_ms']:.4f} ms through the kernels, "
            f"{r['train_loop_ms']:.4f} ms through the loop; forward kernel "
            f"{r['forward_kernel_ms']:.4f} ms, backward kernel "
            f"{r['backward_kernel_ms']:.4f} ms; f32 eval forward "
            f"{r['eval_f32_kernel_ms']:.4f} / {r['eval_f32_loop_ms']:.4f} "
            f"ms; build {build_s:.1f} s | {card}")
    main = records[0]
    return {
        "name": "gru_recurrence",
        "route": "cuda",
        "source": "speech_recognition_tpu_torch/csrc/gru_recurrence.cu",
        "replaces": None,
        "launches": None,
        "max_abs_err": worst,
        "ms": main["forward_kernel_ms"] + main["backward_kernel_ms"],
        "plain_ms": main["train_loop_ms"],
        "bound_ms": bounds[main["shape"]],
        "bound_by": "bytes",
        "library_ms": None,
    }


def bn_shapes(model_name: str) -> list:
    """The (C, T) of each train-mode BatchNorm input of ``model_name``, in
    the forward's order (one CPU pass at batch 2 on raw waveforms)."""
    from speech_recognition_tpu_torch.models.layers import BatchNorm
    from speech_recognition_tpu_torch.models.zoo import build_model

    model, _ = build_model(model_name, num_classes=12)
    shapes = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(lambda m, i, o: shapes.append(
                (i[0].shape[1], i[0][0, 0].numel())))
    with torch.no_grad():
        model.train()(torch.randn(2, T) * 0.1, torch.Generator())
    return shapes


def device_ms_by_kernel(fn, iters: int = BN_ITERS) -> dict:
    """Device ms of each kernel name, a call of ``fn`` on average, in a
    ``torch.profiler`` trace of ``iters`` calls after one untimed."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == cuda and not e.is_user_annotation:
            out[e.name] = out.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / iters / 1e3
    return out


def bn_phase(device, card: str, ptxas: list[str]) -> dict:
    """The [bn] phase: train-mode BatchNorm's kernels (``ops/kernels/
    batchnorm.py``) at every BatchNorm input of the benchmark's three
    models, batch 384, bf16 (the train step's): the kernels against
    their plain twin at each distinct shape (y and dx within a bf16 step
    of their largest value, the statistics and the weights' gradients
    within ``BN_STATS_RTOL`` of theirs), then, for each model, the device
    ms of one step's BatchNorms forward and backward (each layer once,
    the backward in reverse order) through the four kernels, through
    the plain twin, through ATen's ``F.batch_norm`` and through the
    layer before the kernels (``var_mean`` of an f32 copy, then
    ``F.batch_norm``),
    beside the bytes the function has to move (x read and y written
    forward; x and dy read and dx written backward: 10 B an element in
    bf16) and the 16 B of the kernels' two-pass design, over 3.35 TB/s.
    The record's launches are filled in by ``[slice]`` and ``[zoo]``."""
    import torch.nn.functional as F

    from speech_recognition_tpu_torch.ops.kernels import batchnorm as BN

    for line in ptxas:
        log(f"[bn] ptxas -v {line}")
    eps = 1e-3
    models, inputs, worst = {}, {}, 0.0
    for name in BN_MODELS:
        models[name] = bn_shapes(name)
        for ct in models[name]:
            if ct in inputs:
                continue
            g = torch.Generator().manual_seed(len(inputs))
            shape = (BATCH, ct[0], ct[1])
            x = (torch.randn(shape, generator=g) * 2 + 0.5).to(
                device, torch.bfloat16)
            dy = torch.randn(shape, generator=g).to(device, torch.bfloat16)
            w = (1 + 0.2 * torch.randn(ct[0], generator=g)).to(device)
            b = (0.1 * torch.randn(ct[0], generator=g)).to(device)
            inputs[ct] = (x, w, b, dy)
            got = BN.bn_forward(x, w, b, eps)
            want = BN.bn_forward_plain(x, w, b, eps)
            gotb = BN.bn_backward(dy, x, w, got[1], got[3])
            wantb = BN.bn_backward_plain(dy, x, w, want[1], want[3])
            torch.cuda.synchronize()
            rel = lambda a, c: float((a.float() - c.float()).abs().max()
                                     / c.float().abs().max())
            gaps = {"y": rel(got[0], want[0]), "dx": rel(gotb[0], wantb[0])}
            stats = {"mean": rel(got[1], want[1]), "var": rel(got[2], want[2]),
                     "dweight": rel(gotb[1], wantb[1]),
                     "dbias": rel(gotb[2], wantb[2])}
            if max(gaps.values()) > 2.0 ** -7 \
                    or max(stats.values()) > BN_STATS_RTOL:
                raise RuntimeError(f"[bn] {shape}: kernels against the "
                                   f"plain twin {gaps} {stats}")
            worst = max(worst, *gaps.values())
    log(f"[bn] kernels against the plain twin at {len(inputs)} shapes, "
        f"batch {BATCH}, bf16: largest gap over largest value {worst:.3g} "
        f"in y and dx (tol 2^-7), statistics and weight gradients within "
        f"{BN_STATS_RTOL} | {card}")

    def kernels(shapes):
        def run():
            saved = [BN.bn_forward(*inputs[ct][:3], eps) for ct in shapes]
            for ct, (_, mean, _, invstd) in zip(shapes[::-1], saved[::-1]):
                x, w, _, dy = inputs[ct]
                BN.bn_backward(dy, x, w, mean, invstd)
        return run

    def plain(shapes):
        def run():
            saved = [BN.bn_forward_plain(*inputs[ct][:3], eps)
                     for ct in shapes]
            for ct, (_, mean, _, invstd) in zip(shapes[::-1], saved[::-1]):
                x, w, _, dy = inputs[ct]
                BN.bn_backward_plain(dy, x, w, mean, invstd)
        return run

    def aten(shapes, with_var_mean):
        def run():
            ys = []
            for ct in shapes:
                x, w, b, _ = inputs[ct]
                x = x.detach().requires_grad_(True)
                if with_var_mean:
                    with torch.no_grad():
                        torch.var_mean(x.float(), dim=(0, 2), correction=0)
                ys.append(F.batch_norm(x, None, None, w, b, training=True,
                                       eps=eps))
            for ct, y in zip(shapes[::-1], ys[::-1]):
                y.backward(inputs[ct][3])
        return run

    records = {}
    for name, shapes in models.items():
        elements = sum(BATCH * c * t for c, t in shapes)
        k = device_ms_by_kernel(kernels(shapes))
        by_kernel = {n: sum(v for e, v in k.items() if n in e)
                     for n in BN_KERNELS}
        ms = sum(by_kernel.values())
        plain_ms = sum(device_ms_by_kernel(plain(shapes)).values())
        aten_ms = sum(device_ms_by_kernel(aten(shapes, False)).values())
        before_ms = sum(device_ms_by_kernel(aten(shapes, True)).values())
        b10, b16 = (1e3 * n * elements / HBM_BYTES_PER_S for n in (10, 16))
        records[name] = {"ms": ms, "plain_ms": plain_ms, "aten_ms": aten_ms,
                         "before_ms": before_ms, "bound_ms": b10}
        log(f"[bn] {name}: {len(shapes)} BatchNorms, {elements:,} elements "
            f"a step; kernels {ms:.4f} ms ("
            + ", ".join(f"{n} {v:.4f}" for n, v in by_kernel.items())
            + f"); bound {b10:.4f} ms at 10 B an element ({100 * b10 / ms:.1f}"
            f" %), {b16:.4f} ms at 16 B ({100 * b16 / ms:.1f} %); plain twin "
            f"{plain_ms:.4f} ms; ATen F.batch_norm forward and backward "
            f"{aten_ms:.4f} ms; the layer before the kernels (var_mean of an "
            f"f32 copy, then F.batch_norm) {before_ms:.4f} ms; device ms a "
            f"step, "
            f"mean of {BN_ITERS} | {card}")
    main = records[MODEL]
    return {
        "name": "batchnorm",
        "route": "cuda",
        "source": "speech_recognition_tpu_torch/csrc/batchnorm.cu",
        "replaces": None,
        "launches": None,
        "max_abs_err": worst,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["aten_ms"],
    }


def pool_shapes(model_name: str) -> list:
    """(C, T, pool, stride, padding) of each last-axis max pool of
    ``model_name``, in the forward's order (one CPU pass at batch 2 on
    its representation's input at the default geometry)."""
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.models.zoo import build_model
    from speech_recognition_tpu_torch.ops.frontend import Frontend

    s = prepare_model_settings(label_count=12)
    model, spec = build_model(
        model_name, num_classes=12, spectrogram_length=s.spectrogram_length,
        num_log_mel_features=s.num_log_mel_features,
        spectrogram_frequencies=s.spectrogram_frequencies,
        window_size_samples=s.window_size_samples,
        window_stride_samples=s.window_stride_samples)
    x = Frontend(s).features(torch.randn(2, T) * 0.1, spec.representation)
    with recording_pools() as shapes, torch.no_grad():
        model.train()(x, torch.Generator())
    return shapes


@contextlib.contextmanager
def recording_pools():
    """Within: (C, T, pool, stride, padding) of each max pool along a
    last axis (``models/layers.py::_max_pool_axis``, which the max-pool
    kernels take on a card), appended to the list it gives, in order."""
    from speech_recognition_tpu_torch.models import layers as L

    shapes, chain = [], L._max_pool_axis

    def hook(x, pool, stride, padding, dim):
        if dim % x.ndim == x.ndim - 1:
            shapes.append((x.shape[1], x.shape[-1], pool, stride, padding))
        return chain(x, pool, stride, padding, dim)

    L._max_pool_axis = hook
    try:
        yield shapes
    finally:
        L._max_pool_axis = chain


def maxpool_phase(device, card: str, ptxas: list[str]) -> dict:
    """The [maxpool] phase: the max-pool kernels (``ops/kernels/
    maxpool.py``) at every pool of the benchmark's two pooling models,
    batch 384, bf16 (the train step's): the kernels against their plain
    twin at each distinct shape (y and dx bit for bit: both take the
    same f32 sums in the same order), then, for each model, the device
    ms of one step's pools forward and backward (each pool once, the
    backward in reverse order) through the two kernels, through the
    plain twin and through the chain of ``torch.maximum`` with its
    autograd (the layer before the kernels; no one PyTorch call computes
    this function: ``F.max_pool1d`` splits no tie), beside the bytes the
    function has to move (x read and y written forward; x and dy read
    and dx written backward) over 3.35 TB/s. Launches are counted where
    the train steps of [slice] and [zoo] run them (``launch.runs``)."""
    from speech_recognition_tpu_torch.models import layers as L
    from speech_recognition_tpu_torch.ops.kernels import maxpool as MP

    for line in ptxas:
        log(f"[maxpool] ptxas -v {line}")
    models, inputs = {}, {}
    for name in MAXPOOL_MODELS:
        models[name] = pool_shapes(name)
        for shape in models[name]:
            if shape in inputs:
                continue
            c, t, pool, stride, padding = shape
            g = torch.Generator().manual_seed(len(inputs))
            out = MP.window(t, pool, stride, padding)[0]
            x = torch.randn((BATCH, c, t), generator=g).relu().to(
                device, torch.bfloat16)
            dy = torch.randn((BATCH, c, out), generator=g).to(
                device, torch.bfloat16)
            inputs[shape] = (x, dy)
            got = (MP.maxpool_forward(x, pool, stride, padding),
                   MP.maxpool_backward(dy, x, pool, stride, padding))
            want = (MP.maxpool_forward_plain(x, pool, stride, padding),
                    MP.maxpool_backward_plain(dy, x, pool, stride, padding))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"[maxpool] {shape}: kernels against "
                                   f"the plain twin differ")
    log(f"[maxpool] kernels against the plain twin at {len(inputs)} "
        f"shapes, batch {BATCH}, bf16: y and dx bit for bit | {card}")

    def step(shapes, forward, backward):
        def run():
            for shape in shapes:
                forward(inputs[shape][0], *shape[2:])
            for shape in shapes[::-1]:
                backward(*inputs[shape][::-1], *shape[2:])
        return run

    def chain(shapes):
        def run():
            ys = []
            for shape in shapes:
                x = inputs[shape][0].detach().requires_grad_(True)
                ys.append(L._max_pool_axis(x, *shape[2:], -1))
            for shape, y in zip(shapes[::-1], ys[::-1]):
                y.backward(inputs[shape][1])
        return run

    records = {}
    for name, shapes in models.items():
        elements = sum(BATCH * c * t for c, t, *_ in shapes)
        outputs = sum(BATCH * c * MP.window(t, *rest)[0]
                      for c, t, *rest in shapes)
        k = device_ms_by_kernel(step(shapes, MP.maxpool_forward,
                                     MP.maxpool_backward))
        by_kernel = {n: sum(v for e, v in k.items() if n in e)
                     for n in MAXPOOL_KERNELS}
        ms = sum(by_kernel.values())
        plain_ms = sum(device_ms_by_kernel(step(
            shapes, MP.maxpool_forward_plain,
            MP.maxpool_backward_plain)).values())
        kernel_dtypes, L.MAXPOOL_KERNEL_DTYPES = L.MAXPOOL_KERNEL_DTYPES, ()
        try:
            chain_k = device_ms_by_kernel(chain(shapes))
        finally:
            L.MAXPOOL_KERNEL_DTYPES = kernel_dtypes
        chain_ms = sum(chain_k.values())
        nbytes = 2 * (3 * elements + 2 * outputs)
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        records[name] = {"ms": ms, "plain_ms": plain_ms,
                         "chain_ms": chain_ms, "bound_ms": bound}
        log(f"[maxpool] {name}: {len(shapes)} pools, {elements:,} input and "
            f"{outputs:,} output elements a step; kernels {ms:.4f} ms ("
            + ", ".join(f"{n} {v:.4f}" for n, v in by_kernel.items())
            + f"); bound {bound:.4f} ms ({nbytes / 1e9:.4f} GB; "
            f"{100 * bound / ms:.1f} %); plain twin {plain_ms:.4f} ms; the "
            f"chain before the kernels {chain_ms:.4f} ms in "
            f"{len(chain_k)} kernel names; device ms a step, mean of "
            f"{BN_ITERS} | {card}")
    main = records[MAXPOOL_MODELS[0]]
    return {
        "name": "maxpool",
        "route": "cuda",
        "source": "speech_recognition_tpu_torch/csrc/maxpool.cu",
        "replaces": None,
        "launches": None,
        "max_abs_err": 0.0,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "before_ms": main["chain_ms"],
    }


def depthwise_convs(model) -> int:
    """The convs of ``model`` that the depthwise kernels take on a card
    (``Conv.depthwise_1d``); a step runs each once a direction."""
    from speech_recognition_tpu_torch.models.layers import Conv

    return sum(isinstance(m, Conv) and m.depthwise_1d()
               for m in model.modules())


def dwconv_shapes(model_name: str) -> list:
    """(C, T, k, stride, padding) of each depthwise conv of
    ``model_name`` that the kernels take, in the forward's order (one CPU
    pass at batch 2 on its representation's input at the default
    geometry; ``tests/test_torch_dwconv1d.py`` reads its shapes here
    too)."""
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.models.layers import Conv
    from speech_recognition_tpu_torch.models.zoo import build_model
    from speech_recognition_tpu_torch.ops.frontend import Frontend

    s = prepare_model_settings(label_count=12)
    model, spec = build_model(
        model_name, num_classes=12, spectrogram_length=s.spectrogram_length,
        num_log_mel_features=s.num_log_mel_features,
        spectrogram_frequencies=s.spectrogram_frequencies,
        window_size_samples=s.window_size_samples,
        window_stride_samples=s.window_stride_samples)
    shapes = []

    def hook(conv, inputs, _):
        if conv.depthwise_1d():
            shapes.append((inputs[0].shape[1], inputs[0].shape[2],
                           conv.kernel[0], conv.stride[0], conv.padding))

    for m in model.modules():
        if isinstance(m, Conv):
            m.register_forward_hook(hook)
    x = Frontend(s).features(torch.randn(2, T) * 0.1, spec.representation)
    with torch.no_grad():
        model.train()(x, torch.Generator())
    return shapes


def dwconv_phase(device, card: str, ptxas: list[str]) -> dict:
    """The [dwconv] phase: the depthwise conv kernels (``ops/kernels/
    dwconv1d.py``) at every depthwise conv of the benchmark's five
    models, batch 384, bf16 x and dy over the float32 weight (the train
    step's): the kernels against the float64 plain twin at each distinct
    shape (``DWCONV_TOL``), then, for each model, the device ms of one
    step's convs forward and backward (each conv once, the backward in
    reverse order) through the kernels, through the plain twin, through
    the layer before the kernels (``F.pad``, then ``F.conv1d(groups=C)``
    with the bf16 weight autocast would make, and their autograd: all its
    kernels, logged; ATen's depthwise kernels among them, the library's
    call, ``library_ms``), beside the byte floor (x read and y written forward; x and dy read
    and dx written backward, each once) over 3.35 TB/s. Launches are
    counted where the train steps of [slice] and [zoo] run them
    (``launch.runs``)."""
    import torch.nn.functional as F

    from speech_recognition_tpu_torch.ops.framing import same_pad_amount
    from speech_recognition_tpu_torch.ops.kernels import dwconv1d as DW

    for line in ptxas:
        log(f"[dwconv] ptxas -v {line}")

    def pads(t, k, s, padding):
        return same_pad_amount(t, k, s) if padding == "same" else (0, 0)

    models, inputs = {}, {}
    for name in DWCONV_MODELS:
        models[name] = dwconv_shapes(name)
        for shape in models[name]:
            if shape in inputs:
                continue
            c, t, k, s, padding = shape
            left, right = pads(t, k, s, padding)
            out = DW.outputs(t, k, s, left, right)
            g = torch.Generator().manual_seed(len(inputs))
            x = torch.randn((BATCH, c, t), generator=g).to(device,
                                                          torch.bfloat16)
            w = torch.randn((c, 1, k), generator=g).to(device)
            dy = torch.randn((BATCH, c, out), generator=g).to(
                device, torch.bfloat16)
            inputs[shape] = (x, w, dy, s, left, right)
            got = (DW.dwconv1d_forward(x, w, s, left, right),
                   *DW.dwconv1d_backward(dy, x, w, s, left, right))
            args = (x.double(), w.double(), dy.double())
            want = (DW.dwconv1d_forward_plain(*args[:2], s, left, right),
                    *DW.dwconv1d_backward_plain(args[2], *args[:2], s, left,
                                                right))
            mags = [a.abs() for a in args]
            mag = (DW.dwconv1d_forward_plain(*mags[:2], s, left, right),
                   *DW.dwconv1d_backward_plain(mags[2], *mags[:2], s, left,
                                               right))
            torch.cuda.synchronize()
            info = torch.finfo(torch.bfloat16)
            for (key, tol), a, b, m in zip(DWCONV_TOL.items(), got, want,
                                           mag):
                rounding = 0 if key == "dw" else info.eps / 2 * torch.clamp(
                    b.abs(), min=info.smallest_normal)
                if not ((a.double() - b).abs() <= rounding + tol * m).all():
                    raise RuntimeError(f"[dwconv] {shape}: {key} against "
                                       f"the plain twin out of tolerance")
    log(f"[dwconv] kernels against the float64 plain twin at "
        f"{len(inputs)} shapes, batch {BATCH}, bf16 x and dy, f32 w: y, dx "
        f"and dw within {DWCONV_TOL} of their sums' absolute terms | {card}")

    def step(shapes, forward, backward):
        def run():
            for shape in shapes:
                x, w, _, s, left, right = inputs[shape]
                forward(x, w, s, left, right)
            for shape in shapes[::-1]:
                x, w, dy, s, left, right = inputs[shape]
                backward(dy, x, w, s, left, right)
        return run

    def aten(shapes):
        def run():
            ys = []
            for shape in shapes:
                x, w, _, s, left, right = inputs[shape]
                x = x.detach().requires_grad_(True)
                wb = w.bfloat16().detach().requires_grad_(True)
                ys.append(F.conv1d(F.pad(x, (left, right)), wb, stride=s,
                                   groups=x.shape[1]))
            for shape, y in zip(shapes[::-1], ys[::-1]):
                y.backward(inputs[shape][2])
        return run

    records = {}
    for name, shapes in models.items():
        xs = sum(BATCH * c * t for c, t, *_ in shapes)
        ys = sum(BATCH * c * DW.outputs(t, k, s, *pads(t, k, s, p))
                 for c, t, k, s, p in shapes)
        k = device_ms_by_kernel(step(shapes, DW.dwconv1d_forward,
                                     DW.dwconv1d_backward))
        by_kernel = {n: sum(v for e, v in k.items() if n in e)
                     for n in ("dwconv1d_fw", "dwconv1d_bw",
                               "dwconv1d_merge")}
        ms = sum(by_kernel.values())
        plain_ms = sum(device_ms_by_kernel(step(
            shapes, DW.dwconv1d_forward_plain,
            DW.dwconv1d_backward_plain)).values())
        before_k = device_ms_by_kernel(aten(shapes))
        before_ms = sum(before_k.values())
        aten_k = {e: v for e, v in before_k.items() if "depthwise" in e}
        library_ms = sum(aten_k.values())
        nbytes = 2 * (3 * xs + 2 * ys)
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        records[name] = {"ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound}
        log(f"[dwconv] {name}: {len(shapes)} convs, {xs:,} input and "
            f"{ys:,} output elements a step; kernels {ms:.4f} ms ("
            + ", ".join(f"{n} {v:.4f}" for n, v in by_kernel.items())
            + f"); bound {bound:.4f} ms ({nbytes / 1e9:.4f} GB; "
            f"{100 * bound / ms:.1f} %); plain twin {plain_ms:.4f} ms; "
            f"ATen's depthwise kernels {library_ms:.4f} ms; the layer "
            f"before the kernels (F.pad, F.conv1d, autograd) {before_ms:.4f}"
            f" ms in {len(before_k)} kernel names; device ms a step, mean "
            f"of {BN_ITERS} | {card}")
    main = records[DWCONV_MODELS[0]]
    return {
        "name": "dwconv1d",
        "route": "cuda",
        "source": "speech_recognition_tpu_torch/csrc/dwconv1d.cu",
        "replaces": None,
        "launches": None,
        "max_abs_err": None,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],
    }


def edge_case_draws(trainer, ds, starts=(0,)):
    """A training batch's draws with the kernel's edge cases written in
    from each row of ``starts``: zero and most-negative shifts, silence
    rows, bg_vol 0, the largest legal background position, the top file
    ids of the bank, shifts at every residue mod 8 (most of them put the
    wrap inside a 16-byte unit of the output), background positions at
    every residue mod 4, and a row with both volumes 0."""
    d = trainer.draw_batch()
    n, m = ds.num_clips, ds.background.flat.shape[0]
    for i in starts:
        d.shifts[i:i + 4] = torch.tensor([0, -500, -1, -T + 1])
        d.fg_vol[i + 4:i + 8] = 0.0
        d.bg_vol[i + 8:i + 12] = 0.0
        d.bg_pos[i + 12:i + 16] = m - T
        d.file_ids[i + 16:i + 20] = torch.arange(n - 4, n)
        d.shifts[i + 20:i + 28] = torch.arange(8) - 4003
        d.bg_pos[i + 28:i + 32] = torch.arange(4) + (m - T) // 2
        d.fg_vol[i + 32] = d.bg_vol[i + 32] = 0.0
    return d


def state_digest(model) -> str:
    """sha256 of every parameter and buffer, bit for bit."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rank_streams(log_dir: str, kind: str) -> list:
    """Each rank's ``kind`` ("stdout" or "stderr") as torchrun's
    ``--redirects`` wrote it under ``log_dir``, rank r's at index r ("" for
    a rank that left no file)."""
    import glob

    streams = []
    for rank in range(TORCHRUN_RANKS):
        paths = glob.glob(os.path.join(log_dir, "*", "attempt_*", str(rank),
                                       f"{kind}.log"))
        if len(paths) > 1:
            raise RuntimeError(f"torchrun left {paths}")
        streams.append(open(paths[0]).read() if paths else "")
    return streams


def torchrun(module: str, args, cwd, tag: str):
    """``torchrun --nproc_per_node 2 -m module args`` in ``cwd``, the
    ranks on this machine's cards (NCCL with a card each, gloo when they
    share one); returns (stdouts, stderrs, seconds), the lists holding
    each rank's own stream, rank r's at index r. torchrun writes each
    rank's streams to files of their own, so that no rank's line lands
    inside another's, as it can in one shared pipe. A failed rank fails
    the phase; at the time limit, and after it ends, every process of its
    session is killed."""
    import signal
    import tempfile

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory(prefix="srt_torchrun_") as logs:
        # --standalone: torchrun's own store on localhost, on a free port
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--standalone", "--nproc_per_node", str(TORCHRUN_RANKS),
               "--redirects", "3", "--log-dir", logs, "-m", module, *args]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=str(cwd), env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE,
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=TORCHRUN_TIMEOUT_S)
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        secs = time.perf_counter() - t0
        outs, errs = _rank_streams(logs, "stdout"), _rank_streams(logs,
                                                                 "stderr")
    if proc.returncode != 0:
        raise RuntimeError(
            f"{tag} torchrun -m {module} exited {proc.returncode}: "
            f"{out[-1000:]} {err[-2000:]} " + " ".join(
                f"rank {r}: {o[-1000:]} {e[-3000:]}"
                for r, (o, e) in enumerate(zip(outs, errs))))
    return outs, errs, secs


def step_parity(got, want, model, ref_grads, tol):
    """A W-rank step (its metrics ``got``, ``model`` with its gradients)
    against one process's (``want``, ``ref_grads`` by name): ((loss rel
    err, the parameter of the worst median, that median, the parameter
    of the worst max, that max), whether all are within ``tol`` = (loss,
    median, max)), each gradient error over its reference's max |value|."""
    medians, maxima = {}, {}
    for name, p in model.named_parameters():
        g = ref_grads[name]
        e = (p.grad - g).abs() / g.abs().max().clamp_min(1e-30)
        medians[name], maxima[name] = float(e.median()), float(e.max())
    loss_err = abs(float(got["loss"]) - float(want["loss"])) \
        / abs(float(want["loss"]))
    worst = max(maxima, key=maxima.get)
    worst_median = max(medians, key=medians.get)
    parity = (loss_err, worst_median, medians[worst_median], worst,
              maxima[worst])
    return parity, (loss_err <= tol[0] and parity[2] <= tol[1]
                     and parity[4] <= tol[2])


def dp_rank(rank: int, world: int, init_method: str, backend: str,
            results) -> None:
    """One rank of the [dp] phase (a spawned process). It prints nothing:
    it puts one dict of results on ``results``; an exception fails the
    phase."""
    from speech_recognition_tpu_torch.config import (
        AugmentConfig, prepare_model_settings,
    )
    from speech_recognition_tpu_torch.data.device_bank import (
        synthetic_device_dataset,
    )
    from speech_recognition_tpu_torch.export.benchmark import (
        benchmark_train,
    )
    from speech_recognition_tpu_torch.ops.kernels import (
        decode_augment as K,
    )
    from speech_recognition_tpu_torch.ops.kernels import sharded as KS
    from speech_recognition_tpu_torch.parallel.collectives import all_reduce_
    from speech_recognition_tpu_torch.parallel.distributed import (
        host_replicated, initialize_distributed,
    )
    from speech_recognition_tpu_torch.parallel.mesh import (
        make_mesh, rank_device, shard_batch,
    )
    from speech_recognition_tpu_torch.train.loop import Trainer

    device = rank_device(rank)
    torch.cuda.set_device(device)
    initialize_distributed(init_method, world, rank, backend)
    mesh = make_mesh(device)
    out = {"rank": rank, "device": str(device)}

    def barrier():
        all_reduce_(torch.zeros(1, device=device), mesh)
        torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    ds = synthetic_device_dataset(
        device, num_train=NUM_TRAIN, num_val=NUM_VAL, num_pseudo=NUM_PSEUDO,
        num_classes=12, num_background=NUM_BACKGROUND,
        background_len=BACKGROUND_LEN)
    torch.cuda.synchronize(device)
    out["data_s"] = time.perf_counter() - t0
    barrier()
    t0 = time.perf_counter()
    host_replicated(ds, mesh)
    torch.cuda.synchronize(device)
    out["replicate_s"] = time.perf_counter() - t0
    settings = prepare_model_settings(label_count=12)
    augment = AugmentConfig(pseudo_frequency=0.6)

    # the kernel on this rank's rows against its plain version, on the
    # global draws with edge cases in both ranks' rows
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dp = Trainer(MODEL, settings, ds, augment=augment, batch_size=BATCH,
                 compute_dtype="float32", mesh=mesh)
    d = edge_case_draws(dp, ds, starts=range(0, BATCH, BATCH // world))
    bg = ds.background.flat
    errs = []
    for index_dtype in (torch.int64, torch.int32):
        args = (mesh, ds.wav_bank, bg, d.file_ids.to(index_dtype),
                d.shifts.to(index_dtype), d.fg_vol, d.bg_pos.to(index_dtype),
                d.bg_vol)
        got = KS.decode_augment_sharded(*args)
        want = KS.decode_augment_sharded_reference(*args)
        torch.cuda.synchronize(device)
        if got.shape != (BATCH // world, T) or not torch.isfinite(got).all():
            raise RuntimeError(f"rank {rank}: sharded kernel output "
                               f"{tuple(got.shape)} or non-finite values")
        errs.append(float((got - want).abs().max()))
    out["max_abs_err"] = max(errs)
    if out["max_abs_err"] > KERNEL_ATOL:
        raise RuntimeError(f"rank {rank}: decode_augment_sharded vs plain "
                           f"max abs err {errs} > {KERNEL_ATOL}")
    args = (mesh, ds.wav_bank, bg, d.file_ids, d.shifts, d.fg_vol, d.bg_pos,
            d.bg_vol)
    out["bound_ms"], out["bound_by"], out["bytes"] = decode_augment_bound(
        ds.wav_bank, bg, *shard_batch(args[3:], mesh))
    for r in range(world):      # one rank at a time on a shared card
        barrier()
        if r == rank:
            out.update(decode_augment_timings(
                lambda: KS.decode_augment_sharded(*args),
                lambda: KS.decode_augment_sharded_reference(*args),
                (BATCH // world, T), device))
    barrier()

    # one 2-rank step against one process on the same global batch,
    # weights and dropout masks, in f32 and in f64
    ref = Trainer(MODEL, settings, ds, augment=augment, batch_size=BATCH,
                  compute_dtype="float32")
    draw_state = dp.generator.get_state()
    out["parity"] = {}
    ref_grads = {}
    for dtype in DP_TOL:
        dp.generator.set_state(draw_state)
        ref.generator.set_state(draw_state)
        dp_state, ref_state = dp.init_state(), ref.init_state()
        dp_state.model.to(dtype)
        ref_state.model.to(dtype)
        got = dp._update_step(dp_state, dp.build_batch(d).to(dtype),
                              shard_batch(d.labels, mesh))
        want = ref._update_step(ref_state, ref.build_batch(d).to(dtype),
                                d.labels)
        ref_grads[dtype] = {n: p.grad.double() for n, p in
                            ref_state.model.named_parameters()}
        name = str(dtype)[6:]
        out["parity"][name], ok = step_parity(
            got, want, dp_state.model, ref_grads[dtype], DP_TOL[dtype])
        if not ok:
            raise RuntimeError(f"rank {rank}: {world}-rank {name} step vs "
                               f"one process: {out['parity'][name]}")
        del dp_state, ref_state, got, want
    # the streamed step: this rank's int16 rows of the global batch are
    # its bank, against one process on the whole batch, in f32; and
    # decode+augment on the rank's rows against its plain version
    rows = mesh.rows(BATCH)
    wav = ds.wav_bank[d.file_ids]
    dp.generator.set_state(draw_state)
    ref.generator.set_state(draw_state)
    dp_state, ref_state = dp.init_state(), ref.init_state()
    d_dp = dp.draw_stream(d.labels[rows], d.is_silence[rows])
    d_ref = ref.draw_stream(d.labels, d.is_silence)
    args_s = (wav[rows].contiguous(), bg, d_dp.file_ids, d_dp.shifts,
              d_dp.fg_vol, d_dp.bg_pos, d_dp.bg_vol)
    got = K.decode_augment(*args_s)
    want = K.decode_augment_reference(*args_s)
    torch.cuda.synchronize(device)
    out["stream_max_abs_err"] = float((got - want).abs().max())
    if got.shape != (BATCH // world, T) \
            or out["stream_max_abs_err"] > KERNEL_ATOL:
        raise RuntimeError(f"rank {rank}: decode_augment on the streamed "
                           f"rows {tuple(got.shape)}: max abs err "
                           f"{out['stream_max_abs_err']}")
    x_dp = dp.build_stream_batch(wav[rows].contiguous(), d_dp)
    x_ref = ref.build_stream_batch(wav, d_ref)
    out["stream_rows_equal"] = bool(torch.equal(x_dp, x_ref[rows]))
    got = dp._update_step(dp_state, x_dp, d.labels[rows])
    want = ref._update_step(ref_state, x_ref, d.labels)
    out["stream_parity"], ok = step_parity(
        got, want, dp_state.model,
        {n: p.grad for n, p in ref_state.model.named_parameters()},
        DP_TOL[torch.float32])
    if not out["stream_rows_equal"] or not ok:
        raise RuntimeError(f"rank {rank}: {world}-rank streamed float32 "
                           f"step vs one process: rows equal "
                           f"{out['stream_rows_equal']}, "
                           f"{out['stream_parity']}")
    del dp_state, ref_state, got, want, wav, x_dp, x_ref
    # f32's own error, for scale: one process, f32 against f64
    out["f32_vs_f64"] = max(
        float(((g - ref_grads[torch.float64][n]).abs()
               / ref_grads[torch.float64][n].abs().max()).median())
        for n, g in ref_grads[torch.float32].items())
    del dp, ref, ref_grads
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32

    # the path: 20 bf16 train steps, then one validation sweep, with the
    # counts set to 0 just before
    trainer = Trainer(MODEL, settings, ds, augment=augment, batch_size=BATCH,
                      mesh=mesh)
    if trainer.compute_dtype != "bfloat16":
        raise RuntimeError(f"compute dtype {trainer.compute_dtype}")
    state = trainer.init_state()
    barrier()
    torch.cuda.reset_peak_memory_stats(device)
    launch.reset_runs()
    result = benchmark_train(trainer, state, steps=STEPS, warmup=WARMUP)
    t0 = time.perf_counter()
    conf, val_loss = trainer.evaluate(state, "validation")
    out["eval_s"] = time.perf_counter() - t0
    # each train step's decode_augment_sharded is one decode+augment run
    out["launches"] = launch.runs()["decode_augment"]
    out.update(losses=result["losses"], ms_per_step=result["ms_per_step"],
               clips_per_sec=result["clips_per_sec"],
               wall_ms_per_step=result["wall_ms_per_step"],
               peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
               conf=conf.tolist(), val_loss=val_loss,
               digest=state_digest(state.model))

    # what one all-reduce of the step costs on this backend, host clock
    # around whole calls: a BN layer's [C + 1] statistics (12 layers x 4,
    # and the metrics: 49 small ones per step) and the one gradient bucket
    numel = sum(p.numel() for p in state.model.parameters())
    out["all_reduce_ms"] = {}
    for label, n, reps in (("[513]", 513, 50), ("bucket", numel, 5)):
        x = torch.zeros(n, device=device)
        barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            all_reduce_(x, mesh)
        torch.cuda.synchronize(device)
        out["all_reduce_ms"][label] = 1e3 * (time.perf_counter() - t0) / reps
    results.put(out)
    barrier()
    torch.distributed.destroy_process_group()


def dp_phase(card: str):
    """The [dp] phase: spawn the ranks, collect and check their results.
    Returns the ``kernels`` entry of ``decode_augment_sharded``."""
    import torch.multiprocessing as mp

    from speech_recognition_tpu_torch.parallel.distributed import (
        default_backend,
    )
    from speech_recognition_tpu_torch.parallel.mesh import rank_device

    world = DP_RANKS
    backend = default_backend(world)
    devices = {r: str(rank_device(r)) for r in range(world)}
    shared = len(set(devices.values())) < world
    log(f"[dp] {world} ranks, backend {backend}, rank -> device {devices}; "
        f"{BATCH // world} clips per rank of a global batch of {BATCH}"
        + ("; the ranks share one card" if shared else ""))
    phase_t0 = time.perf_counter()
    queue = mp.get_context("spawn").SimpleQueue()
    procs = mp.spawn(dp_rank, nprocs=world, join=False, args=(
        world, f"tcp://localhost:{free_port()}", backend, queue))
    results = {}

    def collect():
        while not queue.empty():
            r = queue.get()
            results[r["rank"]] = r

    try:
        while not procs.join(timeout=1):    # raises if a rank failed
            collect()
            if time.perf_counter() - phase_t0 > DP_TIMEOUT_S:
                raise RuntimeError(f"[dp] ranks still running after "
                                   f"{DP_TIMEOUT_S} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
    collect()
    if sorted(results) != list(range(world)):
        raise RuntimeError(f"[dp] results from ranks {sorted(results)}")
    rs = [results[r] for r in range(world)]

    for r in rs:
        log(f"[dp] rank {r['rank']} on {r['device']}: bank set up in "
            f"{r['data_s']:.1f} s, replicated from rank 0 in "
            f"{r['replicate_s']:.2f} s; decode_augment_sharded "
            f"[{BATCH // world}, {T}] max abs err {r['max_abs_err']:.3g} "
            f"(tol {KERNEL_ATOL}); " + decode_augment_line(
                r, r["bound_ms"], r["bound_by"], r["bytes"], card))
        for dtype, tol in DP_TOL.items():
            loss_err, worst_median, median, worst, worst_err = \
                r["parity"][str(dtype)[6:]]
            log(f"[dp] rank {r['rank']} {str(dtype)[6:]} (TF32 off) "
                f"{world}-rank step vs one process on the global batch: "
                f"loss rel err "
                f"{loss_err:.3g} (tol {tol[0]}); gradient error / max "
                f"|value|: worst median {median:.3g} in {worst_median} (tol "
                f"{tol[1]}), worst max {worst_err:.3g} in {worst} (tol "
                f"{tol[2]})")
        log(f"[dp] rank {r['rank']} one process, f32 against f64: worst "
            f"median gradient error / max |value| {r['f32_vs_f64']:.3g}")
        loss_err, worst_median, median, worst, worst_err = \
            r["stream_parity"]
        tol = DP_TOL[torch.float32]
        log(f"[dp] rank {r['rank']} float32 (TF32 off) {world}-rank "
            f"streamed step, the rank's [{BATCH // world}, {T}] int16 rows "
            f"its bank, vs one process on the global batch: features "
            f"equal to the one process's rows {r['stream_rows_equal']}; "
            f"decode_augment on the rank's rows vs plain max abs err "
            f"{r['stream_max_abs_err']:.3g} (tol {KERNEL_ATOL}); loss rel "
            f"err {loss_err:.3g} (tol {tol[0]}); gradient error / max "
            f"|value|: worst median {median:.3g} in {worst_median} (tol "
            f"{tol[1]}), worst max {worst_err:.3g} in {worst} (tol "
            f"{tol[2]})")
    steps = STEPS + WARMUP
    expected = (NUM_VAL // BATCH) * BATCH
    for r in rs:
        if r["launches"] != steps:
            raise RuntimeError(f"[dp] rank {r['rank']} launched "
                               f"{r['launches']} in {steps} train steps")
        if len(r["losses"]) != steps or not np.isfinite(r["losses"]).all():
            raise RuntimeError(f"[dp] rank {r['rank']} losses {r['losses']}")
        if sum(map(sum, r["conf"])) != expected \
                or not np.isfinite(r["val_loss"]):
            raise RuntimeError(f"[dp] rank {r['rank']}: confusion sums to "
                               f"{sum(map(sum, r['conf']))}, expected "
                               f"{expected}; val loss {r['val_loss']}")
    for key in ("losses", "digest", "conf", "val_loss"):
        if any(r[key] != rs[0][key] for r in rs):
            raise RuntimeError(f"[dp] {key} differs between ranks: "
                               f"{[r[key] for r in rs]}")
    log(f"[dp] losses {[round(v, 4) for v in rs[0]['losses']]}, equal on "
        f"every rank; parameters and BN statistics bit-identical (sha256 "
        f"{rs[0]['digest'][:16]})")
    scaling = ("; the ranks share one card, so this is no measure of "
               "scaling" if shared else "")
    for r in rs:
        log(f"[dp] rank {r['rank']} {MODEL} bf16 global batch {BATCH}: "
            f"{r['ms_per_step']:.3f} ms/step, {r['clips_per_sec']:.0f} "
            f"global clips/s (CUDA events over {STEPS} steps after "
            f"{WARMUP}; host clock {r['wall_ms_per_step']:.3f} ms/step); "
            f"peak memory {r['peak_gb']:.2f} GB{scaling} | {card}")
    conf = np.asarray(rs[0]["conf"])
    log(f"[dp] one {backend} all-reduce on the card's tensors, host clock: "
        + "; ".join(f"rank {r['rank']} " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in r["all_reduce_ms"].items())
            for r in rs) + f" | {card}")
    log(f"[dp] validation: {conf.sum()} clips in {rs[0]['eval_s']:.2f} s, "
        f"accuracy {np.trace(conf) / conf.sum():.4f}, loss "
        f"{rs[0]['val_loss']:.4f}; decode+augment runs per rank "
        f"{rs[0]['launches']}; phase {time.perf_counter() - phase_t0:.1f} s")
    slowest = max(rs, key=lambda r: r["device_ms"])
    return {
        "name": "decode_augment_sharded",
        "route": "cuda",
        "source": "speech_recognition_tpu_torch/csrc/decode_augment.cu",
        "replaces": "speech_recognition_tpu/ops/pallas/sharded.py:22",
        "launches": sum(r["launches"] for r in rs),
        "max_abs_err": max(r["max_abs_err"] for r in rs),
        **{k: slowest[k] for k in ("ms", "plain_ms", "device_ms",
                                   "device_ms_warm", "yardstick_ms")},
        "bound_ms": slowest["bound_ms"],
        "bound_by": slowest["bound_by"],
        "library_ms": None,
    }


def frontend_card_vs_cpu(device, wav_cpu: torch.Tensor, settings) -> dict:
    """Max error of each ``Frontend`` output on the card against the CPU
    (f32, TF32 off), relative to the largest |value| of the CPU's (the
    log-mel where mel > 1e-3, as the parity tests take it)."""
    from speech_recognition_tpu_torch.ops.frontend import LOG_OFFSET, Frontend

    front = Frontend(settings, "highest")
    errs = {}
    for name in FRONTEND_RTOL:
        want = getattr(front, name)(wav_cpu)
        got = getattr(front, name)(wav_cpu.to(device)).cpu()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"frontend {name}: {tuple(got.shape)} or "
                               f"non-finite values")
        d = (got - want).abs()
        if name == "log_mel":
            d = d[torch.exp(want) - LOG_OFFSET > 1e-3]
            want = want[torch.exp(want) - LOG_OFFSET > 1e-3]
        errs[name] = float(d.max() / want.abs().max())
    return errs


def with_batch_stats(model, x_cpu: torch.Tensor):
    """``model`` in eval mode with every BN's running statistics set to
    the batch statistics of ``x_cpu`` (one train-mode pass on the CPU at
    momentum 0), so that eval-mode activations keep their scale."""
    from speech_recognition_tpu_torch.models.layers import BatchNorm

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    momenta = [bn.momentum for bn in bns]
    for bn in bns:
        bn.momentum = 0.0
    with torch.no_grad():
        model.train()(x_cpu, torch.Generator())
    for bn, m in zip(bns, momenta):
        bn.momentum = m
    return model.eval()


def spec_logits_card_vs_cpu(device, x_cpu: torch.Tensor) -> float:
    """Max abs error of ``conv_1d_spec``'s eval logits on the card against
    the CPU over the max |logit| (f32, TF32 off), with the BN running
    statistics set to the batch's (one train-mode pass at momentum 0)."""
    from speech_recognition_tpu_torch.models.zoo import build_model

    model, _ = build_model(FIT_MODEL, num_classes=12,
                           generator=torch.Generator().manual_seed(1))
    model = with_batch_stats(model, x_cpu)
    with torch.no_grad():
        want = model(x_cpu)
        got = copy.deepcopy(model).to(device)(x_cpu.to(device)).cpu()
    if got.shape != (x_cpu.shape[0], 12) or not torch.isfinite(got).all():
        raise RuntimeError(f"conv_1d_spec logits {tuple(got.shape)} or "
                           f"non-finite values")
    return float((got - want).abs().max() / want.abs().max())


def _to(x, device):
    """A tensor or a tuple of them (the mfcc_and_raw input) on ``device``."""
    if isinstance(x, tuple):
        return tuple(t.to(device) for t in x)
    return x.to(device)


def zoo_phase(device, card: str, ds,
              settings) -> tuple[int, dict, dict, dict, dict]:
    """The [zoo] phase, on [slice]'s full-corpus bank ``ds``: for each of
    the 23 models of ``ZOO_PARAMS``, at its golden's geometry (98 frames;
    60 mel features, 40 for ``ZOO_MEL_40``; 257 bins), its parameter
    count against the JAX golden, its f32 logits on the card against the
    CPU on ``Frontend.features`` of 4 clips, the same features on both
    (TF32 off, BN statistics set to the features'; within LOGITS_ATOL,
    absolute and relative to max |logit|), ``ZOO_WARMUP + ZOO_STEPS``
    bf16 train steps through ``Trainer`` at batch 384 with finite losses
    and one decode+augment run each, launched or replayed with the
    step's CUDA graph (timed by CUDA events over the last
    ``ZOO_STEPS``), the models whose capture failed listed, the kernel
    against its plain version on one of the model's own draws, and the
    device's busy time over ``ZOO_TRACED`` more steps (``torch.profiler``)
    against the events' step. A model with BiGRUs runs each GRU kernel
    once a BiGRU and step, each BatchNorm kernel once a BatchNorm and
    step, each max-pool kernel once a pool along a last axis (as the
    CPU forward meets them) and step, and each depthwise kernel once a
    depthwise conv the kernels take and step (13 of the models),
    launched or replayed (``launch.runs``). Returns the runs of
    decode+augment in the trainers' steps, and those of the GRU,
    BatchNorm, max-pool and depthwise kernels by model (read before the
    comparison and the trace)."""
    from speech_recognition_tpu_torch.config import AugmentConfig
    from speech_recognition_tpu_torch.export.benchmark import (
        benchmark_train, traced_train_device_time,
    )
    from speech_recognition_tpu_torch.models.layers import BatchNorm, BiGRU
    from speech_recognition_tpu_torch.models.zoo import (
        MODEL_REGISTRY, build_model,
    )
    from speech_recognition_tpu_torch.ops.frontend import Frontend
    from speech_recognition_tpu_torch.train.loop import Trainer

    phase_t0 = time.perf_counter()
    eager = []
    missing = set(ZOO_PARAMS) - set(MODEL_REGISTRY)
    if missing:
        raise RuntimeError(f"[zoo] not in the registry: {sorted(missing)}")
    clips = ds.decode(ds.partitions["validation"].file_ids[:4]).cpu()
    total, gru_total, bn_total, maxpool_total, dwconv_total = 0, {}, {}, \
        {}, {}
    for name, golden in ZOO_PARAMS.items():
        t0 = time.perf_counter()
        s = dataclasses.replace(settings, num_log_mel_features=(
            40 if name in ZOO_MEL_40 else 60))
        model, spec = build_model(
            name, num_classes=12, generator=torch.Generator().manual_seed(1),
            spectrogram_length=s.spectrogram_length,
            num_log_mel_features=s.num_log_mel_features,
            spectrogram_frequencies=s.spectrogram_frequencies,
            window_size_samples=s.window_size_samples,
            window_stride_samples=s.window_stride_samples)
        count = sum(p.numel() for p in model.parameters())
        if count != golden:
            raise RuntimeError(f"[zoo] {name}: {count} parameters, golden "
                               f"{golden}")
        x = Frontend(s).features(clips, spec.representation)
        tf32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        model = with_batch_stats(model, x)
        with torch.no_grad():
            with recording_pools() as pools:
                want = model(x)
            got = copy.deepcopy(model).to(device)(_to(x, device)).cpu()
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        # absolute, and relative to max |logit|: some of these models
        # give logits of ~1e-2 at their init (conv_1d_top_down's BN inputs
        # are far below BN's eps), where the absolute bound alone is loose
        err, top = float((got - want).abs().max()), float(want.abs().max())
        if got.shape != (4, 12) or not err <= LOGITS_ATOL \
                or not err <= LOGITS_ATOL * top:
            raise RuntimeError(f"[zoo] {name} logits card vs CPU: max abs "
                               f"err {err}, max |logit| {top}")
        del model
        trainer = Trainer(name, s, ds,
                          augment=AugmentConfig(pseudo_frequency=0.6),
                          batch_size=BATCH)
        if trainer.compute_dtype != "bfloat16":
            raise RuntimeError(f"[zoo] {name}: {trainer.compute_dtype}")
        state = trainer.init_state()
        torch.cuda.reset_peak_memory_stats()
        launch.reset_runs()
        result = benchmark_train(trainer, state, steps=ZOO_STEPS,
                                 warmup=ZOO_WARMUP)
        runs = launch.runs()
        launches = runs["decode_augment"]
        grus = {"forward": runs["gru_forward"],
                "backward": runs["gru_backward"]}
        losses = result["losses"]
        if launches != ZOO_STEPS + ZOO_WARMUP:
            raise RuntimeError(f"[zoo] {name}: {launches} decode_augment "
                               f"runs in {ZOO_STEPS + ZOO_WARMUP} train "
                               f"steps")
        bigrus = sum(isinstance(m, BiGRU) for m in state.model.modules())
        want = (ZOO_STEPS + ZOO_WARMUP) * bigrus
        if grus != {"forward": want, "backward": want}:
            raise RuntimeError(f"[zoo] {name}: GRU kernel runs {grus} in "
                               f"{ZOO_STEPS + ZOO_WARMUP} train steps of "
                               f"{bigrus} BiGRU(s)")
        if bigrus:
            gru_total[name] = sum(grus.values())
        bns = sum(isinstance(m, BatchNorm) for m in state.model.modules())
        bn = {k: runs[k] for k in BN_KERNELS}
        if bn != dict.fromkeys(BN_KERNELS, (ZOO_STEPS + ZOO_WARMUP) * bns):
            raise RuntimeError(f"[zoo] {name}: BatchNorm kernel runs {bn} in "
                               f"{ZOO_STEPS + ZOO_WARMUP} train steps of "
                               f"{bns} BatchNorm(s)")
        bn_total[name] = sum(bn.values())
        mp = {k: runs[k] for k in MAXPOOL_KERNELS}
        if mp != dict.fromkeys(MAXPOOL_KERNELS,
                               (ZOO_STEPS + ZOO_WARMUP) * len(pools)):
            raise RuntimeError(f"[zoo] {name}: max-pool kernel runs {mp} "
                               f"in {ZOO_STEPS + ZOO_WARMUP} train steps of "
                               f"{len(pools)} last-axis pool(s)")
        if pools:
            maxpool_total[name] = sum(mp.values())
        dws = depthwise_convs(state.model)
        dw = {k: runs[k] for k in DWCONV_KERNELS}
        if dw != dict.fromkeys(DWCONV_KERNELS, (ZOO_STEPS + ZOO_WARMUP) * dws):
            raise RuntimeError(f"[zoo] {name}: depthwise kernel runs {dw} in "
                               f"{ZOO_STEPS + ZOO_WARMUP} train steps of "
                               f"{dws} depthwise conv(s)")
        if dws:
            dwconv_total[name] = sum(dw.values())
        if trainer.graph_error is not None:
            eager.append(name)
        if len(losses) != ZOO_STEPS + ZOO_WARMUP \
                or not np.isfinite(losses).all():
            raise RuntimeError(f"[zoo] {name} losses: {losses}")
        kernel_err = decode_augment_on_path(ds, trainer.draw_batch(),
                                            f"[zoo] {name}")
        trace = traced_train_device_time(trainer, state, steps=ZOO_TRACED,
                                         warmup=0)
        busy = trace["device_ms_per_step"]
        total += launches
        log(f"[zoo] {name} ({spec.representation}): {count} parameters "
            f"(golden); f32 logits card vs CPU max abs err {err:.3g} (tol "
            f"{LOGITS_ATOL}, and {LOGITS_ATOL} of max |logit| {top:.3g}); "
            f"losses {[round(v, 4) for v in losses]}; decode_augment "
            f"runs {launches} (launched or in replays of the step's CUDA "
            f"graph; capture error: {trainer.graph_error}), vs plain "
            f"{kernel_err:.3g}; GRU kernel runs {grus}; BatchNorm kernel "
            f"runs {bn[BN_KERNELS[0]]} each ({bns} BatchNorms a step); "
            f"max-pool kernel runs {mp[MAXPOOL_KERNELS[0]]} each "
            f"({len(pools)} last-axis pools a step); depthwise kernel runs "
            f"{dw[DWCONV_KERNELS[0]]} each ({dws} depthwise convs a step)")
        log(f"[zoo] {name} bf16 batch {BATCH}: "
            f"{result['ms_per_step']:.3f} ms/step, "
            f"{result['clips_per_sec']:.1f} clips/s (CUDA events over "
            f"{ZOO_STEPS} steps after {ZOO_WARMUP}; host clock "
            f"{result['wall_ms_per_step']:.3f} ms/step); peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; traced "
            f"device {busy:.3f} ms/step in "
            f"{trace['kernels_per_step']:.0f} kernels over {ZOO_TRACED} "
            f"more steps, idle {100 * (1 - busy / result['ms_per_step']):.1f}"
            f" % of the events' step; {time.perf_counter() - t0:.1f} s | "
            f"{card}")
        log(f"[zoo] {name} top kernels, device ms/step: " + "; ".join(
            f"{k} {v:.3f}" for k, v in list(
                trace["top_kernels"].items())[:4]))
        del trainer, state
        torch.cuda.empty_cache()
    log(f"[zoo] phase {time.perf_counter() - phase_t0:.1f} s, "
        f"decode_augment runs {total}; GRU kernel runs {gru_total}; "
        f"BatchNorm kernel runs {bn_total}; depthwise kernel runs "
        f"{dwconv_total} ({len(dwconv_total)} models); models "
        f"whose capture of the train step failed, their steps eager: "
        f"{eager or 'none'}")
    if len(dwconv_total) != 12:
        raise RuntimeError(f"[zoo] depthwise kernels ran in "
                           f"{sorted(dwconv_total)}, not the 12 zoo models "
                           f"beside the flagship that have such convs")
    return total, gru_total, bn_total, maxpool_total, dwconv_total


def hold_decode_augment(bank, bg_flat, d, label: str) -> float:
    """decode+augment's kernel against its plain version on one batch of
    a training path: ``d`` are the trainer's draws on ``bank`` (the
    dataset's, or a streamed batch as its own bank) and the background
    ``bg_flat``; to the last bit. Called after the path's count was
    read, so these launches stay out of it."""
    from speech_recognition_tpu_torch.ops.kernels import (
        decode_augment as K,
    )

    args = (bank, bg_flat, d.file_ids, d.shifts, d.fg_vol, d.bg_pos,
            d.bg_vol)
    got = K.decode_augment(*args)
    want = K.decode_augment_reference(*args)
    if got.shape != (len(d.file_ids), bank.shape[1]) \
            or not torch.isfinite(got).all():
        raise RuntimeError(f"{label} decode_augment {tuple(got.shape)} or "
                           f"non-finite values")
    err = float((got - want).abs().max())
    if err > KERNEL_ATOL:
        raise RuntimeError(f"{label} decode_augment kernel vs plain max abs "
                           f"err {err} > {KERNEL_ATOL}")
    return err


def decode_augment_on_path(ds, d, label: str) -> float:
    """``hold_decode_augment`` on the bank and background of the
    dataset ``ds``."""
    return hold_decode_augment(ds.wav_bank, ds.background.flat, d, label)


def fit_phase(device, card: str, root) -> int:
    """The [fit] phase: the frontend and conv_1d_spec on the card against
    the CPU, then the accuracy calibration for each seed (seed 0 with
    ``--eval_int8``) on a hard corpus written to ``root``; checks the
    launches of decode+augment and the gate on the seed mean. Returns the
    launches."""
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.data.hard_corpus import (
        build_hard_corpus,
    )
    from speech_recognition_tpu_torch.data.wav import load_wav_file
    from speech_recognition_tpu_torch.ops.frontend import Frontend
    from speech_recognition_tpu_torch.tools import calibrate_accuracy as C

    phase_t0 = time.perf_counter()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = 0
    args = C.parse_args(FIT_ARGS)
    t0 = time.perf_counter()
    build_hard_corpus(root, clips_per_word=args.clips_per_word,
                      seed=args.corpus_seed,
                      snr_db_range=(args.snr_lo, args.snr_hi),
                      pitch_span_l=args.pitch_span_l)
    log(f"[fit] hard corpus ({args.clips_per_word} clips per word, "
        f"corpus seed {args.corpus_seed}) written in "
        f"{time.perf_counter() - t0:.1f} s")

    settings = prepare_model_settings(12, output_representation="spec")
    wav = torch.from_numpy(np.stack([
        load_wav_file(str(p), settings.desired_samples)
        for p in sorted(root.glob("*/spk00[0-3]_nohash_0.wav"))[:8]]))
    errs = frontend_card_vs_cpu(device, wav, settings)
    bad = {k: v for k, v in errs.items() if not v <= FRONTEND_RTOL[k]}
    log(f"[fit] Frontend f32 (TF32 off), card vs CPU on {len(wav)} "
        f"corpus clips, max abs err / max |value|: "
        + ", ".join(f"{k} {v:.3g} (tol {FRONTEND_RTOL[k]})"
                    for k, v in errs.items()))
    if bad:
        raise RuntimeError(f"frontend card vs CPU: {bad}")
    x = Frontend(settings).features(wav, "spec")
    logit_err = spec_logits_card_vs_cpu(device, x)
    log(f"[fit] {FIT_MODEL} f32 logits, card vs CPU on {len(wav)} "
        f"clips: max abs err / max |logit| {logit_err:.3g} (tol "
        f"{SPEC_LOGITS_RTOL})")
    if not logit_err <= SPEC_LOGITS_RTOL:
        raise RuntimeError(f"{FIT_MODEL} logits card vs CPU: "
                           f"{logit_err}")
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = tf32

    bests = []
    for seed in FIT_SEEDS:
        args = C.parse_args(FIT_ARGS + ["--seed", str(seed)]
                            + (["--eval_int8"] if seed == 0 else []))
        t0 = time.perf_counter()
        launch.reset_runs()
        record, trainer, history = C.calibrate(args, corpus_root=root)
        seed_launches = launch.runs()["decode_augment"]
        seed_s = time.perf_counter() - t0
        da_err = decode_augment_on_path(
            trainer.dataset, trainer.draw_batch(), f"[fit] seed {seed}")
        steps = trainer.dataset.set_size("training") // args.batch_size
        expected = args.epochs * (steps + args.bn_recalibration_batches)
        for epoch, (acc, cps) in enumerate(zip(
                history["val_categorical_accuracy"],
                history["clips_per_sec"])):
            log(f"[fit] seed {seed} epoch {epoch:2d}: val acc "
                f"{acc:.4f}, {cps:.0f} clips/s (train steps, host clock "
                f"to the read of the last step's loss)")
        log(f"[fit] seed {seed} record: {json.dumps(record)}")
        if args.eval_int8:
            int8 = [record.get(k) for k in ("aot_f32_acc", "aot_int8_acc",
                                            "int8_delta")]
            if not all(isinstance(v, float) and np.isfinite(v)
                       for v in int8):
                raise RuntimeError(f"[fit] --eval_int8 record {int8}")
            log(f"[fit] seed {seed} exported archives (batch 64, f32 "
                f"compute, TF32 off) on the validation clips: aot_f32_acc "
                f"{int8[0]:.4f}, aot_int8_acc {int8[1]:.4f}, int8_delta "
                f"{int8[2]:+.4f} | {card}")
        conf = history["confusion"][-1]
        n_val = trainer.dataset.set_size("validation")
        if conf.sum() != n_val // args.batch_size * args.batch_size:
            raise RuntimeError(f"[fit] confusion sums to {conf.sum()} "
                               f"of {n_val} validation clips")
        log(f"[fit] seed {seed}: {args.epochs} epochs of {steps} steps "
            f"at batch {args.batch_size}, {trainer.compute_dtype}, BN "
            f"re-estimation over {args.bn_recalibration_batches} "
            f"batches per epoch, in {seed_s:.1f} s; decode_augment "
            f"launches {seed_launches} (expected {expected}: one per "
            f"train step and per BN batch); kernel vs plain on a drawn "
            f"batch [{args.batch_size}, {T}]: max abs err {da_err:.3g} "
            f"(tol {KERNEL_ATOL}) | {card}")
        if seed_launches != expected:
            raise RuntimeError(f"[fit] {seed_launches} decode_augment "
                               f"launches, expected {expected}")
        launches += seed_launches
        bests.append(record["val_acc_best"])
        del trainer, history
    mean = sum(bests) / len(bests)
    log(f"[fit] val_acc_best per seed {bests}, mean {mean:.4f} (gate "
        f"{FIT_ACC_GATE}); phase {time.perf_counter() - phase_t0:.1f} s")
    if mean < FIT_ACC_GATE:
        raise RuntimeError(f"[fit] seed mean {mean:.4f} < {FIT_ACC_GATE}")
    return launches


def stream_phase(card: str) -> int:
    """The [stream] phase: ``tools.bench_streaming`` (the flagship at
    batch 384 from a WAV tree on disk through ``HostPrefetchLoader``,
    warm-up, timed and traced steps); checks finite losses and one
    decode+augment launch a step, and holds the kernel against its plain
    version on one more streamed batch, with the bench's own draws.
    Returns the launches."""
    from speech_recognition_tpu_torch.tools import bench_streaming

    t0 = time.perf_counter()
    launch.reset_runs()
    out = run_tool(bench_streaming, STREAM_ARGS, "[stream]")
    launches = launch.runs()["decode_augment"]
    diag, record = out["diagnostics"], out["record"]
    if not diag["losses_finite"] or not record["value"] > 0:
        raise RuntimeError(f"[stream] {record} {diag}")
    if launches != diag["train_steps"] \
            or diag["decode_augment_launches"] != launches:
        raise RuntimeError(f"[stream] {launches} decode_augment launches in "
                           f"{diag['train_steps']} streamed steps")
    trainer = out["trainer"]
    wav, labels, silence = out["batch"]
    err = hold_decode_augment(wav, trainer.dataset.background.flat,
                              trainer.draw_stream(labels, silence),
                              "[stream]")
    parts = diag["loader_s_per_step"]
    log(f"[stream] {diag['model']} {diag['compute_dtype']} batch "
        f"{diag['batch_size']} from {diag['corpus_clips_on_disk']} WAVs on "
        f"disk: {record['value']:.1f} clips/s, {diag['ms_per_step']:.3f} "
        f"ms/step over {diag['steps']} steps after {diag['warmup']} (host "
        f"clock to the read of the last loss); loader host s/step: decode "
        f"{parts['decode_s']:.4f} (producer), copies {parts['copy_s']:.4f} "
        f"(producer), waiting {parts['wait_s']:.4f} (trainer); native "
        f"decoder alone {diag['host_decode_clips_per_sec']:.0f} clips/s; "
        f"traced device busy {diag['device_busy_ms_per_step']:.3f} ms/step "
        f"(idle {100 * diag['device_idle_share']:.1f} % of the untraced "
        f"step; {100 * diag['traced_idle_share']:.1f} % of the traced "
        f"{diag['traced_wall_ms_per_step']:.3f} ms/step), H2D "
        f"{diag['memcpy_htod_ms_per_step']:.3f} ms/step, "
        f"{diag['kernels_per_step']:.0f} kernels a step; peak memory "
        f"{diag['peak_memory_bytes'] / 1e9:.2f} GB | {card}")
    log(f"[stream] decode_augment launches {launches} (one per streamed "
        f"step); kernel vs plain on a streamed batch [{BATCH}, {T}] as its "
        f"own bank: max abs err {err:.3g} (tol {KERNEL_ATOL}); phase "
        f"{time.perf_counter() - t0:.1f} s")
    return launches, record["value"]


def stream_ranks_run(card: str, one_rank: float) -> int:
    """[stream] over 2 ranks: ``tools.bench_streaming`` under
    ``torchrun`` (``STREAM_DP_ARGS``: 1 + 10 steps, untraced), each
    rank's loader over its shard of the clips with B/2 rows, the steps
    data-parallel; its clips/s beside the one rank's of this run. Checks
    finite losses and one decode+augment launch per streamed step on each
    rank. Returns the launches over both ranks."""
    import tempfile

    world = TORCHRUN_RANKS
    with tempfile.TemporaryDirectory(prefix="srt_torch_stream_dp_") as td:
        outs, errs, secs = torchrun(
            "speech_recognition_tpu_torch.tools.bench_streaming",
            STREAM_DP_ARGS, td, "[stream]")
    record = json.loads(outs[0].strip().splitlines()[-1])
    diag = json.loads(next(
        line for line in errs[0].splitlines()
        if line.startswith("diagnostics: "))[len("diagnostics: "):])
    launches = diag["decode_augment_launches_all_ranks"]
    if diag["ranks"] != world or not diag["losses_finite"] \
            or not record["value"] > 0 \
            or launches != world * diag["train_steps"]:
        raise RuntimeError(f"[stream] {world} ranks: {record} {diag}")
    shared = torch.cuda.device_count() < world
    parts = diag["loader_s_per_step"]
    log(f"[stream] {world} ranks under torchrun ({diag['batch_size']} "
        f"global, {diag['batch_size'] // world} rows a rank from its shard "
        f"of the WAVs): {record['value']:.1f} clips/s against one rank's "
        f"{one_rank:.1f} in this run (x{record['value'] / one_rank:.3f}); "
        f"rank 0: {diag['ms_per_step']:.3f} ms/step, loader host s/step "
        f"decode {parts['decode_s']:.4f} copies {parts['copy_s']:.4f} "
        f"waiting {parts['wait_s']:.4f}; decode_augment launches "
        f"{launches} over both ranks; "
        f"{secs:.1f} s with start-up"
        + ("; the ranks share one card, so this is no measure of scaling"
           if shared else "") + f" | {card}")
    return launches


def _train_line(line: str) -> bool:
    return line.startswith(("[ep", "final", "resumed", "Wrote", "wrote",
                            "{"))


def train_phase(device, card: str, root) -> int:
    """The [train] phase on the hard corpus [fit] wrote at ``root``:
    ``tools.train`` in bank mode, with ``--stream`` and BN re-estimation,
    and with ``--resume`` from the bank run's best checkpoint, each for
    two epochs in a working directory of its own; reads the TensorBoard
    events back; freezes the streamed run's best checkpoint in float32
    and int8 (``tools.freeze``), runs ``tools.run_edge_inference
    --benchmark`` on the card over the validation WAVs, and holds the
    archives' probabilities against the eager ``Predictor`` (f32, TF32
    off): the f32 archive against the checkpoint's weights, the int8
    one against their int8 quantization, dequantized. Checks the steps
    and decode+augment's launches of the three runs, and holds the kernel
    against its plain version on a batch of the bank run and on a batch
    of the CLI's streamed loader. Returns the launches."""
    import shutil
    import tempfile
    from pathlib import Path

    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.data.index import build_dataset_index
    from speech_recognition_tpu_torch.data.prefetch import HostPrefetchLoader
    from speech_recognition_tpu_torch.data.wav import load_wav_file
    from speech_recognition_tpu_torch.export.aot import (
        load_exported, quantize_weights_int8,
    )
    from speech_recognition_tpu_torch.infer.tta import Predictor, TTAConfig
    from speech_recognition_tpu_torch.labels import (
        SILENCE_LABEL, get_classes,
    )
    from speech_recognition_tpu_torch.models.zoo import build_model
    from speech_recognition_tpu_torch.tools import (
        freeze, run_edge_inference, train,
    )
    from speech_recognition_tpu_torch.utils.tb_events import (
        read_scalar_events,
    )

    phase_t0 = time.perf_counter()
    common = ["--data_dirs", str(root), "--epochs", str(TRAIN_EPOCHS),
              "--validation_percentage", str(TRAIN_VALIDATION_PCT),
              "--device", device.type]
    runs = (("bank", []),
            ("stream", ["--stream", "--bn_recalibration_batches",
                        str(TRAIN_BN_BATCHES)]),
            ("resume", ["--resume"]))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="srt_torch_train_") as td:
        os.chdir(td)
        try:
            out, launches = {}, {}
            for mode, extra in runs:
                if mode == "resume":
                    best = Path("checkpoints_bank/BEST").read_text()
                    best_step = int(torch.load(best, map_location="cpu",
                                               weights_only=True)["step"])
                    extra = extra + [best]
                t0 = time.perf_counter()
                launch.reset_runs()
                out[mode] = run_tool(train, common + ["--experiment", mode]
                                     + extra, "[train]", _train_line)
                launches[mode] = launch.runs()["decode_augment"]
                log(f"[train] tools.train {mode}: {TRAIN_EPOCHS} epochs, "
                    f"step {out[mode]['state'].step}, val acc "
                    f"{out[mode]['val_categorical_accuracy']:.4f}, "
                    f"{time.perf_counter() - t0:.1f} s, decode_augment "
                    f"launches {launches[mode]} | {card}")
            ds = out["bank"]["trainer"].dataset
            spe = max(1, ds.set_size("training") // BATCH)
            want_steps = {"bank": TRAIN_EPOCHS * spe,
                          "stream": TRAIN_EPOCHS * spe,
                          "resume": best_step + TRAIN_EPOCHS * spe}
            want_launches = {"bank": TRAIN_EPOCHS * spe,
                             "stream": TRAIN_EPOCHS * (spe
                                                       + TRAIN_BN_BATCHES),
                             "resume": TRAIN_EPOCHS * spe}
            for mode, _ in runs:
                if out[mode]["state"].step != want_steps[mode] \
                        or launches[mode] != want_launches[mode] \
                        or not np.isfinite(out[mode]["val_loss"]):
                    raise RuntimeError(
                        f"[train] {mode}: step {out[mode]['state'].step} "
                        f"(expected {want_steps[mode]}), launches "
                        f"{launches[mode]} (expected "
                        f"{want_launches[mode]}), val loss "
                        f"{out[mode]['val_loss']}")
                events = sorted(Path(f"logs_{mode}").glob("events.*"))
                scalars = dict(read_scalar_events(str(events[0])))
                if len(events) != 1 or sorted(scalars) != [0, 1] or any(
                        not np.isfinite(v[k]) for v in scalars.values()
                        for k in ("loss", "val_categorical_accuracy")):
                    raise RuntimeError(f"[train] {mode} TensorBoard events "
                                       f"{events}: {scalars}")
            log(f"[train] steps per epoch {spe} at batch {BATCH}; steps and "
                f"launches as expected (bank {want_launches['bank']}, "
                f"stream {want_launches['stream']} with "
                f"{TRAIN_BN_BATCHES} BN batches an epoch, resume "
                f"{want_launches['resume']} from step {best_step}); "
                f"TensorBoard events read back: epochs 0, 1, "
                f"{len(scalars[1])} scalars each")

            # the CLI's index; decode+augment on this path's own inputs:
            # a batch of the bank run's dataset, and the first batch of the
            # training files from the loader as the stream run builds it,
            # each with its trainer's draws
            classes = get_classes(wanted_only=True)
            index = build_dataset_index(
                data_dirs=[str(root)], silence_percentage=13.0,
                unknown_percentage=60.0, wanted_words=classes,
                validation_percentage=TRAIN_VALIDATION_PCT,
                testing_percentage=0.0)
            bank_trainer = out["bank"]["trainer"]
            da_err = {"bank": decode_augment_on_path(
                bank_trainer.dataset, bank_trainer.draw_batch(),
                "[train] bank")}
            stream_trainer = out["stream"]["trainer"]
            with HostPrefetchLoader(
                    index.files("training"), index.labels_array("training"),
                    index.is_silence_array("training"), batch_size=BATCH,
                    desired_samples=T, seed=0, device=device) as loader:
                wav, labels, silence = next(loader)
            da_err["stream"] = hold_decode_augment(
                wav, stream_trainer.dataset.background.flat,
                stream_trainer.draw_stream(labels, silence),
                "[train] stream")
            log(f"[train] decode_augment kernel vs plain, max abs err: on a "
                f"batch of the bank run {da_err['bank']:.3g}, on a streamed "
                f"batch [{BATCH}, {T}] of the CLI's loader "
                f"{da_err['stream']:.3g} (tol {KERNEL_ATOL})")

            # the validation WAVs (no silence entries) as a flat directory
            files = sorted({e.file for e in index.data_index["validation"]
                            if e.label != SILENCE_LABEL})
            val_dir = Path("validation_wavs")
            val_dir.mkdir()
            for i, path in enumerate(files):
                shutil.copy(path, val_dir / f"clip_{i:05d}.wav")
            # the streamed run's best checkpoint: its BN statistics are
            # re-estimated, so its probabilities differ by clip
            best = Path("checkpoints_stream/BEST").read_text()
            reports, fns = {}, {}
            for dtype in ("float32", "int8"):
                frozen = f"edge/{dtype}.pt2"
                run_tool(freeze, ["--checkpoint_path", best, "--frozen_path",
                                  frozen, "--weight_dtype", dtype,
                                  "--wanted_only", "--device", device.type],
                         "[train]")
                reports[dtype] = run_tool(run_edge_inference, [
                    "--frozen_graph", frozen, "--test_data", str(val_dir),
                    "--submission_fn", f"edge_{dtype}.csv", "--benchmark",
                    "--device", device.type], "[train]")
                fns[dtype] = load_exported(frozen, device)
            sizes = {k: r["artifact_bytes"] for k, r in reports.items()}
            if not (sizes["float32"] < EDGE_BYTES
                    and sizes["int8"] < EDGE_INT8_BYTES
                    and sizes["int8"] < sizes["float32"] / 2.5):
                raise RuntimeError(f"[train] archive bytes {sizes}")

            settings = prepare_model_settings(label_count=12)
            model, _ = build_model(MODEL, num_classes=12)
            model.load_state_dict(torch.load(best, map_location="cpu",
                                             weights_only=True)["model"])
            predictor = Predictor(model, settings, "raw",
                                  TTAConfig(use_tta=False), device)
            wav = torch.from_numpy(np.stack([
                load_wav_file(str(p), T)
                for p in sorted(val_dir.glob("*.wav"))[:EDGE_CHECK_CLIPS]]))
            eager = predictor.predict(wav)
            # the same model with its int8 weights dequantized, as the
            # int8 archive computes them
            model_q, _ = build_model(MODEL, num_classes=12)
            model_q.load_state_dict({
                k: w if scale is None else w.float() * scale
                for k, (w, scale) in quantize_weights_int8(
                    model.state_dict()).items()})
            eager_q = Predictor(model_q, settings, "raw",
                                TTAConfig(use_tta=False), device).predict(wav)
            probs = {k: torch.cat([fn(wav[i:i + 1])
                                   for i in range(len(wav))])
                     for k, fn in fns.items()}
            spread = float(eager.std(0).max())
            f32_err = float((probs["float32"] - eager).abs().max())
            int8_err = float((probs["int8"] - probs["float32"]).abs().max())
            int8_deq_err = float((probs["int8"] - eager_q).abs().max())
            if not (f32_err <= EDGE_PROB_ATOL and int8_err <= EDGE_INT8_ATOL
                    and int8_deq_err <= EDGE_PROB_ATOL
                    and torch.isfinite(probs["int8"]).all()):
                raise RuntimeError(f"[train] archives: f32 vs the eager "
                                   f"Predictor {f32_err}, int8 vs f32 "
                                   f"{int8_err}, int8 vs the eager Predictor "
                                   f"on the dequantized weights "
                                   f"{int8_deq_err}")
        finally:
            os.chdir(cwd)
    for dtype, r in reports.items():
        log(f"[train] edge {dtype}: {r['artifact_bytes']} bytes, batch 1 "
            f"over {r['clips']} validation WAVs on the card: "
            f"{r['avg_ms_per_sample']:.3f} ms/sample (model "
            f"{r['avg_model_ms']:.3f}, decode {r['avg_decode_ms']:.3f}), "
            f"device peak {r['device_peak_bytes'] / 1e6:.1f} MB, max RSS "
            f"{r['max_rss_bytes'] / 1e9:.2f} GB | {card}")
    log(f"[train] archive probabilities on {len(wav)} clips (largest "
        f"std of a class over the clips {spread:.3g}): f32 vs the "
        f"eager Predictor (f32, TF32 off) max abs err {f32_err:.3g} (tol "
        f"{EDGE_PROB_ATOL}); int8 vs the eager Predictor on the dequantized "
        f"int8 weights {int8_deq_err:.3g} (tol {EDGE_PROB_ATOL}); int8 vs "
        f"f32 {int8_err:.3g} (tol {EDGE_INT8_ATOL}); phase "
        f"{time.perf_counter() - phase_t0:.1f} s")
    return sum(launches.values())


def dp_train_phase(card: str, root) -> dict:
    """The [dp-train] phase on [fit]'s corpus at ``root``: ``tools.train``
    over 2 ranks under ``torchrun`` (the flagship at global batch 384),
    in bank mode, then with ``--stream`` and BN re-estimation, each for 2
    epochs of 2 steps in a working directory of its own. Checks that both
    ranks print the same figures after each epoch (the step, the train
    loss and the validation loss and accuracy, bit for bit), that each
    rank ran decode+augment once per train step (in bank mode through
    ``decode_augment_sharded``) and per streamed BN batch, and that rank
    0 alone wrote: one jsonl line and one report per epoch, one
    TensorBoard file, and a best checkpoint that loads. Returns the
    launches summed over the ranks, the bank steps' under
    ``decode_augment_sharded``, the streamed ones under
    ``decode_augment``."""
    import re
    import tempfile
    from pathlib import Path

    from speech_recognition_tpu_torch.parallel.distributed import (
        default_backend,
    )

    world = TORCHRUN_RANKS
    shared = torch.cuda.device_count() < world
    log(f"[dp-train] tools.train over {world} ranks under torchrun, backend "
        f"{default_backend(world)}, global batch {BATCH}"
        + ("; the ranks share one card, so no time here measures scaling"
           if shared else ""))
    epochs, spe = int(DP_TRAIN_ARGS[1]), int(DP_TRAIN_ARGS[3])
    common = ["--data_dirs", str(root), "--validation_percentage",
              str(TRAIN_VALIDATION_PCT), *DP_TRAIN_ARGS]
    totals = {"decode_augment": 0, "decode_augment_sharded": 0}
    for mode, extra, kernel, want in (
            ("bank", [], "decode_augment_sharded", epochs * spe),
            ("stream", ["--stream", "--bn_recalibration_batches",
                        str(DP_TRAIN_BN_BATCHES)], "decode_augment",
             epochs * (spe + DP_TRAIN_BN_BATCHES))):
        with tempfile.TemporaryDirectory(prefix=f"srt_torch_dp_{mode}_") \
                as td:
            outs, _, secs = torchrun(
                "speech_recognition_tpu_torch.tools.train",
                common + ["--experiment", mode] + extra, td, "[dp-train]")
            out = "".join(outs)
            lines = {}
            for rank, epoch, rest in re.findall(
                    r"^\[rank (\d+)/\d+\] epoch (\d+): (.*)$", out, re.M):
                lines.setdefault(int(epoch), {})[int(rank)] = rest
            if sorted(lines) != list(range(epochs)) or any(
                    sorted(v) != list(range(world)) for v in lines.values()):
                raise RuntimeError(f"[dp-train] {mode}: rank lines {lines}")
            for epoch, by_rank in lines.items():
                if len(set(by_rank.values())) != 1 \
                        or f"step={spe * (epoch + 1)} " not in by_rank[0]:
                    raise RuntimeError(f"[dp-train] {mode} epoch {epoch}: "
                                       f"the ranks report {by_rank}")
                loss = float(re.search(r" loss=(\S+)", by_rank[0]).group(1))
                if not np.isfinite(loss):
                    raise RuntimeError(f"[dp-train] {mode}: loss {loss}")
            launched = {int(r): int(n) for r, n in re.findall(
                r"\[rank (\d+)/\d+\] final: .* launches: "
                r"decode_augment=(\d+)", out)}
            if sorted(launched) != list(range(world)) or any(
                    v != want for v in launched.values()):
                raise RuntimeError(f"[dp-train] {mode}: launches {launched},"
                                   f" expected {want} on each rank")
            work = Path(td)
            jsonl = (work / f"logs_{mode}.jsonl").read_text().splitlines()
            # the reports are rank 0's alone
            reports = re.findall(r"^\[ep \d{3}\] ", outs[0], re.M)
            if re.search(r"^\[ep \d{3}\] ", "".join(outs[1:]), re.M):
                raise RuntimeError(f"[dp-train] {mode}: a rank other than "
                                   f"0 printed a report: {outs[1:]}")
            ckpt_dirs = sorted(work.glob("checkpoints_*"))
            events = list((work / f"logs_{mode}").glob("events.*"))
            best = (work / f"checkpoints_{mode}" / "BEST").read_text()
            tree = torch.load(best, map_location="cpu", weights_only=True)
            if len(jsonl) != epochs or len(reports) != epochs \
                    or len(ckpt_dirs) != 1 or len(events) != 1 \
                    or tree["step"] not in (spe, 2 * spe) or not all(
                        torch.isfinite(t).all()
                        for t in tree["model"].values()):
                raise RuntimeError(
                    f"[dp-train] {mode}: rank 0's files: {len(jsonl)} jsonl "
                    f"lines, {len(reports)} reports, {ckpt_dirs}, {events},"
                    f" checkpoint step {tree['step']}")
        totals[kernel] += sum(launched.values())
        log(f"[dp-train] {mode}: {epochs} epochs of {spe} steps in "
            f"{secs:.1f} s (torchrun, start-up included); every epoch the "
            f"ranks print the same figures: " + " | ".join(
                f"epoch {e}: {by_rank[0]}" for e, by_rank in lines.items())
            + f"; launches per rank {launched[0]}; rank 0 alone wrote "
            f"{len(jsonl)} jsonl lines, {len(reports)} reports, one "
            f"TensorBoard file and checkpoints_{mode}/ (best at step "
            f"{tree['step']}, loads) | {card}")
    return totals


def stretch_signals() -> dict:
    """1 s test signals of the CPU stretch tests: a chirp, two tones, a
    tone burst and broadband noise (numpy seed 7)."""
    rng = np.random.default_rng(7)
    t = np.arange(T) / T
    burst = np.zeros(T)
    burst[4000:9000] = np.sin(2 * np.pi * 650 * t[:5000])
    return {k: torch.from_numpy(v.astype(np.float32))[None] for k, v in {
        "chirp": np.sin(2 * np.pi * (300 + 400 * t) * t),
        "tones": (0.6 * np.sin(2 * np.pi * 440 * t)
                  + 0.3 * np.sin(2 * np.pi * 987 * t + 1.3)),
        "noise": rng.normal(0, 0.3, T),
        "burst": burst}.items()}


def infer_card_vs_cpu(device, wav: torch.Tensor, card: str) -> None:
    """[infer] (a): the Predictor of both ported models in the three TTA
    modes, and ``time_stretch``, on the card against the CPU, in f32 with
    TF32 off (the Predictor's own flags, as it serves). ``wav`` are CPU
    clips; the models have random weights from a seed and the BN
    statistics of these clips."""
    from speech_recognition_tpu_torch.config import prepare_model_settings
    from speech_recognition_tpu_torch.infer.tta import Predictor, TTAConfig
    from speech_recognition_tpu_torch.models.zoo import build_model
    from speech_recognition_tpu_torch.ops.frontend import Frontend
    from speech_recognition_tpu_torch.ops.stretch import (
        slow_variant_keep_tail, time_stretch,
    )

    cpu = torch.device("cpu")
    slow = slow_variant_keep_tail(wav)
    modes = {"no TTA": TTAConfig(use_tta=False), "TTA": TTAConfig(),
             "speed TTA": TTAConfig(use_speed_tta=True)}
    errs = {}
    for name, rep in ((MODEL, "raw"), (FIT_MODEL, "spec")):
        settings = prepare_model_settings(12, output_representation=rep)
        model, _ = build_model(name, num_classes=12,
                               generator=torch.Generator().manual_seed(1))
        model = with_batch_stats(model, Frontend(settings).features(wav,
                                                                    rep))
        for mode, tta in modes.items():
            want = Predictor(copy.deepcopy(model), settings, rep, tta,
                             cpu).predict(wav, slow)
            got = Predictor(copy.deepcopy(model), settings, rep, tta,
                            device).predict(wav, slow).cpu()
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise RuntimeError(f"[infer] {name} {mode}: "
                                   f"{tuple(got.shape)} or non-finite")
            errs[f"{name} {mode}"] = float((got - want).abs().max())
    log(f"[infer] Predictor f32 (it turns TF32 off), card vs CPU on "
        f"{len(wav)} corpus clips, max abs err of the probabilities (tol "
        f"{INFER_PROB_ATOL}): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= INFER_PROB_ATOL}
    if bad:
        raise RuntimeError(f"[infer] Predictor card vs CPU: {bad}")
    errs = {}
    for name, y in stretch_signals().items():
        for rate in STRETCH_RATES:
            want = time_stretch(y, rate)
            got = time_stretch(y.to(device), rate).cpu()
            errs[f"{name}@{rate}"] = float((got - want).abs().max()
                                           / want.abs().max())
    log("[infer] time_stretch, card vs CPU, max abs err / max |CPU| (tol "
        "5e-05 noise, 0.15 tonal): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" | {card}")
    bad = {k: v for k, v in errs.items()
           if not v <= STRETCH_RTOL[k.split("@")[0]]}
    if bad:
        raise RuntimeError(f"[infer] time_stretch card vs CPU: {bad}")


def run_tool(tool, argv, tag: str = "[infer]", keep=None) -> object:
    """``tool.main(argv)`` in this process, its stdout echoed under
    ``tag |`` (only the lines ``keep`` accepts, if given); returns what
    it returned."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = tool.main(argv)
    for line in out.getvalue().splitlines():
        if keep is None or keep(line):
            log(f"{tag} | {line}")
    return result


def check_submission(paths: dict, names: list, int2label, mode: str):
    """The files of one ``tools.make_submission`` run: one row per clip in
    sorted order in each CSV, probabilities summing to 1 (0.6 with speed
    TTA: the reference's 6-term sum over 10), each label the argmax of
    its probabilities, the memmap the truncation of probs x 255 in
    AUDIO_NAMES order. Returns (probs [N, 12], wanted labels)."""
    import csv

    from speech_recognition_tpu_torch.infer.submission import (
        to_audio_names_order,
    )
    from speech_recognition_tpu_torch.labels import (
        get_classes, map_to_valid, map_to_wanted, prepare_words_list,
    )

    def rows(kind):
        with open(paths[kind], newline="") as f:
            return list(csv.DictReader(f))

    wanted, every, prob_rows = rows("wanted"), rows("all"), rows("probs")
    for kind, r in (("wanted", wanted), ("all", every), ("probs", prob_rows)):
        if [x["fname"] for x in r] != names:
            raise RuntimeError(f"[infer] {mode}: {kind} CSV rows are not "
                               f"the {len(names)} clips in sorted order")
    probs = np.array([[float(x[int2label[i]]) for i in range(12)]
                      for x in prob_rows], np.float32)
    total = 0.6 if mode == "speed TTA" else 1.0
    if not np.isfinite(probs).all() \
            or np.abs(probs.sum(1) - total).max() > 1e-5:
        raise RuntimeError(f"[infer] {mode}: probabilities do not sum to "
                           f"{total}")
    top = [map_to_valid(int2label[int(i)]) for i in probs.argmax(1)]
    words = prepare_words_list(get_classes(wanted_only=True))
    if [x["label"] for x in every] != top or [x["label"] for x in wanted] \
            != [map_to_wanted(t, words) for t in top]:
        raise RuntimeError(f"[infer] {mode}: a label is not the argmax")
    mm = np.fromfile(paths["memmap"], np.uint8).reshape(len(names), 12)
    if not np.array_equal(mm, (to_audio_names_order(probs, int2label)
                               * 255).astype(np.uint8)):
        raise RuntimeError(f"[infer] {mode}: memmap is not probs x 255 in "
                           f"AUDIO_NAMES order")
    return probs, [x["label"] for x in wanted]


def serving_chain(device, td, root, card: str) -> int:
    """[infer] (b): train ``conv_1d_spec`` by [fit]'s recipe (seed 0),
    with the classes in the submission's order and a best-only
    checkpoint, gather the validation clips into a flat test
    directory, run the TTA set, the three submissions, the pseudo-label
    tools and the vote through their entry points, check the files, then
    retrain on train plus the pseudo-labels. Returns decode+augment's
    launches in the retrain."""
    import os
    import shutil
    from pathlib import Path

    from speech_recognition_tpu_torch.config import (
        AugmentConfig, prepare_model_settings,
    )
    from speech_recognition_tpu_torch.data.device_bank import (
        build_device_dataset,
    )
    from speech_recognition_tpu_torch.data.index import build_dataset_index
    from speech_recognition_tpu_torch.data.wav import decode_batch_int16
    from speech_recognition_tpu_torch.infer.tta import Predictor, TTAConfig
    from speech_recognition_tpu_torch.labels import (
        SILENCE_LABEL, get_classes, get_int2label,
    )
    from speech_recognition_tpu_torch.models.zoo import build_model
    from speech_recognition_tpu_torch.tools import calibrate_accuracy as C
    from speech_recognition_tpu_torch.tools import (
        create_tta_set, make_submission, pseudo_labels,
    )
    from speech_recognition_tpu_torch.train.checkpoint import (
        BestCheckpoint, PlateauCallback, restore_checkpoint,
    )
    from speech_recognition_tpu_torch.train.loop import Trainer
    from speech_recognition_tpu_torch.train.optim import ReduceLROnPlateau

    td = Path(td)
    wanted = get_classes(wanted_only=True)
    int2label = get_int2label(wanted_only=True)
    settings = prepare_model_settings(12, output_representation="spec")
    args = C.parse_args(FIT_ARGS)
    # the calibration's split and recipe (batch, epochs, plateau, BN
    # re-estimation), in bf16
    index_args = dict(silence_percentage=13.0, unknown_percentage=60.0,
                      wanted_words=wanted, validation_percentage=20.0,
                      testing_percentage=0.0)
    index = build_dataset_index([str(root)], **index_args)
    t0 = time.perf_counter()
    trainer = Trainer(FIT_MODEL, settings,
                      build_device_dataset(index, settings, device),
                      augment=AugmentConfig(), batch_size=args.batch_size,
                      seed=0, compute_dtype="bfloat16")
    _, history = trainer.fit(
        trainer.init_state(), epochs=args.epochs,
        callbacks=[PlateauCallback(ReduceLROnPlateau(
            factor=0.5, patience=4, min_lr=1e-5, mode="max")),
            BestCheckpoint(str(td / "ckpt"), verbose=False)],
        bn_recalibration_batches=args.bn_recalibration_batches,
        steps_per_dispatch=8)
    ckpt = (td / "ckpt" / "BEST").read_text()
    log(f"[infer] {FIT_MODEL} trained by [fit]'s recipe (seed 0, classes "
        f"in the submission's order) in {time.perf_counter() - t0:.1f} s: "
        f"val_acc_best {max(history['val_categorical_accuracy']):.4f}; "
        f"checkpoint {os.path.basename(ckpt)}")
    del trainer

    # the validation clips (every word file the sweep saw, no silence
    # entries) as a flat test directory, names without _nohash_ so that
    # their pseudo-labels land in the pseudo partition
    files = sorted({e.file: e.label for e in index.data_index["validation"]
                    if e.label != SILENCE_LABEL}.items())
    test_dir, tta_dir = td / "test", td / "tta"
    test_dir.mkdir()
    names, truth = [], []
    for i, (path, label) in enumerate(files):
        names.append(f"clip_{i:05d}.wav")
        truth.append(label if label in wanted else "unknown")
        shutil.copy(path, test_dir / names[-1])

    t0 = time.perf_counter()
    run_tool(create_tta_set, ["--test_dir", str(test_dir), "--out_dir",
                              str(tta_dir), "--device", device.type])
    common = ["--checkpoint", ckpt, "--model", FIT_MODEL, "--test_dir",
              str(test_dir), "--output_representation", "spec",
              "--window_size_ms", "30", "--window_stride_ms", "10",
              "--wanted_only", "--batch_size", str(INFER_BATCH),
              "--device", device.type]
    subs, probs, accs = {}, {}, {}
    for mode, extra in (("no TTA", ["--no_tta"]), ("TTA", []),
                        ("speed TTA", ["--tta_dir", str(tta_dir)])):
        prefix = str(td / f"sub_{mode.replace(' ', '_')}")
        subs[mode] = run_tool(make_submission,
                              common + extra + ["--out_prefix", prefix])
        probs[mode], labels = check_submission(subs[mode], names, int2label,
                                               mode)
        accs[mode] = float(np.mean([a == b for a, b in zip(labels, truth)]))
    chain_s = time.perf_counter() - t0

    # the no-TTA probabilities against the Predictor on the same batches
    model, _ = build_model(FIT_MODEL, num_classes=12)
    model.load_state_dict(torch.load(ckpt, map_location="cpu",
                                     weights_only=True)["model"])
    pred = Predictor(model, settings, "spec", TTAConfig(use_tta=False),
                     device)
    n = len(names)
    rows = np.zeros((-(-n // INFER_BATCH) * INFER_BATCH, T), np.int16)
    decode_batch_int16([str(test_dir / x) for x in names], T, out=rows)
    direct = torch.cat([pred.predict(torch.from_numpy(
        rows[s:s + INFER_BATCH])).cpu() for s in range(0, len(rows),
                                                         INFER_BATCH)])[:n]
    direct_err = float(np.abs(direct.numpy() - probs["no TTA"]).max())
    log(f"[infer] submissions over {n} validation clips (batch "
        f"{INFER_BATCH}: {n // INFER_BATCH} full and a tail of "
        f"{n % INFER_BATCH}) in {chain_s:.1f} s with the TTA set: rows, "
        f"sums, argmax labels and memmaps checked; no-TTA probabilities "
        f"against the Predictor on the same batches: max abs err "
        f"{direct_err:.3g} (tol {INFER_DIRECT_ATOL}); accuracy on these "
        f"labelled clips: " + ", ".join(f"{k} {v:.4f}"
                                       for k, v in accs.items())
        + f" | {card}")
    if not direct_err <= INFER_DIRECT_ATOL:
        raise RuntimeError(f"[infer] no-TTA probabilities vs the Predictor: "
                           f"{direct_err}")

    # [dp-infer]: the TTA submission over 2 ranks under torchrun
    prefix = str(td / "sub_dp")
    outs, _, secs = torchrun(
        "speech_recognition_tpu_torch.tools.make_submission",
        common + ["--data_parallel", "on", "--out_prefix", prefix], td,
        "[dp-infer]")
    out = "".join(outs)
    if f"data parallel: on, {TORCHRUN_RANKS} ranks" not in out \
            or out.count("wrote:") != 1:
        raise RuntimeError(f"[dp-infer] make_submission output: {out}")
    dp_paths = {"wanted": f"{prefix}.csv",
                "all": f"{prefix}_all_labels.csv",
                "probs": f"{prefix}_all_labels_probs.csv",
                "memmap": f"{prefix}_probs.uint8.memmap"}
    dp_probs, _ = check_submission(dp_paths, names, int2label, "TTA")
    dp_err = float(np.abs(dp_probs - probs["TTA"]).max())
    log(f"[dp-infer] make_submission --data_parallel on over "
        f"{TORCHRUN_RANKS} ranks (each decodes and predicts "
        f"{INFER_BATCH // TORCHRUN_RANKS} rows of every batch of "
        f"{INFER_BATCH}; the tail padded): rank 0 alone wrote the files; "
        f"probabilities vs one process's TTA submission max abs err "
        f"{dp_err:.3g} (tol {DP_INFER_ATOL}); {secs:.1f} s with start-up "
        f"| {card}")
    if not dp_err <= DP_INFER_ATOL:
        raise RuntimeError(f"[dp-infer] 2-rank probabilities vs one "
                           f"process: {dp_err}")

    wanted_csvs = [subs[m]["wanted"] for m in subs]
    pseudo_dir = td / "pseudo"
    stats = run_tool(pseudo_labels, [
        "threshold", "--submission_csv", subs["TTA"]["wanted"], "--memmap",
        subs["TTA"]["memmap"], "--test_dir", str(test_dir), "--out_dir",
        str(pseudo_dir)])
    agreed = run_tool(pseudo_labels, [
        "agreement", "--submissions", *wanted_csvs, "--test_dir",
        str(test_dir), "--out_dir", str(td / "agree")])
    clear, total = run_tool(pseudo_labels, [
        "vote", "--submissions", *wanted_csvs, "--out",
        str(td / "vote.csv")])
    if stats["created"] == 0 or total != n or not 0 < agreed <= n:
        raise RuntimeError(f"[infer] pseudo-labels: threshold {stats}, "
                           f"agreement {agreed}, vote {clear}/{total}")

    # retrain from the checkpoint on train plus the threshold pseudo-labels
    index = build_dataset_index([str(root), str(pseudo_dir)], **index_args)
    ds = build_device_dataset(index, settings, device)
    trainer = Trainer(
        FIT_MODEL, settings, ds,
        augment=AugmentConfig(pseudo_frequency=RETRAIN_PSEUDO_FREQUENCY),
        batch_size=args.batch_size, seed=0, compute_dtype="bfloat16")
    state = restore_checkpoint(ckpt, trainer.init_state())
    pseudo_ids = ds.partitions["pseudo"].file_ids
    draws, drawn = [], []
    draw = trainer.draw_batch

    def counting_draw(*a, **kw):
        d = draw(*a, **kw)
        draws.append(d)
        drawn.append(torch.isin(d.file_ids, pseudo_ids).sum())
        return d

    trainer.draw_batch = counting_draw
    steps = ds.set_size("training") // args.batch_size
    launch.reset_runs()
    state, history = trainer.fit(
        state, epochs=RETRAIN_EPOCHS,
        bn_recalibration_batches=args.bn_recalibration_batches,
        steps_per_dispatch=8)
    launches = launch.runs()["decode_augment"]
    expected = RETRAIN_EPOCHS * (steps + args.bn_recalibration_batches)
    drawn = torch.stack(drawn)
    pseudo_rows = int(drawn.sum())
    most = int(drawn.argmax())
    da_err = decode_augment_on_path(ds, draws[most], "[infer] retrain")
    losses = history["loss"] + history["val_loss"]
    log(f"[infer] retrain: {RETRAIN_EPOCHS} epochs of {steps} steps at "
        f"batch {args.batch_size} on {ds.set_size('training')} training "
        f"and {ds.set_size('pseudo')} pseudo entries (pseudo frequency "
        f"{RETRAIN_PSEUDO_FREQUENCY}): {pseudo_rows} pseudo rows drawn, "
        f"losses {[round(v, 4) for v in history['loss']]}, val acc "
        f"{[round(v, 4) for v in history['val_categorical_accuracy']]}; "
        f"decode_augment launches {launches} (expected {expected}: one per "
        f"train step and per BN batch); kernel vs plain on the draw with "
        f"the most pseudo rows ({int(drawn[most])} of {args.batch_size}, "
        f"[{args.batch_size}, {T}]): max abs err {da_err:.3g} (tol "
        f"{KERNEL_ATOL})")
    if launches != expected or pseudo_rows == 0 \
            or not np.isfinite(losses).all():
        raise RuntimeError(f"[infer] retrain: launches {launches} of "
                           f"{expected}, pseudo rows {pseudo_rows}, losses "
                           f"{losses}")
    return launches


def bench_infer_runs(td, card: str) -> None:
    """[infer] (c): ``tools.bench_infer`` on the flagship at batch 384,
    random weights, over a tree of 7,777 WAVs, with TTA and without; its
    JSON line and diagnostics echoed."""
    import io
    import math

    from speech_recognition_tpu_torch.tools import bench_infer

    one_rank = {}
    for extra in ([], ["--no_tta"]):
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            bench_infer.main(["--num_files", str(BENCH_INFER_FILES),
                              "--keep_dir", str(td), "--device", "cuda"]
                             + extra)
        for line in err.getvalue().splitlines() + out.getvalue().splitlines():
            log(f"[infer] bench_infer{' ' + extra[0] if extra else ''}: "
                f"{line}")
        line = json.loads(out.getvalue().splitlines()[-1])
        values = [line["end_to_end_clips_per_sec"],
                  line["device_clips_per_sec"]]
        if next(iter(line)) != "end_to_end_clips_per_sec" or not all(
                math.isfinite(v) and v > 0 for v in values):
            raise RuntimeError(f"[infer] bench_infer line: {line}")
        log(f"[infer] bench_infer {'without' if extra else 'with'} TTA: "
            f"device {line['device_clips_per_sec']:.1f} clips/s, end to end "
            f"{line['end_to_end_clips_per_sec']:.1f} clips/s ("
            f"{time.perf_counter() - t0:.1f} s) | {card}")
        one_rank[bool(extra)] = line["end_to_end_clips_per_sec"]

    # the sweep with TTA over 2 ranks under torchrun, on the same tree
    outs, _, secs = torchrun(
        "speech_recognition_tpu_torch.tools.bench_infer",
        ["--num_files", str(BENCH_INFER_FILES), "--keep_dir", str(td)],
        td.parent, "[dp-infer]")
    line = json.loads(outs[0].strip().splitlines()[-1])
    if line["ranks"] != TORCHRUN_RANKS or not math.isfinite(
            line["end_to_end_clips_per_sec"]) \
            or line["end_to_end_files"] != BENCH_INFER_FILES:
        raise RuntimeError(f"[dp-infer] bench_infer over ranks: {line}")
    shared = torch.cuda.device_count() < TORCHRUN_RANKS
    log(f"[dp-infer] bench_infer with TTA over {TORCHRUN_RANKS} ranks "
        f"({BENCH_INFER_FILES} WAVs, each rank {384 // TORCHRUN_RANKS} rows "
        f"of every batch of 384): end to end "
        f"{line['end_to_end_clips_per_sec']:.1f} clips/s against one "
        f"rank's {one_rank[False]:.1f} in this run "
        f"(x{line['end_to_end_clips_per_sec'] / one_rank[False]:.3f}); "
        f"{secs:.1f} s with start-up"
        + ("; the ranks share one card, so this is no measure of scaling"
           if shared else "") + f" | {card}")


def wav_decoders(root, card: str) -> None:
    """[infer] (d): the native batch WAV decoder (``csrc/wavio.cc``, on
    its default threads and on one) against its numpy version over the
    tree ``bench_infer`` wrote: files/s of each, host clock, the files in
    the page cache (the bench has read them); the rows must be equal."""
    from speech_recognition_tpu_torch.data import wav as W

    paths = sorted(str(p) for p in root.rglob("*.wav"))
    if len(paths) != BENCH_INFER_FILES:
        raise RuntimeError(f"[infer] {len(paths)} WAVs under {root}")
    rows = {}
    threads = W.default_threads()
    for label, decode in (
            ("numpy", lambda: W.decode_batch_int16_numpy(paths, T)),
            ("native, 1 thread", lambda: W.decode_batch_int16(
                paths, T, num_threads=1)),
            (f"native, {threads} threads",
             lambda: W.decode_batch_int16(paths, T))):
        t0 = time.perf_counter()
        rows[label] = decode()
        secs = time.perf_counter() - t0
        log(f"[infer] WAV decode {label}: {len(paths)} files in "
            f"{secs:.3f} s, {len(paths) / secs:.1f} files/s "
            f"({1e6 * secs / len(paths):.1f} us a file; host clock, "
            f"{os.cpu_count()} cores) | {card}")
    want = rows.pop("numpy")
    for label, got in rows.items():
        if got.shape != want.shape or not np.array_equal(got, want):
            raise RuntimeError(f"[infer] WAV decode {label}: rows differ "
                               f"from the numpy decoder's")
    log("[infer] WAV decode: native rows equal the numpy decoder's")


def infer_phase(device, card: str) -> int:
    """The [infer] phase: (a) the Predictor and the stretch on the card
    against the CPU, (b) the serving chain on the hard corpus and the
    retrain on its pseudo-labels, (c) ``tools.bench_infer``. Returns
    decode+augment's launches in the retrain."""
    import tempfile
    from pathlib import Path

    from speech_recognition_tpu_torch.data.hard_corpus import (
        build_hard_corpus,
    )
    from speech_recognition_tpu_torch.data.wav import load_wav_file
    from speech_recognition_tpu_torch.tools import calibrate_accuracy as C

    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="srt_torch_infer_") as td:
        args = C.parse_args(FIT_ARGS)
        root = Path(td) / "corpus" / "audio"
        build_hard_corpus(root, clips_per_word=args.clips_per_word,
                          seed=args.corpus_seed,
                          snr_db_range=(args.snr_lo, args.snr_hi),
                          pitch_span_l=args.pitch_span_l)
        wav = torch.from_numpy(np.stack([
            load_wav_file(str(p), T)
            for p in sorted(root.glob("*/spk00[0-3]_nohash_0.wav"))[:8]]))
        infer_card_vs_cpu(device, wav, card)
        launches = serving_chain(device, td, root, card)
        bench_infer_runs(Path(td) / "bench", card)
        wav_decoders(Path(td) / "bench", card)
    log(f"[infer] phase {time.perf_counter() - phase_t0:.1f} s")
    return launches


def profile_phase(card: str) -> int:
    """The [profile] phase: ``tools.profile_step`` on the flagship at
    batch 384 (bf16), its trace read back by ``summarize_trace``: the
    device busy per step, the largest kernels and the op classes. Checks
    that the trace holds one decode+augment kernel per traced step and
    that the kernel launched once per step. Returns the launches."""
    import tempfile

    from speech_recognition_tpu_torch.tools import profile_step

    steps = int(PROFILE_ARGS[3])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="srt_torch_profile_") as td:
        launch.reset_runs()
        summary = run_tool(profile_step, PROFILE_ARGS + ["--trace_dir", td],
                           "[profile]", keep=lambda line: False)
        launches = launch.runs()["decode_augment"]
    kernels = {n: m for n, m in summary["modules"].items()
               if re.search(DECODE_KERNEL, n)}
    count = sum(m["count"] for m in kernels.values())
    if launches != steps + int(PROFILE_ARGS[1]) or count != steps \
            or not summary["ms_per_step"] > 0:
        raise RuntimeError(f"[profile] launches {launches}, decode_augment "
                           f"kernels in the trace {count}, "
                           f"{summary['ms_per_step']} ms/step")
    top = sorted(summary["modules"].items(),
                 key=lambda kv: -kv[1]["total_ms"])[:6]
    log(f"[profile] tools.profile_step {MODEL} batch {BATCH} bf16: device "
        f"busy {summary['ms_per_step']:.3f} ms/step over {steps} traced "
        f"steps ({summary['activities'] / steps:.0f} device activities a "
        f"step); op classes ms/step: " + ", ".join(
            f"{k} {v / steps:.3f}" for k, v in summary["ops"].items())
        + f" | {card}")
    log("[profile] top kernels ms/step: " + "; ".join(
        f"{n[:48]} {m['total_ms'] / steps:.3f} (x{m['count'] // steps})"
        for n, m in top) + f"; decode_augment {count} in the trace, "
        f"{launches} launches; phase {time.perf_counter() - t0:.1f} s")
    return launches


def tools_phase(card: str) -> int:
    """The [tools] phase: ``tools.model_info`` over all 25 models on the
    card (parameters, bytes, FLOPs by FlopCounterMode, the Pi budget),
    then ``tools.bench_zoo`` over two models. Checks 25 reports with
    finite positive FLOPs and the flagship's parameter count, and one
    decode+augment launch per bench step. Returns the launches."""
    from speech_recognition_tpu_torch.tools import bench_zoo, model_info

    t0 = time.perf_counter()
    rows = run_tool(model_info, ["--device", "cuda"], "[tools]",
                    keep=lambda line: False)
    flagship = next(r for r in rows if r["model"] == MODEL)
    if len(rows) != 25 or flagship["params"] != 1_191_433 \
            or not flagship["fits_pi_budget"] or not all(
                np.isfinite(r["forward_flops_per_clip"])
                and r["forward_flops_per_clip"] > 0 for r in rows):
        raise RuntimeError(f"[tools] model_info: {rows}")
    log(f"[tools] model_info over {len(rows)} models on the card in "
        f"{time.perf_counter() - t0:.1f} s (MFLOP/clip by "
        f"FlopCounterMode: products and convolutions): " + ", ".join(
            f"{r['model']} {r['params']:,} params "
            f"{r['forward_flops_per_clip'] / 1e6:.1f}"
            + ("" if r["fits_pi_budget"] else " (over the Pi budget)")
            for r in rows))
    t0 = time.perf_counter()
    launch.reset_runs()
    zoo = run_tool(bench_zoo, ["--models", *TOOLS_ZOO_MODELS,
                               *TOOLS_ZOO_ARGS], "[tools]",
                   keep=lambda line: False)
    launches = launch.runs()["decode_augment"]
    per_model = int(TOOLS_ZOO_ARGS[1]) + int(TOOLS_ZOO_ARGS[3])
    if [r["model"] for r in zoo] != TOOLS_ZOO_MODELS \
            or launches != per_model * len(zoo) \
            or not all(r["clips_per_sec"] > 0 for r in zoo):
        raise RuntimeError(f"[tools] bench_zoo: {zoo}, {launches} launches")
    log(f"[tools] bench_zoo ({TOOLS_ZOO_ARGS[1]} steps after "
        f"{TOOLS_ZOO_ARGS[3]}, CUDA events): " + "; ".join(
            f"{r['model']} {r['ms_per_step']} ms/step "
            f"{r['clips_per_sec']:.1f} clips/s" for r in zoo)
        + f"; decode_augment launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s | {card}")
    return launches


def bench_phase(card: str) -> int:
    """The [bench] phase: ``python -m speech_recognition_tpu_torch.bench``
    in a child at the full-corpus scale; its first stdout line must be
    the metric JSON with a finite positive value, and its decode+augment
    launches must equal its train steps. Returns the launches."""
    import math
    import os

    env = dict(os.environ, **BENCH_ENV)
    env.pop("BENCH_SCALE", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "speech_recognition_tpu_torch.bench"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if line.startswith(("rep ", "diagnostics:", "bench total")):
            log(f"[bench] {line}")
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"[bench] rc {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    metric = json.loads(lines[0])
    value = metric.get("value")
    if metric.get("metric") != "train_clips_per_sec" \
            or not isinstance(value, (int, float)) \
            or not math.isfinite(value) or value <= 0:
        raise RuntimeError(f"[bench] first stdout line: {lines[0]}")
    diag = [json.loads(ln.split(":", 1)[1]) for ln in proc.stderr.splitlines()
            if ln.startswith("diagnostics:")]
    if len(diag) != 1 or diag[0]["decode_augment_launches"] \
            != diag[0]["train_steps"]:
        raise RuntimeError(f"[bench] diagnostics {diag}")
    log(f"[bench] metric line: {lines[0]} (env {BENCH_ENV}; {wall:.1f} s) "
        f"| {card}")
    return diag[0]["decode_augment_launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from speech_recognition_tpu_torch.config import (
        AugmentConfig, prepare_model_settings,
    )
    from speech_recognition_tpu_torch.data.device_bank import (
        synthetic_device_dataset,
    )
    from speech_recognition_tpu_torch.device import require_cuda
    from speech_recognition_tpu_torch.export.benchmark import (
        benchmark_train,
    )
    from speech_recognition_tpu_torch.models.layers import BatchNorm
    from speech_recognition_tpu_torch.models.zoo import build_model
    from speech_recognition_tpu_torch.ops.kernels import (
        decode_augment as K,
    )
    from speech_recognition_tpu_torch.train.loop import Trainer

    # 1. device
    device = require_cuda()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)    # nvidia-smi's name, power.limit as it prints them
    log(f"[device] {kind} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    # 2. build every kernel at once, one nvcc per source
    from speech_recognition_tpu_torch.ops.kernels import build
    with concurrent.futures.ThreadPoolExecutor(
            2 * len(KERNEL_SOURCES)) as pool:
        ptxas = {n: pool.submit(build.ptxas_report, n)
                 for n in KERNEL_SOURCES}
        builds = dict(zip(KERNEL_SOURCES,
                          pool.map(timed_build, KERNEL_SOURCES)))
        ptxas = {n: f.result() for n, f in ptxas.items()}
    for lib, secs in builds.values():
        log(f"[build] {lib.name} in {secs:.2f} s")
    for line in ptxas["decode_augment"]:
        log(f"[kernel] ptxas -v {line}")

    # the full-corpus bank the slice trains on (also the kernel's input)
    t0 = time.perf_counter()
    ds = synthetic_device_dataset(
        device, num_train=NUM_TRAIN, num_val=NUM_VAL, num_pseudo=NUM_PSEUDO,
        num_classes=12, num_background=NUM_BACKGROUND,
        background_len=BACKGROUND_LEN)
    torch.cuda.synchronize()
    log(f"[data] {ds.num_clips} clips, "
        f"{ds.wav_bank.numel() * 2 / 1e9:.2f} GB int16 bank on the card, "
        f"{ds.background.flat.numel()} background samples, set up in "
        f"{time.perf_counter() - t0:.1f} s")
    settings = prepare_model_settings(label_count=12)
    trainer = Trainer(MODEL, settings, ds,
                      augment=AugmentConfig(pseudo_frequency=0.6),
                      batch_size=BATCH)
    if trainer.compute_dtype != "bfloat16":
        raise RuntimeError(f"compute dtype {trainer.compute_dtype}")

    # 3. kernel against its plain version
    d = edge_case_draws(trainer, ds)
    bg = ds.background.flat
    before = launch.runs()["decode_augment"]
    errs = []
    for index_dtype in (torch.int64, torch.int32):
        args = (ds.wav_bank, bg, d.file_ids.to(index_dtype),
                d.shifts.to(index_dtype), d.fg_vol, d.bg_pos.to(index_dtype),
                d.bg_vol)
        got = K.decode_augment(*args)
        want = K.decode_augment_reference(*args)
        torch.cuda.synchronize()
        if got.shape != (BATCH, T) or not torch.isfinite(got).all():
            raise RuntimeError("kernel output has the wrong shape or "
                               "non-finite values")
        errs.append(float((got - want).abs().max()))
    max_err = max(errs)
    after = launch.runs()["decode_augment"]
    if after != before + 2:
        raise RuntimeError(f"decode_augment runs went {before} -> {after}")
    if max_err > KERNEL_ATOL:
        raise RuntimeError(f"kernel vs plain max abs err {max_err} > "
                           f"{KERNEL_ATOL}")
    args = (ds.wav_bank, bg, d.file_ids, d.shifts, d.fg_vol, d.bg_pos,
            d.bg_vol)
    timings = decode_augment_timings(
        lambda: K.decode_augment(*args),
        lambda: K.decode_augment_reference(*args), (BATCH, T), device)
    bound_ms, bound_by, nbytes = decode_augment_bound(*args)
    log(f"[kernel] decode_augment B={BATCH} T={T}: max abs err {max_err:.3g}"
        f" (int64 {errs[0]:.3g}, int32 {errs[1]:.3g}; tol {KERNEL_ATOL}); "
        + decode_augment_line(timings, bound_ms, bound_by, nbytes, card))

    # 4. the separable block: kernel against plain, then its benchmark
    separable_kernels = separable_phase(device, card,
                                        builds["separable_block"][1],
                                        ptxas["separable_block"])
    separable_kernels.append(separable_bwd_phase(
        device, card, builds["separable_block_bwd"][1],
        ptxas["separable_block_bwd"]))
    profile_separable(device)
    vjp_host_account(device, card)
    gru_kernel = gru_phase(device, card, builds["gru_recurrence"][1],
                           ptxas["gru_recurrence"])
    separable_kernels.append(gru_kernel)
    bn_kernel = bn_phase(device, card, ptxas["batchnorm"])
    separable_kernels.append(bn_kernel)
    maxpool_kernel = maxpool_phase(device, card, ptxas["maxpool"])
    separable_kernels.append(maxpool_kernel)
    dwconv_kernel = dwconv_phase(device, card, ptxas["dwconv1d"])
    separable_kernels.append(dwconv_kernel)

    # 5. the flagship on the card against the CPU, f32 with TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, _ = build_model(MODEL, num_classes=12,
                           generator=torch.Generator().manual_seed(1))
    x = ds.decode(ds.partitions["validation"].file_ids[:4])
    # BN running statistics set to these clips' batch statistics, so that
    # the logits are not vanishingly small
    model = with_batch_stats(model, x.cpu())
    on_card = copy.deepcopy(model).to(device).eval()
    with torch.no_grad():
        logits_card = on_card(x).cpu()
        logits_cpu = model(x.cpu())
    logit_err = float((logits_card - logits_cpu).abs().max())
    logit_max = float(logits_cpu.abs().max())
    if logits_card.shape != (4, 12) or not logit_err <= LOGITS_ATOL \
            or logit_max < 1e-2:
        raise RuntimeError(f"flagship logits card vs CPU: max abs err "
                           f"{logit_err}, max |logit| {logit_max}")
    log(f"[model] flagship f32 logits, card vs CPU on 4 clips: max abs err "
        f"{logit_err:.3g} (tol {LOGITS_ATOL}; max |logit| {logit_max:.3g})")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    del on_card

    # 6. the slice: 20 bf16 train steps, then one validation sweep
    state = trainer.init_state()
    torch.cuda.reset_peak_memory_stats()
    launch.reset_runs()
    result = benchmark_train(trainer, state, steps=STEPS, warmup=WARMUP)
    t0 = time.perf_counter()
    conf, val_loss = trainer.evaluate(state, "validation")
    eval_s = time.perf_counter() - t0
    runs = launch.runs()
    launches = runs["decode_augment"]
    bn_slice = {k: runs[k] for k in BN_KERNELS}
    maxpool_slice = {k: runs[k] for k in MAXPOOL_KERNELS}
    dwconv_slice = {k: runs[k] for k in DWCONV_KERNELS}
    losses = result["losses"]
    if launches != STEPS + WARMUP:
        raise RuntimeError(f"{launches} kernel launches in "
                           f"{STEPS + WARMUP} train steps")
    bns = sum(isinstance(m, BatchNorm) for m in state.model.modules())
    if bn_slice != dict.fromkeys(BN_KERNELS, (STEPS + WARMUP) * bns):
        raise RuntimeError(f"BatchNorm kernel runs {bn_slice} in "
                           f"{STEPS + WARMUP} train steps of {bns} "
                           f"BatchNorms")
    pools = len(pool_shapes(MODEL))
    if maxpool_slice != dict.fromkeys(MAXPOOL_KERNELS,
                                      (STEPS + WARMUP) * pools):
        raise RuntimeError(f"max-pool kernel runs {maxpool_slice} in "
                           f"{STEPS + WARMUP} train steps of {pools} "
                           f"last-axis pools")
    # the validation sweep's forwards run the forward kernel too
    dws = depthwise_convs(state.model)
    sweeps = NUM_VAL // BATCH
    if dwconv_slice != {"dwconv1d_fw": (STEPS + WARMUP + sweeps) * dws,
                        "dwconv1d_bw": (STEPS + WARMUP) * dws} or dws != 11:
        raise RuntimeError(f"depthwise kernel runs {dwconv_slice} in "
                           f"{STEPS + WARMUP} train steps and {sweeps} "
                           f"validation batches of {dws} depthwise convs")
    if len(losses) != STEPS + WARMUP or not np.isfinite(losses).all():
        raise RuntimeError(f"losses: {losses}")
    expected = (NUM_VAL // BATCH) * BATCH
    if conf.sum() != expected or not np.isfinite(val_loss):
        raise RuntimeError(f"confusion sums to {conf.sum()}, expected "
                           f"{expected}; val loss {val_loss}")
    log(f"[slice] losses {[round(v, 4) for v in losses]}")
    log(f"[slice] {MODEL} bf16 batch {BATCH}: {result['ms_per_step']:.3f} "
        f"ms/step, {result['clips_per_sec']:.0f} clips/s (CUDA events over "
        f"{STEPS} steps after {WARMUP}; host clock "
        f"{result['wall_ms_per_step']:.3f} ms/step); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | {card}")
    log(f"[slice] validation: {conf.sum()} clips in {eval_s:.2f} s, "
        f"accuracy {np.trace(conf) / conf.sum():.4f}, loss {val_loss:.4f}; "
        f"kernel launches in the main path: {launches}; BatchNorm kernel "
        f"runs {bn_slice} ({bns} BatchNorms a step, launched or replayed); "
        f"max-pool kernel runs {maxpool_slice} ({pools} last-axis pools a "
        f"step); depthwise kernel runs {dwconv_slice} ({dws} depthwise "
        f"convs a step, and forward in {sweeps} validation batches)")

    # 7. the other 23 zoo models on the same bank, each with the counts
    # set to 0 just before its steps
    del trainer, state
    torch.cuda.empty_cache()
    zoo_launches, gru_zoo, bn_zoo, maxpool_zoo, dwconv_zoo = zoo_phase(
        device, card, ds, settings)
    gru_kernel["launches_by_path"] = {"zoo": sum(gru_zoo.values())}
    gru_kernel["launches"] = sum(gru_zoo.values())
    bn_kernel["launches_by_path"] = {"slice": sum(bn_slice.values()),
                                     "zoo": sum(bn_zoo.values())}
    bn_kernel["launches"] = sum(bn_kernel["launches_by_path"].values())
    maxpool_kernel["launches_by_path"] = {
        "slice": sum(maxpool_slice.values()),
        "zoo": sum(maxpool_zoo.values())}
    maxpool_kernel["launches"] = sum(
        maxpool_kernel["launches_by_path"].values())
    dwconv_kernel["launches_by_path"] = {
        "slice": sum(dwconv_slice.values()),
        "zoo": sum(dwconv_zoo.values())}
    dwconv_kernel["launches"] = sum(
        dwconv_kernel["launches_by_path"].values())

    # 8. data-parallel training, in processes of their own
    del ds, d, bg, args
    torch.cuda.empty_cache()
    dp_kernel = dp_phase(card)

    # 9. the accuracy signal's calibration, the training CLI and the edge
    # export on its corpus, the serving path and the retrain on its
    # pseudo-labels, streaming, then the bench, each with the counts set
    # to 0 just before
    import tempfile
    from pathlib import Path

    launches_by_path = {"slice": launches, "zoo": zoo_launches}
    with tempfile.TemporaryDirectory(prefix="srt_torch_fit_") as td:
        root = Path(td) / "audio"
        launches_by_path["fit"] = fit_phase(device, card, root)
        launches_by_path["train"] = train_phase(device, card, root)
        dp_train = dp_train_phase(card, root)
        launches_by_path["dp_train"] = dp_train["decode_augment"]
    launches_by_path["infer"] = infer_phase(device, card)
    launches_by_path["stream"], one_rank = stream_phase(card)
    launches_by_path["stream_dp"] = stream_ranks_run(card, one_rank)
    launches_by_path["profile"] = profile_phase(card)
    launches_by_path["tools"] = tools_phase(card)
    launches_by_path["bench"] = bench_phase(card)
    dp_kernel["launches_by_path"] = {
        "dp": dp_kernel["launches"],
        "dp_train": dp_train["decode_augment_sharded"]}
    dp_kernel["launches"] += dp_train["decode_augment_sharded"]

    print(json.dumps({"kernels": [{
        "name": "decode_augment",
        "route": "cuda",
        "source": "speech_recognition_tpu_torch/csrc/decode_augment.cu",
        "replaces": "speech_recognition_tpu/ops/pallas/augment_kernel.py:188",
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "max_abs_err": max_err,
        **timings,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }] + separable_kernels + [dp_kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
