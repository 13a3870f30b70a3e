#!/usr/bin/env python3
"""Drive the PyTorch port (ssunet_gan_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

0. Identify the card (name and power limit from nvidia-smi, torch and CUDA
   versions) and build the CUDA kernels from ssunet_gan_tpu_torch/csrc/
   (one nvcc per source, all at once); count the wgmma instructions of each
   conv core instantiation in SASS (HGMMA in the eval conv core, IGMMA in
   the s8 conv core) and print every kernel's ptxas registers and spills,
   failing on a spill in the s8 conv core.
1. Kernel check: the fused eval stage on the card against its plain
   PyTorch version for the flagship's six fused-stage signatures at 512²,
   bf16, batch 2, seeded weights; then again with the model's own weights
   at the scene request's batch 32 (INFER_BATCH), and each stage timed at
   the tile forward's batch 8; then each of the stages' conv launches
   alone at batch 8 on the stage's own inputs (the eval conv core,
   ``ops/stage_kernel.py`` ``eval_conv``) against its per-launch plain
   version to the same bar, timed beside its bound and the ``F.conv2d``
   call of the same convs (a ``conv:`` line each, and their sum per
   forward).
2. Flagship tile forward: UNet_R_SS_v2 at the widths of
   configs/config_v1.json, seeded weights with every BatchNorm's
   statistics set from a seeded calibration batch (so activations and
   logits are O(1), as in a trained model, instead of shrinking stage by
   stage), 512² bf16 tiles, batch 8; tiles/s, six kernel runs per
   forward, logits against the all-plain forward on the card in bf16 and
   in f32 (the fused stages off: every stage the module composition); the
   f32 route of kernel 1 (``csrc/fused_stage_f32.cu``, 3xTF32 on the
   tensor cores) per stage signature against its plain version in f32 and
   timed (``f32 stage:`` lines), with inf / -inf / NaN planted (output
   classes against the per-launch plain versions), and each of its
   launches alone against its plain version, timed beside its f32 and
   3xTF32 bounds and ``F.conv2d`` f32 (``f32 conv:`` lines); kernel 1 in
   bf16 and f32 keeping a planted NaN on its receptive field; and an f32
   forward at batch 1, its six fused stages on the f32 route, against the
   CPU's.
3. Scene request: segmentation_inference on a seeded 2048² uint8 scene
   (patch 1024, overlap 0.5: 36 tiles, two chunks of 32, the last padded);
   the chunked forward's tile probabilities and the masks against the
   all-plain runs in bf16 and in f32.
4. Train kernels: for each of the six fused stage signatures at 512², bf16,
   batch 2, seeded weights, every call the train stage's forward and
   backward make, each held against its plain version on the same inputs:
   first with the v2 backward (conv_stats: conv1, conv2 with its prologue,
   the γ|β recompute, each backward-data conv down to 3 and nh channels;
   train_tail with and without the head; wgrad with and without the
   prologue), then with the v3 backward (the forward's calls, and every
   fused_conv3 and fused_wgrad chain mode), the v3 pass also at two
   signatures with SSUNet's hidden widths 32 and 64 (WIDE_HIDDEN_SIGS).
5. Stage gradients, after each backward's phase 4: the same six stages
   forward and backward with the kernels, against the same autograd
   Function on the plain versions (bf16) and against plain autograd of the
   module composition in f32: output, both batch-stat pairs, every input
   and parameter gradient.
6. Trainer (this slice's main path, the default v3 backward):
   UNet_R_SS_v2 from configs/config_v1.json at full width, its Adam (lr
   1e-4, weight decay 1e-7), clip 0.7 and BCEDiceLoss, bf16 activations on
   f32 parameters, SyntheticDataset(512, 512) through val_transform and
   BatchLoader at batch 8, train_one_epoch over 2 warm-up and 5 timed
   steps; ms/step and images/s, kernel launches per step against the
   derived counts (PER_STEP), finite metrics, moved BN statistics; then
   V2_STEPS steps with the v2 backward timed beside it (a record); step 1
   on STEP1_BATCHES seeded batches held against the same step on the plain
   versions (bf16) and on the plain module composition (f32), each
   whole-model bar on distances pooled over the batches (STEP1_*), and
   per fused stage on the inputs and cotangent the kernel step gave it
   (batch 1); each kernel call of one
   steady-state v3 step (and the conv_stats and wgrad calls of one v2 step)
   held against its plain version on its inputs (weight gradients also
   against an f64 sum) and timed against it, its bound and the library
   call, with a ``train mode:`` line per call type (the chain modes of
   fused_conv3 and fused_wgrad; conv_stats's conv1 encoder, conv1 decoder
   and conv2, and on the v2 step its γ|β recompute and backward-data convs;
   wgrad's five v2 weight gradients); a profile of one v3 and one v2 step.

7. int8 stages (phases 7 and 8 run after phase 3, before the train
   phases): for the same six stage signatures at 512², batch 2, seeded
   weights and scales, the int8 fused stage on the card against its plain
   version with bf16 inputs (dynamic and static scales), with QTensor
   inputs, with s8 emission, and conv0_1 with the folded head: h1 and y bit
   for bit, outputs to phase 1's bar, emitted s8 equal on at least 99.9% of
   the elements and never more than one step apart; the stages that read a
   seam (conv1_0 and conv2_0 pool, conv1_1 and conv0_1 up) again on a seeded
   seam source read in s8 (dynamic and static scales, a pool seam also as a
   QTensor with s8 out), each read counted; the deep stages' s8
   block through ``torch._int_mm`` against its f64 convs, sum for sum.
8. int8 serving (the second serving path): the BN-calibrated model of phase
   2 calibrated on the 8 seeded tiles, the scales installed, the int8 mode
   on; the tile forward at batch 8 (tiles/s, six int8 kernel stages per
   forward, a profile) and the 2048² scene request, through the same entry
   points; logits, scene tile probabilities and masks against the int8
   all-plain forward and the f32 all-plain forward by phase 2-3's bars, with
   bf16's distances beside them; each int8 stage on the inputs those
   forwards gave it (the model's weights; the scene chunk's batch 32, and
   the tile forward's batch 8) against its plain version, and at batch 8
   timed against it and its bound; then each bf16 input's one-pass
   quantization and each conv launch of the six stages (launches A and B
   of the s8 conv core) alone on the stage's own inputs against its
   per-launch plain version by ``torch.equal``, timed beside its bound and
   ``torch._int_mm`` over the materialized tap operand (``quant:`` and
   ``s8 conv:`` lines, and their sums per forward); a launch that reads a
   seam in s8 also bit for bit against the same launch on the materialized
   s8 seam, timed beside it, the plain seam read and its bound (an ``s8
   seam:`` line each). The main path counts its s8 conv core launches (two
   per stage), quantization passes and the s8 seams it reads (2 up and 2
   pool per forward, where the JAX package's int8 forward reads them); the
   int8 tiles/s and busy ms print beside bf16's of the same run.

9. Bottleneck stages (phases 9 and 10 run after phase 8): the fused
   bottleneck stage on the card against its plain version for UNet_B_SS's
   six fused-stage signatures and one identity-shortcut stage at 512²,
   bf16, batch 2, seeded weights; then with the model's own weights on each
   stage's own inputs at the scene request's batch 32, and each stage timed
   at batch 8 against its plain version and its bound; then each of its
   three conv launches alone as in phase 1 (``conv:`` lines).
10. UNet_B_SS serving (the third serving path): ``build_model("UNet_B_SS",
   3)`` at full width with BN statistics calibrated as in phase 2, the tile
   forward at batch 8 (tiles/s, six bottleneck kernel stages per forward, a
   profile) and the 2048² scene request, through the same entry points;
   logits, scene tile probabilities and masks against the all-plain
   forwards in bf16 and f32 by phase 2-3's bars. Then UNet_R_SS at full
   width: batch-8 tile forwards, six kernel stages of the BasicBlock eval
   kernel per forward, logits to the same bar.
11. The standalone self-SPADE (after phase 6): the fused self-SPADE stage
   against its plain version on the six level-0-2 activation shapes of
   UNet_B_SS (batch 2, seeded), and its backward against autograd of the
   plain composition on the same inputs; UNet_B_SS's trainer at 512², batch
   8, with ``set_fused_spade("pallas")``: 2 warm-up and 3 timed steps
   through ``train_one_epoch`` (one kernel launch per step for each SPADE
   the gate takes: all nine since the tail takes hidden widths up to 64),
   3 steps with the mode off timed beside them; then each of one step's
   calls on its own inputs against plain, timed against plain and its
   bound. The mode is
   restored after. The SPADE tail alone at SSUNet's hidden widths
   (WIDE_TAILS: 512², batch 8, seeded) against its plain version.

12. SSUNet (after phase 10): ``build_model("SSUNet", 3)`` at full width
   (filters 32-512) with BN statistics calibrated as in phase 2 and the
   head's bias centred on the same batch (so no class's mask is
   near-constant), through the same functions as the flagship: phase 1's
   stage checks (its eight fused VGG stage signatures, no shortcut, conv
   biases folded into the BN offsets, 32-256 planes, hidden 8-64, at batch
   2 with seeded weights, kernel 7's h1 and y bit for bit too; then with
   the model's weights on each stage's own inputs at batch 32, timed at
   batch 8, each conv launch alone), phases 2-3's bf16 main path (8
   kernel-1 stages per forward) and comparisons, phase 8's int8 serving
   (the model's own 17 ranges; 8 kernel-7 stages and conv4_0's deep s8
   block, without its residual, per forward; every quantization counted
   and checked; 3 up and 3 pool s8 seams per forward, conv3_1's up seam
   materialized as its producer conv4_0 is deep) and phase 11's trainer
   with ``set_fused_spade("pallas")`` (8 kernel-9 launches per step).
13. The training entry point (after phase 11): ``run_experiment`` on
   configs/config_v1.json's opt_config with its paths in a temporary
   directory (the flagship at 512², batch 8, Adam, bf16) over 16 synthetic
   scenes for 2 epochs, train kernel launches per step against PER_STEP,
   ``log.csv`` and the flat model card (no PyYAML), a resume for a third
   epoch, ``model.pth`` reloaded into a fresh model with a tile forward
   equal bit for bit to the saved model's; then one epoch on each of two
   PNG trees of 16 / 4 / 4 images at 512² written by ``data/png.py`` (the
   same pixels, every row Sub, as ``cv2.imwrite`` writes at its defaults,
   or Paeth: the decoder's two paths), with ``train_transform`` on and
   each tree's decode time per item (``png decode:``); seconds per epoch
   split into loader wait and steps; then ``python -m
   ssunet_gan_tpu_torch.cli.train`` in a process of its own for one epoch
   on the Sub tree.
14. Whole-scene inference through its entry point (after phase 13): the
   flagship of config_v1.json (full width, BN statistics calibrated, head
   centred) saved by the port as a flat card and ``model.pth``, and again
   as a card with ``"int8": true`` and the ``int8_scales.json`` of
   ``calibrate_int8``; a seeded 5000² PNG scene (an Inria scene's size:
   256 tiles of 512² at patch 1024, overlap 0.5, 8 chunks of 32) with its
   labels in the three label colours, and a 2048² scene. The loaded model
   equals the saved one bit for bit; the tile server's first chunk equals
   ``resize_linear`` of ``extract_patches`` bit for bit; the masks of
   ``segmentation_inference`` (ground truth on) and of
   ``pipelined_scene_forward`` + ``merge_patches_device`` are equal bit
   for bit, each route launching exactly 48 kernel-1 stages and reading 16
   up and 16 pool seams; the ground-truth masks equal the same branch on
   the CPU; the int8 card runs the 2048² scene with exactly 12 kernel-7
   stages, phase 8's quantizations and 4 up and 4 pool s8 seams (2 and 2
   per forward), its masks equal to the
   int8 mode set in process; ``python -m
   ssunet_gan_tpu_torch.cli.val_patch`` in a process of its own writes the
   six overlay JPEGs, one byte-identical to ``save_masking_RE`` in
   process. A ``scene:`` line gives the scene's seconds: PNG read, tile
   preparation, H2D / forward / merge (CUDA events), D2H, the ground
   truth, the overlays' blend and JPEG encoding, the unpipelined and
   pipelined totals, tiles/s and the CLI's wall time.
15. The adversarial fine-tune through its entry points (last): the
   flagship of config_v1.json at full width (BN statistics calibrated as in
   phase 2) saved by the port as the supervised ``generator_name`` (flat
   card and ``model.pth``), a ``Generator`` warm-started from it (every
   tensor equal) and the SRGAN discriminator at the trainer's width (64
   channels, 8 blocks, fc 1024); step 1 on STEP1_BATCHES seeded batches
   against the same GAN step on the plain versions (bf16) and on the module
   composition (f32) by phase 6's pooled bars: the perceptual and D losses,
   every G and D gradient after the ±0.8 clip, D's running statistics after
   their three updates, G's after its train forward; G's validation loss
   before and after two train forwards through the kernels and through the
   f32 composition (printed); the joint formulation against the alternating
   one from the same weights (updates and both networks' running
   statistics within the plain-bf16 distance); GAN_WARM + GAN_STEPS steps of each at 512², batch
   8, bf16, Adam 2e-5 (``gan step:`` lines beside phase 6's ms/step;
   PER_STEP's v3 launches per step; finite metrics; D's statistics moved);
   a profile of one joint step split into G's train kernels, D's part (the
   step less the same step with a one-layer D) and the rest (``gan
   profile:``); ``run_gan_experiment`` for 2
   epochs of 16 synthetic scenes with launches per step, ``log.csv``, both
   state directories, a resume for a third epoch, the best ``model.pth``
   into a fresh ``Generator`` with a bit-equal tile forward, its f32
   evaluations on the f32 route of kernel 1 (launches counted); then
   ``python -m
   ssunet_gan_tpu_torch.cli.train_seg_gan`` in a process of its own for one
   epoch on a 16 / 4 / 4 Sub-row PNG tree, warm-started from its own
   supervised directory.
16. The data-parallel paths (last): one process group of world size 1 over
   NCCL from a ``file://`` store (the machine has one card), ``make_mesh()``;
   ``make_train_step(mesh=)`` (the fused train stages, v3 backward) for
   DP_STEPS steps on phase 6's weights and batches (512², batch 8, bf16),
   one joint ``make_gan_train_step(mesh=)`` step on phase 15's G and D, and
   ``segmentation_inference(mesh=)`` on phase 14's 5000² scene, each
   against the same run without ``mesh=`` bit for bit (metrics, every
   parameter, gradient and BatchNorm statistic; the tile probabilities and
   masks), the library's deterministic algorithms on for both runs; the
   train kernels' launches per step equal to PER_STEP (kernels 2, 3, 5 and
   6 as on phase 6's path), 6 kernel-1 stages per scene chunk; then a
   ``dp:`` line: ms/step with and without ``mesh=`` timed in turns from
   ``settle()``, and the all-reduces and bytes of one step. The group is
   destroyed after. Last, the multi-card entry path at one card:
   ``torchrun --standalone --nproc-per-node 1 -m
   ssunet_gan_tpu_torch.cli.train`` (``main`` starts its NCCL group through
   ``parallel.initialize_multihost`` from ``torchrun``'s environment) for
   one epoch on a 16 / 4 / 4 Sub-row PNG tree.

Each path's profile also gives a ``tail:`` line: the shared SPADE tail
kernel's time and launches per forward or step beside its bound; the
flagship and UNet_B_SS forwards and the flagship train step a ``conv
profile:`` line: the eval conv core's time and launches; the int8 forward
an ``s8 conv profile:`` and a ``quant profile:`` line.

Each phase prints its wall time. Prints a ``kernels`` JSON line
(launches on the main paths — phases 2 and 3 for the eval kernel, phase 8
for the int8 eval kernel, phase 6 for the train kernels, where wgrad, v2's
alone, has none, phase 10 for the bottleneck kernel, phase 11's trainer
for the self-SPADE kernel; with SSUNet's (phase 12: kernels 1, 7 and 9),
the entry point's (phase 13: kernels 2, 3, 5 and 6), the scene entry
point's (phase 14: kernels 1 and 7), the GAN's (phase 15: kernels 2,
3, 5 and 6, and kernel 1's stages in its evaluations, none) and the
data-parallel paths' (phase 16, ``dp``: kernels 1, 2, 3, 5 and 6) added, and each
row's ``launches_by_path`` — error, time, plain time, bound, library
time), and ends with ``{"ok": true, "device": {...}}``. Every check that
fails is printed and the run exits non-zero
after the last phase. Needs no network; imports no JAX.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import os
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
BATCH = 8
HW = 512
# One stage, kernel vs plain (bf16): both round every intermediate to bf16 and differ
# only in f32 summation order, so rare 1-ulp flips propagate. An output must
# agree within REL_TOL of its largest magnitude (plus ABS_TOL, far below
# it), and its relative L2 error must stay under L2_TOL. A bf16 ulp is 0.4-
# 0.8% of a value, so one flipped output is within REL_TOL; a wrong kernel
# is off by the order of the values themselves.
REL_TOL, ABS_TOL, L2_TOL = 2e-2, 1e-3, 1e-2
# Full forwards are held against the f32 all-plain forward (see the
# comparisons in main): the kernel's bf16 output may be at most NOISE_RATIO
# times as far from it as the plain bf16 output, and its masks may agree
# with the f32 masks on at most MASK_SLACK fewer pixels than the plain
# version's do; kernel and plain must be closer to each other than the
# plain version is to f32; and kernel and plain masks agree on at least
# MASK_AGREEMENT of the pixels (a kernel that keeps only the logits' sign
# agrees on about half).
NOISE_RATIO = 1.1
# An f32 forward on the card (its fused stages on the f32 route of kernel
# 1, the rest the module composition, TF32 off) against the same forward
# on the CPU: the same f32 arithmetic in another summation order, relative
# L2 of the logits. A last-bit difference can move a max-pool's winner,
# which the unpool carries to another pixel (measured on the H100 at 512²,
# all composition: 1.47e-3); bf16 forwards are ~0.1 apart.
F32_CARD_TOL = 1e-2
# The f32 route of kernel 1 per stage against its plain version (f32, TF32
# off): the same f32 products summed in another order; max abs error over
# max |plain| and relative L2.
F32_STAGE_TOL = 1e-4
MASK_SLACK = 0.002
MASK_AGREEMENT = 0.95
# a mask check has power only where the masks are not near-constant
MASK_SHARE = (0.01, 0.99)
# H100 SXM peaks (NVIDIA data sheet): bf16 dense tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_S8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # tensor cores, TF32 dense
PEAK_BYTES = 3.35e12
# An emitted s8 stage output against the plain version's: equal on at least
# S8_EQUAL of the elements, never more than one step apart (a 1-ulp flip of
# the bf16 output next to a rounding boundary moves one step).
S8_EQUAL = 0.999
# Train kernels against their plain versions (phase 4): outputs as REL_TOL /
# L2_TOL above (both sides round at the same places); the per-channel sums
# of the rounded outputs within SUMS_TOL of the largest sum (plus SUMS_TOL;
# a 1-ulp output flip moves a sum of 5e5 terms by ~1e-6 of it); f32 weight
# gradients within WGRAD_L2_TOL relative L2 (the same bf16 products summed
# in another order).
SUMS_TOL, WGRAD_L2_TOL = 1e-3, 1e-3
# Gradients (phases 5 and 6) are held to the forwards' bar as whole tensors:
# each input gradient, each batch statistic, the loss, and all parameter
# gradients as one vector. One parameter's gradient alone may be a sum that
# cancels (a bias gradient sums a cotangent over ~5e5 pixels), where bf16
# leaves noise of the order of the value in both paths (measured on the
# H100: kernel-plain 2.64 × plain-f32 for a 3-element bias gradient 1.4%
# from f32 in plain bf16); it must stay within GRAD_KP × plain-f32 of the
# plain run. A zeroed gradient is 1 from plain, a sign-flipped one 2, so the
# bar tells them apart wherever plain-f32 < 1 / GRAD_KP; where the bf16
# plain run is further from f32 than that (deep stages of the whole-model
# step, where a rounding flip moves a max-pool winner) it cannot, and the
# run says how many such gradients there were.
GRAD_KP = 3.0
# Step 1 of the whole-model trainer (phase 6) on STEP1_BATCHES seeded
# batches (seeds 1.. of SyntheticDataset), each distance pooled over them
# (sums of squares added before the ratio). One batch's kernel-f32 against
# plain-f32 is a draw between two correct bf16 paths: on the H100 the
# one-batch bars failed 3 of 8 batches with correct kernels
# (tools/torch_step1_bars.py), the pooled ones none. The bars: the loss
# kernel-plain <= plain-f32; each parameter gradient kernel-plain <=
# GRAD_KP x plain-f32; all of them as one vector strict (NOISE_RATIO); and
# each gradient of at least STEP1_SCALE_MIN elements, the scale bar
# |<k-p, p>| / ||p||² <= STEP1_SCALE_KP x plain-f32: the part of the
# kernel's difference along the gradient itself, which a scaled or
# partly dropped gradient moves and the bf16 noise does little (measured
# with correct kernels: at most 0.40 x plain-f32 over 4 batches; a conv1
# weight gradient scaled by 1.05 near the loss, 1.09 x).
STEP1_BATCHES = 4
STEP1_SCALE_KP = 0.8
STEP1_SCALE_MIN = 64
TRAIN_BATCH, TRAIN_WARM, TRAIN_STEPS = 8, 2, 5
V2_STEPS = 3  # the v2 backward's steps timed beside the main path (a record)
# UNet_B_SS's trainer with the fused self-SPADE (phase 11): warm-up and timed
# steps, and the steps with the mode off timed beside them
SPADE_WARM, SPADE_STEPS, SPADE_OFF_STEPS = 2, 3, 3
# the tail alone at SSUNet's wide hidden widths (phase 11): (planes, hidden)
WIDE_TAILS = ((128, 32), (128, 64), (256, 32), (256, 64))
# phase 4's v3 pass also holds every train kernel call at these
# signatures, SSUNet's hidden widths, against its plain version
WIDE_HIDDEN_SIGS = [("hidden32", (64,), 128, 3, 32, 0, 1),
                    ("hidden64", (128,), 256, 3, 64, 0, 2)]
# the train kernels' wrappers: ops/stage_kernel_train.py (forward, v2
# backward) and ops/train_bwd.py (v3 backward)
TRAIN_KERNELS = ("conv_stats", "train_tail", "wgrad", "fused_conv3", "fused_wgrad")
# launches per flagship train step: six fused stages; forward conv1, conv2
# (conv_stats) and the tail. v3 backward: κ1, κ3-κ6 for each stage and κ7
# for all but conv0_0 (the input image needs no gradient), five weight
# gradients each. v2 backward: the γ|β recompute and five backward-data
# convs (conv_stats, none to the input image), five weight gradients.
PER_STEP = {
    "v3": {"conv_stats": 12, "train_tail": 6, "wgrad": 0, "fused_conv3": 6 * 6 - 1,
           "fused_wgrad": 6 * 5},
    "v2": {"conv_stats": 12 + 6 * 6 - 1, "train_tail": 6, "wgrad": 6 * 5, "fused_conv3": 0,
           "fused_wgrad": 0},
}
# the v2 backward's calls per stage, in its order (ops/stage_kernel_train.py
# _train_bwd): the weight gradients, and the backward-data convs after the
# γ|β recompute (none to the input image at conv0_0)
WGRAD_V2 = ("γ|β", "mlp", "x2map", "conv2", "conv1")
BWD_DATA_V2 = ("to actv", "to seg", "to y", "to h1", "to input")


def kernel_module(name):
    """The module of a train kernel's wrapper."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_train, train_bwd

    return train_bwd if name in train_bwd.launches else stage_kernel_train


def reset_launches() -> None:
    for name in TRAIN_KERNELS:
        kernel_module(name).launches[name] = 0


def read_launches() -> dict:
    return {name: kernel_module(name).launches[name] for name in TRAIN_KERNELS}


def phase_done(what: str, t0: float) -> float:
    """Print a phase's wall time; returns the clock for the next phase."""
    t = time.perf_counter()
    print(f"{what}: wall {t - t0:.1f} s")
    return t


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def close(got: torch.Tensor, want: torch.Tensor):
    """(max abs err, max |want|, relative L2 err, within tolerance)."""
    diff = got.float() - want.float()
    err = diff.abs().max().item()
    scale = want.float().abs().max().item()
    l2 = (diff.norm() / want.float().norm().clamp_min(1e-30)).item()
    ok = err <= REL_TOL * scale + ABS_TOL and l2 <= L2_TOL
    return err, scale, l2, ok and bool(torch.isfinite(got.float()).all())


def settle() -> None:
    """Before a timed region: collect Python garbage now and let the card
    drain. A full collection that falls inside a timed loop stalls the host
    (measured: one forward's enqueue 387 ms instead of ~50, after the
    profiler's event objects of earlier phases became garbage)."""
    gc.collect()
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stage_signatures(f, num_classes, input_channels):
    """(name, part channels, planes, labels, hidden, head classes, level)
    of the flagship's six fused stages."""
    nh = lambda c: int(max(c / 16, 4))
    return [
        ("conv0_0", (input_channels,), f[0], num_classes, nh(f[0]), 0, 0),
        ("conv1_0", (f[0],), f[1], num_classes, nh(f[1]), 0, 1),
        ("conv2_0", (f[1],), f[2], num_classes, nh(f[2]), 0, 2),
        ("conv2_1", (f[2], f[2]), f[2], num_classes, nh(f[2]), 0, 2),
        ("conv1_1", (f[1], f[2]), f[1], num_classes, nh(f[1]), 0, 1),
        ("conv0_1", (f[0], f[1]), f[0], num_classes, nh(f[0]), num_classes, 0),
    ]


def stage_bound_ms(parts, planes, labels, hidden, ncls, weight_bytes, shortcut=True, shape=None):
    """Least time for one stage call: the larger of its bytes (inputs and
    weights read once, output written once) over HBM bandwidth and its
    operations over the bf16 tensor-core peak (a VGG stage,
    ``shortcut=False``, has no 1×1 shortcut). ``shape``: the output's
    N×H×W where the parts hold a seam (default the first part's)."""
    n, h, w = shape or parts[0].shape[:3]
    cin = sum(p.shape[-1] for p in parts)
    macs = (9 * cin * planes + 9 * planes * planes + (cin * planes if shortcut else 0)
            + 9 * planes * labels + 9 * labels * hidden + 9 * hidden * 2 * planes
            + planes * ncls)
    flops = 2.0 * macs * n * h * w
    nbytes = (sum(p.numel() * p.element_size() for p in parts) + weight_bytes
              + n * h * w * (ncls or planes) * 2)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def module_stage(parts, block, spade, final=None, name=None, out_key=None, up=None,
                 down=None):
    """One stage as the plain module composition (block, SPADE, final), its
    seams materialized as training and f32 forwards take them."""
    from ssunet_gan_tpu_torch.models import ssunet

    if up or down:
        parts = ssunet._seams(ssunet.as_parts(parts), up, down, False, False, None)[0]
    y = block(parts)
    y = spade(y, y)
    return y if final is None else final(y)


# The seams each model's forward hands its kernel stages ({stage: kind}): a
# pool seam reads the stage's one part pooled 2x2 on load, an up seam its
# second part interpolated along H on load (csrc/eval_conv.cuh read modes 2
# and 1). UNet_R_SS reads those of conv1_0, conv2_0, conv2_2, conv1_3 and
# conv0_4 (RSS_SEAMS_PER: up, pool per forward).
FLAGSHIP_SEAMS = {"conv1_0": "pool", "conv2_0": "pool", "conv1_1": "up", "conv0_1": "up"}
SSUNET_SEAMS = {"conv1_0": "pool", "conv2_0": "pool", "conv3_0": "pool", "conv3_1": "up",
                "conv2_2": "up", "conv1_3": "up", "conv0_4": "up"}
BNECK_SEAMS = {"conv2_2": "up", "conv1_3": "up", "conv0_4": "up"}
RSS_SEAMS_PER = (3, 2)
# The seams the int8 forwards read in kernel 7, in s8 (csrc/int8_conv.cuh read
# modes 1 and 2): where the JAX package's int8 forward reads them, from a
# fused stage's output only, so SSUNet's conv3_1 (its producer conv4_0 is
# deep) takes its up seam materialized.
FLAGSHIP_INT8_SEAMS = FLAGSHIP_SEAMS
SSUNET_INT8_SEAMS = {k: v for k, v in SSUNET_SEAMS.items() if k != "conv3_1"}


def seams_per(seams) -> tuple:
    """(up, pool) seams a forward reads in its kernel stages."""
    kinds = list(seams.values())
    return kinds.count("up"), kinds.count("pool")


def seam_flags(kind):
    """The stage keywords (up, down) of a seam kind (None: no seam)."""
    return ((False, True), None) if kind == "up" else (None, (True,)) if kind == "pool" \
        else (None, None)


def seam_kind(up, down):
    return "up" if any(up or ()) else "pool" if any(down or ()) else None


def seam_reads():
    """The seam counts of the eval conv core's stage wrappers (up, pool)."""
    from ssunet_gan_tpu_torch.ops import stage_kernel

    return stage_kernel.up_reads, stage_kernel.pool_reads


def s8_seam_reads():
    """The s8 seam counts of kernel 7's stage wrapper (up, pool)."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8

    return q8.up_reads, q8.pool_reads


@contextlib.contextmanager
def no_seam_reads(what, check):
    """The int8 and train paths read no bf16 seam (kernels 1 and 8): their
    counts do not move while active."""
    before = seam_reads()
    yield
    moved = [a - b for a, b in zip(seam_reads(), before)]
    check(moved == [0, 0], f"{what}: read {moved[0]} up and {moved[1]} pool seams in a kernel, "
          f"expected none")


@contextlib.contextmanager
def patched(module, name, fn):
    """``module.name`` set to ``fn`` while active."""
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def fused_stages_off():
    """The model's BasicBlock and VGG stages as the module composition while
    active (``set_fused_stage(False)``): the f32 all-plain forwards, which
    would otherwise take the f32 route of kernel 1."""
    from ssunet_gan_tpu_torch.ops import stage_kernel

    stage_kernel.set_fused_stage(False)
    try:
        yield
    finally:
        stage_kernel.set_fused_stage(None)


def random_bn_stats(module, gen) -> None:
    from ssunet_gan_tpu_torch.ops.norm import BatchNorm

    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.3)


def spade_stages_as(fn):
    """Route the model's stages (models/ssunet.py ``spade_stage``) to ``fn``
    while active."""
    from ssunet_gan_tpu_torch.models import ssunet

    return patched(ssunet, "spade_stage", fn)


def calibrate_batchnorm(model, x) -> None:
    """Set every BatchNorm's running statistics to the per-channel mean and
    variance of its input on ``x``, in one eval pass through the model's
    module path (the fused stages unfused, so each BatchNorm sees its
    input)."""
    from ssunet_gan_tpu_torch.ops.norm import BatchNorm

    def hook(m, args):
        t = args[0].float()
        m.running_mean.copy_(t.mean((0, 1, 2)))
        m.running_var.copy_(t.var((0, 1, 2)))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm)]
    try:
        with spade_stages_as(module_stage), torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()


def center_head(model, x) -> None:
    """Shift the final 1x1 conv's bias so that each class's logit has
    median 0 over ``x`` (the module path, as ``calibrate_batchnorm``
    runs it): with random weights a head of ``Conv2d``'s default init, as
    SSUNet's, leaves a class's mask near-constant, and the mask bars have
    no power there."""
    with spade_stages_as(module_stage), torch.no_grad():
        logits = model(x)
        model.final.bias.sub_(logits.reshape(-1, logits.shape[-1]).float().median(0).values)


def profile_kernels(fn, n: int):
    """(device busy ms, wall ms under the profiler, [(ms, count, name)]) per
    call of ``fn``, over ``n`` calls: kernel events only (an op's range on
    the device timeline, a user annotation named after the aten op, repeats
    its kernels' time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = sorted(((e.self_device_time_total / 1e3 / n, e.count // n, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("aten::")
                   and e.self_device_time_total > 0),
                  reverse=True)
    return sum(r[0] for r in rows), wall_ms, rows


def tail_calls(sigs, batch, out_bytes=2, saves=False):
    """The SPADE tail's calls on a path, from the fused stages' signatures:
    (N, H, W, planes, labels, hidden, head classes, bytes per output value,
    saves)."""
    return [(batch, HW >> lv, HW >> lv, planes, lab, nh, ncls, out_bytes, saves)
            for _, _, planes, lab, nh, ncls, lv in sigs]


def tail_line(path, per, rows, calls) -> None:
    """A ``tail:`` line: the SPADE tail kernel's device time and launches
    from a profile's rows (per forward or step), beside its bound: y read
    once, the output (logits, or s8) and the saves written once, over HBM
    bandwidth, or its multiply-adds at the bf16 tensor-core peak."""
    flops = nbytes = 0.0
    for n, h, w, c, lab, nh, ncls, ob, saves in calls:
        px = n * h * w
        flops += 2.0 * px * (spade_macs(c, lab, nh) + c * ncls)
        nbytes += px * (2 * c + (2 * ncls if ncls else ob * c) + (2 * (lab + nh) if saves else 0))
    bound, kind = bound_of(flops, nbytes)
    tail = [r for r in rows if "spade_tail" in r[2]]
    print("tail:", json.dumps(dict(path=path, per=per, ms=sum(r[0] for r in tail),
                                   launches=sum(r[1] for r in tail), bound_ms=bound,
                                   bound_by=kind)))


def hgmma_counts(lib: str, core: str = "eval_conv_core", op: str = "HGMMA") -> dict:
    """wgmma instructions in SASS (``op``: HGMMA for bf16, IGMMA for s8) per
    instantiation of a conv core (the eval conv core, or ``s8_conv_core``)
    in a built library, from ``cuobjdump -sass`` beside nvcc; None when the
    toolkit has no cuobjdump."""
    from ssunet_gan_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    counts, fn = {}, None
    for line in subprocess.run([tool, "-sass", lib], capture_output=True, text=True).stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if core in fn:
                counts[fn] = 0
        elif fn in counts and op in line:
            counts[fn] += 1
    return counts


def ptxas_spills(log: str, core: str) -> dict:
    """Bytes of spill stores and loads per instantiation of a kernel, from
    nvcc's ``-Xptxas -v`` output (each "Compiling entry function" line comes
    before that kernel's stack and spill line)."""
    spills, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if core in line else None
        elif fn is not None and "spill stores" in line:
            words = line.replace(",", "").split()
            spills[fn] = (int(words[words.index("spill") - 2]), int(words[-4]))
            fn = None
    return spills


def conv_profile_line(path, per, rows, cores=("eval_conv_core",), what="conv profile:") -> None:
    """A ``conv profile:`` line: the device time and launches of the kernels
    named ``cores`` from a profile's rows (per forward or step); by default
    the eval conv core's."""
    conv = [r for r in rows if any(c in r[2] for c in cores)]
    print(what, json.dumps(dict(path=path, per=per, ms=sum(r[0] for r in conv),
                                launches=sum(r[1] for r in conv))))


def library_conv(sources, conv):
    """The launch's convs as ``F.conv2d`` calls in bf16, channels-last: one
    over the main segments' sources concatenated (outside the timed region)
    with the bias, one over the shortcut's, added, then ReLU. The library
    yardstick, timed only and never called by the port."""
    import torch.nn.functional as F

    main = conv["main"]

    def operands(xs, ws):
        x = torch.cat(xs, -1).permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        w = torch.cat(ws, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        return x, w, w.shape[-1] // 2

    x0, w0, p0 = operands(sources[:main], conv["oihw"][:main])
    short = operands(sources[main:], conv["oihw"][main:]) if main < len(sources) else None
    bias = None if conv["bias"] is None else conv["bias"].to(torch.bfloat16)

    def run():
        y = F.conv2d(x0, w0, bias, padding=p0)
        if short is not None:
            y += F.conv2d(short[0], short[1], padding=short[2])
        return torch.relu_(y)
    return run


def conv_launch_lines(path, launches, check):
    """Each conv launch of a path's stages alone on its own inputs: the eval
    conv core (``ops/stage_kernel.py`` ``eval_conv``) against its per-launch
    plain version to phase 1's bar, timed beside its bound (multiply-adds at
    the bf16 peak, or each input as the launch reads it and the weight read
    and the output written once over HBM bandwidth) and the library call.
    ``launches``: (stage, launch, sources, packed conv, read modes or
    None). A launch that reads a seam is also held bit for bit against the
    same launch on its materialized sources and timed beside it and beside
    the plain seam (``materialize_seams``). Prints a ``conv:`` line each and
    their sum (per forward; the seam launches' own sums beside it); returns
    the largest max abs error."""
    from ssunet_gan_tpu_torch.ops import stage_kernel

    total = dict(ms=0.0, bound_ms=0.0, library_ms=0.0, launches=0)
    seam_total = dict(ms=0.0, bound_ms=0.0, materialized_ms=0.0, seam_plain_ms=0.0, launches=0)
    kinds, worst = set(), 0.0
    for stage, name, sources, conv, modes in launches:
        modes = tuple(modes or (0,) * len(sources))
        flags = (tuple(m == 1 for m in modes), tuple(m == 2 for m in modes))
        mat = stage_kernel.materialize_seams(sources, *flags)
        got = stage_kernel.eval_conv(sources, conv, modes)
        want = stage_kernel.eval_conv_reference(mat, conv["oihw"], conv["bias"], conv["main"])
        err, scale, l2, ok = close(got, want)
        check(ok, f"{path}: {stage} {name}: the conv core disagrees with its plain version "
              f"(err {err}, max {scale}, l2 {l2})")
        worst = max(worst, err)
        n, h, w = mat[0].shape[:3]
        kk = sum(c * k * k for c, k in conv["segs"])
        flops = 2.0 * n * h * w * conv["cout"] * kk
        nbytes = sum(s.numel() * 2 for s in sources) + 2 * conv["cout"] * (kk + n * h * w)
        bound, kind = bound_of(flops, nbytes)
        kinds.add(kind)
        ms = cuda_ms(lambda: stage_kernel.eval_conv(sources, conv, modes), 20)
        lib_ms = cuda_ms(library_conv(mat, conv), 20)
        for k, v in (("ms", ms), ("bound_ms", bound), ("library_ms", lib_ms), ("launches", 1)):
            total[k] += v
        line = dict(path=path, stage=stage, launch=name, shape=[n, h, w],
                    segments=[list(s) for s in conv["segs"]], cout=conv["cout"], nt=conv["nt"],
                    max_abs_err=err, rel_l2=l2, ms=ms, bound_ms=bound, bound_by=kind,
                    library_ms=lib_ms)
        if any(modes):
            same = torch.equal(got, stage_kernel.eval_conv(mat, conv))
            check(same, f"{path}: {stage} {name}: the launch reading its seam (modes {modes}) "
                  f"differs from the same launch on the materialized sources")
            mat_ms = cuda_ms(lambda: stage_kernel.eval_conv(mat, conv), 20)
            seam_ms = cuda_ms(lambda: stage_kernel.materialize_seams(sources, *flags), 10)
            line.update(modes=list(modes), source_shapes=[list(s.shape) for s in sources],
                        bit_equal_materialized=same, materialized_ms=mat_ms, seam_plain_ms=seam_ms)
            for k, v in (("ms", ms), ("bound_ms", bound), ("materialized_ms", mat_ms),
                         ("seam_plain_ms", seam_ms), ("launches", 1)):
                seam_total[k] += v
        print("conv:", json.dumps(line))
    print("conv:", json.dumps(dict(path=path, per="forward", **total,
                                   bound_by="operations" if "operations" in kinds else "bytes",
                                   seam_launches=seam_total)))
    return worst


# ---------------------------------------------------------------------------
# The eval stages and bf16 serving (phases 1-3, and SSUNet's in phase 12)
# ---------------------------------------------------------------------------


def plain_stage(parts, bp, sp, head=None, packed=None, up=None, down=None):
    """The fused eval stage's plain version, with its wrapper's signature."""
    from ssunet_gan_tpu_torch.ops import stage_kernel

    return stage_kernel.fused_stage_reference(stage_kernel.materialize_seams(parts, up, down),
                                              bp, sp, head)


def materialized_stage(parts, bp, sp, head=None, packed=None, up=None, down=None):
    """Kernel 1 on the stage's seams materialized (W then H, and the pool)
    in plain PyTorch: what the stage computes when it does not read them."""
    from ssunet_gan_tpu_torch.ops import stage_kernel

    return stage_kernel.fused_eval_stage(stage_kernel.materialize_seams(parts, up, down), bp, sp,
                                         head, packed)


def seam_parts(parts, kind, gen, dev):
    """A seeded stage's parts with its seam's source in place of the part
    it stands for: a pool seam's full-resolution source, an up seam's
    half-height tensor."""
    if kind is None:
        return parts
    i = 0 if kind == "pool" else 1
    n, h, w, c = parts[i].shape
    shape = (n, 2 * h, 2 * w, c) if kind == "pool" else (n, h // 2, w, c)
    src = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
    return parts[:i] + (src,) + parts[i + 1:]


def seeded_stage_phase(dev, sigs, block_cls, gen, phase, check, int8=False, seams=None):
    """Each fused stage signature at 512², batch 2, seeded weights (a
    ``block_cls`` conv block with random BN statistics, the signature's
    SPADE, the head where it has one) and inputs: kernel 1 against its
    plain version to the stage bar; a stage of ``seams`` ({stage: kind})
    reads its seam from a seeded source and is also held bit for bit
    against kernel 1 on the materialized seam; with ``int8`` also kernel 7
    (dynamic scales, on the materialized parts: h1 and y bit for bit).
    Returns the largest max abs errors (kernel 1, kernel 7)."""
    from ssunet_gan_tpu_torch.ops import stage_kernel
    from ssunet_gan_tpu_torch.ops.conv import Conv2d
    from ssunet_gan_tpu_torch.ops.spade import SPADE

    worst = [0.0, 0.0]
    for name, chans, planes, lab, nh, head_cls, level in sigs:
        block = block_cls(sum(chans), planes, generator=gen)
        random_bn_stats(block, gen)
        spade = SPADE("spadebatch3x3", planes, lab, float(nh), generator=gen)
        head = None
        if head_cls:
            final = Conv2d(planes, head_cls, 1, generator=gen).to(dev)
            head = (final.weight, final.bias)
        block.to(dev).eval()
        spade.to(dev)
        side = HW >> level
        parts = tuple(torch.randn((2, side, side, c), generator=gen).to(dev, torch.bfloat16)
                      for c in chans)
        bp, sp = block.stage_params(), spade.stage_params()
        kind = (seams or {}).get(name)
        up, down = seam_flags(kind)
        src = seam_parts(parts, kind, gen, dev)
        parts = stage_kernel.materialize_seams(src, up, down)
        got = stage_kernel.fused_eval_stage(src, bp, sp, head, up=up, down=down)
        torch.cuda.synchronize()
        want = plain_stage(parts, bp, sp, head)
        err, scale, l2, ok = close(got, want)
        what = f"{phase}: {name} parts={chans} planes={planes} hidden={nh} {side}x{side}"
        if kind is not None:
            same = torch.equal(got, stage_kernel.fused_eval_stage(parts, bp, sp, head))
            print(f"{what} batch 2: {kind} seam read in the kernel, bit-equal to the "
                  f"materialized seam: {same}")
            check(same, f"{what}: kernel 1 reading its {kind} seam differs from kernel 1 on "
                  f"the materialized seam")
        print(f"{what} batch 2 max_abs_err={err:.4g} max_rel_err={err / max(scale, 1e-30):.4g} "
              f"rel_l2={l2:.3g} (max|plain|={scale:.4g})")
        check(ok and got.shape == want.shape,
              f"{what}: kernel 1 disagrees with plain (err {err}, max {scale}, l2 {l2})")
        worst[0] = max(worst[0], err)
        if int8:
            worst[1] = max(worst[1], int8_stage_agrees(f"{what} batch 2 int8 dynamic", parts, bp,
                                                       sp, head, check))
            if kind is not None:
                worst[1] = max(worst[1], int8_stage_agrees(
                    f"{what} batch 2 int8 dynamic, {kind} seam read in s8", src, bp, sp, head,
                    check, up=up, down=down))
        del parts, src, got, want, block, spade
    torch.cuda.empty_cache()
    return tuple(worst)


def f32_oihw(conv):
    """An f32 launch's segment weights as OIHW tensors (from its plain
    version's ``[K][cout]`` weight)."""
    out, r = [], 0
    for c, k in zip(conv["chans"], conv["ks"]):
        out.append(conv["w"][r:r + k * k * c].reshape(k, k, c, -1).permute(3, 2, 0, 1))
        r += k * k * c
    return out


def library_conv_f32(sources, conv, y=None):
    """An f32 launch as ``F.conv2d`` calls in f32 (TF32 off), channels-last:
    one per kernel size over its segments' sources concatenated (outside
    the timed region), the bias, then ReLU or, for the γ|β launch, the
    modulate with ``y``. The library yardstick, timed only and never
    called by the port."""
    import torch.nn.functional as F

    ws = f32_oihw(conv)
    groups = []
    for k in sorted(set(conv["ks"]), reverse=True):
        sel = [i for i, kk in enumerate(conv["ks"]) if kk == k]
        x = torch.cat([sources[i] for i in sel], -1).permute(0, 3, 1, 2)
        w = torch.cat([ws[i] for i in sel], 1).contiguous(memory_format=torch.channels_last)
        groups.append((x, w, k // 2))
    bias = conv["bias"]
    c = conv["cout"] // 2

    def run():
        out = None
        for x, w, pad in groups:
            t = F.conv2d(x, w, bias if out is None else None, padding=pad)
            out = t if out is None else out.add_(t)
        if conv["modulate"]:
            out = out.permute(0, 2, 3, 1)
            return y * (1 + out[..., :c]) + out[..., c:]
        return torch.relu_(out) if conv["relu"] else out
    return run


def plant_non_finite(part, gen):
    """``part`` with +inf, -inf and NaN planted at seeded positions (a few
    of each, apart), for the output-class check."""
    x = part.clone()
    flat = x.view(-1)
    pos = torch.randperm(flat.numel(), generator=gen)[:9].to(x.device)
    vals = torch.tensor([float("inf"), float("-inf"), float("nan")] * 3, device=x.device)
    flat[pos] = vals
    return x


def output_classes(t):
    """Each element's class: 0 finite, 1 NaN, 2 +inf, 3 -inf."""
    return (torch.isnan(t) * 1 + torch.isposinf(t) * 2 + torch.isneginf(t) * 3).to(torch.int8)


def f32_launches_of(parts, pk, conv_fn):
    """The f32 route's launches of a stage run through ``conv_fn`` (the
    card's ``f32_conv``): (launch, sources, packed conv, y) and its output."""
    launches = []

    def traced(sources, conv, y=None):
        name = next(k for k in ("conv1", "conv2", "seg", "act", "gb", "head") if pk[k] is conv)
        launches.append((name, tuple(sources), conv, y))
        return conv_fn(sources, conv, y)

    from ssunet_gan_tpu_torch.ops import stage_kernel

    out = stage_kernel.f32_stage_launches(parts, pk, traced)
    return launches, out


def nan_witness(dev, block_cls, gen, check) -> None:
    """Kernel 1 in bf16 and its f32 route on a 32x32 map with one NaN in
    one channel of one input pixel: NaN exactly where the stage's receptive
    field reaches it (Chebyshev radius 5: conv1, conv2, seg, act and γ|β,
    each 3x3, every weight nonzero), finite elsewhere, as the plain version
    and the JAX package keep NaN through ReLU (``torch.relu``,
    ``jnp.maximum``)."""
    from ssunet_gan_tpu_torch.ops import stage_kernel
    from ssunet_gan_tpu_torch.ops.spade import SPADE

    block = block_cls(64, 128, generator=gen)
    random_bn_stats(block, gen)
    block.to(dev).eval()
    spade = SPADE("spadebatch3x3", 128, 3, 8.0, generator=gen).to(dev)
    x = torch.randn((2, 32, 32, 64), generator=gen)
    b, py, px = 1, 9, 20
    x[b, py, px, 7] = float("nan")
    yy, xx = torch.meshgrid(torch.arange(32), torch.arange(32), indexing="ij")
    want = torch.zeros((2, 32, 32, 1), dtype=torch.bool)
    want[b, ..., 0] = torch.maximum((yy - py).abs(), (xx - px).abs()) <= 5
    for dtype in (torch.bfloat16, torch.float32):
        out = stage_kernel.fused_eval_stage((x.to(dev, dtype),), block.stage_params(),
                                            spade.stage_params()).float().cpu()
        nan, fin = torch.isnan(out), torch.isfinite(out)
        ok = torch.equal(nan, want.expand_as(nan)) and torch.equal(fin, ~nan)
        print(f"phase 2: planted NaN, kernel 1 {dtype}: {int(nan.sum())} NaN outputs, "
              f"{int(want.sum()) * out.shape[-1]} expected (radius 5), the rest finite: {ok}")
        check(ok, f"phase 2: kernel 1 {dtype} does not keep a planted NaN as the plain version "
                  f"does ({int(nan.sum())} NaN outputs)")


def f32_stage_phase(dev, sigs, block_cls, gen, check) -> dict:
    """The f32 route of kernel 1 (``csrc/fused_stage_f32.cu``, 3xTF32 on
    the tensor cores): each fused stage signature at 512² with seeded
    weights (as :func:`seeded_stage_phase`) and f32 inputs, at batch 2
    against the stage's plain version in f32 (TF32 off) to F32_STAGE_TOL;
    on a 64² map with +inf, -inf and NaN planted in its first part, each
    output's class (finite, NaN, +inf, -inf) against the per-launch plain
    versions' (``f32_stage_launches``: exact f32 products, whose classes
    do not depend on the summation order); then timed at BATCH beside the
    plain version (``f32 stage:`` lines and their sum per forward), and
    each of its launches alone at BATCH against its plain version
    (``f32_conv_reference``) to F32_STAGE_TOL, timed beside its two
    bounds (f32 operations on the CUDA cores; three TF32 products per f32
    product on the tensor cores) and the ``F.conv2d`` f32 call of the same
    convs (``f32 conv:`` lines and their sum per forward). Returns the
    ``kernels`` row's numbers: bound_ms is the 3xTF32 bound."""
    from ssunet_gan_tpu_torch.ops import stage_kernel
    from ssunet_gan_tpu_torch.ops.conv import Conv2d
    from ssunet_gan_tpu_torch.ops.spade import SPADE

    worst, tot = 0.0, {"ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    ltot = {"ms": 0.0, "library_ms": 0.0, "bound_f32_ms": 0.0, "bound_tf32_ms": 0.0,
            "launches": 0}
    for name, chans, planes, lab, nh, head_cls, level in sigs:
        block = block_cls(sum(chans), planes, generator=gen)
        random_bn_stats(block, gen)
        spade = SPADE("spadebatch3x3", planes, lab, float(nh), generator=gen)
        head = None
        if head_cls:
            final = Conv2d(planes, head_cls, 1, generator=gen).to(dev)
            head = (final.weight, final.bias)
        block.to(dev).eval()
        spade.to(dev)
        bp, sp = block.stage_params(), spade.stage_params()
        pk = stage_kernel.pack_stage_f32(chans, bp, sp, head)
        side = HW >> level
        what = f"phase 2: f32 stage {name} parts={chans} planes={planes} hidden={nh}"
        parts = tuple(torch.randn((2, side, side, c), generator=gen).to(dev) for c in chans)
        got = stage_kernel.fused_eval_stage(parts, bp, sp, head, pk)
        want = stage_kernel.fused_stage_reference(parts, bp, sp, head)
        diff = got - want
        err, scale = diff.abs().max().item(), want.abs().max().item()
        l2 = (diff.norm() / want.norm().clamp_min(1e-30)).item()
        print(f"{what} {side}x{side} batch 2 max_abs_err={err:.4g} max_rel_err="
              f"{err / max(scale, 1e-30):.4g} rel_l2={l2:.3g} (max|plain|={scale:.4g})")
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape
              and err <= F32_STAGE_TOL * scale and l2 <= F32_STAGE_TOL,
              f"{what}: the f32 route disagrees with plain (err {err}, max {scale}, l2 {l2})")
        worst = max(worst, err)
        del parts, got, want, diff
        # planted inf / -inf / NaN: each output's class as the plain version's
        parts = tuple(torch.randn((2, 64, 64, c), generator=gen).to(dev) for c in chans)
        parts = (plant_non_finite(parts[0], gen),) + parts[1:]
        got = output_classes(stage_kernel.fused_eval_stage(parts, bp, sp, head, pk))
        want = output_classes(stage_kernel.f32_stage_launches(parts, pk))
        counts = [int((want == k).sum()) for k in range(4)]
        same = bool(torch.equal(got, want))
        print(f"{what} 64x64 batch 2, inf / -inf / NaN planted in part 0: output classes "
              f"(finite, NaN, +inf, -inf) of plain {counts}, equal to the kernel's: {same}, "
              f"{int((got != want).sum())} differ")
        check(same and counts[1] > 0, f"{what}: planted non-finite inputs: the kernel's output "
              f"classes differ from plain at {int((got != want).sum())} elements")
        del parts, got, want
        parts = tuple(torch.randn((BATCH, side, side, c), generator=gen).to(dev) for c in chans)
        settle()
        ms = cuda_ms(lambda: stage_kernel.fused_eval_stage(parts, bp, sp, head, pk), 3)
        plain_ms = cuda_ms(lambda: stage_kernel.fused_stage_reference(parts, bp, sp, head), 3)
        cin = sum(chans)
        macs = (9 * cin * planes + 9 * planes * planes + (cin * planes if bp[4] is not None else 0)
                + 9 * planes * lab + 9 * lab * nh + 9 * nh * 2 * planes + planes * head_cls)
        flops = 2.0 * macs * BATCH * side * side
        nbytes = (sum(p.numel() for p in parts) + sum(t.numel() for t in
                  stage_kernel.packed_tensors(pk)) + BATCH * side * side * (head_cls or planes)) * 4
        bound, kind = bound_of(flops, nbytes, PEAK_F32_FLOPS)
        bound3 = bound_of(3 * flops, nbytes, PEAK_TF32_FLOPS)[0]
        print(f"f32 stage: {name} {side}x{side} batch {BATCH}: {ms:.3f} ms, plain {plain_ms:.3f} "
              f"ms, bound {bound:.3f} ms ({kind}, f32 on the CUDA cores), 3xTF32 bound "
              f"{bound3:.3f} ms; {flops / ms / 1e9:.1f} TFLOP/s")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["flops"] += flops
        tot["bytes"] += nbytes
        # each launch alone at BATCH on the inputs the stage gave it
        launches, _ = f32_launches_of(parts, pk, stage_kernel.f32_conv)
        for lname, sources, conv, y in launches:
            lgot = stage_kernel.f32_conv(sources, conv, y)
            lwant = stage_kernel.f32_conv_reference(sources, conv, y)
            lerr, lscale, ll2, _ = close(lgot, lwant)
            ok = (bool(torch.isfinite(lgot).all()) and lerr <= F32_STAGE_TOL * lscale
                  and ll2 <= F32_STAGE_TOL)
            check(ok, f"phase 2: f32 conv {name} {lname}: the launch disagrees with its plain "
                      f"version (err {lerr}, max {lscale}, l2 {ll2})")
            worst = max(worst, lerr)
            del lgot, lwant
            kk = sum(c * k * k for c, k in zip(conv["chans"], conv["ks"]))
            lflops = 2.0 * BATCH * side * side * conv["cout"] * kk
            lbytes = 4 * (sum(s.numel() for s in sources) + conv["w"].numel()
                          + BATCH * side * side * conv["cout"] // (2 if y is not None else 1)
                          + (y.numel() if y is not None else 0))
            b32, bkind = bound_of(lflops, lbytes, PEAK_F32_FLOPS)
            b3 = bound_of(3 * lflops, lbytes, PEAK_TF32_FLOPS)[0]
            lms = cuda_ms(lambda: stage_kernel.f32_conv(sources, conv, y), 10)
            lib_ms = cuda_ms(library_conv_f32(sources, conv, y), 10)
            for k, v in (("ms", lms), ("library_ms", lib_ms), ("bound_f32_ms", b32),
                         ("bound_tf32_ms", b3), ("launches", 1)):
                ltot[k] += v
            print("f32 conv: " + json.dumps(dict(
                stage=name, launch=lname, shape=[BATCH, side, side],
                segments=[[c, k] for c, k in zip(conv["chans"], conv["ks"])],
                cout=conv["cout"], bn=conv["bn"], modulate=conv["modulate"], max_abs_err=lerr,
                rel_l2=ll2, ms=lms, bound_f32_ms=b32, bound_tf32_ms=b3, bound_by=bkind,
                library_ms=lib_ms, tflops=lflops / lms / 1e9)))
        del parts, block, spade, pk, launches
    torch.cuda.empty_cache()
    bound, kind = bound_of(tot["flops"], tot["bytes"], PEAK_F32_FLOPS)
    bound3 = bound_of(3 * tot["flops"], tot["bytes"], PEAK_TF32_FLOPS)[0]
    print(f"f32 stage: per flagship forward (batch {BATCH}, {len(sigs)} stages): "
          f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, bound {bound:.3f} ms ({kind}, "
          f"f32 on the CUDA cores), 3xTF32 bound {bound3:.3f} ms; "
          f"{tot['flops'] / tot['ms'] / 1e9:.1f} TFLOP/s")
    print(f"f32 conv: per flagship forward ({ltot['launches']} launches): {ltot['ms']:.3f} ms, "
          f"F.conv2d f32 {ltot['library_ms']:.3f} ms, bounds f32 {ltot['bound_f32_ms']:.3f} / "
          f"3xTF32 {ltot['bound_tf32_ms']:.3f} ms")
    return {"max_abs_err": worst, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": bound3, "bound_by": "operations", "bound_f32_ms": bound,
            "library_ms": ltot["library_ms"], "conv_ms": ltot["ms"]}


def model_stage_phase(dev, model, sigs, scene_tiles, phase, name, check, seams) -> dict:
    """Each fused stage of ``model`` with the model's weights on its own
    inputs, captured from an all-plain forward over the scene request's
    first chunk, its seams (``seams``: {stage: kind}, which the forward
    must hand exactly these stages) as the kernel reads them: checked at
    that batch (INFER_BATCH) against the plain version, a seam stage also
    bit for bit against kernel 1 on the materialized seam, timed at the
    tile forward's (BATCH) beside the plain version and the bound
    (``stage:`` lines and their sum per forward; a ``seam:`` line per seam
    stage: the stage on the materialized seam, the plain seam and, for an
    up seam, its W-interpolation ``upsample_w``), then each of its conv
    launches alone at BATCH (``conv:`` lines). Returns kernel 1's numbers
    for the ``kernels`` line (without its launches)."""
    from ssunet_gan_tpu_torch.infer.api import INFER_BATCH, _norm_consts
    from ssunet_gan_tpu_torch.models import ssunet
    from ssunet_gan_tpu_torch.ops import stage_kernel
    from ssunet_gan_tpu_torch.ops.resize import upsample_w

    a, b = _norm_consts()
    chunk = torch.from_numpy(scene_tiles[:INFER_BATCH]).to(dev).float() * a.to(dev) + b.to(dev)
    captured = []

    def capture(parts, bp, sp, head=None, packed=None, up=None, down=None):
        captured.append((tuple(p.clone() for p in parts), up, down))
        return plain_stage(parts, bp, sp, head, up=up, down=down)

    with patched(ssunet, "fused_eval_stage", capture), torch.no_grad():
        model(chunk.to(torch.bfloat16))
    del chunk
    got_seams = {s[0]: seam_kind(u, d) for s, (_, u, d) in zip(sigs, captured)
                 if seam_kind(u, d) is not None}
    if ([tuple(p.shape[-1] for p in c) for c, _, _ in captured] != [s[1] for s in sigs]
            or got_seams != seams):
        fail(f"{phase}: {name}'s fused stages are not the expected {len(sigs)} with the seams "
             f"{seams}: {[[tuple(p.shape) for p in c] for c, _, _ in captured]}, seams "
             f"{got_seams}")
    ms_sum = plain_sum = bound_sum = worst = 0.0
    kinds, conv_launches = set(), []  # each stage's conv launches at BATCH (conv: lines)
    for (stage, chans, planes, lab, nh, head_cls, level), (full, up, down) in zip(sigs, captured):
        side = HW >> level
        kind = seam_kind(up, down)
        modes = stage_kernel.seam_modes(len(full), up, down)
        block, spade = getattr(model, stage), getattr(model, "SPADE" + stage[4:])
        head = (model.final.weight, model.final.bias) if head_cls else None
        bp, sp = block.stage_params(), spade.stage_params()
        pk = stage_kernel.pack_stage(chans, bp, sp, head, torch.bfloat16)
        check(pk["shortcut"] == (bp[4] is not None),
              f"{phase}: {stage} packed shortcut {pk['shortcut']}, the block has "
              f"{'one' if bp[4] is not None else 'none'}")
        got = stage_kernel.fused_eval_stage(full, bp, sp, head, pk, up=up, down=down)
        err, scale, l2, ok = close(got, plain_stage(full, bp, sp, head, up=up, down=down))
        print(f"{phase}: {stage} batch {full[0].shape[0]} model weights max_abs_err={err:.4g} "
              f"rel_l2={l2:.3g} (max|plain|={scale:.4g})"
              + (f", {kind} seam read in the kernel" if kind else ""))
        check(ok, f"{phase}: {stage} at batch {full[0].shape[0]}: kernel 1 disagrees with plain "
              f"(err {err}, max {scale}, l2 {l2})")
        if kind is not None:
            check(torch.equal(got, materialized_stage(full, bp, sp, head, pk, up, down)),
                  f"{phase}: {stage} at batch {full[0].shape[0]}: kernel 1 reading its {kind} "
                  f"seam differs from kernel 1 on the materialized seam")
        del got
        worst = max(worst, err)
        parts = tuple(p[:BATCH] for p in full)
        ms = cuda_ms(lambda: stage_kernel.fused_eval_stage(parts, bp, sp, head, pk, up=up,
                                                           down=down), 10)
        plain_ms = cuda_ms(lambda: plain_stage(parts, bp, sp, head, up=up, down=down), 3, warmup=1)
        wbytes = sum(t.numel() * 2 for t in (bp[0], bp[2], bp[4]) if t is not None)
        wbytes += sum(t.numel() * 4 for t in sp)
        bound, bound_kind = stage_bound_ms(parts, planes, lab, nh, head_cls, wbytes,
                                           shortcut=bp[4] is not None,
                                           shape=(BATCH, side, side))
        kinds.add(bound_kind)
        ms_sum, plain_sum, bound_sum = ms_sum + ms, plain_sum + plain_ms, bound_sum + bound
        print("stage:", json.dumps(dict(model=name, stage=stage,
                                        shape=[BATCH, side, side, sum(chans)], planes=planes,
                                        hidden=nh, seam=kind, ms=ms, plain_ms=plain_ms,
                                        bound_ms=bound, bound_by=bound_kind)))
        if kind is not None:
            line = dict(model=name, stage=stage, kind=kind,
                        source=list(parts[modes.index(1 if kind == "up" else 2)].shape),
                        stage_ms=ms,
                        stage_ms_materialized=cuda_ms(
                            lambda: materialized_stage(parts, bp, sp, head, pk, up, down), 10),
                        seam_plain_ms=cuda_ms(
                            lambda: stage_kernel.materialize_seams(parts, up, down), 10))
            if kind == "up":  # the W-interpolation before it, on a raw source of its shape
                raw = parts[1][:, :, ::2].contiguous()
                line["upsample_w_ms"] = cuda_ms(lambda: upsample_w(raw), 10)
            print("seam:", json.dumps(line))
        h1 = stage_kernel.eval_conv(parts, pk["conv1"], modes)
        conv_launches += [(stage, "conv1", parts, pk["conv1"], modes),
                          (stage, "conv2", (h1,) + (parts if pk["shortcut"] else ()), pk["conv2"],
                           ((0,) + modes) if pk["shortcut"] else None)]
    bound_by = "operations" if "operations" in kinds else "bytes"
    print("stage:", json.dumps(dict(model=name, per="forward", ms=ms_sum, plain_ms=plain_sum,
                                    bound_ms=bound_sum, bound_by=bound_by)))
    worst = max(worst, conv_launch_lines(f"kernel 1: {name}", conv_launches, check))
    del captured, conv_launches, parts, full, pk, h1
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": ms_sum, "plain_ms": plain_sum, "bound_ms": bound_sum,
            "bound_by": bound_by}


def bf16_serving_phase(dev, card, model, sigs, x, scene, scene_tiles, config, check, name,
                       phases, seams) -> dict:
    """A model's bf16 main path: kernel-1 and seam counts to 0, the tile
    forward at batch 8 (``len(sigs)`` kernel-1 stages per forward, reading
    the up and pool seams of ``seams``) and the 2048² scene request (two
    chunks), through the entry points; after the counts were read, the
    kernel path and the all-plain path (bf16) against the f32 all-plain
    forward by the forward and mask bars, the kernel path bit for bit
    against the same kernels on materialized seams, and a profile of the
    tile forward. ``phases``: the labels of the tile forward and the scene
    request. Returns the main path's launches and seam reads, tiles/s,
    scene seconds and distances from f32, and the f32 forwards (logits,
    tile probabilities, masks) for the int8 path."""
    from ssunet_gan_tpu_torch.infer.api import (
        _chunked_forward,
        _norm_consts,
        segmentation_inference,
        tile_forward,
    )
    from ssunet_gan_tpu_torch.models import ssunet
    from ssunet_gan_tpu_torch.ops import stage_kernel

    tile_p, scene_p = phases
    per = len(sigs)
    up_per, pool_per = seams_per(seams)
    ncls = model.num_classes
    t_phase = time.perf_counter()
    stage_kernel.launches = stage_kernel.up_reads = stage_kernel.pool_reads = 0
    warm, iters = 2, 5
    for _ in range(warm):  # the entry point's defaults: bf16 on the card
        probs = tile_forward(model, x)
    settle()
    t0 = time.perf_counter()
    for _ in range(iters):
        probs = tile_forward(model, x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tile_launches = stage_kernel.launches
    check(tile_launches == per * (warm + iters),
          f"{tile_p}: {tile_launches} kernel-1 stages in {warm + iters} {name} tile forwards, "
          f"expected {per} each")
    check(seam_reads() == (up_per * (warm + iters), pool_per * (warm + iters)),
          f"{tile_p}: {seam_reads()} up and pool seams read in {warm + iters} {name} tile "
          f"forwards, expected {(up_per, pool_per)} each")
    check(bool(torch.isfinite(probs.float()).all()) and probs.shape == (BATCH, HW, HW, ncls),
          f"{tile_p}: {name} tile forward output is not finite or has the wrong shape")
    tiles_per_s = BATCH * iters / dt
    print(f"{tile_p}: {name} tile forward {tiles_per_s:.2f} tiles/s (512x512 bf16, batch "
          f"{BATCH}, {dt / iters * 1e3:.2f} ms/forward, {per} kernel-1 stages each) on {card}")
    t_phase = phase_done(tile_p, t_phase)

    settle()
    t0 = time.perf_counter()
    masks, _ = segmentation_inference(model, scene, scene_tiles, None, config, False)
    scene_s = time.perf_counter() - t0
    launches = stage_kernel.launches
    reads = seam_reads()
    check(launches - tile_launches == 2 * per,
          f"{scene_p}: the {name} scene request ran {launches - tile_launches} kernel-1 stages, "
          f"expected {2 * per}")
    forwards = warm + iters + 2
    check(reads == (up_per * forwards, pool_per * forwards),
          f"{scene_p}: {reads} up and pool seams read by the {name} main path, expected "
          f"{(up_per, pool_per)} per forward")
    print(f"{scene_p}: {name} main path read {reads[0]} up and {reads[1]} pool seams in its "
          f"kernel stages ({up_per} and {pool_per} per forward)")
    check_masks(masks, scene_p)
    print(f"{scene_p}: {name} scene 2048x2048 -> {len(masks)} masks in {scene_s:.3f} s (36 tiles, "
          f"bf16) on {card}; positive share {[round(float((m > 0).mean()), 4) for m in masks]}")
    t_phase = phase_done(scene_p, t_phase)

    # comparisons, after the counts were read. The bf16 forward is a
    # sensitive function of where it rounds: a 1-ulp change in a stage can
    # move a max-pool's winner, which the unpool then carries to another
    # pixel, so two correct bf16 forwards differ by several percent. The
    # kernel's and the plain version's bf16 outputs are therefore both held
    # against the f32 all-plain forward (tolerances at the top).
    a, b = _norm_consts()
    xn = x.float() * a.to(dev) + b.to(dev)
    with torch.no_grad():
        logits_k = model(xn.to(torch.bfloat16))
    probs_k = _chunked_forward(model, scene_tiles)  # batch 32, padded chunk
    with patched(ssunet, "fused_eval_stage", plain_stage), torch.no_grad():
        logits_p = model(xn.to(torch.bfloat16))
        probs_p = _chunked_forward(model, scene_tiles)
        plain_masks, _ = segmentation_inference(model, scene, scene_tiles, None, config, False)
    before = stage_kernel.launches, stage_kernel.f32_launches
    with fused_stages_off(), torch.no_grad():
        logits_f = model(xn)
        probs_f = _chunked_forward(model, scene_tiles, torch.float32)
        f32_masks, _ = segmentation_inference(model, scene, scene_tiles, None, config, False,
                                              dtype=torch.float32)
    check((stage_kernel.launches, stage_kernel.f32_launches) == before,
          f"{tile_p}: the f32 all-plain {name} forward launched kernel 1")
    e_logits = forward_bar(f"{tile_p}: {name} logits", logits_k, logits_p, logits_f, check)[0]
    e_probs = forward_bar(f"{scene_p}: {name} scene tile probabilities", probs_k, probs_p,
                          probs_f, check)[0]
    agree_kf = mask_bars(f"{scene_p}: {name}", masks, plain_masks, f32_masks, check)[1]
    seams_materialized(f"{tile_p}: {name}", model, xn, scene_tiles, logits_k, probs_k,
                       ssunet, "fused_eval_stage", materialized_stage, check)
    del logits_k, logits_p, probs_k, probs_p, xn
    # where one tile forward's device time goes (torch.profiler, by kernel)
    tile_forward(model, x)  # the f32 comparisons left f32 operands kept; repack once
    n_prof = 3
    busy, wall_ms, rows = profile_kernels(lambda: tile_forward(model, x), n_prof)
    untraced_ms = dt / iters * 1e3
    print(f"profile: per {name} forward (batch {BATCH}, mean of {n_prof}): device busy "
          f"{busy:.3f} ms, {sum(r[1] for r in rows)} kernels; {wall_ms:.3f} ms wall under the "
          f"profiler (idle share {max(0.0, 1 - busy / wall_ms):.3f}), {untraced_ms:.3f} ms "
          f"untraced (idle share {max(0.0, 1 - busy / untraced_ms):.3f})")
    for ms, count, key in rows[:12]:
        print(f"profile: {name} {ms:9.3f} ms {count:4d}x {key[:90]}")
    tail_line(f"kernel 1: {name} bf16 forward", "forward", rows, tail_calls(sigs, BATCH))
    conv_profile_line(f"kernel 1: {name} bf16 forward", "forward", rows)
    torch.cuda.empty_cache()
    phase_done(f"{tile_p} {name} bf16 comparisons and profile", t_phase)
    return dict(launches=launches, seam_reads=reads, tiles_per_s=tiles_per_s, scene_s=scene_s,
                logits=e_logits, probs=e_probs, masks=agree_kf, busy_ms=busy,
                f32=(logits_f, probs_f, f32_masks))


def seams_materialized(what, model, xn, scene_tiles, logits_k, probs_k, module, stage_name,
                       materialized, check, probs=True):
    """The bf16 forward's logits (and scene tile probabilities) with the
    seams read in the kernel stages against the same forward whose kernel
    stages (``module.stage_name``) take their seams materialized in plain
    PyTorch (``materialized``: W then H, and the pool): equal bit for
    bit."""
    from ssunet_gan_tpu_torch.infer.api import _chunked_forward

    with patched(module, stage_name, materialized), torch.no_grad():
        same = torch.equal(logits_k, model(xn.to(torch.bfloat16)))
        if probs:
            same_p = torch.equal(probs_k, _chunked_forward(model, scene_tiles))
    print(f"{what}: seams read in the kernels, bit-equal to materialized seams: logits {same}"
          + (f", scene tile probabilities {same_p}" if probs else ""))
    check(same and (same_p if probs else True),
          f"{what}: the forward reading its seams in the kernels differs from the forward on "
          f"materialized seams")


# ---------------------------------------------------------------------------
# Train path (phases 4-6)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recording():
    """Record every call of the train kernels' wrappers (name, args, kwargs)
    while active; the calls run as usual."""
    calls = []
    originals = {n: getattr(kernel_module(n), n) for n in TRAIN_KERNELS}

    def recorder(name):
        fn = originals[name]

        def rec(*args, **kwargs):
            calls.append((name, args, kwargs))
            return fn(*args, **kwargs)
        return rec

    for n in TRAIN_KERNELS:
        setattr(kernel_module(n), n, recorder(n))
    try:
        yield calls
    finally:
        for n, fn in originals.items():
            setattr(kernel_module(n), n, fn)


@contextlib.contextmanager
def plain_train_kernels():
    """Route the train stage's wrappers to their plain versions."""
    originals = {n: getattr(kernel_module(n), n) for n in TRAIN_KERNELS}
    for n in TRAIN_KERNELS:
        setattr(kernel_module(n), n, getattr(kernel_module(n), n + "_reference"))
    try:
        yield
    finally:
        for n, fn in originals.items():
            setattr(kernel_module(n), n, fn)


@contextlib.contextmanager
def train_backward(version: str):
    """Run the fused train stages' backward ``version`` ("v3" or "v2")."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst

    before = tst._TRAIN_BWD_V3
    tst.set_train_bwd_v3(version == "v3")
    try:
        yield
    finally:
        tst.set_train_bwd_v3(before)


def _parts(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _arg(args, kwargs, i, name, default=None):
    return args[i] if len(args) > i else kwargs.get(name, default)


def conv3_call(args, kwargs):
    """A fused_conv3 call's (mode, src, weight, side, consts, bias, shortcut)."""
    names = ("mode", "src", "weight", "side", "consts", "bias", "shortcut")
    defaults = (None, None, None, (), (), None, None)
    return tuple(_arg(args, kwargs, i, n, d) for i, (n, d) in enumerate(zip(names, defaults)))


def wgrad3_call(args, kwargs):
    """A fused_wgrad call's (mode, x, g, consts, prologue)."""
    names = ("mode", "x", "g", "consts", "prologue")
    defaults = (None, None, None, (), None)
    return tuple(_arg(args, kwargs, i, n, d) for i, (n, d) in enumerate(zip(names, defaults)))


def describe_call(name, args, kwargs) -> str:
    if name == "train_tail":
        f2, parts = args[0], _parts(args[1])
        head = args[6] if len(args) > 6 else kwargs.get("head")
        return (f"train_tail {tuple(f2.shape)} parts={[p.shape[-1] for p in parts]}"
                f" head={head is not None}")
    if name == "fused_conv3":
        mode, src, weight, side, _, _, shortcut = conv3_call(args, kwargs)
        return (f"fused_conv3 {mode} {tuple(src[0].shape[:3])} "
                f"in={[t.shape[-1] for t in _parts(src)]} out={weight.shape[0]}")
    if name == "fused_wgrad":
        mode, x, g, _, _ = wgrad3_call(args, kwargs)
        return (f"fused_wgrad {mode} {tuple(_parts(x)[0].shape[:3])} "
                f"in={[t.shape[-1] for t in _parts(x)]} g={[t.shape[-1] for t in _parts(g)]}")
    parts = _parts(args[0])
    extra = "".join(f" {k}" for k in ("prologue", "bias") if kwargs.get(k) is not None)
    cout = args[1].shape[0] if name == "conv_stats" else args[1].shape[-1]
    return (f"{name} {tuple(parts[0].shape[:3])} in={[p.shape[-1] for p in parts]} "
            f"out={cout}{extra}")


def _nbytes(tensors):
    """Bytes of the distinct tensors among ``tensors``."""
    seen = {}
    for t in tensors:
        seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def call_cost(name, args, kwargs):
    """(FLOPs, bytes) one call must do: the multiply-adds of its products
    at their real (unpadded) widths; each input read and each output
    written once."""
    if name == "train_tail":
        f2, parts, _, _, _, sp = args[:6]
        head = args[6] if len(args) > 6 else kwargs.get("head")
        parts = _parts(parts)
        n, h, w, c = f2.shape
        csum = sum(p.shape[-1] for p in parts)
        lab, nh = sp[0].shape[0], sp[2].shape[0]
        ncls = 0 if head is None else head[0].shape[0]
        macs = csum * c + 9 * c * lab + 9 * lab * nh + 9 * nh * 2 * c + c * ncls
        nbytes = 2 * n * h * w * (c + csum + (ncls or c) + c + lab + nh)
        return 2.0 * macs * n * h * w, nbytes
    if name == "fused_conv3":
        mode, src, weight, side, _, _, shortcut = conv3_call(args, kwargs)
        src = _parts(src)
        n, h, w = src[0].shape[:3]
        cout = weight.shape[0]
        macs = weight[0].numel() * cout + (0 if shortcut is None else shortcut.numel())
        nbytes = (_nbytes(list(src) + list(side)) + 2 * (weight.numel() + (
            0 if shortcut is None else shortcut.numel())) + 2 * n * h * w * cout)
        return 2.0 * macs * n * h * w, nbytes
    if name == "fused_wgrad":
        mode, x, g, _, _ = wgrad3_call(args, kwargs)
        x, g = _parts(x), _parts(g)
        n, h, w = x[0].shape[:3]
        cin = sum(p.shape[-1] for p in x)
        cout = 2 * g[0].shape[-1] if mode == "gb" else g[0].shape[-1]
        return 2.0 * 9 * cin * cout * n * h * w, _nbytes(list(x) + list(g)) + 4 * 9 * cin * cout
    parts = _parts(args[0])
    n, h, w = parts[0].shape[:3]
    cin = sum(p.shape[-1] for p in parts)
    if name == "conv_stats":
        cout = args[1].shape[0]
        nbytes = 2 * (n * h * w * (cin + cout) + 9 * cin * cout)
    else:  # wgrad: f32 dW out
        cout = args[1].shape[-1]
        nbytes = 2 * n * h * w * (cin + cout) + 4 * 9 * cin * cout
    return 2.0 * 9 * cin * cout * n * h * w, nbytes


def bound_of(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(ms, kind): the larger of the operations at ``peak`` (bf16 tensor
    cores by default) and the bytes at HBM bandwidth."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def wgrad_inputs(name, args, kwargs):
    """A weight gradient call's (input parts, materialized cotangent,
    prologue)."""
    if name == "wgrad":
        return _parts(args[0]), args[1], _arg(args, kwargs, 2, "prologue")
    from ssunet_gan_tpu_torch.ops import train_bwd as ttb

    mode, x, g, consts, prologue = wgrad3_call(args, kwargs)
    x = _parts(x)
    return x, ttb._cotangent(mode, _parts(g), consts, x[0].dtype), prologue


def library_call(name, args, kwargs):
    """One PyTorch call on the same inputs as a yardstick (cuDNN in bf16):
    the convolution for conv_stats (without the sums) and for fused_conv3
    (its 3×3 conv on the raw sources, without the chains), the weight
    gradient on the materialized input and cotangent for wgrad and
    fused_wgrad; None for train_tail."""
    import torch.nn.functional as F
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst

    if name == "train_tail":
        return None
    if name == "fused_conv3":
        mode, src, weight, _, _, bias, _ = conv3_call(args, kwargs)
        src = _parts(src)
        srcs = (src[0], src[0]) if mode == "modgrad" else src[:1]
        x = torch.cat(srcs, -1).permute(0, 3, 1, 2)
        wt = weight.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        b = None if bias is None else bias.to(torch.bfloat16)
        return lambda: F.conv2d(x, wt, b, padding=1)
    if name in ("wgrad", "fused_wgrad"):
        parts, g, pro = wgrad_inputs(name, args, kwargs)
        if pro is not None:
            parts = (tst._prologued(parts[0], pro),)
        x = torch.cat(parts, -1).permute(0, 3, 1, 2)
        gt = g.permute(0, 3, 1, 2)
        shape = (gt.shape[1], x.shape[1], 3, 3)
        return lambda: torch.nn.grad.conv2d_weight(x, shape, gt, padding=1)
    parts = _parts(args[0])
    pro = kwargs.get("prologue")
    if pro is not None:
        parts = (tst._prologued(parts[0], pro),)
    x = torch.cat(parts, -1).permute(0, 3, 1, 2)  # NCHW view, channels-last memory
    wt = args[1].to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b = kwargs.get("bias")
    b = None if b is None else b.to(torch.bfloat16)
    return lambda: F.conv2d(x, wt, b, padding=1)


def wgrad_f64(parts, g, prologue=None):
    """The weight gradient of the same bf16 values summed in f64, image by
    image: the yardstick of the kernel's and the plain version's f32 sums."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst

    parts = _parts(parts)
    if prologue is not None:
        parts = (tst._prologued(parts[0], prologue),)
    x = torch.cat(parts, -1).permute(0, 3, 1, 2)
    gt = g.permute(0, 3, 1, 2)
    shape = (gt.shape[1], x.shape[1], 3, 3)
    return sum(torch.nn.grad.conv2d_weight(x[i:i + 1].double(), shape, gt[i:i + 1].double(),
                                           padding=1) for i in range(x.shape[0]))


def sums_close(sums, w_sums):
    """(largest error, within SUMS_TOL of each row's largest sum)."""
    errs = [(s - w).abs().max().item() for s, w in zip(sums, w_sums)]
    ok = all(e <= SUMS_TOL * w.abs().max().item() + SUMS_TOL for e, w in zip(errs, w_sums))
    return max(errs), ok and bool(torch.isfinite(sums).all()) and sums.shape == w_sums.shape


def compare_call(name, args, kwargs):
    """The kernel and the plain version of one recorded call on its inputs:
    (max abs err, within tolerance, text)."""
    mod = kernel_module(name)
    got = getattr(mod, name)(*args, **kwargs)
    want = getattr(mod, name + "_reference")(*args, **kwargs)
    torch.cuda.synchronize()
    if name in ("wgrad", "fused_wgrad"):
        diff = (got - want).abs().max().item()
        l2 = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
        ok = l2 <= WGRAD_L2_TOL and bool(torch.isfinite(got).all()) and got.shape == want.shape
        exact = wgrad_f64(*wgrad_inputs(name, args, kwargs))
        return diff, ok, (f"rel_l2={l2:.3g} max_abs_err={diff:.4g}; from an f64 sum "
                          f"kernel {rel_l2(got.double(), exact):.3g} plain {rel_l2(want.double(), exact):.3g}")
    if name in ("conv_stats", "fused_conv3"):
        (out, sums), (w_out, w_sums) = got, want
        outs, w_outs = _parts(out), _parts(w_out)
        worst, ok, texts = 0.0, len(outs) == len(w_outs), []
        for o, wo in zip(outs, w_outs):
            err, scale, l2, o_ok = close(o, wo)
            worst, ok = max(worst, err), ok and o_ok and o.shape == wo.shape
            texts.append(f"max_abs_err={err:.4g} rel_l2={l2:.3g} (max|plain|={scale:.4g})")
        text = " ".join(texts)
        if (sums is None) != (w_sums is None):
            ok = False
        elif w_sums is not None:
            d, s_ok = sums_close(sums, w_sums)
            ok = ok and s_ok
            rows = [round(v, 4) for v in w_sums.abs().amax(1).tolist()]
            text += f" sums_err={d:.4g} (max|sum| by row {rows})"
        return worst, ok, text
    worst, oks, texts = 0.0, [], []
    for what, g, wv in zip(("out", "y", "seg", "actv"), got, want):
        err, scale, l2, ok = close(g, wv)
        worst, oks = max(worst, err), oks + [ok and g.shape == wv.shape]
        texts.append(f"{what} {err:.4g}/{l2:.3g}")
    return worst, all(oks), "max_abs_err/rel_l2 " + " ".join(texts)


def rel_l2(u, v):
    return ((u.float() - v.float()).norm() / v.float().norm().clamp_min(1e-30)).item()


def against_f32_bar(what, kern, plain, f32, check, strict=True) -> bool:
    """The forwards' bar for one tensor: the kernel no further from f32 than
    NOISE_RATIO × the plain bf16 path, and kernel-plain no further apart
    than plain-f32 (relative L2). With ``strict=False`` (one parameter's
    gradient, where a sum that cancels, such as a bias gradient, leaves
    bf16 noise of the order of the value itself) ``e_kp ≤ GRAD_KP·e_p``;
    the parameter gradient as a whole is then held to the strict bar.
    Returns whether the bar would fail a zeroed gradient (GRAD_KP·e_p < 1)."""
    e_k, e_p, e_kp = rel_l2(kern, f32), rel_l2(plain, f32), rel_l2(kern, plain)
    finite = bool(torch.isfinite(kern.float()).all())
    if strict:
        ok = finite and e_k <= NOISE_RATIO * e_p and e_kp <= e_p
    else:
        ok = finite and e_kp <= GRAD_KP * e_p
    print(f"{what}: rel_l2 kernel-f32 {e_k:.4g} plain-f32 {e_p:.4g} kernel-plain "
          f"{e_kp:.4g}{'' if ok else '  <-- FAILED'}")
    check(ok, f"{what}: kernel-f32 {e_k}, plain-f32 {e_p}, kernel-plain {e_kp}")
    return GRAD_KP * e_p < 1


def gradient_bars(what, names, kern, plain, f32, check) -> None:
    """Each parameter's gradient (e_kp ≤ GRAD_KP·e_p), then all of them as
    one vector (strict)."""
    blind = [n for n, k, p, f in zip(names, kern, plain, f32)
             if not against_f32_bar(f"{what} d {n}", k, p, f, check, strict=False)]
    flat = lambda ts: torch.cat([t.float().reshape(-1) for t in ts])
    against_f32_bar(f"{what} parameter gradient (all {len(names)} tensors)",
                    flat(kern), flat(plain), flat(f32), check)
    print(f"{what}: {len(names) - len(blind)} of {len(names)} parameter gradients resolved "
          f"(plain-f32 < 1/{GRAD_KP:g}, a zeroed gradient fails the bar); not resolved: "
          f"{', '.join(blind) or 'none'}")


def step1_sums(kern, plain, f32) -> np.ndarray:
    """Per tensor of one step 1 (the loss, then each parameter gradient):
    ||k-p||², ||p-f||², ||k-f||², ||p||², ||f||² in f64, 1 where the
    kernel's tensor is finite, the projections <k-p, p>, <p-f, f>, and the
    tensor's element count, for the kernel (k), plain (p) and f32 (f) runs.
    Summed over batches, they give the pooled distances of
    :func:`step1_bars`."""
    rows = []
    for k, p, f in zip(kern, plain, f32):
        k, p, f = k.double(), p.double(), f.double()
        rows.append(torch.stack([(k - p).square().sum(), (p - f).square().sum(),
                                 (k - f).square().sum(), p.square().sum(), f.square().sum(),
                                 torch.isfinite(k).all().double(), ((k - p) * p).sum(),
                                 ((p - f) * f).sum(), torch.tensor(float(k.numel()),
                                                                   dtype=torch.float64,
                                                                   device=k.device)]))
    return torch.stack(rows).cpu().numpy()


def step1_bars(sums, names, pooled=True):
    """The step-1 bars on the per-batch sums of :func:`step1_sums` (shape
    batches × tensors × 9). ``pooled``: each distance over all the batches
    at once, the bars of STEP1_* (above); else the one-batch bars of
    chip_smoke.py before them (the loss strict, each gradient e_kp ≤
    GRAD_KP·e_p, all gradients strict), for the record. Returns (ok, [(what,
    e_k, e_p, e_kp, held)], names of the single gradients that failed)."""
    s = np.asarray(sums, dtype=np.float64)
    tot = s.sum(0)  # sums of squares and projections over the batches
    finite = s[..., 5].min(0) > 0

    def ratios(t):
        kp2, pf2, kf2, p2, f2 = t[:5]
        e = lambda a, b: float(np.sqrt(a / max(b, 1e-300)))
        return e(kf2, f2), e(pf2, f2), e(kp2, p2)

    rows = []
    e_k, e_p, e_kp = ratios(tot[0])
    held = bool(finite[0]) and (e_kp <= e_p if pooled
                                else e_k <= NOISE_RATIO * e_p and e_kp <= e_p)
    rows.append(("loss", e_k, e_p, e_kp, held))
    bad = []
    for i, n in enumerate(names):
        t = tot[1 + i]
        e_k, e_p, e_kp = ratios(t)
        ok = bool(finite[1 + i]) and e_kp <= GRAD_KP * e_p
        if pooled and s[0, 1 + i, 8] >= STEP1_SCALE_MIN:
            ok = ok and abs(t[6]) / max(t[3], 1e-300) <= STEP1_SCALE_KP * e_p
        if not ok:
            bad.append(n)
    e_k, e_p, e_kp = ratios(tot[1:].sum(0))
    rows.append((f"all {len(names)} parameter gradients", e_k, e_p, e_kp,
                 bool(finite[1:].all()) and e_k <= NOISE_RATIO * e_p and e_kp <= e_p))
    rows.append(("each parameter gradient", float("nan"), float("nan"), float("nan"), not bad))
    return all(r[4] for r in rows), rows, bad


def stage_phases(dev, sigs, check, version, train_err):
    """Phases 4 and 5 with the fused stages' backward ``version``: every
    train kernel call of the six stages at batch 2 against its plain
    version, and the stage gradients against plain and f32."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
    from ssunet_gan_tpu_torch.ops.blocks import BasicBlock
    from ssunet_gan_tpu_torch.ops.conv import Conv2d
    from ssunet_gan_tpu_torch.ops.spade import SPADE

    for name, chans, planes, lab, nh, head_cls, level in sigs:
        g = torch.Generator().manual_seed(SEED + 10)
        block = BasicBlock(sum(chans), planes, generator=g)
        with torch.no_grad():  # BN affines away from (1, 0)
            for bn in (block.bn1, block.bn2):
                bn.weight.copy_(1 + 0.2 * torch.randn(planes, generator=g))
                bn.bias.copy_(0.2 * torch.randn(planes, generator=g))
        spade = SPADE("spadebatch3x3", planes, lab, float(nh), generator=g)
        final = Conv2d(planes, head_cls, 1, generator=g) if head_cls else None
        block.to(dev).train()
        spade.to(dev)
        mods = (block, spade) + ((final.to(dev),) if final is not None else ())
        names = [f"{m.__class__.__name__}.{k}" for m in mods for k, _ in m.named_parameters()]
        params = [p for m in mods for p in m.parameters()]
        head = None if final is None else (final.weight, final.bias)
        side = HW >> level
        xs = [torch.randn((2, side, side, c), generator=g).to(dev) for c in chans]
        cot = torch.randn((2, side, side, head_cls or planes), generator=g).to(dev)

        def stage_run(dtype):
            parts = tuple(x.to(dtype).requires_grad_() for x in xs)
            out, stats = tst.fused_train_stage(parts, block.train_params(),
                                               spade.stage_params(), head)
            grads = torch.autograd.grad((out.float() * cot).sum(), [*parts, *params])
            return [out, *(s for pair in stats for s in pair), *grads]

        def module_run():
            """Plain autograd of the module composition in f32; the batch
            statistics from the BatchNorms' inputs."""
            parts = tuple(x.requires_grad_() for x in xs)
            seen = []
            hooks = [bn.register_forward_pre_hook(lambda m, a: seen.append(a[0].detach()))
                     for bn in (block.bn1, block.bn2)]
            try:
                out = module_stage(parts, block, spade, final)
            finally:
                for hk in hooks:
                    hk.remove()
            stats = [v for t in seen for v in (t.mean((0, 1, 2)), t.var((0, 1, 2)))]
            grads = torch.autograd.grad((out.float() * cot).sum(), [*parts, *params])
            return [out, *stats, *grads]

        with train_backward(version):
            with recording() as calls:
                kern = stage_run(torch.bfloat16)
            torch.cuda.synchronize()
            for kname, args, kw in calls:
                err, ok, text = compare_call(kname, args, kw)
                train_err[kname] = max(train_err[kname], err)
                what = f"phase 4 ({version}): {name} {describe_call(kname, args, kw)}"
                print(f"{what} {text}")
                check(ok, f"{what}: {text}")
            print(f"phase 4 ({version}): {name}: {dict(Counter(c[0] for c in calls))} calls, "
                  f"forward and backward")
            del calls
            with plain_train_kernels():
                plain = stage_run(torch.bfloat16)
        f32 = module_run()
        labels = (["out", "mean1", "uvar1", "mean2", "uvar2"]
                  + [f"d part{i}" for i in range(len(xs))])
        for lbl, k, p, f in zip(labels, kern, plain, f32):
            against_f32_bar(f"phase 5 ({version}): {name} {lbl}", k, p, f, check)
        n0 = len(labels)
        gradient_bars(f"phase 5 ({version}): {name}", names, kern[n0:], plain[n0:], f32[n0:],
                      check)
        del kern, plain, f32, xs, block, spade, final, params
    torch.cuda.empty_cache()


def call_types(calls):
    """The type of each recorded call, for the per-type sub-tables: a chain
    mode for fused_conv3 and fused_wgrad; for conv_stats the forward's conv1
    (encoder: one part; decoder: two), conv2 (with the prologue), and on a
    v2 step the γ|β recompute (with the bias) and the backward-data convs
    after it (no sums), by their place; for wgrad its place among a stage's
    five v2 weight gradients. None for train_tail."""
    types, n_wgrad, n_data = [], 0, 0
    for kname, args, kw in calls:
        kind = None
        if kname in ("fused_conv3", "fused_wgrad"):
            kind = _arg(args, kw, 0, "mode")
        elif kname == "wgrad":
            kind, n_wgrad = WGRAD_V2[n_wgrad % len(WGRAD_V2)], n_wgrad + 1
        elif kname == "conv_stats":
            if _arg(args, kw, 3, "prologue") is not None:
                kind = "conv2 (prologue)"
            elif _arg(args, kw, 2, "bias") is not None:
                kind, n_data = "γ|β recompute", 0
            elif not _arg(args, kw, 4, "stats", True):
                kind, n_data = f"backward-data {BWD_DATA_V2[n_data]}", n_data + 1
            else:
                kind = "conv1 decoder" if len(_parts(args[0])) == 2 else "conv1 encoder"
        types.append(kind)
    return types


def time_calls(calls, kernels, label, train_err, check):
    """Hold each recorded call of ``kernels`` against its plain version on
    its inputs (phase 4's tolerances) and time it against the plain
    version, its bound and the library call. Returns per-kernel totals."""
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                  "kinds": set(), "calls": 0, "macs": 0.0} for k in kernels}
    by_type = {}  # (kernel, call type): the per-type sub-tables
    for (kname, args, kw), ctype in zip(calls, call_types(calls)):
        if kname not in kernels:
            continue
        err, ok, text = compare_call(kname, args, kw)
        train_err[kname] = max(train_err[kname], err)
        what = f"phase 6: {label} batch {TRAIN_BATCH} {describe_call(kname, args, kw)}"
        print(f"{what} {text}")
        check(ok, f"{what}: {text}")
        mod = kernel_module(kname)
        fn, ref = getattr(mod, kname), getattr(mod, kname + "_reference")
        ms = cuda_ms(lambda: fn(*args, **kw), 3, warmup=1)
        plain_ms = cuda_ms(lambda: ref(*args, **kw), 1, warmup=1)
        lib = library_call(kname, args, kw)
        lib_ms = None if lib is None else cuda_ms(lib, 3, warmup=1)
        flops, nbytes = call_cost(kname, args, kw)
        bound, kind = bound_of(flops, nbytes)
        t = totals[kname]
        t["macs"] += flops / 2
        t["ms"] += ms
        t["plain_ms"] += plain_ms
        t["bound_ms"] += bound
        t["library_ms"] += lib_ms or 0.0
        t["kinds"].add(kind)
        t["calls"] += 1
        if ctype is not None:
            m = by_type.setdefault((kname, ctype), [0, 0.0, 0.0, 0.0, 0.0])
            for i, v in enumerate((1, ms, plain_ms, bound, lib_ms or 0.0)):
                m[i] += v
        print(f"train call: {describe_call(kname, args, kw)} ms {ms:.3f} plain {plain_ms:.3f} "
              f"bound {bound:.3f} ({kind}) library "
              f"{'none' if lib_ms is None else f'{lib_ms:.3f}'}")
    for (kname, ctype), (n, ms, plain_ms, bound, lib_ms) in sorted(by_type.items()):
        print(f"train mode: {kname} {ctype} ({label}, {n} calls) per step ms {ms:.3f} "
              f"plain {plain_ms:.3f} bound {bound:.3f} library {lib_ms:.3f}")
    for kname, t in totals.items():
        print(f"train kernel: {kname} ({label}, {t['calls']} calls) per step ms {t['ms']:.3f} "
              f"plain {t['plain_ms']:.3f} bound {t['bound_ms']:.3f} "
              f"library {t['library_ms']:.3f}; {t['macs']:.4g} multiply-adds "
              f"({2e3 * t['macs'] / PEAK_BF16_FLOPS:.3f} ms at the bf16 peak)")
    return totals


def print_profile(what, step_fn, ms_step):
    busy, wall_ms, rows = profile_kernels(step_fn, 1)
    print(f"profile: per train step, {what} (batch {TRAIN_BATCH}): device busy {busy:.3f} ms, "
          f"{sum(r[1] for r in rows)} kernels; {wall_ms:.3f} ms wall under the profiler "
          f"(idle share {max(0.0, 1 - busy / wall_ms):.3f}), {ms_step:.3f} ms untraced "
          f"(idle share {max(0.0, 1 - busy / ms_step):.3f})")
    for ms, count, key in rows[:20]:
        print(f"profile: {what} {ms:9.3f} ms {count:4d}x {key[:90]}")
    return rows


def train_phases(dev, cfg, card, sigs, check):
    """Phases 4-6; returns (launch counts of the main path, max abs error
    per kernel, per-step time totals per kernel, the v3 step's ms)."""
    from ssunet_gan_tpu_torch.models import build_model, ssunet

    ncls, in_ch = cfg["num_classes"], cfg["input_channels"]
    train_err = {k: 0.0 for k in TRAIN_KERNELS}
    # ---- phases 4 and 5: the v2 backward (kernel 4 and the v2 uses of
    # kernel 2, off the main path), then the v3 backward (the main path's)
    t0 = time.perf_counter()
    for version in ("v2", "v3"):
        stage_phases(dev, sigs + (WIDE_HIDDEN_SIGS if version == "v3" else []), check, version,
                     train_err)
        t0 = phase_done(f"phases 4-5 ({version})", t0)

    # ---- phase 6: the trainer (this slice's main path, the v3 backward)
    from ssunet_gan_tpu_torch.data.dataset import SyntheticDataset
    from ssunet_gan_tpu_torch.data.loader import BatchLoader
    from ssunet_gan_tpu_torch.data.transforms import val_transform
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
    from ssunet_gan_tpu_torch.ops.losses import get_loss
    from ssunet_gan_tpu_torch.ops.norm import BatchNorm
    from ssunet_gan_tpu_torch.train.optim import build_optimizer, build_scheduler
    from ssunet_gan_tpu_torch.train.step import make_train_step
    from ssunet_gan_tpu_torch.train.supervised import train_one_epoch

    check(tst._TRAIN_BWD_V3, "phase 6: the default train backward is not v3")

    def loader(n_steps, seed):
        ds = SyntheticDataset(n_steps * TRAIN_BATCH, HW, HW, ncls, in_ch,
                              transform=val_transform(cfg), seed=seed)
        return BatchLoader(ds, TRAIN_BATCH, shuffle=False, drop_last=True,
                           num_workers=int(cfg["num_workers"]))

    tmodel = build_model(cfg["arch"], ncls, in_ch, cfg["deep_supervision"], seed=SEED,
                         device=dev).train()
    optimizer = build_optimizer(tmodel.parameters(), cfg)
    loss_fn = get_loss(cfg["loss"])
    step = make_train_step(tmodel, loss_fn, optimizer, ncls, cfg["deep_supervision"],
                           clip=float(cfg["clip"]))
    lr = build_scheduler(cfg).lr(0)
    pnames = [n for n, _ in tmodel.named_parameters()]

    # step 1 from identical weights on STEP1_BATCHES seeded batches: the
    # kernels, the same autograd Function on the plain versions (bf16), and
    # plain autograd of the module composition in f32 (independent of the
    # Function's backward); the bars pool each distance over the batches
    snapshot = copy.deepcopy(tmodel.state_dict())
    fused_stage = ssunet.spade_stage
    fused_ids = {id(getattr(tmodel, s[0])): s[0] for s in sigs}
    seen = {}

    def capturing_stage(parts, block, spade, final=None, name=None, out_key=None, up=None,
                        down=None):
        """The model's stage, recording each fused stage's inputs (its seams
        materialized as a train forward takes them) and the cotangent its
        output receives."""
        if up or down:
            parts = ssunet._seams(ssunet.as_parts(parts), up, down, False, False, None)[0]
        out = fused_stage(parts, block, spade, final)
        if id(block) in fused_ids:
            rec = seen[fused_ids[id(block)]] = {
                "parts": tuple(p.detach() for p in ssunet.as_parts(parts)),
                "mods": (block, spade, final)}
            out.register_hook(lambda g: rec.__setitem__("g", g.detach()))
        return out

    def step1_grads(x, y, dtype, stage):
        tmodel.load_state_dict(snapshot)
        tmodel.zero_grad(set_to_none=True)
        with spade_stages_as(stage):
            out = tmodel(x.to(dtype))
            loss = loss_fn(torch.where(torch.isnan(out), torch.zeros_like(out), out), y)
            loss.backward()
        res = [loss.detach()] + [p.grad.detach().clone() for p in tmodel.parameters()]
        tmodel.zero_grad(set_to_none=True)
        return res

    sums = []
    for seed in range(1, STEP1_BATCHES + 1):
        batches = iter(loader(1, seed=seed))
        _, img, mask, _ = next(batches)
        batches.close()  # its producer thread ends now, not at a garbage collection
        x1, y1 = torch.from_numpy(img).to(dev), torch.from_numpy(mask).to(dev)
        # batch 1 also records each fused stage's inputs and cotangent
        kern = step1_grads(x1, y1, torch.bfloat16, capturing_stage if seed == 1 else fused_stage)
        with plain_train_kernels():
            plain = step1_grads(x1, y1, torch.bfloat16, fused_stage)
        f32 = step1_grads(x1, y1, torch.float32, module_stage)
        sums.append(step1_sums(kern, plain, f32))
        print(f"phase 6: step 1 batch {seed} loss kernel {kern[0].item():.6f} plain "
              f"{plain[0].item():.6f} f32 {f32[0].item():.6f}")
        if seed == 1:
            kern1 = kern
        del kern, plain, f32
    tmodel.load_state_dict(snapshot)
    ok, rows, bad = step1_bars(sums, pnames)
    what = f"phase 6: step 1 over batches 1-{STEP1_BATCHES} (pooled)"
    for name, e_k, e_p, e_kp, held in rows:
        print(f"{what} {name}: rel_l2 kernel-f32 {e_k:.4g} plain-f32 {e_p:.4g} kernel-plain "
              f"{e_kp:.4g}{'' if held else '  <-- FAILED'}")
    print(f"{what}: single parameter gradients failing: {', '.join(bad) or 'none'}")
    check(ok, f"{what}: bars {[r[0] for r in rows if not r[4]]}, gradients {bad}")

    # each fused stage on the inputs and output cotangent the kernel step
    # gave it (no bf16 divergence upstream): the model's parameter gradients
    # from that step against the Function on the plain versions and the f32
    # module composition on the same inputs and cotangent
    check(list(seen) == [s[0] for s in sigs] and all("g" in r for r in seen.values()),
          f"phase 6: step 1 fused stages seen {list(seen)}, expected {[s[0] for s in sigs]}")
    pindex = {id(p): i for i, p in enumerate(tmodel.parameters())}
    for name, rec in seen.items():
        block, spade, final = rec["mods"]
        parts, g = rec["parts"], rec["g"].float()
        params = [p for m in rec["mods"] if m is not None for p in m.parameters()]
        head = None if final is None else (final.weight, final.bias)
        with plain_train_kernels():
            out, _ = tst.fused_train_stage(parts, block.train_params(),
                                           spade.stage_params(), head)
        plain = torch.autograd.grad((out.float() * g).sum(), params)
        out = module_stage(tuple(p.float() for p in parts), block, spade, final)
        f32 = torch.autograd.grad((out.float() * g).sum(), params)
        gradient_bars(f"phase 6: step 1 {name} on its inputs",
                      [pnames[pindex[id(p)]] for p in params],
                      [kern1[1 + pindex[id(p)]] for p in params], plain, f32, check)
        del out, plain, f32
    tmodel.load_state_dict(snapshot)
    del kern1, snapshot, seen
    torch.cuda.empty_cache()
    t0 = phase_done("phase 6 step 1 checks", t0)

    # the main path: counts to 0, 2 warm-up steps, 5 timed steps, counts read
    per_step = PER_STEP["v3"]
    bns = [m for m in tmodel.modules() if isinstance(m, BatchNorm)]
    stats_before = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
    reset_launches()
    warm_log = train_one_epoch(0, cfg, loader(TRAIN_WARM, seed=1), step, lr, device=dev)
    check(read_launches() == {k: TRAIN_WARM * v for k, v in per_step.items()},
          f"phase 6: launches in {TRAIN_WARM} warm-up steps {read_launches()} != "
          f"{TRAIN_WARM} x {per_step}")
    settle()
    t1 = time.perf_counter()
    log = train_one_epoch(1, cfg, loader(TRAIN_STEPS, seed=2), step, lr, device=dev)
    torch.cuda.synchronize()
    train_dt = time.perf_counter() - t1
    counts = read_launches()
    steps = TRAIN_WARM + TRAIN_STEPS
    print(f"phase 6: kernel launches in {steps} steps: {counts} "
          f"(expected {steps} x {per_step})")
    check(counts == {k: steps * v for k, v in per_step.items()},
          f"phase 6: launches {counts} != {steps} x {per_step}")
    ms_step = train_dt / TRAIN_STEPS * 1e3
    print(f"phase 6: flagship train step (v3 backward) {ms_step:.2f} ms/step, "
          f"{TRAIN_BATCH * TRAIN_STEPS / train_dt:.2f} images/s (512x512 bf16, batch "
          f"{TRAIN_BATCH}, Adam, {TRAIN_STEPS} steps after {TRAIN_WARM} warm-up) on {card}")
    print(f"phase 6: warm-up epoch {warm_log}; timed epoch {log}")
    finite = all(np.isfinite(v) for lg in (warm_log, log)
                 for k, v in lg.items() if k != "images_per_sec")
    check(finite, f"phase 6: metrics not finite: {warm_log} {log}")
    moved = sum(bool((m.running_mean != b[0]).any() and (m.running_var != b[1]).any())
                for m, b in zip(bns, stats_before))
    print(f"phase 6: BN running statistics moved in {moved} of {len(bns)} BatchNorms")
    check(moved == len(bns), f"phase 6: only {moved} of {len(bns)} BatchNorms moved")
    del stats_before

    # the v2 backward beside it in the same call: a record, not a claim
    with train_backward("v2"):
        reset_launches()
        train_one_epoch(0, cfg, loader(1, seed=4), step, lr, device=dev)
        settle()
        t1 = time.perf_counter()
        v2_log = train_one_epoch(1, cfg, loader(V2_STEPS, seed=5), step, lr, device=dev)
        torch.cuda.synchronize()
        v2_dt = time.perf_counter() - t1
        v2_counts = read_launches()
    ms_step_v2 = v2_dt / V2_STEPS * 1e3
    check(v2_counts == {k: (1 + V2_STEPS) * v for k, v in PER_STEP["v2"].items()},
          f"phase 6: v2 launches {v2_counts} != {1 + V2_STEPS} x {PER_STEP['v2']}")
    print(f"phase 6: flagship train step (v2 backward, record) {ms_step_v2:.2f} ms/step, "
          f"{TRAIN_BATCH * V2_STEPS / v2_dt:.2f} images/s ({V2_STEPS} steps after 1 warm-up) "
          f"on {card}; launches {v2_counts}; epoch {v2_log}")
    t0 = phase_done("phase 6 trainer (v3 main path, v2 record)", t0)

    # one steady-state step: each kernel call held against its plain version
    # on the same inputs (phase 4's tolerances, at the main path's shapes),
    # and timed against the plain version, its bound and the library call;
    # kernel 4 (v2 only) from one v2 step, beside that step's conv_stats
    # calls (a record: the kernels line keeps the v3 step's)
    _, img, mask, _ = next(iter(loader(1, seed=3)))
    xb = torch.from_numpy(img).to(dev).to(torch.bfloat16)
    yb = torch.from_numpy(mask).to(dev)
    with recording() as calls:
        step(xb, yb, lr)
    torch.cuda.synchronize()
    totals = time_calls(calls, [k for k in TRAIN_KERNELS if k != "wgrad"], "v3", train_err,
                        check)
    del calls
    with train_backward("v2"), recording() as calls:
        step(xb, yb, lr)
    torch.cuda.synchronize()
    totals["wgrad"] = time_calls(calls, ["conv_stats", "wgrad"], "v2", train_err,
                                 check)["wgrad"]
    del calls
    torch.cuda.empty_cache()
    t0 = phase_done("phase 6 per-call checks and timing", t0)

    # where one train step's device time goes, v3 and v2
    rows = print_profile("v3", lambda: step(xb, yb, lr), ms_step)
    tail_line("kernel 3: flagship train step (v3)", "step", rows,
              tail_calls(sigs, TRAIN_BATCH, saves=True))
    conv_profile_line("kernel 3: flagship train step (v3), the residual conv", "step", rows)
    with train_backward("v2"):
        print_profile("v2", lambda: step(xb, yb, lr), ms_step_v2)
    phase_done("phase 6 profiles", t0)
    return counts, train_err, totals, ms_step


# ---------------------------------------------------------------------------
# Eval forwards against the f32 all-plain forward (phases 2-3 and 8)
# ---------------------------------------------------------------------------


def forward_bar(what, kern, plain, ref, check):
    """A forward's output on the kernels and on the plain versions against
    the f32 all-plain forward: the kernel no further from f32 than
    NOISE_RATIO x the plain path, kernel-plain closer than plain-f32
    (relative L2). Returns (kernel-f32, plain-f32, kernel-plain)."""
    mx = lambda u, v: (u.float() - v.float()).abs().max().item()
    e_k, e_p, e_kp = rel_l2(kern, ref), rel_l2(plain, ref), rel_l2(kern, plain)
    print(f"{what}: rel_l2 kernel-f32 {e_k:.4g}, plain-f32 {e_p:.4g}, kernel-plain "
          f"{e_kp:.4g}; max_abs kernel-f32 {mx(kern, ref):.4g}, plain-f32 "
          f"{mx(plain, ref):.4g}, kernel-plain {mx(kern, plain):.4g} "
          f"(max|f32| {ref.float().abs().max().item():.4g}, "
          f"mean|f32| {ref.float().abs().mean().item():.4g})")
    check(bool(torch.isfinite(kern.float()).all()) and kern.shape == ref.shape,
          f"{what}: not finite or shape {tuple(kern.shape)} != {tuple(ref.shape)}")
    check(e_k <= NOISE_RATIO * e_p, f"{what}: kernel-f32 {e_k} > {NOISE_RATIO} x plain-f32 {e_p}")
    check(e_kp <= e_p, f"{what}: kernel-plain {e_kp} > plain-f32 {e_p}")
    return e_k, e_p, e_kp


def mask_bars(what, masks, plain_masks, f32_masks, check):
    """Scene masks on the kernels, on the plain versions and in f32: the
    shares of pixels on which they agree, held to the bars at the top.
    Returns (kernel-plain, kernel-f32, plain-f32)."""
    agree = lambda ms1, ms2: float(np.mean([np.mean(u == v) for u, v in zip(ms1, ms2)]))
    agree_kp, agree_kf, agree_pf = (agree(masks, plain_masks), agree(masks, f32_masks),
                                    agree(plain_masks, f32_masks))
    shares = [float((m > 0).mean()) for m in f32_masks]
    print(f"{what}: masks agree kernel-plain {agree_kp:.6f}, kernel-f32 {agree_kf:.6f}, "
          f"plain-f32 {agree_pf:.6f} of pixels; f32 positive shares "
          f"{[round(v, 4) for v in shares]}")
    check(agree_kp >= max(MASK_AGREEMENT, agree_pf),
          f"{what}: masks kernel-plain agree on {agree_kp} < max({MASK_AGREEMENT}, "
          f"plain-f32 {agree_pf})")
    check(agree_kf >= agree_pf - MASK_SLACK,
          f"{what}: masks kernel-f32 {agree_kf} < plain-f32 {agree_pf} - {MASK_SLACK}")
    check(all(MASK_SHARE[0] <= v <= MASK_SHARE[1] for v in shares),
          f"{what}: the f32 masks are near-constant ({shares}); the mask check has no power")
    return agree_kp, agree_kf, agree_pf


def check_masks(masks, what):
    for m in masks:
        if m.shape != (2048, 2048) or not set(np.unique(m)) <= {0, 255}:
            fail(f"{what}: bad mask: shape {m.shape}, values {np.unique(m)[:8]}")


# ---------------------------------------------------------------------------
# int8 eval path (phases 7-8)
# ---------------------------------------------------------------------------


def int8_stage_agrees(what, parts, bp, sp, head, check, **kw) -> float:
    """One int8 stage call on the card against its plain version: h1 and y
    bit for bit; the output to phase 1's bar, or (a QTensor) its s8 values
    to S8_EQUAL. Returns the output's max abs error (dequantized for s8)."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8

    got, h1, y = q8.fused_eval_stage_int8(parts, bp, sp, head, intermediates=True, **kw)
    torch.cuda.synchronize()
    want, w_h1, w_y = q8.int8_stage_reference(parts, bp, sp, head, intermediates=True, **kw)
    exact = torch.equal(h1, w_h1), torch.equal(y, w_y)
    check(all(exact), f"{what}: h1 / y equal the plain version's: {exact}")
    if isinstance(want, q8.QTensor):
        d = (got.q.int() - want.q.int()).abs()
        far, same = d.max().item(), (d == 0).float().mean().item()
        ok = (isinstance(got, q8.QTensor) and got.scale == want.scale and far <= 1
              and same >= S8_EQUAL)
        print(f"{what} h1,y exact {all(exact)}; s8 out equal on {same:.6f}, at most {far} "
              f"steps apart (scale {want.scale:.5g})")
        check(ok, f"{what}: emitted s8 equal on {same}, up to {far} steps apart")
        return far * want.scale
    err, scale, l2, ok = close(got, want)
    print(f"{what} h1,y exact {all(exact)}; max_abs_err={err:.4g} rel_l2={l2:.3g} "
          f"(max|plain|={scale:.4g})")
    check(ok and got.shape == want.shape, f"{what}: kernel disagrees with plain "
          f"(err {err}, max {scale}, l2 {l2})")
    return err


def int8_stage_phase(dev, sigs, check, seams) -> float:
    """Phase 7; returns the largest output error of the int8 stage calls.
    A stage of ``seams`` ({stage: kind}) also reads its seam in s8 from a
    seeded source (an up seam's half-height tensor, a pool seam's
    full-resolution one) with dynamic and static scales (the up part at its
    ``":half"`` range), a pool seam also as a QTensor with s8 out; each
    seam read counted once."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8
    from ssunet_gan_tpu_torch.ops.blocks import BasicBlock
    from ssunet_gan_tpu_torch.ops.conv import Conv2d
    from ssunet_gan_tpu_torch.ops.spade import SPADE

    gen = torch.Generator().manual_seed(SEED + 20)
    worst = 0.0
    for name, chans, planes, lab, nh, head_cls, level in sigs:
        block = BasicBlock(sum(chans), planes, generator=gen)
        random_bn_stats(block, gen)
        spade = SPADE("spadebatch3x3", planes, lab, planes / 16, generator=gen)
        head = None
        if head_cls:
            final = Conv2d(planes, head_cls, 1, generator=gen).to(dev)
            head = (final.weight, final.bias)
        block.to(dev).eval()
        spade.to(dev)
        bp, sp = block.stage_params(), spade.stage_params()
        side = HW >> level
        parts = tuple(torch.randn((2, side, side, c), generator=gen).to(dev, torch.bfloat16)
                      for c in chans)
        what = f"phase 7: {name} parts={chans} planes={planes} {side}x{side}"
        worst = max(worst, int8_stage_agrees(f"{what} dynamic", parts, bp, sp, head, check))
        # static scales a little inside the data's range, so some values saturate
        scales = {f"{name}:{i}": 0.9 * p.float().abs().max().item() for i, p in enumerate(parts)}
        q8.set_int8_calibration(scales)
        try:
            worst = max(worst, int8_stage_agrees(f"{what} static", parts, bp, sp, head, check,
                                                 calib_key=name))
            qparts = tuple(q8.QTensor(q8.quantize_tensor(p, scales[f"{name}:{i}"])[0],
                                      scales[f"{name}:{i}"] / 127.0, torch.bfloat16)
                           for i, p in enumerate(parts))
            worst = max(worst, int8_stage_agrees(f"{what} QTensor inputs", qparts, bp, sp, head,
                                                 check, calib_key=name))
            if not head_cls:
                amax = q8.int8_stage_reference(qparts, bp, sp).float().abs().max().item()
                worst = max(worst, int8_stage_agrees(
                    f"{what} QTensor inputs, s8 out", qparts, bp, sp, head, check,
                    calib_key=name, out_abs_max=0.95 * amax))
        finally:
            q8.set_int8_calibration(None)
        kind = seams.get(name)
        if kind is not None:
            up, down = seam_flags(kind)
            src = seam_parts(parts, kind, gen, dev)
            before = s8_seam_reads()
            worst = max(worst, int8_stage_agrees(f"{what} {kind} seam, dynamic", src, bp, sp,
                                                 head, check, up=up, down=down))
            cal = {f"{name}:{i}": 0.9 * p.float().abs().max().item() for i, p in enumerate(src)}
            cal[f"{name}:1:half"] = cal.get(f"{name}:1", 0.0) * 0.95
            q8.set_int8_calibration(cal)
            try:
                worst = max(worst, int8_stage_agrees(f"{what} {kind} seam, static", src, bp, sp,
                                                     head, check, calib_key=name, up=up,
                                                     down=down))
                calls = 2
                if kind == "pool":
                    s0 = cal[f"{name}:0"]
                    qsrc = (q8.QTensor(q8.quantize_tensor(src[0], s0)[0], s0 / 127.0,
                                       torch.bfloat16),)
                    amax = q8.int8_stage_reference(qsrc, bp, sp, down=down).float().abs().max()
                    worst = max(worst, int8_stage_agrees(
                        f"{what} QTensor pool seam, s8 out", qsrc, bp, sp, head, check,
                        calib_key=name, out_abs_max=0.95 * amax.item(), down=down))
                    calls = 3
            finally:
                q8.set_int8_calibration(None)
            moved = tuple(a - b for a, b in zip(s8_seam_reads(), before))
            want = (calls, 0) if kind == "up" else (0, calls)
            check(moved == want, f"{what}: {moved} s8 up / pool seams read, expected {want}")
            del src
        del parts, qparts, block, spade
    # the deep stages' s8 block: its integer convs through the library call
    # against the f64 convs, at the widths of conv3_1 (level 3, batch 8)
    qs = tuple(torch.randint(-127, 128, (BATCH, 64, 64, 384), generator=gen).to(dev, torch.int8)
               for _ in range(2))
    ws = tuple(torch.randint(-127, 128, (384, 384, 3, 3), generator=gen).to(dev, torch.int8)
               for _ in qs)
    same = torch.equal(q8.int_conv(qs, ws, 1, library=True), q8.int_conv(qs, ws, 1))
    print(f"phase 7: deep s8 block, torch._int_mm sums equal the f64 convs': {same}")
    check(same, "phase 7: the deep block's library sums differ from the f64 convs'")
    torch.cuda.empty_cache()
    return worst


def int8_stage_bound_ms(parts, planes, labels, hidden, ncls, out_bytes, weight_bytes,
                        shortcut=True, shape=None):
    """Least time for one int8 stage call: its s8 multiply-adds (conv1,
    conv2, and the shortcut where the block has one) at the s8 tensor-core
    peak plus the tail's at the bf16 peak, or its bytes (each part as it
    arrives, s8 or bf16, a seam's source at its own size, and the weights
    read once, the output written once) over HBM bandwidth. ``shape``: the
    output's N×H×W where the parts hold a seam (default the first part's)."""
    n, h, w = shape or parts[0].shape[:3]
    cin = sum(p.shape[-1] for p in parts)
    s8_macs = 9 * cin * planes + 9 * planes * planes + (cin * planes if shortcut else 0)
    tail_macs = 9 * planes * labels + 9 * labels * hidden + 9 * hidden * 2 * planes + planes * ncls
    t_ops = 2.0 * n * h * w * (s8_macs / PEAK_S8_OPS + tail_macs / PEAK_BF16_FLOPS)
    in_bytes = sum(int(np.prod(p.shape)) * (1 if hasattr(p, "q") else 2) for p in parts)
    t_bytes = (in_bytes + weight_bytes + out_bytes) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def library_int_mm(sources, weights):
    """``torch._int_mm`` over the materialized tap operand of s8 NHWC
    sources and their OIHW weights (3×3 zero-padded, or 1×1), as
    ``int_conv``'s library route builds it (K padded to a multiple of 8):
    the GEMM alone, timed only and never called by the port."""
    import torch.nn.functional as F

    from ssunet_gan_tpu_torch.ops.stage_kernel_int8 import tap_operand

    cout, k = weights[0].shape[0], weights[0].shape[-1]
    a = tap_operand(sources, k, k // 2)
    wmat = torch.cat([wp.permute(2, 3, 1, 0).reshape(-1, cout) for wp in weights])
    pad = -a.shape[1] % 8
    a = F.pad(a, (0, pad)).contiguous()
    wmat = F.pad(wmat, (0, 0, 0, pad)).contiguous()
    return lambda: torch._int_mm(a, wmat)


def int8_quant_lines(model, x, check, phase) -> int:
    """Every one-pass quantization (``quantize_tensor``) of one int8 tile
    forward of ``x`` on the main path (batch 8): the fused stages' bf16
    parts and the deep s8 blocks' bf16 parts and f32 h1 (dynamic scale),
    each on the tensor the forward gave it, held against
    ``quantize_reference`` by ``torch.equal``, the scale included, and
    timed beside its plain version and its bound (one read of the input and
    one s8 write over HBM bandwidth). Prints ``quant:`` lines and their sum
    per forward. Returns the quantizations one forward needs, counted from
    the stages' inputs (each part that is not a QTensor, and each deep
    block's h1), independently of ``quant_launches``."""
    from ssunet_gan_tpu_torch.infer.api import tile_forward
    from ssunet_gan_tpu_torch.models import ssunet
    from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8

    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, launches=0)
    need, stage = [0], [None]  # the quantizations the stages need; (name, kind, parts)
    kernel, fused, deep = q8.quantize_tensor, ssunet.fused_eval_stage_int8, ssunet.int8_block

    def checked(t, abs_max=None):
        name, kind, parts = stage[0]
        i = next((i for i, p in enumerate(parts) if p is t), None)
        q, s = kernel(t, abs_max)
        w_q, w_s = q8.quantize_reference(t, abs_max)
        exact = torch.equal(q, w_q) and (torch.equal(s, w_s) if abs_max is None else s == w_s)
        what = "h1" if i is None else f"part {i}"
        check(exact, f"{phase}: {name} {what}: the quantization kernel differs from plain")
        ms = cuda_ms(lambda: kernel(t, abs_max), 20)
        plain_ms = cuda_ms(lambda: q8.quantize_reference(t, abs_max), 5)
        bound = t.numel() * (t.element_size() + 1) / PEAK_BYTES * 1e3
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound), ("launches", 1)):
            total[k] += v
        print("quant:", json.dumps(dict(
            stage=name, stage_kind=kind, input=what, shape=list(t.shape),
            dtype=str(t.dtype).replace("torch.", ""),
            scale="static" if abs_max is not None else "dynamic", exact=exact, ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by="bytes")))
        return q, s

    def entered(name, kind, parts, extra):
        parts = ssunet.as_parts(parts)
        stage[0] = (name, kind, parts)
        need[0] += sum(not isinstance(p, q8.QTensor) for p in parts) + extra

    def fused_stage(parts, *a, **kw):
        entered(kw["calib_key"], "fused", parts, 0)
        return fused(parts, *a, **kw)

    def deep_block(parts, *a, **kw):
        entered(kw["calib_key"], "deep", parts, 1)  # and its h1
        return deep(parts, *a, **kw)

    q8.quantize_tensor, ssunet.fused_eval_stage_int8 = checked, fused_stage
    ssunet.int8_block = deep_block
    try:
        tile_forward(model, x)
    finally:
        q8.quantize_tensor, ssunet.fused_eval_stage_int8, ssunet.int8_block = kernel, fused, deep
    check(total["launches"] == need[0],
          f"{phase}: one int8 forward quantized {total['launches']} inputs, its stages need "
          f"{need[0]}")
    print("quant:", json.dumps(dict(per="forward", **total, bound_by="bytes")))
    return need[0]


def int8_conv_launch_lines(stages, check, phase):
    """Each conv launch of the int8 stages alone on the stage's own inputs
    (``stages``: name, parts, packed stage, calibration key, whether the
    block has a shortcut; batch 8):
    launches A and B of the s8 conv core (``s8_conv1``, ``s8_conv2``,
    launch Q between them) against their per-launch plain versions by
    ``torch.equal``; each timed beside its bound (s8 multiply-adds at the
    s8 peak, or each input and the weight read and each output written
    once over HBM bandwidth) and the library time (``torch._int_mm`` over
    the materialized tap operand: launch B's 3×3 over q(h1) and shortcut as
    two GEMMs). Prints ``s8 conv:`` lines and their sum per forward. A
    stage without a shortcut (VGG) runs launch B with zero shortcut
    columns; its bound and library call count the 3×3 alone. A launch that
    reads a seam in s8 is also held bit for bit against the same launch on
    the materialized s8 seam (``read_seams_s8``), and an ``s8 seam:`` line
    gives its time beside that launch's, the plain seam read's and its
    bound (its operations, or the bytes it reads: the seam's source at its
    own size)."""
    from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8

    total = dict(ms=0.0, bound_ms=0.0, library_ms=0.0, launches=0)
    seam_total = dict(ms=0.0, bound_ms=0.0, materialized_ms=0.0, seam_plain_ms=0.0, launches=0)
    kinds = set()
    for name, parts, pk, calib_key, shortcut, (up, down) in stages:
        qparts, scales, _ = q8._quantize_parts(parts, calib_key, up=up)
        seam = dict(up=up, down=down)
        mat = q8.read_seams_s8(qparts, **seam)  # the s8 parts as the launches read them
        chans = tuple(q.shape[-1] for q in qparts)
        ops = q8._scaled_operands(pk, chans, scales, qparts[0].device)
        n, h, w = mat[0].shape[:3]
        m = n * h * w
        th = q8.band_rows(h)
        conv1, conv2 = ops["conv1"], ops["conv2"]
        cout = conv1["cout"]
        h1, rowmax = q8.s8_conv1(qparts, conv1, ops["d1"], pk["t1"], **seam)
        qh1, bandscale = q8.band_quant(h1, rowmax, th)
        y = q8.s8_conv2(qh1, bandscale, qparts, conv2, pk["d2"], ops["ds"], pk["t2"], **seam)
        torch.cuda.synchronize()
        w_h1, w_rowmax = q8.s8_conv1_reference(qparts, conv1, ops["d1"], pk["t1"], **seam)
        w_y = q8.s8_conv2_reference(qh1, bandscale, qparts, conv2, pk["d2"], ops["ds"], pk["t2"],
                                    **seam)
        qimg = qh1[:, :, 1:th + 1].reshape(n, h, w, cout)
        qbytes = sum(q.numel() for q in qparts)
        launches = [
            ("A", torch.equal(h1, w_h1) and torch.equal(rowmax, w_rowmax), conv1,
             lambda: q8.s8_conv1(qparts, conv1, ops["d1"], pk["t1"], **seam),
             lambda: q8.s8_conv1(mat, conv1, ops["d1"], pk["t1"]),
             lambda: torch.equal(h1, q8.s8_conv1(mat, conv1, ops["d1"], pk["t1"])[0]),
             [library_int_mm(mat, conv1["oihw"])],
             2.0 * m * cout * 9 * sum(chans),
             qbytes + conv1["w"].numel() + 2 * m * cout + 4 * n * h),
            ("B", torch.equal(y, w_y), conv2,
             lambda: q8.s8_conv2(qh1, bandscale, qparts, conv2, pk["d2"], ops["ds"], pk["t2"],
                                 **seam),
             lambda: q8.s8_conv2(qh1, bandscale, mat, conv2, pk["d2"], ops["ds"], pk["t2"]),
             lambda: torch.equal(y, q8.s8_conv2(qh1, bandscale, mat, conv2, pk["d2"], ops["ds"],
                                                pk["t2"])),
             ([library_int_mm(mat, conv2["oihw"][:-1])] if shortcut else [])
             + [library_int_mm((qimg,), conv2["oihw"][-1:])],
             2.0 * m * cout * (9 * cout + (sum(chans) if shortcut else 0)),
             qh1.numel() + (qbytes if shortcut else 0) + conv2["w"].numel() + 2 * m * cout),
        ]
        del w_h1, w_rowmax, w_y
        modes = q8.seam_modes(len(qparts), up, down)
        kind = seam_kind(up, down)
        for launch, exact, conv, run, run_mat, same_mat, libs, flops, nbytes in launches:
            check(exact, f"{phase}: {name} launch {launch}: the s8 conv core differs from its "
                  f"plain version")
            ms = cuda_ms(run, 20)
            lib_ms = sum(cuda_ms(f, 20) for f in libs)
            del libs
            bound, bkind = bound_of(flops, nbytes, PEAK_S8_OPS)
            kinds.add(bkind)
            for k, v in (("ms", ms), ("bound_ms", bound), ("library_ms", lib_ms), ("launches", 1)):
                total[k] += v
            print("s8 conv:", json.dumps(dict(
                path=phase, stage=name, launch=launch, shape=[n, h, w], parts=list(chans), cout=cout,
                nt=conv["nt"], nblk=conv["nblk"], exact=exact, ms=ms, bound_ms=bound,
                bound_by=bkind, library_ms=lib_ms, seam=kind)))
            if kind is not None:
                same = same_mat()
                check(same, f"{phase}: {name} launch {launch}: reading its {kind} seam in s8 "
                      f"differs from the same launch on the materialized s8 seam")
                mat_ms = cuda_ms(run_mat, 20)
                plain_ms = cuda_ms(lambda: q8.read_seams_s8(qparts, **seam), 10)
                for k, v in (("ms", ms), ("bound_ms", bound), ("materialized_ms", mat_ms),
                             ("seam_plain_ms", plain_ms), ("launches", 1)):
                    seam_total[k] += v
                print("s8 seam:", json.dumps(dict(
                    path=phase, stage=name, launch=launch, kind=kind, modes=list(modes),
                    source_shapes=[list(q.shape) for q in qparts], shape=[n, h, w],
                    bit_equal_materialized=same, ms=ms, materialized_ms=mat_ms,
                    seam_plain_ms=plain_ms, bound_ms=bound, bound_by=bkind)))
        del launches, h1, rowmax, qh1, bandscale, y, qimg, ops, mat
        torch.cuda.empty_cache()
    print("s8 conv:", json.dumps(dict(path=phase, per="forward", **total,
                                      bound_by="operations" if "operations" in kinds else "bytes",
                                      seam_launches=seam_total)))


# the decoder stages whose up part is a bilinear upsample, which records the
# abs-max of its half-height tensor under "<stage>:1:half" (the flagship's
# deeper decoders un-pool); SSUNet's decoders all upsample bilinearly
FLAGSHIP_BILINEAR = ("conv1_1", "conv0_1")
# the stages the int8 mode sends through the deep s8 block ({stage: with the
# residual}): the flagship's levels 3-5, SSUNet's conv4_0 (512 planes, a
# VGG block without a residual)
FLAGSHIP_DEEP = {s: True for s in ("conv3_0", "conv4_0", "conv5_0", "conv4_1", "conv3_1")}
SSUNET_DEEP = {"conv4_0": False}


def expected_ranges(model, bilinear) -> set:
    """The keys a calibration pass of ``model`` records, from its stage
    modules alone: each stage's parts (``"<stage>:0"``, and ``":1"`` for a
    decoder stage ``conv<l>_<k>`` with k > 0, which takes a skip and an up
    part) and the ``":half"`` key of each bilinear decoder's up part."""
    keys = set()
    for name, _ in model.named_children():
        if name.startswith("conv") and "_" in name and name[4:].replace("_", "").isdigit():
            keys.add(f"{name}:0")
            if int(name.split("_")[1]) > 0:
                keys.add(f"{name}:1")
    return keys | {f"{name}:1:half" for name in bilinear}


def int8_serving_phase(dev, card, model, sigs, check, x, scene, scene_tiles, config,
                       f32, bf16, phase, name, bilinear, deep, seams):
    """A model's int8 serving path (phase 8 for the flagship, phase 12 for
    SSUNet): calibrate, then the main path (``len(sigs)`` kernel-7 stages,
    reading the s8 up and pool seams of ``seams`` ({stage: kind}), and the
    ``deep`` s8 blocks per forward), every quantization, the forwards
    against plain and f32, each stage and s8 conv launch on its own inputs
    (a seam launch also against the same launch on the materialized s8
    seam), a profile. ``f32``: the f32 all-plain (logits, tile
    probabilities, masks); ``bf16``: the bf16 kernel path's numbers for the
    side-by-side lines; ``bilinear``: the decoders whose up part records a
    ``":half"`` range; ``deep``: {stage: residual} of the stages the s8
    block takes. Returns kernel 7's row of the ``kernels`` line, its
    max_abs_err over this phase's stage checks, and the seams its main path
    read."""
    from ssunet_gan_tpu_torch.infer.api import (
        _chunked_forward,
        _norm_consts,
        segmentation_inference,
        tile_forward,
    )
    from ssunet_gan_tpu_torch.infer.calibrate import calibrate_int8
    from ssunet_gan_tpu_torch.models import ssunet
    from ssunet_gan_tpu_torch.ops import stage_kernel, stage_kernel_int8 as q8

    t_phase = time.perf_counter()
    a, b = _norm_consts()
    xn = x.float() * a.to(dev) + b.to(dev)
    scales = calibrate_int8(model, xn.cpu().numpy(), batch_size=BATCH, device=dev)
    print(f"{phase}: {name}: {len(scales)} recorded ranges: "
          + ", ".join(f"{k} {v:.4g}" for k, v in sorted(scales.items())))
    want = expected_ranges(model, bilinear)
    check(set(scales) == want and all(np.isfinite(v) and v > 0 for v in scales.values()),
          f"{phase}: expected the {len(want)} ranges {sorted(want)} finite and positive, got "
          f"{scales}")
    per = len(sigs)
    up_per, pool_per = seams_per(seams)
    worst = 0.0
    deep_runs = []  # (stage, residual) of each deep s8 block the main path ran
    int8_block = ssunet.int8_block

    def counted_block(parts, bp, calib_key=None, residual=True):
        deep_runs.append((calib_key, residual))
        return int8_block(parts, bp, calib_key=calib_key, residual=residual)

    q8.set_int8_stage(True)
    try:
        # the main path: counts to 0, the tile forward, the scene request
        with patched(ssunet, "int8_block", counted_block):
            q8.launches = q8.conv_launches = q8.quant_launches = q8.up_reads = q8.pool_reads = 0
            bf16_before = stage_kernel.launches
            warm, iters = 2, 5
            for _ in range(warm):
                probs = tile_forward(model, x)
            settle()
            t0 = time.perf_counter()
            for _ in range(iters):
                probs = tile_forward(model, x)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            tile_launches = q8.launches
            settle()
            t0 = time.perf_counter()
            masks, _ = segmentation_inference(model, scene, scene_tiles, None, config, False)
            scene_s = time.perf_counter() - t0
            launches, conv_launches, quant_launches = (q8.launches, q8.conv_launches,
                                                       q8.quant_launches)
            reads = s8_seam_reads()
        forwards = warm + iters + 2
        check(reads == (up_per * forwards, pool_per * forwards),
              f"{phase}: {reads} s8 up and pool seams read by the {name} int8 main path, "
              f"expected {(up_per, pool_per)} per forward ({forwards} forwards)")
        check(tile_launches == per * (warm + iters) and stage_kernel.launches == bf16_before,
              f"{phase}: {tile_launches} int8 kernel stages and "
              f"{stage_kernel.launches - bf16_before} bf16 ones in {warm + iters} {name} tile "
              f"forwards, expected {per} and 0 each")
        check(launches - tile_launches == 2 * per,
              f"{phase}: the {name} scene request ran {launches - tile_launches} int8 kernel "
              f"stages, expected {2 * per}")
        check(Counter(deep_runs) == Counter({k: forwards for k in deep.items()}),
              f"{phase}: deep s8 blocks {Counter(deep_runs)}, expected {deep} once per forward "
              f"({forwards} forwards)")
        check(bool(torch.isfinite(probs.float()).all())
              and probs.shape == (BATCH, HW, HW, model.num_classes),
              f"{phase}: {name} int8 tile forward output is not finite or has the wrong shape")
        tiles_per_s = BATCH * iters / dt
        print(f"{phase}: {name} int8 tile forward {tiles_per_s:.2f} tiles/s (512x512, "
              f"calibrated int8 stages, bf16 activations, batch {BATCH}, "
              f"{dt / iters * 1e3:.2f} ms/forward, {per} kernel-7 stages and {len(deep)} deep s8 "
              f"blocks each) on {card}; bf16 in this run {bf16['tiles_per_s']:.2f} tiles/s")
        print(f"{phase}: {name} main path launches: {launches} int8 stages, {conv_launches} s8 "
              f"conv core launches, {quant_launches} one-pass quantizations "
              f"({quant_launches / forwards:g} per forward of a batch), deep s8 blocks "
              f"{dict(Counter(deep_runs))}; s8 seams read {reads[0]} up and {reads[1]} pool "
              f"({up_per} and {pool_per} per forward)")
        check(conv_launches == 2 * launches,
              f"{phase}: the s8 conv core ran {conv_launches} times for {launches} stages "
              f"(expected two each)")
        check_masks(masks, phase)
        print(f"{phase}: {name} scene 2048x2048 -> {len(masks)} masks in {scene_s:.3f} s (36 "
              f"tiles, int8) on {card}; bf16 in this run {bf16['scene_s']:.3f} s; positive share "
              f"{[round(float((m > 0).mean()), 4) for m in masks]}")
        t_phase = phase_done(f"{phase} {name} int8 main path", t_phase)

        # after the counts were read: every quantization of one more tile
        # forward against plain, and the count the main path needed
        need = int8_quant_lines(model, x, check, phase)
        check(quant_launches == need * forwards,
              f"{phase}: the quantization kernel ran {quant_launches} times on the main path, "
              f"its stages need {need} per forward ({need * forwards} in all)")
        t_phase = phase_done(f"{phase} {name} quantization checks", t_phase)

        # comparisons, after the counts were read: the same forwards with
        # every int8 stage on its plain version, and each stage's inputs kept
        sink = None  # the list that keeps each stage call of one plain forward, or None

        def plain_int8(parts, bp, sp, head=None, calib_key=None, out_abs_max=None, packed=None,
                       up=None, down=None):
            if sink is not None and len(sink) < len(sigs):
                sink.append((parts, bp, sp, head, calib_key, out_abs_max, up, down))
            return q8.int8_stage_reference(parts, bp, sp, head, calib_key, out_abs_max,
                                           up=up, down=down)

        with torch.no_grad():
            logits_k = model(xn.to(torch.bfloat16))
        probs_k = _chunked_forward(model, scene_tiles)
        kernel_stage = ssunet.fused_eval_stage_int8
        ssunet.fused_eval_stage_int8 = plain_int8
        try:
            sink = captured = []  # the tile forward's batch
            with torch.no_grad():
                logits_p = model(xn.to(torch.bfloat16))
            sink = captured_scene = []  # the scene request's first chunk, INFER_BATCH tiles
            probs_p = _chunked_forward(model, scene_tiles)
            sink = None
            plain_masks, _ = segmentation_inference(model, scene, scene_tiles, None, config,
                                                    False)
        finally:
            ssunet.fused_eval_stage_int8 = kernel_stage
        logits_f, probs_f, f32_masks = f32
        e_k, e_p, _ = forward_bar(f"{phase}: {name} int8 logits", logits_k, logits_p, logits_f,
                                  check)
        pe_k, pe_p, _ = forward_bar(f"{phase}: {name} int8 scene tile probabilities", probs_k,
                                    probs_p, probs_f, check)
        _, agree_kf, agree_pf = mask_bars(f"{phase}: {name} int8", masks, plain_masks, f32_masks,
                                          check)
        print(f"{phase}: {name} distance from the f32 all-plain forward, int8 | bf16 (kernel paths): "
              f"logits rel_l2 {e_k:.4g} | {bf16['logits']:.4g}; scene tile probabilities "
              f"{pe_k:.4g} | {bf16['probs']:.4g}; masks agree {agree_kf:.6f} | "
              f"{bf16['masks']:.6f} (int8 plain: logits {e_p:.4g}, probabilities {pe_p:.4g}, "
              f"masks {agree_pf:.6f})")
        del logits_k, logits_p, probs_k, probs_p
        t_phase = phase_done(f"{phase} {name} int8 comparisons", t_phase)

        # each int8 stage on the inputs the forward gave it (model weights,
        # batch 8): against plain, and timed against plain and its bound
        for calls in (captured, captured_scene):
            got_seams = {c[4]: seam_kind(c[6], c[7]) for c in calls
                         if seam_kind(c[6], c[7]) is not None}
            if [s[0] for s in sigs] != [c[4] for c in calls] or got_seams != seams:
                fail(f"{phase}: the {name} int8 forward's fused stages are "
                     f"{[c[4] for c in calls]} with the s8 seams {got_seams}, expected "
                     f"{[s[0] for s in sigs]} with {seams}")
        for parts, bp, sp, head, calib_key, out_amax, up, down in captured_scene:
            what = (f"{phase}: {calib_key} batch {parts[0].shape[0]} (scene chunk) model "
                    f"weights, {'s8' if out_amax is not None else 'bf16'} out"
                    + (f", {seam_kind(up, down)} seam read in s8" if up or down else ""))
            worst = max(worst, int8_stage_agrees(what, parts, bp, sp, head, check,
                                                 calib_key=calib_key, out_abs_max=out_amax,
                                                 up=up, down=down))
        del captured_scene
        ms_sum = plain_sum = bound_sum = 0.0
        kinds = set()
        tails = []
        launch_stages = []  # each stage's inputs and packed operands, for the s8 conv: lines
        for (stage, chans, planes, lab, nh, head_cls, level), call in zip(sigs, captured):
            parts, bp, sp, head, calib_key, out_amax, up, down = call
            tails += tail_calls([(stage, chans, planes, lab, nh, head_cls, level)], BATCH,
                                1 if out_amax is not None else 2)
            kw = dict(calib_key=calib_key, out_abs_max=out_amax, up=up, down=down)
            forms = ["s8" if isinstance(p, q8.QTensor) else "bf16" for p in parts]
            what = (f"{phase}: {stage} batch {BATCH} model weights, parts {forms}, "
                    f"{'s8' if out_amax is not None else 'bf16'} out"
                    + (f", {seam_kind(up, down)} seam read in s8" if up or down else ""))
            worst = max(worst, int8_stage_agrees(what, parts, bp, sp, head, check, **kw))
            block, spade = getattr(model, stage), getattr(model, "SPADE" + stage[4:])
            final = model.final if head_cls else None
            packed = ssunet._stage_operands(parts, block, spade, final, int8=True)[3]
            run = lambda: q8.fused_eval_stage_int8(parts, bp, sp, head, packed=packed, **kw)
            ref = lambda: q8.int8_stage_reference(parts, bp, sp, head, **kw)
            ms = cuda_ms(run, 10)
            plain_ms = cuda_ms(ref, 1, warmup=1)
            side = HW >> level
            shortcut = bp[4] is not None
            wbytes = sum(t.numel() for t in (bp[0], bp[2], bp[4]) if t is not None) + 5 * 4 * planes
            wbytes += sum(t.numel() * 4 for t in sp)
            out_bytes = BATCH * side * side * ((head_cls or planes) * (1 if out_amax else 2))
            bound, kind = int8_stage_bound_ms(parts, planes, lab, nh, head_cls, out_bytes, wbytes,
                                              shortcut, (BATCH, side, side))
            kinds.add(kind)
            ms_sum, plain_sum, bound_sum = ms_sum + ms, plain_sum + plain_ms, bound_sum + bound
            row = dict(model=name, stage=stage, shape=[BATCH, side, side, sum(chans)], planes=planes,
                       parts=forms, seam=seam_kind(up, down), ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=kind)
            print("int8 stage:", json.dumps(row))
            launch_stages.append((stage, parts, packed, calib_key, shortcut, (up, down)))
        del captured
        int8_conv_launch_lines(launch_stages, check, phase)
        del launch_stages
        t_phase = phase_done(f"{phase} {name} int8 per-stage checks and timing", t_phase)

        # where one int8 tile forward's device time goes
        n_prof = 3
        busy, wall_ms, rows = profile_kernels(lambda: tile_forward(model, x), n_prof)
        untraced_ms = dt / iters * 1e3
        print(f"profile: per {name} int8 forward (batch {BATCH}, mean of {n_prof}): device busy "
              f"{busy:.3f} ms, {sum(r[1] for r in rows)} kernels; {wall_ms:.3f} ms wall under "
              f"the profiler (idle share {max(0.0, 1 - busy / wall_ms):.3f}), "
              f"{untraced_ms:.3f} ms untraced (idle share "
              f"{max(0.0, 1 - busy / untraced_ms):.3f}); bf16 in this run: busy "
              f"{bf16['busy_ms']:.3f} ms, {bf16['tiles_per_s']:.2f} tiles/s against int8's "
              f"{tiles_per_s:.2f}")
        for ms, count, key in rows[:14]:
            print(f"profile: {name} int8 {ms:9.3f} ms {count:4d}x {key[:90]}")
        tail_line(f"kernel 7: {name} int8 forward", "forward", rows, tails)
        conv_profile_line(f"kernel 7: {name} int8 forward", "forward", rows, ("s8_conv_core",),
                          "s8 conv profile:")
        conv_profile_line(f"kernel 7: {name} int8 forward", "forward", rows,
                          ("q_quant_kernel", "q_absmax_kernel"), "quant profile:")
        phase_done(f"{phase} {name} int8 profile", t_phase)
    finally:
        q8.set_int8_stage(False)
        q8.set_int8_calibration(None)
    return {
        "name": "fused_eval_stage_int8", "route": "cuda",
        "source": f"ssunet_gan_tpu_torch/csrc/{q8.SOURCE}", "replaces": q8.REPLACES,
        "launches": launches, "max_abs_err": worst, "ms": ms_sum, "plain_ms": plain_sum,
        "bound_ms": bound_sum, "bound_by": "operations" if "operations" in kinds else "bytes",
        "library_ms": None, "quant_per_forward": need, "seam_reads": reads,
    }

# ---------------------------------------------------------------------------
# UNet_B_SS and UNet_R_SS serving, the bottleneck stage (phases 9-10)
# ---------------------------------------------------------------------------


def bneck_signatures(f, num_classes, input_channels):
    """(name, part channels, planes, labels, hidden, head classes, level) of
    UNet_B_SS's six fused stages, in the forward's order."""
    nh = lambda c: int(max(c / 16, 4))
    return [
        ("conv0_0", (input_channels,), f[0], num_classes, nh(f[0]), 0, 0),
        ("conv1_0", (f[0],), f[1], num_classes, nh(f[1]), 0, 1),
        ("conv2_0", (f[1],), f[2], num_classes, nh(f[2]), 0, 2),
        ("conv2_2", (f[2], f[3]), f[2], num_classes, nh(f[2]), 0, 2),
        ("conv1_3", (f[1], f[2]), f[1], num_classes, nh(f[1]), 0, 1),
        ("conv0_4", (f[0], f[1]), f[0], num_classes, nh(f[0]), num_classes, 0),
    ]


def spade_macs(planes, labels, hidden):
    """Multiply-adds per pixel of the self-SPADE's three 3×3 convs."""
    return 9 * planes * labels + 9 * labels * hidden + 9 * hidden * 2 * planes


def bneck_bound_ms(parts, planes, labels, hidden, ncls, weight_bytes, identity, shape=None):
    """Least time for one bottleneck stage call: its multiply-adds at the
    bf16 tensor-core peak, or its bytes (inputs and weights read once, the
    output written once) over HBM bandwidth. ``shape``: the output's N×H×W
    where the parts hold a seam (default the first part's)."""
    n, h, w = shape or parts[0].shape[:3]
    cin = sum(p.shape[-1] for p in parts)
    macs = (cin * planes + 9 * planes * planes + planes * planes
            + (0 if identity else cin * planes) + spade_macs(planes, labels, hidden)
            + planes * ncls)
    nbytes = (sum(p.numel() * p.element_size() for p in parts) + weight_bytes
              + n * h * w * (ncls or planes) * 2)
    return bound_of(2.0 * macs * n * h * w, nbytes)


def plain_bneck(parts, bp, sp, head=None, packed=None, up=None):
    """Kernel 8's plain version, with its wrapper's signature."""
    from ssunet_gan_tpu_torch.ops import stage_kernel, stage_kernel_bneck as kb

    return kb.fused_bneck_reference(stage_kernel.materialize_seams(parts, up), bp, sp, head)


def materialized_bneck(parts, bp, sp, head=None, packed=None, up=None):
    """Kernel 8 on the stage's up seams materialized in plain PyTorch."""
    from ssunet_gan_tpu_torch.ops import stage_kernel, stage_kernel_bneck as kb

    return kb.fused_eval_stage_bneck(stage_kernel.materialize_seams(parts, up), bp, sp, head,
                                     packed)


def bneck_stage_phase(dev, model, sigs, scene_tiles, check):
    """Phase 9; returns kernel 8's row of the ``kernels`` line without its
    launches. The up seams of ``BNECK_SEAMS`` are read in the kernel (from
    a seeded half-height source, then the forward's own) and held bit for
    bit against kernel 8 on the materialized seam besides the plain
    version's bar."""
    from ssunet_gan_tpu_torch.infer.api import INFER_BATCH, _norm_consts
    from ssunet_gan_tpu_torch.models import ssunet
    from ssunet_gan_tpu_torch.ops import stage_kernel, stage_kernel_bneck as kb
    from ssunet_gan_tpu_torch.ops.blocks import Bottleneck
    from ssunet_gan_tpu_torch.ops.conv import Conv2d
    from ssunet_gan_tpu_torch.ops.spade import SPADE

    gen = torch.Generator().manual_seed(SEED + 30)
    worst = 0.0
    identity = ("identity", (sigs[1][2],), sigs[1][2], sigs[1][3], sigs[1][4], 0, 1)
    for name, chans, planes, lab, nh, head_cls, level in sigs + [identity]:
        block = Bottleneck(sum(chans), planes, generator=gen)
        check((block.shortcut is None) == (name == "identity"),
              f"phase 9: {name}: unexpected shortcut kind")
        random_bn_stats(block, gen)
        spade = SPADE("spadebatch3x3", planes, lab, planes / 16, generator=gen)
        head = None
        if head_cls:
            final = Conv2d(planes, head_cls, 1, generator=gen).to(dev)
            head = (final.weight, final.bias)
        block.to(dev).eval()
        spade.to(dev)
        side = HW >> level
        parts = tuple(torch.randn((2, side, side, c), generator=gen).to(dev, torch.bfloat16)
                      for c in chans)
        bp, sp = block.stage_params(), spade.stage_params()
        kind = BNECK_SEAMS.get(name)
        up = seam_flags(kind)[0]
        src = seam_parts(parts, kind, gen, dev)
        parts = stage_kernel.materialize_seams(src, up)
        got = kb.fused_eval_stage_bneck(src, bp, sp, head, up=up)
        torch.cuda.synchronize()
        want = kb.fused_bneck_reference(parts, bp, sp, head)
        err, scale, l2, ok = close(got, want)
        print(f"phase 9: {name} parts={chans} planes={planes} {side}x{side} "
              f"max_abs_err={err:.4g} max_rel_err={err / max(scale, 1e-30):.4g} "
              f"rel_l2={l2:.3g} (max|plain|={scale:.4g})")
        check(ok and got.shape == want.shape,
              f"phase 9: {name}: kernel disagrees with plain (err {err}, max {scale}, l2 {l2})")
        if kind is not None:
            same = torch.equal(got, kb.fused_eval_stage_bneck(parts, bp, sp, head))
            print(f"phase 9: {name} batch 2: up seam read in the kernel, bit-equal to the "
                  f"materialized seam: {same}")
            check(same, f"phase 9: {name}: kernel 8 reading its up seam differs from kernel 8 "
                  f"on the materialized seam")
        worst = max(worst, err)
        del parts, src, got, want, block, spade

    # the model's weights and each stage's own inputs, from an all-plain
    # forward over the scene's first chunk: checked at the scene request's
    # batch (INFER_BATCH), timed at the tile forward's (BATCH)
    captured = []

    def capture(parts, bp, sp, head=None, packed=None, up=None):
        captured.append((tuple(p.clone() for p in parts), up))
        return plain_bneck(parts, bp, sp, head, up=up)

    a, b = _norm_consts()
    chunk = torch.from_numpy(scene_tiles[:INFER_BATCH]).to(dev).float() * a.to(dev) + b.to(dev)
    with patched(ssunet, "fused_eval_stage_bneck", capture), torch.no_grad():
        model(chunk.to(torch.bfloat16))
    del chunk
    got_seams = {s[0]: "up" for s, (_, u) in zip(sigs, captured) if any(u or ())}
    if ([tuple(p.shape[-1] for p in c) for c, _ in captured] != [s[1] for s in sigs]
            or got_seams != BNECK_SEAMS):
        fail(f"phase 9: the forward's bottleneck stages are not the expected six with the "
             f"seams {BNECK_SEAMS}: {[[tuple(p.shape) for p in c] for c, _ in captured]}, "
             f"seams {got_seams}")
    ms_sum = plain_sum = bound_sum = 0.0
    kinds = set()
    conv_launches = []  # each stage's conv launches at batch 8 (conv: lines)
    for (name, chans, planes, lab, nh, head_cls, level), (full, up) in zip(sigs, captured):
        side = HW >> level
        modes = stage_kernel.seam_modes(len(full), up)
        block, spade = getattr(model, name), getattr(model, "SPADE" + name[4:])
        head = (model.final.weight, model.final.bias) if head_cls else None
        bp, sp = block.stage_params(), spade.stage_params()
        pk = kb.pack_stage_bneck(chans, bp, sp, head, torch.bfloat16)
        got = kb.fused_eval_stage_bneck(full, bp, sp, head, pk, up=up)
        err, scale, l2, ok = close(got, plain_bneck(full, bp, sp, head, up=up))
        print(f"phase 9: {name} batch {INFER_BATCH} model weights max_abs_err={err:.4g} "
              f"rel_l2={l2:.3g} (max|plain|={scale:.4g})"
              + (", up seam read in the kernel" if any(modes) else ""))
        check(ok, f"phase 9: {name} at batch {INFER_BATCH}: kernel disagrees with plain "
              f"(err {err}, max {scale}, l2 {l2})")
        if any(modes):
            check(torch.equal(got, materialized_bneck(full, bp, sp, head, pk, up)),
                  f"phase 9: {name} at batch {INFER_BATCH}: kernel 8 reading its up seam "
                  f"differs from kernel 8 on the materialized seam")
        del got
        worst = max(worst, err)
        parts = tuple(p[:BATCH] for p in full)
        ms = cuda_ms(lambda: kb.fused_eval_stage_bneck(parts, bp, sp, head, pk, up=up), 10)
        plain_ms = cuda_ms(lambda: plain_bneck(parts, bp, sp, head, up=up), 3, warmup=1)
        wbytes = sum(t.numel() * 2 for t in (bp[0], bp[2], bp[4], bp[6]) if t is not None)
        wbytes += sum(t.numel() * 4 for t in sp)
        bound, kind = bneck_bound_ms(parts, planes, lab, nh, head_cls, wbytes, bp[6] is None,
                                     shape=(BATCH, side, side))
        kinds.add(kind)
        ms_sum, plain_sum, bound_sum = ms_sum + ms, plain_sum + plain_ms, bound_sum + bound
        row = dict(stage=name, shape=[BATCH, side, side, sum(chans)], planes=planes,
                   seam="up" if any(modes) else None, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=kind)
        print("bneck stage:", json.dumps(row))
        if any(modes):
            print("seam:", json.dumps(dict(
                model="UNet_B_SS", stage=name, kind="up", source=list(parts[1].shape),
                stage_ms=ms, stage_ms_materialized=cuda_ms(
                    lambda: materialized_bneck(parts, bp, sp, head, pk, up), 10),
                seam_plain_ms=cuda_ms(lambda: stage_kernel.materialize_seams(parts, up), 10))))
        h1 = stage_kernel.eval_conv(parts, pk["conv1"], modes)
        h2 = stage_kernel.eval_conv((h1,), pk["conv2"])
        conv_launches += [(name, "conv1", parts, pk["conv1"], modes),
                          (name, "conv2", (h1,), pk["conv2"], None),
                          (name, "conv3", (h2,) + parts, pk["conv3"], (0,) + modes)]
    worst = max(worst, conv_launch_lines("kernel 8", conv_launches, check))
    del captured, full, parts, pk, h1, h2, conv_launches
    torch.cuda.empty_cache()
    return {
        "name": "fused_eval_stage_bneck", "route": "cuda",
        "source": f"ssunet_gan_tpu_torch/csrc/{kb.SOURCE}", "replaces": kb.REPLACES,
        "max_abs_err": worst, "ms": ms_sum, "plain_ms": plain_sum, "bound_ms": bound_sum,
        "bound_by": "operations" if "operations" in kinds else "bytes", "library_ms": None,
    }


def bneck_serving_phase(dev, card, model, sigs, x, scene, scene_tiles, config, check) -> int:
    """Phase 10 for UNet_B_SS; returns kernel 8's launches on this main path."""
    from ssunet_gan_tpu_torch.infer.api import (
        _chunked_forward,
        _norm_consts,
        segmentation_inference,
        tile_forward,
    )
    from ssunet_gan_tpu_torch.models import ssunet
    from ssunet_gan_tpu_torch.ops import stage_kernel, stage_kernel_bneck as kb

    t_phase = time.perf_counter()
    ncls = model.num_classes
    up_per = seams_per(BNECK_SEAMS)[0]
    # the main path: counts to 0, the tile forward, the scene request
    kb.launches = stage_kernel.up_reads = stage_kernel.pool_reads = 0
    other_before = stage_kernel.launches
    warm, iters = 2, 5
    for _ in range(warm):
        probs = tile_forward(model, x)
    settle()
    enqueue = []  # host time of each forward's enqueue, no synchronization
    t0 = time.perf_counter()
    for _ in range(iters):
        t1 = time.perf_counter()
        probs = tile_forward(model, x)
        enqueue.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if kb.launches != 6 * (warm + iters) or stage_kernel.launches != other_before:
        fail(f"phase 10: expected {6 * (warm + iters)} bottleneck kernel stages and no "
             f"BasicBlock one, counted {kb.launches} and {stage_kernel.launches - other_before}")
    if not torch.isfinite(probs.float()).all() or probs.shape != (BATCH, HW, HW, ncls):
        fail("phase 10: UNet_B_SS tile forward output is not finite or has the wrong shape")
    print(f"phase 10: UNet_B_SS tile forward {BATCH * iters / dt:.2f} tiles/s (512x512 bf16, "
          f"batch {BATCH}, {dt / iters * 1e3:.2f} ms/forward) on {card}")
    print(f"phase 10: host ms to enqueue each timed forward {[round(v, 2) for v in enqueue]}")
    forwards = warm + iters
    settle()
    t0 = time.perf_counter()
    masks, _ = segmentation_inference(model, scene, scene_tiles, None, config, False)
    scene_s = time.perf_counter() - t0
    launches = kb.launches
    if launches != 6 * forwards + 12:
        fail(f"phase 10: the scene request ran {launches - 6 * forwards} bottleneck "
             f"kernel stages, expected 12")
    reads = seam_reads()
    check(reads == (up_per * (forwards + 2), 0),
          f"phase 10: {reads} up and pool seams read by the UNet_B_SS main path, expected "
          f"{(up_per, 0)} per forward")
    print(f"phase 10: UNet_B_SS main path read {reads[0]} up seams in kernel 8 ({up_per} per "
          f"forward) and {reads[1]} pool seams")
    check_masks(masks, "phase 10")
    print(f"phase 10: UNet_B_SS scene 2048x2048 -> {len(masks)} masks in {scene_s:.3f} s "
          f"(36 tiles, bf16) on {card}; positive share "
          f"{[round(float((m > 0).mean()), 4) for m in masks]}")
    t_phase = phase_done("phase 10 main path", t_phase)

    # comparisons, after the counts were read: every bottleneck stage on its
    # plain version (bf16), and the f32 forward, which the gate sends to the
    # module composition
    a, b = _norm_consts()
    xn = x.float() * a.to(dev) + b.to(dev)
    with torch.no_grad():
        logits_k = model(xn.to(torch.bfloat16))
    probs_k = _chunked_forward(model, scene_tiles)
    with patched(ssunet, "fused_eval_stage_bneck", plain_bneck), torch.no_grad():
        logits_p = model(xn.to(torch.bfloat16))
        probs_p = _chunked_forward(model, scene_tiles)
        plain_masks, _ = segmentation_inference(model, scene, scene_tiles, None, config, False)
    before = kb.launches
    with fused_stages_off(), torch.no_grad():
        logits_f = model(xn)
        probs_f = _chunked_forward(model, scene_tiles, torch.float32)
        f32_masks, _ = segmentation_inference(model, scene, scene_tiles, None, config, False,
                                              dtype=torch.float32)
    check(kb.launches == before, "phase 10: an f32 forward launched the bf16 kernel")
    forward_bar("phase 10: UNet_B_SS logits", logits_k, logits_p, logits_f, check)
    forward_bar("phase 10: UNet_B_SS scene tile probabilities", probs_k, probs_p, probs_f, check)
    mask_bars("phase 10: UNet_B_SS", masks, plain_masks, f32_masks, check)
    seams_materialized("phase 10: UNet_B_SS", model, xn, scene_tiles, logits_k, probs_k,
                       ssunet, "fused_eval_stage_bneck", materialized_bneck, check)
    del logits_k, logits_p, logits_f, probs_k, probs_p, probs_f, xn
    torch.cuda.empty_cache()
    t_phase = phase_done("phase 10 comparisons", t_phase)

    n_prof = 3
    busy, wall_ms, rows = profile_kernels(lambda: tile_forward(model, x), n_prof)
    untraced_ms = dt / iters * 1e3
    print(f"profile: per UNet_B_SS forward (batch {BATCH}, mean of {n_prof}): device busy "
          f"{busy:.3f} ms, {sum(r[1] for r in rows)} kernels; {wall_ms:.3f} ms wall under "
          f"the profiler (idle share {max(0.0, 1 - busy / wall_ms):.3f}), "
          f"{untraced_ms:.3f} ms untraced (idle share "
          f"{max(0.0, 1 - busy / untraced_ms):.3f})")
    for ms, count, key in rows[:12]:
        print(f"profile: UNet_B_SS {ms:9.3f} ms {count:4d}x {key[:90]}")
    tail_line("kernel 8: UNet_B_SS bf16 forward", "forward", rows, tail_calls(sigs, BATCH))
    conv_profile_line("kernel 8: UNet_B_SS bf16 forward", "forward", rows)
    phase_done("phase 10 profile", t_phase)
    return launches, reads


def rss_forward_phase(dev, card, cfg, x, calib, check) -> None:
    """Phase 10's second model: UNet_R_SS at full width through the tile
    forward, six stages of the BasicBlock eval kernel per forward, logits
    against the all-plain forwards in bf16 and f32."""
    from ssunet_gan_tpu_torch.infer.api import _norm_consts, tile_forward
    from ssunet_gan_tpu_torch.models import build_model, ssunet
    from ssunet_gan_tpu_torch.ops import stage_kernel, stage_kernel_bneck as kb

    t_phase = time.perf_counter()
    model = build_model("UNet_R_SS", cfg["num_classes"], cfg["input_channels"], seed=SEED,
                        device=dev)
    calibrate_batchnorm(model, calib)
    before, bneck_before, reads_before = stage_kernel.launches, kb.launches, seam_reads()
    warm, iters = 1, 3
    for _ in range(warm):
        probs = tile_forward(model, x)
    settle()
    t0 = time.perf_counter()
    for _ in range(iters):
        probs = tile_forward(model, x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ran = stage_kernel.launches - before
    if ran != 6 * (warm + iters) or kb.launches != bneck_before:
        fail(f"phase 10: UNet_R_SS ran {ran} kernel stages in {warm + iters} forwards, "
             f"expected 6 each (and {kb.launches - bneck_before} bottleneck ones, expected 0)")
    if not torch.isfinite(probs.float()).all() or probs.shape != (BATCH, HW, HW, model.num_classes):
        fail("phase 10: UNet_R_SS tile forward output is not finite or has the wrong shape")
    reads = [a - b for a, b in zip(seam_reads(), reads_before)]
    check(reads == [v * (warm + iters) for v in RSS_SEAMS_PER],
          f"phase 10: UNet_R_SS read {reads} up and pool seams in {warm + iters} forwards, "
          f"expected {RSS_SEAMS_PER} each")
    print(f"phase 10: UNet_R_SS read {reads[0]} up and {reads[1]} pool seams in kernel 1 "
          f"({RSS_SEAMS_PER} per forward)")
    print(f"phase 10: UNet_R_SS tile forward {BATCH * iters / dt:.2f} tiles/s (512x512 bf16, "
          f"batch {BATCH}, {dt / iters * 1e3:.2f} ms/forward, six kernel stages each) on {card}")
    a, b = _norm_consts()
    xn = x.float() * a.to(dev) + b.to(dev)
    with torch.no_grad():
        logits_k = model(xn.to(torch.bfloat16))
        with patched(ssunet, "fused_eval_stage", plain_stage):
            logits_p = model(xn.to(torch.bfloat16))
            logits_f = model(xn)
    forward_bar("phase 10: UNet_R_SS logits", logits_k, logits_p, logits_f, check)
    seams_materialized("phase 10: UNet_R_SS", model, xn, None, logits_k, None, ssunet,
                       "fused_eval_stage", materialized_stage, check, probs=False)
    del model, logits_k, logits_p, logits_f
    torch.cuda.empty_cache()
    phase_done("phase 10 UNet_R_SS", t_phase)


# ---------------------------------------------------------------------------
# The standalone self-SPADE stage and UNet_B_SS's trainer (phase 11)
# ---------------------------------------------------------------------------


def spade_call_agrees(what, x, params, check) -> float:
    """One fused self-SPADE call on the card against its plain version, to
    phase 1's bar; returns the max abs error."""
    from ssunet_gan_tpu_torch.ops import spade_kernel as sk

    got = sk.fused_spade_stage(x, *params)
    torch.cuda.synchronize()
    want = sk.self_spade_reference(x, params)
    err, scale, l2, ok = close(got, want)
    print(f"{what} max_abs_err={err:.4g} rel_l2={l2:.3g} (max|plain|={scale:.4g})")
    check(ok and got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: kernel disagrees with plain (err {err}, max {scale}, l2 {l2})")
    return err


def spade_phase(dev, card, cfg, sigs, check):
    """Phase 11; returns kernel 9's row of the ``kernels`` line."""
    from ssunet_gan_tpu_torch.models import build_model
    from ssunet_gan_tpu_torch.ops import spade_kernel as sk
    from ssunet_gan_tpu_torch.ops.spade import SPADE

    t_phase = time.perf_counter()
    ncls, in_ch = cfg["num_classes"], cfg["input_channels"]
    gen = torch.Generator().manual_seed(SEED + 40)
    worst = 0.0
    # the six level-0-2 activations, batch 2, seeded: forward against plain,
    # backward against autograd of the plain composition on the same inputs
    for name, _, planes, lab, nh, _, level in sigs:
        side = HW >> level
        spade = SPADE("spadebatch3x3", planes, lab, planes / 16, generator=gen).to(dev)
        params = spade.stage_params()
        x = torch.randn((2, side, side, planes), generator=gen).to(dev, torch.bfloat16)
        cot = torch.randn((2, side, side, planes), generator=gen).to(dev, torch.bfloat16)
        what = f"phase 11: SPADE{name[4:]} {planes} channels {side}x{side} batch 2"
        with torch.no_grad():
            worst = max(worst, spade_call_agrees(what, x, params, check))
        xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
        grads = torch.autograd.grad(sk.fused_spade_stage(xk, *params), [xk, *params], cot)
        plain = torch.autograd.grad(sk.self_spade_composition(xp, *params), [xp, *params], cot)
        torch.cuda.synchronize()
        l2s = [rel_l2(g, p) for g, p in zip(grads, plain)]
        oks = [close(g, p)[3] and g.shape == p.shape for g, p in zip(grads, plain)]
        print(f"{what} backward: rel_l2 from autograd of the plain composition, x and the "
              f"eight parameters: {[float(f'{v:.3g}') for v in l2s]}")
        check(all(oks), f"{what}: backward disagrees with the plain composition's: {l2s}")
        del x, cot, xk, xp, grads, plain, spade
    torch.cuda.empty_cache()
    # the tail alone at SSUNet's hidden widths, beyond the flagship's 4-16:
    # 512², batch 8, seeded weights and inputs, to phase 1's bar
    cgen = torch.Generator(device=dev).manual_seed(SEED + 41)
    for planes, nh in WIDE_TAILS:
        spade = SPADE("spadebatch3x3", planes, 3, float(nh), generator=gen).to(dev)
        params = spade.stage_params()
        x = torch.randn((BATCH, HW, HW, planes), generator=cgen, device=dev).to(torch.bfloat16)
        what = f"phase 11: the tail alone, {planes} channels, hidden {nh}, {HW}x{HW} batch {BATCH}"
        with torch.no_grad():
            spade_call_agrees(what, x, params, check)
            ms = cuda_ms(lambda: sk.fused_spade_stage(x, *params), 5)
        bound, kind = bound_of(2.0 * spade_macs(planes, 3, nh) * x.numel() / planes,
                               2 * x.numel() * 2)
        row = dict(path=f"the tail alone, {planes} channels, hidden {nh}", per="call", ms=ms,
                   launches=1, bound_ms=bound, bound_by=kind)
        print("tail:", json.dumps(row))
        del x, spade, params
    torch.cuda.empty_cache()
    t_phase = phase_done("phase 11 kernel checks", t_phase)

    # UNet_B_SS's trainer, the mode "pallas": the main path of kernel 9
    tmodel = build_model("UNet_B_SS", ncls, in_ch, cfg["deep_supervision"], seed=SEED,
                         device=dev)
    row = pallas_trainer_phase(dev, card, cfg, tmodel, "UNet_B_SS", "phase 11", check,
                               off_steps=SPADE_OFF_STEPS)
    del tmodel
    torch.cuda.empty_cache()
    row["max_abs_err"] = max(row["max_abs_err"], worst)
    del row["per_step"]
    return row


def pallas_trainer_phase(dev, card, cfg, model, name, phase, check, off_steps=0) -> dict:
    """``model``'s trainer at 512², batch 8, with ``set_fused_spade("pallas")``
    (the main path of kernel 9): SPADE_WARM warm-up and SPADE_STEPS timed
    steps through ``train_one_epoch``, one kernel launch per step for each
    SPADE the gate takes; ``off_steps`` steps with the mode off timed beside
    them (a record); a profile of one step; then each of that step's calls
    on its own inputs against plain, timed against plain and its bound. The
    mode is restored after. Returns kernel 9's row of the ``kernels`` line,
    and ``per_step``, the SPADEs the gate takes."""
    from ssunet_gan_tpu_torch.data.dataset import SyntheticDataset
    from ssunet_gan_tpu_torch.data.loader import BatchLoader
    from ssunet_gan_tpu_torch.data.transforms import val_transform
    from ssunet_gan_tpu_torch.ops import spade as spade_mod
    from ssunet_gan_tpu_torch.ops import spade_kernel as sk
    from ssunet_gan_tpu_torch.ops.losses import get_loss
    from ssunet_gan_tpu_torch.ops.spade import SPADE
    from ssunet_gan_tpu_torch.train.optim import build_optimizer, build_scheduler
    from ssunet_gan_tpu_torch.train.step import make_train_step
    from ssunet_gan_tpu_torch.train.supervised import train_one_epoch

    t_phase = time.perf_counter()
    ncls, in_ch = cfg["num_classes"], cfg["input_channels"]

    def loader(n_steps, seed):
        ds = SyntheticDataset(n_steps * TRAIN_BATCH, HW, HW, ncls, in_ch,
                              transform=val_transform(cfg), seed=seed)
        return BatchLoader(ds, TRAIN_BATCH, shuffle=False, drop_last=True,
                           num_workers=int(cfg["num_workers"]))

    model.train()
    step = make_train_step(model, get_loss(cfg["loss"]), build_optimizer(model.parameters(), cfg),
                           ncls, cfg["deep_supervision"], clip=float(cfg["clip"]))
    lr = build_scheduler(cfg).lr(0)
    # one launch per step for each SPADE whose self-SPADE the gate takes
    per_step = sum(
        sk.fused_spade_supported(
            torch.empty((1, 1, 1, m.x2map.weight.shape[1]), dtype=torch.bfloat16, device=dev),
            m.ks, m.label_nc, m.nhidden)
        for m in model.modules() if isinstance(m, SPADE))
    mode_before = sk._FUSED
    try:
        sk.set_fused_spade("pallas")
        sk.launches = 0
        warm_log = train_one_epoch(0, cfg, loader(SPADE_WARM, seed=1), step, lr, device=dev)
        check(sk.launches == per_step * SPADE_WARM,
              f"{phase}: {sk.launches} self-SPADE launches in {SPADE_WARM} warm-up steps, "
              f"expected {per_step} each")
        settle()
        t1 = time.perf_counter()
        log = train_one_epoch(1, cfg, loader(SPADE_STEPS, seed=2), step, lr, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launches = sk.launches
        steps = SPADE_WARM + SPADE_STEPS
        print(f"{phase}: {name} self-SPADE kernel launches in {steps} steps: {launches} "
              f"(expected {steps} x {per_step})")
        check(launches == per_step * steps,
              f"{phase}: {name} launches {launches} != {steps} x {per_step}")
        finite = all(np.isfinite(v) for lg in (warm_log, log)
                     for k, v in lg.items() if k != "images_per_sec")
        check(finite, f"{phase}: metrics not finite: {warm_log} {log}")
        ms_step = dt / SPADE_STEPS * 1e3
        print(f"{phase}: {name} train step, fused self-SPADE {ms_step:.2f} ms/step, "
              f"{TRAIN_BATCH * SPADE_STEPS / dt:.2f} images/s (512x512 bf16, batch "
              f"{TRAIN_BATCH}, Adam, {SPADE_STEPS} steps after {SPADE_WARM} warm-up, {per_step} "
              f"kernel-9 launches per step) on {card}; warm-up epoch {warm_log}; timed epoch {log}")
        t_phase = phase_done(f"{phase} {name} trainer (fused self-SPADE)", t_phase)

        if off_steps:  # the mode off beside it in the same call: a record, not a claim
            sk.set_fused_spade("off")
            train_one_epoch(2, cfg, loader(1, seed=3), step, lr, device=dev)
            settle()
            t1 = time.perf_counter()
            off_log = train_one_epoch(3, cfg, loader(off_steps, seed=4), step, lr, device=dev)
            torch.cuda.synchronize()
            off_dt = time.perf_counter() - t1
            check(sk.launches == launches,
                  f"{phase}: the mode off launched the self-SPADE kernel")
            print(f"{phase}: {name} train step, SPADE composition (mode off, record) "
                  f"{off_dt / off_steps * 1e3:.2f} ms/step, "
                  f"{TRAIN_BATCH * off_steps / off_dt:.2f} images/s ({off_steps} steps "
                  f"after 1 warm-up) on {card}; epoch {off_log}")
            t_phase = phase_done(f"{phase} {name} trainer (mode off)", t_phase)

        # one step's calls on their own inputs: against plain, and timed
        sk.set_fused_spade("pallas")
        _, img, mask, _ = next(iter(loader(1, seed=5)))
        xb = torch.from_numpy(img).to(dev).to(torch.bfloat16)
        yb = torch.from_numpy(mask).to(dev)
        calls = []

        def capture(x, *params):
            calls.append((x.detach(), tuple(p.detach() for p in params)))
            return sk.fused_spade_stage(x, *params)

        with patched(spade_mod, "fused_spade_stage", capture):
            step(xb, yb, lr)
        torch.cuda.synchronize()
        # where one train step's device time goes
        rows = print_profile(f"{name}, fused self-SPADE", lambda: step(xb, yb, lr), ms_step)
        tail_line(f"kernel 9: {name} train step (\"pallas\")", "step", rows,
                  [(*x.shape, p[0].shape[0], p[2].shape[0], 0, 2, False) for x, p in calls])
    finally:
        sk.set_fused_spade(mode_before)
    if len(calls) != per_step or any(x.shape[0] != TRAIN_BATCH for x, _ in calls):
        fail(f"{phase}: the step's self-SPADE calls are {[tuple(c[0].shape) for c in calls]}, "
             f"expected {per_step} at batch {TRAIN_BATCH}")
    ms_sum = plain_sum = bound_sum = worst = 0.0
    kinds = set()
    for x, params in calls:
        planes, lab, nh = x.shape[-1], params[0].shape[0], params[2].shape[0]
        what = (f"{phase}: {name}'s self-SPADE of {planes} channels (hidden {nh}) at "
                f"{x.shape[1]}x{x.shape[2]}, batch {TRAIN_BATCH}, on the step's own input")
        with torch.no_grad():
            worst = max(worst, spade_call_agrees(what, x, params, check))
            ms = cuda_ms(lambda: sk.fused_spade_stage(x, *params), 10)
            plain_ms = cuda_ms(lambda: sk.self_spade_reference(x, params), 3, warmup=1)
        nbytes = 2 * x.numel() * 2 + sum(p.numel() * 4 for p in params)
        bound, kind = bound_of(2.0 * spade_macs(planes, lab, nh) * x.numel() / planes, nbytes)
        kinds.add(kind)
        ms_sum, plain_sum, bound_sum = ms_sum + ms, plain_sum + plain_ms, bound_sum + bound
        row = dict(model=name, stage=f"SPADE {planes} channels", shape=list(x.shape), hidden=nh,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=kind)
        print("spade stage:", json.dumps(row))
    del calls, step, xb, yb
    torch.cuda.empty_cache()
    phase_done(f"{phase} {name} per-call checks and timing", t_phase)
    return {
        "name": "fused_spade_stage", "route": "cuda",
        "source": f"ssunet_gan_tpu_torch/csrc/{sk.SOURCE}", "replaces": sk.REPLACES,
        "launches": launches, "max_abs_err": worst, "ms": ms_sum, "plain_ms": plain_sum,
        "bound_ms": bound_sum, "bound_by": "operations" if "operations" in kinds else "bytes",
        "library_ms": None, "per_step": per_step,
    }


# ---------------------------------------------------------------------------
# SSUNet (phase 12) and the training entry point (phase 13)
# ---------------------------------------------------------------------------

# the training entry point (phase 13): synthetic train scenes (two steps of
# batch 8 per epoch) and the PNG tree of the CLI run (train / val / test)
ENTRY_SYNTHETIC, ENTRY_EPOCHS = 16, 2
CLI_SPLITS = (("training", 16), ("validation", 4), ("test", 4))


def ssunet_signatures(f, num_classes, input_channels):
    """(name, part channels, planes, labels, hidden, head classes, level)
    of SSUNet's eight fused VGG stages, in the forward's order (conv4_0, 512
    planes, runs the composition)."""
    nh = lambda c: int(max(c / 4, 4))
    return [
        ("conv0_0", (input_channels,), f[0], num_classes, nh(f[0]), 0, 0),
        ("conv1_0", (f[0],), f[1], num_classes, nh(f[1]), 0, 1),
        ("conv2_0", (f[1],), f[2], num_classes, nh(f[2]), 0, 2),
        ("conv3_0", (f[2],), f[3], num_classes, nh(f[3]), 0, 3),
        ("conv3_1", (f[3], f[4]), f[3], num_classes, nh(f[3]), 0, 3),
        ("conv2_2", (f[2], f[3]), f[2], num_classes, nh(f[2]), 0, 2),
        ("conv1_3", (f[1], f[2]), f[1], num_classes, nh(f[1]), 0, 1),
        ("conv0_4", (f[0], f[1]), f[0], num_classes, nh(f[0]), num_classes, 0),
    ]


def ssunet_phase(dev, card, cfg, calib, x, scene, scene_tiles, config, check):
    """Phase 12: SSUNet at full width through the phases the flagship runs
    (1-3, 8, and 11's trainer). Returns {kernel: (launches, max abs
    error)} for kernels 1, 7 and 9 on its main paths."""
    from ssunet_gan_tpu_torch.models import build_model
    from ssunet_gan_tpu_torch.ops import stage_kernel
    from ssunet_gan_tpu_torch.ops.blocks import VGGBlock

    t_phase = time.perf_counter()
    ncls, in_ch = cfg["num_classes"], cfg["input_channels"]
    model = build_model("SSUNet", ncls, in_ch, seed=SEED, device=dev)
    calibrate_batchnorm(model, calib)
    center_head(model, calib)
    sigs = ssunet_signatures(model.filters, ncls, in_ch)
    check(model.conv4_0.planes > stage_kernel.MAX_PLANES,
          "phase 12: conv4_0 was expected past the fused stage's planes")
    gen = torch.Generator().manual_seed(SEED + 50)
    seeded = seeded_stage_phase(dev, sigs, VGGBlock, gen, "phase 12", check, int8=True,
                                seams=SSUNET_SEAMS)
    t_phase = phase_done("phase 12 VGG stages, seeded", t_phase)
    stages = model_stage_phase(dev, model, sigs, scene_tiles, "phase 12", "SSUNet", check,
                               SSUNET_SEAMS)
    phase_done("phase 12 VGG stages, model weights", t_phase)

    serve = bf16_serving_phase(dev, card, model, sigs, x, scene, scene_tiles, config, check,
                               "SSUNet", ("phase 12", "phase 12"), SSUNET_SEAMS)
    with no_seam_reads("phase 12: SSUNet int8", check):
        int8_row = int8_serving_phase(
            dev, card, model, sigs, check, x, scene, scene_tiles, config, serve.pop("f32"),
            serve, "phase 12", "SSUNet", [s[0] for s in sigs if len(s[1]) == 2], SSUNET_DEEP,
            SSUNET_INT8_SEAMS)
    torch.cuda.empty_cache()

    # training: kernel 9 on every SPADE the gate takes (the eight of 32-256
    # planes; conv4_0's hidden 128 is past the tail's limit), the VGG blocks
    # through plain autograd
    with no_seam_reads("phase 12: SSUNet training", check):
        spade_row = pallas_trainer_phase(dev, card, cfg, model, "SSUNet", "phase 12", check)
    check(spade_row["per_step"] == len(sigs),
          f"phase 12: the SPADE gate takes {spade_row['per_step']} of SSUNet's nine")
    del model
    torch.cuda.empty_cache()
    return {
        "seam_reads": serve["seam_reads"], "s8_seam_reads": int8_row["seam_reads"],
        "fused_eval_stage": (serve["launches"], max(seeded[0], stages["max_abs_err"])),
        "fused_eval_stage_int8": (int8_row["launches"], max(seeded[1], int8_row["max_abs_err"])),
        "fused_spade_stage": (spade_row["launches"], spade_row["max_abs_err"]),
    }


def write_png_tree(root, name, splits, size, num_classes, in_ch, filter_type):
    """The reference's directory layout of PNGs written by the port's codec
    (``data/png.py``, every row with ``filter_type``) from seeded synthetic
    scenes: BGR images, one 0/255 mask per class."""
    from ssunet_gan_tpu_torch.data.dataset import SyntheticDataset
    from ssunet_gan_tpu_torch.data.png import write_image

    for k, (split, n) in enumerate(splits):
        ds = SyntheticDataset(n, size, size, num_classes, in_ch, seed=100 + k)
        for i in range(n):
            img, _, mask, _ = ds[i]
            img_dir = os.path.join(root, name, "images", split)
            os.makedirs(img_dir, exist_ok=True)
            write_image(os.path.join(img_dir, f"{i:04d}.png"), img, filter_type)
            for c in range(num_classes):
                d = os.path.join(root, name, "annotations", split, str(c))
                os.makedirs(d, exist_ok=True)
                write_image(os.path.join(d, f"{i:04d}.png"),
                            (mask[..., c] * 255).astype(np.uint8), filter_type)


def png_decode_line(root, name, split, card) -> None:
    """A ``png decode:`` line: ``data/png.py``'s time per item of a split
    (its image and its masks, as ``SegmentationDataset`` reads them) and
    the part of it that is zlib's inflate, the floor of any decoder (the
    rest is the unfilter: the row path or the anti-diagonal walk, by the
    files' filters)."""
    import zlib

    from ssunet_gan_tpu_torch.data import png

    img_dir = os.path.join(root, name, "images", split)
    ids = sorted(os.listdir(img_dir))
    ann = os.path.join(root, name, "annotations", split)
    mask_dirs = sorted(os.path.join(ann, d) for d in os.listdir(ann))
    decode_s = inflate_s = 0.0
    kinds, shape = set(), None
    for i in ids:
        for path in [os.path.join(img_dir, i)] + [os.path.join(d, i) for d in mask_dirs]:
            with open(path, "rb") as f:
                data = f.read()
            t0 = time.perf_counter()
            x = png.decode_png(data)
            t1 = time.perf_counter()
            raw = zlib.decompress(b"".join(body for kind, body in png._chunks(data)
                                           if kind == b"IDAT"))
            decode_s, inflate_s = decode_s + t1 - t0, inflate_s + time.perf_counter() - t1
            shape = shape or list(x.shape)  # the image's
            kinds |= set(np.frombuffer(raw, np.uint8).reshape(x.shape[0], -1)[:, 0].tolist())
    n = len(ids)
    print("png decode:", json.dumps(dict(
        tree=name, split=split, items=n, masks_per_item=len(mask_dirs), image_shape=shape,
        filters=sorted(kinds), ms_per_item=decode_s / n * 1e3,
        inflate_ms_per_item=inflate_s / n * 1e3, card=card)))


def run_cli(module, here, tmp, dev, overrides, launcher=()):
    """``python [launcher] -m <module> --config <file> --device <dev>`` in a
    process of its own, the file config_v1.json with ``overrides`` for one
    epoch on the PNG tree ``<tmp>/inputs/pngs``, its models in
    ``<tmp>/cli_models``. Returns (the finished process, its seconds, the
    opt_config it ran)."""
    with open(os.path.join(here, "configs", "config_v1.json")) as f:
        raw = json.load(f)
    raw["file_path"] = {"input_path": os.path.join(tmp, "inputs"),
                        "model_path": os.path.join(tmp, "cli_models"),
                        "output_path": os.path.join(tmp, "outputs"),
                        "checkpoint_path": os.path.join(tmp, "cli_checkpoint")}
    raw["opt_config"].update(overrides, epochs=1, dataset="pngs", val_dataset="pngs")
    cli_config = os.path.join(tmp, module.rsplit(".", 1)[-1] + ".json")
    with open(cli_config, "w") as f:
        json.dump(raw, f)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *launcher, "-m", module, "--config", cli_config,
                           "--device", dev.type], cwd=here, env=dict(os.environ, PYTHONPATH=here),
                          capture_output=True, text=True, timeout=600)
    return proc, time.perf_counter() - t0, raw["opt_config"]


def entry_point_phase(dev, card, here, check, overrides=None):
    """Phase 13: ``run_experiment`` on config_v1.json's opt_config (the
    flagship at 512², batch 8, Adam, bf16) with its paths in a temporary
    directory, its resume, ``model.pth`` reloaded, one epoch on PNG files
    (the loader's wait on decoded data), and the CLI on the same files.
    ``overrides`` replace opt_config keys (a rehearsal on the CPU makes the
    tiles small). Returns the train kernels' launches on this path."""
    import tempfile

    from ssunet_gan_tpu_torch.config import load_experiment_config, load_flat_card
    from ssunet_gan_tpu_torch.data import png
    from ssunet_gan_tpu_torch.infer.api import tile_forward
    from ssunet_gan_tpu_torch.models import build_model
    from ssunet_gan_tpu_torch.train import checkpoint as ckpt
    from ssunet_gan_tpu_torch.train import supervised

    t_phase = time.perf_counter()
    config_path = os.path.join(here, "configs", "config_v1.json")
    overrides = dict(overrides or {})
    size = int(overrides.get("input_h", HW))
    per_step = PER_STEP["v3"]
    tiles = torch.from_numpy(np.random.default_rng(SEED + 60).integers(
        0, 256, (BATCH, size, size, 3), dtype=np.uint8)).to(dev)
    saved_probs = {}
    save_model = ckpt.save_model

    def save_and_probe(model_dir, model):
        """Save, then run the tile forward of the model as saved."""
        path = save_model(model_dir, model)
        with torch.no_grad():
            saved_probs["probs"] = tile_forward(model, tiles, device=dev).clone()
        return path

    epochs = []  # (epoch, train s, loader wait s, eval s)
    loader_cls, train_epoch, evaluate = (supervised.BatchLoader, supervised.train_one_epoch,
                                         supervised.evaluate)
    waits = [0.0]

    class TimedLoader(loader_cls):
        def __iter__(self):
            it = super().__iter__()
            while True:
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                if self.shuffle:  # the train split
                    waits[0] += time.perf_counter() - t
                yield batch

    def timed_epoch(epoch, *args, **kwargs):
        waits[0] = 0.0
        t = time.perf_counter()
        out = train_epoch(epoch, *args, **kwargs)
        epochs.append([epoch, time.perf_counter() - t, waits[0], 0.0])
        return out

    def timed_eval(*args, **kwargs):
        t = time.perf_counter()
        out = evaluate(*args, **kwargs)
        epochs[-1][3] += time.perf_counter() - t
        return out

    yaml_before = sys.modules.get("yaml", None)
    sys.modules["yaml"] = None  # the card machine has no PyYAML: write the flat card
    launches = {}
    with tempfile.TemporaryDirectory() as tmp, \
            patched(ckpt, "save_model", save_and_probe), \
            patched(supervised, "BatchLoader", TimedLoader), \
            patched(supervised, "train_one_epoch", timed_epoch), \
            patched(supervised, "evaluate", timed_eval):
        try:
            cfg = load_experiment_config(config_path)
            cfg.opt_config.update(overrides)
            cfg.file_path.model_path = os.path.join(tmp, "models")
            cfg.file_path.checkpoint_path = os.path.join(tmp, "checkpoint")
            reset_launches()
            _, best_iou, log = supervised.run_experiment(cfg, synthetic=ENTRY_SYNTHETIC,
                                                         epochs_override=ENTRY_EPOCHS, device=dev)
            counts = read_launches()
            steps = ENTRY_EPOCHS * (ENTRY_SYNTHETIC // cfg.opt_config["batch_size"])
            print(f"phase 13: run_experiment on config_v1.json (the flagship 512x512, batch 8, "
                  f"Adam, bf16), {ENTRY_EPOCHS} epochs of {ENTRY_SYNTHETIC} synthetic scenes: train "
                  f"kernel launches {counts} in {steps} steps; log {dict(log)}")
            check(counts == {k: steps * v for k, v in per_step.items()},
                  f"phase 13: launches {counts} != {steps} x {per_step}")
            mdir = cfg.model_dir()
            with open(os.path.join(mdir, "log.csv")) as f:
                rows = f.read().splitlines()
            check(rows[0] == "epoch,lr,loss,iou,dice,val_loss,val_iou,val_dice" and len(rows) == 3,
                  f"phase 13: log.csv {rows}")
            with open(os.path.join(mdir, "config.yml")) as f:
                card_text = f.read()
            check(load_flat_card(card_text) == cfg.opt_config,
                  "phase 13: the flat model card does not read back as the opt_config")
            check(os.path.isfile(os.path.join(mdir, "model.pth")) and "probs" in saved_probs,
                  f"phase 13: no model.pth saved (best val IoU {best_iou})")
            t_phase = phase_done("phase 13 run_experiment", t_phase)

            # resume for a third epoch
            cfg.opt_config["resume"] = True
            reset_launches()
            _, _, log3 = supervised.run_experiment(cfg, synthetic=ENTRY_SYNTHETIC,
                                                   epochs_override=ENTRY_EPOCHS + 1, device=dev)
            more = read_launches()
            resumed = ENTRY_SYNTHETIC // cfg.opt_config["batch_size"]
            print(f"phase 13: resumed: epochs {log3['epoch']}, launches {more}")
            check(log3["epoch"] == [ENTRY_EPOCHS]
                  and more == {k: resumed * v for k, v in per_step.items()},
                  f"phase 13: the resume ran epochs {log3['epoch']} with launches {more}")
            for k in counts:
                launches[k] = counts[k] + more[k]
            fresh = build_model(cfg.opt_config["arch"], cfg.opt_config["num_classes"], 3,
                                seed=SEED + 61, device=dev)
            report = ckpt.load_model(mdir, fresh)
            with torch.no_grad():
                probs = tile_forward(fresh, tiles, device=dev)
            same = torch.equal(probs, saved_probs["probs"])
            print(f"phase 13: model.pth into a fresh model: {len(report['loaded'])} tensors "
                  f"loaded, missing {report['missing']}, unmatched {report['unmatched']}; tile "
                  f"forward equal to the saved model's bit for bit: {same}")
            check(same and not report["missing"] and not report["unmatched"],
                  "phase 13: the model reloaded from model.pth differs from the saved one")
            del fresh, probs
            t_phase = phase_done("phase 13 resume and reload", t_phase)

            # one epoch on each of two PNG trees, the same pixels: Sub rows,
            # as cv2.imwrite writes at its defaults (the decoder's row
            # path; the tree the CLI reads below), and Paeth rows (its
            # anti-diagonal walk, which libpng's adaptive filters take)
            png_root = os.path.join(tmp, "inputs")
            base, sources = cfg.name, ["synthetic"] * len(epochs)
            steps = CLI_SPLITS[0][1] // cfg.opt_config["batch_size"]
            for tree, filter_type in (("pngs", png.SUB), ("pngs_paeth", png.PAETH)):
                write_png_tree(png_root, tree, CLI_SPLITS, size, cfg.opt_config["num_classes"],
                               cfg.opt_config["input_channels"], filter_type)
                png_decode_line(png_root, tree, CLI_SPLITS[0][0], card)
                cfg.file_path.input_path = png_root
                cfg.opt_config.update(resume=False, dataset=tree, val_dataset=tree,
                                      name=f"{base}_{tree}")
                reset_launches()
                supervised.run_experiment(cfg, epochs_override=1, device=dev)
                more = read_launches()
                check(more == {k: steps * v for k, v in per_step.items()},
                      f"phase 13: the epoch on {tree} ran launches {more}, expected {steps} x "
                      f"{per_step}")
                for k in counts:
                    launches[k] += more[k]
                sources.append(f"PNG ({tree})")
            for (epoch, train_s, wait_s, eval_s), data in zip(epochs, sources):
                print(f"phase 13: {data} epoch {epoch}: train {train_s:.3f} s (loader wait "
                      f"{wait_s:.3f} s, {wait_s / train_s:.3f} of it; steps "
                      f"{train_s - wait_s:.3f} s), val + test evaluation {eval_s:.3f} s on {card}")
            t_phase = phase_done("phase 13 PNG epochs", t_phase)
        finally:
            if yaml_before is None:
                sys.modules.pop("yaml", None)
            else:
                sys.modules["yaml"] = yaml_before

        # the CLI on PNG files, in a process of its own
        proc, cli_s, _ = run_cli("ssunet_gan_tpu_torch.cli.train", here, tmp, dev, overrides)
        tail = [ln for ln in proc.stdout.splitlines() if " - iou " in ln or "saved" in ln]
        print(f"phase 13: python -m ssunet_gan_tpu_torch.cli.train on {sum(n for _, n in CLI_SPLITS)}"
              f" PNGs at {size}x{size} (train_transform on): exit {proc.returncode} in {cli_s:.1f} s "
              f"on {card}; {tail}")
        check(proc.returncode == 0,
              f"phase 13: the CLI exited {proc.returncode}: {proc.stdout[-1500:]} "
              f"{proc.stderr[-3000:]}")
    phase_done("phase 13 CLI", t_phase)
    return launches


SCENE_HW = 5000  # an Inria "chicago" scene, the size config_v1.json was trained on
SCENE_INT8_HW = 2048  # 36 tiles, two chunks, the last padded
LABEL_BLOCK = 64  # the labels' colour blocks, in pixels
SCENE_NAME = "chicago1"


def smooth_scene(hw, seed, dev):
    """A seeded HWC uint8 BGR scene: a smooth field (a coarse random grid
    upsampled bilinearly, on ``dev``) plus noise in [-12, 12]."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((1, 3, hw // 64 + 2, hw // 64 + 2), generator=g).to(dev) * 255
    field = torch.nn.functional.interpolate(coarse, size=(hw, hw), mode="bilinear",
                                            align_corners=False)[0].permute(1, 2, 0)
    noise = torch.randint(-12, 13, (hw, hw, 3), generator=g).to(dev)
    return (field + noise).round().clamp(0, 255).to(torch.uint8).cpu().numpy()


def scene_labels(hw, seed):
    """Labels in the three label colours of ``mask_convert`` (BGR), in
    LABEL_BLOCK-pixel blocks, each class present."""
    from ssunet_gan_tpu_torch.data.tiling import LABEL_COLOURS

    n = hw // LABEL_BLOCK + 1
    cls = np.random.default_rng(seed).integers(0, 3, (n, n))
    cls[0, :3] = [0, 1, 2]
    colours = np.array([LABEL_COLOURS[c] for c in range(3)], np.uint8)
    lab = colours[cls].repeat(LABEL_BLOCK, 0).repeat(LABEL_BLOCK, 1)
    return np.ascontiguousarray(lab[:hw, :hw])


def scene_phase(dev, card, here, check, quant_per_forward, scene_hw=SCENE_HW,
                int8_hw=SCENE_INT8_HW, tile_hw=HW):
    """Phase 14: whole-scene inference through its entry points on the
    flagship of config_v1.json (full width, BN statistics calibrated, head
    centred), from a model directory written by the port (flat card,
    ``model.pth``; a second card with ``"int8": true`` and
    ``int8_scales.json``) over PNG scenes: ``load_segmentation_models``,
    the tile server, ``segmentation_inference`` with ground truth beside
    ``pipelined_scene_forward``, the ground-truth branch on the CPU, the
    int8 card, and ``python -m ssunet_gan_tpu_torch.cli.val_patch``. Prints
    the ``scene:`` breakdown. ``quant_per_forward``: the one-pass
    quantizations of one int8 forward (phase 8). The sizes shrink for a
    rehearsal on the CPU. Returns {kernel: launches} and the kernel-1 seam
    reads of this path."""
    import tempfile

    from ssunet_gan_tpu_torch import native
    from ssunet_gan_tpu_torch.config import dump_model_card, load_experiment_config
    from ssunet_gan_tpu_torch.data import png
    from ssunet_gan_tpu_torch.data.jpeg import encode_jpeg
    from ssunet_gan_tpu_torch.data.tiling import extract_patches, grid_coords, merge_patches_device
    from ssunet_gan_tpu_torch.data.transforms import resize_linear
    from ssunet_gan_tpu_torch.infer import api
    from ssunet_gan_tpu_torch.infer.calibrate import calibrate_int8
    from ssunet_gan_tpu_torch.infer.overlays import PINK, YELLOW, _blend, save_masking_RE
    from ssunet_gan_tpu_torch.models import build_model
    from ssunet_gan_tpu_torch.ops import spade_kernel, stage_kernel, stage_kernel_int8 as q8
    from ssunet_gan_tpu_torch.train.checkpoint import save_model

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(fn):
        """(result, device ms by CUDA events, or host ms on the CPU)."""
        sync()
        if not cuda:
            t0 = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t0) * 1e3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    config_path = os.path.join(here, "configs", "config_v1.json")
    exp = load_experiment_config(config_path)
    opt = dict(exp.opt_config, input_h=tile_hw, input_w=tile_hw)
    name, ncls = opt["name"], opt["num_classes"]
    model = build_model(opt["arch"], ncls, opt["input_channels"], opt["deep_supervision"],
                        seed=SEED, device=dev)
    a, b = api._norm_consts()
    calib = np.random.default_rng(SEED + 2).integers(0, 256, (2, tile_hw, tile_hw, 3), np.uint8)
    calib = torch.from_numpy(calib).to(dev).float() * a.to(dev) + b.to(dev)
    calibrate_batchnorm(model, calib)
    center_head(model, calib)
    launches, seams, seams8 = {}, [0, 0], [0, 0]
    yaml_before = sys.modules.get("yaml", None)
    sys.modules["yaml"] = None  # the card machine has no PyYAML: the flat card
    with tempfile.TemporaryDirectory() as tmp:
        try:
            # (a) the model directories: bf16 card, int8 card with its scales
            models = os.path.join(tmp, "models")
            mdir = os.path.join(models, name)
            dump_model_card(opt, mdir)
            save_model(mdir, model)
            idir = os.path.join(models, name + "_int8")
            dump_model_card(dict(opt, int8=True), idir)
            save_model(idir, model)
            scales = calibrate_int8(model, calib.cpu().numpy(), idir, batch_size=2, device=dev)
            q8.set_int8_calibration(None)

            # (b) the scenes, PNG with Sub rows (cv2.imwrite's default)
            scenes, int8_scenes = os.path.join(tmp, "scenes"), os.path.join(tmp, "scenes_int8")
            os.makedirs(scenes)
            os.makedirs(int8_scenes)
            scene_path = os.path.join(scenes, f"{SCENE_NAME}_image.png")
            png.write_image(scene_path, smooth_scene(scene_hw, SEED + 70, dev))
            png.write_image(os.path.join(scenes, f"{SCENE_NAME}_labels.png"),
                            scene_labels(scene_hw, SEED + 71))
            int8_path = os.path.join(int8_scenes, "int8_image.png")
            png.write_image(int8_path, smooth_scene(int8_hw, SEED + 72, dev))
            with open(config_path) as f:
                raw = json.load(f)
            raw["file_path"] = {"input_path": tmp, "model_path": models,
                                "output_path": os.path.join(tmp, "outputs"),
                                "checkpoint_path": os.path.join(tmp, "checkpoint")}
            raw["opt_config"].update(input_h=tile_hw, input_w=tile_hw)
            raw["val_config"].update(name=name, full_image_path=scenes, gt_mask_flag="True",
                                     patch_overlap=0.5)
            exp_path = os.path.join(tmp, "val_patch.json")
            with open(exp_path, "w") as f:
                json.dump(raw, f)
            raw["val_config"].update(name=name + "_int8", full_image_path=int8_scenes,
                                     gt_mask_flag="False")
            int8_exp = os.path.join(tmp, "val_patch_int8.json")
            with open(int8_exp, "w") as f:
                json.dump(raw, f)
            t_phase = phase_done("phase 14 model directories and scenes", t_phase)

            # (c) loading
            loaded, config = api.load_segmentation_models(exp_path, device=dev)
            want = model.state_dict()
            same = all(torch.equal(v, want[k]) for k, v in loaded.state_dict().items()) \
                and loaded.state_dict().keys() == want.keys()
            print(f"phase 14: load_segmentation_models: {type(loaded).__name__}, state bit-equal "
                  f"to the saved model: {same}, patch {config['patch_size']}, overlap "
                  f"{config['patch_overlap']}")
            check(same and config["patch_size"] == 1024 and config["patch_overlap"] == 0.5
                  and not loaded.training, "phase 14: the loaded model or config differs")
            del model

            # (d) the scene read, then the tile server against resize_linear
            t0 = time.perf_counter()
            scene = png.read_image(scene_path)
            labels = png.read_image(scene_path.replace("image", "labels"))
            read_s = time.perf_counter() - t0
            h, w = scene.shape[:2]
            p = api.effective_patch_size(h, w, config["patch_size"])
            coords = grid_coords(h, w, p, 0.5)
            n = len(coords)
            first = coords[:api.INFER_BATCH]
            tiles0 = native.extract_resize_u8(scene, first, p, tile_hw, tile_hw)
            plain0 = np.stack([resize_linear(t, tile_hw, tile_hw)
                               for t in extract_patches(scene, first, p)])
            crop_same = np.array_equal(native.extract_u8(labels, first, p),
                                       extract_patches(labels, first, p))
            print(f"phase 14: scene {h}x{w}, patch {p}: {n} tiles in {-(-n // api.INFER_BATCH)} "
                  f"chunks; the tile server's first chunk equals resize_linear(extract_patches) "
                  f"bit for bit: {np.array_equal(tiles0, plain0)}; its label crops equal "
                  f"extract_patches: {crop_same}")
            check(np.array_equal(tiles0, plain0) and crop_same,
                  "phase 14: the tile server's tiles or crops differ from the plain version")
            del tiles0, plain0

            # (e) the two routes, counts set to 0 just before each and read
            # just after: the tile server + segmentation_inference with
            # ground truth, then the pipelined forward + merge
            sync()
            t0 = time.perf_counter()
            tiles, masks = api.patch_and_preprocess(scene, labels, config, raw_uint8=True)
            prep_s = time.perf_counter() - t0
            stage_kernel.launches = stage_kernel.up_reads = stage_kernel.pool_reads = 0
            t0 = time.perf_counter()
            pred, gt = api.segmentation_inference(loaded, scene, tiles, masks, config, True,
                                                  device=dev)
            gt_route_s = time.perf_counter() - t0
            route_a = (stage_kernel.launches, stage_kernel.up_reads, stage_kernel.pool_reads)

            stage_kernel.launches = stage_kernel.up_reads = stage_kernel.pool_reads = 0
            gc.collect()
            sync()
            t0 = time.perf_counter()
            probs, pcoords, pp = api.pipelined_scene_forward(loaded, scene, config,
                                                             quantize_probs=True, device=dev)
            merged = merge_patches_device(probs, pcoords, h, w, pp, ncls, overlap=0.5).cpu().numpy()
            piped_s = time.perf_counter() - t0
            route_b = (stage_kernel.launches, stage_kernel.up_reads, stage_kernel.pool_reads)
            chunks = -(-n // api.INFER_BATCH)
            per = (6 * chunks, 2 * chunks, 2 * chunks)
            equal = all(np.array_equal(merged[..., c], pred[c]) for c in range(ncls))
            print(f"phase 14: segmentation_inference (ground truth on) launches {route_a[0]} "
                  f"kernel-1 stages, {route_a[1]} up / {route_a[2]} pool seams; "
                  f"pipelined_scene_forward {route_b[0]}, {route_b[1]} / {route_b[2]}; expected "
                  f"{per} each; masks bit-equal: {equal}; positive share "
                  f"{[round(float((m > 0).mean()), 4) for m in pred]}; ground truth "
                  f"{[round(float((m > 0).mean()), 4) for m in gt]}")
            check(route_a == per and route_b == per,
                  f"phase 14: launches and seams {route_a} / {route_b}, expected {per} per route")
            check(equal, "phase 14: the pipelined route's masks differ from segmentation_inference's")
            check(all(m.shape == (h, w) and set(np.unique(m)) <= {0, 255} for m in pred + gt),
                  "phase 14: a mask of the wrong shape or values")
            check(all(0 < m.mean() < 255 for m in gt), "phase 14: a ground-truth mask is constant")
            launches["fused_eval_stage"] = route_a[0] + route_b[0]
            seams = [route_a[1] + route_b[1], route_a[2] + route_b[2]]
            del probs, merged
            t_phase = phase_done("phase 14 two routes", t_phase)

            # (f) the ground-truth branch on the CPU, the same functions
            t0 = time.perf_counter()
            gt_cpu = merge_patches_device(api.gt_probs(masks, ncls, tile_hw, "cpu"), coords, h, w,
                                          p, ncls, overlap=0.5).numpy()
            cpu_s = time.perf_counter() - t0
            gt_equal = all(np.array_equal(gt_cpu[..., c], gt[c]) for c in range(ncls))
            print(f"phase 14: ground-truth masks on the card equal the CPU's bit for bit: "
                  f"{gt_equal} (CPU branch {cpu_s:.2f} s)")
            check(gt_equal, "phase 14: the ground-truth masks differ between card and CPU")
            del gt_cpu

            # (i) the breakdown of one unpipelined scene: H2D, forward, merge
            # (device time), D2H; the ground-truth branch; the overlays
            x_dev, h2d_ms = timed(lambda: torch.from_numpy(tiles).to(dev))

            def forwards():
                return torch.cat([api.tile_forward(loaded, x_dev[i:i + api.INFER_BATCH],
                                                   device=dev)
                                  for i in range(0, n, api.INFER_BATCH)])

            probs, fwd_ms = timed(forwards)
            merged_dev, merge_ms = timed(
                lambda: merge_patches_device(probs, coords, h, w, p, ncls, overlap=0.5))
            merged, d2h_ms = timed(lambda: merged_dev.cpu().numpy())
            del x_dev, probs, merged_dev
            sync()
            t0 = time.perf_counter()
            gt_dev = merge_patches_device(api.gt_probs(masks, ncls, tile_hw, dev), coords, h, w,
                                          p, ncls, overlap=0.5).cpu()
            gt_s = time.perf_counter() - t0
            del gt_dev
            sync()
            t0 = time.perf_counter()
            api.segmentation_inference(loaded, scene, tiles, masks, config, False, device=dev)
            unpiped_s = prep_s + time.perf_counter() - t0
            blend_s = jpeg_s = 0.0
            re1 = None
            for c in range(1, ncls):
                for mask, colour, second in ((gt[c], YELLOW, None), (pred[c], PINK, None),
                                             (gt[c], YELLOW, pred[c])):
                    t0 = time.perf_counter()
                    img = _blend(scene.copy(), mask, colour)
                    if second is not None:
                        img = _blend(img, second, PINK)
                    t1 = time.perf_counter()
                    data = encode_jpeg(img)
                    blend_s, jpeg_s = blend_s + t1 - t0, jpeg_s + time.perf_counter() - t1
                    if c == 1 and colour is PINK:
                        re1 = data
            t_phase = phase_done("phase 14 breakdown", t_phase)

            # (g) the int8 card on the 2048² scene, then in process
            q8.launches = q8.conv_launches = q8.quant_launches = q8.up_reads = q8.pool_reads = 0
            stage_kernel.launches = 0
            model8, config8 = api.load_segmentation_models(int8_exp, device=dev)
            t0 = time.perf_counter()
            s8, tiles8, m8 = api.get_patched_input(int8_path, config8, False, raw_uint8=True)
            masks8, _ = api.segmentation_inference(model8, s8, tiles8, m8, config8, False,
                                                   device=dev)
            int8_s = time.perf_counter() - t0
            n8 = -(-len(tiles8) // api.INFER_BATCH)
            got8 = (q8.launches, q8.quant_launches, stage_kernel.launches, q8.up_reads,
                    q8.pool_reads)
            seams8 = list(got8[3:])
            installed = q8.int8_calibration() == scales and q8.int8_stage_enabled()
            q8.set_int8_stage(False)
            q8.set_int8_calibration(None)
            api.configure_int8({"int8": True}, idir)
            again, _ = api.segmentation_inference(loaded, s8, tiles8, m8, config, False,
                                                  device=dev)
            q8.set_int8_stage(False)
            q8.set_int8_calibration(None)
            same8 = all(np.array_equal(x_, y_) for x_, y_ in zip(masks8, again))
            up8, pool8 = seams_per(FLAGSHIP_INT8_SEAMS)
            want8 = (6 * n8, quant_per_forward * n8, 0, up8 * n8, pool8 * n8)
            print(f"phase 14: int8 card on a {int8_hw}x{int8_hw} scene ({len(tiles8)} tiles, "
                  f"{n8} chunks): kernel-7 stages, quantizations, kernel-1 stages, s8 up and "
                  f"pool seams {got8}, "
                  f"expected {want8}; scales installed from int8_scales.json: {installed}; masks "
                  f"bit-equal to configure_int8 + segmentation_inference in process: {same8}; "
                  f"{int8_s:.3f} s on {card}")
            check(got8 == want8 and installed and same8,
                  f"phase 14: the int8 card ran {got8} (expected {want8}), scales installed "
                  f"{installed}, masks equal {same8}")
            check(not q8.int8_stage_enabled() and q8.int8_calibration() is None,
                  "phase 14: the int8 mode was not cleared")
            check(all(m.shape == s8.shape[:2] and set(np.unique(m)) <= {0, 255}
                      for m in masks8), "phase 14: an int8 mask of the wrong shape or values")
            launches["fused_eval_stage_int8"] = got8[0]
            del model8, tiles8, m8, again
            t_phase = phase_done("phase 14 int8 card", t_phase)
        finally:
            q8.set_int8_stage(False)
            q8.set_int8_calibration(None)
            q8.set_band_rows(None)
            spade_kernel.set_fused_spade(None)
            if yaml_before is None:
                sys.modules.pop("yaml", None)
            else:
                sys.modules["yaml"] = yaml_before

        # (h) the CLI in a process of its own, on the same scene
        env = dict(os.environ, PYTHONPATH=here)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ssunet_gan_tpu_torch.cli.val_patch",
                               "--config", exp_path, "--device", dev.type], cwd=here, env=env,
                              capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        out_dir = os.path.join(tmp, "outputs", name)
        files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
        stem = f"{SCENE_NAME}_image"
        expected = sorted(f"{stem}_{c}_{k}_masking.jpg" for c in range(1, ncls)
                          for k in ("GT", "RE", "GT_RE"))
        blobs = {f: open(os.path.join(out_dir, f), "rb").read() for f in files}
        framed = all(v.startswith(b"\xff\xd8") and v.endswith(b"\xff\xd9") for v in blobs.values())
        ours = os.path.join(tmp, "re1.jpg")
        save_masking_RE(scene.copy(), pred[1], pred[1], ours)
        with open(ours, "rb") as f:
            re_file = f.read()
        re_same = blobs.get(f"{stem}_1_RE_masking.jpg") == re_file == re1
        print(f"phase 14: python -m ssunet_gan_tpu_torch.cli.val_patch on the {h}x{w} scene: exit "
              f"{proc.returncode} in {cli_s:.1f} s on {card}; files {files} "
              f"({sum(len(v) for v in blobs.values())} bytes), JPEG-framed: {framed}; "
              f"{stem}_1_RE_masking.jpg byte-identical to save_masking_RE in process: {re_same}")
        check(proc.returncode == 0, f"phase 14: the CLI exited {proc.returncode}: "
              f"{proc.stdout[-1500:]} {proc.stderr[-3000:]}")
        check(files == expected and framed and re_same,
              f"phase 14: the CLI wrote {files} (framed {framed}, RE equal {re_same}), expected "
              f"{expected}")
    print("scene:", json.dumps(dict(
        scene=f"{h}x{w}", tiles=n, chunks=chunks, png_read_s=read_s, tile_prep_s=prep_s,
        h2d_ms=h2d_ms, forward_ms=fwd_ms, merge_ms=merge_ms, d2h_ms=d2h_ms,
        ground_truth_s=gt_s, overlays_blend_s=blend_s, overlays_jpeg_s=jpeg_s,
        overlay_files=2 * (ncls - 1) + (ncls - 1), unpipelined_s=unpiped_s,
        pipelined_s=piped_s, pipelined_tiles_per_s=n / piped_s,
        segmentation_inference_with_gt_s=gt_route_s, int8_scene_s=int8_s, cli_s=cli_s,
        card=card)))
    phase_done("phase 14 CLI", t_phase)
    return launches, tuple(seams), tuple(seams8)


# phase 15: the GAN step's warm-up and timed steps per formulation; the
# kernels of the generator's fused train stages by their profiler names
GAN_WARM, GAN_STEPS = 2, 5
G_KERNELS = ("fused_conv3_kernel", "fused_wgrad_kernel", "stats_reduce_kernel", "eval_conv_core",
             "spade_tail_kernel")
CONV_NAMES = ("conv", "xmma", "gemm", "sm90", "cutlass", "implicit", "dgrad", "wgrad", "fprop")


class GlobalMean(torch.nn.Module):
    """NHWC maps to their per-channel means in f32: the body of the one-layer
    discriminator that the GAN profile subtracts."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float().mean((1, 2))


def gan_phase(dev, card, here, check, sup_ms_step, overrides=None):
    """Phase 15: the adversarial fine-tune (``train/gan.py``) with the
    flagship of config_v1.json at full width as G (BN statistics calibrated
    as in phase 2, saved as the supervised ``generator_name`` and warm-started
    from it) and the SRGAN discriminator at the trainer's width: step 1 on
    STEP1_BATCHES seeded batches against the plain versions (bf16) and the
    module composition (f32) by phase 6's pooled bars; the joint formulation
    against the alternating one; GAN_WARM + GAN_STEPS timed steps of each
    (launches per step = PER_STEP["v3"]); a profile of one joint step; then
    ``run_gan_experiment`` (2 epochs of 16 synthetic scenes, a resume for a
    third, ``model.pth`` reloaded) and ``python -m
    ssunet_gan_tpu_torch.cli.train_seg_gan`` for one epoch on a 16 / 4 / 4
    Sub-row PNG tree. ``overrides`` replace opt_config keys (a rehearsal on
    the CPU makes the tiles small; it skips the timing and the profile).
    Returns the kernel launches on this path (the train kernels', and the
    f32 stages of its evaluations under ``fused_eval_stage_f32``)."""
    import tempfile

    from ssunet_gan_tpu_torch.config import dump_model_card, load_experiment_config, load_model_card
    from ssunet_gan_tpu_torch.data import png
    from ssunet_gan_tpu_torch.data.dataset import SyntheticDataset
    from ssunet_gan_tpu_torch.data.loader import BatchLoader
    from ssunet_gan_tpu_torch.data.transforms import val_transform
    from ssunet_gan_tpu_torch.infer.api import _norm_consts, tile_forward
    from ssunet_gan_tpu_torch.models import build_model, ssunet
    from ssunet_gan_tpu_torch.models.gan import Discriminator, Generator
    from ssunet_gan_tpu_torch.ops import stage_kernel
    from ssunet_gan_tpu_torch.ops.conv import Dense
    from ssunet_gan_tpu_torch.ops.losses import get_loss
    from ssunet_gan_tpu_torch.ops.norm import BatchNorm
    from ssunet_gan_tpu_torch.train import checkpoint as ckpt
    from ssunet_gan_tpu_torch.train import gan as gan_train
    from ssunet_gan_tpu_torch.train import gan_step
    from ssunet_gan_tpu_torch.train.optim import adam
    from ssunet_gan_tpu_torch.train.step import make_eval_step
    from ssunet_gan_tpu_torch.train.supervised import train_one_epoch
    from ssunet_gan_tpu_torch.utils import count_params

    t_start = t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    cfg = load_experiment_config(os.path.join(here, "configs", "config_v1.json"))
    cfg.opt_config.update(overrides or {})
    opt = cfg.opt_config
    size, ncls, in_ch = int(opt["input_h"]), opt["num_classes"], opt["input_channels"]
    lr, gname = float(opt["gan_lr"]), opt["generator_name"]
    per_step = PER_STEP["v3"]
    loss_fn = get_loss(opt["loss"])
    fused_stage = ssunet.spade_stage
    launches = {k: 0 for k in TRAIN_KERNELS}
    bf16 = torch.bfloat16

    def count_launches(what, n_steps):
        got = read_launches()
        print(f"phase 15: {what}: train kernel launches {got} in {n_steps} steps")
        check(got == {k: n_steps * v for k, v in per_step.items()},
              f"phase 15: {what}: launches {got} != {n_steps} x {per_step}")
        for k in got:
            launches[k] += got[k]
        reset_launches()

    def loader(n_steps, seed):
        ds = SyntheticDataset(n_steps * TRAIN_BATCH, size, size, ncls, in_ch,
                              transform=val_transform(opt), seed=seed)
        return BatchLoader(ds, TRAIN_BATCH, shuffle=False, drop_last=True,
                           num_workers=int(opt["num_workers"]))

    def batch(seed):
        it = iter(loader(1, seed))
        _, img, mask, _ = next(it)
        it.close()
        return torch.from_numpy(img).to(dev), torch.from_numpy(mask).to(dev)

    yaml_before = sys.modules.get("yaml", None)
    sys.modules["yaml"] = None  # the card machine has no PyYAML: the flat card
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg.file_path.model_path = os.path.join(tmp, "models")
            cfg.file_path.checkpoint_path = os.path.join(tmp, "checkpoint")
            # the supervised generator, as the port's trainer saves it (also
            # for the CLI's own model directory)
            sup = build_model(opt["arch"], ncls, in_ch, opt["deep_supervision"], seed=SEED,
                              device=dev)
            a, b = _norm_consts()
            calib = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
                0, 256, (2, size, size, in_ch), dtype=np.uint8)).to(dev)
            calibrate_batchnorm(sup, calib.float() * a.to(dev) + b.to(dev))
            for root in ("models", "cli_models"):
                sup_dir = os.path.join(tmp, root, gname)
                dump_model_card(dict(opt, name=gname), sup_dir)
                ckpt.save_model(sup_dir, sup)
            g_config = dict(load_model_card(cfg.model_dir(gname)), name=gname)
            generator = Generator.from_config(g_config, device=dev, seed=SEED + 70)
            report = gan_train.warm_start(cfg, g_config, generator)
            g_sd = generator.state_dict()
            equal = all(torch.equal(g_sd["net." + k], v) for k, v in sup.state_dict().items())
            print(f"phase 15: warm start from the supervised model.pth: {len(report['loaded'])} "
                  f"tensors loaded, missing {report['missing']}, unmatched "
                  f"{report['unmatched']}; every net. tensor equal to the saved one: {equal}")
            check(equal and not report["missing"] and not report["unmatched"],
                  "phase 15: the warm-started generator differs from the saved model")
            del sup, calib, g_sd
            disc = Discriminator(ncls, gan_train.D_KERNEL, gan_train.D_CHANNELS,
                                 gan_train.D_BLOCKS, gan_train.D_FC,
                                 generator=torch.Generator().manual_seed(SEED + 71)).to(dev)
            print(f"phase 15: G {g_config['arch']} ({count_params(generator)} parameters), D "
                  f"{gan_train.D_CHANNELS} channels x {gan_train.D_BLOCKS} blocks, fc "
                  f"{gan_train.D_FC} ({count_params(disc)} parameters)")
            d_bns = [(n, m) for n, m in disc.named_modules() if isinstance(m, BatchNorm)]
            g_bns = [(n, m) for n, m in generator.named_modules() if isinstance(m, BatchNorm)]
            snapshot = (copy.deepcopy(generator.state_dict()), copy.deepcopy(disc.state_dict()))

            def restore():
                generator.load_state_dict(snapshot[0])
                disc.load_state_dict(snapshot[1])

            def running(bns=d_bns):
                return [t.detach().clone() for _, m in bns
                        for t in (m.running_mean, m.running_var)]

            # step 1 on seeded batches: the kernels, the plain versions (bf16)
            # and the module composition (f32), from the same weights; G's
            # running statistics are those its train forward left (the fused
            # stages' Σ/Σx² on the kernel run)
            def step1(x, y, dtype, stage):
                restore()
                with spade_stages_as(stage):
                    m = gan_step.gan_gradients(generator, disc, loss_fn, x.to(dtype), y, ncls)
                grads = lambda mod: [p.grad.detach().clone() for p in mod.parameters()]
                return ([m["perceptual_loss"]] + grads(generator),
                        [m["d_loss"]] + grads(disc), [m["d_loss"]] + running(),
                        [m["perceptual_loss"]] + running(g_bns))

            stat_names = lambda bns: [f"{n}.{k}" for n, _ in bns
                                      for k in ("running_mean", "running_var")]
            names = ([n for n, _ in generator.named_parameters()],
                     [n for n, _ in disc.named_parameters()], stat_names(d_bns),
                     stat_names(g_bns))
            sums = ([], [], [], [])
            for seed in range(1, STEP1_BATCHES + 1):
                x, y = batch(seed)
                kern = step1(x, y, bf16, fused_stage)
                with plain_train_kernels():
                    plain = step1(x, y, bf16, fused_stage)
                f32 = step1(x, y, torch.float32, module_stage)
                for i in range(4):
                    sums[i].append(step1_sums(kern[i], plain[i], f32[i]))
                print(f"phase 15: step 1 batch {seed} perceptual loss kernel "
                      f"{kern[0][0].item():.6f} plain {plain[0][0].item():.6f} f32 "
                      f"{f32[0][0].item():.6f}; D loss kernel {kern[1][0].item():.6f} plain "
                      f"{plain[1][0].item():.6f} f32 {f32[1][0].item():.6f}")
                del kern, plain, f32
            for what, ss, nn_ in zip(("G (perceptual loss, gradients)", "D (loss, gradients)",
                                      "D (loss, running statistics after 3 updates)",
                                      "G (perceptual loss, running statistics after its "
                                      "train forward)"),
                                     sums, names):
                ok, rows, bad = step1_bars(ss, nn_)
                label = f"phase 15: step 1 {what} over batches 1-{STEP1_BATCHES} (pooled)"
                for name, e_k, e_p, e_kp, held in rows:
                    print(f"{label} {name}: rel_l2 kernel-f32 {e_k:.4g} plain-f32 {e_p:.4g} "
                          f"kernel-plain {e_kp:.4g}{'' if held else '  <-- FAILED'}")
                print(f"{label}: single tensors failing: {', '.join(bad) or 'none'}")
                check(ok, f"{label}: bars {[r[0] for r in rows if not r[4]]}, tensors {bad}")

            # G's validation forward (eval mode) before and after two train
            # forwards without an update, through the kernels (bf16) and
            # through the module composition (f32): the eval step's loss
            # (NaN logits scrubbed to 0), the share of logits that are not
            # finite and the largest finite one. Where the synthetic run's
            # validation loss jumps, this shows which route does it.
            eval_step = make_eval_step(generator, loss_fn, ncls)

            def eval_probe(dtype, stage, forwards):
                restore()
                with torch.no_grad(), spade_stages_as(stage):
                    generator.train()
                    for seed in range(1, forwards + 1):
                        generator(batch(seed)[0].to(dtype))
                    xv, yv = batch(STEP1_BATCHES + 1)
                    loss = eval_step(xv.to(dtype), yv)["loss"].item()
                    out = generator(xv.to(dtype)).float()
                fin = torch.isfinite(out)
                top = out[fin].abs().max().item() if bool(fin.any()) else float("nan")
                return f"loss {loss:.6g}, not finite {1 - fin.float().mean().item():.4f}, " \
                       f"max |finite| {top:.4g}"

            for n in (0, 2):
                for what, dt, st in (("kernels", bf16, fused_stage),
                                     ("f32 composition", torch.float32, module_stage)):
                    print(f"phase 15: G's validation forward after {n} train forwards without "
                          f"an update, {what}: {eval_probe(dt, st, n)}")
            t_phase = phase_done("phase 15 step 1", t_phase)

            # the joint formulation against the alternating one: one Adam step
            # from the same weights on batch 1, within the plain-bf16 distance
            x, y = batch(1)

            def one_step(joint, dtype, stage):
                restore()
                gan_step.set_joint_gan(joint)
                try:
                    step = gan_step.make_gan_train_step(
                        generator, disc, loss_fn, adam(generator.parameters()),
                        adam(disc.parameters()), ncls)
                    with spade_stages_as(stage):
                        step(x.to(dtype), y, lr)
                finally:
                    gan_step.set_joint_gan(True)
                delta = lambda mod, sd: torch.cat([(p.detach().float() - sd[n].float()).reshape(-1)
                                                   for n, p in mod.named_parameters()])
                flat = lambda ts: torch.cat([t.float().reshape(-1) for t in ts])
                return (delta(generator, snapshot[0]), delta(disc, snapshot[1]), flat(running()),
                        flat(running(g_bns)))

            runs = {"joint": one_step(True, bf16, fused_stage),
                    "alternating": one_step(False, bf16, fused_stage)}
            with plain_train_kernels():
                runs["plain"] = one_step(True, bf16, fused_stage)
            runs["f32"] = one_step(True, torch.float32, module_stage)
            for i, what in enumerate(("G update", "D update", "D running statistics",
                                      "G running statistics")):
                j, alt, p, f = (runs[k][i] for k in ("joint", "alternating", "plain", "f32"))
                e_ja, e_pf = rel_l2(j, alt), rel_l2(p, f)
                print(f"phase 15: joint against alternating, {what}: rel_l2 {e_ja:.4g} (bar: "
                      f"plain-f32 {e_pf:.4g}); max abs {(j - alt).abs().max().item():.4g}")
                check(bool(torch.isfinite(j).all()) and e_ja <= e_pf,
                      f"phase 15: joint against alternating, {what}: {e_ja} > {e_pf}")
            del runs
            t_phase = phase_done("phase 15 joint against alternating", t_phase)

            # the timed steps, each formulation from the same weights
            ms_step = {}
            for joint, what in ((True, "joint"), (False, "alternating")):
                restore()
                gan_step.set_joint_gan(joint)
                try:
                    step = gan_step.make_gan_train_step(
                        generator, disc, loss_fn, adam(generator.parameters()),
                        adam(disc.parameters()), ncls)
                    before = running()
                    reset_launches()
                    warm = train_one_epoch(0, opt, loader(GAN_WARM, seed=1), step, lr, device=dev)
                    count_launches(f"{what} warm-up", GAN_WARM)
                    if cuda:
                        settle()
                    t1 = time.perf_counter()
                    log = train_one_epoch(1, opt, loader(GAN_STEPS, seed=2), step, lr, device=dev)
                    if cuda:
                        torch.cuda.synchronize()
                    dt = time.perf_counter() - t1
                    count_launches(f"{what} timed", GAN_STEPS)
                finally:
                    gan_step.set_joint_gan(True)
                ms_step[what] = dt / GAN_STEPS * 1e3
                print(f"gan step: {what} {ms_step[what]:.2f} ms/step, "
                      f"{TRAIN_BATCH * GAN_STEPS / dt:.2f} images/s ({size}x{size} bf16, batch "
                      f"{TRAIN_BATCH}, Adam {lr:g} on G and D, {GAN_STEPS} steps after "
                      f"{GAN_WARM} warm-up); the supervised step (phase 6) "
                      f"{sup_ms_step:.2f} ms/step; on {card}")
                print(f"phase 15: {what} epochs: warm-up {warm}; timed {log}")
                check(all(np.isfinite(v) for lg in (warm, log) for v in lg.values()),
                      f"phase 15: {what} metrics not finite: {warm} {log}")
                moved = sum(bool((a != b).any()) for a, b in zip(running(), before))
                print(f"phase 15: {what}: D's running statistics moved in {moved} of "
                      f"{len(before)} buffers")
                check(moved == len(before), f"phase 15: {what}: D's statistics moved in {moved}")
            t_phase = phase_done("phase 15 timed steps", t_phase)

            if cuda:  # where one joint step's device time goes: G's kernels, D's part, idle
                def profiled_step(d):
                    """One joint step's profile with discriminator ``d``."""
                    step = gan_step.make_gan_train_step(generator, d, loss_fn,
                                                        adam(generator.parameters()),
                                                        adam(d.parameters()), ncls)
                    restore()
                    return profile_kernels(lambda: step(xb, y, lr), 1)

                xb = x.to(bf16)
                busy, wall_ms, rows = profiled_step(disc)
                # D's part: the same step less the step with a one-layer D (a
                # Dense over the fake's channel means)
                null_d = torch.nn.Sequential(GlobalMean(), Dense(ncls, 1)).to(dev)
                n_busy, _, n_rows = profiled_step(null_d)
                g_ms = sum(r[0] for r in rows if any(k in r[2] for k in G_KERNELS))
                conv_ms = lambda rs: sum(r[0] for r in rs
                                         if any(k in r[2].lower() for k in CONV_NAMES))
                d_busy, d_conv = busy - n_busy, conv_ms(rows) - conv_ms(n_rows)
                by_key = {}
                for sign, rs in ((1, rows), (-1, n_rows)):
                    for ms, n, key in rs:
                        t = by_key.setdefault(key, [0.0, 0])
                        t[0] += sign * ms
                        t[1] += sign * n
                print(f"gan profile: one joint step (batch {TRAIN_BATCH}): device busy {busy:.3f} "
                      f"ms over {sum(r[1] for r in rows)} kernels, {wall_ms:.3f} ms wall under "
                      f"the profiler (idle share {max(0.0, 1 - busy / wall_ms):.3f}), "
                      f"{ms_step['joint']:.3f} ms untraced (idle share "
                      f"{max(0.0, 1 - busy / ms_step['joint']):.3f}); G's train kernels "
                      f"{g_ms:.3f} ms; D's part {d_busy:.3f} ms (its convolution kernels "
                      f"{d_conv:.3f}; the step with a one-layer D {n_busy:.3f}); the rest "
                      f"{busy - g_ms - d_busy:.3f} ms; on {card}")
                for ms, n, key in rows[:12]:
                    print(f"gan profile: step {ms:9.3f} ms {n:4d}x {key[:90]}")
                for key, (ms, n) in sorted(by_key.items(), key=lambda kv: -kv[1][0])[:6]:
                    print(f"gan profile: D's part {ms:9.3f} ms {n:4d}x {key[:90]}")
                del null_d
                t_phase = phase_done("phase 15 profile", t_phase)
            del generator, disc, snapshot
            if cuda:
                torch.cuda.empty_cache()

            # the entry point in process: 2 epochs, a resume, model.pth reloaded
            tiles = torch.from_numpy(np.random.default_rng(SEED + 73).integers(
                0, 256, (BATCH, size, size, 3), dtype=np.uint8)).to(dev)
            saved = {}
            save_model = ckpt.save_model

            def save_and_probe(model_dir, model):
                """Save, then run the tile forward of the generator as saved."""
                path = save_model(model_dir, model)
                saved["probs"] = tile_forward(model, tiles, device=dev).clone()
                return path

            with patched(ckpt, "save_model", save_and_probe):
                reset_launches()
                stage_kernel.f32_launches = 0
                _, _, best_iou, log = gan_train.run_gan_experiment(
                    cfg, synthetic=ENTRY_SYNTHETIC, epochs_override=ENTRY_EPOCHS, device=dev)
                steps = ENTRY_EPOCHS * (ENTRY_SYNTHETIC // opt["batch_size"])
                count_launches("run_gan_experiment", steps)
                mdir = cfg.model_dir()
                with open(os.path.join(mdir, "log.csv")) as f:
                    rows = f.read().splitlines()
                print(f"phase 15: run_gan_experiment on config_v1.json, {ENTRY_EPOCHS} epochs of "
                      f"{ENTRY_SYNTHETIC} synthetic scenes: best test IoU {best_iou:.4f}; log "
                      f"{dict(log)}")
                check(rows[0] == "epoch,lr,loss,iou,dice,val_loss,val_iou,val_dice"
                      and len(rows) == 1 + ENTRY_EPOCHS and log["lr"] == [opt["lr"]] * ENTRY_EPOCHS,
                      f"phase 15: log.csv {rows}")
                check(os.path.isfile(os.path.join(mdir, "model.pth")) and "probs" in saved
                      and all(ckpt.has_train_state(os.path.join(mdir, d))
                              for d in ("generator_state", "discriminator_state")),
                      "phase 15: model.pth or a state directory missing")
                opt["resume"] = True
                reset_launches()
                _, _, _, log3 = gan_train.run_gan_experiment(
                    cfg, synthetic=ENTRY_SYNTHETIC, epochs_override=ENTRY_EPOCHS + 1, device=dev)
                opt["resume"] = False
                print(f"phase 15: resumed from both state directories: epochs {log3['epoch']}")
                check(log3["epoch"] == [ENTRY_EPOCHS],
                      f"phase 15: the resume ran epochs {log3['epoch']}")
                count_launches("the resumed epoch", steps // ENTRY_EPOCHS)
                # evaluate feeds the loader's f32, as the JAX package does:
                # G's fused stages take the f32 route of kernel 1
                launches["fused_eval_stage_f32"] = stage_kernel.f32_launches
            print(f"phase 15: f32 stages (kernel 1's f32 route) launched by the evaluations: "
                  f"{launches['fused_eval_stage_f32']}")
            check(launches["fused_eval_stage_f32"] > 0,
                  "phase 15: the evaluations launched no f32 stage")
            fresh = Generator.from_config(g_config, device=dev, seed=SEED + 72)
            report = ckpt.load_model(mdir, fresh)
            probs = tile_forward(fresh, tiles, device=dev)
            same = torch.equal(probs, saved["probs"])
            print(f"phase 15: the best model.pth into a fresh Generator: {len(report['loaded'])} "
                  f"tensors, missing {report['missing']}, unmatched {report['unmatched']}; tile "
                  f"forward equal to the saved generator's bit for bit: {same}")
            check(same and not report["missing"] and not report["unmatched"],
                  "phase 15: the generator reloaded from model.pth differs from the saved one")
            del fresh, probs, saved, tiles
            t_phase = phase_done("phase 15 run_gan_experiment, resume and reload", t_phase)

            # the CLI in a process of its own, one epoch on a Sub-row PNG tree
            write_png_tree(os.path.join(tmp, "inputs"), "pngs", CLI_SPLITS, size, ncls, in_ch,
                           png.SUB)
            proc, cli_s, cli_opt = run_cli("ssunet_gan_tpu_torch.cli.train_seg_gan", here, tmp,
                                           dev, overrides or {})
            cli_dir = os.path.join(tmp, "cli_models", cli_opt["name"])
            lines = [ln for ln in proc.stdout.splitlines()
                     if "warm start" in ln or " - iou " in ln or "saved" in ln]
            print(f"phase 15: python -m ssunet_gan_tpu_torch.cli.train_seg_gan on "
                  f"{sum(n for _, n in CLI_SPLITS)} PNGs at {size}x{size}: exit "
                  f"{proc.returncode} in {cli_s:.1f} s on {card}; {lines}")
            ok = proc.returncode == 0 and any("warm start" in ln for ln in lines)
            if ok:
                with open(os.path.join(cli_dir, "log.csv")) as f:
                    ok = len(f.read().splitlines()) == 2 and os.path.isfile(
                        os.path.join(cli_dir, "model.pth"))
            check(ok, f"phase 15: the CLI exited {proc.returncode}: {proc.stdout[-1500:]} "
                      f"{proc.stderr[-3000:]}")
            phase_done("phase 15 CLI", t_phase)
    finally:
        gan_step.set_joint_gan(True)
        if yaml_before is None:
            sys.modules.pop("yaml", None)
        else:
            sys.modules["yaml"] = yaml_before
    phase_done("phase 15", t_start)
    return launches


# phase 16: data parallel at world size 1 (NCCL): the steps checked bit for
# bit against the same steps without mesh=, then timed in turns
DP_STEPS, DP_TIMED = 4, 3
# torchrun over this machine's one card, its rendezvous on a free local port
TORCHRUN_ONE = ("-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1")


def _state_equal(a: dict, b: dict):
    """The names of the tensors of two state_dicts that differ by a bit."""
    return [k for k in a if not torch.equal(a[k], b[k])]


@contextlib.contextmanager
def deterministic():
    """The library's deterministic algorithms while active (cuDNN and the
    index_add_ of the bilinear seams' backward pick an order of their own
    otherwise), so that two runs of one step can be compared bit for bit."""
    before = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.deterministic = before[1]


def dp_phase(dev, card, here, check, hw=HW, batch=TRAIN_BATCH, scene_hw=SCENE_HW,
             overrides=None):
    """Phase 16: the data-parallel paths at world size 1, one process group
    over NCCL (gloo on the CPU) from a ``file://`` store: the flagship's
    supervised step (``make_train_step(mesh=)``, the fused train stages, v3
    backward, phase 6's weights and batches at 512², batch 8, bf16) for
    DP_STEPS steps, one joint GAN step (phase 15's G and D,
    ``make_gan_train_step(mesh=)``) and the sharded scene
    (``segmentation_inference(mesh=)`` on phase 14's 5000² scene), each
    bit for bit against the same run without ``mesh=`` (metrics,
    parameters, gradients, BatchNorm statistics; probabilities and masks).
    Then DP_TIMED steps of each timed in turns from ``settle()`` (a ``dp:``
    line with the collectives per step). The counts are set to 0 just
    before each mesh run and read just after; returns {kernel: launches}
    of the mesh runs. Then ``torchrun --standalone --nproc-per-node 1 -m
    ssunet_gan_tpu_torch.cli.train`` for one epoch on a PNG tree: the
    entry path over N cards, at one. The sizes shrink for a rehearsal on
    the CPU."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from ssunet_gan_tpu_torch import native
    from ssunet_gan_tpu_torch.config import load_experiment_config
    from ssunet_gan_tpu_torch.data import png
    from ssunet_gan_tpu_torch.data.dataset import SyntheticDataset
    from ssunet_gan_tpu_torch.data.loader import BatchLoader
    from ssunet_gan_tpu_torch.data.tiling import grid_coords
    from ssunet_gan_tpu_torch.data.transforms import val_transform
    from ssunet_gan_tpu_torch.infer import api
    from ssunet_gan_tpu_torch.models import build_model
    from ssunet_gan_tpu_torch.models.gan import Discriminator, Generator
    from ssunet_gan_tpu_torch.ops import collectives, stage_kernel
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
    from ssunet_gan_tpu_torch.ops.losses import get_loss
    from ssunet_gan_tpu_torch.parallel import make_mesh
    from ssunet_gan_tpu_torch.train import gan as gan_train
    from ssunet_gan_tpu_torch.train import gan_step
    from ssunet_gan_tpu_torch.train.optim import adam, build_optimizer, build_scheduler
    from ssunet_gan_tpu_torch.train.step import make_train_step

    t_start = t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    cfg = load_experiment_config(os.path.join(here, "configs", "config_v1.json"))
    cfg.opt_config.update(overrides or {})
    opt = cfg.opt_config
    ncls, in_ch = opt["num_classes"], opt["input_channels"]
    loss_fn = get_loss(opt["loss"])
    check(tst._TRAIN_BWD_V3, "phase 16: the default train backward is not v3")
    counts = {k: 0 for k in TRAIN_KERNELS}
    counts["fused_eval_stage"] = 0

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def counted(fn):
        """``fn()`` with the kernel counts set to 0 just before it, read just
        after and added to this path's."""
        sync()
        reset_launches()
        stage_kernel.launches = 0
        out = fn()
        sync()
        for k, v in read_launches().items():
            counts[k] += v
        counts["fused_eval_stage"] += stage_kernel.launches
        return out

    store = tempfile.mkdtemp()
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh()
        print(f"phase 16: process group {dist.get_backend()} of {mesh.size}, mesh "
              f"{mesh.shape} on {mesh.device}")
        check(mesh.size == 1 and mesh.group is not None,
              f"phase 16: mesh {mesh.shape} group {mesh.group}")

        # (a) the supervised step: phase 6's weights and batches
        ds = SyntheticDataset(DP_STEPS * batch, hw, hw, ncls, in_ch,
                              transform=val_transform(opt), seed=2)
        batches = [(torch.from_numpy(img).to(dev).to(torch.bfloat16),
                    torch.from_numpy(mask).to(dev))
                   for _, img, mask, _ in BatchLoader(ds, batch, num_workers=2)]
        lr = build_scheduler(opt).lr(0)
        init = build_model(opt["arch"], ncls, in_ch, opt["deep_supervision"], seed=SEED,
                           device=dev).state_dict()

        def trainer(use_mesh):
            model = build_model(opt["arch"], ncls, in_ch, opt["deep_supervision"],
                                device=dev)
            model.load_state_dict(init)
            optimizer = build_optimizer(model.parameters(), opt)
            step = make_train_step(model, loss_fn, optimizer, ncls, opt["deep_supervision"],
                                   clip=float(opt["clip"]), mesh=mesh if use_mesh else None)
            return model, step

        def supervised(use_mesh):
            model, step = trainer(use_mesh)
            metrics = []
            for x, y in batches:
                m = step(x, y, lr)
                metrics.append({k: v.clone() for k, v in m.items()})
            grads = {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}
            return metrics, model.state_dict(), grads

        with deterministic():
            plain = supervised(False)
            dp = counted(lambda: supervised(True))
        per_step = PER_STEP["v3"]
        got = {k: counts[k] for k in TRAIN_KERNELS}
        print(f"phase 16: supervised step: train kernel launches with mesh= in {DP_STEPS} "
              f"steps {got} (phase 6's per step: {per_step})")
        check(got == {k: DP_STEPS * v for k, v in per_step.items()},
              f"phase 16: supervised launches {got} != {DP_STEPS} x {per_step}")
        diff_m = [(i, k) for i, (a, b) in enumerate(zip(plain[0], dp[0])) for k in a
                  if not torch.equal(a[k], b[k])]
        diff_s, diff_g = _state_equal(plain[1], dp[1]), _state_equal(plain[2], dp[2])
        print(f"phase 16: supervised step with mesh= against without, {DP_STEPS} steps: "
              f"metrics differing {diff_m or 'none'}; parameters and BN statistics differing "
              f"{len(diff_s)} of {len(plain[1])}; gradients differing {len(diff_g)} of "
              f"{len(plain[2])}; loss per step "
              f"{[round(m['loss'].item(), 6) for m in dp[0]]}")
        check(not diff_m and not diff_s and not diff_g and plain[1].keys() == dp[1].keys(),
              f"phase 16: supervised step not bit-equal: metrics {diff_m}, state "
              f"{diff_s[:5]}, grads {diff_g[:5]}")
        check(all(bool(torch.isfinite(m["loss"])) for m in dp[0]),
              "phase 16: supervised losses not finite")
        del plain, dp
        t_phase = phase_done("phase 16 supervised step", t_phase)

        # (b) one joint GAN step: phase 15's G (the calibrated flagship) and D
        a, b = api._norm_consts()
        calib = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
            0, 256, (2, hw, hw, in_ch), dtype=np.uint8)).to(dev)
        sup = build_model(opt["arch"], ncls, in_ch, opt["deep_supervision"], seed=SEED,
                          device=dev)
        calibrate_batchnorm(sup, calib.float() * a.to(dev) + b.to(dev))
        g_init = sup.state_dict()
        gx, gy = batches[0]

        def gan(use_mesh):
            generator = Generator.from_config(dict(opt, name=opt["generator_name"]),
                                              device=dev, seed=SEED + 70)
            generator.net.load_state_dict(g_init)
            disc = Discriminator(ncls, gan_train.D_KERNEL, gan_train.D_CHANNELS,
                                 gan_train.D_BLOCKS, gan_train.D_FC,
                                 generator=torch.Generator().manual_seed(SEED + 71)).to(dev)
            step = gan_step.make_gan_train_step(generator, disc, loss_fn,
                                                adam(generator.parameters()),
                                                adam(disc.parameters()), ncls,
                                                mesh=mesh if use_mesh else None)
            m = step(gx, gy, float(opt["gan_lr"]))
            return ({k: v.clone() for k, v in m.items()},
                    {f"G.{k}": v for k, v in generator.state_dict().items()}
                    | {f"D.{k}": v for k, v in disc.state_dict().items()},
                    {f"{w}.{n}": p.grad.clone() for w, mod in (("G", generator), ("D", disc))
                     for n, p in mod.named_parameters() if p.grad is not None})

        gan_step.set_joint_gan(True)
        before = dict(counts)
        with deterministic():
            plain = gan(False)
            dp = counted(lambda: gan(True))
        gan_launches = {k: counts[k] - before[k] for k in TRAIN_KERNELS}
        diff_m = [k for k in plain[0] if not torch.equal(plain[0][k], dp[0][k])]
        diff_s, diff_g = _state_equal(plain[1], dp[1]), _state_equal(plain[2], dp[2])
        print(f"phase 16: joint GAN step with mesh= against without: metrics differing "
              f"{diff_m or 'none'}; G and D parameters and buffers differing {len(diff_s)} of "
              f"{len(plain[1])}; clamped gradients differing {len(diff_g)} of "
              f"{len(plain[2])}; train kernel launches {gan_launches}; metrics "
              f"{ {k: round(v.item(), 6) for k, v in dp[0].items()} }")
        check(not diff_m and not diff_s and not diff_g,
              f"phase 16: GAN step not bit-equal: metrics {diff_m}, state {diff_s[:5]}, "
              f"grads {diff_g[:5]}")
        check(gan_launches == PER_STEP["v3"],
              f"phase 16: GAN step launches {gan_launches} != {PER_STEP['v3']}")
        del plain, dp, sup, calib
        t_phase = phase_done("phase 16 GAN step", t_phase)

        # (c) the sharded scene: phase 14's scene and model (calibrated, head
        # centred), the tile server's tiles
        scene = smooth_scene(scene_hw, SEED + 70, dev)
        smodel = build_model(opt["arch"], ncls, in_ch, opt["deep_supervision"], seed=SEED,
                             device=dev)
        calib = np.random.default_rng(SEED + 2).integers(0, 256, (2, hw, hw, 3), np.uint8)
        calib = torch.from_numpy(calib).to(dev).float() * a.to(dev) + b.to(dev)
        calibrate_batchnorm(smodel, calib)
        center_head(smodel, calib)
        smodel.eval()
        sconfig = dict(opt, patch_size=1024, patch_overlap=0.5, input_h=hw, input_w=hw)
        p_size = api.effective_patch_size(scene_hw, scene_hw, 1024)
        coords = grid_coords(scene_hw, scene_hw, p_size, 0.5)
        tiles = native.extract_resize_u8(np.ascontiguousarray(scene), coords, p_size, hw, hw)

        def sharded(use_mesh):
            m = mesh if use_mesh else None
            probs = api._chunked_forward(smodel, tiles, device=dev, mesh=m)
            masks = api.segmentation_inference(smodel, scene, tiles, None, sconfig, False,
                                               device=dev, mesh=m)[0]
            return probs, np.stack(masks)

        before = counts["fused_eval_stage"]
        plain = sharded(False)
        dp = counted(lambda: sharded(True))
        scene_stages = counts["fused_eval_stage"] - before
        n_chunks = -(-len(coords) // api.INFER_BATCH)
        share = [float((m > 0).mean()) for m in dp[1]]
        print(f"phase 16: sharded scene {scene_hw}² ({len(coords)} tiles, {n_chunks} chunks) "
              f"with mesh= against without: probabilities bit-equal "
              f"{torch.equal(plain[0], dp[0])}, masks bit-equal "
              f"{np.array_equal(plain[1], dp[1])}; kernel-1 stages {scene_stages}; mask "
              f"shares {[round(v, 4) for v in share]}")
        check(torch.equal(plain[0], dp[0]) and np.array_equal(plain[1], dp[1]),
              "phase 16: the sharded scene differs from the unsharded one")
        if cuda:
            check(scene_stages == 2 * 6 * n_chunks,
                  f"phase 16: {scene_stages} kernel-1 stages in the two scene passes, "
                  f"expected {2 * 6 * n_chunks}")
        del plain, dp, tiles, scene, smodel
        t_phase = phase_done("phase 16 sharded scene", t_phase)

        # (d) ms/step with and without mesh=, in turns (plain, mesh, mesh,
        # plain) from settle(), and the collectives of one step
        if cuda:
            times = {False: [], True: []}
            for use_mesh in (False, True, True, False):
                model, step = trainer(use_mesh)
                step(*batches[0], lr)  # warm-up
                settle()
                t0 = time.perf_counter()
                for x, y in batches[1:DP_TIMED + 1]:
                    step(x, y, lr)
                torch.cuda.synchronize()
                times[use_mesh].append((time.perf_counter() - t0) / DP_TIMED * 1e3)
                if use_mesh:
                    c0 = dict(collectives.calls)
                    step(*batches[0], lr)
                    torch.cuda.synchronize()
                    per = {k: collectives.calls[k] - c0[k] for k in c0}
                del model, step
            print(f"dp: flagship supervised step at world size {mesh.size} ({dist.get_backend()}"
                  f"), 512² bf16 batch {batch}, v3: without mesh= "
                  f"{', '.join(f'{t:.2f}' for t in times[False])} ms/step, with mesh= "
                  f"{', '.join(f'{t:.2f}' for t in times[True])} ms/step ({DP_TIMED} steps "
                  f"each, turns plain / mesh / mesh / plain); collectives per step: "
                  f"{per['all_reduce']} all-reduces, {per['bytes']} bytes; on {card}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    # (e) the multi-card entry path at one card: torchrun starts the CLI,
    # whose main takes its NCCL group from torchrun's environment
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp()
    try:
        write_png_tree(os.path.join(tmp, "inputs"), "pngs", CLI_SPLITS, hw, ncls, in_ch,
                       png.SUB)
        proc, cli_s, _ = run_cli("ssunet_gan_tpu_torch.cli.train", here, tmp, dev,
                                 overrides or {}, launcher=TORCHRUN_ONE)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    backend = "nccl" if cuda else "gloo"
    mesh_line = f"=> data mesh: {backend} group of 1 ranks, rank 0 on {dev.type}" + (
        ":0" if cuda else "")
    lines = proc.stdout.splitlines()
    tail = [ln for ln in lines if " - iou " in ln]
    print(f"phase 16: torchrun --nproc-per-node 1 -m ssunet_gan_tpu_torch.cli.train on "
          f"{sum(n for _, n in CLI_SPLITS)} PNGs at {hw}x{hw}: exit {proc.returncode} in "
          f"{cli_s:.1f} s on {card}; mesh line {mesh_line in lines}; {tail}")
    check(proc.returncode == 0 and mesh_line in lines and len(tail) == 1,
          f"phase 16: torchrun's CLI exited {proc.returncode}, mesh line {mesh_line in lines}, "
          f"{len(tail)} epoch lines: {proc.stdout[-1500:]} {proc.stderr[-3000:]}")
    phase_done("phase 16 torchrun CLI", t_phase)
    phase_done("phase 16", t_start)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 2
    from ssunet_gan_tpu_torch import _build
    from ssunet_gan_tpu_torch.config import load_experiment_config
    from ssunet_gan_tpu_torch.data.tiling import extract_patches, grid_coords
    from ssunet_gan_tpu_torch.infer.api import INFER_BATCH, _norm_consts
    from ssunet_gan_tpu_torch.models import build_model
    from ssunet_gan_tpu_torch.ops import (
        spade_kernel,
        stage_kernel,
        stage_kernel_bneck,
        stage_kernel_int8,
        stage_kernel_train,
        train_bwd,
    )
    from ssunet_gan_tpu_torch.ops.blocks import BasicBlock

    torch.backends.cudnn.allow_tf32 = False  # the plain f32 convs stay f32
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    failures = []

    def check(ok: bool, msg: str) -> None:
        """Record a failed comparison; the run fails after printing them all."""
        if not ok:
            failures.append(msg)
            print(f"chip_smoke: check failed: {msg}", file=sys.stderr)

    # ---- phase 0: card and build
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    sources = (stage_kernel.SOURCE, stage_kernel_train.SOURCE, train_bwd.SOURCE,
               stage_kernel_int8.SOURCE, stage_kernel_bneck.SOURCE, spade_kernel.SOURCE,
               stage_kernel.SOURCE_F32)
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
        list(pool.map(_build.build, sources))
    print(f"phase 0: kernels built in {time.perf_counter() - t0:.2f} s")
    for source in (stage_kernel.SOURCE, stage_kernel_bneck.SOURCE, stage_kernel_train.SOURCE):
        counts = hgmma_counts(_build.build(source))
        if counts is None:
            print(f"phase 0: no cuobjdump beside nvcc; the SASS of {source} is not read")
            continue
        print(f"phase 0: HGMMA in {source}'s eval conv core: {sorted(counts.values())}")
        check(len(counts) > 0 and all(counts.values()),
              f"phase 0: {source}: an eval conv core instantiation without wgmma: {counts}")
    counts = hgmma_counts(_build.build(stage_kernel_int8.SOURCE), "s8_conv_core", "IGMMA")
    if counts is not None:
        print(f"phase 0: IGMMA in {stage_kernel_int8.SOURCE}'s s8 conv core: "
              f"{sorted(counts.values())}")
        check(len(counts) > 0 and all(counts.values()),
              f"phase 0: an s8 conv core instantiation without wgmma: {counts}")
    for source in sources:
        for line in _build.build_log(source).splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry", "wgmma")):
                print(f"  ptxas {source}:", line.strip())
    spills = ptxas_spills(_build.build_log(stage_kernel_int8.SOURCE), "s8_conv_core")
    print(f"phase 0: s8 conv core instantiations {len(spills)}, spill bytes (stores, loads) "
          f"{sorted(spills.values())}")
    check(len(spills) > 0 and not any(st or ld for st, ld in spills.values()),
          f"phase 0: the s8 conv core spills: {spills}")
    t_phase = time.perf_counter()

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_experiment_config(os.path.join(here, "configs", "config_v1.json")).opt_config
    ncls, in_ch = cfg["num_classes"], cfg["input_channels"]
    gen = torch.Generator().manual_seed(SEED)

    # the scene request of phase 3: 36 tiles of 512² from a 2048² scene
    scene = np.random.default_rng(SEED + 1).integers(0, 256, (2048, 2048, in_ch), dtype=np.uint8)
    config = {"patch_size": 1024, "patch_overlap": 0.5, "num_classes": ncls,
              "input_h": HW, "input_w": HW}
    coords = grid_coords(2048, 2048, 1024, 0.5)
    scene_tiles = np.ascontiguousarray(extract_patches(scene, coords, 1024)[:, ::2, ::2])
    if len(coords) != 36 or -(-len(coords) // INFER_BATCH) != 2:
        fail(f"expected 36 tiles in 2 chunks, got {len(coords)}")

    # ---- phase 1: kernel against plain, six signatures, 512² batch 2, then
    # the model's weights on each stage's own inputs
    model = build_model(cfg["arch"], ncls, in_ch, cfg["deep_supervision"],
                        seed=SEED, device=dev)
    a, b = _norm_consts()
    calib = np.random.default_rng(SEED + 2).integers(0, 256, (2, HW, HW, in_ch), dtype=np.uint8)
    calib = torch.from_numpy(calib).to(dev).float() * a.to(dev) + b.to(dev)
    calibrate_batchnorm(model, calib)
    sigs = stage_signatures(model.filters, ncls, in_ch)
    seeded_err = seeded_stage_phase(dev, sigs, BasicBlock, gen, "phase 1", check,
                                    seams=FLAGSHIP_SEAMS)[0]
    stages = model_stage_phase(dev, model, sigs, scene_tiles, "phase 1", "flagship", check,
                               FLAGSHIP_SEAMS)
    t_phase = phase_done("phase 1", t_phase)

    # ---- phases 2-3: the flagship tile forward and scene request (main path)
    tiles = np.random.default_rng(SEED).integers(0, 256, (BATCH, HW, HW, in_ch), dtype=np.uint8)
    x = torch.from_numpy(tiles).to(dev)
    serve = bf16_serving_phase(dev, card, model, sigs, x, scene, scene_tiles, config, check,
                               "flagship", ("phase 2", "phase 3"), FLAGSHIP_SEAMS)
    t_phase = time.perf_counter()

    # the f32 route of kernel 1 per stage; then an f32 forward on the card,
    # its fused stages on that route (the flagship's f32 path: the counts
    # set to 0 just before it), the same forward on the CPU with the fused
    # eval stages off its yardstick
    f32_row = f32_stage_phase(dev, sigs, BasicBlock, gen, check)
    nan_witness(dev, BasicBlock, torch.Generator().manual_seed(SEED + 9), check)
    xn = x.float() * a.to(dev) + b.to(dev)
    before = stage_kernel.launches
    stage_kernel.f32_launches = 0
    with torch.no_grad():
        f32_card = model(xn[:1]).cpu()
    f32_row["launches"] = stage_kernel.f32_launches
    cpu_model = copy.deepcopy(model).cpu()
    stage_kernel.set_fused_stage(False)
    try:
        with torch.no_grad():
            f32_cpu = cpu_model(xn[:1].cpu())
    finally:
        stage_kernel.set_fused_stage(None)
    e_f32 = rel_l2(f32_card, f32_cpu)
    print(f"phase 2: f32 flagship forward on the card ({f32_row['launches']} stages on the "
          f"f32 route, {stage_kernel.launches - before} bf16 ones) against the CPU f32 "
          f"forward: rel_l2 {e_f32:.4g} (bar {F32_CARD_TOL:g}), max|CPU| "
          f"{f32_cpu.abs().max().item():.4g}")
    check(stage_kernel.launches == before and f32_row["launches"] == len(sigs)
          and bool(torch.isfinite(f32_card).all()) and e_f32 <= F32_CARD_TOL,
          f"phase 2: f32 card forward: {f32_row['launches']} f32 stages of {len(sigs)}, "
          f"{stage_kernel.launches - before} bf16 ones, rel_l2 {e_f32} from the CPU forward")
    f32_row = {"name": "fused_eval_stage_f32", "route": "cuda",
               "source": f"ssunet_gan_tpu_torch/csrc/{stage_kernel.SOURCE_F32}",
               "replaces": stage_kernel.REPLACES, **f32_row}
    del cpu_model, f32_card, f32_cpu, xn
    eval_row = {
        "name": "fused_eval_stage", "route": "cuda",
        "source": f"ssunet_gan_tpu_torch/csrc/{stage_kernel.SOURCE}",
        "replaces": stage_kernel.REPLACES, "launches": serve["launches"], **stages,
        "max_abs_err": max(stages["max_abs_err"], seeded_err), "library_ms": None,
        "seam_reads": serve["seam_reads"],
    }
    t_phase = phase_done("phase 2 f32 card forward", t_phase)

    # ---- phases 7-8: the int8 stages, then int8 serving (the second main path)
    int8_err = int8_stage_phase(dev, sigs, check, FLAGSHIP_INT8_SEAMS)
    phase_done("phase 7", t_phase)
    with no_seam_reads("phase 8: flagship int8", check):
        int8_row = int8_serving_phase(
            dev, card, model, sigs, check, x, scene, scene_tiles, config, serve.pop("f32"),
            serve, "phase 8", "flagship", FLAGSHIP_BILINEAR, FLAGSHIP_DEEP, FLAGSHIP_INT8_SEAMS)
    int8_row["max_abs_err"] = max(int8_row["max_abs_err"], int8_err)
    del model, serve
    torch.cuda.empty_cache()

    # ---- phases 9-10: the bottleneck stage, then UNet_B_SS serving (the
    # third serving path) and UNet_R_SS's forward
    t_phase = time.perf_counter()
    model_b = build_model("UNet_B_SS", ncls, in_ch, seed=SEED, device=dev)
    calibrate_batchnorm(model_b, calib)
    bsigs = bneck_signatures(model_b.filters, ncls, in_ch)
    bneck_row = bneck_stage_phase(dev, model_b, bsigs, scene_tiles, check)
    phase_done("phase 9", t_phase)
    bneck_row["launches"], bneck_row["seam_reads"] = bneck_serving_phase(
        dev, card, model_b, bsigs, x, scene, scene_tiles, config, check)
    del model_b
    torch.cuda.empty_cache()
    rss_forward_phase(dev, card, cfg, x, calib, check)

    # ---- phase 12: SSUNet (kernels 1, 7 and 9 on its VGG stages)
    ssunet_runs = ssunet_phase(dev, card, cfg, calib, x, scene, scene_tiles, config, check)
    del x, calib
    torch.cuda.empty_cache()

    with no_seam_reads("phases 4-6: flagship training", check):
        counts, train_err, totals, sup_ms_step = train_phases(dev, cfg, card, sigs, check)

    # ---- phase 11: the standalone self-SPADE and UNet_B_SS's trainer
    with no_seam_reads("phase 11: UNet_B_SS training", check):
        spade_row = spade_phase(dev, card, cfg, bsigs, check)

    # ---- phase 13: the training entry point (kernels 2, 3, 5 and 6)
    stage_kernel.f32_launches = 0
    entry_counts = entry_point_phase(dev, card, here, check)
    entry_counts["fused_eval_stage_f32"] = stage_kernel.f32_launches
    print(f"phase 13: f32 stages launched by run_experiment's evaluations: "
          f"{stage_kernel.f32_launches}")
    check(stage_kernel.f32_launches > 0, "phase 13: the evaluations launched no f32 stage")

    # ---- phase 14: whole-scene inference through its entry point (kernels 1 and 7)
    scene_counts, scene_seams, scene_s8_seams = scene_phase(dev, card, here, check,
                                                            int8_row.pop("quant_per_forward"))

    # ---- phase 15: the adversarial fine-tune (kernels 2, 3, 5 and 6)
    gan_counts = gan_phase(dev, card, here, check, sup_ms_step)

    # ---- phase 16: the data-parallel paths at world size 1 (kernels 1, 2, 3, 5, 6)
    dp_counts = dp_phase(dev, card, here, check)
    dp_train = {k: dp_counts[k] for k in ("conv_stats", "train_tail", "fused_conv3",
                                          "fused_wgrad")}
    print(f"phase 16: launches on the dp path {dp_counts}")
    check(all(dp_train.values()), f"phase 16: a train kernel never launched on the dp path: "
                                  f"{dp_train}")

    if failures:
        fail(f"{len(failures)} checks failed: " + "; ".join(failures[:20]))

    kernels = [eval_row, f32_row, int8_row] + [{
        "name": kname, "route": "cuda",
        "source": "ssunet_gan_tpu_torch/csrc/" + getattr(
            kernel_module(kname), "KERNEL_SOURCE", {}).get(kname, kernel_module(kname).SOURCE),
        "replaces": kernel_module(kname).REPLACES[kname],
        "launches": counts[kname], "max_abs_err": train_err[kname],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "operations" if "operations" in t["kinds"] else "bytes",
        "library_ms": None if kname == "train_tail" else t["library_ms"],
    } for kname, t in totals.items()] + [bneck_row, spade_row]
    # each row's launches on every main path that runs it: the flagship's
    # (phases 2-3, 6, 8, 10-11) and SSUNet's (phase 12), the entry point's
    # (phase 13); rows 1, 7 and 8 also the seams their kernels read there
    for row in kernels:
        path = ("flagship" if row["name"] not in ("fused_eval_stage_bneck", "fused_spade_stage")
                else "UNet_B_SS")
        paths = {path: row["launches"]}
        if row["name"] in ssunet_runs:
            n, err = ssunet_runs[row["name"]]
            paths["SSUNet"] = n
            row["max_abs_err"] = max(row["max_abs_err"], err)
        if row["name"] in entry_counts:
            paths["run_experiment"] = entry_counts[row["name"]]
        if row["name"] in scene_counts:
            paths["val_patch"] = scene_counts[row["name"]]
        if row["name"] in gan_counts:
            paths["gan"] = gan_counts[row["name"]]
        if dp_counts.get(row["name"]):
            paths["dp"] = dp_counts[row["name"]]
        row["launches"] = sum(paths.values())
        row["launches_by_path"] = paths
        if "seam_reads" in row:
            by_path = {path: row.pop("seam_reads")}
            if row["name"] == "fused_eval_stage":
                by_path["SSUNet"] = ssunet_runs["seam_reads"]
                by_path["val_patch"] = scene_seams
            elif row["name"] == "fused_eval_stage_int8":
                by_path["SSUNet"] = ssunet_runs["s8_seam_reads"]
                by_path["val_patch"] = scene_s8_seams
            row["up_reads"] = sum(r[0] for r in by_path.values())
            row["pool_reads"] = sum(r[1] for r in by_path.values())
            row["seam_reads_by_path"] = {k: {"up": u, "pool": p} for k, (u, p) in by_path.items()}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
