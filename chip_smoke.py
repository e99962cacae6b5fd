#!/usr/bin/env python3
"""Build and drive the PyTorch port (voxelmorph_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository:

    python3 chip_smoke.py            # the smoke run
    python3 chip_smoke.py --profile  # also print a profiler breakdown of one call
    python3 chip_smoke.py --compare-warp-source OLD/warp_bounded.cu
        # also time another build of the warp kernels (an earlier commit's
        # csrc/warp_bounded.cu) on phases 2 and 2b's inputs
    python3 chip_smoke.py --compare-gather-source OLD/warp_gather.cu
        # also time an earlier commit's gather kernels on phase 2e's inputs
    python3 chip_smoke.py --conditioning
        # also the readings behind phase 8's and 12c's card-vs-CPU limits,
        # 12c's dispatch halo and 13c's masked faces
    python3 chip_smoke.py --nccl-ranks 4
        # instead of the smoke run (on a host with 4 cards): phase 15c alone

Phases:
  1. device and build: the card's name and power limit (nvidia-smi), then
     every CUDA kernel of the port built with nvcc from csrc/, all at once,
     and the conv kernel's tensor-core instructions (HMMA) counted in its
     machine code (cuobjdump), which must not be none;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it and at stress shapes, with times
     beside the bound (and bound_share, the bound over the time), the plain
     version, one PyTorch library call and, for the warp, one elementwise op
     that moves the same bytes; a kernel and the calls it is compared with
     are timed in turns;
  2b. the bounded-warp backward kernel against its plain version at phase
     2's shapes, bit-equal across two launches, with times beside the bound,
     the plain version and the backward of grid_sample, on the phase's
     random shifts and on a smooth field of the same bound;
  2c. gradients through warp_bounded and integrate_vec_batched on CUDA
     tensors (the backward kernel) against the same on the CPU;
  2d. the conv kernel against its plain version at the full-width U-Net's
     11 conv shapes, bfloat16 and float32, forward (both rounding orders)
     and the input-gradient orientation, on channels-last inputs as the
     U-Net feeds them, bit-equal across two launches, with times beside the
     bound, the plain version and cuDNN's conv3d on the same inputs;
  2e. the tiered warp's predicated kernels at each tier of {1, 2} at the
     squaring shape, 1 to 4 channels: every branch launched with the
     device's tier word into its own NaN-filled buffer (the gather's dvol,
     which it adds into, zeroed where it is named), only the named one
     writing, equal to the unpredicated kernel or the torch gather
     (forward and dshift bit for bit, the gather's dvol within 1e-5);
     transform_batched forward and backward through them, with its device
     work counters; its time against the host-chosen call's, the time of a
     launch that returns at once, and the gather kernels against the torch
     gather and grid_sample, on a smooth field and a rough one, with the
     backward's atomic adds and the terms it merged into a neighbouring
     lane's add, and beside any --compare-gather-source build;
  2e(i). (after phase 3) the gather kernels at the serving warp's shape,
     160x192x224 with one channel, on a smooth field of the max|d| of
     phase 3's final warp and on that flow itself, as in 2e;
  3. the serving path end to end: the committed full-width VxmDense
     checkpoint (160x192x224, bfloat16) registers a synthetic smooth pair
     through build_register_fn; the work counters of that call must show a
     bounded kernel running and each tiered warp running exactly one of its
     branches (as in every path below that gates them), and its outputs
     must agree with the port's own bfloat16 CPU run; then the same in
     float32 (TF32 off) against the port's own CPU run, and the bfloat16
     outputs against the float32 ones;
  3b. serving with the conv kernel (set_pallas_conv(True), the JAX
     package's VXM_PALLAS_CONV=1): 11 conv launches and no layout copy per
     register call, float32 kernel mode against float32 cuDNN mode, bfloat16
     against float32;
  3c. --fast-warp (enable_fast_warp) at full width: four halo-2 bounded
     warps by the integration root for the moved image, the warp unchanged;
     the card against the port's CPU run at 80x96x112;
  4. training at full width: the default recipe of scripts/train.py (MSE +
     Grad-l2, Adam 1e-4, float32) on VxmDense at 160x192x224 from seed 0:
     one step's loss and gradients through the kernels against the
     gather-only path, the card against the port's CPU run at 80x96x112,
     ten steps that lower the loss with the backward kernel launched in
     every step, the time per step and the peak memory; then three steps of
     the committed checkpoint's own recipe (use_probs, NCC, KL, bfloat16);
  4b. training with the conv kernel: one step's loss and gradients against
     cuDNN mode, then three steps that lower the loss, 21 conv launches per
     step (11 forward, 10 input gradients) and no layout copy;
  5. semi-supervised segmentation training at full width: the recipe of
     scripts/train_semisupervised_seg.py (MSE + Grad-l2 + Dice, Adam 1e-4,
     float32) on VxmDenseSemiSupervisedSeg from seed 0, with a synthetic
     30-label map (a Voronoi partition of the head mask) one-hot at half
     resolution as generators.semisupervised gives it: one step's loss and
     gradients on the card against the port's CPU run at 80x96x112; the
     segmentation warp (30 channels: the gather) launching no kernel; three
     steps in cuDNN mode and three with the conv kernel (flow head redrawn,
     as in 4b) that lower the loss, the first launching what phases 4 and
     4b's VxmDense step from the same weights launches, seconds per step and
     peak memory;
     then the warp of a 40-label one-hot at 80x96x112 (the wide-channel
     gather), value and flow gradient, against the CPU;
  5b. the warp ops on the card against the port's CPU run: transform with
     affine matrices, compose, integrate_vec (ss, quadrature, ode),
     jacobian_determinant, and cli/warp at full width with a dense warp and
     with an affine;
  6. point-cloud semi-supervised training at full width: the recipe of
     scripts/train_semisupervised_pointcloud.py with --surf-bidir (MSE both
     ways at 0.5, Grad-l2 at 0.01, the SDT terms at 0.25, Adam 1e-4,
     float32, 5000 surface points of 4 of phase 5's 30 labels a step) on
     VxmDenseSemiSupervisedPointCloud: generators.surf_semisupervised on the
     card against the CPU at 80x96x112 (8 labels), bit for bit; one step's
     loss and gradients on the card against the CPU there; the generator's
     seconds per draw at full width on the card; three steps in cuDNN mode
     and three with the conv kernel (flow head redrawn) that lower the loss,
     with their launches, seconds and peak memory; the checkpoint registered
     through cli/register via registration_model;
  6b. --cache-device and --steps-per-dispatch: Trainer.fit_cached_pairs on 4
     full-width volumes held on the card, one 4-step dispatch against 4
     single steps from the same weights on the same picks (params bit-equal
     with cudnn.deterministic, else within 1e-6 of their largest
     magnitude), 1 host fetch of metrics against 4, seconds per step; then
     phase 4's step with and without the rematerialised integration
     (gradients bit-equal; peak memory and seconds per step);
  6c. a 2-D VxmDense on the pair's middle slice (192x224): one step's
     gradients and three steps and a register call, card against CPU, no
     kernel launched; a 3-D VxmDense with do_res and a tanh final activation
     at full width, bfloat16 and float32, conv kernel against cuDNN mode,
     every conv launched with the activation off;
  6d. Trainer.fit with prefetch and without, of the point-cloud recipe
     from its generator on the card (on its own stream) and of cli/train's
     default from scan_to_scan over npz files: the parameters bit-equal,
     seconds per step of each, and the seconds of each part of one
     point-cloud draw (components, blur, EDT, x2 zoom, point draws);
  6e. the U-Net's per-block remat on and off in phase 4's step, cuDNN and
     conv-kernel mode: gradients bit-equal (cudnn.deterministic), conv
     launches, peak memory and seconds per step;
  7. a full-width register call and one float32 train step of the default
     recipe, the flow head redrawn until the warps take all three tiers
     (VXM_WINDOW_HALO=2; the tier of each warp read from the work counters
     around its launches), in cuDNN and conv-kernel mode, each under
     torch.cuda.set_sync_debug_mode("error"): any host synchronisation in
     them fails the run;
  8. template creation at full width: scripts/train_template.py's recipe
     (NCC, float32, TF32 off) on TemplateCreation from seed 0, the atlas
     seeded with the pair's other image (--init-template), ten steps in
     cuDNN mode and ten with the conv kernel that lower the loss, each with
     its work counters, the atlas's full-resolution warp backward writing
     a non-zero dvol through the halo-1 bounded kernel (the warp's autograd
     Function wrapped to record it), a finite non-zero atlas gradient and
     MeanStream counting every sample; then, the flow head redrawn
     N(0, 0.2), one step whose atlas dvol comes from the gather backward's
     atomics, and that step (with --image-loss mse) at 80x96x112 on the
     card against the CPU (loss, every gradient, MeanStream's buffers);
     seconds per step, peak memory;
  8b. the conditional template (a 4-value phenotype, 4 features, 3 extra
     convs) at full width: four steps, gated as 8, the Dense weight's bytes;
  9. atlas-based segmentation at full width: a probabilistic atlas of 4
     classes made on the card, three steps of
     scripts/train_unsupervised_seg.py's recipe in each conv mode (the stat
     ConvBlocks, ci 5, through the conv kernel: 36 launches a step), the
     stat ConvBlocks' outputs with the conv kernel against cuDNN; then
     cli/test_unsupervised_seg with a 30-label atlas mapped onto the 4
     classes, 21 labels a chunk (the wide gather), at full width on the card
     and at 80x96x112 on the card against the CPU;
  10. cli/train_instance at full width warm-started from the committed
     checkpoint, 20 steps that lower the loss, a step's time and launches at
     the script's defaults, and Transform of its warp and of an affine
     against transform_batched and warp.transform;
  11a. HyperMorph serving: the committed HyperVxmDense checkpoint
     (float32, trained at 80x96x112) re-targeted to 160x192x224 registers
     smooth_pair at lambda 0, 0.5 and 1, each call's work counters gated;
     lambda changes the warp; with set_pallas_conv(True) the hyper blocks
     launch no conv kernel and the outputs are bit-equal to cuDNN mode; the
     card against the port's CPU run at 80x96x112, bfloat16 against
     float32; ms per pair at lambda 0.5;
  11b. HyperMorph training: scripts/train_hypermorph.py's recipe from seed
     0, one bs2 step with lambdas 0.2 and 0.8 (the grouped per-sample conv)
     on the card against the CPU at 80x96x112 (flow head redrawn), ten bs1
     steps at full width with lambda drawn from the script's stream, the
     bounded backward in each, the loss of a fixed (pair, lambda 0.5)
     lowered; seconds per step, peak memory, the Dense weights' bytes;
  11c. cli/train_hypermorph --cache-device --steps-per-dispatch 4 on 4
     full-width volumes against 4 single steps (params bit-equal with
     cudnn.deterministic), then cli/register and cli/test with --hyper 0.3
     (the same Dice) and cli/sweep_hypermorph over lambda 0, 0.5 and 1 on
     the labelled pair;
  12a. SynthMorph's synthesis (labels_to_image) on Voronoi label maps of
     the committed checkpoint artifacts_r5/synth_w25_00010.npz's 46 label
     values, at 80x96x112 (46 output labels) and at 160x192x224 (the first
     30): the card against the CPU on the same draws at 80x96x112 (image,
     one-hot, warp and inverse), the one-hot's channel sums against the
     warped indicator of the output labels, the fused one-hot warp against
     the packed (1 + L)-channel interpn and the time of each, ms per
     synthesized pair and its peak memory;
  12b. the checkpoint's VxmDense (bfloat16) re-targeted to 160x192x224
     registers smooth_pair at bs1 in cuDNN and conv-kernel mode (one launch
     per conv block, no layout copy), bfloat16 against float32, and the
     card against the CPU in float32 at 80x96x112; ms per pair; the conv
     kernel at that call's 10 conv shapes (64 wide; 2 -> 64 at full width,
     the decoder's 128 -> 64), forward and input gradient, bfloat16 and
     float32, against its plain version as in 2d, timed beside cuDNN;
  12c. the checkpoint's recipe (80x96x112, 46 labels, bfloat16,
     shared_contrast 0.5, Dice + Grad + NCC at 0.25, Adam 1e-4, bs1): one
     float32 step's loss and gradients with the conv kernel against cuDNN
     and on the card against the CPU on the same draws; ten bfloat16 steps
     in cuDNN mode and three with the conv kernel (s per step, peak
     memory), each followed by a step under set_sync_debug_mode("error");
     fit_cached_labels' 4-step dispatch against 4 single steps of the cached
     generator, every warp bounded (VXM_WINDOW_HALO=4), params bit-equal
     with cudnn.deterministic;
  12d. the same architecture from seed 0 at 160x192x224 (46 labels in, 30
     out, bfloat16): one float32 step's loss and gradients with the conv
     kernel against cuDNN on the same draws, then three bfloat16 steps in
     each conv mode: s per step, peak memory (with --profile, the device
     time of one step by kernel);
  12e. cli/train_synthmorph --cache-device --steps-per-dispatch 4
     --init-weights the checkpoint on 4 maps at 80x96x112 padded to
     160x192x224 (--out-shape), then cli/register and cli/test of the
     checkpoint it wrote on the labelled pair (the same Dice);
  13a-b. SynthMorph's joint affine and deformable model: HyperVxmJoint at
     its defaults (~890 M parameters, drawn on the card from a CUDA
     generator seeded 0) registers smooth_pair at 160x192x224 through
     build_joint_register_fn in float32 (TF32 off) and bfloat16: shapes,
     finite outputs, svf_2 == -svf_1, two calls bit-equal, the work
     counters of the integration's warp kernels, bfloat16 against float32,
     no host sync (set_sync_debug_mode("error")) and no conv-kernel launch
     with set_pallas_conv(True); ms per pair and peak memory of each; the
     detector's fit of an image to itself is the identity (13b);
  13c-d. a narrow HyperVxmJoint at 160x192x224 on the card against the
     CPU in float32 (the pair's faces masked to zero), then saved and
     served by cli/register --hyper 0.3 and cli/test on the labelled pair,
     whose Dice must be build_eval_register_fn's;
  14a. data parallelism over one rank: the Trainer over an NCCL process
     group of world size 1 (a file:// store; the mesh 1x1, no wrapper) takes
     phase 4's recipe (float32, TF32 off, seed 0, bs1) for 3 steps that
     must be bit-equal to those of the Trainer without a process group on
     the same batches (cudnn.deterministic), each step's work counters
     gated; then a step under set_sync_debug_mode("error") and two in
     conv-kernel mode (32 conv launches a step); s per step beside the plain
     Trainer's and phase 4's, peak memory;
  14b. two processes on the one card over gloo (chip_smoke.py --dp-rank R
     --dp-dir DIR, one row each of a global batch of 2, the Trainer's
     DistributedDataParallel averaging the gradients) against one process at
     batch 2 on the card: the loss, the gradients within DP_GRAD_RTOL of
     each tensor's max, the updated params within rtol 1e-4, atol 1e-6
     (JAX's DP-vs-single bound) wherever the two runs' gradients agree in
     sign, and the two ranks' params bit-equal;
  15a. spatial sharding over two processes on the one card over gloo
     (chip_smoke.py --sp-rank R --sp-world 2 --sp-dir DIR): a (1, 2) mesh,
     each rank training the U-Net of phase 4's recipe (float32, TF32 off,
     seed 0, bs1, cudnn.deterministic) on 80 of the 160 planes, a plane of
     halo exchanged around every conv, the flow gathered for the
     integration, warps and losses: 3 steps in cuDNN mode and 2 in
     conv-kernel mode, each step held to one process's step on the card
     from the same params and Adam state (the loss within 1e-5, the
     gradients within DP_GRAD_RTOL of each tensor's max, the params after
     it as 14b holds them) and the losses to one process's run of the same
     steps, the ranks bit-equal, each rank's work counters those of the one
     process's step (32 conv launches a step in conv-kernel mode), each
     rank's peak memory beside the one process's; then the committed bfloat16 checkpoint's register call on
     the ranks' slabs against phase 3's call, within phase 3's bfloat16
     limits;
  15b. four processes in one launch: a (1, 4) mesh of uneven slabs
     (48/48/32/32 planes) and a (2, 2) mesh at batch 2, one step each, held
     to one process's step as in 15a (correctness only: gloo's transport
     through the host sets their times);
  15c. (--nccl-ranks N only, after the build, in place of the other
     phases) one process per card over NCCL: phase 4's step spatially
     sharded on (1, N) in cuDNN and conv-kernel mode and data-parallel on
     (N, 1) at batch N, SP_NCCL_STEPS steps each, held to one card as 15a
     holds its steps, with s per step and peak memory beside one card's;
  16. every other model class spatially sharded over two processes on the
     card over gloo in one launch (chip_smoke.py --sp16-rank R --sp-dir
     DIR), a (1, 2) mesh: one step of each class's recipe at 160x192x224
     from its seed (phases 5, 6, 8, 8b, 9 in conv-kernel mode, 10, 11's
     HyperMorph checkpoint re-targeted, 12d's SynthMorph in float32 and in
     bfloat16, and HyperVxmJoint at 13c's widths) held to one process's
     step from the same params and Adam state, run by rank 0 once both
     ranks freed the card: the loss within 1e-5, the gradients within
     DP_GRAD_RTOL of each tensor's max (the bfloat16 step's as far from
     one process's float32 gradients as SP16_BF16_COST_FACTOR times one
     process's bfloat16 ones at most), the params as 15a holds them, the
     ranks bit-equal (a digest of every parameter's bits), each rank's
     work counters one process's and each rank's peak memory within the
     DDP buckets of one process's.
It prints a JSON line of kernel results and, last, a JSON line with the
device. Any failure prints a traceback and exits non-zero without that line.
Nothing is written to the repository except the kernel build directory.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from voxelmorph_tpu_torch import _build, generators, losses, registration
from voxelmorph_tpu_torch.cli import register as register_cli
from voxelmorph_tpu_torch.cli import sweep_hypermorph as sweep_cli
from voxelmorph_tpu_torch.cli import test as test_cli
from voxelmorph_tpu_torch.cli import test_unsupervised_seg as test_seg_cli
from voxelmorph_tpu_torch.cli import train_hypermorph as hyper_train_cli
from voxelmorph_tpu_torch.cli import train_synthmorph as synth_train_cli
from voxelmorph_tpu_torch.cli import train_instance as instance_cli
from voxelmorph_tpu_torch.cli import warp as warp_cli
from voxelmorph_tpu_torch.cli.train_cond_template import cond_template_terms
from voxelmorph_tpu_torch.cli.train_hypermorph import hyp_stream, hypermorph_terms
from voxelmorph_tpu_torch.cli.train_synthmorph import synthmorph_terms
from voxelmorph_tpu_torch.cli.train_template import template_terms
from voxelmorph_tpu_torch.cli.train_unsupervised_seg import unsupervised_seg_terms
from voxelmorph_tpu_torch.models.atlas import (ConditionalTemplateCreation,
                                               ProbAtlasSegmentation, TemplateCreation,
                                               stream_step)
from voxelmorph_tpu_torch.models.hyper import HyperVxmDense
from voxelmorph_tpu_torch.models.modelio import load_model, read_checkpoint, save_model
from voxelmorph_tpu_torch.models.synthmorph import (HyperVxmJoint, LabelsToImageConfig,
                                                    SynthMorphDense, _scale_matrix,
                                                    labels_to_image, labels_to_image_draws,
                                                    labels_to_image_from_draws)
from voxelmorph_tpu_torch.models.unet import ConvBlock
from voxelmorph_tpu_torch.models.vxm import (InstanceDense, Transform, VxmDense,
                                             VxmDenseSemiSupervisedPointCloud,
                                             VxmDenseSemiSupervisedSeg)
from voxelmorph_tpu_torch.ops import conv3, interp
from voxelmorph_tpu_torch.ops import warp as warp_ops
from voxelmorph_tpu_torch.ops import warp_bounded as warp_bounded_ops
from voxelmorph_tpu_torch.ops import warp_gather as warp_gather_ops
from voxelmorph_tpu_torch.ops.interp import interpn_label_onehot, ndgrid, resize
from voxelmorph_tpu_torch.ops.warp_bounded import (warp_bounded, warp_bounded_bwd,
                                                   warp_bounded_bwd_plain, windowed_transform)
from voxelmorph_tpu_torch.ops.warp_gather import (launch_gather_bwd, launch_gather_fwd,
                                                  warp_gather_bwd_plain, warp_gather_plain)
from voxelmorph_tpu_torch.py.utils import dice, load_volfile
from voxelmorph_tpu_torch.registration import (build_register_fn, enable_fast_warp,
                                               resolve_registration_model)
from voxelmorph_tpu_torch.training import (LossTerm, Trainer, device_cached_label_generator,
                                           make_loss_fn)

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "artifacts_r4" / "probs_ncc_0050.npz"
INSHAPE = (160, 192, 224)
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12
TF32_TENSOR_FLOPS_PER_S = 494.7e12
# the faster route to float32 accuracy for a convolution: three TF32 passes
# on the tensor cores (the 3xTF32 split of csrc/conv3.cu), not the float32
# CUDA cores
F32_CONV_FLOPS_PER_S = TF32_TENSOR_FLOPS_PER_S / 3

# (batch, spatial, channels, halo) of the bounded-warp checks; the first is
# the serving and training shape (the squaring steps at half resolution)
WARP_CASES = [
    (1, (80, 96, 112), 3, 1),
    (2, (80, 96, 112), 3, 1),
    (2, (80, 96, 112), 3, 2),
    (1, INSHAPE, 1, 2),
    # the other channel counts and halos the wrapper accepts; halo 4 with
    # 4 channels needs more than 48 KB of shared memory per block
    (1, (80, 96, 112), 2, 3),
    (1, (80, 96, 112), 4, 4),
]

# kernel vs plain version: both compute the same f32 terms; they may differ
# only in the order of additions
KERNEL_TOL = 1e-5
# float32 GPU vs CPU at full width: conv sums in another order through the
# U-Net, and the GPU's early squaring steps take the kernel where the CPU
# takes the gather (same function, other rounding)
FLOW_TOL = 1e-3   # voxels
IMAGE_TOL = 1e-4  # intensities in [0, 1]
# bfloat16 GPU vs CPU at full width: both round every conv output and bias
# add to bfloat16, but cuDNN and the CPU's convolutions accumulate in other
# orders, so single roundings differ by one bf16 step and the difference
# grows through the U-Net and the seven squarings. Measured on an H100:
# 9.2e-3 voxels on pos_flow, 2.1e-4 on y_source. The bfloat16-vs-float32
# gap below is 0.15 and 4.6e-3, so these limits tell the dtypes apart.
BF16_FLOW_TOL = 3e-2   # voxels
BF16_IMAGE_TOL = 1e-3  # intensities in [0, 1]
# bfloat16 vs float32, both on the card: the cost of bfloat16 compute.
# Measured on an H100: 0.15 voxels on pos_flow, 4.6e-3 on y_source.
BF16_VS_F32_FLOW_TOL = 0.5    # voxels
BF16_VS_F32_IMAGE_TOL = 2e-2  # intensities in [0, 1]
# gradients through the bounded warp and the seven squarings, GPU vs CPU,
# relative to the largest gradient: the backward kernel and the plain
# version differ only in the order of additions. Measured on an H100: 0 for
# warp_bounded, 2.0e-7 for integrate_vec_batched.
GRAD_GPU_CPU_RTOL = 1e-5
# one float32 train step's loss and parameter gradients, each tensor
# relative to its largest entry. The kernel path and the gather-only path
# on the card differ in the warp of each squaring step: at the seed-0 init
# the flows (~1e-5 voxels) are below half a float step of most coordinates,
# so x + shift rounds to x and the displacement is exactly 0, where the
# bounded warp's backward (the Pallas kernel's formulation) takes the tent
# weight's derivative as 0 and the gather takes a one-sided difference.
# With the flow head redrawn as N(0, FLOW_STD), flows of about a voxel,
# the two agree to the order of their sums. The card and the CPU both take
# the bounded tiers and differ in the order of sums (cuDNN's and the CPU's
# convolutions, scatter-adds with atomics). Measured on an H100, largest
# over the loss and the 24 gradient tensors: 0.187 at the seed-0 init and
# 5.9e-6 with the redrawn head (kernel vs gather-only); 1.6e-4 and 1.4e-4
# (card vs CPU). A zero gradient differs by 1, a sign-flipped one by 2.
FLOW_STD = 0.05
TRAIN_INIT_KERNEL_VS_GATHER_RTOL = 0.5
TRAIN_KERNEL_VS_GATHER_RTOL = 1e-4
TRAIN_GPU_VS_CPU_RTOL = 2e-3
# one float32 train step (flow head redrawn), conv kernel mode against cuDNN
# mode on the card, TF32 off: both convolve in full float32 and differ in the
# order of sums and in the weight gradient (shifted matrix products against
# cuDNN's)
TRAIN_CONV_KERNEL_VS_CUDNN_RTOL = 1e-4

# the semi-supervised recipe's labels: a 30-label map, as the repository's
# semi-supervised quality run used; the wide-channel check takes 40, the
# fewest whose one-hot corner table at 80x96x112 passes the gather's limit
SEMI_LABELS = 30
WIDE_LABELS = 40
# the warp ops, card against CPU, relative to the largest magnitude: the
# same float32 operations, whose sums (matrix products, the channel sum of
# the wide gather's coordinate gradient) run in other orders
WARP_OPS_RTOL = 1e-5

# the point-cloud recipe (scripts/train_semisupervised_pointcloud.py with
# --surf-bidir): 5000 surface points of 4 of the map's labels a step; its
# generator, card against CPU at half width, on the map's first 8 labels
# (the atlas's SDTs are computed for every label the run uses)
SURF_POINTS = 5000
POINT_LABELS_SAMPLED = 4
POINT_CPU_LABELS = 8
# K, the steps of one --steps-per-dispatch dispatch in phase 6b, and the
# largest difference of its params from single steps', relative to each
# tensor's largest magnitude, where the run is not bit-equal
DISPATCH_STEPS = 4
DISPATCH_RTOL = 1e-6
# the least share of bf16 conv outputs the kernel and its plain version agree
# on bit for bit in the same rounding order
BF16_EQUAL_SHARE = 0.99

# (D, H, W, ci, co) of the full-width U-Net's 11 conv blocks, in the order of
# the forward; the first block's input (the image pair) needs no gradient
UNET_CONVS = [(160, 192, 224, 2, 16), (80, 96, 112, 16, 32), (40, 48, 56, 32, 32),
              (20, 24, 28, 32, 32), (10, 12, 14, 32, 32), (20, 24, 28, 64, 32),
              (40, 48, 56, 64, 32), (80, 96, 112, 64, 32), (160, 192, 224, 48, 32),
              (160, 192, 224, 32, 16), (160, 192, 224, 16, 16)]


# conv launches of a train step in conv-kernel mode: the U-Net's 11 forward
# convs, their recomputation in the backward (the per-block remat), and the
# input gradients of all but the first
TRAIN_STEP_CONVS = 3 * len(UNET_CONVS) - 1
# the tiers {1, H} of the predicated-warp checks (phase 2e and phase 7):
# with H = 2 a warp has three branches, the halo-1 and halo-2 bounded
# kernels and the gather
TIER_HALO = 2
# the gather kernel's dvol against the torch gather's (index_put with
# atomics on the card): the same float32 terms summed in other orders,
# relative to the largest |dvol|
GATHER_DVOL_RTOL = 1e-5


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def window_halo(value):
    """Run with VXM_WINDOW_HALO set: "1" sends the CPU through the bounded
    tiers as the card takes them, "0" sends every warp to the gather."""
    os.environ["VXM_WINDOW_HALO"] = value
    try:
        yield
    finally:
        os.environ.pop("VXM_WINDOW_HALO")


@contextlib.contextmanager
def conv_kernel_mode(enabled):
    """Run with the conv-kernel dispatch forced on or off."""
    conv3.set_pallas_conv(enabled)
    try:
        yield
    finally:
        conv3.set_pallas_conv(None)


@contextlib.contextmanager
def full_float32():
    """Run cuDNN's float32 convolutions and float32 matrix products in full
    float32 (cuDNN's default is TF32), then restore the settings."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def reset_launches():
    warp_bounded.launches = warp_bounded_bwd.launches = conv3.conv3_same_cf.launches = 0
    launch_gather_fwd.launches = launch_gather_bwd.launches = 0
    conv3.conv3_same_cf.layout_copies = 0
    warp_bounded_ops.reset_work()


def read_launches():
    """Launches of each kernel since reset_launches; of the warp kernels
    also the launches that ran past their tier word (the device counters,
    one fetch); and the conv wrapper's layout copies."""
    work = warp_bounded_ops.read_work()
    return {"fwd": warp_bounded.launches, "bwd": warp_bounded_bwd.launches,
            "gather_fwd": launch_gather_fwd.launches, "gather_bwd": launch_gather_bwd.launches,
            "fwd_ran": work["warp_bounded_fwd"], "bwd_ran": work["warp_bounded_bwd"],
            "gather_fwd_ran": work["warp_gather_fwd"],
            "gather_bwd_ran": work["warp_gather_bwd"],
            "conv": conv3.conv3_same_cf.launches,
            "layout_copies": conv3.conv3_same_cf.layout_copies}


def check_warp_work(counts, label, backward=True):
    """Fail unless ``counts`` (read_launches) show the tiered warps of a run
    doing their work: a bounded kernel ran past its tier word, and each
    tiered warp ran exactly one of its branches (a warp launches the gather
    kernel once, so the bounded and gather launches that ran add up to the
    gather's launches); with ``backward`` the backward kernels too. The
    launch counts alone cannot show this: every tiered warp launches every
    branch."""
    for bounded, gather in (("fwd", "gather_fwd"), ("bwd", "gather_bwd"))[:1 + backward]:
        ran = counts[f"{bounded}_ran"], counts[f"{gather}_ran"]
        if ran[0] == 0 or sum(ran) != counts[gather]:
            raise AssertionError(f"{label}: of {counts[gather]} tiered warps {ran[0]} ran a "
                                 f"bounded {bounded} kernel and {ran[1]} the gather: {counts}")


def no_warp_launches(counts):
    """True where ``counts`` (read_launches) hold no warp kernel launch."""
    return not any(v for k, v in counts.items() if k not in ("conv", "layout_copies"))


def tensor_core_instructions(name):
    """The number of tensor-core (HMMA) instructions in the machine code of
    the kernel library ``name``, from cuobjdump next to nvcc."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return sum("HMMA" in line for line in sass.splitlines())


def phase(name):
    log(f"\n== {name}")
    return time.perf_counter()


def warm_device(seconds=0.5):
    """Keep the card busy for a while, so that the timings that follow do
    not start while its clocks are still rising from idle (the build leaves
    it idle for tens of seconds)."""
    a = torch.randn(4096, 4096, device="cuda")
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        for _ in range(10):
            a = (a @ a).clamp_(-1.0, 1.0)
        torch.cuda.synchronize()


def time_cuda_ms(fn, reps=20, warmup=3):
    """Median device time of ``fn`` in ms over ``reps`` runs, each with a
    cold L2 (see sample_cuda_ms)."""
    return float(np.median(sample_cuda_ms(fn, reps, warmup)))


def time_in_turns(fns, rounds=2, reps=10, warmup=3):
    """Median device time in ms of each of ``fns`` (a dict), timed in turns:
    ``rounds`` rounds, each timing every function ``reps`` times in order,
    so that a drift of the card's state does not favour one of them."""
    samples = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            samples[name] += sample_cuda_ms(fn, reps, warmup)
    return {name: float(np.median(t)) for name, t in samples.items()}


# Cycles the card spins before each timed run, about 1 ms: longer than the
# host takes to launch the run, so that the time from the start event to
# the end event is the device's alone.
SPIN_CYCLES = 2_000_000


def sample_cuda_ms(fn, reps, warmup):
    """Device times of ``reps`` runs of ``fn`` in ms, each with a cold L2 (a
    256 MB buffer is written before each run) and timed from a start event
    that the card reaches only after spinning SPIN_CYCLES: without that, a
    short kernel whose launch takes the host longer than the flush takes
    the card is timed with the card idle, waiting for it."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def warp_case(rng, batch, spatial, nch, halo):
    """Random volume and shifts within +-halo, with a band of voxels along
    every border pushed across it, so that clamping binds."""
    vol = rng.standard_normal((batch, *spatial, nch), dtype=np.float32)
    shift = rng.uniform(-halo, halo, size=(batch, *spatial, 3)).astype(np.float32)
    band = 3
    for axis in range(3):
        lo = [slice(None)] * 5
        hi = [slice(None)] * 5
        lo[axis + 1] = slice(0, band)
        hi[axis + 1] = slice(-band, None)
        lo[4] = hi[4] = axis
        shift[tuple(lo)] = -halo
        shift[tuple(hi)] = halo
    return (torch.from_numpy(vol).cuda(), torch.from_numpy(shift).cuda())


def build_compare_libraries(builds, stem):
    """Build other copies of a kernel source: ``builds`` lists (label,
    source, extra nvcc flags), an earlier commit's copy unpacked outside the
    package or the package's own with -D flags; each is built with the
    package's nvcc flags plus its own, all at once, into the build
    directory. Returns {label: ctypes library}."""
    out = _build.library_path(stem).parent / "compare"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, src, flags) in enumerate(builds):
        lib = out / f"lib{stem}_{i}.so"
        procs[label] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (lib, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{text}")
        for line in text.splitlines():
            if any(key in line for key in ("registers", "smem", "spill", "Compiling entry")):
                log(f"  {label}: {line.strip()}")
        libs[label] = ctypes.CDLL(str(lib))
    return libs


def compare_launch(lib, name, tensors, halo):
    """Launch the entry point ``name`` of another build on the current
    stream, as ops/warp_bounded.py launches the package's own."""
    fn = getattr(lib, name)
    fn.argtypes = warp_bounded_ops._ARGTYPES[name]
    fn.restype = ctypes.c_int
    B, D, H, W, C = tensors[0].shape
    err = fn(*(t.data_ptr() for t in tensors), B, D, H, W, C, halo, None, 0, None,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} of another build failed to launch: CUDA error {err}")


def compare_rows(libs, name, inputs, outputs, plain, halo):
    """Each other build's error against the plain version, and a function
    that launches it, by label."""
    errs, fns = {}, {}
    for label, lib in libs.items():
        compare_launch(lib, name, inputs + outputs, halo)
        torch.cuda.synchronize()
        errs[label] = max((o - p).abs().max().item() for o, p in zip(outputs, plain))
        fns[label] = lambda lib=lib: compare_launch(lib, name, inputs + outputs, halo)
    return errs, fns


def timed_row(row, fns, compare):
    """Time the kernel, the library call and the other builds in turns, and
    put their times into ``row`` (the other builds' under "compare")."""
    errs, other = compare
    times = time_in_turns({**fns, **{f"compare {k}": f for k, f in other.items()}})
    row.update({k: times[k] for k in fns})
    if errs:
        row["compare"] = {k: dict(max_abs_err=errs[k], ms=times[f"compare {k}"]) for k in errs}


def grid_sample_warp(vol_cf, grid):
    """The library comparator: trilinear grid_sample with border clamping."""
    return F.grid_sample(vol_cf, grid, mode="bilinear", padding_mode="border",
                         align_corners=True)


def check_warp_bounded(rng, compare_libs):
    """Kernel vs plain version at the serving shape and stress shapes, and
    the other builds of ``compare_libs`` beside it."""
    rows = []
    for batch, spatial, nch, halo in WARP_CASES:
        vol, shift = warp_case(rng, batch, spatial, nch, halo)
        out = warp_bounded(vol, shift, halo)
        plain = windowed_transform(vol, shift, halo)
        torch.cuda.synchronize()
        err = (out - plain).abs().max().item()

        # grid_sample takes channels-first volumes and (x, y, z) coordinates
        # normalised to [-1, 1]; the conversion is outside the timed call
        coords = ndgrid(spatial, device="cuda") + shift
        dims = torch.tensor([s - 1 for s in spatial], device="cuda", dtype=torch.float32)
        grid = (2.0 * coords / dims - 1.0).flip(-1).contiguous()
        vol_cf = vol.movedim(-1, 1).contiguous()
        lib_err = (grid_sample_warp(vol_cf, grid).movedim(1, -1) - plain).abs().max().item()

        vox = batch * int(np.prod(spatial))
        nbytes = (2 * nch + 3) * 4 * vox
        ops = (46 + 16 * nch) * vox
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S) * 1e3
        # the floor of this timing for the kernel's bytes: one elementwise
        # op that reads vol and shift (every sector of it) and writes a
        # tensor of vol's size
        same = shift[..., :nch] if nch <= 3 else None
        row = dict(
            shape=[batch, *spatial, nch], halo=halo, max_abs_err=err,
            grid_sample_err=lib_err,
            plain_ms=time_cuda_ms(lambda: windowed_transform(vol, shift, halo)),
            bound_ms=bound_ms, same_bytes_ms=None,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS_PER_S else "operations")
        fns = dict(ms=lambda: warp_bounded(vol, shift, halo),
                   library_ms=lambda: grid_sample_warp(vol_cf, grid))
        if same is not None:
            fns["same_bytes_ms"] = lambda: vol + same
        timed_row(row, fns, compare_rows(compare_libs, "vxm_warp_bounded_fwd", [vol, shift],
                                         [torch.empty_like(vol)], [plain], halo))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        log(json.dumps(row))
        if not err <= KERNEL_TOL:
            raise AssertionError(f"warp_bounded kernel differs from its plain version "
                                 f"by {err} > {KERNEL_TOL} at {row['shape']} halo {halo}")
        rows.append(row)
        del vol, shift, out, plain, coords, grid, vol_cf
    return rows


def smooth_pair(spatial, device):
    """A smooth synthetic pair: low-frequency noise upsampled to ``spatial``
    and scaled to [0, 1], and the same image warped by a smooth random
    displacement of a few voxels."""
    img, fixed, _ = smooth_pair_and_disp(spatial, device)
    return img, fixed


def smooth_pair_and_disp(spatial, device):
    """``smooth_pair`` and the displacement that warps one into the other."""
    rng = np.random.default_rng(SEED)
    coarse = torch.from_numpy(
        rng.standard_normal((10, 12, 14, 1), dtype=np.float32)).to(device)
    img = resize(coarse, [s / c for s, c in zip(spatial, (10, 12, 14))], new_shape=spatial)
    img = (img - img.min()) / (img.max() - img.min())
    disp = torch.from_numpy(
        3.0 * rng.standard_normal((5, 6, 7, 3), dtype=np.float32)).to(device)
    disp = resize(disp, [s / c for s, c in zip(spatial, (5, 6, 7))], new_shape=spatial)
    fixed = warp_ops.transform(img, disp, window_halo=None)
    return img[None], fixed[None], disp


def voronoi_labels(img, nb_labels, seed):
    """A label map of ``img`` ``(*S, 1)``: the head mask (intensity above
    0.3) split among ``nb_labels`` seeded centres inside it (each voxel
    takes its nearest centre's label, 1 to nb_labels), 0 outside.
    Returns int32 ``(*S,)`` on img's device."""
    spatial = img.shape[:-1]
    mask = img[..., 0] > 0.3
    flat = np.flatnonzero(mask.cpu().numpy())
    picks = np.random.default_rng(seed).choice(flat, nb_labels, replace=False)
    centres = torch.from_numpy(np.stack(np.unravel_index(picks, spatial), -1)).to(
        img.device, torch.float32)
    grid = ndgrid(spatial, device=img.device).reshape(-1, 3)
    nearest = torch.cdist(grid, centres, compute_mode="donot_use_mm_for_euclid_dist")
    nearest = nearest.argmin(dim=-1).reshape(spatial)
    return torch.where(mask, nearest + 1, 0).to(torch.int32)


def labelled_pair(spatial, device):
    """smooth_pair with SEMI_LABELS-label maps: the moving scan's Voronoi
    labels, and the fixed scan's, carried by the pair's displacement
    (nearest). Returns (moving, fixed, moving labels, fixed labels)."""
    moving, fixed, disp = smooth_pair_and_disp(spatial, device)
    src = voronoi_labels(moving[0], SEMI_LABELS, SEED + 5)
    trg = warp_ops.transform(src.float(), disp, interp_method="nearest",
                             window_halo=None).round().to(torch.int32)
    return moving, fixed, src, trg


def semi_batch(spatial, device):
    """The semi-supervised generator's batch on labelled_pair: (src, trg,
    src_seg), (trg, zero flow, trg_seg), the segs one-hot over SEMI_LABELS
    labels at half resolution (generators._one_hot_seg, downsize 2)."""
    moving, fixed, src, trg = labelled_pair(spatial, device)
    labels = np.arange(1, SEMI_LABELS + 1)
    segs = [torch.from_numpy(np.ascontiguousarray(generators._one_hot_seg(
        s.cpu().numpy()[None, ..., None], labels, downsize=2))).to(device) for s in (src, trg)]
    zero = torch.zeros((1, *spatial, 3), device=device)
    return (moving, fixed, segs[0]), (fixed, zero, segs[1])


def max_and_mean_abs(a, b):
    d = (a.float().cpu() - b.float().cpu()).abs()
    return d.max().item(), d.mean().item()


def register_full_width(moving, fixed):
    """The serving path in the checkpoint's own dtype (bfloat16)."""
    model = load_model(str(CHECKPOINT), device="cuda")
    log(f"model: VxmDense {model.inshape} dtype {model.dtype}, "
        f"{sum(p.numel() for p in model.parameters())} params")
    register = build_register_fn(model)

    reset_launches()
    t0 = time.perf_counter()
    moved, warp = register(moving, fixed)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"first call {first_s:.3f} s; kernel launches {launches}")
    check_warp_work(launches, "the serving path", backward=False)
    if tuple(moved.shape) != (1, *INSHAPE, 1) or tuple(warp.shape) != (1, *INSHAPE, 3):
        raise AssertionError(f"shapes: moved {tuple(moved.shape)}, warp {tuple(warp.shape)}")
    if not (torch.isfinite(moved).all() and torch.isfinite(warp).all()):
        raise AssertionError("non-finite output")
    log(f"max|warp| {warp.abs().max().item():.4f} voxels; "
        f"mean|moved - fixed| {(moved - fixed).abs().mean().item():.5f} "
        f"(before: {(moving - fixed).abs().mean().item():.5f})")

    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        register(moving, fixed)
    torch.cuda.synchronize()
    pairs_per_s = reps / (time.perf_counter() - t0)
    log(f"bs1 bfloat16: {pairs_per_s:.4f} pairs/s ({1e3 / pairs_per_s:.2f} ms per pair)")
    return model, launches, moved, warp


def bf16_vs_cpu(moved, warp, moving, fixed):
    """The bfloat16 card run against the port's bfloat16 CPU run."""
    t0 = time.perf_counter()
    cpu_moved, cpu_warp = build_register_fn(load_model(str(CHECKPOINT), device="cpu"))(
        moving.cpu(), fixed.cpu())
    flow_err, flow_mean = max_and_mean_abs(warp, cpu_warp)
    image_err, image_mean = max_and_mean_abs(moved, cpu_moved)
    log(f"bfloat16 on cpu: {time.perf_counter() - t0:.3f} s")
    log(f"GPU vs CPU bfloat16: pos_flow max abs err {flow_err:.4e} (mean {flow_mean:.4e}, "
        f"tol {BF16_FLOW_TOL}), y_source max abs err {image_err:.4e} "
        f"(mean {image_mean:.4e}, tol {BF16_IMAGE_TOL})")
    if not (flow_err <= BF16_FLOW_TOL and image_err <= BF16_IMAGE_TOL):
        raise AssertionError("bfloat16 GPU run disagrees with the bfloat16 CPU run")


def register_f32_vs_cpu(moving, fixed):
    """float32 on the card (TF32 off) against the port's CPU run."""
    with full_float32():
        return _register_f32_vs_cpu(moving, fixed)


def _register_f32_vs_cpu(moving, fixed):
    results = {}
    for device in ("cuda", "cpu"):
        model = load_model(str(CHECKPOINT), device=device, dtype=torch.float32)
        reset_launches()
        t0 = time.perf_counter()
        moved, warp = build_register_fn(model)(moving.to(device), fixed.to(device))
        if device == "cuda":
            torch.cuda.synchronize()
        counts = read_launches()
        log(f"float32 on {device}: {time.perf_counter() - t0:.3f} s, warp_bounded launches "
            f"{counts['fwd']}, of which {counts['fwd_ran']} ran")
        if device == "cuda":
            check_warp_work(counts, "the float32 register call", backward=False)
        elif not no_warp_launches(counts):
            raise AssertionError(f"the CPU run launched warp kernels: {counts}")
        results[device] = (moved.cpu(), warp.cpu())
    flow_err = (results["cuda"][1] - results["cpu"][1]).abs().max().item()
    image_err = (results["cuda"][0] - results["cpu"][0]).abs().max().item()
    log(f"GPU vs CPU float32: pos_flow max abs err {flow_err:.3e} (tol {FLOW_TOL}), "
        f"y_source max abs err {image_err:.3e} (tol {IMAGE_TOL})")
    if not (flow_err <= FLOW_TOL and image_err <= IMAGE_TOL):
        raise AssertionError("float32 GPU run disagrees with the CPU run")
    return results["cuda"]


def bf16_vs_f32(moved, warp, moved_f32, warp_f32):
    """The bfloat16 card run against the float32 card run."""
    flow_err, flow_mean = max_and_mean_abs(warp, warp_f32)
    image_err, image_mean = max_and_mean_abs(moved, moved_f32)
    log(f"bfloat16 vs float32 on the GPU: pos_flow max abs diff {flow_err:.4e} "
        f"(mean {flow_mean:.4e}, tol {BF16_VS_F32_FLOW_TOL}), y_source max abs diff "
        f"{image_err:.4e} (mean {image_mean:.4e}, tol {BF16_VS_F32_IMAGE_TOL})")
    if not (flow_err <= BF16_VS_F32_FLOW_TOL and image_err <= BF16_VS_F32_IMAGE_TOL):
        raise AssertionError("bfloat16 GPU run is too far from the float32 GPU run")


def register_conv_kernel(moving, fixed):
    """Phase 3b: the serving path with the conv kernel. Returns the launch
    counts of one bfloat16 register call and its ms per pair."""
    with conv_kernel_mode(True):
        register = build_register_fn(load_model(str(CHECKPOINT), device="cuda"))
        reset_launches()
        moved, warp = register(moving, fixed)
        torch.cuda.synchronize()
        launches = read_launches()
        log(f"bfloat16 register call with the conv kernel: kernel launches {launches}")
        if launches["conv"] != len(UNET_CONVS):
            raise AssertionError(f"expected {len(UNET_CONVS)} conv launches, got {launches}")
        check_warp_work(launches, "the conv-kernel register call", backward=False)
        if launches["layout_copies"] != 0:
            raise AssertionError(f"the register call copied conv inputs to channels-last "
                                 f"{launches['layout_copies']} times")
        if tuple(warp.shape) != (1, *INSHAPE, 3) or not (
                torch.isfinite(moved).all() and torch.isfinite(warp).all()):
            raise AssertionError("bad output of the conv-kernel register call")
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            register(moving, fixed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        log(f"bs1 bfloat16 with the conv kernel: {ms:.2f} ms per pair ({1e3 / ms:.4f} pairs/s)")

    f32, f32_launches = {}, {}
    for enabled in (True, False):
        with conv_kernel_mode(enabled), full_float32():
            model = load_model(str(CHECKPOINT), device="cuda", dtype=torch.float32)
            reset_launches()
            f32[enabled] = build_register_fn(model)(moving, fixed)
            torch.cuda.synchronize()
            f32_launches[enabled] = read_launches()["conv"]
    flow_err, _ = max_and_mean_abs(f32[True][1], f32[False][1])
    image_err, _ = max_and_mean_abs(f32[True][0], f32[False][0])
    log(f"float32, conv kernel ({f32_launches[True]} launches) vs cuDNN "
        f"({f32_launches[False]}): pos_flow max abs err {flow_err:.3e} (tol {FLOW_TOL}), "
        f"y_source max abs err {image_err:.3e} (tol {IMAGE_TOL})")
    if f32_launches != {True: len(UNET_CONVS), False: 0}:
        raise AssertionError(f"float32 conv launches {f32_launches}")
    if not (flow_err <= FLOW_TOL and image_err <= IMAGE_TOL):
        raise AssertionError("float32 conv-kernel run disagrees with the cuDNN run")
    bf16_vs_f32(moved, warp, *f32[True])
    return launches, ms


def fast_warp_check(moving, fixed):
    """Phase 3c: --fast-warp at full width (bfloat16), then float32 on the
    card against the port's CPU run at 80x96x112. Returns the launch counts
    of the full-width call and its ms per pair."""
    def calls(model, mv, fx):
        """Register with and without the phase warp; the launches of each."""
        out = {}
        for name, m in (("plain", model), ("fast", enable_fast_warp(model))):
            reset_launches()
            moved, warp = build_register_fn(m)(mv, fx)
            if mv.is_cuda:
                torch.cuda.synchronize()
            out[name] = (moved, warp, read_launches())
        return out

    def phase_launches(out):
        # the bounded launches that ran: in the plain call, the kernel-tier
        # squarings and the final warp where max|warp| <= 1 (the halo-1
        # tier); in the fast call, the same squarings and 4 halo-2 phase
        # warps
        squarings = out["plain"][2]["fwd_ran"] - int(
            out["plain"][1].abs().max().item() <= 1.0)
        return out["fast"][2]["fwd_ran"] - squarings

    model = load_model(str(CHECKPOINT), device="cuda")
    out = calls(model, moving, fixed)
    launches = out["fast"][2]
    n_phase = phase_launches(out)
    flow_err, _ = max_and_mean_abs(out["fast"][1], out["plain"][1])
    image_diff, image_mean = max_and_mean_abs(out["fast"][0], out["plain"][0])
    log(f"fast warp, bfloat16, {INSHAPE}: kernel launches {launches} ({n_phase} phase warps); "
        f"pos_flow vs the plain call {flow_err:.3e}; y_source vs the gather's {image_diff:.4e} "
        f"(mean {image_mean:.4e})")
    if n_phase != 4 or flow_err > FLOW_TOL:
        raise AssertionError("the fast-warp call did not take four halo-2 phase warps")
    ms = {}
    for name, m in (("plain", model), ("fast", enable_fast_warp(model))):
        register = build_register_fn(m)
        register(moving, fixed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            register(moving, fixed)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / 5 * 1e3
    log(f"bs1 bfloat16: fast warp {ms['fast']:.2f} ms per pair, gather {ms['plain']:.2f} ms")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    half = tuple(s // 2 for s in INSHAPE)
    mv_h, fx_h = smooth_pair(half, "cpu")
    results = {}
    for device in ("cuda", "cpu"):
        m = resolve_registration_model(
            load_model(str(CHECKPOINT), device=device, dtype=torch.float32), half)
        t0 = time.perf_counter()
        results[device] = calls(m, mv_h.to(device), fx_h.to(device))
        log(f"fast warp, float32, {half} on {device}: {time.perf_counter() - t0:.2f} s, "
            f"{phase_launches(results[device]) if device == 'cuda' else 0} phase warp launches")
    if phase_launches(results["cuda"]) != 4:
        raise AssertionError(f"the fast-warp call at {half} took no bounded phase warps")
    flow_err, _ = max_and_mean_abs(results["cuda"]["fast"][1], results["cpu"]["fast"][1])
    image_err, _ = max_and_mean_abs(results["cuda"]["fast"][0], results["cpu"]["fast"][0])
    log(f"fast warp GPU vs CPU float32 at {half}: pos_flow max abs err {flow_err:.3e} (tol "
        f"{FLOW_TOL}), y_source max abs err {image_err:.3e} (tol {IMAGE_TOL})")
    if not (flow_err <= FLOW_TOL and image_err <= IMAGE_TOL):
        raise AssertionError("the fast-warp GPU run disagrees with the CPU run")
    return launches, ms["fast"]


def profile_device(label, fn, rows):
    """Device time by kernel over one run of ``fn``, and the share of its
    wall time in which the device ran no kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernels only: operator events repeat the time of the kernels they launch
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    log(f"profiled {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.4f}")
    log(events.table(sort_by="self_device_time_total", row_limit=rows))


def profile_call(model, moving, fixed):
    """The profile of one bfloat16 register call, after a warm-up call."""
    register = build_register_fn(model)
    register(moving, fixed)
    torch.cuda.synchronize()
    profile_device("call", lambda: register(moving, fixed), rows=25)


def bwd_bound(vox, nch):
    """The least time of the warp backward on the card: it reads vol, shift
    and g and writes dvol and dshift, (3C + 6) * 4 bytes per voxel; its
    operations, about (32 C + 224) per voxel (8 nonzero taps each for the
    dvol gather and for dshift), at the f32 rate. Returns (ms, bound_by)."""
    nbytes = (3 * nch + 6) * 4 * vox
    ops = (32 * nch + 224) * vox
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_warp_bounded_bwd(rng, compare_libs):
    """Backward kernel vs plain version at phase 2's shapes: within
    KERNEL_TOL, and bit-equal across two launches (no atomics); the other
    builds of ``compare_libs`` beside it."""
    rows = []
    for batch, spatial, nch, halo in WARP_CASES:
        vol, shift = warp_case(rng, batch, spatial, nch, halo)
        g = torch.from_numpy(rng.standard_normal(vol.shape, dtype=np.float32)).cuda()
        dvol, dshift = warp_bounded_bwd(vol, shift, g, halo)
        dvol2, dshift2 = warp_bounded_bwd(vol, shift, g, halo)
        pvol, pshift = warp_bounded_bwd_plain(vol, shift, g, halo)
        torch.cuda.synchronize()
        err = max((dvol - pvol).abs().max().item(), (dshift - pshift).abs().max().item())
        repeatable = torch.equal(dvol, dvol2) and torch.equal(dshift, dshift2)
        scale = max(pvol.abs().max().item(), pshift.abs().max().item())

        # the library comparator: the backward of grid_sample (border,
        # align_corners), for the volume and the sampling grid
        coords = ndgrid(spatial, device="cuda") + shift
        dims = torch.tensor([s - 1 for s in spatial], device="cuda", dtype=torch.float32)
        grid = (2.0 * coords / dims - 1.0).flip(-1).contiguous().requires_grad_()
        vol_cf = vol.movedim(-1, 1).contiguous().requires_grad_()
        out_cf = grid_sample_warp(vol_cf, grid)
        g_cf = g.movedim(-1, 1).contiguous()

        vox = batch * int(np.prod(spatial))
        bound_ms, bound_by = bwd_bound(vox, nch)
        row = dict(
            shape=[batch, *spatial, nch], halo=halo, max_abs_err=err, max_abs_grad=scale,
            repeatable=repeatable,
            # the plain version is slow at the large halos: fewer runs
            plain_ms=time_cuda_ms(lambda: warp_bounded_bwd_plain(vol, shift, g, halo),
                                  reps=5, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by)
        timed_row(row, dict(
            ms=lambda: warp_bounded_bwd(vol, shift, g, halo),
            library_ms=lambda: torch.autograd.grad(out_cf, (vol_cf, grid), g_cf,
                                                   retain_graph=True)),
            compare_rows(compare_libs, "vxm_warp_bounded_bwd", [vol, shift, g],
                         [torch.empty_like(vol), torch.empty_like(shift)], [pvol, pshift], halo))
        row["bound_share"] = bound_ms / row["ms"]
        # the same on a smooth shift of the same bound, as a velocity field
        # gives: the lanes of a warp then share the sources that reach them
        sshift = torch.stack([smooth_field(rng, spatial, (5, 6, 7), halo / 2, "cuda")
                              for _ in range(batch)]).clamp_(-halo, halo)
        sgrid = (2.0 * (ndgrid(spatial, device="cuda") + sshift) / dims - 1.0).flip(-1)
        sgrid = sgrid.contiguous().requires_grad_()
        sout_cf = grid_sample_warp(vol_cf, sgrid)
        smooth = time_in_turns(dict(
            ms=lambda: warp_bounded_bwd(vol, sshift, g, halo),
            library_ms=lambda: torch.autograd.grad(sout_cf, (vol_cf, sgrid), g_cf,
                                                   retain_graph=True)))
        row["smooth_ms"], row["smooth_library_ms"] = smooth["ms"], smooth["library_ms"]
        log(json.dumps(row))
        if not err <= KERNEL_TOL:
            raise AssertionError(f"warp_bounded_bwd kernel differs from its plain version "
                                 f"by {err} > {KERNEL_TOL} at {row['shape']} halo {halo}")
        if not repeatable:
            raise AssertionError(f"two launches of warp_bounded_bwd differ at {row['shape']}")
        if not scale > 100 * KERNEL_TOL:
            raise AssertionError(f"gradients of {scale} cannot show a {KERNEL_TOL} error")
        rows.append(row)
        del vol, shift, g, dvol, dshift, dvol2, dshift2, pvol, pshift, out_cf, grid, vol_cf
        del sshift, sgrid, sout_cf
    return rows


def smooth_field(rng, spatial, coarse, scale, device):
    """A smooth random displacement of about ``scale`` voxels."""
    disp = torch.from_numpy(scale * rng.standard_normal((*coarse, 3), dtype=np.float32))
    return resize(disp.to(device), [s / c for s, c in zip(spatial, coarse)],
                  new_shape=spatial)


def check_grads_gpu_vs_cpu(rng):
    """Gradients through warp_bounded and integrate_vec_batched on CUDA
    tensors (the backward kernel) against the same on CPU tensors, where
    VXM_WINDOW_HALO=1 sends the CPU through the bounded tier too. Fails if a
    gradient is None or zero, as it was before the warp had a backward."""
    spatial = (40, 48, 56)
    vol = rng.standard_normal((1, *spatial, 3), dtype=np.float32)
    shift = rng.uniform(-1, 1, size=(1, *spatial, 3)).astype(np.float32)
    vec = smooth_field(rng, spatial, (5, 6, 7), 8.0, "cpu")[None].numpy()
    w_out = rng.standard_normal((1, *spatial, 3), dtype=np.float32)

    def grads(device):
        v, s, u = (torch.from_numpy(a).to(device).requires_grad_() for a in (vol, shift, vec))
        w = torch.from_numpy(w_out).to(device)
        reset_launches()
        g_warp = torch.autograd.grad((warp_bounded(v, s, 1) * w).sum(), (v, s),
                                     allow_unused=True)
        g_int = torch.autograd.grad((warp_ops.integrate_vec_batched(u, 7) * w).sum(), (u,),
                                    allow_unused=True)
        counts = read_launches()
        return [None if x is None else x.cpu() for x in (*g_warp, *g_int)], \
            counts["bwd_ran" if device == "cuda" else "bwd"]

    gpu, gpu_launches = grads("cuda")
    with window_halo("1"):
        cpu, cpu_launches = grads("cpu")
    log(f"max|vec| {np.abs(vec).max():.3f} voxels; warp_bounded_bwd launches that ran on "
        f"the GPU {gpu_launches}, launches on the CPU {cpu_launches}")
    if gpu_launches == 0 or cpu_launches != 0:
        raise AssertionError("the GPU gradients did not come from the backward kernel alone")
    for name, a, b in zip(("warp dvol", "warp dshift", "integrate dvec"), gpu, cpu):
        if a is None or b is None:
            raise AssertionError(f"{name}: no gradient")
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        log(f"{name}: GPU vs CPU max abs err {err:.4e}, max|grad| {scale:.4e}, "
            f"rel {err / max(scale, 1e-30):.4e} (tol {GRAD_GPU_CPU_RTOL})")
        if not scale > 0:
            raise AssertionError(f"{name}: zero gradient")
        if not err <= GRAD_GPU_CPU_RTOL * scale:
            raise AssertionError(f"{name}: GPU and CPU gradients differ")


def conv_bound(ci, co, vox, dtype, f32_rate=F32_CONV_FLOPS_PER_S):
    """The least time of one conv on the card: its operations,
    2 * 27 * ci * co per voxel, at the dense bf16 tensor-core rate or, in
    float32, ``f32_rate`` (three TF32 passes), or its bytes, x read and y
    written once. Returns (ms, bound_by, seconds of the bytes, seconds of the
    operations)."""
    t_bytes = (ci + co) * vox * (2 if dtype == torch.bfloat16 else 4) / HBM_BYTES_PER_S
    rate = BF16_TENSOR_FLOPS_PER_S if dtype == torch.bfloat16 else f32_rate
    t_ops = 2 * 27 * ci * co * vox / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), \
        t_bytes, t_ops


def check_conv3(seed, convs=UNET_CONVS, orientations=("fwd", "fwd_act_off", "dx"),
                label="conv3", dtypes=(torch.bfloat16, torch.float32)):
    """The conv kernel against its plain version at a U-Net's (D, H, W, ci,
    co) ``convs``, in forward order (default: the full-width VxmDense's):
    the forward in both rounding orders, the forward with the activation off
    and a non-zero bias (``do_res`` blocks), and the input-gradient
    orientation (taps flipped, ci and co swapped, no bias or activation),
    those of ``orientations``, in ``dtypes``, within conv3.kernel_tolerance
    and bit-equal across two launches; times of the rounding order the main
    path uses beside the bound and cuDNN's, cuDNN's float32 in full
    float32, as the kernel computes. Returns the rows and the totals by
    (dtype, orientation) over the convs a register call (forward) and a
    train step (input gradient: all but the first) run."""
    with full_float32():
        return _check_conv3(seed, convs, orientations, label, dtypes)


def _check_conv3(seed, convs, orientations, label, dtypes):
    rows, totals = [], {}
    gen = torch.Generator(device="cuda").manual_seed(seed)  # data made on the card
    cl = torch.channels_last_3d  # the layout the U-Net keeps in conv-kernel mode
    for dtype in dtypes:
        elem = 2 if dtype == torch.bfloat16 else 4
        for index, (D, H, W, ci, co) in enumerate(convs):
            vox = D * H * W
            x = torch.randn((1, ci, D, H, W), generator=gen, device="cuda").to(dtype).contiguous(
                memory_format=cl)
            g = torch.randn((1, co, D, H, W), generator=gen, device="cuda").to(dtype).contiguous(
                memory_format=cl)
            kernel = torch.randn((3, 3, 3, ci, co), generator=gen, device="cuda") * \
                (2.0 / (27 * ci)) ** 0.5
            bias = 0.1 * torch.randn(co, generator=gen, device="cuda")
            flipped = kernel.flip(0, 1, 2).transpose(3, 4)
            path_order = not conv3.jax_kernel_takes(ci, co, D, H, W, elem, elem)
            # the forward as the U-Net calls it; the input gradient as the
            # backward calls it (conv3_input_grad flips the taps itself), its
            # plain version and cuDNN with the flipped, transposed taps
            cases = {
                "fwd": (x, kernel, bias, 0.2, [path_order, not path_order], (ci, co),
                        lambda order, x=x, kernel=kernel, bias=bias: conv3.conv3_same_cf(
                            x, kernel, bias, act_slope=0.2, round_conv_first=order)),
                # the activation off with a bias: the mode of a do_res block
                # and of a block before a final activation
                "fwd_act_off": (x, kernel, bias, None, [path_order], (ci, co),
                                lambda order, x=x, kernel=kernel, bias=bias: conv3.conv3_same_cf(
                                    x, kernel, bias, act_slope=None, round_conv_first=order)),
                "dx": (g, flipped, torch.zeros(ci, device="cuda"), None, [False], (co, ci),
                       lambda order, g=g, kernel=kernel: conv3.conv3_input_grad(g, kernel)),
            }
            for orientation, (inp, k, b, slope, orders, (c_in, c_out), launch) in \
                    cases.items():
                if orientation not in orientations:
                    continue
                err = ratio = 0.0
                equal_share = 1.0
                repeatable = True
                for order in orders:
                    y = launch(order)
                    y2 = launch(order)
                    plain = conv3.conv3_same_cf_plain(inp, k, b, slope, None, order)
                    torch.cuda.synchronize()
                    diff = (y.float() - plain.float()).abs()
                    err = max(err, diff.max().item())
                    ratio = max(ratio, (diff / conv3.kernel_tolerance(plain, b, order)).max().item())
                    equal_share = min(equal_share, (y == plain).float().mean().item())
                    repeatable = repeatable and torch.equal(y, y2)
                    del y, y2, plain, diff
                order = orders[0]
                w_lib = k.permute(4, 3, 0, 1, 2).to(dtype).contiguous()
                b_lib = b.to(dtype)
                bound_ms, bound_by, t_bytes, t_ops = conv_bound(c_in, c_out, vox, dtype)
                # float32's bound at the CUDA-core rate (the bound stated before
                # the tensor-core kernel), for comparison
                cuda_core_ms = conv_bound(c_in, c_out, vox, dtype, F32_FLOPS_PER_S)[0]
                row = dict(
                    conv=index, orientation=orientation, dtype=str(dtype).split(".")[1],
                    shape=[1, c_in, D, H, W], co=c_out, round_conv_first=order,
                    max_abs_err=err, max_err_over_tol=ratio, equal_share=equal_share,
                    repeatable=repeatable,
                    ms=time_cuda_ms(lambda: launch(order)),
                    plain_ms=time_cuda_ms(lambda: conv3.conv3_same_cf_plain(
                        inp, k, b, slope, None, order), reps=3, warmup=1),
                    library_ms=time_cuda_ms(lambda: F.conv3d(inp, w_lib, b_lib, padding=1)),
                    bound_ms=bound_ms, bound_by=bound_by)
                log(json.dumps(row))
                if not ratio <= 1.0:
                    raise AssertionError(f"conv3 kernel differs from its plain version by "
                                         f"{ratio:.3f} of its tolerance at {row}")
                if not repeatable:
                    raise AssertionError(f"two launches of the conv3 kernel differ at {row}")
                # in bfloat16 the sums' order rarely flips a rounding (the
                # other rounding order differs in about a third of outputs)
                if dtype == torch.bfloat16 and not equal_share >= BF16_EQUAL_SHARE:
                    raise AssertionError(f"conv3 kernel equals its plain version on only "
                                         f"{equal_share:.4f} of the outputs at {row}")
                rows.append(row)
                if orientation != "dx" or index > 0:
                    t = totals.setdefault((row["dtype"], orientation), dict(
                        convs=0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                        t_bytes=0.0, t_ops=0.0, cuda_core_bound_ms=0.0))
                    t["convs"] += 1
                    t["cuda_core_bound_ms"] += cuda_core_ms
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                        t[key] += row[key]
                    t["t_bytes"] += t_bytes
                    t["t_ops"] += t_ops
            del x, g, kernel, flipped
    for (dtype, orientation), t in totals.items():
        t["bound_by"] = "bytes" if t.pop("t_bytes") >= t.pop("t_ops") else "operations"
        f32_note = (f"; at the float32 CUDA-core rate the bound was "
                    f"{t['cuda_core_bound_ms']:.4f} ms" if dtype == "float32" else "")
        t.pop("cuda_core_bound_ms")
        log(f"{label} {dtype} {orientation}, {t['convs']} convs: kernel {t['ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}{f32_note}), plain {t['plain_ms']:.4f} "
            f"ms, cuDNN {t['library_ms']:.4f} ms")
    return rows, totals


def default_recipe(inshape, flow_std=None):
    """scripts/train.py's default: MSE + Grad('l2', loss_mult=2), weight 0.01,
    on a float32 VxmDense with default features, initialised from seed 0.
    ``flow_std`` redraws the flow head's kernel as N(0, flow_std) (seed 1),
    for flows of about a voxel instead of the init's ~1e-5."""
    model = VxmDense(inshape, int_steps=7, int_resolution=2,
                     generator=torch.Generator().manual_seed(SEED))
    if flow_std is not None:
        with torch.no_grad():
            model.flow.weight.normal_(0.0, flow_std,
                                      generator=torch.Generator().manual_seed(SEED + 1))
    terms = [LossTerm("y_source", losses.MSE(1.0).loss, weight=1.0, target_index=0),
             LossTerm("reg", losses.Grad("l2", loss_mult=2).loss, weight=0.01,
                      target_index=1, name="grad")]
    return model, terms


def one_step_grads(inshape, device, moving, fixed, flow_std=None):
    """Loss and parameter gradients of one train step of the default recipe
    (no update, ``flow_std`` as in ``default_recipe``), with the kernel
    launch counts of the step."""
    zero = torch.zeros((1, *inshape, 3))
    return recipe_step_grads(default_recipe, inshape, device, ((moving, fixed), (fixed, zero)),
                             flow_std)


def compare_grads(label, loss_a, grads_a, loss_b, grads_b, rtol):
    """Hold each gradient tensor of run a to run b within ``rtol`` of the
    tensor's largest magnitude; returns the largest relative error."""
    worst = abs(loss_a - loss_b) / abs(loss_b)
    log(f"{label}: loss {loss_a:.8f} vs {loss_b:.8f} (rel {worst:.3e})")
    for name in grads_b:
        scale = grads_b[name].abs().max().item()
        rel = (grads_a[name] - grads_b[name]).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, rel)
        if not (scale > 0 and rel <= rtol):
            raise AssertionError(f"{label}: {name} differs by {rel:.3e} of its max "
                                 f"{scale:.3e} (tol {rtol})")
    log(f"{label}: largest relative difference over loss and {len(grads_b)} gradient "
        f"tensors {worst:.4e} (tol {rtol})")
    return worst


def train_full_width(profile):
    """Phase 4: the default recipe at full width on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    moving, fixed = smooth_pair(INSHAPE, "cuda")

    # (a) the kernel path against the gather-only path, both on the card:
    # from the seed-0 init, and with the flow head redrawn for real flows
    for flow_std, rtol in ((None, TRAIN_INIT_KERNEL_VS_GATHER_RTOL),
                           (FLOW_STD, TRAIN_KERNEL_VS_GATHER_RTOL)):
        label = "seed-0 init" if flow_std is None else f"flow head N(0, {flow_std})"
        loss_k, grads_k, launches = one_step_grads(INSHAPE, "cuda", moving, fixed, flow_std)
        with window_halo("0"):
            loss_g, grads_g, launches_g = one_step_grads(INSHAPE, "cuda", moving, fixed,
                                                         flow_std)
        log(f"{label}: kernel launches {launches}, gather-only path {launches_g}")
        check_warp_work(launches, f"the kernel path, {label}")
        if not no_warp_launches(launches_g):
            raise AssertionError(f"the gather-only path launched warp kernels: {launches_g}")
        compare_grads(f"kernel vs gather-only, {label}, {INSHAPE}", loss_k, grads_k,
                      loss_g, grads_g, rtol)
        if flow_std is None:
            train_launches = launches
        else:
            redrawn_launches = launches
        del grads_k, grads_g

    # (b) the card against the port's CPU run, at half width; the CPU takes
    # the bounded tiers too (VXM_WINDOW_HALO=1), through the plain backward
    half = tuple(s // 2 for s in INSHAPE)
    mv_h, fx_h = smooth_pair(half, "cpu")
    for flow_std in (None, FLOW_STD):
        label = "seed-0 init" if flow_std is None else f"flow head N(0, {flow_std})"
        t0 = time.perf_counter()
        loss_c, grads_c, _ = one_step_grads(half, "cuda", mv_h, fx_h, flow_std)
        with window_halo("1"):
            loss_cpu, grads_cpu, _ = one_step_grads(half, "cpu", mv_h, fx_h, flow_std)
        log(f"one step at {half} on the CPU and the card: {time.perf_counter() - t0:.2f} s")
        compare_grads(f"GPU vs CPU, {label}, {half}", loss_c, grads_c, loss_cpu, grads_cpu,
                      TRAIN_GPU_VS_CPU_RTOL)

    # (c)-(e) ten steps from seed 0
    model, terms = default_recipe(INSHAPE)
    trainer = Trainer(model, terms, lr=1e-4, device="cuda")
    zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    step_losses, step_s, per_step = [], [], []
    for step in range(11):
        reset_launches()
        t0 = time.perf_counter()
        metrics = trainer.train_step((moving, fixed), (fixed, zero))
        step_losses.append(metrics["loss"].item())  # synchronises
        step_s.append(time.perf_counter() - t0)
        per_step.append(read_launches())
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log("step losses: " + ", ".join(f"{x:.8f}" for x in step_losses))
    log("bounded kernel launches per step, forward/ran and backward/ran: " + ", ".join(
        f"{p['fwd']}/{p['fwd_ran']} {p['bwd']}/{p['bwd_ran']}" for p in per_step))
    median_s = float(np.median(step_s[1:]))
    log(f"float32 train step, bs1, {INSHAPE}: median {median_s:.4f} s/step over "
        f"{len(step_s) - 1} steps after one warm-up ({step_s[0]:.3f} s); peak memory "
        f"allocated {peak_gb:.3f} GiB")
    if not all(np.isfinite(step_losses)):
        raise AssertionError("non-finite training loss")
    if not step_losses[-1] < step_losses[0]:
        raise AssertionError(f"ten steps did not lower the loss: {step_losses}")
    for step, counts in enumerate(per_step):
        check_warp_work(counts, f"train step {step}")
    if profile:
        profile_device("train step", lambda: trainer.train_step(
            (moving, fixed), (fixed, zero))["loss"].item(), rows=30)
        conv_library_times(trainer.model)
    return train_launches, redrawn_launches, median_s


def train_checkpoint_recipe():
    """Three steps of the committed checkpoint's own recipe: use_probs, NCC
    and KL (prior lambda 10, weight 0.01), bfloat16, from its weights."""
    model = load_model(str(CHECKPOINT), device="cuda")
    terms = [LossTerm("y_source", losses.NCC().loss, weight=1.0, target_index=0),
             LossTerm("reg", losses.KL(10.0, INSHAPE).loss, weight=0.01,
                      target_index=1, name="kl")]
    trainer = Trainer(model, terms, lr=1e-4, device="cuda")
    trainer.load(str(CHECKPOINT))
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
    for step in range(3):
        reset_launches()
        metrics = {k: v.item() for k, v in trainer.train_step((moving, fixed),
                                                              (fixed, zero)).items()}
        counts = read_launches()
        log(f"checkpoint recipe step {step}: {json.dumps(metrics)}; "
            f"warp_bounded_bwd launches {counts['bwd']}, of which {counts['bwd_ran']} ran")
        if not all(np.isfinite(list(metrics.values()))):
            raise AssertionError("non-finite loss in the checkpoint recipe")
        check_warp_work(counts, f"checkpoint recipe step {step}")


def train_conv_kernel(moving, fixed, profile):
    """Phase 4b: the default recipe (float32, TF32 off, flow head redrawn
    N(0, FLOW_STD)) with the conv kernel: one step against cuDNN mode, then
    three steps. Returns the launch counts of a step."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for enabled in (True, False):
        with conv_kernel_mode(enabled):
            runs[enabled] = one_step_grads(INSHAPE, "cuda", moving, fixed, FLOW_STD)
    log(f"one step, conv kernel launches {runs[True][2]}, cuDNN mode {runs[False][2]}")
    expected = TRAIN_STEP_CONVS
    if runs[True][2]["conv"] != expected or runs[False][2]["conv"] != 0:
        raise AssertionError(f"expected {expected} conv launches per step")
    for enabled, run in runs.items():
        check_warp_work(run[2], f"one step, conv kernel {enabled}")
    if runs[True][2]["layout_copies"] != 0:
        raise AssertionError(f"a train step copied conv inputs or cotangents to channels-last "
                             f"{runs[True][2]['layout_copies']} times")
    compare_grads(f"conv kernel vs cuDNN, flow head N(0, {FLOW_STD}), {INSHAPE}",
                  runs[True][0], runs[True][1], runs[False][0], runs[False][1],
                  TRAIN_CONV_KERNEL_VS_CUDNN_RTOL)
    one_step_launches = runs[True][2]
    del runs

    with conv_kernel_mode(True):
        model, terms = default_recipe(INSHAPE, FLOW_STD)
        trainer = Trainer(model, terms, lr=1e-4, device="cuda")
        zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        step_losses, step_s, per_step = [], [], []
        for _ in range(3):
            reset_launches()
            t0 = time.perf_counter()
            step_losses.append(trainer.train_step((moving, fixed), (fixed, zero))["loss"].item())
            step_s.append(time.perf_counter() - t0)
            per_step.append(read_launches())
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        log("conv kernel step losses: " + ", ".join(f"{x:.8f}" for x in step_losses))
        log(f"conv kernel launches per step: {per_step}")
        log(f"float32 train step with the conv kernel, bs1, {INSHAPE}: " + ", ".join(
            f"{x:.4f}" for x in step_s) + f" s/step; peak memory allocated {peak_gb:.3f} GiB")
        if not (all(np.isfinite(step_losses)) and step_losses[-1] < step_losses[0]):
            raise AssertionError(f"three steps did not lower the loss: {step_losses}")
        if any(p["conv"] != expected for p in per_step):
            raise AssertionError(f"a step missed a kernel: {per_step}")
        for counts in per_step:
            check_warp_work(counts, "a conv-kernel train step")
        if any(p["layout_copies"] != 0 for p in per_step):
            raise AssertionError(f"a step copied conv inputs to channels-last: {per_step}")
        if profile:
            profile_device("train step, conv kernel", lambda: trainer.train_step(
                (moving, fixed), (fixed, zero))["loss"].item(), rows=30)
    return per_step[-1], one_step_launches


def semi_recipe(inshape, flow_std=None):
    """scripts/train_semisupervised_seg.py's default: MSE + Grad('l2',
    loss_mult=2) at weight 0.01 + Dice at weight 0.01, on a float32
    VxmDenseSemiSupervisedSeg of SEMI_LABELS labels with default features,
    initialised from seed 0 (its VxmDense draws as default_recipe's);
    ``flow_std`` redraws the flow head as default_recipe does."""
    model = VxmDenseSemiSupervisedSeg(inshape, nb_labels=SEMI_LABELS, int_steps=7,
                                      int_resolution=2,
                                      generator=torch.Generator().manual_seed(SEED))
    if flow_std is not None:
        with torch.no_grad():
            model.vxm.flow.weight.normal_(0.0, flow_std,
                                          generator=torch.Generator().manual_seed(SEED + 1))
    terms = [LossTerm("y_source", losses.MSE().loss, weight=1.0, target_index=0),
             LossTerm("reg", losses.Grad("l2", loss_mult=2).loss, weight=0.01,
                      target_index=1, name="grad"),
             LossTerm("y_seg_source", losses.Dice().loss, weight=0.01, target_index=2,
                      name="dice")]
    return model, terms


def recipe_step_grads(recipe, inshape, device, batch, flow_std=None):
    """Loss and parameter gradients of one train step of ``recipe`` (no
    update), with the kernel launch counts of the step."""
    model, terms = recipe(inshape, flow_std)
    trainer = Trainer(model, terms, device=device)
    trainer.model.train()
    inputs, targets = (tuple(a.to(device) for a in part) for part in batch)
    reset_launches()
    loss, _ = trainer.loss_fn(inputs, targets)
    loss.backward()
    if device == "cuda":
        torch.cuda.synchronize()
    grads = {n: p.grad.detach().cpu() for n, p in trainer.model.named_parameters()}
    return loss.item(), grads, read_launches()


def find_node(tensor, name):
    """Whether the autograd graph of ``tensor`` holds a node called ``name``."""
    seen, todo = set(), [tensor.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == name:
            return True
        todo.extend(f for f, _ in node.next_functions)
    return False


def train_semisupervised(one_step_launches, smi):
    """Phase 5: the semi-supervised recipe at full width on the card.
    ``one_step_launches`` maps conv-kernel mode (False, True) to the
    launches of one VxmDense step of phases 4 and 4b from the same weights
    (seed 0, flow head redrawn N(0, FLOW_STD)) on the same pair. Returns the
    launch counts of a step in cuDNN mode and in conv-kernel mode."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # (a) the card against the port's CPU run at half width, flows of about
    # a voxel; the CPU takes the bounded tiers too (VXM_WINDOW_HALO=1)
    half = tuple(s // 2 for s in INSHAPE)
    batch_h = semi_batch(half, "cpu")
    t0 = time.perf_counter()
    loss_c, grads_c, _ = recipe_step_grads(semi_recipe, half, "cuda", batch_h, FLOW_STD)
    with window_halo("1"):
        loss_cpu, grads_cpu, _ = recipe_step_grads(semi_recipe, half, "cpu", batch_h, FLOW_STD)
    log(f"semi-supervised step at {half} on the CPU and the card: "
        f"{time.perf_counter() - t0:.2f} s")
    compare_grads(f"semi-supervised GPU vs CPU, flow head N(0, {FLOW_STD}), {half}",
                  loss_c, grads_c, loss_cpu, grads_cpu, TRAIN_GPU_VS_CPU_RTOL)
    del grads_c, grads_cpu, batch_h

    # (b) the segmentation warp alone, forward and backward, launches no
    # kernel: its 30 channels take the gather
    inputs, targets = semi_batch(INSHAPE, "cuda")
    log(f"segmentations {tuple(inputs[2].shape)} one-hot; labels present in the source: "
        f"{int((inputs[2].sum(dim=(0, 1, 2, 3)) > 0).sum().item())} of {SEMI_LABELS}")
    seg_flow = smooth_field(np.random.default_rng(SEED + 9), tuple(inputs[2].shape[1:4]),
                            (5, 6, 7), 1.0, "cuda")[None].requires_grad_()
    reset_launches()
    torch.autograd.grad(warp_ops.transform_batched(inputs[2], seg_flow).sum(), seg_flow)
    torch.cuda.synchronize()
    seg_warp_launches = read_launches()
    log(f"segmentation warp alone, forward and backward: launches {seg_warp_launches}")
    if any(seg_warp_launches.values()):
        raise AssertionError("the 30-channel segmentation warp launched a kernel")

    # (c) three steps (flow head redrawn, as phase 4b) in cuDNN mode and
    # with the conv kernel
    per_mode = {}
    for enabled in (False, True):
        mode = "conv kernel" if enabled else "cuDNN"
        with conv_kernel_mode(enabled):
            model, terms = semi_recipe(INSHAPE, FLOW_STD)
            trainer = Trainer(model, terms, lr=1e-4, device="cuda")
            torch.cuda.reset_peak_memory_stats()
            step_losses, dices, step_s, per_step = [], [], [], []
            for _ in range(3):
                reset_launches()
                t0 = time.perf_counter()
                metrics = trainer.train_step(inputs, targets)
                step_losses.append(metrics["loss"].item())  # synchronises
                step_s.append(time.perf_counter() - t0)
                dices.append(metrics["dice"].item())
                per_step.append(read_launches())
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"semi-supervised, {mode}: step losses " + ", ".join(
            f"{x:.8f}" for x in step_losses) + "; dice " + ", ".join(f"{x:.6f}" for x in dices))
        log(f"semi-supervised, {mode}: launches per step {per_step}; a VxmDense step from "
            f"the same weights {one_step_launches[enabled]}")
        log(f"float32 semi-supervised train step, {mode}, bs1, {INSHAPE}, {SEMI_LABELS} labels: "
            + ", ".join(f"{x:.4f}" for x in step_s) + f" s/step (median of the last two "
            f"{float(np.median(step_s[1:])):.4f}); peak memory allocated {peak_gb:.3f} GiB; {smi}")
        if not (all(np.isfinite(step_losses)) and step_losses[-1] < step_losses[0]):
            raise AssertionError(f"three semi-supervised steps ({mode}) did not lower the "
                                 f"loss: {step_losses}")
        if not all(np.isfinite(d) and -1.0 <= d <= 0.0 for d in dices):
            raise AssertionError(f"the dice term left [-1, 0]: {dices}")
        # the first step launches what a VxmDense step from the same weights
        # launches (phases 4 and 4b); every step launches both warp kernels
        # and, in kernel mode, the U-Net's 21 convs
        convs = TRAIN_STEP_CONVS if enabled else 0
        if per_step[0] != {**one_step_launches[enabled], "conv": convs}:
            raise AssertionError(f"the first semi-supervised step launched {per_step[0]}, a "
                                 f"VxmDense step {one_step_launches[enabled]}")
        if any(p["conv"] != convs or p["layout_copies"] != 0 for p in per_step):
            raise AssertionError(f"a semi-supervised step missed a kernel: {per_step}")
        for counts in per_step:
            check_warp_work(counts, f"a semi-supervised step, {mode}")
        per_mode[enabled] = per_step[-1]
        del trainer, model
    return per_mode[False], per_mode[True]


def wide_seg_warp_check(rng):
    """Phase 5, last gate: the warp of a WIDE_LABELS-label one-hot at
    80x96x112 by a smooth flow (its corner table passes the gather's limit,
    so it takes the wide-channel path), value and flow gradient on the card
    against the CPU."""
    half = tuple(s // 2 for s in INSHAPE)
    moving = smooth_pair(half, "cpu")[0]
    seg = voronoi_labels(moving[0], WIDE_LABELS, SEED + 6)[None, ..., None].numpy()
    onehot = torch.from_numpy(np.ascontiguousarray(generators._one_hot_seg(
        seg, np.arange(1, WIDE_LABELS + 1))))
    table_bytes = int(np.prod(half)) * 8 * WIDE_LABELS * 4
    if not table_bytes > interp._CORNER_TABLE_BYTES_LIMIT:
        raise AssertionError(f"a corner table of {table_bytes} bytes takes the table path")
    flow = smooth_field(rng, half, (5, 6, 7), 3.0, "cpu")[None]
    w = torch.from_numpy(rng.standard_normal(onehot.shape, dtype=np.float32))
    results = {}
    for device in ("cuda", "cpu"):
        f = flow.to(device).requires_grad_()
        t0 = time.perf_counter()
        out = warp_ops.transform_batched(onehot.to(device), f)
        if not find_node(out, "_LinearGatherWideBackward"):
            raise AssertionError(f"the {WIDE_LABELS}-label warp on {device} did not take the "
                                 "wide-channel gather")
        g, = torch.autograd.grad((out * w.to(device)).sum(), f)
        results[device] = (out.detach().cpu(), g.cpu())
        log(f"{WIDE_LABELS}-label one-hot warp at {half} on {device} (wide-channel gather, "
            f"corner table {table_bytes} B): {time.perf_counter() - t0:.3f} s")
    for name, a, b in zip(("value", "flow gradient"), results["cuda"], results["cpu"]):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        log(f"wide seg warp {name}: GPU vs CPU max abs err {err:.3e}, max {scale:.3e}, rel "
            f"{err / scale:.3e} (tol {WARP_OPS_RTOL})")
        if not (scale > 0 and err <= WARP_OPS_RTOL * scale):
            raise AssertionError(f"the wide seg warp's {name} differs on the card")


def card_vs_cpu(label, fn, *arrays):
    """``fn`` on CUDA copies of ``arrays`` against ``fn`` on the CPU, within
    WARP_OPS_RTOL of the CPU result's largest magnitude."""
    t0 = time.perf_counter()
    gpu = fn(*(a.cuda() for a in arrays)).cpu()
    cpu = fn(*arrays)
    scale = cpu.abs().max().item()
    err = (gpu - cpu).abs().max().item()
    log(f"{label}: shape {tuple(cpu.shape)}, GPU vs CPU max abs err {err:.3e}, max {scale:.3e}, "
        f"rel {err / max(scale, 1e-30):.3e} (tol {WARP_OPS_RTOL}); {time.perf_counter() - t0:.2f} s")
    if not (scale > 0 and err <= WARP_OPS_RTOL * scale and tuple(gpu.shape) == tuple(cpu.shape)):
        raise AssertionError(f"{label}: the card disagrees with the CPU")


def warp_ops_check(rng):
    """Phase 5b: transform with affines, compose, integrate_vec and
    jacobian_determinant at 80x96x112, and cli/warp at full width, on the
    card against the CPU."""
    half = tuple(s // 2 for s in INSHAPE)
    vol = smooth_pair(half, "cpu")[0][0]

    def near_identity(rows):
        mat = np.eye(4, dtype=np.float32)[:rows]
        mat[:3, :3] += 0.08 * rng.standard_normal((3, 3))
        mat[:3, 3] = 4.0 * rng.standard_normal(3)
        return torch.from_numpy(mat.astype(np.float32))

    dense = smooth_field(rng, half, (5, 6, 7), 3.0, "cpu")
    mats = {rows: near_identity(rows) for rows in (3, 4)}
    with full_float32():
        for rows, mat in mats.items():
            for shift_center in (True, False):
                card_vs_cpu(f"transform, {rows}x4 affine, shift_center={shift_center}",
                            lambda v, m: warp_ops.transform(v, m, shift_center=shift_center),
                            vol, mat)
            card_vs_cpu(f"transform, {rows}x4 affine, shape (64, 96, 128)",
                        lambda v, m: warp_ops.transform(v, m, shift_center=False,
                                                        shape=(64, 96, 128)), vol, mat)
        card_vs_cpu("compose [affine, dense]", lambda m, d: warp_ops.compose([m, d]),
                    mats[3], dense)
        card_vs_cpu("compose [dense, affine]", lambda d, m: warp_ops.compose([d, m]),
                    dense, mats[4])
        for method, steps in (("ss", 7), ("quadrature", 5), ("ode", 3)):
            card_vs_cpu(f"integrate_vec {method}, {steps} steps",
                        lambda d: warp_ops.integrate_vec(d, method=method, nb_steps=steps), dense)
        card_vs_cpu("jacobian_determinant", warp_ops.jacobian_determinant, dense)

        # cli/warp at full width, a dense warp and an affine
        with tempfile.TemporaryDirectory() as tmp:
            moving = smooth_pair(INSHAPE, "cpu")[0][0, ..., 0]
            np.save(f"{tmp}/moving.npy", moving.numpy())
            np.save(f"{tmp}/warp.npy", smooth_field(rng, INSHAPE, (5, 6, 7), 4.0, "cpu").numpy())
            np.save(f"{tmp}/affine.npy", mats[3].numpy())
            for warp_file in ("warp.npy", "affine.npy"):
                out = {}
                for device in ("cuda", "cpu"):
                    t0 = time.perf_counter()
                    warp_cli.main(["--moving", f"{tmp}/moving.npy", "--warp", f"{tmp}/{warp_file}",
                                   "--moved", f"{tmp}/moved_{device}.nii", "--device", device])
                    out[device] = load_volfile(f"{tmp}/moved_{device}.nii")
                    log(f"cli/warp {warp_file} on {device}: {time.perf_counter() - t0:.2f} s")
                scale = np.abs(out["cpu"]).max()
                err = np.abs(out["cuda"] - out["cpu"]).max()
                moved_by = np.abs(out["cuda"] - moving.numpy()).max()
                log(f"cli/warp {warp_file} at {INSHAPE}: GPU vs CPU max abs err {err:.3e}, max "
                    f"{scale:.3e} (tol {WARP_OPS_RTOL}); max change of the image {moved_by:.3f}")
                if not (out["cuda"].shape == INSHAPE and err <= WARP_OPS_RTOL * scale
                        and moved_by > 0.1):
                    raise AssertionError(f"cli/warp with {warp_file}: the card disagrees with "
                                         "the CPU or did not move the image")


@contextlib.contextmanager
def integration_remat(remat):
    """Run with the models' integration (``integrate_vec_batched``)
    rematerialised or not; the default is rematerialised, as in JAX."""
    original = warp_ops.integrate_vec_batched
    warp_ops.integrate_vec_batched = lambda *a, **kw: original(*a, remat=remat, **kw)
    try:
        yield
    finally:
        warp_ops.integrate_vec_batched = original


def pointcloud_files(tmp, spatial, device):
    """labelled_pair as the point-cloud trainer's files: the atlas (the
    moving scan and its labels) and one subject (the fixed scan and its
    labels), npz files with 'vol' and 'seg' in ``tmp``."""
    moving, fixed, src, trg = labelled_pair(spatial, device)
    os.makedirs(tmp, exist_ok=True)
    np.savez(f"{tmp}/atlas.npz", vol=moving[0, ..., 0].cpu().numpy(), seg=src.cpu().numpy())
    np.savez(f"{tmp}/subject.npz", vol=fixed[0, ..., 0].cpu().numpy(), seg=trg.cpu().numpy())
    return f"{tmp}/atlas.npz", f"{tmp}/subject.npz"


def pointcloud_generator(tmp, device, labels=None):
    """generators.surf_semisupervised as the point-cloud recipe runs it
    (--surf-bidir, SURF_POINTS points, POINT_LABELS_SAMPLED labels a step,
    smoothing 0.1, SDTs at full resolution) on ``pointcloud_files``, its
    draws from a numpy generator seeded SEED."""
    with np.load(f"{tmp}/atlas.npz") as d:
        vol, seg = d["vol"], d["seg"]
    return generators.surf_semisupervised(
        [f"{tmp}/subject.npz"], vol, seg, nb_surface_pts=SURF_POINTS, labels=labels,
        surf_bidir=True, smooth_seg_std=0.1, nb_labels_sample=POINT_LABELS_SAMPLED,
        sdt_vol_resize=1.0, device=device, rng=np.random.default_rng(SEED))


def pointcloud_recipe(inshape, flow_std=None):
    """The point-cloud recipe's model and losses: VxmDenseSemiSupervisedPointCloud
    (a bidirectional VxmDense with default features, from seed 0), MSE at 0.5
    both ways, Grad('l2', loss_mult=2) at 0.01 and the SDT terms at
    0.25 / dt_sigma^2 with dt_sigma 1; ``flow_std`` redraws the flow head as
    default_recipe does."""
    model = VxmDenseSemiSupervisedPointCloud(
        inshape, nb_surface_points=SURF_POINTS, nb_labels_sample=POINT_LABELS_SAMPLED,
        int_steps=7, int_resolution=2, generator=torch.Generator().manual_seed(SEED))
    if flow_std is not None:
        with torch.no_grad():
            model.vxm.flow.weight.normal_(0.0, flow_std,
                                          generator=torch.Generator().manual_seed(SEED + 1))
    terms = [LossTerm("y_source", losses.MSE().loss, weight=0.5, target_index=0),
             LossTerm("y_target", losses.MSE().loss, weight=0.5, target_index=1),
             LossTerm("reg", losses.Grad("l2", loss_mult=2).loss, weight=0.01, target_index=2,
                      name="grad"),
             LossTerm("subj_dt_value", losses.MSE().loss, weight=0.25, target_index=3,
                      name="subj_dt"),
             LossTerm("atl_dt_value", losses.MSE().loss, weight=0.25, target_index=4,
                      name="atl_dt")]
    return model, terms


def train_pointcloud(smi):
    """Phase 6: the point-cloud recipe at full width on the card. Returns
    the launch counts of a step in cuDNN mode and in conv-kernel mode."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    half = tuple(s // 2 for s in INSHAPE)
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the generator at half width on the card and on the CPU, from
        # the same numpy seed: its images, SDT stacks and clouds bit-equal
        pointcloud_files(f"{tmp}/half", half, "cpu")
        labels = np.arange(1, POINT_CPU_LABELS + 1)
        batches = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            batches[device] = next(pointcloud_generator(f"{tmp}/half", device, labels))
            log(f"point-cloud generator at {half} on {device}, {POINT_CPU_LABELS} labels "
                f"(atlas SDTs and the first step): {time.perf_counter() - t0:.2f} s")
        names = ["moving", "fixed", "subject SDTs", "atlas SDTs", "subject cloud", "atlas cloud",
                 "target fixed", "target moving", "zero flow", "zero values", "zero values"]
        for name, a, b in zip(names, sum(batches["cuda"], []), sum(batches["cpu"], [])):
            if a.device.type != "cuda" or not torch.equal(a.cpu(), b):
                raise AssertionError(f"the point-cloud generator's {name} differ on the card")
        log(f"point-cloud generator at {half}: the {len(names)} tensors bit-equal on the card "
            f"and the CPU (subject SDTs {tuple(batches['cpu'][0][2].shape)}, clouds "
            f"{tuple(batches['cpu'][0][4].shape)})")

        # (b) one step, the card against the port's CPU run at half width,
        # flows of about a voxel; the CPU takes the bounded tiers too
        batch_h = batches["cpu"]
        t0 = time.perf_counter()
        loss_c, grads_c, _ = recipe_step_grads(pointcloud_recipe, half, "cuda", batch_h,
                                               FLOW_STD)
        with window_halo("1"):
            loss_cpu, grads_cpu, _ = recipe_step_grads(pointcloud_recipe, half, "cpu", batch_h,
                                                       FLOW_STD)
        log(f"point-cloud step at {half} on the CPU and the card: "
            f"{time.perf_counter() - t0:.2f} s")
        compare_grads(f"point-cloud GPU vs CPU, flow head N(0, {FLOW_STD}), {half}",
                      loss_c, grads_c, loss_cpu, grads_cpu, TRAIN_GPU_VS_CPU_RTOL)
        del grads_c, grads_cpu, batches, batch_h

        # (c) the generator on the card at full width: the atlas's SDTs of
        # every label, then a step's subject SDTs and both clouds
        pointcloud_files(tmp, INSHAPE, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gen = pointcloud_generator(tmp, "cuda")
        draws, gen_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            draws.append(next(gen))
            torch.cuda.synchronize()
            gen_s.append(time.perf_counter() - t0)
        gen_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        inputs, targets = draws[0]
        log(f"point-cloud generator on the card, {INSHAPE}, {SEMI_LABELS} labels, "
            f"{POINT_LABELS_SAMPLED} a step, {SURF_POINTS} points: first draw {gen_s[0]:.3f} s "
            f"(with the atlas's {SEMI_LABELS} SDTs), then " + ", ".join(
                f"{x:.3f}" for x in gen_s[1:]) + f" s per step; peak memory {gen_peak:.3f} "
            f"GiB; {smi}")
        if tuple(inputs[2].shape) != (1, *INSHAPE, POINT_LABELS_SAMPLED) or \
                tuple(inputs[4].shape) != (1, SURF_POINTS, 4) or \
                not all(a.device.type == "cuda" and torch.isfinite(a).all() for a in inputs):
            raise AssertionError("the point-cloud generator's tensors are not the recipe's")
        del draws, gen

        # (d) three steps (flow head redrawn, as phase 4b) on the first
        # draw, in cuDNN mode and with the conv kernel
        per_mode = {}
        for enabled in (False, True):
            mode = "conv kernel" if enabled else "cuDNN"
            with conv_kernel_mode(enabled):
                model, terms = pointcloud_recipe(INSHAPE, FLOW_STD)
                trainer = Trainer(model, terms, lr=1e-4, device="cuda")
                torch.cuda.reset_peak_memory_stats()
                step_losses, step_s, per_step, dts = [], [], [], []
                for _ in range(3):
                    reset_launches()
                    t0 = time.perf_counter()
                    metrics = trainer.train_step(inputs, targets)
                    step_losses.append(metrics["loss"].item())  # synchronises
                    step_s.append(time.perf_counter() - t0)
                    per_step.append(read_launches())
                    dts.append((metrics["subj_dt"].item(), metrics["atl_dt"].item()))
                peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"point-cloud, {mode}: step losses " + ", ".join(
                f"{x:.8f}" for x in step_losses) + "; SDT terms (subject, atlas) " + ", ".join(
                f"({a:.5f}, {b:.5f})" for a, b in dts))
            log(f"point-cloud, {mode}: launches per step {per_step}")
            log(f"float32 point-cloud train step, {mode}, bs1, {INSHAPE}: " + ", ".join(
                f"{x:.4f}" for x in step_s) + f" s/step (median of the last two "
                f"{float(np.median(step_s[1:])):.4f}); peak memory allocated {peak_gb:.3f} GiB; "
                f"{smi}")
            if not (all(np.isfinite(step_losses)) and step_losses[-1] < step_losses[0]):
                raise AssertionError(f"three point-cloud steps ({mode}) did not lower the "
                                     f"loss: {step_losses}")
            convs = TRAIN_STEP_CONVS if enabled else 0
            if any(p["conv"] != convs or p["layout_copies"] != 0 for p in per_step):
                raise AssertionError(f"a point-cloud step missed a kernel: {per_step}")
            for counts in per_step:
                check_warp_work(counts, f"a point-cloud step, {mode}")
            per_mode[enabled] = per_step[-1]
            if not enabled:
                trainer.save(f"{tmp}/pointcloud.npz")
            del trainer, model

        # (e) registration_model, then a pair registered through cli/register
        net = resolve_registration_model(load_model(f"{tmp}/pointcloud.npz", device="cuda"))
        log(f"registration_model of the point-cloud checkpoint: {type(net).__name__} "
            f"{net.inshape}, bidir {net.bidir}, {sum(p.numel() for p in net.parameters())} "
            f"params")
        reset_launches()
        t0 = time.perf_counter()
        register_cli.main(["--moving", f"{tmp}/subject.npz", "--fixed", f"{tmp}/atlas.npz",
                           "--model", f"{tmp}/pointcloud.npz", "--moved", f"{tmp}/moved.nii",
                           "--warp", f"{tmp}/warp.nii"])
        counts = read_launches()
        warp = load_volfile(f"{tmp}/warp.nii")
        moved = load_volfile(f"{tmp}/moved.nii")
        log(f"cli/register with the point-cloud checkpoint: {time.perf_counter() - t0:.2f} s, "
            f"launches {counts}, warp {warp.shape}, max|warp| "
            f"{np.abs(warp).max():.3f} voxels")
        if warp.shape != (*INSHAPE, 3) or moved.shape != INSHAPE or \
                not (np.isfinite(warp).all() and np.isfinite(moved).all()):
            raise AssertionError("cli/register of the point-cloud checkpoint failed")
        check_warp_work(counts, "cli/register of the point-cloud checkpoint", backward=False)
    return per_mode[False], per_mode[True]


def cached_dispatch_check(smi):
    """Phase 6b: fit_cached_pairs over DISPATCH_STEPS-step dispatches of
    the default recipe against single steps on the same picks, from the
    same weights, at full width; then phase 4's step with and without the
    rematerialised integration. Returns the launch counts of a dispatch's
    step."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    data = torch.cat([moving, fixed, moving.flip(1), fixed.flip(2)])
    log(f"volume stack on the card: {tuple(data.shape)}, "
        f"{data.numel() * data.element_size() / 2 ** 20:.1f} MiB")
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = {}
        for k in (1, DISPATCH_STEPS, 1):  # the first run warms the card up
            model, terms = default_recipe(INSHAPE, FLOW_STD)
            trainer = Trainer(model, terms, lr=1e-4, device="cuda")
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.fit_cached_pairs(
                data, epochs=DISPATCH_STEPS // k, steps_per_epoch=k, steps_per_dispatch=k,
                seed=SEED, log_fn=lambda _: None)
            torch.cuda.synchronize()
            runs[k] = dict(s=(time.perf_counter() - t0) / DISPATCH_STEPS, metrics=metrics,
                           fetches=trainer.metric_fetches, launches=read_launches(),
                           params={n: p.detach().clone()
                                   for n, p in trainer.model.named_parameters()})
            del trainer, model
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    one, many = runs[1], runs[DISPATCH_STEPS]
    equal = all(torch.equal(one["params"][n], p) for n, p in many["params"].items())
    worst = max(((one["params"][n] - p).abs().max() / p.abs().max()).item()
                for n, p in many["params"].items())
    log(f"fit_cached_pairs, {DISPATCH_STEPS} steps from the same weights on the same picks: "
        f"K = {DISPATCH_STEPS} against K = 1 params bit-equal {equal} (cudnn.deterministic), "
        f"largest difference {worst:.3e} of a tensor's largest magnitude (tol {DISPATCH_RTOL})")
    log(f"host metric fetches: {many['fetches']} for one dispatch of {DISPATCH_STEPS} steps, "
        f"{one['fetches']} for {DISPATCH_STEPS} single steps; dispatch-mean metrics "
        f"{json.dumps(many['metrics'])}, the last single step's {json.dumps(one['metrics'])}")
    log(f"seconds per step, {INSHAPE}, float32, cuDNN: K = 1 {one['s']:.4f}, "
        f"K = {DISPATCH_STEPS} {many['s']:.4f} (launches per {DISPATCH_STEPS} steps "
        f"{many['launches']}); {smi}")
    if not (equal or worst <= DISPATCH_RTOL):
        raise AssertionError("the dispatched steps differ from single steps")
    if many["fetches"] != 1 or one["fetches"] != DISPATCH_STEPS:
        raise AssertionError(f"metric fetches {many['fetches']} and {one['fetches']}")
    check_warp_work(many["launches"], f"a dispatch of {DISPATCH_STEPS} steps")
    launches = {k: v // DISPATCH_STEPS for k, v in many["launches"].items()}

    # phase 4's step with and without the rematerialised integration: the
    # gradients bit-equal (cudnn.deterministic), memory and time per step
    results = {}
    for remat in (True, False):
        with integration_remat(remat):
            torch.backends.cudnn.deterministic = True
            try:
                loss, grads, step_launches = one_step_grads(INSHAPE, "cuda", moving, fixed,
                                                            FLOW_STD)
            finally:
                torch.backends.cudnn.deterministic = saved[0]
            model, terms = default_recipe(INSHAPE, FLOW_STD)
            trainer = Trainer(model, terms, lr=1e-4, device="cuda")
            zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
            trainer.train_step((moving, fixed), (fixed, zero))["loss"].item()  # warm-up
            torch.cuda.reset_peak_memory_stats()
            step_s = []
            for _ in range(2):
                t0 = time.perf_counter()
                trainer.train_step((moving, fixed), (fixed, zero))["loss"].item()
                step_s.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            results[remat] = (loss, grads)
            log(f"phase 4 step, integration remat={remat}: " + ", ".join(
                f"{x:.4f}" for x in step_s) + f" s/step, peak memory allocated {peak:.3f} GiB, "
                f"launches {step_launches}; {smi}")
            del trainer, model
    same = results[True][0] == results[False][0] and all(
        torch.equal(results[True][1][n], g) for n, g in results[False][1].items())
    log(f"remat against stored integration: loss and {len(results[True][1])} gradients "
        f"bit-equal {same}")
    if not same:
        raise AssertionError("the rematerialised integration changed the gradients")
    return launches


def nd_and_res_check(smi):
    """Phase 6c: a 2-D VxmDense on the pair's middle slice, card against
    CPU, and a 3-D do_res VxmDense with a tanh final activation through the
    conv kernel against cuDNN mode. Returns the launches of a 2-D step and
    of a do_res register call with the conv kernel."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    moving, fixed = smooth_pair(INSHAPE, "cpu")
    mid = INSHAPE[0] // 2
    pair2 = (moving[:, mid].contiguous(), fixed[:, mid].contiguous())
    shape2 = INSHAPE[1:]

    def recipe2(inshape, flow_std=None):
        model = VxmDense(inshape, int_steps=7, int_resolution=2,
                         generator=torch.Generator().manual_seed(SEED))
        if flow_std is not None:
            with torch.no_grad():
                model.flow.weight.normal_(0.0, 3 ** 0.5 * flow_std,
                                          generator=torch.Generator().manual_seed(SEED + 1))
        terms = [LossTerm("y_source", losses.MSE(1.0).loss, weight=1.0, target_index=0),
                 LossTerm("reg", losses.Grad("l2", loss_mult=2).loss, weight=0.01,
                          target_index=1, name="grad")]
        return model, terms

    zero2 = torch.zeros((1, *shape2, 2))
    batch2 = ((pair2[0], pair2[1]), (pair2[1], zero2))
    loss_c, grads_c, launches2 = recipe_step_grads(recipe2, shape2, "cuda", batch2, FLOW_STD)
    loss_cpu, grads_cpu, _ = recipe_step_grads(recipe2, shape2, "cpu", batch2, FLOW_STD)
    log(f"2-D VxmDense {shape2}: one step's launches {launches2}")
    compare_grads(f"2-D GPU vs CPU, {shape2}", loss_c, grads_c, loss_cpu, grads_cpu,
                  TRAIN_GPU_VS_CPU_RTOL)
    if any(launches2.values()):
        raise AssertionError(f"the 2-D step launched a kernel: {launches2}")
    out = {}
    for device in ("cuda", "cpu"):
        model, terms = recipe2(shape2, FLOW_STD)
        trainer = Trainer(model, terms, lr=1e-4, device=device)
        inputs = tuple(a.to(device) for a in batch2[0])
        targets = tuple(a.to(device) for a in batch2[1])
        t0 = time.perf_counter()
        step_losses = [trainer.train_step(inputs, targets)["loss"].item() for _ in range(3)]
        step_s = time.perf_counter() - t0
        reset_launches()
        moved, warp = build_register_fn(trainer.model.eval())(*inputs)
        out[device] = (step_losses, moved.cpu(), warp.cpu(), read_launches())
        log(f"2-D VxmDense on {device}: 3 steps {step_s:.3f} s, losses " + ", ".join(
            f"{x:.8f}" for x in step_losses) + f"; register call launches {out[device][3]}")
    losses_c, losses_cpu = out["cuda"][0], out["cpu"][0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses_c, losses_cpu))
    flow_err, _ = max_and_mean_abs(out["cuda"][2], out["cpu"][2])
    image_err, _ = max_and_mean_abs(out["cuda"][1], out["cpu"][1])
    log(f"2-D after 3 steps, GPU vs CPU: losses rel {rel:.3e} (tol {TRAIN_GPU_VS_CPU_RTOL}), "
        f"pos_flow max abs err {flow_err:.3e} (tol {FLOW_TOL}), y_source {image_err:.3e} "
        f"(tol {IMAGE_TOL}); max|warp| {out['cuda'][2].abs().max().item():.3f}")
    if not (losses_c[-1] < losses_c[0] and rel <= TRAIN_GPU_VS_CPU_RTOL
            and flow_err <= FLOW_TOL and image_err <= IMAGE_TOL):
        raise AssertionError("the 2-D model disagrees on the card or did not learn")
    if any(out["cuda"][3].values()):
        raise AssertionError(f"the 2-D register call launched a kernel: {out['cuda'][3]}")

    # a do_res model with a tanh final activation at full width: every block
    # adds its residual, so the conv kernel runs with the activation off
    moving, fixed = moving.cuda(), fixed.cuda()
    act_off = []  # per conv kernel launch: whether its activation was off
    original = conv3._conv3_cuda

    def spy(x, kernel, bias, act_slope, *args):
        act_off.append(act_slope is None)
        return original(x, kernel, bias, act_slope, *args)

    results, res_launches = {}, None
    for dtype in (torch.bfloat16, torch.float32):
        for enabled in (True, False):
            with conv_kernel_mode(enabled), full_float32():
                model = VxmDense(INSHAPE, do_res=True, final_activation_function="tanh",
                                 dtype=dtype, generator=torch.Generator().manual_seed(SEED))
                with torch.no_grad():
                    model.flow.weight.normal_(0.0, FLOW_STD,
                                              generator=torch.Generator().manual_seed(SEED + 1))
                register = build_register_fn(model.cuda().eval())
                act_off.clear()
                reset_launches()
                conv3._conv3_cuda = spy
                try:
                    t0 = time.perf_counter()
                    results[dtype, enabled] = register(moving, fixed)
                    torch.cuda.synchronize()
                    first_s = time.perf_counter() - t0
                finally:
                    conv3._conv3_cuda = original
                launches = read_launches()
                log(f"do_res + tanh VxmDense, {str(dtype).split('.')[1]}, "
                    f"{'conv kernel' if enabled else 'cuDNN'}: {first_s:.3f} s, launches "
                    f"{launches}, conv launches with the activation off {sum(act_off)} of "
                    f"{len(act_off)}")
                expected = len(UNET_CONVS) if enabled else 0
                if launches["conv"] != expected or sum(act_off) != expected:
                    raise AssertionError(f"expected {expected} conv launches, all with the "
                                         f"activation off: {launches}, {act_off}")
                if dtype == torch.bfloat16 and enabled:
                    res_launches = launches
                del model, register
    # phase 3b's limits: float32, kernel against cuDNN; bfloat16, those of
    # bfloat16 against float32, since in bfloat16 the two modes round in
    # other places (the kernel once after the bias where the JAX package's
    # kernel takes a shape, cuDNN mode after the conv and again after the
    # bias, as XLA's conv does)
    for dtype, flow_tol, image_tol in ((torch.float32, FLOW_TOL, IMAGE_TOL),
                                       (torch.bfloat16, BF16_VS_F32_FLOW_TOL,
                                        BF16_VS_F32_IMAGE_TOL)):
        (moved_k, warp_k), (moved_c, warp_c) = results[dtype, True], results[dtype, False]
        flow_err, _ = max_and_mean_abs(warp_k, warp_c)
        image_err, _ = max_and_mean_abs(moved_k, moved_c)
        log(f"do_res + tanh, {str(dtype).split('.')[1]}, conv kernel vs cuDNN: pos_flow max abs "
            f"err {flow_err:.3e} (tol {flow_tol}), y_source {image_err:.3e} (tol {image_tol}); "
            f"max|warp| {warp_c.abs().max().item():.3f} voxels")
        if not (flow_err <= flow_tol and image_err <= image_tol
                and torch.isfinite(warp_k).all() and torch.isfinite(moved_k).all()):
            raise AssertionError("the do_res model's conv-kernel run disagrees with cuDNN mode")
    return launches2, res_launches



def tier_case(rng, spatial, nch, tier):
    """A volume and a random shift (batch 1) whose max|d| puts the warp on
    ``tier`` of the tiers {1, TIER_HALO}: bound 1, TIER_HALO or
    TIER_HALO + 2, with bands pushed across every edge (warp_case); on the
    gather tier also slabs of coordinates exactly on 0 and dim - 1."""
    vol, shift = warp_case(rng, 1, spatial, nch, {0: 1, 1: TIER_HALO, 2: TIER_HALO + 2}[tier])
    if tier == 2:
        for axis, dim in enumerate(spatial):
            idx = [slice(None)] * 5
            idx[1 + axis], idx[4] = 4, axis
            shift[tuple(idx)] = -4.0
            idx[1 + axis] = 1
            shift[tuple(idx)] = float(dim - 2)
    return vol, shift


def host_chosen_warp(vol, shift):
    """The warp as the port chose its tier before: max|d| read on the host,
    then the one branch (the bounded kernel or the torch gather)."""
    max_d = shift.abs().max().item()
    for h in (1, TIER_HALO):
        if max_d <= h:
            return warp_bounded(vol, shift, h)
    return warp_gather_plain(vol, shift)


def wall_ms(fn, reps=20):
    """Host wall-clock ms per call of ``fn`` over ``reps`` calls, from a
    synchronised card to a synchronised card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def check_tiered_warp(rng, gather_builds, counting):
    """Phase 2e: the predicated warp at each tier of {1, TIER_HALO} at the
    squaring shape, 1 to 4 channels (the gather's dshift adds the channels
    in the order of the card's torch reduction, which differs by channel
    count: csrc/warp_gather.cu channel_sum). Each branch's kernel writes its own
    NaN-filled buffer with the device's tier word: the branches not named
    must leave theirs untouched, the named one must equal the unpredicated
    kernel (bounded) or the torch gather (gather forward and dshift bit for
    bit, dvol within GATHER_DVOL_RTOL). Then the whole tiered warp
    (transform_batched, forward and backward) against the host-chosen path,
    its work counters, its time against the host-chosen call's, and the
    time of a launch that returns at once. Returns the gather kernel's rows
    for the kernels line."""
    spatial = WARP_CASES[0][1]
    halos = (1, TIER_HALO)
    skipped = {}
    for nch in (1, 2, 3, 4):
        for tier in (0, 1, 2):
            vol, shift = tier_case(rng, spatial, nch, tier)
            g = torch.from_numpy(rng.standard_normal(vol.shape, dtype=np.float32)).cuda()
            word = warp_ops.tier_index(shift, halos)
            # (a) every branch into its own buffer
            outs, grads = [], []
            for serve in range(3):
                out = torch.full_like(vol, float("nan"))
                # the gather adds into its dvol: zeroed where it is named
                dvol = torch.full_like(vol, 0.0 if serve == 2 == tier else float("nan"))
                dshift = torch.full_like(shift, float("nan"))
                if serve < 2:
                    warp_bounded_ops.launch_bounded_fwd(vol, shift, out, halos[serve], word, serve)
                    warp_bounded_ops.launch_bounded_bwd(vol, shift, g, dvol, dshift, halos[serve],
                                                        word, serve)
                else:
                    launch_gather_fwd(vol, shift, out, word, serve)
                    launch_gather_bwd(vol, shift, g, dvol, dshift, word, serve)
                outs.append(out)
                grads.append((dvol, dshift))
            torch.cuda.synchronize()
            for serve in range(3):
                if serve != tier and not (torch.isnan(outs[serve]).all() and all(
                        torch.isnan(x).all() for x in grads[serve])):
                    raise AssertionError(f"branch {serve} wrote at tier {tier}, C = {nch}")
            out, (dvol, dshift) = outs[tier], grads[tier]
            if tier < 2:
                ref = warp_bounded(vol, shift, halos[tier])
                ref_vol, ref_shift = warp_bounded_bwd(vol, shift, g, halos[tier])
                plain_err = (out - windowed_transform(vol, shift, halos[tier])).abs().max().item()
                equal = torch.equal(out, ref) and torch.equal(dvol, ref_vol) and \
                    torch.equal(dshift, ref_shift)
                dvol_rel = 0.0
            else:
                ref = warp_gather_plain(vol, shift)
                ref_vol, ref_shift = warp_gather_bwd_plain(vol, shift, g)
                plain_err = (out - ref).abs().max().item()
                equal = torch.equal(out, ref) and torch.equal(dshift, ref_shift)
                dvol_rel = ((dvol - ref_vol).abs().max() / ref_vol.abs().max()).item()
            log(f"tier {tier}, C = {nch}: max|d| {shift.abs().max().item():.3f}; the named "
                f"branch equals its reference {equal} (forward vs plain {plain_err:.3e}"
                f"{'' if tier < 2 else f', dvol rel {dvol_rel:.3e} (tol {GATHER_DVOL_RTOL})'}); "
                f"the others wrote nothing")
            if not equal or dvol_rel > GATHER_DVOL_RTOL or plain_err > KERNEL_TOL:
                raise AssertionError(f"the tier-{tier} branch differs from its reference")

            # (b) the whole tiered warp, forward and backward, and its counters
            v, s = vol.clone().requires_grad_(), shift.clone().requires_grad_()
            reset_launches()
            with window_halo(str(TIER_HALO)):
                got = warp_ops.transform_batched(v, s)
                got_vol, got_shift = torch.autograd.grad(got, (v, s), g)
            torch.cuda.synchronize()
            counts = read_launches()
            ran = (counts["fwd_ran"], counts["gather_fwd_ran"], counts["bwd_ran"],
                   counts["gather_bwd_ran"])
            want = (int(tier < 2), int(tier == 2), int(tier < 2), int(tier == 2))
            ok = torch.equal(got, out) and torch.equal(got_shift, dshift) and (
                torch.equal(got_vol, dvol) if tier < 2 else
                ((got_vol - ref_vol).abs().max() / ref_vol.abs().max()).item()
                <= GATHER_DVOL_RTOL)
            log(f"tier {tier}, C = {nch}: transform_batched (predicated) forward and backward "
                f"equal the branch {ok}; launches {counts['fwd']} + {counts['gather_fwd']} "
                f"forward, {counts['bwd']} + {counts['gather_bwd']} backward; ran "
                f"(bounded fwd, gather fwd, bounded bwd, gather bwd) {ran}")
            if not ok or ran != want:
                raise AssertionError(f"the tiered warp at tier {tier} took another branch")
            # the same where the volume needs no gradient (the image warp of
            # a train step): the gather's backward then takes no dvol
            s = shift.clone().requires_grad_()
            with window_halo(str(TIER_HALO)):
                (alone,) = torch.autograd.grad(warp_ops.transform_batched(vol, s), (s,), g)
            torch.cuda.synchronize()
            log(f"tier {tier}, C = {nch}: the shift's gradient with no volume gradient equals "
                f"it with one {torch.equal(alone, got_shift)}")
            if not torch.equal(alone, got_shift):
                raise AssertionError(f"the tiered warp at tier {tier}: the shift's gradient "
                                     f"differs where the volume needs no gradient")

            # (c) the predicated call against the host-chosen one, and the
            # device time of each launch that returns at once
            if nch not in (1, 3):  # the channel counts of the main paths
                continue
            with window_halo(str(TIER_HALO)):
                times = dict(predicated=wall_ms(lambda: warp_ops.transform_batched(vol, shift)),
                             host_chosen=wall_ms(lambda: host_chosen_warp(vol, shift)))
            log(f"tier {tier}, C = {nch}: forward warp {times['predicated']:.4f} ms predicated "
                f"(3 launches, no host sync), {times['host_chosen']:.4f} ms host-chosen (a host "
                f"read of max|d|, 1 launch); host wall clock, 20 calls")
            if nch == 3 and tier == 0:
                other = torch.empty_like(vol)
                # dvol_zero: the fill of the zeroed dvol that the tiered
                # warp's backward hands its branches (the gather adds into it)
                skipped = time_in_turns(dict(
                    bounded_fwd=lambda: warp_bounded_ops.launch_bounded_fwd(
                        vol, shift, other, TIER_HALO, word, 1),
                    bounded_bwd=lambda: warp_bounded_ops.launch_bounded_bwd(
                        vol, shift, g, other, torch.empty_like(shift), TIER_HALO, word, 1),
                    gather_fwd=lambda: launch_gather_fwd(vol, shift, other, word, 2),
                    gather_bwd=lambda: launch_gather_bwd(vol, shift, g, other,
                                                         torch.empty_like(shift), word, 2),
                    dvol_zero=lambda: other.zero_(),
                    **{f"{label} {d}": fn for label, lib in gather_builds.items()
                       for d, fn in (
                           ("fwd", lambda lib=lib: gather_compare_launch(
                               lib, "vxm_warp_gather_fwd", (vol, shift, other), word, 2)),
                           ("bwd", lambda lib=lib: gather_compare_launch(
                               lib, "vxm_warp_gather_bwd",
                               (vol, shift, g, other, torch.empty_like(shift)), word, 2)))}))
                log(f"device ms of a launch that returns at once, {spatial}, C = 3: "
                    + json.dumps(skipped))
            del vol, shift, g, outs, grads, v, s, got, got_vol, got_shift, ref, ref_vol, ref_shift
            del alone

    # (d) the phase warp (--fast-warp's lax.cond) forward and backward at
    # each branch against the host-chosen composition
    check_phase_warp(rng, spatial)

    # (e) the gather kernels at the squaring shape on a smooth field of up to
    # TIER_HALO + 2 voxels (a late squaring's), and on a rough field of up
    # to 12 voxels, whose lanes share few corners (few merged adds)
    nch = WARP_CASES[0][2]
    vol = torch.from_numpy(rng.standard_normal((1, *spatial, nch), dtype=np.float32)).cuda()
    shift = smooth_field(rng, spatial, (5, 6, 7), 1.0, "cuda")[None]
    shift = (shift * ((TIER_HALO + 2) / shift.abs().max())).contiguous()
    g = torch.from_numpy(rng.standard_normal(vol.shape, dtype=np.float32)).cuda()
    fwd_row, bwd_row = gather_case("squaring shape, smooth", vol, shift, g, gather_builds,
                                   counting)
    rough = torch.from_numpy(rng.uniform(-12, 12, size=shift.shape).astype(np.float32)).cuda()
    rough_rows = gather_case("squaring shape, rough", vol, rough, g, gather_builds, counting)
    fwd_row["rough"], bwd_row["rough"] = ({k: r[k] for k in (
        "ms", "kernel_ms", "library_ms", "bound_share", "adds", "merged", "max_abs_err")
        if k in r}
        for r in rough_rows)
    return fwd_row, bwd_row, skipped


def gather_serving_shape(rng, warp, builds, counting):
    """The gather kernels at the serving warp's shape (1, 160, 192, 224, 1):
    on a smooth field scaled to the max|d| of the register call's final
    warp (``warp``, phase 3's flow), and on that flow itself. Returns
    {"smooth": (forward row, backward row), "flow": (...)}."""
    max_d = warp.abs().max().item()
    log(f"the register call's final warp (phase 3): max|d| {max_d:.4f} voxels")
    vol = torch.from_numpy(rng.standard_normal((1, *INSHAPE, 1), dtype=np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal(vol.shape, dtype=np.float32)).cuda()
    shift = smooth_field(rng, INSHAPE, (5, 6, 7), 1.0, "cuda")[None]
    shift = (shift * (max_d / shift.abs().max())).contiguous()
    return {"smooth": gather_case(f"serving shape, smooth, max|d| {max_d:.4f}", vol, shift, g,
                                  builds, counting),
            "flow": gather_case("serving shape, phase 3's flow", vol,
                                warp.float().clone(memory_format=torch.contiguous_format), g,
                                builds, counting)}


def gather_summary(row):
    """The numbers of a gather_case row that the kernels line carries."""
    return {k: row[k] for k in ("shape", "max_abs_shift", "ms", "kernel_ms", "ms_no_dvol",
                                "plain_ms", "library_ms", "bound_ms", "bound_share", "adds",
                                "merged") if k in row}


def gather_compare_launch(lib, name, tensors, tier=None, serve=0):
    """Launch the entry point ``name`` of another build of
    csrc/warp_gather.cu on the current stream, as ops/warp_gather.py
    launches the package's own, counting nothing."""
    fn = getattr(lib, name)
    fn.argtypes = warp_gather_ops._ARGTYPES[name]
    fn.restype = ctypes.c_int
    B, D, H, W, C = tensors[0].shape
    err = fn(*(t.data_ptr() for t in tensors), B, D, H, W, C,
             int(warp_gather_ops.is_wide((D, H, W), C)),
             None if tier is None else tier.data_ptr(), serve, None,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} of another build failed to launch: CUDA error {err}")


def gather_case(label, vol, shift, g, builds, counting):
    """The gather kernels on one input: forward and dshift bit-equal to the
    torch gather (warp_gather_plain and its autograd VJP) and dvol within
    GATHER_DVOL_RTOL of its largest magnitude, for the package's build and
    each other build of ``builds`` ({label: library}); the backward's
    atomic adds and merged terms (from ``counting``, the package's source
    built with VXM_GATHER_COUNT: the 8 corner terms of every output added
    once); then times in turns: the forward kernel; the backward into a
    zeroed dvol (ms: the fill of the dvol that the kernel adds into, then
    the kernel, as the tiered warp's backward runs them; kernel_ms: the
    kernel alone) and with no dvol (ms_no_dvol: the image warp of a train
    step); grid_sample and its backward; and the other builds, each
    backward into a zeroed dvol too (the fill timed with it unless the
    build zeroes dvol itself, as an earlier one did). Returns the
    forward's and the backward's rows."""
    nch = vol.shape[-1]
    spatial = tuple(vol.shape[1:-1])
    shift = shift.contiguous()
    out, dshift = torch.empty_like(vol), torch.empty_like(shift)
    dvol = torch.zeros_like(vol)
    launch_gather_fwd(vol, shift, out)
    launch_gather_bwd(vol, shift, g, dvol, dshift)
    counts = torch.zeros(3, dtype=torch.int32, device="cuda")
    fn = counting.vxm_warp_gather_bwd
    fn.argtypes = warp_gather_ops._ARGTYPES["vxm_warp_gather_bwd"]
    B, D, H, W, _ = vol.shape
    if fn(vol.data_ptr(), shift.data_ptr(), g.data_ptr(), torch.zeros_like(vol).data_ptr(),
          torch.empty_like(shift).data_ptr(), B, D, H, W, nch,
          int(warp_gather_ops.is_wide((D, H, W), nch)), None, 0, counts.data_ptr(),
          torch.cuda.current_stream().cuda_stream) != 0:
        raise RuntimeError("the counting build of the gather backward failed to launch")
    adds, merged = counts[1:].tolist()
    ref = warp_gather_plain(vol, shift)
    ref_vol, ref_shift = warp_gather_bwd_plain(vol, shift, g)
    torch.cuda.synchronize()

    def errors(out, dvol, dshift):
        return dict(
            max_abs_err=(out - ref).abs().max().item(),
            bit_equal=torch.equal(out, ref), dshift_bit_equal=torch.equal(dshift, ref_shift),
            dshift_max_abs_err=(dshift - ref_shift).abs().max().item(),
            dvol_rel=((dvol - ref_vol).abs().max() / ref_vol.abs().max()).item())

    own = errors(out, dvol, dshift)
    others, zeroes = {}, {}
    for name, lib in builds.items():
        o, dv, ds = torch.empty_like(vol), torch.full_like(vol, float("nan")), \
            torch.empty_like(shift)
        gather_compare_launch(lib, "vxm_warp_gather_fwd", (vol, shift, o))
        gather_compare_launch(lib, "vxm_warp_gather_bwd", (vol, shift, g, dv, ds))
        # a build that adds into dvol leaves the NaN; one that zeroes it
        # first leaves none
        zeroes[name] = not dv.isnan().any().item()
        if not zeroes[name]:
            dv.zero_()
            gather_compare_launch(lib, "vxm_warp_gather_bwd", (vol, shift, g, dv, ds))
        torch.cuda.synchronize()
        others[name] = dict(errors(o, dv, ds), zeroes_dvol=zeroes[name])
    coords = ndgrid(spatial, device="cuda") + shift
    dims = torch.tensor([s - 1 for s in spatial], device="cuda", dtype=torch.float32)
    grid = (2.0 * coords / dims - 1.0).flip(-1).contiguous().requires_grad_()
    vol_cf = vol.movedim(-1, 1).contiguous().requires_grad_()
    out_cf = grid_sample_warp(vol_cf, grid)
    g_cf = g.movedim(-1, 1).contiguous()
    vox = vol.shape[0] * int(np.prod(spatial))
    fwd_bytes, bwd_bytes = (2 * nch + 3) * 4 * vox, (3 * nch + 6) * 4 * vox
    fwd_row = dict(shape=list(vol.shape), max_abs_err=own["max_abs_err"],
                   bit_equal=own["bit_equal"], max_abs_shift=shift.abs().max().item(),
                   plain_ms=time_cuda_ms(lambda: warp_gather_plain(vol, shift), reps=5, warmup=1),
                   bound_ms=fwd_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    bwd_row = dict(shape=list(vol.shape), max_abs_err=max(own["dshift_max_abs_err"],
                                                          (dvol - ref_vol).abs().max().item()),
                   dshift_bit_equal=own["dshift_bit_equal"], dvol_rel=own["dvol_rel"],
                   adds=adds, merged=merged,
                   plain_ms=time_cuda_ms(lambda: warp_gather_bwd_plain(vol, shift, g), reps=5,
                                         warmup=1),
                   bound_ms=bwd_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    scratch = torch.zeros_like(vol)  # the timed backward adds into it
    fwd_fns = dict(ms=lambda: launch_gather_fwd(vol, shift, out),
                   library_ms=lambda: grid_sample_warp(vol_cf, grid))
    bwd_fns = dict(ms=lambda: (scratch.zero_(),
                               launch_gather_bwd(vol, shift, g, scratch, dshift)),
                   kernel_ms=lambda: launch_gather_bwd(vol, shift, g, scratch, dshift),
                   ms_no_dvol=lambda: launch_gather_bwd(vol, shift, g, None, dshift),
                   library_ms=lambda: torch.autograd.grad(out_cf, (vol_cf, grid), g_cf,
                                                          retain_graph=True))
    for name, lib in builds.items():
        fwd_fns[name] = lambda lib=lib: gather_compare_launch(
            lib, "vxm_warp_gather_fwd", (vol, shift, out))
        bwd_fns[name] = lambda lib=lib, zeroes=zeroes[name]: (
            None if zeroes else scratch.zero_(),
            gather_compare_launch(lib, "vxm_warp_gather_bwd", (vol, shift, g, scratch, dshift)))
    for row, fns in ((fwd_row, fwd_fns), (bwd_row, bwd_fns)):
        times = time_in_turns(fns)
        row.update({k: times[k] for k in fns if k not in builds})
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if builds:
            row["compare"] = {k: dict(ms=times[k], **others[k]) for k in builds}
    log(f"gather forward, {label}: " + json.dumps(fwd_row))
    log(f"gather backward, {label} (ms: the fill of the zeroed dvol and the kernel; "
        f"kernel_ms: the kernel alone): " + json.dumps(bwd_row))
    for name, e in {"package": own, **others}.items():
        if not (e["bit_equal"] and e["dshift_bit_equal"]) or not e["dvol_rel"] <= GATHER_DVOL_RTOL:
            raise AssertionError(f"the gather kernels ({name}) differ from the torch gather "
                                 f"on the {label} field: {e}")
    if adds + merged != 8 * vox:
        raise AssertionError(f"the gather backward added {adds} times and merged {merged} "
                             f"of the 8 corner terms of {vox} outputs")
    return fwd_row, bwd_row


def check_phase_warp(rng, spatial, n_apps=4, halo=TIER_HALO):
    """phase_warp_batched on the card (the branch chosen on the device)
    against the host-chosen branch (n_apps warp_bounded calls by root, or
    the torch gather by full_flow), forward and backward, where max|root|
    <= halo (the fast branch) and where it exceeds it (the slow one): the
    forward, dfull_flow and the fast branch's dvols and droot bit-equal,
    the slow branch's dvols within GATHER_DVOL_RTOL and its droot zero."""
    for branch, bound in ((0, halo), (1, halo + 1)):
        vols = torch.from_numpy(rng.standard_normal((1, *spatial, 1), dtype=np.float32)).cuda()
        root = warp_case(rng, 1, spatial, 3, bound)[1]
        full = smooth_field(rng, spatial, (5, 6, 7), 2.0 * n_apps, "cuda")[None].contiguous()
        g = torch.from_numpy(rng.standard_normal(vols.shape, dtype=np.float32)).cuda()
        grads = {}
        for name in ("card", "host"):
            v, r, f = (t.clone().requires_grad_() for t in (vols, root, full))
            if name == "card":
                out = warp_ops.phase_warp_batched(v, r, f, n_apps, halo)
            elif branch == 0:
                out = v
                for _ in range(n_apps):
                    out = warp_bounded(out, r, halo)
            else:
                out = warp_gather_plain(v, f)
            grads[name] = (out.detach(), *torch.autograd.grad(out, (v, r, f), g,
                                                              allow_unused=True))
        (out, dv, dr, df), (rout, rdv, rdr, rdf) = grads["card"], grads["host"]
        zero_if_none = (lambda x, like: torch.zeros_like(like) if x is None else x)
        rdr, rdf = zero_if_none(rdr, root), zero_if_none(rdf, full)
        dv_ok = torch.equal(dv, rdv) if branch == 0 else \
            ((dv - rdv).abs().max() / rdv.abs().max()).item() <= GATHER_DVOL_RTOL
        ok = torch.equal(out, rout) and dv_ok and torch.equal(dr, rdr) and torch.equal(df, rdf)
        log(f"phase warp, {'fast' if branch == 0 else 'slow'} branch (max|root| "
            f"{root.abs().max().item():.2f}, halo {halo}): forward and gradients equal the "
            f"host-chosen branch's {ok}")
        if not ok:
            raise AssertionError("the phase warp on the card differs from the host-chosen one")


def redraw_until_all_tiers(label, moving, fixed):
    """The default recipe with its flow head redrawn N(0, flow_std), from
    FLOW_STD and 4 times larger (up to 3 draws), until a register call
    takes the halo-1, the halo-TIER_HALO and the gather tier (under
    VXM_WINDOW_HALO=TIER_HALO). Returns (model on the card, terms,
    flow_std, the tiers of the call's warps)."""
    flow_std = FLOW_STD
    for _ in range(3):
        model, terms = default_recipe(INSHAPE, flow_std)
        model = model.to("cuda").eval()
        register = build_register_fn(model)
        tiers = tiers_taken(lambda: register(moving, fixed))
        log(f"{label}, flow head N(0, {flow_std}): tiers of the register call's warps {tiers}")
        if set(tiers) == {0, 1, 2}:
            return model, terms, flow_std, tiers
        flow_std *= 4
    raise AssertionError(f"{label}: no flow head drawn took every tier")


def tiers_taken(model_fn):
    """The tier each tiered warp of one call of ``model_fn`` took, read from
    the work counters: they are fetched around each of a warp's predicated
    forward launches (host reads: diagnostics only, outside the timed and
    sync-checked runs), and the warp's tier is the branch whose launch did
    work. Fails unless exactly one branch of each warp did, the one its
    tier index names."""
    taken, ran = [], []
    forward = warp_ops._TieredWarp.forward
    bounded, gather = warp_bounded_ops.launch_bounded_fwd, warp_ops.launch_gather_fwd

    def counted(launch, slot):
        def run(*args):  # the last argument is the branch the launch serves
            before = warp_bounded_ops.read_work()[slot]
            launch(*args)
            if warp_bounded_ops.read_work()[slot] != before:
                ran.append(args[-1])
        return run

    def tiered(ctx, vol, shift, halos):
        ran.clear()
        out = forward(ctx, vol, shift, halos)
        named = int(warp_ops.tier_index(shift, halos).item())
        if ran != [named]:
            raise AssertionError(f"a tiered warp ran the branches {ran}; its tier index "
                                 f"names {named}")
        taken.append(named)
        return out

    warp_ops._TieredWarp.forward = staticmethod(tiered)
    warp_bounded_ops.launch_bounded_fwd = counted(bounded, "warp_bounded_fwd")
    warp_ops.launch_gather_fwd = counted(gather, "warp_gather_fwd")
    try:
        model_fn()
    finally:
        warp_ops._TieredWarp.forward = staticmethod(forward)
        warp_bounded_ops.launch_bounded_fwd = bounded
        warp_ops.launch_gather_fwd = gather
    return taken


def sync_free_check(smi):
    """Phase 7: the full-width register call and one float32 train step of
    the default recipe, flow head redrawn so that every tier runs, in cuDNN
    and conv-kernel mode, each under torch.cuda.set_sync_debug_mode("error")
    after a warm-up: any host synchronisation inside raises. Also the time
    of each path."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
    results = {}
    with window_halo(str(TIER_HALO)):
        for enabled in (False, True):
            mode = "conv kernel" if enabled else "cuDNN"
            with conv_kernel_mode(enabled):
                model, terms, flow_std, tiers = redraw_until_all_tiers(
                    f"register call, {mode}", moving, fixed)
                register = build_register_fn(model)
                register(moving, fixed)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    moved, warp = register(moving, fixed)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                if not (torch.isfinite(moved).all() and torch.isfinite(warp).all()):
                    raise AssertionError(f"non-finite register output ({mode})")
                ms = wall_ms(lambda: register(moving, fixed), reps=5)

                trainer = Trainer(model.train(), terms, lr=1e-4, device="cuda")
                trainer.train_step((moving, fixed), (fixed, zero))["loss"].item()  # warm-up
                step_tiers = tiers_taken(lambda: trainer.train_step((moving, fixed),
                                                                    (fixed, zero)))
                torch.cuda.synchronize()
                reset_launches()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    metrics = trainer.train_step((moving, fixed), (fixed, zero))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                counts = read_launches()
                check_warp_work(counts, f"the sync-free train step, {mode}")
                loss = metrics["loss"].item()
                step_s = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    trainer.train_step((moving, fixed), (fixed, zero))["loss"].item()
                    step_s.append(time.perf_counter() - t0)
                log(f"{mode}, VXM_WINDOW_HALO={TIER_HALO}, flow head N(0, {flow_std}): register "
                    f"call and train step ran under set_sync_debug_mode('error') with no host "
                    f"sync; tiers of the register call's warps {tiers}, of a step's forward "
                    f"warps {step_tiers}; the step's launches {counts}; loss {loss:.8f}; "
                    f"register {ms:.2f} ms per pair (float32), step " + ", ".join(
                        f"{x:.4f}" for x in step_s) + f" s; {smi}")
                if not np.isfinite(loss) or sorted(set(tiers + step_tiers)) != [0, 1, 2]:
                    raise AssertionError(f"the sync-free runs ({mode}) did not take every tier")
                results[enabled] = dict(register_ms=ms, step_s=float(np.median(step_s)),
                                        tiers=sorted(set(tiers + step_tiers)), launches=counts)
                del trainer, model, register
    return results


def unet_remat_check(smi):
    """Phase 6e: the U-Net's per-block remat on and off in phase 4's step
    (flow head redrawn), cuDNN and conv-kernel mode: gradients bit-equal
    (cudnn.deterministic), peak memory and seconds per step."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
    out = {}
    for enabled in (False, True):
        mode = "conv kernel" if enabled else "cuDNN"
        runs = {}
        with conv_kernel_mode(enabled):
            for remat in (True, False):
                def recipe(inshape, flow_std, remat=remat):
                    model, terms = default_recipe(inshape, flow_std)
                    model.unet.remat = remat
                    return model, terms

                saved = torch.backends.cudnn.deterministic
                torch.backends.cudnn.deterministic = True
                try:
                    loss, grads, launches = recipe_step_grads(
                        recipe, INSHAPE, "cuda", ((moving, fixed), (fixed, zero)), FLOW_STD)
                finally:
                    torch.backends.cudnn.deterministic = saved
                model, terms = recipe(INSHAPE, FLOW_STD)
                trainer = Trainer(model, terms, lr=1e-4, device="cuda")
                trainer.train_step((moving, fixed), (fixed, zero))["loss"].item()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                step_s = []
                for _ in range(2):
                    t0 = time.perf_counter()
                    trainer.train_step((moving, fixed), (fixed, zero))["loss"].item()
                    step_s.append(time.perf_counter() - t0)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                runs[remat] = dict(loss=loss, grads=grads, peak=peak,
                                   s=float(np.median(step_s)), conv=launches["conv"])
                log(f"U-Net remat={remat}, {mode}: " + ", ".join(f"{x:.4f}" for x in step_s)
                    + f" s/step, peak memory allocated {peak:.3f} GiB, conv launches "
                    f"{launches['conv']}; {smi}")
                del trainer, model
        same = runs[True]["loss"] == runs[False]["loss"] and all(
            torch.equal(runs[True]["grads"][n], gr) for n, gr in runs[False]["grads"].items())
        log(f"U-Net remat against stored, {mode}: loss and {len(runs[True]['grads'])} "
            f"gradients bit-equal {same}")
        want = (TRAIN_STEP_CONVS, 2 * len(UNET_CONVS) - 1) if enabled else (0, 0)
        if not same or (runs[True]["conv"], runs[False]["conv"]) != want:
            raise AssertionError(f"the U-Net remat changed the gradients or the conv launches "
                                 f"({mode})")
        out[enabled] = {k: {r: runs[r][k] for r in (True, False)} for k in ("peak", "s")}
    return out


def draw_parts(tmp):
    """Seconds of each part of one point-cloud draw on the card, at full
    width: for each of POINT_LABELS_SAMPLED subject labels the components
    (largest island and hole fill), the blur, the threshold (the k-th
    largest blurred value) and the EDT; for
    the subject's and the atlas's SDT of each the x2 zoom and the point
    draws (as generators.surf_semisupervised computes them)."""
    from voxelmorph_tpu_torch.py import ndimage as ndi
    from voxelmorph_tpu_torch.py import utils as pu

    with np.load(f"{tmp}/subject.npz") as d:
        seg = torch.as_tensor(d["seg"], device="cuda")
    labels = np.unique(seg.cpu().numpy())[1:POINT_LABELS_SAMPLED + 1]
    parts = dict(components=0.0, blur=0.0, threshold=0.0, edt=0.0, zoom=0.0, points=0.0)
    rng = np.random.default_rng(SEED)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        parts[name] += time.perf_counter() - t0
        return result

    per = SURF_POINTS // (2 * POINT_LABELS_SAMPLED)
    for label in labels:
        mask = seg == int(label)
        island = timed("components", lambda: pu.extract_largest_vol(mask))
        filled = timed("components", lambda: ~pu.extract_largest_vol(~island))
        smooth = timed("blur", lambda: ndi.gaussian_filter(filled, 0.1))
        size = int(filled.sum().item())
        clean = timed("threshold", lambda: smooth > -torch.sort(-smooth.reshape(-1)).values[size])
        sdt = timed("edt", lambda: pu.signed_dist_trf(clean.to(torch.float64)))
        for _ in range(2):  # the subject's and the atlas's SDT of the label
            fine = timed("zoom", lambda: ndi.zoom(sdt, [2] * 3, order=1))
            timed("points", lambda: pu.edge_to_surface_pts(fine.abs() < 0.50001, per, rng=rng))
    return parts


def prefetch_check(smi):
    """Phase 6d: Trainer.fit with prefetch 2 and without (cuDNN mode, flow
    head redrawn), of the point-cloud recipe from its generator on the card
    (the producer on its own stream) and of cli/train's default fit from
    scan_to_scan over npz files (a draw is host work: two volumes read from
    disk). The batches are the same, so the parameters after the same steps
    must be bit-equal (cudnn.deterministic); seconds per step of each, and
    the parts of one point-cloud draw."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        pointcloud_files(tmp, INSHAPE, "cuda")
        return _prefetch_check(tmp, smi)


def fits_with_and_without_prefetch(label, make_generator, recipe, steps=4):
    """Trainer.fit of ``steps`` steps of ``recipe()`` (model, terms) from
    ``make_generator()``, inline and with prefetch 2, from the same weights
    (cudnn.deterministic). Each generator is drawn once on this thread
    before the fit, as the point-cloud CLI draws (the point-cloud atlas's
    SDTs are made then, on this thread's stream), then once for a warm-up
    step. Fails unless the parameters after both fits are bit-equal.
    Returns the seconds per step, {0: inline, 2: prefetch}."""
    runs = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for prefetch in (0, 2):
            gen = make_generator()
            next(gen)
            model, terms = recipe()
            trainer = Trainer(model, terms, lr=1e-4, device="cuda")
            trainer.train_step(*next(gen))["loss"].item()  # warm-up step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.fit(gen, epochs=1, steps_per_epoch=steps, log_fn=lambda _: None,
                                  prefetch_size=prefetch)
            torch.cuda.synchronize()
            runs[prefetch] = dict(s=(time.perf_counter() - t0) / steps, loss=metrics["loss"],
                                  params={n: p.detach().clone()
                                          for n, p in trainer.model.named_parameters()})
            del trainer, model, gen
    finally:
        torch.backends.cudnn.deterministic = saved
    equal = all(torch.equal(runs[0]["params"][n], p) for n, p in runs[2]["params"].items())
    log(f"{label} fit, {steps} steps, cuDNN: {runs[0]['s']:.4f} s/step inline, "
        f"{runs[2]['s']:.4f} s/step with prefetch 2; params bit-equal {equal}; losses "
        f"{runs[0]['loss']:.8f}, {runs[2]['loss']:.8f}")
    if not equal:
        raise AssertionError(f"prefetch changed the batches or their order ({label})")
    return {k: run["s"] for k, run in runs.items()}


def _prefetch_check(tmp, smi):
    point = fits_with_and_without_prefetch(
        "point-cloud (the generator on the card, its own stream)",
        lambda: pointcloud_generator(tmp, "cuda"), lambda: pointcloud_recipe(INSHAPE, FLOW_STD))
    # cli/train's default: scan_to_scan over four npz volumes (the pair and
    # its mirror images), the default recipe
    moving, fixed = smooth_pair(INSHAPE, "cpu")
    files = []
    for i, vol in enumerate((moving, fixed, moving.flip(1), fixed.flip(2))):
        files.append(f"{tmp}/scan{i}.npz")
        np.savez(files[-1], vol=vol[0, ..., 0].numpy())
    host = fits_with_and_without_prefetch(
        "cli/train default (scan_to_scan, volumes read from disk)",
        lambda: generators.scan_to_scan(files, rng=np.random.default_rng(SEED)),
        lambda: default_recipe(INSHAPE, FLOW_STD))
    parts = draw_parts(tmp)
    # how much of a draw is device work, which a second stream cannot hide
    # behind a step that keeps the card busy
    gen = pointcloud_generator(tmp, "cuda")
    next(gen)
    profile_device("one point-cloud draw at full width", lambda: next(gen), rows=8)
    del gen
    log("one point-cloud draw's parts on the card, s: " + json.dumps(parts) + f"; {smi}")
    return dict(inline_s=point[0], prefetch_s=point[2], host_inline_s=host[0],
                host_prefetch_s=host[2], parts=parts)


def conv_library_times(model):
    """cuDNN's time for each 3x3x3 conv of the U-Net (the convs the Pallas
    conv kernel computes) at full width in bfloat16, forward and backward,
    beside the bound of their FLOPs at the dense bf16 tensor-core rate."""
    shapes = []
    hooks = [m.register_forward_hook(lambda m, i, o: shapes.append(
        (m.conv.in_channels, m.conv.out_channels, tuple(i[0].shape))))
        for m in model.modules() if isinstance(m, ConvBlock)]
    with torch.no_grad():
        model.eval()
        moving, fixed = smooth_pair(INSHAPE, "cuda")
        model(moving, fixed)
    for h in hooks:
        h.remove()
    total = dict(flops=0, fwd_ms=0.0, bwd_ms=0.0)
    for ci, co, shape in shapes:
        x = torch.randn(shape, device="cuda", dtype=torch.bfloat16, requires_grad=True)
        w = torch.randn((co, ci, 3, 3, 3), device="cuda", dtype=torch.bfloat16,
                        requires_grad=True)
        out = F.conv3d(x, w, padding=1)
        g = torch.randn_like(out)
        flops = 2 * 27 * ci * co * int(np.prod(shape[2:]))
        fwd = time_cuda_ms(lambda: F.conv3d(x, w, padding=1))
        bwd = time_cuda_ms(lambda: torch.autograd.grad(out, (x, w), g, retain_graph=True))
        log(f"conv {ci}->{co} at {shape[2:]}: cuDNN bf16 fwd {fwd:.4f} ms, bwd {bwd:.4f} ms; "
            f"bound {flops / BF16_TENSOR_FLOPS_PER_S * 1e3:.4f} ms fwd, "
            f"{2 * flops / BF16_TENSOR_FLOPS_PER_S * 1e3:.4f} ms bwd")
        total["flops"] += flops
        total["fwd_ms"] += fwd
        total["bwd_ms"] += bwd
    log(f"U-Net convs ({len(shapes)}): cuDNN bf16 fwd {total['fwd_ms']:.4f} ms, "
        f"bwd {total['bwd_ms']:.4f} ms; {total['flops'] / 1e9:.3f} GFLOP fwd, bound "
        f"{total['flops'] / BF16_TENSOR_FLOPS_PER_S * 1e3:.4f} ms fwd, "
        f"{2 * total['flops'] / BF16_TENSOR_FLOPS_PER_S * 1e3:.4f} ms bwd")


# the template-creation recipe of scripts/train_template.py (NCC, weights
# 1/1/1: the scan->atlas image term weighs 1 - 1 = 0); steps of phase 8's
# loss gate; the flow head's redraw that sends the full-resolution image
# warps to the gather tier (max|d| over the halo)
TEMPLATE_STEPS = 10
TEMPLATE_GATHER_STD = 0.2
ATLAS_DVOL = "atlas: the step's warp dvol"
# the atlas's whole gradient, card against CPU at half width, as
# ||card - CPU|| / ||CPU|| (L2 over the volume). Its part through the
# U-Net's input follows the warps' shift gradients, which jump where a
# coordinate crosses an integer, so single voxels move far on any change of
# rounding, and its max-abs difference is no measure. Measured on an H100:
# 1.95e-3 card vs CPU (2.8e-2 of its max); on the CPU alone, the scan scaled
# by 1 + 1e-7 noise moves it by 0.10 (--conditioning). The limit is
# ten times the first and a fifth of the second.
ATLAS_GRAD_GPU_VS_CPU_L2 = 2e-2
# the conditional template of scripts/train_cond_template.py: a 4-value
# phenotype, conv_nb_features 4, extra_conv_layers 3
PHENO_FEATS = 4
COND_STEPS = 4
# atlas-based segmentation: a probabilistic atlas of 4 tissue classes (the
# background and 3 Voronoi regions of the head), a full atlas of 30 labels
# mapped onto them, 21 labels a chunk (the script's default)
PROB_CLASSES = 4
FULL_LABELS = 30
PROB_STEPS = 3
# the instance optimisation of scripts/train_instance.py, warm-started from
# the committed checkpoint. At the script's default learning rate (1e-3)
# Adam's first step moves every flow component by about mult x lr = 1 voxel
# and the loss rises before it falls (the timed run below logs its losses);
# at 1e-4 it falls from the first step. The gated run takes 1e-4.
INSTANCE_STEPS = 20
INSTANCE_LR = 1e-4


@contextlib.contextmanager
def record_dvol(kept=None):
    """Record each tiered warp's backward that computes the volume's
    gradient (dvol): the volume's shape, the tier word of its warp (0: the
    halo-1 bounded kernel, 1: the gather, at the default halo) and
    max|dvol|, as device tensors, read after the run (``read_dvol``); with
    a list ``kept``, each dvol itself too, copied. The warp's autograd
    Function is wrapped for the run, as phase 7 wraps its forward: the
    forward also computes the tier word (``tier_index``, as the warp does)
    and keeps it on the autograd context, since a backward under a
    checkpoint may read its saved tensors only once; nothing is
    synchronised, and nothing is launched in addition but that reduction,
    a copy and one reduction of dvol (and the copy of a kept one)."""
    forward, backward = warp_ops._TieredWarp.forward, warp_ops._TieredWarp.backward
    records = []

    def forward_recorded(ctx, vol, shift, halos):
        ctx.recorded_tier = warp_ops.tier_index(shift, halos)
        return forward(ctx, vol, shift, halos)

    def backward_recorded(ctx, g):
        grads = backward(ctx, g)
        if grads[0] is not None:
            records.append((tuple(grads[0].shape), ctx.recorded_tier.clone(),
                            grads[0].detach().abs().amax()))
            if kept is not None:
                kept.append(grads[0].detach().clone())
        return grads

    warp_ops._TieredWarp.forward = staticmethod(forward_recorded)
    warp_ops._TieredWarp.backward = staticmethod(backward_recorded)
    try:
        yield records
    finally:
        warp_ops._TieredWarp.forward = staticmethod(forward)
        warp_ops._TieredWarp.backward = staticmethod(backward)


@contextlib.contextmanager
def warp_vol_grads(kept):
    """Keep, in the list ``kept``, the gradient each ``transform_batched``
    passes to a volume that needs one: the warp's dvol on any device (the
    CPU's warps are no autograd Function of their own to wrap)."""
    transform_batched = warp_ops.transform_batched

    def recorded(vols, shifts, *args, **kwargs):
        if vols.requires_grad:
            vols = vols.view_as(vols)
            vols.register_hook(lambda g: kept.append(g.detach().clone()))
        return transform_batched(vols, shifts, *args, **kwargs)

    warp_ops.transform_batched = recorded
    try:
        yield kept
    finally:
        warp_ops.transform_batched = transform_batched


def read_dvol(records):
    """The records of ``record_dvol`` as (shape, tier, max|dvol|) on the
    host; clears them."""
    out = [(shape, int(tier.item()), float(top.item())) for shape, tier, top in records]
    records.clear()
    return out


def check_dvol(label, dvols, tier, spatial=INSHAPE):
    """Fail unless one tiered warp of the step at ``spatial`` computed a
    dvol (the atlas's warp; every squaring step computes one at half
    resolution), on ``tier``, non-zero and finite."""
    full = [d for d in dvols if d[0][1:4] == spatial]
    if len(full) != 1 or full[0][1] != tier or not (np.isfinite(full[0][2]) and full[0][2] > 0):
        raise AssertionError(f"{label}: expected one warp backward at {spatial} writing a "
                             f"non-zero dvol on tier {tier}; got {full}")
    return full[0]


def template_recipe(inshape, flow_std=None, atlas=None):
    """scripts/train_template.py's default (NCC) on a float32
    TemplateCreation with default features, initialised from seed 0;
    ``flow_std`` redraws the flow head as default_recipe does; ``atlas``
    seeds the atlas, as the script's --init-template does."""
    model = TemplateCreation(inshape, generator=torch.Generator().manual_seed(SEED))
    if flow_std is not None:
        with torch.no_grad():
            model.vxm.flow.weight.normal_(0.0, flow_std,
                                          generator=torch.Generator().manual_seed(SEED + 1))
    if atlas is not None:
        model.set_atlas(atlas)
    return model, template_terms("ncc")


def template_targets(scan):
    zero = torch.zeros((1, *scan.shape[1:-1], 3), device=scan.device)
    return (scan,), (scan, zero, zero, zero)


def template_step_grads(inshape, device, scan, flow_std, atlas):
    """Loss, parameter gradients and MeanStream's buffers after one train
    step of the template recipe (no update), with the dvol records on the
    card. The atlas's whole gradient is returned apart; its part through
    the full-resolution warp, the dvol that the step's own warp backward
    wrote (on the card the tiered warp's kernel's, kept by
    ``record_dvol``), goes in with the others as ATLAS_DVOL."""
    model, terms = template_recipe(inshape, flow_std, atlas)
    trainer = Trainer(model, terms, device=device)
    trainer.model.train()
    inputs, targets = template_targets(scan.to(device))
    kept, dvols = [], None
    with (record_dvol(kept) if device == "cuda" else warp_vol_grads(kept)) as records:
        with stream_step(trainer.model):
            loss, _ = trainer.loss_fn(inputs, targets)
            loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            dvols = read_dvol(records)
    full = [d for d in kept if tuple(d.shape[1:-1]) == tuple(inshape)]
    if len(full) != 1:
        raise AssertionError(f"expected one warp dvol at {inshape} on {device}, got {len(full)}")
    grads = {n: p.grad.detach().cpu() for n, p in trainer.model.named_parameters()}
    total = grads.pop("atlas")
    grads[ATLAS_DVOL] = full[0].cpu()
    for name, buf in trainer.model.named_buffers():
        grads[f"{name} (state after the step)"] = buf.detach().cpu().reshape(-1)
    return loss.item(), grads, dvols, total


def rel_l2(a, b):
    """||a - b|| / ||b||, in float64."""
    return (torch.linalg.vector_norm((a.double() - b.double()))
            / torch.linalg.vector_norm(b.double())).item()


def rel_max(a, b):
    """max|a - b| / max|b|."""
    return (a - b).abs().max().item() / b.abs().max().item()


def run_steps(trainer, inputs, targets, steps, label, smi, dvol_tier=None, gate_loss=True):
    """``steps`` train steps with the work counters read after each (and,
    with ``dvol_tier``, the step's full-resolution dvol backward checked);
    with ``gate_loss`` the last loss must be below the first. Returns the
    losses, the seconds of each step, the launches of the last, the peak
    memory in GiB and each step's full-resolution dvol record."""
    torch.cuda.reset_peak_memory_stats()
    losses_, step_s, counts, dvol_steps = [], [], None, []
    with record_dvol() as records:
        for step in range(steps):
            reset_launches()
            t0 = time.perf_counter()
            losses_.append(trainer.train_step(inputs, targets)["loss"].item())  # synchronises
            step_s.append(time.perf_counter() - t0)
            counts = read_launches()
            check_warp_work(counts, f"{label}, step {step}")
            dvols = read_dvol(records)
            if dvol_tier is not None:
                dvol_steps.append(check_dvol(f"{label}, step {step}", dvols, dvol_tier))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{label}: step losses " + ", ".join(f"{x:.8f}" for x in losses_))
    if dvol_steps:
        log(f"{label}: the full-resolution warp's dvol, max|dvol| of each step (tier "
            f"{dvol_tier}): " + ", ".join(f"{d[2]:.3e}" for d in dvol_steps))
    log(f"{label}, bs1, {INSHAPE}: " + ", ".join(f"{x:.4f}" for x in step_s) + " s/step "
        f"(median after the first {float(np.median(step_s[1:])):.4f}); peak memory allocated "
        f"{peak_gb:.3f} GiB; launches of the last step {counts}; {smi}")
    if not all(np.isfinite(losses_)) or (gate_loss and not losses_[-1] < losses_[0]):
        raise AssertionError(f"{label}: {steps} steps did not lower the loss: {losses_}")
    return losses_, step_s, counts, peak_gb, dvol_steps


def grads_finite_nonzero(label, tensors):
    for name, t in tensors.items():
        if t is None or not (torch.isfinite(t).all() and t.abs().max().item() > 0):
            raise AssertionError(f"{label}: the gradient of {name} is missing, zero or "
                                 "not finite")


def train_template(smi, conditioning=False):
    """Phase 8: template creation at full width. Returns the launches of a
    step in cuDNN mode, in conv-kernel mode and with the flow head redrawn
    (the atlas's dvol through the gather), and the card-vs-CPU readings;
    with ``conditioning``, also how far the CPU's own step moves when the
    scan is scaled by 1 + 1e-7 noise."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    scan, template = smooth_pair(INSHAPE, "cuda")
    inputs, targets = template_targets(scan)
    out = {}
    for enabled in (False, True):
        mode = "conv kernel" if enabled else "cuDNN"
        with conv_kernel_mode(enabled):
            # the atlas seeded with the pair's other image (--init-template):
            # from the N(0, 1e-7) init, NCC's cross term and variances stay
            # clamped at its eps (1e-5, as in JAX) on this smooth scan for
            # ten steps and more, which passes the warped atlas no gradient
            # (a dvol of exact zeros)
            model, terms = template_recipe(INSHAPE, atlas=template)
            trainer = Trainer(model, terms, lr=1e-4, device="cuda")
            # the seed-0 flows are ~1e-5 voxels: the atlas's full-resolution
            # warp takes the halo-1 bounded kernel, whose backward writes dvol
            _, step_s, counts, peak, _ = run_steps(
                trainer, inputs, targets, TEMPLATE_STEPS,
                f"float32 template creation, {mode}", smi, dvol_tier=0)
            grads_finite_nonzero(f"template creation, {mode}", {"atlas": model.atlas.grad})
            count = model.mean_stream.count.item()
            log(f"template creation, {mode}: MeanStream count {count} after {TEMPLATE_STEPS} "
                f"samples; max|atlas - its seed| "
                f"{(model.atlas.detach() - template).abs().max().item():.3e}")
            if count != min(TEMPLATE_STEPS, model.mean_stream.cap):
                raise AssertionError(f"MeanStream counted {count} samples of {TEMPLATE_STEPS}")
            # the atlas needs a gradient: the first conv's input gradient too
            if enabled and counts["conv"] != TRAIN_STEP_CONVS + 1:
                raise AssertionError(f"a template step launched {counts['conv']} convs, not "
                                     f"{TRAIN_STEP_CONVS + 1}")
            out[enabled] = dict(launches=counts, step_s=float(np.median(step_s[1:])),
                                peak_gib=peak)
            del trainer, model

    # the flow head redrawn: the image warps take the gather tier, and the
    # atlas's dvol comes from the gather backward's atomics at full width
    model, terms = template_recipe(INSHAPE, TEMPLATE_GATHER_STD, template)
    trainer = Trainer(model, terms, lr=1e-4, device="cuda")
    reset_launches()
    with record_dvol() as records:
        loss = trainer.train_step(inputs, targets)["loss"].item()
        dvols = read_dvol(records)
    counts = read_launches()
    check_warp_work(counts, "the redrawn template step")
    full = check_dvol("the redrawn template step", dvols, 1)
    log(f"template step, flow head N(0, {TEMPLATE_GATHER_STD}): loss {loss:.8f}; the atlas's "
        f"warp backward {full}; launches {counts}")
    grads_finite_nonzero("the redrawn template step", {"atlas": model.atlas.grad})
    out["gather"] = dict(launches=counts)
    del trainer, model

    # one step, the card against the port's CPU run at half width (full-width
    # features, flows of voxels; the CPU takes the bounded tiers too): the
    # loss, the parameters' gradients, MeanStream's buffers and the atlas's
    # dvol to compare_grads' tolerance, the atlas's whole gradient by its
    # norm (ATLAS_GRAD_GPU_VS_CPU_L2)
    half = tuple(s // 2 for s in INSHAPE)
    scan_h, template_h = smooth_pair(half, "cpu")
    t0 = time.perf_counter()
    loss_c, grads_c, dvol_c, total_c = template_step_grads(half, "cuda", scan_h,
                                                           TEMPLATE_GATHER_STD, template_h)
    with window_halo("1"):
        loss_cpu, grads_cpu, _, total_cpu = template_step_grads(half, "cpu", scan_h,
                                                                TEMPLATE_GATHER_STD, template_h)
    log(f"template step at {half} on the card and the CPU: {time.perf_counter() - t0:.2f} s; "
        f"dvol backwards at {half} on the card "
        f"{[d for d in dvol_c if d[0][1:4] == half]}")
    check_dvol("the half-width template step on the card", dvol_c, 1, half)
    label = f"template creation GPU vs CPU, flow head N(0, {TEMPLATE_GATHER_STD}), {half}"
    compare_grads(label, loss_c, grads_c, loss_cpu, grads_cpu, TRAIN_GPU_VS_CPU_RTOL)
    out["card_vs_cpu"] = dict(atlas_rel_l2=rel_l2(total_c, total_cpu),
                              atlas_rel_max=rel_max(total_c, total_cpu),
                              dvol_rel_max=rel_max(grads_c[ATLAS_DVOL], grads_cpu[ATLAS_DVOL]))
    log(f"{label}: {json.dumps(out['card_vs_cpu'])} (the atlas's whole gradient by its norm, "
        f"tol {ATLAS_GRAD_GPU_VS_CPU_L2})")
    if not out["card_vs_cpu"]["atlas_rel_l2"] <= ATLAS_GRAD_GPU_VS_CPU_L2:
        raise AssertionError(f"{label}: the atlas's gradient differs by "
                             f"{out['card_vs_cpu']['atlas_rel_l2']:.3e} of its norm")
    if conditioning:
        # the CPU's own sensitivity: the scan scaled by 1 + 1e-7 noise
        noise = torch.from_numpy(np.random.default_rng(SEED + 14).standard_normal(
            scan_h.shape, dtype=np.float32))
        with window_halo("1"):
            _, grads_p, _, total_p = template_step_grads(
                half, "cpu", scan_h * (1 + 1e-7 * noise), TEMPLATE_GATHER_STD, template_h)
        params = [k for k in grads_cpu if k != ATLAS_DVOL and "(state" not in k]
        out["conditioning"] = dict(
            atlas_rel_l2=rel_l2(total_p, total_cpu), atlas_rel_max=rel_max(total_p, total_cpu),
            dvol_rel_max=rel_max(grads_p[ATLAS_DVOL], grads_cpu[ATLAS_DVOL]),
            params_rel_max=max(rel_max(grads_p[k], grads_cpu[k]) for k in params))
        log(f"{label}: on the CPU, the scan scaled by 1 + 1e-7 noise moves "
            f"{json.dumps(out['conditioning'])}")
    return out


def cond_template_check(smi):
    """Phase 8b: the conditional template at full width, a few steps."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    scan = smooth_pair(INSHAPE, "cuda")[0]
    pheno = torch.from_numpy(np.random.default_rng(SEED + 11).standard_normal(
        (1, PHENO_FEATS), dtype=np.float32)).cuda()
    atlas = torch.zeros_like(scan)  # the CLI's default atlas
    zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
    model = ConditionalTemplateCreation(INSHAPE, (PHENO_FEATS,), conv_nb_features=4,
                                        extra_conv_layers=3,
                                        generator=torch.Generator().manual_seed(SEED))
    dense_bytes = model.pheno_dense.weight.numel() * 4
    trainer = Trainer(model, cond_template_terms("ncc"), lr=1e-4, device="cuda")
    _, step_s, counts, peak, _ = run_steps(trainer, (pheno, atlas, scan), (scan, zero, zero, zero),
                                        COND_STEPS, "float32 conditional template, cuDNN", smi,
                                        dvol_tier=0)
    grads_finite_nonzero("the conditional template", {
        "pheno_dense.weight": model.pheno_dense.weight.grad,
        "atlas_gen.weight": model.atlas_gen.weight.grad})
    log(f"conditional template: pheno_dense weight {tuple(model.pheno_dense.weight.shape)}, "
        f"{dense_bytes} B ({dense_bytes / 2 ** 30:.3f} GiB; with its gradient and Adam's "
        f"moments {4 * dense_bytes / 2 ** 30:.3f} GiB); peak {peak:.3f} GiB; {smi}")
    count = model.mean_stream.count.item()
    if count != COND_STEPS:
        raise AssertionError(f"MeanStream counted {count} samples of {COND_STEPS}")
    return dict(launches=counts, step_s=float(np.median(step_s[1:])), peak_gib=peak,
                dense_bytes=dense_bytes)


def prob_atlas(moving, nb_classes, seed):
    """A probabilistic atlas ``(1, *S, nb_classes)`` of ``moving``'s head:
    the background and nb_classes - 1 Voronoi regions, one-hot, blurred
    twice by a 5^3 box and normalised, made on moving's device."""
    labels = voronoi_labels(moving[0], nb_classes - 1, seed)
    onehot = F.one_hot(labels.long(), nb_classes).to(torch.float32)
    x = onehot.movedim(-1, 0)[None]
    for _ in range(2):
        x = F.avg_pool3d(x, 5, stride=1, padding=2, count_include_pad=False)
    x = x / x.sum(dim=1, keepdim=True)
    return x[0].movedim(0, -1)[None].contiguous()


def prob_recipe(inshape, flow_std=None):
    """scripts/train_unsupervised_seg.py's default (stat post warp, Grad-l2
    at 10) on a float32 ProbAtlasSegmentation of PROB_CLASSES classes,
    seed 0, the flow head redrawn as default_recipe does."""
    model = ProbAtlasSegmentation(inshape, nb_labels=PROB_CLASSES, stat_post_warp=True,
                                  generator=torch.Generator().manual_seed(SEED))
    if flow_std is not None:
        with torch.no_grad():
            model.vxm.flow.weight.normal_(0.0, flow_std,
                                          generator=torch.Generator().manual_seed(SEED + 1))
    return model, unsupervised_seg_terms(10.0)


def prob_atlas_check(smi):
    """Phase 9: atlas-based segmentation at full width."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    atlas = prob_atlas(moving, PROB_CLASSES, SEED + 12)
    zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
    image = fixed * (fixed > 0.2)  # a background the data term's mask leaves out
    out = {}
    for enabled in (False, True):
        mode = "conv kernel" if enabled else "cuDNN"
        with conv_kernel_mode(enabled):
            model, terms = prob_recipe(INSHAPE, FLOW_STD)
            trainer = Trainer(model, terms, lr=1e-4, device="cuda")
            _, step_s, counts, peak, _ = run_steps(
                trainer, (image, atlas), (atlas, zero), PROB_STEPS,
                f"float32 atlas-based segmentation, {mode}", smi)
            # the U-Net's 32 conv launches and the two stat ConvBlocks',
            # forward and input gradient
            expected = TRAIN_STEP_CONVS + 4 if enabled else 0
            if counts["conv"] != expected:
                raise AssertionError(f"a segmentation step launched {counts['conv']} convs, "
                                     f"not {expected}")
            out[enabled] = dict(launches=counts, step_s=float(np.median(step_s[1:])),
                                peak_gib=peak)
            del trainer, model

    # one step's loss and gradients, conv-kernel mode against cuDNN mode: the
    # stat ConvBlocks' input gradients (16 -> PROB_CLASSES + 1 and
    # PROB_CLASSES -> 16) reach stat_conv0's weights, the flow and the U-Net
    runs = {}
    for enabled in (True, False):
        with conv_kernel_mode(enabled):
            runs[enabled] = recipe_step_grads(prob_recipe, INSHAPE, "cuda",
                                              ((image, atlas), (atlas, zero)), FLOW_STD)
    if runs[True][2]["conv"] != TRAIN_STEP_CONVS + 4 or runs[False][2]["conv"] != 0:
        raise AssertionError(f"one segmentation step launched {runs[True][2]['conv']} convs "
                             f"in conv-kernel mode, {runs[False][2]['conv']} in cuDNN mode")
    out["conv_kernel_vs_cudnn"] = compare_grads(
        f"atlas-based segmentation, conv kernel vs cuDNN, flow head N(0, {FLOW_STD}), "
        f"{INSHAPE}", runs[True][0], runs[True][1], runs[False][0], runs[False][1],
        TRAIN_CONV_KERNEL_VS_CUDNN_RTOL)
    del runs
    # the stat ConvBlocks' four shapes against the kernel's plain version
    check_conv3(SEED + 15, [(*INSHAPE, PROB_CLASSES + 1, 16), (*INSHAPE, 16, PROB_CLASSES)],
                ("fwd", "dx"), "9 conv3 at the stat ConvBlocks,", (torch.float32,))

    # the stat ConvBlocks (ci = PROB_CLASSES + 1) through the conv kernel
    # against cuDNN, on the same input, float32
    model, _ = prob_recipe(INSHAPE, FLOW_STD)
    model = model.cuda().eval()
    captured = {}
    def capture(module, args):
        captured["x"] = args[0]

    model.stat_conv0.register_forward_pre_hook(capture)
    with torch.no_grad(), full_float32():
        model(image, atlas)
        feats = {}
        for enabled in (False, True):
            with conv_kernel_mode(enabled):
                reset_launches()
                h0 = model.stat_conv0(captured["x"])
                feats[enabled] = (h0, model.stat_conv1(h0))
                launches = read_launches()["conv"]
                if launches != (2 if enabled else 0):
                    raise AssertionError(f"the stat ConvBlocks launched {launches} convs")
    for i, name in enumerate(("stat_conv0", "stat_conv1")):
        a, b = feats[True][i].float(), feats[False][i].float()
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        log(f"{name} (ci {a.shape[1] if i else captured['x'].shape[1]}), conv kernel vs cuDNN, "
            f"float32: max abs err {err:.3e} of max {scale:.3e} (tol {IMAGE_TOL} x max)")
        if not (scale > 0 and err <= IMAGE_TOL * scale):
            raise AssertionError(f"{name}: the conv kernel disagrees with cuDNN")
    del model, captured, feats

    # cli/test_unsupervised_seg: a FULL_LABELS-label atlas mapped onto the
    # classes, at full width on the card, and card against CPU at half width
    with tempfile.TemporaryDirectory() as tmp:
        out["test_seg"] = {}
        for spatial in (INSHAPE, tuple(s // 2 for s in INSHAPE)):
            mv, fx = smooth_pair(spatial, "cpu")
            model, _ = prob_recipe(spatial, FLOW_STD)
            save_model(f"{tmp}/prob.npz", model)
            labels = voronoi_labels(mv[0].cuda(), FULL_LABELS - 1, SEED + 13)
            full = F.one_hot(labels.long(), FULL_LABELS).to(torch.float32).cpu()
            mapping = np.arange(FULL_LABELS) % PROB_CLASSES
            np.savez(f"{tmp}/atlas.npz",
                     vol=prob_atlas(mv.cuda(), PROB_CLASSES, SEED + 12)[0].cpu().numpy())
            np.savez(f"{tmp}/full.npz", vol=full.numpy())
            np.save(f"{tmp}/mapping.npy", mapping)
            np.savez(f"{tmp}/image.npz", vol=fx[0, ..., 0].numpy())
            segs = {}
            devices = ("cuda",) if spatial == INSHAPE else ("cuda", "cpu")
            for device in devices:
                args = [f"{tmp}/image.npz", f"{tmp}/seg_{device}.nii", "--model", f"{tmp}/prob.npz",
                        "--atlas", f"{tmp}/atlas.npz", "--atlas-full", f"{tmp}/full.npz",
                        "--mapping", f"{tmp}/mapping.npy", "--device", device]
                if device == "cpu":
                    args += ["--posteriors", f"{tmp}/post_cpu.nii"]
                t0 = time.perf_counter()
                reset_launches()
                if device == "cpu":
                    with window_halo("1"):
                        segs[device] = test_seg_cli.main(args)
                else:
                    segs[device] = test_seg_cli.main(args)
                    torch.cuda.synchronize()
                counts = read_launches()
                log(f"cli/test_unsupervised_seg at {spatial} on {device}, {FULL_LABELS} labels "
                    f"in chunks of 21: {time.perf_counter() - t0:.2f} s; classes found "
                    f"{np.unique(segs[device]).size}; launches {counts}")
                if device == "cuda":
                    check_warp_work(counts, "cli/test_unsupervised_seg", backward=False)
                    out["test_seg"][spatial] = counts
            if segs["cuda"].shape != spatial or np.unique(segs["cuda"]).size < FULL_LABELS // 2:
                raise AssertionError(f"cli/test_unsupervised_seg at {spatial}: a segmentation "
                                     f"of {np.unique(segs['cuda']).size} labels")
            if "cpu" in segs:
                # voxels whose two best posteriors tie (on the CPU, within
                # 1e-5 of the best) may take either label; no other may differ
                post = load_volfile(f"{tmp}/post_cpu.nii")
                top2 = np.sort(post, axis=-1)[..., -2:]
                tied = top2[..., 1] - top2[..., 0] <= 1e-5 * top2[..., 1]
                differ = segs["cuda"] != segs["cpu"]
                log(f"segmentation at {spatial}, card vs CPU: {int(differ.sum())} voxels differ, "
                    f"all among the {int(tied.sum())} whose two best posteriors tie")
                if (differ & ~tied).any():
                    raise AssertionError("the card's segmentation differs from the CPU's")
            del model
    return out


def instance_check(smi):
    """Phase 10: cli/train_instance at full width warm-started from the
    committed checkpoint, then Transform on its warp and on an affine."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    moving, fixed = smooth_pair(INSHAPE, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/moving.npz", vol=moving[0, ..., 0].numpy())
        np.savez(f"{tmp}/fixed.npz", vol=fixed[0, ..., 0].numpy())
        t0 = time.perf_counter()
        step_losses = instance_cli.main([
            "--moving", f"{tmp}/moving.npz", "--fixed", f"{tmp}/fixed.npz", "--model",
            str(CHECKPOINT), "--moved", f"{tmp}/moved.nii", "--warp", f"{tmp}/warp.nii",
            "--steps", str(INSTANCE_STEPS), "--lr", str(INSTANCE_LR), "--device", "cuda"])
        cli_s = time.perf_counter() - t0
        moved = torch.from_numpy(load_volfile(f"{tmp}/moved.nii")).cuda()
        warp = torch.from_numpy(load_volfile(f"{tmp}/warp.nii")).cuda()
    log(f"cli/train_instance, {INSTANCE_STEPS} steps at {INSHAPE} from {CHECKPOINT.name}: "
        f"{cli_s:.2f} s in all; losses {step_losses[0]:.6f} -> {step_losses[-1]:.6f}; "
        f"max|warp| {warp.abs().max().item():.3f} voxels")
    if not (all(np.isfinite(step_losses)) and step_losses[-1] < step_losses[0]):
        raise AssertionError(f"cli/train_instance did not lower the loss: {step_losses}")

    # the seconds and launches of a step of the CLI's recipe (its defaults:
    # MSE, Grad-l2 at 0.01, Adam 1e-3) from the same warm start; the loss
    # is logged, not gated
    model = InstanceDense(INSHAPE, generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.set_flow(load_model(str(CHECKPOINT), device="cuda")(
            moving.cuda(), fixed.cuda())["preint_flow"].float())
    trainer = Trainer(model, [LossTerm("y_source", losses.MSE().loss, target_index=0),
                              LossTerm("reg", losses.Grad("l2", loss_mult=2).loss, weight=0.01,
                                       target_index=1, name="grad")], lr=1e-3, device="cuda")
    zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
    _, step_s, counts, peak, _ = run_steps(trainer, (moving.cuda(),), (fixed.cuda(), zero), 6,
                                        "float32 instance optimisation", smi, gate_loss=False)

    # Transform: the written warp through transform_batched, and an affine
    # through warp.transform
    mv = moving.cuda()
    with torch.no_grad():
        ours = Transform()(mv, warp[None])
        ref = warp_ops.transform_batched(mv, warp[None])
        err_cli = (ours[0] - moved[..., None]).abs().max().item()
        mat = torch.tensor([[1.02, 0.03, 0.0, 2.5], [-0.02, 0.98, 0.01, -1.5],
                            [0.0, 0.02, 1.01, 0.75]], device="cuda")
        aff = Transform()(mv, mat[None])
        aff_ref = warp_ops.transform(mv[0], mat, window_halo=None)
    log(f"Transform of the CLI's warp vs transform_batched: max abs err "
        f"{(ours - ref).abs().max().item():.3e}; vs the CLI's moved image {err_cli:.3e}; "
        f"affine vs warp.transform {(aff[0] - aff_ref).abs().max().item():.3e}")
    if not (torch.equal(ours, ref) and torch.equal(aff[0], aff_ref) and err_cli <= IMAGE_TOL):
        raise AssertionError("Transform disagrees with transform_batched or warp.transform")
    return dict(launches=counts, step_s=float(np.median(step_s[1:])), peak_gib=peak,
                cli_s=cli_s)


# Phase 11, HyperMorph: the committed checkpoint (HyperVxmDense, default
# features, svf_resolution 2, float32, trained at 80x96x112), its lambdas,
# the steps of its recipe and the CLIs' lambda
HYPER_CHECKPOINT = ROOT / "artifacts_r5" / "hyper_r5_0100_model.npz"
HYPER_LAMBDAS = (0.0, 0.5, 1.0)
HYPER_STEPS = 10
HYPER_CLI_LAMBDA = 0.3
# the least max|pos_flow(lambda 0) - pos_flow(lambda 1)| that shows the
# hypernetwork conditioning the warp, in voxels
HYPER_MIN_LAMBDA_EFFECT = 0.1
# one bs2 HyperMorph step (flow head redrawn N(0, FLOW_STD)) card against
# CPU at 80x96x112, each gradient tensor relative to its largest entry. The
# generators' gradients of the encoder's first and third blocks are the
# worst conditioned: on the chip host's CPU alone, the same step summed in
# another order (two bs1 steps, or a loop over the samples in place of the
# grouped conv) moves them by up to 7.1e-4, and its input scaled by
# 1 + 1e-7 noise by 7.1e-4. Measured on an H100: 1.915e-3 and 1.572e-3 for
# the third block's, every other tensor under 1.2e-3; the same with
# cudnn.deterministic, with two bs1 steps (1.93e-3) and with a loop over
# the samples (1.99e-3), so neither the grouped conv nor the batch sets
# it; 2.56e-3 with the pair and its reverse as the batch. A zero gradient
# differs by 1.
HYPER_GRAD_GPU_VS_CPU_RTOL = 5e-3


def hyper_serving(smi, profile):
    """Phase 11a: the committed HyperMorph checkpoint (float32, as trained)
    re-targeted to INSHAPE registers smooth_pair at each of HYPER_LAMBDAS;
    the conv kernel is never launched on its hyper blocks; the card against
    the CPU at the checkpoint's own 80x96x112, and bfloat16 against
    float32. Everything in float32 runs with TF32 off. Returns the
    launches and the ms per pair at lambda 0.5."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    model = resolve_registration_model(load_model(str(HYPER_CHECKPOINT), device="cuda"),
                                       inshape=INSHAPE)
    log(f"model: HyperVxmDense {model.inshape} dtype {model.dtype}, "
        f"{sum(p.numel() for p in model.parameters())} params")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        outs, launches = {}, {}
        for lam in HYPER_LAMBDAS:
            reset_launches()
            outs[lam] = build_register_fn(model, hyper=lam)(moving, fixed)
            torch.cuda.synchronize()
            launches[lam] = read_launches()
            moved, warp = outs[lam]
            check_warp_work(launches[lam], f"the HyperMorph register call at lambda {lam}",
                            backward=False)
            if tuple(warp.shape) != (1, *INSHAPE, 3) or not (
                    torch.isfinite(moved).all() and torch.isfinite(warp).all()):
                raise AssertionError(f"bad HyperMorph output at lambda {lam}")
            log(f"lambda {lam}: max|warp| {warp.abs().max().item():.4f} voxels, "
                f"mean|moved - fixed| {(moved - fixed).abs().mean().item():.5f} (before "
                f"{(moving - fixed).abs().mean().item():.5f}); launches {launches[lam]}")
        effect = (outs[0.0][1] - outs[1.0][1]).abs().max().item()
        log(f"max|pos_flow(lambda 0) - pos_flow(lambda 1)| {effect:.4f} voxels "
            f"(at least {HYPER_MIN_LAMBDA_EFFECT})")
        if not effect >= HYPER_MIN_LAMBDA_EFFECT:
            raise AssertionError("lambda does not change the HyperMorph warp")
        with conv_kernel_mode(True):
            reset_launches()
            kernel_mode = build_register_fn(model, hyper=0.5)(moving, fixed)
            torch.cuda.synchronize()
            counts = read_launches()
        same = all(torch.equal(a, b) for a, b in zip(kernel_mode, outs[0.5]))
        log(f"with set_pallas_conv(True): conv launches {counts['conv']}, layout copies "
            f"{counts['layout_copies']}, outputs bit-equal to cuDNN mode {same}")
        if counts["conv"] or counts["layout_copies"] or not same:
            raise AssertionError("a hyper block took the conv kernel, or its output changed")
    finally:
        torch.backends.cudnn.deterministic = saved

    reps = 5
    register = build_register_fn(model, hyper=0.5)
    register(moving, fixed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        register(moving, fixed)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    log(f"bs1 float32 HyperMorph, lambda 0.5: {ms:.2f} ms per pair ({1e3 / ms:.4f} pairs/s); "
        f"{smi}")
    if profile:
        profile_device("HyperMorph register call, lambda 0.5", lambda: register(moving, fixed),
                       rows=20)
    del model

    # the card against the port's CPU run at the checkpoint's own shape;
    # bfloat16 against float32 on the card
    half = tuple(s // 2 for s in INSHAPE)
    mv_h, fx_h = smooth_pair(half, "cpu")
    results = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = load_model(str(HYPER_CHECKPOINT), device=device)
        results[device] = [t.cpu() for t in build_register_fn(model, hyper=0.5)(
            mv_h.to(device), fx_h.to(device))]
        log(f"lambda 0.5 at {half} on {device}: {time.perf_counter() - t0:.2f} s")
    flow_err = (results["cuda"][1] - results["cpu"][1]).abs().max().item()
    image_err = (results["cuda"][0] - results["cpu"][0]).abs().max().item()
    log(f"GPU vs CPU float32 at {half}: pos_flow max abs err {flow_err:.3e} (tol {FLOW_TOL}; "
        f"max|pos_flow| {results['cpu'][1].abs().max().item():.3f}), y_source max abs err "
        f"{image_err:.3e} (tol {IMAGE_TOL})")
    if not (flow_err <= FLOW_TOL and image_err <= IMAGE_TOL):
        raise AssertionError("the HyperMorph float32 GPU run disagrees with the CPU run")
    bf16_model = resolve_registration_model(
        load_model(str(HYPER_CHECKPOINT), device="cuda", dtype=torch.bfloat16), inshape=INSHAPE)
    moved, warp = build_register_fn(bf16_model, hyper=0.5)(moving, fixed)
    log("HyperMorph, lambda 0.5:")
    bf16_vs_f32(moved, warp, *outs[0.5])
    return dict(launches=launches[0.5], ms_per_pair=ms, lambda_effect_voxels=effect,
                gpu_vs_cpu=[flow_err, image_err])


def hyper_model(inshape, flow_std=None):
    """scripts/train_hypermorph.py's model: a float32 HyperVxmDense of
    default features, svf_resolution 2, from seed 0; ``flow_std`` redraws
    the flow head's kernel as N(0, flow_std) (seed 1)."""
    model = HyperVxmDense(inshape, nb_unet_features=[[16, 32, 32, 32],
                                                     [32, 32, 32, 32, 32, 16, 16]],
                          int_steps=7, int_resolution=2, svf_resolution=2,
                          generator=torch.Generator().manual_seed(SEED))
    if flow_std is not None:
        with torch.no_grad():
            model.vxm.flow.weight.normal_(0.0, flow_std,
                                          generator=torch.Generator().manual_seed(SEED + 1))
    return model


def hyper_batch(moving, fixed, lambdas):
    """The recipe's batch of len(lambdas) pairs, each with its lambda: the
    pair, then the pair flipped along the i-th axis."""
    n = len(lambdas)
    src = torch.cat([moving if i == 0 else moving.flip(i) for i in range(n)])
    trg = torch.cat([fixed if i == 0 else fixed.flip(i) for i in range(n)])
    hyp = torch.tensor(lambdas, dtype=torch.float32, device=src.device)[:, None]
    zero = torch.zeros((n, *src.shape[1:-1], 3), device=src.device)
    return (src, trg, hyp), (trg, zero)


def hyper_training(smi, profile):
    """Phase 11b: train_hypermorph's recipe (MSE at sigma 0.05 weighted
    1 - lambda, Grad-l2 x 2 weighted lambda, Adam 1e-4, float32, TF32 off):
    one bs2 step with two lambdas, card against CPU at 80x96x112 (flow head
    redrawn); then ten bs1 steps at INSHAPE with lambda drawn from
    hyp_stream, the bounded backward in each, and the loss of a fixed
    (pair, lambda 0.5) lowered. Returns the launches and readings."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    terms = hypermorph_terms("mse", 0.05, 2)

    half = tuple(s // 2 for s in INSHAPE)
    mv_h, fx_h = smooth_pair(half, "cpu")
    batch = hyper_batch(mv_h, fx_h, [0.2, 0.8])
    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        with window_halo("1") if device == "cpu" else contextlib.nullcontext():
            trainer = Trainer(hyper_model(half, FLOW_STD), terms, device=device)
            trainer.model.train()
            inputs, targets = (tuple(a.to(device) for a in part) for part in batch)
            reset_launches()
            loss, _ = trainer.loss_fn(inputs, targets)
            loss.backward()
            if device == "cuda":
                torch.cuda.synchronize()
                check_warp_work(read_launches(), "the bs2 HyperMorph step at half width")
        runs[device] = (loss.item(), {n: p.grad.detach().cpu()
                                      for n, p in trainer.model.named_parameters()})
        log(f"bs2 HyperMorph step at {half} on {device}: {time.perf_counter() - t0:.2f} s")
        del trainer, loss
    card_vs_cpu_rel = compare_grads(f"HyperMorph GPU vs CPU, bs2, lambda 0.2 and 0.8, {half}",
                                    *runs["cuda"], *runs["cpu"], HYPER_GRAD_GPU_VS_CPU_RTOL)
    del runs

    moving, fixed = smooth_pair(INSHAPE, "cuda")
    model = hyper_model(INSHAPE)
    dense_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                      if "_gen." in n or n.startswith("hyp_dense_"))
    trainer = Trainer(model, terms, lr=1e-4, device="cuda")
    probe_in, probe_tg = hyper_batch(moving, fixed, [0.5])

    def probe_loss():
        model.train()
        with torch.no_grad():
            return trainer.loss_fn(probe_in, probe_tg)[0].item()

    before = probe_loss()
    stream = hyp_stream(1, 0.2)
    zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    step_s, step_losses, drawn, counts = [], [], [], None
    for step in range(HYPER_STEPS):
        (hyp,) = next(stream)
        drawn.append(float(hyp[0, 0]))
        reset_launches()
        t0 = time.perf_counter()
        step_losses.append(trainer.train_step((moving, fixed, hyp), (fixed, zero))["loss"].item())
        step_s.append(time.perf_counter() - t0)
        counts = read_launches()
        check_warp_work(counts, f"HyperMorph train step {step}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = probe_loss()
    median_s = float(np.median(step_s[1:]))
    log("lambdas drawn: " + ", ".join(f"{x:.4f}" for x in drawn))
    log("step losses: " + ", ".join(f"{x:.6f}" for x in step_losses))
    log(f"HyperMorph float32 train step, bs1, {INSHAPE}: " + ", ".join(
        f"{x:.4f}" for x in step_s) + f" s/step (median after the first {median_s:.4f}); peak "
        f"memory allocated {peak:.3f} GiB; the hypernetwork's Dense weights "
        f"{dense_bytes / 2 ** 30:.3f} GiB, {4 * dense_bytes / 2 ** 30:.3f} with their gradients "
        f"and Adam's moments; launches of the last step {counts}; {smi}")
    log(f"loss at (pair, lambda 0.5): {before:.6f} before the {HYPER_STEPS} steps, "
        f"{after:.6f} after")
    if not (np.isfinite(step_losses).all() and np.isfinite(after) and after < before):
        raise AssertionError("the HyperMorph steps did not lower the loss at lambda 0.5")
    if profile:
        profile_device("HyperMorph train step", lambda: trainer.train_step(
            probe_in, probe_tg)["loss"].item(), rows=30)
    return dict(launches=counts, step_s=median_s, peak_gib=peak,
                dense_gib=dense_bytes / 2 ** 30, gpu_vs_cpu_rel=card_vs_cpu_rel,
                probe_loss=[before, after])


def hyper_clis(smi):
    """Phase 11c: cli/train_hypermorph --cache-device with
    --steps-per-dispatch against single steps on 4 full-width volumes, then
    cli/register, cli/test and cli/sweep_hypermorph on the labelled pair."""
    moving, fixed, src_lab, trg_lab = labelled_pair(INSHAPE, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        vols = [moving[0, ..., 0], fixed[0, ..., 0], moving[0, ..., 0].flip(0),
                fixed[0, ..., 0].flip(1)]
        for i, vol in enumerate(vols):
            np.savez(f"{tmp}/scan{i}.npz", vol=vol.numpy())
        Path(f"{tmp}/list.txt").write_text("".join(f"{tmp}/scan{i}.npz\n" for i in range(4)))
        common = ["--img-list", f"{tmp}/list.txt", "--epochs", "1", "--steps-per-epoch",
                  str(DISPATCH_STEPS), "--cache-device", "--device", "cuda"]
        saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        runs = {}
        try:
            for name, extra in (("single", []),
                                ("dispatch", ["--steps-per-dispatch", str(DISPATCH_STEPS)])):
                reset_launches()
                t0 = time.perf_counter()
                trainer = hyper_train_cli.main([*common, *extra, "--model-dir", f"{tmp}/{name}"])
                torch.cuda.synchronize()
                runs[name] = dict(s=time.perf_counter() - t0, launches=read_launches(),
                                  fetches=trainer.metric_fetches,
                                  params={n: p.detach().clone()
                                          for n, p in trainer.model.named_parameters()})
                del trainer
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        one, many = runs["single"], runs["dispatch"]
        equal = all(torch.equal(one["params"][n], p) for n, p in many["params"].items())
        worst = max(((one["params"][n] - p).abs().max() / p.abs().max()).item()
                    for n, p in many["params"].items())
        log(f"cli/train_hypermorph --cache-device, {DISPATCH_STEPS} steps at {INSHAPE}: "
            f"--steps-per-dispatch {DISPATCH_STEPS} against single steps params bit-equal "
            f"{equal} (cudnn.deterministic), largest difference {worst:.3e} of a tensor's "
            f"largest magnitude (tol {DISPATCH_RTOL}); {one['s']:.2f} and {many['s']:.2f} s "
            f"in all (two checkpoints each); metric fetches {one['fetches']} and "
            f"{many['fetches']}; launches of the dispatch {many['launches']}")
        if not (equal or worst <= DISPATCH_RTOL):
            raise AssertionError("the HyperMorph dispatch differs from single steps")
        check_warp_work(many["launches"], "the HyperMorph dispatch")
        launches = {k: v // DISPATCH_STEPS for k, v in many["launches"].items()}
        del runs, one, many

        # the labelled pair, and the checkpoint re-targeted to its shape
        for name, vol, lab in (("moving", moving, src_lab), ("fixed", fixed, trg_lab)):
            np.savez(f"{tmp}/{name}.npz", vol=vol[0, ..., 0].numpy(), seg=lab.numpy())
        Path(f"{tmp}/pairs.txt").write_text(f"{tmp}/moving.npz {tmp}/fixed.npz\n")
        np.save(f"{tmp}/labels.npy", np.arange(1, SEMI_LABELS + 1))
        save_model(f"{tmp}/hyper_full.npz", resolve_registration_model(
            load_model(str(HYPER_CHECKPOINT), device="cpu"), inshape=INSHAPE))
        lam = str(HYPER_CLI_LAMBDA)
        t0 = time.perf_counter()
        register_cli.main(["--moving", f"{tmp}/moving.npz", "--fixed", f"{tmp}/fixed.npz",
                           "--model", f"{tmp}/hyper_full.npz", "--hyper", lam,
                           "--moved", f"{tmp}/moved.nii", "--warp", f"{tmp}/warp.nii",
                           "--device", "cuda"])
        register_s = time.perf_counter() - t0
        warp = torch.from_numpy(load_volfile(f"{tmp}/warp.nii")).cuda()
        carried = warp_ops.transform(src_lab.cuda().float(), warp, interp_method="nearest",
                                     window_halo=None).cpu().numpy()
        register_dice = float(np.mean(dice(carried, trg_lab.numpy())))
        log(f"cli/register --hyper {lam} at {INSHAPE}: {register_s:.2f} s; max|warp| "
            f"{warp.abs().max().item():.3f} voxels; Dice of the labels carried by its warp "
            f"{register_dice:.4f} (unregistered "
            f"{np.mean(dice(src_lab.numpy(), trg_lab.numpy())):.4f})")
        t0 = time.perf_counter()
        scores = test_cli.main(["--model", f"{tmp}/hyper_full.npz", "--pairs",
                                f"{tmp}/pairs.txt", "--img-suffix", "", "--seg-prefix", "",
                                "--hyper", lam, "--device", "cuda"])
        test_s = time.perf_counter() - t0
        log(f"cli/test --hyper {lam}: Dice {scores[0]:.4f}, {test_s:.2f} s")
        if abs(scores[0] - register_dice) > 1e-4:
            raise AssertionError(f"cli/test's Dice {scores[0]} differs from cli/register's "
                                 f"{register_dice}")
        t0 = time.perf_counter()
        report = sweep_cli.main(["--model", str(HYPER_CHECKPOINT), "--pairs",
                                 f"{tmp}/pairs.txt", "--labels", f"{tmp}/labels.npy",
                                 "--lambdas", *map(str, HYPER_LAMBDAS),
                                 "--out", f"{tmp}/sweep.json", "--device", "cuda"])
        sweep_s = time.perf_counter() - t0
    log(f"cli/sweep_hypermorph over {HYPER_LAMBDAS}: {sweep_s:.2f} s; {smi}")
    if [r["lambda"] for r in report["sweep"]] != list(HYPER_LAMBDAS) or not all(
            0.0 <= r["dice_mean"] <= 1.0 for r in report["sweep"]):
        raise AssertionError(f"bad sweep report {report}")
    return dict(launches=launches, register_dice=register_dice, test_dice=float(scores[0]),
                sweep=report["sweep"], identity_dice=report["identity_dice_mean"],
                cli_s=dict(register=register_s, test=test_s, sweep=sweep_s))


SYNTH_CHECKPOINT = ROOT / "artifacts_r5" / "synth_w25_00010.npz"
# the checkpoint's own shape, and its recipe's bs1 step
SYNTH_HALF = (80, 96, 112)
# full resolution's output labels: the first 30 of the checkpoint's 46
SYNTH_OUT_LABELS = 30
SYNTH_STEPS = 10
SYNTH_IMAGE_LOSS_WEIGHT = 0.25
# the synthesis on the card against the CPU on the same draws, each output
# (image, one-hot, warp, inverse) relative to its largest magnitude: the
# same plain gathers summed in another order, through 5 squarings and the
# exp and pow of the contrast (the CPU tests read 2.0e-7 against JAX)
SYNTH_GPU_VS_CPU_RTOL = 1e-4
# the fused one-hot warp against the packed one ((1 + L)-channel interpn):
# the same corner order and products, so equal up to float addition of
# zeros, which changes nothing
SYNTH_FUSED_VS_PACKED_RTOL = 1e-6
# a one-hot channel sum against the warped indicator of the output labels,
# in absolute units (a sum is at most 1)
SYNTH_CHANNEL_SUM_TOL = 1e-5
# one float32 step of the checkpoint's recipe, card against CPU, each
# gradient tensor relative to its largest entry. The last convs' weight
# gradients are small sums of terms that cancel: on the GPU machine's CPU
# alone the synthesis noise scaled by 1 + 1e-7 noise moves them by up to
# 6.9e-4 and 1.76e-3 (two draws of that noise), on the card by 3.2e-4 and
# 4.6e-4; card against CPU they read 2.66e-3 (every tensor outside the
# last two convs and the flow head under 1e-3; an NVIDIA H100 80GB HBM3
# at 700 W, --conditioning). A zero gradient differs by 1.
SYNTH_GRAD_GPU_VS_CPU_RTOL = 5e-3
# the halo under which the dispatch check runs (VXM_WINDOW_HALO): every
# warp of the recipe (flows under 2.4 voxels) takes a bounded kernel, whose
# backward adds no atomics, so the dispatch and the single steps are
# bit-equal; at the default halo 1 the last squarings take the gather, whose
# backward adds the field's gradient with atomics in any order (two runs of
# the same 4 single steps differ by 4.7e-6 and 7.4e-6 of a tensor's largest
# entry; an NVIDIA H100 80GB HBM3 at 700 W, --conditioning)
SYNTH_DISPATCH_HALO = 4


# conv launches of a SynthMorph train step in conv-kernel mode: its U-Net's
# 10 forward convs, their recomputation in the backward (the per-block
# remat), and the input gradients of all but the first
TRAIN_STEP_SYNTH_CONVS = 29


def synth_labels():
    """The committed SynthMorph checkpoint's synthesis config: its 46 input
    labels and parameters."""
    return read_checkpoint(str(SYNTH_CHECKPOINT))[1]["cfg"]


def synth_label_maps(spatial, n, label_values, device):
    """``n`` label maps ``(*spatial,)`` int32 of the checkpoint's label values:
    Voronoi partitions (voronoi_labels) of the head masks of smooth_pair's
    two images and their flips, into len(label_values) - 1 regions, the
    background the first value (0)."""
    moving, fixed = smooth_pair(spatial, device)
    images = [moving[0], fixed[0], moving[0].flip(0), fixed[0].flip(1)]
    values = torch.as_tensor(np.asarray(label_values, np.int64), device=device)
    return [values[voronoi_labels(images[i % 4], len(label_values) - 1,
                                  SEED + 20 + i).long()].to(torch.int32) for i in range(n)]


def draws_on(draws, device):
    """Synthesis draws (tensors, lists and tuples of them, dicts) on ``device``."""
    if isinstance(draws, torch.Tensor):
        return draws.to(device)
    if isinstance(draws, dict):
        return {k: draws_on(v, device) for k, v in draws.items()}
    if isinstance(draws, (list, tuple)):
        return type(draws)(draws_on(v, device) for v in draws)
    return draws


def synth_config(spatial, nb_out, base=None):
    """The checkpoint's synthesis at ``spatial`` with its first ``nb_out``
    labels as outputs."""
    base = base or synth_labels()
    kwargs = {k: v for k, v in base.to_dict().items()
              if k not in ("in_shape", "out_shape", "out_label_list")}
    return LabelsToImageConfig(in_shape=spatial, out_shape=spatial,
                               out_label_list=kwargs["in_label_list"][:nb_out], **kwargs)


def synth_synthesis(smi, profile):
    """Phase 12a: labels_to_image at 80x96x112 (46 output labels) and at
    INSHAPE (30): the card against the CPU on the same draws at 80x96x112;
    the one-hot's channel sums against the warped indicator of the output
    labels; the fused one-hot warp against the packed one, and the time of
    each; ms per synthesized pair and its peak memory (with ``profile``,
    one image's device time by kernel at INSHAPE)."""
    base = synth_labels()
    out = {}
    for spatial, nb_out in ((SYNTH_HALF, base.nb_in_labels), (INSHAPE, SYNTH_OUT_LABELS)):
        cfg = synth_config(spatial, nb_out, base)
        maps = [m[None, ..., None] for m in synth_label_maps(spatial, 2, base.in_label_list,
                                                            "cuda")]
        gen = torch.Generator(device="cuda").manual_seed(SEED)

        def pair():
            return [labels_to_image(gen, m, cfg, return_warp=True) for m in maps]

        torch.cuda.reset_peak_memory_stats()
        pair_ms = wall_ms(pair, reps=5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        image, one_hot, warp, inv_warp = pair()[0]
        if profile and spatial == INSHAPE:
            profile_device(f"labels_to_image, one image at {spatial}, {nb_out} labels",
                           lambda: labels_to_image(gen, maps[0], cfg)[0].sum().item(), rows=25)
        row = dict(labels_in=cfg.nb_in_labels, labels_out=nb_out, pair_ms=pair_ms,
                   peak_gib=peak, max_warp=warp.abs().max().item())
        log(f"12a {spatial}, {cfg.nb_in_labels} labels in, {nb_out} out: {pair_ms:.2f} ms per "
            f"synthesized pair (two labels_to_image calls with return_warp, draws included), "
            f"peak memory allocated {peak:.3f} GiB; max|warp| {row['max_warp']:.3f} voxels; "
            f"image in [{image.min().item():.3g}, {image.max().item():.3g}]; {smi}")
        if not (torch.isfinite(image).all() and 0 <= image.min() and image.max() <= 1
                and tuple(one_hot.shape) == (1, *spatial, nb_out)):
            raise AssertionError(f"12a: a bad synthesized image or one-hot at {spatial}")

        # the channel sums: the warped indicator of the output labels
        out_lut = torch.as_tensor(cfg.out_lut, device="cuda")
        out_idx = out_lut[maps[0][0, ..., 0].long().clamp(0, out_lut.numel() - 1)]
        loc = ndgrid(spatial, device="cuda") + warp[0]
        expected = interp.interpn((out_idx >= 0).float(), loc)
        sums = one_hot[0].sum(-1)
        sum_err = (sums - expected).abs().max().item()
        row["channel_sum_err"] = sum_err
        log(f"12a {spatial}: one-hot channel sums in [{sums.min().item():.6f}, "
            f"{sums.max().item():.6f}], against the warped indicator of the output labels max "
            f"abs err {sum_err:.3e} (tol {SYNTH_CHANNEL_SUM_TOL})")
        if not sum_err <= SYNTH_CHANNEL_SUM_TOL:
            raise AssertionError(f"12a: the one-hot's channel sums are off at {spatial}")

        # fused against packed, on a random image, the map's output indices
        # and the synthesis warp's locations
        img = torch.rand(spatial, generator=gen, device="cuda")

        def fused():
            return interpn_label_onehot(img, out_idx, loc, nb_out)

        def packed():
            one = F.one_hot(out_idx.clamp(min=0).long(), nb_out).float() * (
                out_idx >= 0)[..., None]
            warped = interp.interpn(torch.cat([img[..., None], one], -1), loc)
            return warped[..., 0], warped[..., 1:]

        f_img, f_oh = fused()
        p_img, p_oh = packed()
        rel = max(rel_max(f_img, p_img), rel_max(f_oh, p_oh))
        equal = torch.equal(f_img, p_img) and torch.equal(f_oh, p_oh)
        del f_img, f_oh, p_img, p_oh
        row.update(fused_ms=wall_ms(fused, reps=5), packed_ms=wall_ms(packed, reps=5),
                   fused_vs_packed=rel)
        log(f"12a {spatial}: the fused one-hot warp against the packed interpn of "
            f"{nb_out + 1} channels: bit-equal {equal}, largest relative difference {rel:.3e} "
            f"(tol {SYNTH_FUSED_VS_PACKED_RTOL}); fused {row['fused_ms']:.3f} ms, packed "
            f"{row['packed_ms']:.3f} ms (host clock, synchronised, mean of 5)")
        if not rel <= SYNTH_FUSED_VS_PACKED_RTOL:
            raise AssertionError(f"12a: the fused one-hot warp differs from the packed one")

        if spatial == SYNTH_HALF:
            # the card against the CPU on the same draws
            draws = labels_to_image_draws(torch.Generator().manual_seed(SEED + 1), cfg, 1)
            t0 = time.perf_counter()
            cpu = labels_to_image_from_draws(maps[0].cpu(), cfg, draws, return_warp=True)
            cpu_s = time.perf_counter() - t0
            card = labels_to_image_from_draws(maps[0], cfg, draws_on(draws, "cuda"),
                                              return_warp=True)
            errs = [rel_max(a.cpu(), b) for a, b in zip(card, cpu)]
            row["gpu_vs_cpu"] = errs
            log(f"12a {spatial}: card vs CPU on the same draws (CPU {cpu_s:.2f} s), largest "
                f"difference relative to the largest magnitude: image {errs[0]:.3e}, one-hot "
                f"{errs[1]:.3e}, warp {errs[2]:.3e}, inverse {errs[3]:.3e} (tol "
                f"{SYNTH_GPU_VS_CPU_RTOL})")
            if not max(errs) <= SYNTH_GPU_VS_CPU_RTOL:
                raise AssertionError("12a: the synthesis on the card disagrees with the CPU")
        out[spatial] = row
        del maps, image, one_hot, warp, inv_warp, loc, expected, img
    return out


def conv_blocks(model):
    """The U-Net's conv blocks of a VxmDense."""
    return sum(isinstance(m, ConvBlock) for m in model.unet.modules())


def conv_block_shapes(model, fn):
    """The (D, H, W, ci, co) of each 3-D ConvBlock call of ``model`` while
    ``fn()`` runs, in call order."""
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: shapes.append((*args[0].shape[2:], args[0].shape[1],
                                       m.conv.out_channels)))
        for m in model.modules() if isinstance(m, ConvBlock)]
    try:
        fn()
    finally:
        for hook in hooks:
            hook.remove()
    return shapes


def synth_serving(smi):
    """Phase 12b: the committed checkpoint's VxmDense (bfloat16) re-targeted
    to INSHAPE registers smooth_pair at bs1 in cuDNN and conv-kernel mode;
    the conv kernel at the U-Net's conv shapes of that call (64 wide, the
    decoder's 128 -> 64), forward and input gradient, bfloat16 and float32,
    against its plain version and timed beside cuDNN (check_conv3);
    bfloat16 against float32 (TF32 off) on the card, and the card against
    the CPU in float32 at the checkpoint's own 80x96x112."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    model = resolve_registration_model(load_model(str(SYNTH_CHECKPOINT), device="cuda"),
                                       inshape=INSHAPE)
    blocks = conv_blocks(model)
    log(f"12b model: VxmDense {model.inshape} dtype {model.dtype}, "
        f"{sum(p.numel() for p in model.parameters())} params, {blocks} conv blocks")
    results = {}
    for enabled in (False, True):
        mode = "conv kernel" if enabled else "cuDNN"
        with conv_kernel_mode(enabled):
            register = build_register_fn(model)
            shapes = conv_block_shapes(model, lambda: register(moving, fixed))
            torch.cuda.synchronize()
            reset_launches()
            moved, warp = register(moving, fixed)
            torch.cuda.synchronize()
            counts = read_launches()
            check_warp_work(counts, f"12b register call, {mode}", backward=False)
            ms = wall_ms(lambda: register(moving, fixed), reps=5)
        log(f"12b {mode}, bfloat16, bs1, {INSHAPE}: {ms:.2f} ms per pair; max|warp| "
            f"{warp.abs().max().item():.3f} voxels; launches {counts}; {smi}")
        if enabled and (counts["conv"] != blocks or counts["layout_copies"]):
            raise AssertionError(f"12b: {counts['conv']} conv-kernel launches for {blocks} "
                                 f"blocks, {counts['layout_copies']} layout copies")
        if not (torch.isfinite(moved).all() and torch.isfinite(warp).all()):
            raise AssertionError(f"12b: non-finite register output ({mode})")
        results[enabled] = dict(ms=ms, launches=counts, out=(moved, warp))
    log("12b the conv kernel's bfloat16 call against cuDNN's:")
    bf16_vs_f32(*results[True]["out"], *results[False]["out"])
    log(f"12b the U-Net's conv shapes (D, H, W, ci, co): {shapes}")
    conv_rows, conv_totals = check_conv3(SEED + 5, shapes, ("fwd", "dx"),
                                         label="12b conv3 at SynthMorph's U-Net shapes,")
    f32 = resolve_registration_model(load_model(str(SYNTH_CHECKPOINT), device="cuda",
                                                dtype=torch.float32), inshape=INSHAPE)
    moved_f32, warp_f32 = build_register_fn(f32)(moving, fixed)
    log("12b bfloat16 (cuDNN) against float32:")
    bf16_vs_f32(*results[False]["out"], moved_f32, warp_f32)
    del model, f32, moved_f32, warp_f32

    mv_h, fx_h = smooth_pair(SYNTH_HALF, "cpu")
    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        net = resolve_registration_model(load_model(str(SYNTH_CHECKPOINT), device=device,
                                                    dtype=torch.float32), inshape=SYNTH_HALF)
        runs[device] = [t.cpu() for t in build_register_fn(net)(mv_h.to(device),
                                                                fx_h.to(device))]
        log(f"12b float32 at {SYNTH_HALF} on {device}: {time.perf_counter() - t0:.2f} s")
    flow_err = (runs["cuda"][1] - runs["cpu"][1]).abs().max().item()
    image_err = (runs["cuda"][0] - runs["cpu"][0]).abs().max().item()
    log(f"12b GPU vs CPU float32 at {SYNTH_HALF}: pos_flow max abs err {flow_err:.3e} (tol "
        f"{FLOW_TOL}; max|pos_flow| {runs['cpu'][1].abs().max().item():.3f}), y_source max abs "
        f"err {image_err:.3e} (tol {IMAGE_TOL})")
    if not (flow_err <= FLOW_TOL and image_err <= IMAGE_TOL):
        raise AssertionError("12b: the float32 GPU run disagrees with the CPU run")
    return dict(launches=results[False]["launches"], conv_launches=results[True]["launches"],
                ms_per_pair=results[False]["ms"], conv_ms_per_pair=results[True]["ms"],
                gpu_vs_cpu=[flow_err, image_err], conv_shapes=shapes, conv_rows=conv_rows,
                conv_totals={f"{dtype} {orientation}": t
                             for (dtype, orientation), t in conv_totals.items()})


def synth_recipe_terms():
    """The committed checkpoint's recipe: Dice + 1, Grad-l2, and NCC at
    --image-loss-weight 0.25."""
    return synthmorph_terms(1.0, SYNTH_IMAGE_LOSS_WEIGHT)


def synth_step_grads(device, draws, batch, conv, dtype=torch.float32, make_model=None):
    """One step's loss and gradients of the checkpoint's recipe on
    ``draws`` (float32 with TF32 off unless ``dtype``), on ``device``, of
    the checkpoint's model or of ``make_model(device)``; the CPU takes the
    bounded tiers as the card does. Returns (loss, grads, launches)."""
    model = (make_model(device) if make_model else
             load_model(str(SYNTH_CHECKPOINT), device=device, dtype=dtype)).train()
    on_device = draws_on(draws, device)
    loss_fn = make_loss_fn(lambda *x, generator=None: model(*x, draws=on_device),
                           synth_recipe_terms())
    inputs = tuple(t.to(device) for t in batch)
    counts = None
    with (window_halo("1") if device == "cpu" else conv_kernel_mode(conv)):
        if device == "cuda":
            reset_launches()
        loss, _ = loss_fn(inputs, (torch.zeros(1, device=device),))
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            counts = read_launches()
    return loss.item(), {n: p.grad.detach().float().cpu()
                         for n, p in model.named_parameters()}, counts


def synth_conditioning(draws, batch, runs):
    """How far the synthesis noise scaled by 1 + 1e-7 noise moves 12c's
    float32 gradients on the CPU and on the card: the largest relative
    difference of each side against its own run in ``runs``."""
    noisy = draws_on(draws, "cpu")
    gen = torch.Generator().manual_seed(SEED + 3)
    for side in ("src", "trg"):
        d = dict(noisy[side][0])
        d["noise"] = d["noise"] * (1 + 1e-7 * torch.randn(d["noise"].shape, generator=gen))
        noisy[side] = [d]
    for name, device in (("CPU", "cpu"), ("cuDNN", "cuda")):
        _, grads, _ = synth_step_grads(device, noisy, batch, False)
        ref = runs[name][1]
        worst = max(((grads[n] - g).abs().max() / g.abs().max()).item() for n, g in ref.items())
        log(f"12c conditioning: the synthesis noise scaled by 1 + 1e-7 noise moves the "
            f"{name} run's gradients by up to {worst:.3e} of a tensor's largest magnitude")


def synth_training(smi, profile, conditioning):
    """Phase 12c: the committed checkpoint's recipe (80x96x112, 46 labels,
    bfloat16, shared_contrast 0.5, Dice + Grad + NCC at 0.25, Adam 1e-4,
    bs1) on Voronoi label maps: one float32 step's loss and gradients with
    the conv kernel against cuDNN and on the card against the CPU, on the
    same draws; SYNTH_STEPS bfloat16 steps in cuDNN mode and three with the
    conv kernel (s per step, peak memory, each tiered warp one branch);
    fit_cached_labels' 4-step dispatch against 4 single steps of the cached
    generator, bit for bit (SYNTH_DISPATCH_HALO); a step in each conv mode
    under set_sync_debug_mode("error"). With ``profile``, a bfloat16 step's
    device time by kernel; with ``conditioning``, the readings behind
    SYNTH_GRAD_GPU_VS_CPU_RTOL and SYNTH_DISPATCH_HALO."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    base = synth_labels()
    maps = synth_label_maps(SYNTH_HALF, 4, base.in_label_list, "cuda")
    batch = (maps[0][None, ..., None], maps[1][None, ..., None])
    probe = load_model(str(SYNTH_CHECKPOINT), device="cpu")
    draws = probe.draw(torch.Generator().manual_seed(SEED + 2), 1, "cpu")
    runs = {}
    for name, device, conv in (("cuDNN", "cuda", False), ("conv kernel", "cuda", True),
                               ("CPU", "cpu", False)):
        t0 = time.perf_counter()
        runs[name] = synth_step_grads(device, draws, batch, conv)
        log(f"12c float32 step at {SYNTH_HALF} ({name}): {time.perf_counter() - t0:.2f} s; "
            f"launches {runs[name][2]}")
    for name in ("cuDNN", "conv kernel"):
        check_warp_work(runs[name][2], f"12c float32 step, {name}")
    kernel_vs_cudnn = compare_grads(f"12c conv kernel vs cuDNN, float32, {SYNTH_HALF}",
                                    *runs["conv kernel"][:2], *runs["cuDNN"][:2],
                                    TRAIN_CONV_KERNEL_VS_CUDNN_RTOL)
    card_vs_cpu_rel = compare_grads(f"12c GPU vs CPU, float32, {SYNTH_HALF}",
                                    *runs["cuDNN"][:2], *runs["CPU"][:2],
                                    SYNTH_GRAD_GPU_VS_CPU_RTOL)
    if conditioning:
        synth_conditioning(draws, batch, runs)
    del runs, probe

    zero = torch.zeros(1, device="cuda")
    pairs = [(maps[i][None, ..., None], maps[(i + 1) % 4][None, ..., None]) for i in range(4)]
    steps = {}
    for enabled, n in ((False, SYNTH_STEPS), (True, 3)):
        mode = "conv kernel" if enabled else "cuDNN"
        with conv_kernel_mode(enabled):
            trainer = Trainer(load_model(str(SYNTH_CHECKPOINT), device="cuda"),
                              synth_recipe_terms(), lr=1e-4, device="cuda")
            torch.cuda.reset_peak_memory_stats()
            losses_, step_s, counts = [], [], None
            for i in range(n):
                reset_launches()
                t0 = time.perf_counter()
                losses_.append(trainer.train_step(pairs[i % 4], (zero,))["loss"].item())
                step_s.append(time.perf_counter() - t0)
                counts = read_launches()
                check_warp_work(counts, f"12c bfloat16 step {i}, {mode}")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            # no host sync inside a step, after the warm-up above
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                metrics = trainer.train_step(pairs[0], (zero,))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            sync_free_loss = metrics["loss"].item()
            if profile and not enabled:
                profile_device(f"SynthMorph recipe step at {SYNTH_HALF} (cuDNN, bfloat16)",
                               lambda: trainer.train_step(pairs[0], (zero,))["loss"].item(),
                               rows=30)
        median_s = float(np.median(step_s[1:]))
        log(f"12c bfloat16 steps, {mode}, bs1, {SYNTH_HALF}: losses " + ", ".join(
            f"{x:.6f}" for x in losses_) + "; " + ", ".join(f"{x:.4f}" for x in step_s)
            + f" s/step (median after the first {median_s:.4f}); peak memory allocated "
            f"{peak:.3f} GiB; launches of the last step {counts}; a step under "
            f"set_sync_debug_mode('error') ran with no host sync (loss {sync_free_loss:.6f}); "
            f"{smi}")
        if not all(np.isfinite([*losses_, sync_free_loss])):
            raise AssertionError(f"12c: non-finite losses ({mode}): {losses_}")
        if enabled and not counts["conv"]:
            raise AssertionError("12c: no conv-kernel launch in a conv-kernel step")
        steps[enabled] = dict(step_s=median_s, peak_gib=peak, launches=counts)
        del trainer

    # fit_cached_labels' dispatch of 4 steps against 4 single steps of the
    # cached generator on the same picks, flips and synthesis draws, every
    # warp bounded (SYNTH_DISPATCH_HALO)
    host_maps = [m.cpu().numpy() for m in maps]
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    params, fetches = {}, {}
    try:
        with window_halo(str(SYNTH_DISPATCH_HALO)):
            for name in ("single", "dispatch"):
                trainer = Trainer(load_model(str(SYNTH_CHECKPOINT), device="cuda"),
                                  synth_recipe_terms(), lr=1e-4, device="cuda")
                reset_launches()
                t0 = time.perf_counter()
                if name == "dispatch":
                    trainer.fit_cached_labels(host_maps, epochs=1,
                                              steps_per_epoch=DISPATCH_STEPS,
                                              steps_per_dispatch=DISPATCH_STEPS, start_step=1,
                                              log_fn=lambda _: None)
                else:
                    stream = device_cached_label_generator(host_maps, start_step=1,
                                                           device="cuda")
                    for _ in range(DISPATCH_STEPS):
                        trainer.train_step(*next(stream))
                torch.cuda.synchronize()
                dispatch_s = time.perf_counter() - t0
                counts = read_launches()
                fetches[name] = trainer.metric_fetches
                params[name] = {n: p.detach().clone()
                                for n, p in trainer.model.named_parameters()}
                del trainer
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    if conditioning:
        # two runs of the same single steps at the default halo
        saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            again = []
            for _ in range(2):
                trainer = Trainer(load_model(str(SYNTH_CHECKPOINT), device="cuda"),
                                  synth_recipe_terms(), lr=1e-4, device="cuda")
                stream = device_cached_label_generator(host_maps, start_step=1, device="cuda")
                for _ in range(DISPATCH_STEPS):
                    trainer.train_step(*next(stream))
                again.append({n: p.detach().clone() for n, p in trainer.model.named_parameters()})
                del trainer
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        log(f"12c conditioning: two runs of the same {DISPATCH_STEPS} single steps at the "
            f"default halo differ by up to " + "{:.3e}".format(max(
                ((again[0][n] - p).abs().max() / p.abs().max()).item()
                for n, p in again[1].items())) + " of a tensor's largest magnitude")
    equal = all(torch.equal(params["single"][n], p) for n, p in params["dispatch"].items())
    worst = max(((params["single"][n] - p).abs().max() / p.abs().max()).item()
                for n, p in params["dispatch"].items())
    log(f"12c fit_cached_labels, {DISPATCH_STEPS} steps in one dispatch against single steps, "
        f"VXM_WINDOW_HALO={SYNTH_DISPATCH_HALO}: "
        f"params bit-equal {equal} (cudnn.deterministic), largest difference {worst:.3e} of a "
        f"tensor's largest magnitude (tol {DISPATCH_RTOL}); metric fetches {fetches}; "
        f"{dispatch_s:.2f} s for the dispatch; its launches {counts}")
    if not equal or fetches["dispatch"] != 1:
        raise AssertionError("12c: the dispatch differs from single steps")
    check_warp_work(counts, "12c the dispatch")
    return dict(step_s=steps[False]["step_s"], peak_gib=steps[False]["peak_gib"],
                conv_step_s=steps[True]["step_s"], conv_peak_gib=steps[True]["peak_gib"],
                launches=steps[False]["launches"], conv_launches=steps[True]["launches"],
                dispatch_bit_equal=equal, kernel_vs_cudnn_rel=kernel_vs_cudnn,
                gpu_vs_cpu_rel=card_vs_cpu_rel)


def synth_fullres(smi, profile):
    """Phase 12d: the checkpoint's architecture from seed 0 at INSHAPE (46
    labels in, 30 out, bfloat16, shared_contrast 0.5, its recipe): one
    float32 step's loss and gradients with the conv kernel against cuDNN
    (TF32 off) on the same draws, then three bfloat16 steps in each conv
    mode: s per step, peak memory, each tiered warp one branch."""
    base = synth_labels()
    cfg = synth_config(INSHAPE, SYNTH_OUT_LABELS, base)
    maps = synth_label_maps(INSHAPE, 2, base.in_label_list, "cuda")
    pair = (maps[0][None, ..., None], maps[1][None, ..., None])
    zero = torch.zeros(1, device="cuda")

    def make_model(device, dtype=torch.bfloat16):
        return SynthMorphDense(cfg, nb_unet_features=[[64] * 4, [64] * 6], int_steps=5,
                               int_resolution=2, svf_resolution=2, dtype=dtype,
                               shared_contrast=0.5,
                               generator=torch.Generator().manual_seed(SEED)).to(device)

    draws = make_model("cpu").draw(torch.Generator(device="cuda").manual_seed(SEED + 4), 1,
                                   "cuda")
    runs = {}
    with full_float32():
        for enabled in (False, True):
            t0 = time.perf_counter()
            runs[enabled] = synth_step_grads(
                "cuda", draws, pair, enabled,
                make_model=lambda device: make_model(device, torch.float32))
            log(f"12d float32 step at {INSHAPE} ({'conv kernel' if enabled else 'cuDNN'}): "
                f"{time.perf_counter() - t0:.2f} s; launches {runs[enabled][2]}")
            check_warp_work(runs[enabled][2], f"12d float32 step, conv kernel {enabled}")
    if runs[True][2]["conv"] != TRAIN_STEP_SYNTH_CONVS or runs[False][2]["conv"]:
        raise AssertionError(f"12d: conv launches {runs[True][2]['conv']} and "
                             f"{runs[False][2]['conv']}, expected {TRAIN_STEP_SYNTH_CONVS} and 0")
    kernel_vs_cudnn = compare_grads(f"12d conv kernel vs cuDNN, float32, {INSHAPE}",
                                    *runs[True][:2], *runs[False][:2],
                                    TRAIN_CONV_KERNEL_VS_CUDNN_RTOL)
    del runs, draws
    out = {}
    for enabled in (False, True):
        mode = "conv kernel" if enabled else "cuDNN"
        with conv_kernel_mode(enabled):
            model = make_model("cpu")
            trainer = Trainer(model, synth_recipe_terms(), lr=1e-4, device="cuda")
            torch.cuda.reset_peak_memory_stats()
            losses_, step_s, counts = [], [], None
            for i in range(3):
                reset_launches()
                t0 = time.perf_counter()
                losses_.append(trainer.train_step(pair, (zero,))["loss"].item())
                step_s.append(time.perf_counter() - t0)
                counts = read_launches()
                check_warp_work(counts, f"12d step {i}, {mode}")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if profile:
                profile_device(f"SynthMorph full-resolution train step ({mode}, bfloat16)",
                               lambda: trainer.train_step(pair, (zero,))["loss"].item(), rows=30)
        median_s = float(np.median(step_s[1:]))
        log(f"12d bfloat16 steps, {mode}, bs1, {INSHAPE}, {cfg.nb_in_labels} labels in, "
            f"{cfg.nb_out_labels} out: losses " + ", ".join(f"{x:.6f}" for x in losses_) + "; "
            + ", ".join(f"{x:.4f}" for x in step_s) + f" s/step (median after the first "
            f"{median_s:.4f}); peak memory allocated {peak:.3f} GiB; launches of the last step "
            f"{counts}; {smi}")
        if not all(np.isfinite(losses_)) or (enabled and not counts["conv"]):
            raise AssertionError(f"12d: bad full-resolution steps ({mode})")
        out[enabled] = dict(step_s=median_s, peak_gib=peak, launches=counts)
        del trainer, model
    out[True]["kernel_vs_cudnn_rel"] = kernel_vs_cudnn
    return out


def synth_clis(smi):
    """Phase 12e: cli/train_synthmorph --cache-device --steps-per-dispatch 4
    --init-weights the committed checkpoint on 4 label maps at 80x96x112
    padded to INSHAPE (--out-shape) for one epoch, then cli/register and
    cli/test of the checkpoint it wrote on the labelled pair at INSHAPE."""
    base = synth_labels()
    maps = synth_label_maps(SYNTH_HALF, 4, base.in_label_list, "cpu")
    moving, fixed, src_lab, trg_lab = labelled_pair(INSHAPE, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/maps")
        for i, lab in enumerate(maps):
            np.save(f"{tmp}/maps/map{i}.npy", lab.numpy())
        reset_launches()
        t0 = time.perf_counter()
        trainer = synth_train_cli.main([
            "--label-dir", f"{tmp}/maps", "--model-dir", f"{tmp}/run", "--cache-device",
            "--steps-per-dispatch", str(DISPATCH_STEPS), "--steps-per-epoch",
            str(DISPATCH_STEPS), "--epochs", "1", "--init-weights", str(SYNTH_CHECKPOINT),
            "--dtype", "bfloat16", "--shared-contrast", "0.5", "--image-loss-weight",
            str(SYNTH_IMAGE_LOSS_WEIGHT), "--out-shape", *map(str, INSHAPE), "--device", "cuda"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = read_launches()
        fetches = trainer.metric_fetches
        del trainer
        check_warp_work(counts, "12e cli/train_synthmorph's dispatch")
        log(f"12e cli/train_synthmorph, {DISPATCH_STEPS} steps in one dispatch, maps at "
            f"{SYNTH_HALF} padded to {INSHAPE}: {train_s:.2f} s in all (two checkpoints); "
            f"metric fetches {fetches}; launches {counts}")
        if fetches != 1:
            raise AssertionError(f"12e: {fetches} metric fetches for one dispatch")

        for name, vol, lab in (("moving", moving, src_lab), ("fixed", fixed, trg_lab)):
            np.savez(f"{tmp}/{name}.npz", vol=vol[0, ..., 0].numpy(), seg=lab.numpy())
        Path(f"{tmp}/pairs.txt").write_text(f"{tmp}/moving.npz {tmp}/fixed.npz\n")
        written = f"{tmp}/run/00001.npz"
        t0 = time.perf_counter()
        register_cli.main(["--moving", f"{tmp}/moving.npz", "--fixed", f"{tmp}/fixed.npz",
                           "--model", written, "--moved", f"{tmp}/moved.nii",
                           "--warp", f"{tmp}/warp.nii", "--device", "cuda"])
        register_s = time.perf_counter() - t0
        warp = torch.from_numpy(load_volfile(f"{tmp}/warp.nii")).cuda()
        carried = warp_ops.transform(src_lab.cuda().float(), warp, interp_method="nearest",
                                     window_halo=None).cpu().numpy()
        register_dice = float(np.mean(dice(carried, trg_lab.numpy())))
        log(f"12e cli/register at {INSHAPE}: {register_s:.2f} s; max|warp| "
            f"{warp.abs().max().item():.3f} voxels; Dice of the labels carried by its warp "
            f"{register_dice:.4f} (unregistered "
            f"{np.mean(dice(src_lab.numpy(), trg_lab.numpy())):.4f})")
        t0 = time.perf_counter()
        scores = test_cli.main(["--model", written, "--pairs", f"{tmp}/pairs.txt",
                                "--img-suffix", "", "--seg-prefix", "", "--device", "cuda"])
        test_s = time.perf_counter() - t0
    log(f"12e cli/test: Dice {scores[0]:.4f}, {test_s:.2f} s; {smi}")
    if abs(scores[0] - register_dice) > 1e-4:
        raise AssertionError(f"12e: cli/test's Dice {scores[0]} differs from cli/register's "
                             f"{register_dice}")
    return dict(launches=counts, register_dice=register_dice, test_dice=float(scores[0]),
                cli_s=dict(train=train_s, register=register_s, test=test_s))


# Phase 13: SynthMorph's joint affine and deformable model. Its defaults
# (voxelmorph_tpu/models/synthmorph.py:524-550) are its full width; 13c's
# cut widths keep a CPU run at 160x192x224 to seconds.
JOINT_HYPER = 0.5
JOINT_CLI_HYPER = 0.3
JOINT_CUT = dict(hyp_units=(8,), enc_nf=(16,) * 4, dec_nf=(16,) * 4, add_nf=(16,) * 4,
                 aff_num_feat=16, aff_enc_nf=(16,) * 4)
# bfloat16 against float32 on the card: max|tot_1 diff| as a share of
# max|tot_1|. Set from the fit's conditioning, not from a run: bfloat16
# rounds the detector's features, which moves their barycenters by a
# fraction of a voxel, and the least-squares fit of a seeded init's
# clustered landmarks passes that on to the affine (13a logs the change
# of aff_1) and from it to every voxel of tot_1
JOINT_BF16_RTOL = 0.25
# 13b: the detector's aff_1 for one image on both sides, against the
# identity (as tests/test_synthmorph.py holds it on the CPU)
JOINT_IDENTITY_TOL = 1e-2
# 13c: the card against the CPU in float32 (TF32 off): tot_1 within this
# share of max|tot_1| (the CPU tests hold the port to JAX within 1e-5; the
# fit passes the card's other summation orders on, amplified), the moved
# image within IMAGE_TOL
JOINT_GPU_CPU_RTOL = 1e-3
# 13c's pair is smooth_pair with a zero background this many voxels deep
# at each face, ramping to the image over as many again, as a
# skull-stripped scan's. The affine stage samples the images with zero
# fill, which is discontinuous at the field of view's edge: there a
# sample's move of 1e-4 voxels (the fit's round-off) can switch it between
# the fill and the image, and the deformable stage's SVF with it, unless
# the image is zero there too (--conditioning prints how far 1 + 1e-7
# noise moves the SVF with and without the mask)
JOINT_EDGE = 8


def joint_counts(label, fn):
    """The work counters of one call of ``fn``, gated as every serving
    path's: a bounded kernel ran and each tiered warp ran one branch."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = read_launches()
    check_warp_work(counts, label, backward=False)
    return out, counts


def joint_outputs_ok(label, out, moved):
    """Fail unless the joint model's outputs have their shapes, are
    finite, and svf_2 is -svf_1 bit for bit."""
    half = tuple(s // 2 for s in INSHAPE)
    shapes = {"tot_1": (1, *INSHAPE, 3), "svf_1": (1, *half, 3), "def_1": (1, *half, 3)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{label}: {key} of shape {tuple(out[key].shape)}")
    if tuple(moved.shape) != (1, *INSHAPE, 1):
        raise AssertionError(f"{label}: moved of shape {tuple(moved.shape)}")
    if not all(torch.isfinite(t).all() for t in (*out.values(), moved)):
        raise AssertionError(f"{label}: non-finite output")
    if not torch.equal(out["svf_2"], -out["svf_1"]):
        raise AssertionError(f"{label}: svf_2 is not -svf_1")


def joint_call(label, model, hyp, moving, fixed):
    """The model's outputs, then one build_joint_register_fn call's moved
    image and warp with its work counters (gated); the call's warp must be
    the outputs' tot_1, bit for bit. Returns (out, moved, warp, counts)."""
    with torch.inference_mode():
        out = model(hyp, moving, fixed)
    register = registration.build_joint_register_fn(model)
    (moved, warp), counts = joint_counts(label, lambda: register(hyp, moving, fixed))
    joint_outputs_ok(label, out, moved)
    if not torch.equal(warp, out["tot_1"]):
        raise AssertionError(f"{label}: two calls differ")
    return out, moved, warp, counts


def joint_full_width(smi, profile):
    """Phase 13a-b: HyperVxmJoint at its defaults (full width) at INSHAPE,
    its ~890 M parameters drawn on the card from a CUDA generator seeded
    SEED, registers smooth_pair at JOINT_HYPER through
    build_joint_register_fn, in float32 (TF32 off) and in bfloat16: shapes,
    finite outputs, svf_2 == -svf_1, two calls bit-equal
    (cudnn.deterministic), the work counters (bounded kernels in the
    integration, one branch a tiered warp), bfloat16 against float32, no
    host sync (set_sync_debug_mode("error")) and no conv-kernel launch with
    set_pallas_conv(True), the outputs unchanged; ms per pair (host clock,
    5 calls after a warm-up) and peak memory of each. 13b: the detector's
    aff_1 for the moving image on both sides is the identity."""
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    hyp = torch.full((1, 1), JOINT_HYPER, device="cuda")
    t0 = time.perf_counter()
    model = HyperVxmJoint(INSHAPE, generator=torch.Generator("cuda").manual_seed(SEED)).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"HyperVxmJoint {INSHAPE} at its defaults: {n_params} parameters "
        f"({n_params * 4 / 2 ** 30:.3f} GiB in float32), drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    register = registration.build_joint_register_fn(model)
    results = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with full_float32():
            out, moved, warp, counts = joint_call("13a float32", model, hyp, moving, fixed)
            f32 = dict(moved=moved, warp=warp, counts=counts, aff_1=out["aff_1"])
            torch.cuda.reset_peak_memory_stats()
            ms = wall_ms(lambda: register(hyp, moving, fixed), reps=5)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"13a float32 (TF32 off): {ms:.2f} ms per pair, peak {peak:.3f} GiB; max|tot_1| "
            f"{warp.abs().max().item():.4f} voxels, max|svf_1| "
            f"{out['svf_1'].abs().max().item():.4f}; mean|moved - fixed| "
            f"{(moved - fixed).abs().mean().item():.5f} (before "
            f"{(moving - fixed).abs().mean().item():.5f}); launches {f32['counts']}; {smi}")
        results["float32"] = dict(ms_per_pair=ms, peak_gib=peak)
        del out

        # 13b: one image on both sides; the detector's fit is the identity
        ima = torch.stack([warp_ops.transform(m, _scale_matrix(2.0, 3, "cuda"),
                                              fill_value=0.0, shift_center=False,
                                              shape=tuple(s // 2 for s in INSHAPE))
                           for m in moving])
        with full_float32(), torch.inference_mode():
            aff = model.affine(ima, ima)["aff_1"][0]
        eye = torch.eye(3, 4, device="cuda")
        identity_err = (aff - eye).abs().max().item()
        log(f"13b the detector on one image both sides: max|aff_1 - I| {identity_err:.3e} "
            f"(tol {JOINT_IDENTITY_TOL})")
        if not identity_err <= JOINT_IDENTITY_TOL:
            raise AssertionError("13b: the detector's fit of an image to itself is not I")

        # the same weights in a bfloat16 model, built on the card
        bf16 = HyperVxmJoint(INSHAPE, dtype=torch.bfloat16,
                             generator=torch.Generator("cuda")).eval()
        bf16.load_state_dict(model.state_dict())
        del model, register
        out, moved, warp, counts = joint_call("13a bfloat16", bf16, hyp, moving, fixed)
        aff_diff = (out["aff_1"] - f32["aff_1"]).abs().max().item()
        del out
        register = registration.build_joint_register_fn(bf16)
        rel = (warp - f32["warp"]).abs().max().item() / f32["warp"].abs().max().item()
        image_diff = (moved - f32["moved"]).abs().max().item()
        log(f"13a bfloat16 vs float32: max|aff_1 diff| {aff_diff:.3e}, max|tot_1 diff| / "
            f"max|tot_1| {rel:.3e} (tol {JOINT_BF16_RTOL}), moved max abs diff "
            f"{image_diff:.3e}")
        if not rel <= JOINT_BF16_RTOL:
            raise AssertionError("13a: the bfloat16 joint warp is too far from float32's")
        register(hyp, moving, fixed)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            synced = register(hyp, moving, fixed)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not torch.equal(synced[1], warp):
            raise AssertionError("13a: the bfloat16 call under sync debug changed the warp")
        with conv_kernel_mode(True):
            reset_launches()
            kernel_mode = register(hyp, moving, fixed)
            torch.cuda.synchronize()
            conv_counts = read_launches()
        same = all(torch.equal(a, b) for a, b in zip(kernel_mode, (moved, warp)))
        log(f"13a bfloat16: no host sync under set_sync_debug_mode('error'); with "
            f"set_pallas_conv(True): conv launches {conv_counts['conv']}, outputs bit-equal "
            f"{same}")
        if conv_counts["conv"] or not same:
            raise AssertionError("13a: the joint model took the conv kernel, or its output "
                                 "changed")
        torch.cuda.reset_peak_memory_stats()
        ms = wall_ms(lambda: register(hyp, moving, fixed), reps=5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"13a bfloat16: {ms:.2f} ms per pair, peak {peak:.3f} GiB; launches {counts}; {smi}")
        results["bfloat16"] = dict(ms_per_pair=ms, peak_gib=peak)
        if profile:
            profile_device("HyperVxmJoint register call, bfloat16",
                           lambda: register(hyp, moving, fixed), rows=20)
    finally:
        torch.backends.cudnn.deterministic = saved
    return dict(launches=f32["counts"], params=n_params, bf16_vs_f32_rtol=rel,
                bf16_vs_f32_aff=aff_diff, identity_err=identity_err, **results)


def joint_cut_model():
    """13c's model: HyperVxmJoint at INSHAPE with JOINT_CUT's widths, drawn
    on the card from seed SEED."""
    return HyperVxmJoint(INSHAPE, **JOINT_CUT,
                         generator=torch.Generator("cuda").manual_seed(SEED)).eval()


def edge_masked(image, depth=JOINT_EDGE):
    """``image`` ``(B, *S, C)`` times a mask that is zero within ``depth``
    voxels of each face and rises linearly to 1 over ``depth`` more."""
    out = image
    for axis, size in enumerate(image.shape[1:-1]):
        x = torch.arange(size, dtype=image.dtype, device=image.device)
        ramp = ((torch.minimum(x, size - 1 - x) - depth) / depth).clamp(0.0, 1.0)
        shape = [1] * image.dim()
        shape[axis + 1] = size
        out = out * ramp.view(shape)
    return out


def joint_conditioning(model, hyp, masked):
    """The reading behind JOINT_EDGE: the model on the card, float32, run
    twice on smooth_pair, the moving image scaled by 1 + 1e-7 noise the
    second time, unmasked and ``masked``; how far svf_1 and tot_1 move."""
    unmasked = smooth_pair(INSHAPE, "cuda")
    noise = 1 + 1e-7 * torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(
        unmasked[0].shape, dtype=np.float32)).cuda()
    for name, (moving, fixed) in (("unmasked", unmasked), ("masked", masked)):
        with full_float32(), torch.inference_mode():
            a, b = model(hyp, moving, fixed), model(hyp, moving * noise, fixed)
        log(f"13c --conditioning, the {name} pair twice, 1 + 1e-7 apart: " + ", ".join(
            f"max|{k} diff| {(a[k] - b[k]).abs().max().item():.3e} of "
            f"{a[k].abs().max().item():.4f}" for k in ("aff_1", "svf_1", "tot_1")))


def joint_vs_cpu_and_clis(smi, conditioning=False):
    """Phase 13c: JOINT_CUT's model at INSHAPE on the card against the same
    weights on the CPU, float32 (TF32 off), on smooth_pair edge_masked
    (JOINT_EDGE): tot_1 and the moved image (with ``conditioning``, also
    joint_conditioning). 13d:
    that model saved with save_model, then cli/register --hyper
    JOINT_CLI_HYPER (moved and warp written) and cli/test on labelled_pair
    (its Voronoi labels), whose Dice must be that of
    build_eval_register_fn's outputs."""
    model = joint_cut_model()
    moving, fixed = (edge_masked(x) for x in smooth_pair(INSHAPE, "cuda"))
    hyp = torch.full((1, 1), JOINT_HYPER, device="cuda")
    with full_float32():
        card, _ = joint_counts("13c register call",
                               lambda: registration.build_joint_register_fn(model)(
                                   hyp, moving, fixed))
    cpu_model = HyperVxmJoint(INSHAPE, **JOINT_CUT).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    cpu = registration.build_joint_register_fn(cpu_model)(hyp.cpu(), moving.cpu(), fixed.cpu())
    cpu_s = time.perf_counter() - t0
    scale = cpu[1].abs().max().item()
    warp_err = (card[1].cpu() - cpu[1]).abs().max().item()
    image_err = (card[0].cpu() - cpu[0]).abs().max().item()
    log(f"13c card vs CPU, {JOINT_CUT}, float32: max|tot_1 diff| {warp_err:.3e} (tol "
        f"{JOINT_GPU_CPU_RTOL} x max|tot_1| {scale:.4f}); moved max abs err {image_err:.3e} "
        f"(tol {IMAGE_TOL}); CPU call {cpu_s:.2f} s")
    if not (warp_err <= JOINT_GPU_CPU_RTOL * scale and image_err <= IMAGE_TOL):
        raise AssertionError("13c: the joint model on the card disagrees with the CPU")
    del cpu_model
    if conditioning:
        joint_conditioning(model, hyp, (moving, fixed))

    moving_c, fixed_c, src_lab, trg_lab = labelled_pair(INSHAPE, "cpu")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = f"{tmp}/joint.npz"
            save_model(ckpt, model)
            for name, vol, lab in (("moving", moving_c, src_lab), ("fixed", fixed_c, trg_lab)):
                np.savez(f"{tmp}/{name}.npz", vol=vol[0, ..., 0].numpy(), seg=lab.numpy())
            Path(f"{tmp}/pairs.txt").write_text(f"{tmp}/moving.npz {tmp}/fixed.npz\n")
            t0 = time.perf_counter()
            register_cli.main(["--moving", f"{tmp}/moving.npz", "--fixed", f"{tmp}/fixed.npz",
                               "--model", ckpt, "--moved", f"{tmp}/moved.nii",
                               "--warp", f"{tmp}/warp.nii", "--hyper", str(JOINT_CLI_HYPER),
                               "--device", "cuda"])
            register_s = time.perf_counter() - t0
            moved = load_volfile(f"{tmp}/moved.nii")
            warp = load_volfile(f"{tmp}/warp.nii")
            if moved.shape != INSHAPE or warp.shape != (*INSHAPE, 3) or not (
                    np.isfinite(moved).all() and np.isfinite(warp).all()):
                raise AssertionError(f"13d cli/register wrote {moved.shape}, {warp.shape}")
            t0 = time.perf_counter()
            scores = test_cli.main(["--model", ckpt, "--pairs", f"{tmp}/pairs.txt",
                                    "--img-suffix", "", "--seg-prefix", "", "--hyper",
                                    str(JOINT_CLI_HYPER), "--device", "cuda"])
            test_s = time.perf_counter() - t0
            loaded = load_model(ckpt, device="cuda")
            reset_launches()
            _, _, carried = registration.build_eval_register_fn(loaded, hyper=JOINT_CLI_HYPER)(
                moving_c.cuda(), fixed_c.cuda(), src_lab.cuda().float()[None, ..., None])
            torch.cuda.synchronize()
            counts = read_launches()
            check_warp_work(counts, "13d build_eval_register_fn", backward=False)
            eval_dice = float(np.mean(dice(carried.cpu().numpy().squeeze(), trg_lab.numpy())))
    finally:
        torch.backends.cudnn.deterministic = saved
    log(f"13d cli/register --hyper {JOINT_CLI_HYPER}: {register_s:.2f} s, max|warp| "
        f"{np.abs(warp).max():.3f} voxels; cli/test Dice {scores[0]:.6f} ({test_s:.2f} s), "
        f"build_eval_register_fn's {eval_dice:.6f} (unregistered "
        f"{np.mean(dice(src_lab.numpy(), trg_lab.numpy())):.4f}); {smi}")
    if scores[0] != eval_dice:
        raise AssertionError("13d: cli/test's Dice differs from build_eval_register_fn's")
    return dict(gpu_vs_cpu=[warp_err, image_err], cpu_s=cpu_s, test_dice=float(scores[0]),
                cli_s=dict(register=register_s, test=test_s), eval_launches=counts)



# data parallelism (phase 14): the steps of each run, the tolerance of the
# two-process step against one process at batch 2 (JAX's own DP-vs-single
# bound, tests/test_sharding.py: rtol 1e-4, atol 1e-6 on the updated params;
# the gradients within DP_GRAD_RTOL of each tensor's largest magnitude), and
# how long the spawned ranks may take
DP_STEPS = 3
DP_RTOL, DP_ATOL = 1e-4, 1e-6
DP_GRAD_RTOL = 1e-4
DP_RANK_TIMEOUT_S = 300


def dp_batch(moving, fixed, batch):
    """Phase 4's recipe's inputs and targets at ``batch``: the pair, then
    the pair swapped, in turns."""
    pairs = ([(moving, fixed), (fixed, moving)] * batch)[:batch]
    src = torch.cat([p[0] for p in pairs])
    trg = torch.cat([p[1] for p in pairs])
    return (src, trg), (trg, torch.zeros((batch, *INSHAPE, 3), device=moving.device))


@contextlib.contextmanager
def deterministic_cudnn():
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def timed_steps(trainer, inputs, targets, steps, label):
    """``steps`` train steps, each timed to its loss's read and its work
    counters gated; returns the losses, seconds and launches of each."""
    losses_, step_s, counts = [], [], []
    for step in range(steps):
        reset_launches()
        t0 = time.perf_counter()
        losses_.append(trainer.train_step(inputs, targets)["loss"].item())  # synchronises
        step_s.append(time.perf_counter() - t0)
        counts.append(read_launches())
        check_warp_work(counts[-1], f"{label}, step {step}")
    return losses_, step_s, counts


def dp_one_rank(smi, phase4_s):
    """Phase 14a: the Trainer over an NCCL process group of one rank
    (file:// store), phase 4's recipe at full width: DP_STEPS steps bit-equal
    to the Trainer without a process group on the same batches
    (cudnn.deterministic), a step under set_sync_debug_mode("error"), and a
    conv-kernel step. Returns the launch counts of a step and the times."""
    import torch.distributed as dist
    from voxelmorph_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    inputs, targets = dp_batch(moving, fixed, 1)
    runs = {}
    with deterministic_cudnn(), tempfile.TemporaryDirectory() as tmp:
        model, terms = default_recipe(INSHAPE)
        trainer = Trainer(model, terms, lr=1e-4, device="cuda")
        runs["plain"] = timed_steps(trainer, inputs, targets, DP_STEPS, "14a, no process group")
        plain = {n: p.detach().clone() for n, p in model.named_parameters()}
        del trainer, model
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            model, terms = default_recipe(INSHAPE)
            trainer = Trainer(model, terms, lr=1e-4, device="cuda",
                              mesh=mesh_lib.make_mesh_for_batch(1))
            torch.cuda.reset_peak_memory_stats()
            runs["mesh"] = timed_steps(trainer, inputs, targets, DP_STEPS, "14a, one NCCL rank")
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            equal = all(torch.equal(plain[n], p) for n, p in model.named_parameters())
            torch.cuda.synchronize()
            reset_launches()
            torch.cuda.set_sync_debug_mode("error")
            try:
                metrics = trainer.train_step(inputs, targets)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            sync_free = read_launches()
            check_warp_work(sync_free, "14a, the sync-free step")
            loss = metrics["loss"].item()
            with conv_kernel_mode(True):
                conv = timed_steps(trainer, inputs, targets, 2, "14a, conv kernel")
            world = (dist.get_backend(), dist.get_world_size(), dict(trainer.mesh.shape),
                     trainer.ddp is None)
        finally:
            dist.destroy_process_group()
    mesh_s = float(np.median(runs["mesh"][1][1:]))
    plain_s = float(np.median(runs["plain"][1][1:]))
    log(f"14a: {world[0]} world of {world[1]}, mesh {world[2]}, no DDP wrapper {world[3]}; "
        f"losses {runs['mesh'][0]} against {runs['plain'][0]} without a process group: "
        f"params after {DP_STEPS} steps bit-equal {equal} (cudnn.deterministic)")
    log(f"14a: float32 step, bs1, {INSHAPE}: {mesh_s:.4f} s/step over one NCCL rank, "
        f"{plain_s:.4f} without a process group (both cudnn.deterministic; median after the "
        f"first), phase 4's {phase4_s:.4f}; peak memory allocated {peak_gb:.3f} GiB; "
        f"the sync-free step's loss {loss:.8f}, launches {sync_free}; conv kernel steps "
        + ", ".join(f"{x:.4f}" for x in conv[1]) + f" s, launches {conv[2][-1]}; {smi}")
    if not equal:
        raise AssertionError("14a: the steps over one NCCL rank differ from the plain Trainer's")
    if not (world[1] == 1 and world[2] == {"data": 1, "space": 1} and world[3]):
        raise AssertionError(f"14a: the world, mesh or wrapper is not one rank's: {world}")
    if any(c["conv"] != TRAIN_STEP_CONVS or c["layout_copies"] for c in conv[2]):
        raise AssertionError(f"14a: a conv-kernel step missed a kernel: {conv[2]}")
    if not all(np.isfinite(runs["mesh"][0] + conv[0] + [loss])):
        raise AssertionError("14a: a non-finite loss")
    return dict(launches=runs["mesh"][2][-1], conv_launches=conv[2][-1], s_per_step=mesh_s,
                plain_s_per_step=plain_s, conv_s_per_step=conv[1][-1], peak_gib=peak_gb)


def dp_rank(rank, tmp):
    """A rank of phase 14b (``chip_smoke.py --dp-rank R --dp-dir DIR``): one
    step of phase 4's recipe on its row of a global batch of 2, the two
    processes sharing the one card over gloo, the gradients averaged by the
    Trainer's DistributedDataParallel; writes its params, gradients, loss
    and launches to DIR/rank{R}.pt."""
    import torch.distributed as dist
    from voxelmorph_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh_lib.initialize_distributed(f"file://{tmp}/store", 2, rank, "cpu")
    try:
        with deterministic_cudnn():
            moving, fixed = smooth_pair(INSHAPE, "cuda")
            model, terms = default_recipe(INSHAPE)
            trainer = Trainer(model, terms, lr=1e-4, device="cuda")
            reset_launches()
            loss = trainer.train_step(*dp_batch(moving, fixed, 2))["loss"].item()
            counts = read_launches()
        torch.save(dict(loss=loss, launches=counts, mesh=dict(trainer.mesh.shape),
                        ddp=type(trainer.ddp).__name__, backend=dist.get_backend(),
                        params={n: p.detach().cpu() for n, p in model.named_parameters()},
                        grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()}),
                   os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dp_two_ranks(smi):
    """Phase 14b: two processes on the one card over gloo (a global batch of
    2, a row each) against one process at batch 2 on the card: the loss,
    the averaged gradients and the updated params, and the two ranks'
    params equal. Returns rank 0's launches."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-rank",
                                   str(r), "--dp-dir", tmp], cwd=ROOT,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=DP_RANK_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        ranks_s = time.perf_counter() - t0
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"14b: rank {r} exited with {p.returncode}:\n{out}")
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    with deterministic_cudnn():
        moving, fixed = smooth_pair(INSHAPE, "cuda")
        model, terms = default_recipe(INSHAPE)
        trainer = Trainer(model, terms, lr=1e-4, device="cuda")
        start = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        loss = trainer.train_step(*dp_batch(moving, fixed, 2))["loss"].item()
        ref = {n: p.detach().cpu() for n, p in model.named_parameters()}
        ref_grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        del trainer, model
    two = got[0]
    replicas = all(torch.equal(two["params"][n], got[1]["params"][n]) for n in ref)
    grad_rel = max(((two["grads"][n] - g).abs().max() / g.abs().max()).item()
                   for n, g in ref_grads.items())
    # Adam's first step moves each parameter by lr * sign(gradient): an
    # element whose gradient is within the runs' gap of zero may step
    # either way
    outside, undetermined, worst = 0, 0, 0.0
    for n, p in ref.items():
        share = (two["params"][n] - p).abs() / (DP_ATOL + DP_RTOL * p.abs())
        gap = (two["grads"][n] - ref_grads[n]).abs().max()
        free = (torch.sign(two["grads"][n]) != torch.sign(ref_grads[n])) & (
            ref_grads[n].abs() <= gap)
        outside += int((share > 1).sum())
        undetermined += int(((share > 1) & free).sum())
        worst = max(worst, share.masked_fill(free, 0).max().item())
    moved = max((ref[n] - start[n]).abs().max().item() for n in ref)
    log(f"14b: two processes on one card ({two['backend']}, {two['ddp']}, mesh {two['mesh']}), "
        f"{ranks_s:.2f} s for both to start, step and write; loss {two['loss']:.8f} against "
        f"{loss:.8f} in one process at batch 2; gradients within {grad_rel:.3e} of each "
        f"tensor's max (tol {DP_GRAD_RTOL}); updated params: {outside} elements outside rtol "
        f"{DP_RTOL}, atol {DP_ATOL}, of which {undetermined} have gradients of opposite sign "
        f"within the runs' gap of zero; the rest at {worst:.3f} of the tolerance; the step "
        f"moved the params by up to {moved:.3e}; the ranks' params bit-equal {replicas}; "
        f"rank 0's launches {two['launches']}; {smi}")
    if two["mesh"] != {"data": 2, "space": 1} or two["ddp"] != "DistributedDataParallel":
        raise AssertionError(f"14b: not a two-way data-parallel step: {two['mesh']}")
    if not (abs(two["loss"] - loss) <= 1e-5 * abs(loss) and grad_rel <= DP_GRAD_RTOL):
        raise AssertionError("14b: the two-process step's loss or gradients differ")
    if outside != undetermined or not replicas or moved < 10 * DP_ATOL:
        raise AssertionError("14b: the updated params differ from one process's")
    check_warp_work(two["launches"], "14b, rank 0's step")
    return dict(launches=two["launches"], grad_rel=grad_rel, outside=outside,
                undetermined=undetermined, seconds=ranks_s)


# spatial sharding (phase 15): the steps of each run, and how long the
# spawned ranks may take
SP_STEPS = {"cudnn": 3, "conv": 2}
SP_RANK_TIMEOUT_S = 400
# phase 15c's steps of each run: the first is a warm-up, the median of the
# rest is its s per step
SP_NCCL_STEPS = 5


def sp_run(mesh, batch, steps, conv, moving, fixed):
    """``steps`` steps of phase 4's recipe at ``batch`` (dp_batch) with the
    Trainer over ``mesh`` (None: one process), cudnn.deterministic, in
    conv-kernel mode with ``conv``: each step's loss, gradients, seconds and
    launches, the params and Adam state before it, the params after the
    steps and the peak memory."""
    inputs, targets = dp_batch(moving, fixed, batch)
    with deterministic_cudnn(), conv_kernel_mode(conv):
        model, terms = default_recipe(INSHAPE)
        trainer = Trainer(model, terms, lr=1e-4, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer.init()
        out = dict(losses=[], grads=[], seconds=[], launches=[], before=[])
        for _ in range(steps):
            out["before"].append(({n: p.detach().cpu().clone()
                                   for n, p in model.named_parameters()},
                                  _cpu_tree(trainer.optimizer.state_dict())))
            reset_launches()
            t0 = time.perf_counter()
            out["losses"].append(trainer.train_step(inputs, targets)["loss"].item())
            out["seconds"].append(time.perf_counter() - t0)
            out["launches"].append(read_launches())
            out["grads"].append({n: p.grad.detach().cpu().clone()
                                 for n, p in model.named_parameters()})
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["params"] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        out["mesh"] = dict(trainer.mesh.shape)
    del trainer, model
    torch.cuda.empty_cache()
    return out


def sp_register(mesh, moving, fixed):
    """The committed bfloat16 checkpoint's register call on this rank's
    slabs (shard_batch(spatial=True)) inside mesh_lib.spatial: the moved
    image and warp, whole on every rank, and the call's launches."""
    from voxelmorph_tpu_torch.parallel import mesh as mesh_lib

    model = load_model(str(CHECKPOINT), device="cuda")
    src, trg = mesh_lib.shard_batch(mesh, (moving, fixed), spatial=True, device="cuda",
                                    align=model.slab_align)
    register = build_register_fn(model)
    # phase 3's settings: cuDNN's float32 convolutions (the flow head) in TF32
    torch.backends.cudnn.allow_tf32 = True
    with mesh_lib.spatial(mesh):
        register(src, trg)  # a first call, untimed
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        moved, warp = register(src, trg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = read_launches()
    check_warp_work(launches, "15a, the sharded register call", backward=False)
    return dict(moved=moved.cpu(), warp=warp.cpu(), launches=launches, seconds=seconds,
                slab=int(src.shape[1]))


def _cpu_tree(tree):
    """A copy of a nested dict or list of tensors, the tensors on the CPU."""
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu_tree(v) for v in tree]
    return tree.detach().cpu().clone() if isinstance(tree, torch.Tensor) else tree


def sp_replay(before, batch, conv, moving, fixed):
    """One process's step of phase 4's recipe from each state ``before`` (a
    sharded run's params and Adam state before each of its steps), as
    sp_run takes it: each step's loss, gradients and params after, to hold
    the sharded step to one process's step from the same state."""
    inputs, targets = dp_batch(moving, fixed, batch)
    with deterministic_cudnn(), conv_kernel_mode(conv):
        model, terms = default_recipe(INSHAPE)
        trainer = Trainer(model, terms, lr=1e-4, device="cuda")
        trainer.init()
        out = dict(losses=[], grads=[], after=[])
        for params, adam in before:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(params[n])
            trainer.optimizer.load_state_dict(adam)
            out["losses"].append(trainer.train_step(inputs, targets)["loss"].item())
            out["grads"].append({n: p.grad.detach().cpu().clone()
                                 for n, p in model.named_parameters()})
            out["after"].append({n: p.detach().cpu().clone() for n, p in model.named_parameters()})
    del trainer, model
    torch.cuda.empty_cache()
    return out


def sp_rank(rank, world, tmp, nccl=False):
    """A rank of phase 15 (``chip_smoke.py --sp-rank R --sp-world N
    --sp-dir DIR``), sharing the one card with the others over gloo: with 2
    ranks, phase 15a's runs on a (1, 2) mesh and the sharded register
    call; with 4, phase 15b's steps on (1, 4) and (2, 2) meshes. With
    ``nccl`` (``--sp-nccl``), on a card of its own over NCCL, phase 15c's
    runs on (1, N) and (N, 1). Writes its results to DIR/rank{R}.pt."""
    import torch.distributed as dist
    from voxelmorph_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh_lib.initialize_distributed(f"file://{tmp}/store", world, rank,
                                    "cuda" if nccl else "cpu")
    try:
        moving, fixed = smooth_pair(INSHAPE, "cuda")
        if nccl:
            space, data = mesh_lib.make_mesh((1, world)), mesh_lib.make_mesh((world, 1))
            out = {"spatial": sp_run(space, 1, SP_NCCL_STEPS, False, moving, fixed),
                   "spatial_conv": sp_run(space, 1, SP_NCCL_STEPS, True, moving, fixed),
                   "data": sp_run(data, world, SP_NCCL_STEPS, False, moving, fixed)}
        elif world == 2:
            mesh = mesh_lib.make_mesh((1, 2))
            out = {mode: sp_run(mesh, 1, n, mode == "conv", moving, fixed)
                   for mode, n in SP_STEPS.items()}
            out["register"] = sp_register(mesh, moving, fixed)
        else:
            out = {"row": sp_run(mesh_lib.make_mesh((1, 4)), 1, 1, False, moving, fixed),
                   "grid": sp_run(mesh_lib.make_mesh((2, 2)), 2, 1, False, moving, fixed)}
        out["backend"] = dist.get_backend()
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def sp_spawn(world, label, nccl=False):
    """Start ``world`` ranks of phase 15 (on the one card over gloo, or with
    ``nccl`` one per card) and wait for them; returns each rank's results
    and the seconds they took."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--sp-rank",
                                   str(r), "--sp-world", str(world), "--sp-dir", tmp]
                                  + ["--sp-nccl"] * nccl,
                                  cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for r in range(world)]
        try:
            outs = [p.communicate(timeout=SP_RANK_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        seconds = time.perf_counter() - t0
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"{label}: rank {r} exited with {p.returncode}:\n{out}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)], seconds


WORK_KEYS = ("fwd", "fwd_ran", "bwd", "bwd_ran", "gather_fwd", "gather_fwd_ran", "gather_bwd",
             "gather_bwd_ran", "conv")


def sp_hold(label, ranks_, ref, same, mesh, smi):
    """Hold each rank's run (sp_run) to one process. Each step to one
    process's step from the same params and Adam state (``same``,
    sp_replay): the loss within 1e-5, the gradients within DP_GRAD_RTOL of
    each tensor's max, the params after it within DP_RTOL/DP_ATOL wherever
    the two steps' gradients agree in sign or lie outside their gap of zero
    (as 14b holds them). The losses to one process's run of the same steps
    (``ref``) within 1e-5; every rank's params bit-equal to rank 0's; every
    rank's work counters those of the one process's steps. Returns a
    summary."""
    got = ranks_[0]
    if got["mesh"] != mesh:
        raise AssertionError(f"{label}: the mesh is {got['mesh']}, not {mesh}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(got["losses"] * 2, same["losses"] + ref["losses"]))
    grad_rel = max(((g[n] - r[n]).abs().max() / r[n].abs().max()).item()
                   for g, r in zip(got["grads"], same["grads"]) for n in r)
    afters = [b[0] for b in got["before"][1:]] + [got["params"]]
    outside, undetermined, worst = 0, 0, 0.0
    for g, r, mine, theirs in zip(got["grads"], same["grads"], afters, same["after"]):
        for n, p in theirs.items():
            share = (mine[n] - p).abs() / (DP_ATOL + DP_RTOL * p.abs())
            free = (torch.sign(g[n]) != torch.sign(r[n])) & (
                r[n].abs() <= (g[n] - r[n]).abs().max())
            outside += int((share > 1).sum())
            undetermined += int(((share > 1) & free).sum())
            worst = max(worst, share.masked_fill(free, 0).max().item())
    replicas = all(torch.equal(other["params"][n], got["params"][n])
                   for other in ranks_[1:] for n in got["params"])
    work = [[{k: c[k] for k in WORK_KEYS} for c in r["launches"]] for r in ranks_]
    ref_work = [{k: c[k] for k in WORK_KEYS} for c in ref["launches"]]
    peaks = [round(r["peak_gib"], 3) for r in ranks_]
    log(f"{label}: mesh {got['mesh']}; losses {got['losses']}, one process's from the same "
        f"states {same['losses']}, one process's run {ref['losses']} (largest rel "
        f"{loss_rel:.3e}); gradients within {grad_rel:.3e} of each tensor's max of one "
        f"process's from the same states (tol {DP_GRAD_RTOL}); params after each step: "
        f"{outside} elements outside rtol {DP_RTOL}, atol {DP_ATOL} of one process's step, "
        f"of which {undetermined} have gradients of opposite sign within the steps' gap of "
        f"zero, the rest at {worst:.3f} of the tolerance; the ranks' params bit-equal "
        f"{replicas}; rank 0's launches {got['launches'][-1]}; s per step of each rank "
        f"{[[round(x, 4) for x in r['seconds']] for r in ranks_]} (one process "
        f"{[round(x, 4) for x in ref['seconds']]}); peak memory allocated per rank {peaks} "
        f"GiB, one process {ref['peak_gib']:.3f} GiB; {smi}")
    if not (loss_rel <= 1e-5 and grad_rel <= DP_GRAD_RTOL):
        raise AssertionError(f"{label}: the sharded steps' losses or gradients differ")
    if outside != undetermined or not replicas:
        raise AssertionError(f"{label}: the updated params differ from one process's")
    for r, counts in enumerate(ranks_):
        for step, c in enumerate(counts["launches"]):
            check_warp_work(c, f"{label}, rank {r}, step {step}")
    if any(w != ref_work for w in work):
        raise AssertionError(f"{label}: a rank's work counters {work} are not one "
                             f"process's {ref_work}")
    return dict(loss_rel=loss_rel, grad_rel=grad_rel, outside=outside,
                undetermined=undetermined, peak_gib=peaks, one_process_peak_gib=ref["peak_gib"],
                s_per_step=[r["seconds"] for r in ranks_], one_process_s=ref["seconds"])


def spatial_two_ranks(smi, moved_ref, warp_ref):
    """Phase 15a: a (1, 2) mesh of two processes on the card against one
    process (sp_rank, sp_hold), and the bfloat16 register call on slabs
    against phase 3's ``moved_ref``, ``warp_ref``. Returns the launches of
    rank 0's steps and call, and a summary."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks_, seconds = sp_spawn(2, "15a")
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    summary = dict(seconds=seconds, backend=ranks_[0]["backend"])
    for mode, steps in SP_STEPS.items():
        ref = sp_run(None, 1, steps, mode == "conv", moving, fixed)
        same = sp_replay(ranks_[0][mode]["before"], 1, mode == "conv", moving, fixed)
        summary[mode] = sp_hold(f"15a, {mode}", [r[mode] for r in ranks_], ref, same,
                                {"data": 1, "space": 2}, smi)
        if mode == "conv" and any(c["conv"] != TRAIN_STEP_CONVS or c["layout_copies"]
                                  for r in ranks_ for c in r[mode]["launches"]):
            raise AssertionError(f"15a: a conv-kernel step missed a kernel or copied a "
                                 f"layout: {[r[mode]['launches'] for r in ranks_]}")
    call = [r["register"] for r in ranks_]
    flow_err, flow_mean = max_and_mean_abs(call[0]["warp"], warp_ref.cpu())
    image_err, image_mean = max_and_mean_abs(call[0]["moved"], moved_ref.cpu())
    alike = torch.equal(call[0]["warp"], call[1]["warp"]) and torch.equal(call[0]["moved"],
                                                                          call[1]["moved"])
    log(f"15a: bfloat16 register call on slabs of {call[0]['slab']} planes, "
        f"{[round(c['seconds'], 4) for c in call]} s per rank (gloo through the host): "
        f"pos_flow max abs err {flow_err:.4e} (mean {flow_mean:.4e}, tol {BF16_FLOW_TOL}), "
        f"y_source {image_err:.4e} (mean {image_mean:.4e}, tol {BF16_IMAGE_TOL}) against "
        f"phase 3's call; the ranks' outputs bit-equal {alike}; launches "
        f"{call[0]['launches']}; 15a's ranks {seconds:.2f} s; {smi}")
    if not (flow_err <= BF16_FLOW_TOL and image_err <= BF16_IMAGE_TOL and alike):
        raise AssertionError("15a: the sharded bfloat16 register call differs")
    summary["register"] = dict(flow_err=flow_err, image_err=image_err,
                               seconds=[c["seconds"] for c in call])
    return dict(cudnn=ranks_[0]["cudnn"]["launches"][-1],
                conv=ranks_[0]["conv"]["launches"][-1],
                register=call[0]["launches"]), summary


def spatial_four_ranks(smi):
    """Phase 15b: four processes in one launch, a step on a (1, 4) mesh
    (slabs 48/48/32/32) and one on (2, 2) at batch 2, each held to one
    process's step (sp_hold). Returns rank 0's launches and a summary."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks_, seconds = sp_spawn(4, "15b")
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    summary = dict(seconds=seconds)
    for key, batch, mesh in (("row", 1, {"data": 1, "space": 4}),
                             ("grid", 2, {"data": 2, "space": 2})):
        ref = sp_run(None, batch, 1, False, moving, fixed)
        same = dict(losses=ref["losses"], grads=ref["grads"], after=[ref["params"]])
        summary[key] = sp_hold(f"15b, {key}", [r[key] for r in ranks_], ref, same, mesh, smi)
    log(f"15b: four ranks {seconds:.2f} s")
    return dict(row=ranks_[0]["row"]["launches"][-1],
                grid=ranks_[0]["grid"]["launches"][-1]), summary


def spatial_nccl(smi, world):
    """Phase 15c: ``world`` processes, one per card, over NCCL: phase 4's
    step spatially sharded on (1, N) in both conv modes and data-parallel
    on (N, 1) at batch N, each run held to one card's from the same states
    (sp_hold); s per step (the median after the first) beside one card's.
    Returns a summary."""
    if torch.cuda.device_count() < world:
        raise AssertionError(f"15c: {world} ranks need {world} cards; "
                             f"{torch.cuda.device_count()} present")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks_, seconds = sp_spawn(world, "15c", nccl=True)
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    summary = dict(seconds=seconds, backend=ranks_[0]["backend"], world=world)
    for key, batch, conv, mesh in (("spatial", 1, False, {"data": 1, "space": world}),
                                   ("spatial_conv", 1, True, {"data": 1, "space": world}),
                                   ("data", world, False, {"data": world, "space": 1})):
        ref = sp_run(None, batch, SP_NCCL_STEPS, conv, moving, fixed)
        same = sp_replay(ranks_[0][key]["before"], batch, conv, moving, fixed)
        summary[key] = sp_hold(f"15c, {key}", [r[key] for r in ranks_], ref, same, mesh, smi)
        ranks_s = max(float(np.median(r[key]["seconds"][1:])) for r in ranks_)
        one_s = float(np.median(ref["seconds"][1:]))
        summary[key].update(s_per_step_median=ranks_s, one_card_s_per_step_median=one_s)
        log(f"15c, {key}: {ranks_s:.4f} s per step over {world} cards (the slowest rank's "
            f"median after the first), {one_s:.4f} on one card at batch {batch}: "
            f"{one_s / ranks_s:.3f}x; peak per rank {summary[key]['peak_gib']} GiB, one "
            f"card {ref['peak_gib']:.3f} GiB; {smi}")
    log(f"15c: {world} ranks {seconds:.2f} s")
    return summary


# spatial sharding of every other model class (phase 16): the classes in the
# order of the run, each trained by the recipe of the phase named beside it;
# HyperVxmJoint at 13c's cut widths (JOINT_CUT): at its defaults each of two
# ranks would hold ~18 GiB of params, gradients, DDP buckets and Adam state
# and ~20 GiB of activations (the deformable stage's 256-wide maps on
# 40x96x112 slabs, twice), which two ranks on one 80 GB card do not fit;
# how long the spawned ranks may take
SP16_CLASSES = {"semisupervised": "5", "pointcloud": "6", "template": "8",
                "cond_template": "8b", "prob_atlas": "9, conv kernel", "instance": "10",
                "hyper": "11", "synthmorph_float32": "12d, float32",
                "synthmorph": "12d, bfloat16", "joint": "13c's widths"}
SP16_RANK_TIMEOUT_S = 700
SP16_LOSS_RTOL = 1e-5
# a bfloat16 step: each rank's weight gradient is its slab's part rounded to
# bfloat16 (cuDNN's output type), and the hook adds the rounded parts where
# one process rounds one sum (as JAX's GSPMD reduces its partial bfloat16
# gradients); each slab's edge planes also add their input gradient in two
# rounded parts. So the sharded step is a bfloat16 evaluation of the
# gradient with more roundings than one process's: measured on an NVIDIA
# H100 80GB HBM3 at 700 W, 0.155 of dec_conv_0_0.conv.weight's largest
# entry from one process's bfloat16 gradient, and 2.4 times as far from the
# float32 gradient in L2 over every tensor (6.91e-3 against 2.91e-3, the
# float32 gradient's norm 5.58e-2). Each tensor's distance to one process's
# float32 gradient is held to this many times one process's bfloat16
# gradient's, what bfloat16 itself costs that tensor (measured: at most
# 3.27 times, dec_conv_2_0.conv.bias); a slab's part of a gradient lost
# would move it by about half its size, 7 to 12 times that cost on the
# worst tensors. Its params are not held: Adam's first update of a weight
# whose bfloat16 gradient is of the order of its eps (1e-8; these
# gradients are 1e-7 at most) follows that gradient's rounded size
SP16_BF16_COST_FACTOR = 4.0


def sp16_batches():
    """Phase 16's batches, made once on the card: {class: (inputs, targets,
    extras)}, with the template's atlas (the pair's other image, as phase
    8's --init-template) and the instance flow's warm start (the committed
    checkpoint's preintegrated flow for the pair, as cli/train_instance's
    --model) among the extras."""
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    zero = torch.zeros((1, *INSHAPE, 3), device="cuda")
    out = {"semisupervised": (*semi_batch(INSHAPE, "cuda"), {})}
    with tempfile.TemporaryDirectory() as tmp:
        pointcloud_files(tmp, INSHAPE, "cuda")
        out["pointcloud"] = (*next(pointcloud_generator(tmp, "cuda")), {})
    out["template"] = (*template_targets(moving), {"atlas": fixed})
    pheno = torch.from_numpy(np.random.default_rng(SEED + 11).standard_normal(
        (1, PHENO_FEATS), dtype=np.float32)).cuda()
    out["cond_template"] = ((pheno, torch.zeros_like(moving), moving),
                            (moving, zero, zero, zero), {})
    atlas = prob_atlas(moving, PROB_CLASSES, SEED + 12)
    out["prob_atlas"] = ((fixed * (fixed > 0.2), atlas), (atlas, zero), {})
    with torch.no_grad():
        flow = load_model(str(CHECKPOINT), device="cuda")(moving, fixed)["preint_flow"].float()
    out["instance"] = ((moving,), (fixed, torch.zeros_like(flow)), {"flow": flow})
    out["hyper"] = (*hyper_batch(moving, fixed, [0.5]), {})
    maps = synth_label_maps(INSHAPE, 2, synth_labels().in_label_list, "cuda")
    out["synthmorph"] = out["synthmorph_float32"] = (
        (maps[0][None, ..., None], maps[1][None, ..., None]), (torch.zeros(1, device="cuda"),),
        {})
    hyp = torch.full((1, 1), JOINT_HYPER, device="cuda")
    out["joint"] = ((hyp, moving, fixed), (fixed, zero), {})
    return {k: tuple(_cpu_tree(list(part)) if isinstance(part, tuple) else _cpu_tree(part)
                     for part in v) for k, v in out.items()}


def sp16_model(key, extras):
    """Phase 16's model of class ``key`` on the card from its recipe's seed:
    (model, loss terms, conv-kernel mode, learning rate)."""
    if key == "semisupervised":
        return (*semi_recipe(INSHAPE), False, 1e-4)
    if key == "pointcloud":
        return (*pointcloud_recipe(INSHAPE), False, 1e-4)
    if key == "template":
        return (*template_recipe(INSHAPE, atlas=extras["atlas"]), False, 1e-4)
    if key == "cond_template":
        return (ConditionalTemplateCreation(INSHAPE, (PHENO_FEATS,), conv_nb_features=4,
                                            extra_conv_layers=3,
                                            generator=torch.Generator().manual_seed(SEED)),
                cond_template_terms("ncc"), False, 1e-4)
    if key == "prob_atlas":
        return (*prob_recipe(INSHAPE), True, 1e-4)
    if key == "instance":
        # cli/train_instance's model and losses, warm-started as its --model
        model = InstanceDense(INSHAPE, generator=torch.Generator().manual_seed(SEED))
        model.set_flow(extras["flow"])
        return (model, [LossTerm("y_source", losses.MSE().loss, weight=1.0, target_index=0),
                        LossTerm("reg", losses.Grad("l2", loss_mult=2).loss, weight=0.01,
                                 target_index=1, name="grad")], False, INSTANCE_LR)
    if key == "hyper":
        model = resolve_registration_model(load_model(str(HYPER_CHECKPOINT), device="cuda"),
                                           inshape=INSHAPE)
        return model.train(), hypermorph_terms("mse", 0.05, 2), False, 1e-4
    if key.startswith("synthmorph"):
        cfg = synth_config(INSHAPE, SYNTH_OUT_LABELS)
        dtype = torch.float32 if key == "synthmorph_float32" else torch.bfloat16
        return (SynthMorphDense(cfg, nb_unet_features=[[64] * 4, [64] * 6], int_steps=5,
                                int_resolution=2, svf_resolution=2, dtype=dtype,
                                shared_contrast=0.5,
                                generator=torch.Generator().manual_seed(SEED)),
                synth_recipe_terms(), False, 1e-4)
    if key == "joint":
        model = HyperVxmJoint(INSHAPE, return_moved=True, **JOINT_CUT,
                              generator=torch.Generator("cuda").manual_seed(SEED))
        return (model, [LossTerm("moved_1", losses.MSE().loss, target_index=0),
                        LossTerm("svf_1", losses.Grad("l2").loss, weight=0.01, target_index=1,
                                 name="grad")], False, 1e-4)
    raise KeyError(key)


def sp16_digest(model):
    """Each parameter's bits folded into one int64 (a position-weighted sum
    of its float32 words, wrapping), on the CPU: two ranks' digests are
    equal where their params are bit-equal, and differ otherwise but by a
    chance of about 2^-64."""
    out = []
    for p in model.parameters():
        words = p.detach().float().contiguous().view(torch.int32).flatten().long()
        weight = torch.arange(words.numel(), device=words.device) * 2654435761 + 40503
        out.append(((words + 1) * weight).sum())
    return torch.stack(out).cpu()


def sp16_step(key, batch, mesh):
    """One step of class ``key``'s recipe: with ``mesh``, the Trainer's
    sharded step; without, one process's step as the Trainer takes it (in a
    world of two, whose Trainer would wrap the model for data parallelism:
    the loss function, backward and Adam, with the Trainer's generator seeded
    0, outside any sharded step). Returns the loss, launches, seconds, peak
    memory and, for rank 0 and the reference, the gradients and params;
    with ``mesh``, also a digest of the params and the planes of this
    rank's slab."""
    from voxelmorph_tpu_torch.parallel import mesh as mesh_lib

    inputs, targets, extras = batch
    inputs = tuple(a.cuda().float() for a in inputs)
    targets = tuple(a.cuda() for a in targets)
    model, terms, conv, lr = sp16_model(key, {k: v.cuda() for k, v in extras.items()})
    rank = mesh_lib.world()[0]
    with deterministic_cudnn(), conv_kernel_mode(conv):
        if mesh is not None:
            trainer = Trainer(model, terms, lr=lr, device="cuda", mesh=mesh)
            trainer.init()
            step = lambda: trainer.train_step(inputs, targets)["loss"]  # noqa: E731
        else:
            model = model.to("cuda").train()
            opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
            loss_fn = make_loss_fn(model, terms)
            generator = torch.Generator(device="cuda").manual_seed(0)

            def step():
                opt.zero_grad(set_to_none=True)
                with stream_step(model):
                    loss, _ = loss_fn(inputs, targets, generator)
                    loss.backward()
                opt.step()
                return loss
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        loss = step().item()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        out = dict(loss=loss, launches=launches, seconds=seconds,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   param_gib=sum(p.numel() * 4 for p in model.parameters()) / 2 ** 30)
        if mesh is None or rank == 0:
            out["grads"] = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
            out["params"] = {n: p.detach().cpu() for n, p in model.named_parameters()}
        if mesh is not None:
            out["digest"] = sp16_digest(model)
            # the planes of this rank's slab of the volume the model cuts
            lo, hi = mesh_lib.slab_bounds(model.slab_depth, 2, model.slab_align)[
                mesh.position(rank)[1]]
            out["slab"] = hi - lo
    return out


def sp16_compare(got, ref, float32=None):
    """The sharded step ``got`` (rank 0's) against one process's ``ref``:
    the relative loss gap, the largest gradient gap relative to each
    tensor's largest entry, and the params after it as sp_hold holds them
    (elements outside DP_RTOL/DP_ATOL of one process's, those among them
    whose gradients have opposite signs within the steps' gap of zero, and
    the worst share of the tolerance of the rest). With ``float32``, one
    process's float32 gradients of a bfloat16 step, also the largest ratio
    of a tensor's distance to them to one process's bfloat16 gradient's
    (``bf16_ratio``), and L2 distances over every gradient."""
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    grad_rel, worst_name, bf16_ratio, bf16_rows = 0.0, None, 0.0, []
    # squared L2 of sharded - one, one - float32, sharded - float32, float32
    sq = np.zeros(4)
    outside, undetermined, worst = 0, 0, 0.0
    for n, r in ref["grads"].items():
        g = got["grads"][n]
        rel = ((g - r).abs().max() / r.abs().max()).item() if r.abs().max() > 0 else float(
            (g - r).abs().max() > 0)
        if rel > grad_rel:
            grad_rel, worst_name = rel, n
        if float32 is not None:
            f = float32[n]
            far, cost = (g - f).abs().max().item(), (r - f).abs().max().item()
            ratio = far / cost if cost else float(far > 0)
            bf16_ratio = max(bf16_ratio, ratio)
            bf16_rows.append((ratio, n, far, cost, (g - r).abs().max().item(),
                              f.abs().max().item()))
            sq += [float(((g - r) ** 2).sum()), float(((r - f) ** 2).sum()),
                   float(((g - f) ** 2).sum()), float((f ** 2).sum())]
        share = (got["params"][n] - ref["params"][n]).abs() / (
            DP_ATOL + DP_RTOL * ref["params"][n].abs())
        free = (torch.sign(g) != torch.sign(r)) & (r.abs() <= (g - r).abs().max())
        outside += int((share > 1).sum())
        undetermined += int(((share > 1) & free).sum())
        worst = max(worst, share.masked_fill(free, 0).max().item())
    return dict(loss_rel=loss_rel, grad_rel=grad_rel, worst_grad=worst_name, outside=outside,
                undetermined=undetermined, worst_share=worst, bf16_ratio=bf16_ratio,
                # the largest ratios: (ratio, tensor, the distance to
                # float32, bfloat16's cost, the gap to one process's
                # bfloat16, max|float32|)
                bf16_worst=sorted(bf16_rows, reverse=True)[:4],
                bf16_l2=[float(x) for x in np.sqrt(sq)])


def sp16_rank(rank, tmp):
    """A rank of phase 16 (``chip_smoke.py --sp16-rank R --sp-dir DIR``):
    every class's sharded step on a (1, 2) mesh of two processes sharing the
    card over gloo, and on rank 0, after both ranks freed the card, one
    process's step of the same recipe from the same params and Adam state.
    Writes DIR/rank{R}.pt: per class its step's readings, and on rank 0 the
    comparison and the one process's readings."""
    import datetime

    import torch.distributed as dist
    from voxelmorph_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # a timeout, so that a rank that fails does not leave the other waiting
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=SP16_RANK_TIMEOUT_S - 60))
    try:
        batches = torch.load(os.path.join(tmp, "batches.pt"))
        mesh = mesh_lib.make_mesh((1, 2))
        out, float32 = {}, None
        for key in SP16_CLASSES:
            got = out[key] = sp16_step(key, batches[key], mesh)
            digest = got.pop("digest")
            torch.cuda.empty_cache()
            dist.barrier()
            if rank == 0:
                ref = sp16_step(key, batches[key], None)
                # the float32 SynthMorph step's gradients, for the bfloat16 one's
                got.update(sp16_compare(got, ref, float32 if key == "synthmorph" else None))
                float32 = ref["grads"] if key == "synthmorph_float32" else None
                got["one_process"] = {k: v for k, v in ref.items()
                                      if k not in ("grads", "params")}
                del got["grads"], got["params"], ref
                torch.cuda.empty_cache()
            # rank 0's digest less rank 1's
            mine = digest if rank == 0 else -digest
            dist.all_reduce(mine)
            got["ranks_bit_equal"] = bool((mine == 0).all())
            dist.barrier()
        out["backend"] = dist.get_backend()
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spatial_models(smi):
    """Phase 16: every model class but VxmDense spatially sharded over two
    processes on the one card (sp16_rank), each class's sharded step held to
    one process's step from the same params and Adam state. Returns rank
    0's launches by class and a summary."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        torch.save(sp16_batches(), os.path.join(tmp, "batches.pt"))
        torch.cuda.empty_cache()
        batches_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--sp16-rank",
                                   str(r), "--sp-dir", tmp], cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=SP16_RANK_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        ranks_s = time.perf_counter() - t0
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"16: rank {r} exited with {p.returncode}:\n{out}")
        ranks_ = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    summary, launches, failed = dict(batches_s=batches_s, ranks_s=ranks_s,
                                      backend=ranks_[0]["backend"]), {}, []
    for key, recipe in SP16_CLASSES.items():
        got = [r[key] for r in ranks_]
        one = got[0]["one_process"]
        work = [{k: g["launches"][k] for k in WORK_KEYS} for g in got]
        ref_work = {k: one["launches"][k] for k in WORK_KEYS}
        peaks = [round(g["peak_gib"], 3) for g in got]
        # beyond one process a rank holds DDP's buckets (a copy of the
        # gradients) and the reduction's copy of one
        peak_ok = all(g["peak_gib"] <= one["peak_gib"] + 2 * g["param_gib"] for g in got)
        bf16 = key == "synthmorph"
        grads_ok = (got[0]["bf16_ratio"] <= SP16_BF16_COST_FACTOR if bf16 else
                    got[0]["grad_rel"] <= DP_GRAD_RTOL
                    and got[0]["outside"] == got[0]["undetermined"])
        ok = (got[0]["loss_rel"] <= SP16_LOSS_RTOL and grads_ok
              and all(g["ranks_bit_equal"] for g in got) and all(w == ref_work for w in work)
              and peak_ok)
        log(f"16, {key} (phase {recipe}'s recipe), (1, 2) mesh, slabs of {got[0]['slab']} and "
            f"{got[1]['slab']} planes: loss {got[0]['loss']:.8f}, one process's "
            f"{one['loss']:.8f} (rel {got[0]['loss_rel']:.3e}, tol {SP16_LOSS_RTOL}); "
            f"gradients within {got[0]['grad_rel']:.3e} of each tensor's max (worst "
            f"{got[0]['worst_grad']}; tol {DP_GRAD_RTOL}" + (
                f"; bfloat16: each tensor's distance to one process's float32 gradient "
                f"within {got[0]['bf16_ratio']:.4f} times one process's bfloat16 gradient's "
                f"(tol {SP16_BF16_COST_FACTOR}), the largest (ratio, tensor, distance, "
                f"bfloat16's, the gap to one process's bfloat16, max|float32|) "
                f"{got[0]['bf16_worst']}; L2 over every gradient: sharded - one process "
                f"{got[0]['bf16_l2'][0]:.4e}, one process - float32 {got[0]['bf16_l2'][1]:.4e}, "
                f"sharded - float32 {got[0]['bf16_l2'][2]:.4e}, float32 "
                f"{got[0]['bf16_l2'][3]:.4e}; params not held"
                if bf16 else "") + "); params after the step: "
            f"{got[0]['outside']} elements outside rtol {DP_RTOL}, atol {DP_ATOL}, of which "
            f"{got[0]['undetermined']} have gradients of opposite sign within the steps' gap "
            f"of zero, the rest at {got[0]['worst_share']:.3f} of the tolerance; the ranks "
            f"bit-equal {[g['ranks_bit_equal'] for g in got]}; launches per rank {work}, one "
            f"process {ref_work}; s per step {[round(g['seconds'], 4) for g in got]} (one "
            f"process {one['seconds']:.4f}; gloo through the host); peak memory allocated per "
            f"rank {peaks} GiB, one process {one['peak_gib']:.3f} GiB, params "
            f"{got[0]['param_gib']:.3f} GiB; {smi}")
        for r, g in enumerate(got):
            check_warp_work(g["launches"], f"16, {key}, rank {r}")
        if not ok:
            failed.append(key)
        launches[key] = got[0]["launches"]
        summary[key] = dict(
            {k: got[0][k] for k in ("loss_rel", "grad_rel", "outside", "undetermined",
                                    "worst_share", "bf16_ratio", "slab")},
            peak_gib=peaks, one_process_peak_gib=one["peak_gib"],
            s_per_step=[g["seconds"] for g in got], one_process_s=one["seconds"])
    log(f"16: batches {batches_s:.2f} s, the two ranks {ranks_s:.2f} s")
    if failed:
        raise AssertionError(f"16: the sharded steps of {failed} differ from one process's")
    return launches, summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="print profiler breakdowns of a register call and a train "
                             "step, with and without the conv kernel, of HyperMorph's, and "
                             "of SynthMorph's synthesis and steps")
    parser.add_argument("--compare-warp-source", nargs="+", default=[], metavar="CU",
                        help="other copies of csrc/warp_bounded.cu to build and time "
                             "beside the package's warp kernels in phases 2 and 2b")
    parser.add_argument("--compare-gather-source", nargs="+", default=[], metavar="CU",
                        help="other copies of csrc/warp_gather.cu (an earlier commit's) "
                             "to build and time beside the package's gather kernels in "
                             "phase 2e")
    parser.add_argument("--conditioning", action="store_true",
                        help="also print the readings behind phase 8's and 12c's "
                             "card-vs-CPU limits: how far 1 + 1e-7 noise on the scan moves "
                             "the CPU's atlas gradient (ATLAS_GRAD_GPU_VS_CPU_L2), how far "
                             "it moves 12c's float32 gradients on the synthesis noise "
                             "(SYNTH_GRAD_GPU_VS_CPU_RTOL), how far two runs of the same "
                             "steps at the default halo differ (SYNTH_DISPATCH_HALO), and "
                             "how far it moves 13c's joint model on the card, with the "
                             "pair's faces masked and not (JOINT_EDGE)")
    parser.add_argument("--dp-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--dp-dir", help=argparse.SUPPRESS)
    parser.add_argument("--sp-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--sp-world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--sp-dir", help=argparse.SUPPRESS)
    parser.add_argument("--sp-nccl", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--sp16-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--nccl-ranks", type=int, metavar="N",
                        help="instead of the smoke run: phase 15c alone, phase 4's step "
                             "spatially sharded over N cards and data-parallel over them, "
                             "one process per card over NCCL, against one card (needs N "
                             "cards)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    if args.dp_rank is not None:  # a rank that phase 14b started
        dp_rank(args.dp_rank, args.dp_dir)
        return 0
    if args.sp_rank is not None:  # a rank that phase 15 started
        sp_rank(args.sp_rank, args.sp_world, args.sp_dir, args.sp_nccl)
        return 0
    if args.sp16_rank is not None:  # a rank that phase 16 started
        sp16_rank(args.sp16_rank, args.sp_dir)
        return 0
    # the serving path's own halo rule and conv dispatch, whatever the
    # environment says
    for name in ("VXM_WINDOW_HALO", "VXM_PALLAS_CONV", "VXM_XLA_DW_EINSUM"):
        os.environ.pop(name, None)
    torch.manual_seed(SEED)
    t_all = time.perf_counter()

    t = phase("1. device and build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t_build = time.perf_counter()
    build_logs = _build.build(force=True)
    log(f"built {sorted(build_logs)} in {time.perf_counter() - t_build:.2f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if any(key in line for key in ("registers", "smem", "spill", "Compiling entry")):
                log(f"  {name}: {line.strip()}")
    if args.nccl_ranks:
        t = phase(f"15c. spatial sharding over {args.nccl_ranks} cards with NCCL")
        log("summary: " + json.dumps(spatial_nccl(smi, args.nccl_ranks)))
        log(f"phase 15c: {time.perf_counter() - t:.2f} s")
        log(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    compare_libs = build_compare_libraries(
        [(f"{i}:{src}", src, []) for i, src in enumerate(args.compare_warp_source)],
        "warp_bounded")
    gather_builds = build_compare_libraries(
        [("counting", _build.SOURCES["warp_gather"], ["-DVXM_GATHER_COUNT=1"])]
        + [(f"source {i}:{src}", src, []) for i, src in enumerate(args.compare_gather_source)],
        "warp_gather")
    # the package's kernels built to count the backward's atomic adds and
    # merged terms (phase 2e's logs; not timed)
    counting = gather_builds.pop("counting")
    hmma = tensor_core_instructions("conv3")
    log(f"conv3: {hmma} tensor-core instructions (HMMA) in libconv3.so")
    if hmma == 0:
        raise AssertionError("the conv kernel has no tensor-core instructions")
    log(f"phase 1: {time.perf_counter() - t:.2f} s")

    t = phase("2. warp_bounded kernel vs plain version")
    warm_device()
    rows = check_warp_bounded(np.random.default_rng(SEED), compare_libs)
    log(f"phase 2: {time.perf_counter() - t:.2f} s")

    t = phase("2b. warp_bounded backward kernel vs plain version")
    bwd_rows = check_warp_bounded_bwd(np.random.default_rng(SEED + 1), compare_libs)
    log(f"phase 2b: {time.perf_counter() - t:.2f} s")

    t = phase("2c. gradients through the bounded warp: GPU vs CPU")
    check_grads_gpu_vs_cpu(np.random.default_rng(SEED + 2))
    log(f"phase 2c: {time.perf_counter() - t:.2f} s")

    t = phase("2d. conv3 kernel vs plain version")
    conv_rows, conv_totals = check_conv3(SEED + 3)
    log(f"phase 2d: {time.perf_counter() - t:.2f} s")

    t = phase("2e. the predicated tiered warp at each tier; the gather kernel")
    gather_fwd_row, gather_bwd_row, skipped = check_tiered_warp(np.random.default_rng(SEED + 9),
                                                                gather_builds, counting)
    log(f"phase 2e: {time.perf_counter() - t:.2f} s")

    t = phase("3. VxmDense registration at full width")
    moving, fixed = smooth_pair(INSHAPE, "cuda")
    model, launches, moved, warp = register_full_width(moving, fixed)
    if args.profile:
        profile_call(model, moving, fixed)
    del model
    bf16_vs_cpu(moved, warp, moving, fixed)
    bf16_vs_f32(moved, warp, *register_f32_vs_cpu(moving, fixed))
    log(f"phase 3: {time.perf_counter() - t:.2f} s")

    t = phase("2e(i). the gather kernels at the serving shape, by phase 3's final flow")
    serving_gather = gather_serving_shape(np.random.default_rng(SEED + 10), warp, gather_builds,
                                          counting)
    log(f"phase 2e(i): {time.perf_counter() - t:.2f} s")

    t = phase("3b. VxmDense registration with the conv kernel")
    conv_launches, conv_ms = register_conv_kernel(moving, fixed)
    if args.profile:
        with conv_kernel_mode(True):
            profile_call(load_model(str(CHECKPOINT), device="cuda"), moving, fixed)
    log(f"phase 3b: {time.perf_counter() - t:.2f} s")

    t = phase("3c. --fast-warp at full width")
    fast_launches, _ = fast_warp_check(moving, fixed)
    log(f"phase 3c: {time.perf_counter() - t:.2f} s")

    t = phase("4. VxmDense training at full width")
    train_launches, redrawn_launches, phase4_s = train_full_width(args.profile)
    train_checkpoint_recipe()
    log(f"phase 4: {time.perf_counter() - t:.2f} s")

    t = phase("4b. VxmDense training with the conv kernel")
    conv_train_launches, conv_redrawn_launches = train_conv_kernel(moving, fixed, args.profile)
    log(f"phase 4b: {time.perf_counter() - t:.2f} s")

    t = phase("5. semi-supervised segmentation training at full width")
    semi_launches, semi_conv_launches = train_semisupervised(
        {False: redrawn_launches, True: conv_redrawn_launches}, smi)
    wide_seg_warp_check(np.random.default_rng(SEED + 7))
    log(f"phase 5: {time.perf_counter() - t:.2f} s")

    t = phase("5b. warp ops on the card")
    warp_ops_check(np.random.default_rng(SEED + 8))
    log(f"phase 5b: {time.perf_counter() - t:.2f} s")

    t = phase("6. point-cloud semi-supervised training at full width")
    point_launches, point_conv_launches = train_pointcloud(smi)
    log(f"phase 6: {time.perf_counter() - t:.2f} s")

    t = phase("6b. --cache-device and --steps-per-dispatch at full width; remat")
    cached_launches = cached_dispatch_check(smi)
    log(f"phase 6b: {time.perf_counter() - t:.2f} s")

    t = phase("6d. point-cloud fit with and without prefetch; the parts of a draw")
    prefetch = prefetch_check(smi)
    log(f"phase 6d: {time.perf_counter() - t:.2f} s")

    t = phase("6e. the U-Net's per-block remat on and off")
    unet_remat = unet_remat_check(smi)
    log(f"phase 6e: {time.perf_counter() - t:.2f} s")

    t = phase("6c. 2-D VxmDense; do_res with a final activation")
    nd_launches, res_launches = nd_and_res_check(smi)
    log(f"phase 6c: {time.perf_counter() - t:.2f} s")

    t = phase("7. register call and train step with no host sync, every tier")
    sync_free = sync_free_check(smi)
    log(f"phase 7: {time.perf_counter() - t:.2f} s")

    t = phase("8. template creation at full width")
    template = train_template(smi, args.conditioning)
    log(f"phase 8: {time.perf_counter() - t:.2f} s")

    t = phase("8b. conditional template at full width")
    cond = cond_template_check(smi)
    log(f"phase 8b: {time.perf_counter() - t:.2f} s")

    t = phase("9. atlas-based segmentation at full width")
    prob = prob_atlas_check(smi)
    log(f"phase 9: {time.perf_counter() - t:.2f} s")

    t = phase("10. instance optimisation and Transform at full width")
    instance = instance_check(smi)
    log(f"phase 10: {time.perf_counter() - t:.2f} s")

    t = phase("11a. HyperMorph registration at full width")
    hyper_serve = hyper_serving(smi, args.profile)
    log(f"phase 11a: {time.perf_counter() - t:.2f} s")

    t = phase("11b. HyperMorph training at full width")
    hyper_train = hyper_training(smi, args.profile)
    log(f"phase 11b: {time.perf_counter() - t:.2f} s")

    t = phase("11c. the HyperMorph CLIs at full width")
    hyper_cli = hyper_clis(smi)
    log(f"phase 11c: {time.perf_counter() - t:.2f} s")

    t12 = t = phase("12a. SynthMorph's synthesis at 80x96x112 and full width")
    synth_synth = synth_synthesis(smi, args.profile)
    log(f"phase 12a: {time.perf_counter() - t:.2f} s")

    t = phase("12b. SynthMorph registration at full width")
    synth_serve = synth_serving(smi)
    log(f"phase 12b: {time.perf_counter() - t:.2f} s")

    t = phase("12c. the SynthMorph checkpoint's recipe at 80x96x112")
    synth_train = synth_training(smi, args.profile, args.conditioning)
    log(f"phase 12c: {time.perf_counter() - t:.2f} s")

    t = phase("12d. SynthMorph training at full width")
    synth_full = synth_fullres(smi, args.profile)
    log(f"phase 12d: {time.perf_counter() - t:.2f} s")

    t = phase("12e. the SynthMorph CLIs")
    synth_cli = synth_clis(smi)
    log(f"phase 12e: {time.perf_counter() - t:.2f} s; phase 12: {time.perf_counter() - t12:.2f} s")

    t13 = t = phase("13a-b. SynthMorph's joint model at full width")
    joint = joint_full_width(smi, args.profile)
    log(f"phase 13a-b: {time.perf_counter() - t:.2f} s")

    t = phase("13c-d. the joint model card vs CPU; its CLIs")
    joint_cli = joint_vs_cpu_and_clis(smi, args.conditioning)
    log(f"phase 13c-d: {time.perf_counter() - t:.2f} s; phase 13: "
        f"{time.perf_counter() - t13:.2f} s")

    t14 = t = phase("14a. the Trainer over one NCCL rank at full width")
    dp_one = dp_one_rank(smi, phase4_s)
    log(f"phase 14a: {time.perf_counter() - t:.2f} s")

    t = phase("14b. two processes on the one card over gloo")
    dp_two = dp_two_ranks(smi)
    log(f"phase 14b: {time.perf_counter() - t:.2f} s; phase 14: "
        f"{time.perf_counter() - t14:.2f} s")

    t15 = t = phase("15a. spatial sharding over two processes on the one card")
    sp_two, sp_two_summary = spatial_two_ranks(smi, moved, warp)
    log(f"phase 15a: {time.perf_counter() - t:.2f} s")

    t = phase("15b. spatial sharding over four processes: (1, 4) and (2, 2)")
    sp_four, sp_four_summary = spatial_four_ranks(smi)
    log(f"phase 15b: {time.perf_counter() - t:.2f} s; phase 15: "
        f"{time.perf_counter() - t15:.2f} s")

    t = phase("16. spatial sharding of every other model class over two processes")
    sp16, sp16_summary = spatial_models(smi)
    log(f"phase 16: {time.perf_counter() - t:.2f} s")

    paths = {"register": launches, "train_step": train_launches,
             "register_conv": conv_launches, "register_fast_warp": fast_launches,
             "train_step_conv": conv_train_launches,
             "train_step_semisupervised": semi_launches,
             "train_step_semisupervised_conv": semi_conv_launches,
             "train_step_pointcloud": point_launches,
             "train_step_pointcloud_conv": point_conv_launches,
             "train_step_cached_dispatch": cached_launches,
             "train_step_2d": nd_launches, "register_do_res_conv": res_launches,
             "train_step_template": template[False]["launches"],
             "train_step_template_conv": template[True]["launches"],
             "train_step_template_gather": template["gather"]["launches"],
             "train_step_cond_template": cond["launches"],
             "train_step_prob_atlas": prob[False]["launches"],
             "train_step_prob_atlas_conv": prob[True]["launches"],
             "test_unsupervised_seg": prob["test_seg"][INSHAPE],
             "train_step_instance": instance["launches"],
             "register_hyper": hyper_serve["launches"],
             "train_step_hyper": hyper_train["launches"],
             "train_step_hyper_cached_dispatch": hyper_cli["launches"],
             "register_synthmorph": synth_serve["launches"],
             "train_step_synthmorph": synth_train["launches"],
             "train_step_synthmorph_conv": synth_train["conv_launches"],
             # the full-width step in conv-kernel mode
             "train_step_synthmorph_fullres": synth_full[True]["launches"],
             # cli/train_synthmorph's whole dispatch of DISPATCH_STEPS steps
             # (maps padded to INSHAPE)
             "train_step_synthmorph_cached_dispatch": synth_cli["launches"],
             # one float32 register call of the full-width joint model
             "register_joint": joint["launches"],
             # a step of the Trainer over one NCCL rank, cuDNN and conv-kernel
             # mode, and rank 0's step of two processes over gloo
             "train_step_data_parallel": dp_one["launches"],
             "train_step_data_parallel_conv": dp_one["conv_launches"],
             "train_step_data_parallel_two_ranks": dp_two["launches"],
             # rank 0 of the spatially sharded runs: a step on (1, 2) in cuDNN
             # and conv-kernel mode, the bfloat16 register call, and a step
             # on (1, 4) and on (2, 2)
             "train_step_spatial": sp_two["cudnn"], "train_step_spatial_conv": sp_two["conv"],
             "register_spatial": sp_two["register"],
             "train_step_spatial_four_ranks": sp_four["row"],
             "train_step_spatial_two_by_two": sp_four["grid"],
             # rank 0's sharded step of each other model class on (1, 2)
             **{f"train_step_spatial_{key}": n for key, n in sp16.items()}}
    serving, serving_bwd = rows[0], bwd_rows[0]
    conv_serving = conv_totals[("bfloat16", "fwd")]
    conv_train = {key: conv_totals[("float32", "fwd")][key] + conv_totals[("float32", "dx")][key]
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    kernels = [dict(
        name="warp_bounded_fwd", route="cuda",
        source="voxelmorph_tpu_torch/csrc/warp_bounded.cu",
        replaces="voxelmorph_tpu/ops/pallas_interp.py:269",
        launches=point_launches["fwd"], launches_ran=point_launches["fwd_ran"],
        launches_by_path={path: [n["fwd"], n["fwd_ran"]] for path, n in paths.items()},
        skipped_launch_ms=skipped["bounded_fwd"],
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=serving["ms"], plain_ms=serving["plain_ms"], bound_ms=serving["bound_ms"],
        bound_by=serving["bound_by"], bound_share=serving["bound_share"],
        library_ms=serving["library_ms"]), dict(
        name="warp_bounded_bwd", route="cuda",
        source="voxelmorph_tpu_torch/csrc/warp_bounded.cu",
        replaces="voxelmorph_tpu/ops/pallas_interp.py:952",
        launches=point_launches["bwd"], launches_ran=point_launches["bwd_ran"],
        launches_by_path={path: [n["bwd"], n["bwd_ran"]] for path, n in paths.items()},
        skipped_launch_ms=skipped["bounded_bwd"],
        max_abs_err=max(r["max_abs_err"] for r in bwd_rows),
        ms=serving_bwd["ms"], plain_ms=serving_bwd["plain_ms"],
        bound_ms=serving_bwd["bound_ms"], bound_by=serving_bwd["bound_by"],
        bound_share=serving_bwd["bound_share"], library_ms=serving_bwd["library_ms"]), dict(
        # the gather branch of the tiered warp: no Pallas kernel computes
        # it (the JAX package's XLA gather, interpn); times at the squaring
        # shape on a smooth field of up to TIER_HALO + 2 voxels
        name="warp_gather_fwd", route="cuda", source="voxelmorph_tpu_torch/csrc/warp_gather.cu",
        replaces="voxelmorph_tpu/ops/interp.py:301", pallas_counterpart=False,
        launches=point_launches["gather_fwd"], launches_ran=point_launches["gather_fwd_ran"],
        launches_by_path={path: [n["gather_fwd"], n["gather_fwd_ran"]]
                          for path, n in paths.items()},
        skipped_launch_ms=skipped["gather_fwd"], max_abs_err=gather_fwd_row["max_abs_err"],
        ms=gather_fwd_row["ms"], plain_ms=gather_fwd_row["plain_ms"],
        bound_ms=gather_fwd_row["bound_ms"], bound_by=gather_fwd_row["bound_by"],
        bound_share=gather_fwd_row["bound_share"], library_ms=gather_fwd_row["library_ms"],
        rough=gather_fwd_row["rough"],
        serving={case: gather_summary(rows[0]) for case, rows in serving_gather.items()}),
        dict(
        name="warp_gather_bwd", route="cuda", source="voxelmorph_tpu_torch/csrc/warp_gather.cu",
        replaces="voxelmorph_tpu/ops/interp.py:301", pallas_counterpart=False,
        launches=point_launches["gather_bwd"], launches_ran=point_launches["gather_bwd_ran"],
        launches_by_path={path: [n["gather_bwd"], n["gather_bwd_ran"]]
                          for path, n in paths.items()},
        skipped_launch_ms=skipped["gather_bwd"], dvol_zero_ms=skipped["dvol_zero"],
        max_abs_err=gather_bwd_row["max_abs_err"],
        ms=gather_bwd_row["ms"], kernel_ms=gather_bwd_row["kernel_ms"],
        plain_ms=gather_bwd_row["plain_ms"],
        bound_ms=gather_bwd_row["bound_ms"], bound_by=gather_bwd_row["bound_by"],
        bound_share=gather_bwd_row["bound_share"], library_ms=gather_bwd_row["library_ms"],
        adds=gather_bwd_row["adds"], merged=gather_bwd_row["merged"],
        rough=gather_bwd_row["rough"],
        serving={case: gather_summary(rows[1]) for case, rows in serving_gather.items()}),
        dict(
        # times: the 11 forward convs of a bfloat16 register call, summed;
        # train_step_conv: the 11 forward and 10 input-gradient convs of a
        # float32 train step
        name="conv3_fwd", route="cuda", source="voxelmorph_tpu_torch/csrc/conv3.cu",
        replaces="voxelmorph_tpu/ops/pallas_conv.py:124",
        launches=point_conv_launches["conv"],
        launches_by_path={path: n["conv"] for path, n in paths.items()},
        max_abs_err=max(r["max_abs_err"] for r in conv_rows),
        max_err_over_tol=max(r["max_err_over_tol"] for r in conv_rows),
        ms=conv_serving["ms"], plain_ms=conv_serving["plain_ms"],
        bound_ms=conv_serving["bound_ms"], bound_by=conv_serving["bound_by"],
        library_ms=conv_serving["library_ms"], register_conv_ms_per_pair=conv_ms,
        train_step_conv=conv_train, tensor_core_instructions=hmma,
        # the same sums at SynthMorph's 64-wide U-Net (phase 12b): 10
        # forward convs, 9 input gradients
        synthmorph=synth_serve["conv_totals"])]
    log("summary: " + json.dumps(dict(
        template={("conv_kernel" if k is True else "cudnn" if k is False else k): {
            key: val for key, val in v.items() if key != "launches"} for k, v in template.items()},
        cond_template={k: v for k, v in cond.items() if k != "launches"},
        prob_atlas={("conv_kernel" if k else "cudnn"): {
            key: val for key, val in prob[k].items() if key != "launches"} for k in (False, True)},
        instance={k: v for k, v in instance.items() if k != "launches"},
        hypermorph=dict(
            serving={k: v for k, v in hyper_serve.items() if k != "launches"},
            training={k: v for k, v in hyper_train.items() if k != "launches"},
            clis={k: v for k, v in hyper_cli.items() if k != "launches"}),
        synthmorph=dict(
            synthesis={"x".join(map(str, k)): v for k, v in synth_synth.items()},
            serving={k: v for k, v in synth_serve.items()
                     if "launches" not in k and k != "conv_rows"},
            training={k: v for k, v in synth_train.items() if "launches" not in k},
            fullres={("conv_kernel" if k else "cudnn"): {
                key: val for key, val in v.items() if key != "launches"}
                for k, v in synth_full.items()},
            clis={k: v for k, v in synth_cli.items() if k != "launches"}),
        joint=dict(full_width={k: v for k, v in joint.items() if k != "launches"},
                   cut_width={k: v for k, v in joint_cli.items() if k != "eval_launches"}),
        data_parallel=dict(
            one_rank={k: v for k, v in dp_one.items() if "launches" not in k},
            two_ranks={k: v for k, v in dp_two.items() if k != "launches"}),
        spatial=dict(two_ranks=sp_two_summary, four_ranks=sp_four_summary,
                     other_models=sp16_summary),
        sync_free={("conv_kernel" if k else "cudnn"): v for k, v in sync_free.items()},
        prefetch=prefetch,
        unet_remat={("conv_kernel" if k else "cudnn"): {
            key: {("on" if r else "off"): x for r, x in val.items()} for key, val in v.items()}
            for k, v in unet_remat.items()})))
    log(f"\ntotal {time.perf_counter() - t_all:.2f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
