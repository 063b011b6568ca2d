#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``shadow_removal_istd_tpu_torch``).

Run from the repository root on a machine with one CUDA card (Hopper,
``nvcc`` under ``$CUDA_HOME`` or ``/usr/local/cuda``)::

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line is printed:

1. build: compiles ``csrc/decoder_upsample.cu``,
   ``csrc/decoder_upsample_tc.cu``, ``csrc/decoder_upsample_narrow.cu``,
   ``csrc/hshear.cu`` and ``csrc/int8_conv.cu`` for ``sm_90a`` (one
   ``nvcc`` each, started
   together, beside ``g++`` building the native PNG loader from
   ``native/png_decoder.cpp``), prints the card, its power limit, the
   compiler's register, spill and shared-memory report, and the host's
   Python packages (``tensorstore``, ``zstandard`` and ``yaml`` among
   them), ``zlib.h`` and ``g++`` (``[env]``);
2. decoder kernel vs plain: the decoder kernels against their plain
   PyTorch version on the card at every MNet decoder step of a 256x256
   and a 480x640 input at ngf 64, batch 2, f32 and bf16, one-part and
   split-skip two-part forms, edge padding, and at 480x640 in bf16 also
   zero padding (max abs 2e-5 in f32, 3e-2 in bf16); each check names
   the variant that ran, which must be the narrow kernel for the Co 1/3
   final steps, the tensor-core kernel for every other bf16 step and the
   CUDA-core kernel for the other f32 steps; at 256x256 the tensor-core
   and narrow steps also count the outputs that differ from the rounded
   float64 value, beside the CUDA-core kernel's and the plain version's
   count, and so does the CUDA-core kernel at the f32 K = 4096 step
   (``[accuracy]``); the zero-pad f32 form at the 16x16 step and the
   256x256 final steps;
3. shear kernel vs plain: ``hshear`` against its plain version at the
   three pass shapes of the training augmentation (batch 16, 7 channels,
   480x640 -> 256; passes 1 and 2 write the transposed layout the next
   pass reads, pass 3 the normal one) and at ragged ones in both layouts
   (W0 off 4, tiles cut at both edges, pad 0, a misaligned view): 0
   outputs may differ (and max abs 3e-5 on 0-255 data), then
   ``fused_augment_shear`` through the kernel against the same through
   the plain version (1e-5 on its [-1, 1] output);
4. serving: ``InferenceEngine`` (ngf 64, bf16, split-skip, seeded random
   weights) behind ``ShadowRemovalServer`` on loopback answers 4
   concurrent 480x640 PNG requests and one 256x256 (rows in all five PNG
   filter types; the host's decode time per request is printed); replies
   decode to the right shapes, the decoder's launch count rises by 10
   per stacked forward (8 tensor-core, 2 narrow), and the kernel
   path's uint8 output is within 2 gray levels of the same engine forced
   onto the plain decoder;
5. training: ``Trainer`` at the JAX CLI's defaults (G1/G2 MNet ngf 64,
   ConvTranspose decoder, droprate 0.05; D1/D2 PatchGAN ndf 64; batch 16,
   256x256 shear-augmented crops of 64 synthetic 480x640 triplets on the
   card; f32; visual loss through a seeded random VGG-19-BN) trains 2
   epochs of 4 steps, validating 16 full-resolution triplets after each:
   metrics finite, every network's parameters and BatchNorm statistics
   moved, ``hshear`` launched exactly 3 times per step (and 3 times for
   the epoch-0 image log's augmentation) and the decoder kernel 10 times
   per stacked forward of the validations and the image logs (8
   CUDA-core and 2 narrow in f32); then one bf16 epoch (8 tensor-core, 2
   narrow); the VGG weights reach the trainer as a converted ``.npz``
   file; these runs take the fused epoch (``device_cache=True``);
6. cli: ``write_istd_layout`` writes an ISTD directory of 32 train and 8
   test 480x640 triplets (the port's PNG encoder, rows in all five filter
   types), whose decode is timed per stream (``[time] istd load``, with
   the library decoder if any and the stdlib codec); ``cli.main --tasks
   train infer`` at the CLI's defaults (ngf 64, ndf 64, batch 16, 256
   crops, f32, shear augmentation, that VGG file) runs 2 epochs,
   validating, saving the checkpoint and writing weight files after
   each, then infers the test split to PNGs: ``hshear`` launched 3 times
   a step (+ 3 for the image log), the decoder 10 times per stacked
   forward (8 CUDA-core, 2 narrow) over 2 validations, 3 image logs and
   the inference, the 8 weight files and
   the checkpoint exist, 2 x 8 PNGs decode to 480x640, and they are
   within 2 gray levels of the same inference run on the plain decoder;
   then ``--tasks train --epochs 3 --load-checkpoint`` starts at epoch 2
   from a state bit-identical to the saved run's (weights, BN
   statistics, both Adam states with their steps' dtype and device,
   step) and trains its epoch (``[time] checkpoint``, ``[time] cli
   infer`` img/s with the PNG writes, the phase's wall time);
7. host: two host-pipeline epochs (``RunConfig(device_cache=False)``:
   ``BatchPipeline`` order, ``prefetch_to_device`` uploads) at the CLI's
   defaults on 64 + 16 synthetic 480x640 triplets with every writer on
   (``log_every = vis_every = valid_every = 1``) and ``profile_dir``:
   ``hshear`` 3 launches a step, the decoder 8 CUDA-core + 2 narrow per
   stacked forward of the validations and of each image log; both event
   files read back by the CRC-checking reader with every JAX tag at both
   epochs; the trace names ``hshear`` 3 times a step; the host epoch's
   img/s beside the fused epoch's on the same data, in turns, and each
   one's idle share (the card's busy union over the profiled span), the
   writers' cost and the host pipeline's parts per batch; a SIGTERM to
   ``cli.main`` in a subprocess after its second epoch: exit 0, the
   checkpoint and ``latest`` files, infer skipped, and the run resumed
   from it for one more epoch byte-identical to an uninterrupted run
   (cuDNN's deterministic algorithms in both); the native PNG loader
   byte-equal to cv2 on the ``cli`` directory, used by ``load_all``,
   timed beside cv2 and the stdlib codec; the serving daemon with
   ``--use-selu --droprate`` (a SELU UNet, ngf 64, f32) answering as the
   engine does in this process;
8. eval: ``ops/resize.resize`` at 480x640 -> 256x256 and -> 300x400
   (area) and 256x256 -> 480x640 (linear), batch 16, within 1e-5 of
   float64 numpy applied with the same matrices; ``rgb_to_lab`` within
   1e-3 LAB units of float64 and ``aggregate_regions`` of
   ``region_metrics`` within rtol 1e-5 of float64 sums, on 16 480x640
   images; an ISTD directory of 16 train + 32 test 480x640 triplets;
   ``metrics/eval_cli.all_metrics`` (masks at size 256 and at the native
   size, and the maskless PSNR/SSIM path) on the card equal to the same
   on the CPU (rtol 1e-5), with images/s and the host decode apart;
   ``cli.main --tasks train infer --eval-metrics``: ``Eval/*`` of the
   validation within rtol 5e-4 of the offline ``all_metrics`` on the PNGs
   ``infer`` wrote, 10 decoder launches per validation batch and image
   log (8 CUDA-core, 2 narrow); the gather augmentation of a batch-16 480x640x7
   uint8 group to 256x256 within 1e-3 of a float64 numpy inverse-affine
   bilinear with the same parameters, the identity warp equal to the
   crop (flipped where drawn) exactly, no ``hshear`` launch, timed beside
   the shear path; 3 training steps on it (no ``hshear`` launch) beside
   3 on the shear path;
9. zoo: the decoder kernels at UNet's four up-conv shapes (1024->512 at
   16x16 .. 128->64 at 128x128 for a 256x256 input; no LeakyReLU, no
   BN), both pads, f32 and bf16, against the plain version (2e-5 / 3e-2)
   and at the K = 4096 step against float64, then timed at a 256x256
   batch-32 bf16 forward's shapes and a 480x640 batch-16 f32
   validation's (zero pad) beside the plain version, cuDNN's phase conv
   and ``conv_transpose2d`` and the bound;
   ``InferenceEngine(net_g="unet")`` bf16 at 256x256 batch 32: 8
   tensor-core and no narrow launches a stacked forward, uint8 within 2
   gray levels of the plain path, img/s beside MNet's; ``Trainer`` with
   UNet G and BEGAN D at the CLI's defaults (ngf/ndf 64, f32, shear
   augmentation, 256 crops of 32 480x640 triplets, batch 16, the random
   VGG file): one epoch and a 480x640 validation, k1/k2 within [0, 1]
   and, from 0.5, moved by the timed steps, 8 CUDA-core launches a
   stacked forward; DenseUNet G + dummy D
   with SoftAdapt for one epoch (weights moved, sum 1); the legacy CLI
   (``cli.stcgan_main --tasks train infer``, pix2pix ngf 64 and NLayer ndf
   64) on the ``cli`` phase's ISTD directory for 2 epochs: plateau state
   in the checkpoint, no decoder launch, 192x256 PNGs; its G1 -> G2 at
   480x640 through the engine; the train-step img/s of each;
10. timings (CUDA events; torch.profiler): each decoder step's kernel
   output on the timed inputs held to its plain version, then its time
   beside the CUDA-core variant's on the same inputs (the before/after
   of the wide bf16 steps and of the final ones), the plain version's, a
   cuDNN convolution of the same step, its bound and, for the final
   steps, the f32 FMA ceiling; stacked img/s at 256x256, batch 32, bf16,
   with the chosen kernels, the CUDA-core kernel only and the plain
   decoder, in turns; f32 serving at 256x256, batch 32: each wide step on
   the CUDA-core kernel beside cuDNN f32 and its FMA ceiling, and the
   stacked img/s (8 CUDA-core and 2 narrow launches a forward); the
   training step's img/s and its split by phase, each ``hshear`` pass in
   its path layout beside the normal layout, its plain version,
   ``F.grid_sample`` and its bound; ``shear_rotate_crop`` folded beside
   unfolded (the normal layout and two transpose copies) with a profiler
   pass that must show 3 ``hshear`` kernels and no image-sized copy; the
   decoder
   kernels' zero-pad (ConvTranspose) form at the validation shapes (wide
   and final steps apart; each wide step's TFLOP/s and share of the f32
   FMA rate), and the validation img/s;
11. remat: ``Trainer`` at the CLI's defaults (as in phase 5, on 32
   synthetic 480x640 triplets on the card) takes 2 steps plain and,
   from a copy of the same state with ``remat=True``, 2 steps
   rematerialized on the same batches and dropout generators under
   cuDNN's deterministic algorithms: the largest difference of the 14
   metrics, the parameters, the BN statistics and both Adam states is
   printed (bit-identical expected; the phase fails above 1e-6 on a
   parameter, rtol 1e-5 on a metric, or on different generator states);
   then plain and remat in turns at 256x256 b16 (median of 5 after a
   warm-up, CUDA events): step ms, img/s, the split by the step's
   marks, the peak (``max_memory_allocated`` after
   ``reset_peak_memory_stats``) and the step's own part of it above what
   was allocated before it, with ``hshear`` 3 launches a remat step;
   480x480 crops of the 480x640 triplets, plain and remat at b8 and
   remat at b24 (median of 2 after a warm-up; peak GiB and img/s;
   ``hshear`` 3 launches a step), and plain b24's peak reckoned from b8
   (what was held before the step, plus 3x the step's own part; not
   run); one remat step each of UNet + BEGAN (k1, k2 in [0, 1]) and
   DenseUNet + dummy + SoftAdapt (weights sum to 1), metrics finite;
12. h5: ``data/h5.py::build_h5`` (the port's HDF5 writer) over the
   ``cli`` phase's ISTD directory: build seconds and file MB;
   ``load_streams`` of each split (img, mask, matte, target) equal byte
   for byte to ``ISTDDataset.load_all`` of the directory, with the names,
   and its load seconds per image; ``cli.main --data-h5 FILE --tasks
   train --epochs 1`` at the CLI's defaults: ``hshear`` 3 launches a step
   (+ 3 for the image log), the decoder 8 CUDA-core + 2 narrow per
   stacked forward of the validation and the 2 image logs, validation
   names from the file; ``h5py`` never imported;
13. int8 (last, so that the earlier phases' profiler readings run in
   the process they ran in before it): ``cli.main --tasks train
   --NN-upconv yes`` for one epoch on the ``cli`` directory writes
   nearest-upsample MNet weights;
   ``InferenceEngine(dtype="int8")`` loads them, calibrated on the
   directory's 8 test images; ``quantize_pad`` and ``int8_conv``
   (``csrc/int8_conv.cu``) against their plain versions at every conv
   site of the stacked pair (20 of each) at 256x256 and 480x640, batch
   2, in f32 and bf16 compute: the int8 tensors, the s32 sums and the
   dequantized outputs bit for bit; the engine's 480x640 batch-4 forward
   launches each kernel 20 times, and its uint8 output is within 2 gray
   levels of the same engine on the plain versions (the share of values
   that differ printed); PSNR of int8 against the folded f32 forward and
   the bf16 engine on the same inputs; stacked img/s at 256x256, batch
   32, int8 and bf16 in turns, the int8 forward's device time by kernel
   group (``[profile]``), and each kernel's time per launch and per
   forward beside its plain version, its bound and, for ``int8_conv``,
   ``torch._int_mm`` on ``Tensor.unfold`` patches; the serving daemon
   with ``--dtype int8 --int8-calib`` answering one 480x640 request as
   the engine in this process does;
14. export (after ``int8``): ``tools/export.py`` writes the ngf 64
   split-skip MNet pair (seeded random weights) as ``torch.export``
   artifacts, each export's seconds and MB printed: bf16 256x256 with
   the batch pinned at 32, bf16 256x256 with a symbolic batch, f32
   256x256 pinned at 32, and bf16 480x640 symbolic. Each 256x256
   artifact, loaded by ``ArtifactEngine`` on the card: its forward
   launches K1 (the op ``srit::decoder_upsample`` in the graph) 8
   tensor-core + 2 narrow times in bf16, 8 CUDA-core + 2 narrow in f32;
   its outputs against the same modules' eager ``infer_step`` within
   3e-2 (bf16) / 2e-5 (f32); its uint8 replies within 2 gray levels of
   ``InferenceEngine``'s. The 480x640 artifact refuses a 512x640 image,
   and the daemon with ``--artifact`` answers one 480x640 request as the
   engine in this process does and a weight reload with 501. Timed:
   the artifact's stacked img/s at 256x256 b32 bf16 beside
   ``InferenceEngine``'s, in turns (``[time] artifact stacked``); the
   eager forward through the op beside the same forward calling the
   kernel's launcher directly, in turns, and the host time of one op
   call beside one direct call (``[time] K1 op dispatch``);
   ``tools/preprocess.compute_sp_polyfit`` on a 480x640 pair at ksize 5,
   deg 1 and 2, on the host (``[time] compute_sp_polyfit``);
15. parallel (after every earlier phase): ``W = torch.cuda.device_count()``
   data-parallel ranks over NCCL where there are two cards or more, else
   2 ranks sharing ``cuda:0`` over gloo (printed, with ``nvidia-smi``'s
   name and power limit). The training configuration (ngf 64, f32, shear,
   256 crops of 16 + 16 synthetic 480x640 triplets, global batch 16,
   Adam eps 1, deterministic cuDNN) trains 2 epochs of one step, each
   validated, in one process and in W spawned ranks
   (``torch.multiprocessing``, a ``file://`` rendezvous): every rank's
   state identical and started from the single run's. Each leaf of the
   state (parameters, BN statistics, Adam moments) is read as its
   largest difference from the single run over its own change from the
   start (at least 1e-3 of its kind's largest change); after both steps
   every kind of DP's reading, and its metrics, lie within the larger
   of 1e-4 and 4x the largest reading of the single run again on its
   batch in 6 other orders (the same shapes and deterministic
   algorithms: what the reduction order alone moves). Each rank then
   replays step 1 with a planted fault (BatchNorm statistics of the
   rank's slice alone; their gradient not summed; the last rank's
   gradients dropped), each of which must exceed that limit. Launches
   per rank (``hshear`` 3 a step, K1 8 CUDA-core + 2 narrow per
   validation forward, rank 0 also its image logs); both runs' img/s
   over 2 more steps. Two ``cli.main``
   processes on the card joined by ``--coordinator`` train one epoch on
   the ``cli`` directory (batch 8): identical validation lines, the
   checkpoint and weight files from rank 0 only, event files only under
   its logs. ``StackedPipeline`` at 480x640 b4 bf16 (stages on
   ``cuda:0``/``cuda:1``, or both on ``cuda:0`` on two streams): 8
   tensor-core + 2 narrow launches a batch, bit-identical to the fused
   ``infer_step`` for one batch and a stream of 8 in order, timed beside
   it in turns. ``InferenceEngine`` over two devices (two replicas on
   one card where there is one) answers 4 480x640 images as the
   one-device engine does, each replica's forward launching K1 8
   tensor-core + 2 narrow;
16. shard (after ``parallel``): spatial row sharding, tensor parallelism
   and the composed mesh, on ranks spawned as in phase 15 (NCCL with a
   card a rank where there are cards enough, else gloo ranks sharing
   ``cuda:0``: correctness and overhead, no scaling; printed with
   ``nvidia-smi``'s name and power limit). Spatial: the serving engine's
   split-skip MNet pair (ngf 64, seeded) at 480x640 b1 in bf16 and f32
   over 2 spatial ranks, each rank's row slab against the one-process
   forward's rows (3e-2 bf16, 2e-5 f32), its K1 launches by variant (8
   tensor-core + 2 narrow in bf16, 8 CUDA-core + 2 narrow in f32, the
   gathered deep level's step included) and the row gathers (1 a
   generator: 15 rows a rank do not take the innermost stride-2 conv),
   its latency beside the one-process forward's. TP: one training step
   of phase 15's configuration (ngf 64, 256 crops, batch 16, f32, Adam
   eps 1) on a 1x2 (data x model) mesh, each state leaf read against
   phase 15's single run by its per-leaf rule and limit; a planted "no
   all-reduce before a split conv" and a planted "gather backward sums"
   each exceed the limit; ``hshear`` 3 launches a step a rank, K1 none;
   each rank's parameter + BN + Adam bytes beside one process's; img/s
   of 2 more steps. 3-D: the engine pair's state (ngf 64, f32) split
   over a 1x2x2 (data x spatial x model) mesh of 4 ranks, its forward at
   256x256 b2 (weights gathered at use, row slabs) against one process
   within 2e-5, 8 CUDA-core + 2 narrow K1 launches a rank.

The second-to-last line is the kernels' JSON summary, the line before it
``nvidia-smi``'s name and power limit, and the last line
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --compare NAME=PATH [NAME=PATH ...]`` does none
of that: it builds each given source of the CUDA-core kernel (e.g. an
earlier commit's ``csrc/decoder_upsample.cu``, unpacked by ``git
archive`` into a git-ignored directory) with its C entry renamed, and
times it beside the checkout's at the f32 wide steps of validation and
serving, with cuDNN f32 and the bound (``[compare]`` lines).
``python3 chip_smoke.py --compare-hshear NAME=PATH [NAME=PATH ...]``
does the same for sources of ``csrc/hshear.cu``: each runs the three
passes of one augmentation (in the path's layouts where its C entry
takes ``transpose_out``, else in the normal layout, as the kernel's
first version did), compared bit for bit with the checkout's kernel and
timed beside it in turns, and the whole rotation through it.
``python3 chip_smoke.py --compare-reflect-pad`` times the train step
(f32 and bf16 compute) with the models' deterministic reflect-pad
backward beside torch's atomic one, in turns (``[compare-pad]`` lines).
"""

from __future__ import annotations

import contextlib
import http.client
import importlib.util
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
PEAK_INT8 = 1979e12     # H100 SXM dense int8 tensor-core operations/s
NGF = 64
DEVICE = "cuda"
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SOURCE = "shadow_removal_istd_tpu_torch/csrc/decoder_upsample.cu"
SOURCE_TC = "shadow_removal_istd_tpu_torch/csrc/decoder_upsample_tc.cu"
SOURCE_NARROW = ("shadow_removal_istd_tpu_torch/csrc/"
                 "decoder_upsample_narrow.cu")
REPLACES = "shadow_removal_istd_tpu/ops/pallas_decoder.py:61"
SHEAR_SOURCE = "shadow_removal_istd_tpu_torch/csrc/hshear.cu"
SHEAR_REPLACES = "shadow_removal_istd_tpu/ops/pallas_shear.py:47"
SHEAR_TOL = 3e-5        # 0-255 data: one f32 ulp at 255
AUG_TOL = 1e-5          # fused augmentation output in [-1, 1]
KERNELS = ("decoder_upsample", "decoder_upsample_tc",
           "decoder_upsample_narrow", "hshear", "int8_conv")
INT8_SOURCE = "shadow_removal_istd_tpu_torch/csrc/int8_conv.cu"
# no Pallas kernel: the XLA s8 x s8 -> s32 convs of the JAX int8 graph
# and the activation quantize before them
INT8_REPLACES = {"int8_conv": "shadow_removal_istd_tpu/models/quant.py:139",
                 "quantize_pad": "shadow_removal_istd_tpu/models/quant.py:93"}
# the int8 phase: kernel checks at these sizes (batch 2), throughput and
# the kernels' times at 256x256 and this batch
INT8_CHECK_HW = ((256, 256), (480, 640))
INT8_BATCH = 32
# the training slice's data: 64 train + 16 validation triplets at ISTD's
# 480x640, batch 16, 256 crops (TrainConfig's defaults); a CPU rehearsal
# shrinks these and TRAIN_KW (TrainConfig overrides)
DATA_HW = (480, 640)
N_TRAIN, N_VALID = 64, 16
AUG_BATCH, CROP = 16, 256
TRAIN_KW: dict = {}
# the CLI phase: an ISTD directory of 32 train + 8 test triplets at
# DATA_HW, trained and inferred at the CLI's defaults (CLI_ARGS adds
# flags: a CPU rehearsal's devices and widths)
CLI_TRAIN, CLI_TEST = 32, 8
CLI_ARGS: list = []
# the eval phase: an ISTD directory of 16 train + 32 test triplets at
# DATA_HW (one training step, two validation batches of 16), the resize
# checks' other shapes, and its tolerances
EVAL_TRAIN, EVAL_TEST = 16, 32
RESIZE_TO = (300, 400)      # the legacy tree's pre-augmentation resize
RESIZE_TOL = 1e-5           # [0, 1] data, against float64
LAB_TOL = 1e-3              # LAB units, against float64
EVAL_RTOL = 1e-5            # dataset metrics: f32 sums vs float64, card vs CPU
EVAL_CLI_RTOL = 5e-4        # in-training Eval/* vs the offline CLI
GATHER_TOL = 1e-3           # gather augmentation on [-1, 1], vs float64
# the zoo phase: UNet's up-convs at 256x256 (batch 32 in bf16 serving),
# UNet + BEGAN and DenseUNet + dummy training on 32 train + 16 validation
# triplets at DATA_HW, and the legacy CLI at its fixed widths (LEGACY_ARGS
# adds flags: a CPU rehearsal's devices, batch and crop)
ZOO_HW = (256, 256)
ZOO_SERVE_BATCH = 32
ZOO_TRAIN, ZOO_VALID = 32, 16
LEGACY_NGF = 64
LEGACY_ARGS: list = []
# the host phase: the host-pipeline epoch on 64 train + 16 validation
# triplets at DATA_HW (TRAIN_KW as above), timed beside the fused epoch;
# the SIGTERM run of cli.main in a subprocess (HOST_CLI_ARGS adds flags:
# a CPU rehearsal's devices and widths)
HOST_TRAIN, HOST_VALID = 64, 16
HOST_CLI_ARGS: list = []
# the remat phase: 32 synthetic triplets at DATA_HW; plain and remat
# steps at AUG_BATCH and CROP (TRAIN_KW as above), timed over REMAT_STEPS
# after a warm-up, then full-resolution crops at two batches; the plain
# step's parameters and metrics bound the remat step's
REMAT_TRAIN, REMAT_STEPS = 32, 5
REMAT_CROP, REMAT_BATCHES = 480, (8, 24)
REMAT_PARAM_TOL = 1e-6      # abs, parameters after 2 steps
REMAT_METRIC_RTOL = 1e-5    # the 14 metrics of 2 steps
# the parallel phase: data-parallel training at TRAIN_KW on PAR_TRAIN +
# PAR_VALID triplets at DATA_HW, against one process's run of the same
# steps, with Adam eps PAR_ADAM_EPS: Adam's update lr * g / (|g| + eps)
# moves a parameter by up to lr / eps times its gradient's change, so at
# the default 1e-8 the f32 rounding of a near-zero gradient becomes a
# +-lr move whatever the ranks agree on; at eps 1 the bound is lr. Each
# leaf of the state is read as its largest difference from the single
# run over its own change from the common start (at least PAR_FLOOR of
# the largest change of its kind) and held within PAR_SPREAD_K times the
# largest such reading of the single run again on its batch in each
# order of PAR_ORDERS (the reduction order's spread), and at least
# PAR_REL_TOL; each planted fault of PAR_FAULTS must exceed that limit
# (see _par_planted). Then two CLI
# processes on the cli phase's directory, and the pipeline at DATA_HW,
# PIPE_BATCH a batch, PIPE_STREAM batches
PAR_TRAIN, PAR_VALID = 16, 16
PAR_ADAM_EPS = 1.0
PAR_FLOOR = 1e-3
PAR_REL_TOL = 1e-4
PAR_SPREAD_K = 4
PAR_ORDERS = ("rolled by 1", "rolled by -1", "rolled by half", "reversed",
              "halves reversed", "odd rows first")
PAR_FAULTS = ("bn_local", "bn_backward_local", "rank_grad_dropped")
PIPE_BATCH, PIPE_STREAM = 4, 8
# the shard phase: the stacked forward over 2 spatial ranks at SHARD_HW,
# batch 1, timed over SHARD_ITERS after a warm-up; the 1x2x2 forward at
# SHARD_3D_HW, batch 2; the TP step at the parallel phase's configuration
# with the faults of SHARD_FAULTS planted (see _shard_planted)
SHARD_HW = DATA_HW
SHARD_3D_HW = (256, 256)
SHARD_ITERS = 10
SHARD_FAULTS = ("no_reduce", "gather_sums")
# the export phase: artifacts of the serving pair at EXPORT_HW (batch
# EXPORT_BATCH pinned, and symbolic) and at EXPORT_SERVE_HW (symbolic,
# for the daemon and the refusal of a larger image); polyfit sp timed at
# DATA_HW for each (ksize, deg) of POLYFIT_CASES
EXPORT_HW = (256, 256)
EXPORT_BATCH = 32
EXPORT_SERVE_HW = (480, 640)
POLYFIT_CASES = ((5, 1), (5, 2))
# files the phases write (weights, checkpoints, the ISTD directory, PNGs):
# a git-ignored directory of the checkout, removed at the end
SMOKE_DIR = Path("_smoke")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def decoder_steps(h: int, w: int, ngf: int = NGF):
    """The MNet decoder steps of an HxW input: (label, H, W, part
    channels, Co, final). ``final`` steps run without LeakyReLU and BN;
    the final step has Co 1 in G1 and 3 in G2."""
    f = [ngf, 2 * ngf, 4 * ngf, 8 * ngf]
    steps = [(f"{h // 32}x{w // 32} {f[3]}->{f[3]}", h // 32, w // 32,
              (f[3],), f[3], False)]
    for lvl in (2, 1, 0):
        s = 2 ** (lvl + 2)
        steps.append((f"{h // s}x{w // s} ({f[lvl + 1]}+{f[lvl + 1]})->"
                      f"{f[lvl]}", h // s, w // s, (f[lvl + 1],) * 2,
                      f[lvl], False))
    for co in (1, 3):
        steps.append((f"{h // 2}x{w // 2} ({ngf}+{ngf})->{co}", h // 2,
                      w // 2, (ngf, ngf), co, True))
    return steps


def step_inputs(n, h, w, parts, co, final, dtype, gen):
    """Random step inputs on the card; weights at LeCun scale so outputs
    stay O(1) at every width."""
    xs = [torch.randn(n, c, h, w, device=DEVICE, generator=gen).to(dtype)
          .contiguous(memory_format=torch.channels_last) for c in parts]
    ci = sum(parts)
    w4 = (torch.randn(2, 2, ci, 4 * co, device=DEVICE, generator=gen)
          / (4 * ci) ** 0.5).to(dtype)
    if final:
        return xs, w4, None, None
    s4 = (torch.rand(co, device=DEVICE, generator=gen) + 0.5).repeat(4)
    b4 = (torch.randn(co, device=DEVICE, generator=gen) * 0.1).repeat(4)
    return xs, w4, s4, b4


def fma_ceiling_ms(flops, nbytes) -> float:
    """The least time of a step on the CUDA cores: its FLOPs at the f32
    FMA rate or its bytes, whichever is longer."""
    return max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3


def step_cost(n, h, w, parts, co, final, elt):
    """(FLOPs, bytes) a decoder step must do and move: each input read
    once, each output written once."""
    ci = sum(parts)
    flops = 32 * n * h * w * ci * co
    nbytes = (n * h * w * ci * elt + 16 * ci * co * elt
              + (0 if final else 2 * 4 * co * 4) + n * 4 * h * w * co * elt)
    return flops, nbytes


def expected_variant(dtype, final) -> str:
    """The decoder kernel an MNet step at ngf 64 must run on: the final
    step (Co 1 or 3) on the narrow kernel, the others, whose channel
    counts are multiples of 8 on aligned tensors, on the tensor cores in
    bf16 and the CUDA cores in f32."""
    if final:
        return "narrow"
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


def reset_decoder_counts() -> None:
    from shadow_removal_istd_tpu_torch.ops.decoder import decoder_upsample

    decoder_upsample.launches = 0
    for k in decoder_upsample.launches_by_variant:
        decoder_upsample.launches_by_variant[k] = 0


def counted(parts, w4, s4, b4, **kw):
    """``decoder_upsample``'s output and the variant whose count rose."""
    from shadow_removal_istd_tpu_torch.ops.decoder import decoder_upsample

    before = dict(decoder_upsample.launches_by_variant)
    out = decoder_upsample(parts, w4, s4, b4, **kw)
    rose = [k for k, n in decoder_upsample.launches_by_variant.items()
            if n != before[k]]
    return out, "+".join(rose)


def cuda_core_only(parts, w4, scale4=None, bias4=None, *, leaky,
                   zero_pad=False):
    """``decoder_upsample`` with every step on the CUDA-core kernel, the
    kernel every step ran on before the tensor-core variant (timing
    only; not counted)."""
    from shadow_removal_istd_tpu_torch.ops.decoder import _launch

    return _launch(tuple(parts), w4, scale4, bias4, w4.shape[-1] // 4,
                   leaky, zero_pad, "cuda_core")[0]


def decoder_f64(parts, w4, s4, b4, *, leaky, zero_pad=False):
    """The decoder step's spec (``decoder_upsample_plain``) with the
    convolution and the affine in float64: the exact value a kernel's
    bf16 output should round from."""
    from shadow_removal_istd_tpu_torch.ops.decoder import (
        subpixel_depth_to_space,
    )

    F = torch.nn.functional
    n, _, h, w = parts[0].shape
    acc, off = 0.0, 0
    for x in parts:
        a = F.pad((F.leaky_relu(x, 0.2) if leaky else x).double(),
                  (1, 1, 1, 1), mode="constant" if zero_pad else "replicate")
        k = w4[:, :, off:off + x.shape[1]].double().permute(3, 2, 0, 1)
        acc, off = acc + F.conv2d(a, k), off + x.shape[1]
    if s4 is not None:
        acc = acc * s4.double().view(1, -1, 1, 1) \
            + b4.double().view(1, -1, 1, 1)
    return subpixel_depth_to_space(acc, h, w, w4.shape[-1] // 4)


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from shadow_removal_istd_tpu_torch.data import native_loader
    from shadow_removal_istd_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS) + 1) as pool:
        native = pool.submit(native_loader.build)   # g++, beside the nvccs
        built = list(pool.map(_build.build, KERNELS))
        native_lib = native.result()
    for name, (path, log) in zip(KERNELS, built):
        _build.load(name)
        print(f"[build] {path.name}")
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem")):
                print(f"[ptxas] {name}: {line.strip()}")
    if not native_loader.is_available():
        raise SystemExit("the native PNG loader did not load")
    print(f"[build] {native_lib.name} (native PNG loader, g++)")
    print(f"[build] {len(KERNELS)} kernels and the loader in "
          f"{time.perf_counter() - t0:.1f} s")
    libs = ", ".join(
        f"{m} {'present' if importlib.util.find_spec(m) else 'absent'}"
        for m in ("cv2", "PIL", "tensorboard", "tensorboardX", "h5py",
                  "tensorstore", "zstandard", "yaml"))
    zlib = Path("/usr/include/zlib.h").is_file()
    gxx = (subprocess.run(["g++", "--version"], capture_output=True,
                          text=True).stdout.splitlines() or ["?"])[0] \
        if shutil.which("g++") else "absent"
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", cuda {torch.version.cuda}, ninja "
          f"{shutil.which('ninja') or 'absent'}, {libs}, /usr/include/"
          f"zlib.h {'present' if zlib else 'absent'}, g++ {gxx}")
    print(f"[card] {nvidia_smi()}")


def phase_kernel_vs_plain() -> dict:
    from shadow_removal_istd_tpu_torch.ops.decoder import (
        decoder_upsample_plain,
    )

    torch.backends.cudnn.allow_tf32 = False   # the f32 checks hold f32
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for h, w in ((256, 256), (480, 640)):
        for label, sh, sw, parts, co, final in decoder_steps(h, w):
            for dtype in (torch.float32, torch.bfloat16):
                xs, w4, s4, b4 = step_inputs(2, sh, sw, parts, co, final,
                                             dtype, gen)
                forms = [("concat", [torch.cat(xs, 1).contiguous(
                    memory_format=torch.channels_last)])]
                if len(xs) == 2:
                    forms.append(("split", xs))
                # the bf16 validation epoch runs the zero-pad form
                pads = (False, True) if (
                    (h, w) == (480, 640) and dtype == torch.bfloat16) \
                    else (False,)
                for (form, args), zero_pad in [(f, z) for f in forms
                                               for z in pads]:
                    kw = dict(leaky=not final, zero_pad=zero_pad)
                    got, variant = counted(args, w4, s4, b4, **kw)
                    want = decoder_upsample_plain(args, w4, s4, b4, **kw)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    ok = (err <= TOL[dtype] and got.shape == want.shape
                          and variant == expected_variant(dtype, final))
                    worst[dtype] = max(worst[dtype], err)
                    print(f"[check] {h}x{w} step {label:<24} "
                          f"{str(dtype)[6:]:<8} {form:<6} "
                          f"{'zero' if zero_pad else 'edge'} {variant:<11} "
                          f"max_abs_err {err:.3e} (tol {TOL[dtype]:.0e}) "
                          f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise SystemExit(f"kernel disagrees or wrong "
                                         f"variant at {h}x{w} {label} "
                                         f"{dtype} {form} {kw}")
                if (h, w) == (256, 256) and (variant != "cuda_core"
                                             or 4 * sum(parts) == 4096):
                    # outputs off the rounding of the exact value; in f32
                    # at the K = 4096 step, where the sum is longest
                    exact = decoder_f64(args, w4, s4, b4, **kw)
                    runs = [(variant, got), ("plain", want)]
                    if variant != "cuda_core":
                        runs.insert(1, ("cuda_core", cuda_core_only(
                            args, w4, s4, b4, **kw)))
                    print(f"[accuracy] 256x256 step {label:<24} "
                          f"{str(dtype)[6:]} outputs off the rounded f64 "
                          f"value, of {got.numel()} (max abs off f64): "
                          + ", ".join(
                              f"{k} {int((o != exact.to(dtype)).sum())} "
                              f"({(o.double() - exact).abs().max():.2e})"
                              for k, o in runs))
    # the ConvTranspose form (zero padding), f32, at the 16x16 step and
    # the 256x256 final steps (one part, as the validation MNet runs it)
    for sh, parts, co, final in ((16, (512, 512), 256, False),
                                 (128, (128,), 1, True),
                                 (128, (128,), 3, True)):
        xs, w4, s4, b4 = step_inputs(2, sh, sh, parts, co, final,
                                     torch.float32, gen)
        kw = dict(leaky=not final, zero_pad=True)
        got, variant = counted(xs, w4, s4, b4, **kw)
        want = decoder_upsample_plain(xs, w4, s4, b4, **kw)
        err = (got - want).abs().max().item()
        worst[torch.float32] = max(worst[torch.float32], err)
        print(f"[check] zero-pad (ConvTranspose) form {sh}x{sh} "
              f"{'+'.join(map(str, parts))}->{co} f32 {variant} "
              f"max_abs_err {err:.3e}")
        if (err > TOL[torch.float32]
                or variant != expected_variant(torch.float32, final)):
            raise SystemExit("kernel disagrees in the zero-pad form")
    return worst


def _post(addr, body, path="/v1/unshadow"):
    conn = http.client.HTTPConnection(*addr, timeout=300)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def phase_serving() -> tuple[int, dict]:
    from shadow_removal_istd_tpu_torch.models import layers
    from shadow_removal_istd_tpu_torch.ops.decoder import (
        decoder_upsample,
        decoder_upsample_plain,
    )
    from shadow_removal_istd_tpu_torch.serving import (
        InferenceEngine,
        ShadowRemovalServer,
    )
    from shadow_removal_istd_tpu_torch.utils.image_io import (
        imdecode_color,
        png_decode,
        png_encode,
    )

    t0 = time.perf_counter()
    engine = InferenceEngine("mnet", ngf=NGF, dtype="bfloat16",
                             split_skip=True, max_batch=8, seed=0,
                             device=DEVICE)
    engine.warmup([(480, 640), (256, 256)], batch_sizes=[1, 4])
    print(f"[serve] engine ngf {NGF} bf16 split-skip built and warmed in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
            for _ in range(4)] + [rng.integers(0, 256, (256, 256, 3),
                                               dtype=np.uint8)]
    # RGB PNGs whose rows cycle through all five filter types, as a
    # client's libpng picks them adaptively (Average and Paeth included)
    bodies = [png_encode(np.ascontiguousarray(im[..., ::-1]),
                         np.arange(im.shape[0]) % 5) for im in imgs]
    for name, decode in (("server's decoder", imdecode_color),
                         ("stdlib codec", png_decode)):
        decode(bodies[0])
        t0 = time.perf_counter()
        for body in bodies[:4]:
            decode(body)
        print(f"[serve] host decode of one 480x640 request, {name}: "
              f"{(time.perf_counter() - t0) / 4 * 1e3:.2f} ms")
    srv = ShadowRemovalServer(engine, port=0, window_ms=50.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        reset_decoder_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
            replies = list(pool.map(lambda b: _post(srv.address, b), bodies))
        wall = time.perf_counter() - t0
        launches = decoder_upsample.launches
        by_variant = dict(decoder_upsample.launches_by_variant)
        snap = srv.stats.snapshot()
    finally:
        srv.shutdown()
        thread.join(timeout=10)
    for im, (status, body) in zip(imgs, replies):
        if status != 200:
            raise SystemExit(f"request failed with HTTP {status}: {body!r}")
        out = imdecode_color(body)
        if out.shape != im.shape:
            raise SystemExit(f"reply shape {out.shape} != {im.shape}")
    print(f"[serve] {len(replies)} concurrent requests (4x 480x640, "
          f"1x 256x256) answered in {wall:.3f} s; batches "
          f"{snap['batches']}, kernel launches {launches} {by_variant}")
    nb = snap["batches"]
    if (launches == 0 or launches != 10 * nb
            or by_variant != {"tensor_core": 8 * nb, "narrow": 2 * nb,
                              "cuda_core": 0}):
        raise SystemExit(f"expected 10 kernel launches per stacked "
                         f"forward (8 tensor-core, 2 narrow), got "
                         f"{launches} {by_variant} for {nb}")
    got = engine.infer_group(imgs[:4])
    with mock.patch.object(layers, "decoder_upsample",
                           decoder_upsample_plain):
        want = engine.infer_group(imgs[:4])
    diff = max(int(np.abs(g.astype(np.int16) - p).max())
               for gp, pp in zip(got, want) for g, p in zip(gp, pp))
    print(f"[serve] kernel vs plain decoder, 480x640 batch 4 uint8: max "
          f"diff {diff} gray levels (limit 2)")
    if diff > 2:
        raise SystemExit("kernel path disagrees with the plain decoder")
    return launches, by_variant


def phase_timings(worst_err: dict, launches: int, by_variant: dict) -> dict:
    from shadow_removal_istd_tpu_torch.models import layers
    from shadow_removal_istd_tpu_torch.ops.decoder import (
        decoder_upsample,
        decoder_upsample_plain,
    )
    from shadow_removal_istd_tpu_torch.serving import InferenceEngine

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    dt = torch.bfloat16
    totals = {}
    for (h, w), n in (((256, 256), 32), ((480, 640), 4)):
        # sums over the forward's 10 launches, and apart over its 8 wide
        # steps and its 2 final ones
        tot = {f"{g}{k}": 0.0 for g in ("", "wide_", "final_")
               for k in ("ms", "cuda_core_ms", "plain_ms", "library_ms",
                         "bound_ms", "fma_ms")}
        tot.update(ops_ms=0.0, bytes_ms=0.0)
        for label, sh, sw, parts, co, final in decoder_steps(h, w):
            xs, w4, s4, b4 = step_inputs(n, sh, sw, parts, co, final, dt,
                                         gen)
            kw = dict(leaky=not final, zero_pad=False)
            # the timed inputs, held to the plain version first, through
            # the chosen kernel and through the CUDA-core one
            want = decoder_upsample_plain(xs, w4, s4, b4, **kw).float()
            got, variant = counted(xs, w4, s4, b4, **kw)
            err = (got.float() - want).abs().max().item()
            err_cc = (cuda_core_only(xs, w4, s4, b4, **kw).float()
                      - want).abs().max().item()
            worst_err[dt] = max(worst_err[dt], err, err_cc)
            ok = (max(err, err_cc) <= TOL[dt]
                  and variant == expected_variant(dt, final))
            print(f"[check] {h}x{w} b{n} step {label:<24} bfloat16 "
                  f"{'split' if len(xs) == 2 else 'single'} {variant} "
                  f"max_abs_err {err:.3e}, cuda_core {err_cc:.3e} (tol "
                  f"{TOL[dt]:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"kernel disagrees or wrong variant at "
                                 f"{h}x{w} b{n} {label}")
            ms = time_ms(lambda: decoder_upsample(xs, w4, s4, b4, **kw))
            ms_cc = (ms if variant == "cuda_core" else
                     time_ms(lambda: cuda_core_only(xs, w4, s4, b4, **kw)))
            plain = time_ms(
                lambda: decoder_upsample_plain(xs, w4, s4, b4, **kw))
            # the step's convolution alone, as one cuDNN call
            a = torch.nn.functional.pad(torch.cat(xs, 1), (1, 1, 1, 1),
                                        mode="replicate")
            k = w4.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib = time_ms(lambda: torch.nn.functional.conv2d(a, k))
            flops, nbytes = step_cost(n, sh, sw, parts, co, final, 2)
            t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
            bound = max(t_ops, t_bytes)
            fma = fma_ceiling_ms(flops, nbytes)
            print(f"[time] {h}x{w} b{n} step {label:<24} {variant} "
                  f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s) | "
                  f"cuda_core {ms_cc:.4f} ({flops / ms_cc / 1e9:.1f} "
                  f"TFLOP/s) | plain {plain:.4f} | cudnn conv {lib:.4f} | "
                  f"bound {bound:.4f} "
                  f"({'ops' if t_ops >= t_bytes else 'bytes'}) | f32 FMA "
                  f"ceiling {fma:.4f}")
            reps = 1 if final else 2        # G1 and G2 each run the step
            group = "final_" if final else "wide_"
            for key, v in (("ms", ms), ("cuda_core_ms", ms_cc),
                           ("plain_ms", plain), ("library_ms", lib),
                           ("bound_ms", bound), ("fma_ms", fma)):
                tot[key] += reps * v
                tot[group + key] += reps * v
            tot["ops_ms"] += reps * t_ops
            tot["bytes_ms"] += reps * t_bytes
        print(f"[time] {h}x{w} b{n} per stacked forward (10 launches): "
              f"kernels {tot['ms']:.4f} ms, cuda_core only "
              f"{tot['cuda_core_ms']:.4f}, plain {tot['plain_ms']:.4f}, "
              f"cudnn conv {tot['library_ms']:.4f}, bound "
              f"{tot['bound_ms']:.4f}")
        print(f"[time] {h}x{w} b{n} wide bf16 steps (8 launches): "
              f"tensor_core {tot['wide_ms']:.4f} ms, cuda_core "
              f"{tot['wide_cuda_core_ms']:.4f}, cudnn conv "
              f"{tot['wide_library_ms']:.4f}, bound "
              f"{tot['wide_bound_ms']:.4f}")
        print(f"[time] {h}x{w} b{n} final steps (2 launches): narrow "
              f"{tot['final_ms']:.4f} ms, cuda_core "
              f"{tot['final_cuda_core_ms']:.4f}, plain "
              f"{tot['final_plain_ms']:.4f}, cudnn conv "
              f"{tot['final_library_ms']:.4f}, bound "
              f"{tot['final_bound_ms']:.4f}, f32 FMA ceiling "
              f"{tot['final_fma_ms']:.4f}")
        totals[(h, w)] = tot

    engine = InferenceEngine("mnet", ngf=NGF, dtype="bfloat16",
                             split_skip=True, max_batch=32, seed=0,
                             device=DEVICE)
    x = torch.randint(0, 256, (32, 256, 256, 3), dtype=torch.uint8,
                      device=DEVICE, generator=gen)
    # in turns: kernels, CUDA-core only, plain, CUDA-core only, kernels
    runs = {}
    for name, fn in (("kernels", decoder_upsample),
                     ("cuda_core", cuda_core_only),
                     ("plain", decoder_upsample_plain),
                     ("cuda_core", cuda_core_only),
                     ("kernels", decoder_upsample)):
        with mock.patch.object(layers, "decoder_upsample", fn):
            runs.setdefault(name, []).append(
                time_ms(lambda: engine._stacked(x), iters=10))
    ms = sum(runs["kernels"]) / 2
    print("[time] stacked G1+G2 256x256 b32 bf16: " + "; ".join(
        f"{name} {32e3 * len(v) / sum(v):.1f} img/s ("
        + ", ".join(f"{t:.3f}" for t in v) + " ms/batch)"
        for name, v in runs.items()))
    img = np.random.default_rng(1).integers(0, 256, (480, 640, 3),
                                            dtype=np.uint8)
    engine.infer_group([img] * 4)
    t0 = time.perf_counter()
    for _ in range(5):
        engine.infer_group([img] * 4)
    print(f"[time] infer_group 480x640 b4 bf16 (host included): "
          f"{(time.perf_counter() - t0) / 5 * 1e3:.2f} ms")
    f32 = time_f32_serving(gen, x)
    profile_stacked(engine, x)

    t = totals[(256, 256)]
    return {"name": "decoder_upsample", "route": "cuda", "source": SOURCE_TC,
            "sources": [SOURCE_TC, SOURCE_NARROW, SOURCE],
            "replaces": REPLACES, "launches": launches,
            "launches_by_variant": by_variant,
            "max_abs_err": max(worst_err.values()),
            "max_abs_err_f32": worst_err[torch.float32],
            "ms": round(t["ms"], 5),
            "cuda_core_ms": round(t["cuda_core_ms"], 5),
            "wide_ms": round(t["wide_ms"], 5),
            "wide_cuda_core_ms": round(t["wide_cuda_core_ms"], 5),
            "narrow_ms": round(t["final_ms"], 5),
            "narrow_cuda_core_ms": round(t["final_cuda_core_ms"], 5),
            "stacked_img_s": round(32e3 / ms, 2),
            "plain_ms": round(t["plain_ms"], 5),
            "bound_ms": round(t["bound_ms"], 5),
            "bound_by": ("operations" if t["ops_ms"] >= t["bytes_ms"]
                         else "bytes"),
            "library_ms": round(t["library_ms"], 5),
            "shape": "one stacked G1+G2 forward, 256x256, batch 32, bf16",
            **f32}


def time_f32_serving(gen, x) -> dict:
    """f32 serving (``InferenceEngine(dtype="float32")``, the exact-eval
    numerics) at 256x256, batch 32: each wide step on the CUDA-core kernel,
    held to its plain version, beside one cuDNN f32 convolution (TF32 off)
    and its f32 FMA ceiling; then the stacked forward's img/s, whose 10
    launches must be 8 CUDA-core and 2 narrow."""
    from shadow_removal_istd_tpu_torch.models import layers
    from shadow_removal_istd_tpu_torch.ops.decoder import (
        decoder_upsample,
        decoder_upsample_plain,
    )
    from shadow_removal_istd_tpu_torch.serving import InferenceEngine

    dt, n = torch.float32, x.shape[0]
    tot = dict.fromkeys(("ms", "library_ms", "bound_ms", "flops"), 0.0)
    for label, sh, sw, parts, co, final in decoder_steps(256, 256):
        if final:
            continue
        xs, w4, s4, b4 = step_inputs(n, sh, sw, parts, co, final, dt, gen)
        kw = dict(leaky=True, zero_pad=False)
        got, variant = counted(xs, w4, s4, b4, **kw)
        err = (got - decoder_upsample_plain(xs, w4, s4, b4, **kw)
               ).abs().max().item()
        if err > TOL[dt] or variant != "cuda_core":
            raise SystemExit(f"f32 serving step {label}: {variant} "
                             f"max_abs_err {err:.3e}")
        ms = time_ms(lambda: decoder_upsample(xs, w4, s4, b4, **kw), 10)
        a = torch.nn.functional.pad(torch.cat(xs, 1), (1, 1, 1, 1),
                                    mode="replicate")
        k = w4.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = time_ms(lambda: torch.nn.functional.conv2d(a, k), 10)
        flops, nbytes = step_cost(n, sh, sw, parts, co, final, 4)
        bound = fma_ceiling_ms(flops, nbytes)
        print(f"[time] f32 serving 256x256 b{n} step {label:<24} "
              f"{variant} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"{100 * bound / ms:.0f} % of the f32 FMA ceiling) | cudnn "
              f"conv {lib:.4f} | bound {bound:.4f} | max_abs_err "
              f"{err:.2e}")
        for key, v in (("ms", ms), ("library_ms", lib), ("bound_ms", bound),
                       ("flops", flops)):
            tot[key] += 2 * v               # G1 and G2 each run the step
    print(f"[time] f32 serving 256x256 b{n} wide steps (8 launches, "
          f"{tot['flops']:.4g} FLOP): cuda_core {tot['ms']:.4f} ms, cudnn "
          f"conv {tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f}")
    engine = InferenceEngine("mnet", ngf=NGF, dtype="float32",
                             split_skip=True, max_batch=n, seed=0,
                             device=DEVICE)
    engine._stacked(x)
    torch.cuda.synchronize()
    reset_decoder_counts()
    engine._stacked(x)
    torch.cuda.synchronize()
    by_variant = dict(decoder_upsample.launches_by_variant)
    if by_variant != {"tensor_core": 0, "cuda_core": 8, "narrow": 2}:
        raise SystemExit(f"f32 stacked forward: expected 8 cuda_core and 2 "
                         f"narrow launches, got {by_variant}")
    runs = {}
    for name, fn in (("kernels", decoder_upsample),
                     ("plain", decoder_upsample_plain),
                     ("kernels", decoder_upsample)):
        with mock.patch.object(layers, "decoder_upsample", fn):
            runs.setdefault(name, []).append(
                time_ms(lambda: engine._stacked(x), iters=5))
    print(f"[time] stacked G1+G2 256x256 b{n} f32 (launches {by_variant}): "
          + "; ".join(f"{name} {n * 1e3 * len(v) / sum(v):.1f} img/s ("
                      + ", ".join(f"{t:.3f}" for t in v) + " ms/batch)"
                      for name, v in runs.items()))
    return {"f32_wide_ms": round(tot["ms"], 5),
            "f32_wide_library_ms": round(tot["library_ms"], 5),
            "f32_wide_bound_ms": round(tot["bound_ms"], 5),
            "f32_stacked_img_s": round(
                n * 1e3 * len(runs["kernels"]) / sum(runs["kernels"]), 2)}


def profile_stacked(engine, x, label: str = "stacked 256x256 b32") -> None:
    """Device time by kernel over one stacked forward (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    engine._stacked(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine._stacked(x)
        torch.cuda.synchronize()
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    rows = [e for e in prof.key_averages() if dev_us(e) > 0]
    # kernel rows only: an aten op and the kernels it launches are
    # separate rows, and summing both counted the time twice
    rows = [e for e in rows if getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA] or rows
    total = sum(dev_us(e) for e in rows)
    print(f"[profile] {label}: device time {total / 1e3:.3f} ms "
          f"over {len(rows)} kernel names, {sum(e.count for e in rows)} "
          f"launches")
    for e in sorted(rows, key=lambda e: -dev_us(e))[:12]:
        print(f"[profile] {dev_us(e) / 1e3:9.3f} ms "
              f"{100 * dev_us(e) / max(total, 1):5.1f}% "
              f"x{e.count:<4} {e.key[:90]}")


def _record_passes(fn):
    """Run ``fn()`` with ``ops.shear.hshear`` wrapped to record each
    call's ``(img, shifts, out_w, pad, transpose_out)``; returns (fn's
    result, calls)."""
    from shadow_removal_istd_tpu_torch.ops import shear

    calls, real = [], shear.hshear

    def recorder(img, shifts, out_w, pad, *, transpose_out=False):
        calls.append((img, shifts, out_w, pad, transpose_out))
        return real(img, shifts, out_w, pad, transpose_out=transpose_out)

    with mock.patch.object(shear, "hshear", recorder):
        out = fn()
    return out, calls


def _aug_inputs(gen):
    """A batch-16 group of 7 uint8 channels at 480x640 and one draw of
    augmentation parameters, on the card."""
    from shadow_removal_istd_tpu_torch.ops.augment import (
        AugmentConfig,
        sample_augment_params,
    )

    b, (h, w), crop = AUG_BATCH, DATA_HW, CROP
    u8 = torch.randint(0, 256, (b, h, w, 7), dtype=torch.uint8,
                       device=DEVICE, generator=gen)
    params = sample_augment_params(gen, b, (h, w),
                                   AugmentConfig(crop_size=crop,
                                                 method="shear"), DEVICE)
    return u8, params


def shear_cost(img, shifts, out_w, pad) -> tuple[float, float]:
    """(ops, bytes) an ``hshear`` call must do and move with these
    inputs: the image columns each row's taps reach, read once, the
    output written once, the per-row start and fraction read once; 3
    FLOPs per output (1 - f, two products, a sum: the 1 - f once per
    row)."""
    from shadow_removal_istd_tpu_torch.ops.shear import _taps

    bsz, c, h, w0 = img.shape
    kint, _ = _taps(img, shifts, out_w, pad)
    lo = (kint.long() - pad).clamp(min=0)
    hi = (kint.long() + out_w - pad).clamp(max=w0 - 1)
    cols = (hi - lo + 1).clamp(min=0).sum().item()
    nbytes = 4 * c * cols + 4 * bsz * c * h * out_w + 8 * bsz * h
    return 3.0 * bsz * c * h * out_w, float(nbytes)


def grid_for(img, shifts, out_w):
    """The ``F.grid_sample`` grid (align_corners) that samples row r at
    columns ``shifts[r] + j``: the same row shifts as ``hshear`` except
    where its start is clipped."""
    bsz, _, h, w0 = img.shape
    j = torch.arange(out_w, device=img.device, dtype=torch.float32)
    xs = (shifts[:, :, None] + j) * (2.0 / (w0 - 1)) - 1.0
    ys = (torch.arange(h, device=img.device, dtype=torch.float32)
          * (2.0 / max(h - 1, 1)) - 1.0)[None, :, None].expand_as(xs)
    return torch.stack([xs, ys], dim=-1)


def _layout_name(transpose_out: bool) -> str:
    return "transposed" if transpose_out else "normal"


def phase_shear_vs_plain() -> float:
    """``hshear`` against ``hshear_plain``: each pass of one augmentation
    in the layout the path gives it, and ragged cases (tiles cut at both
    edges, W0 off 4 so 4-byte copies run, pad 0, out_w > W0, a
    misaligned ``img`` view) in both layouts; the outputs must agree bit
    for bit (and within SHEAR_TOL). Then ``fused_augment_shear`` through
    the kernel against its plain path."""
    from shadow_removal_istd_tpu_torch.ops import shear

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    u8, params = _aug_inputs(gen)
    got, calls = _record_passes(
        lambda: shear.fused_augment_shear(u8, params, CROP))
    if [c[4] for c in calls] != [True, True, False]:
        raise SystemExit(f"fused_augment_shear made hshear calls with "
                         f"transpose_out {[c[4] for c in calls]}, expected "
                         "[True, True, False]")
    worst = 0.0
    cases = [(f"pass {i + 1}", *call) for i, call in enumerate(calls)]
    for b, c, h, w0, out_w, pad, lo, hi in (
            (1, 1, 5, 37, 29, 3, -9.0, 40.0),       # clips both ends
            (2, 3, 13, 300, 257, 11, -20.0, 60.0),  # out_w one past a tile
            (3, 7, 9, 64, 700, 400, -400.0, 100.0),  # out_w > W0
            (1, 7, 17, 255, 1, 0, -3.0, 300.0),     # one output column
            (2, 7, 33, 66, 70, 5, -8.0, 8.0),       # W0 % 4 == 2, H 33
            (1, 8, 40, 480, 256, 0, 0.0, 223.0),    # pad 0, C 8
            (2, 7, 36, 712, 130, 4, -4.0, 580.0)):  # out_w % 4 == 2
        img = torch.rand(b, c, h, w0, device=DEVICE, generator=gen) * 255
        shifts = lo + (hi - lo) * torch.rand(b, h, device=DEVICE,
                                             generator=gen)
        cases += [("ragged", img, shifts, out_w, pad, t)
                  for t in (False, True)]
    # a contiguous view 4 bytes past a 16-byte boundary, NaN around it
    n = 2 * 7 * 40 * 64
    buf = torch.full((n + 4,), float("nan"), device=DEVICE)
    img = buf[1:1 + n].view(2, 7, 40, 64)
    img.copy_(torch.rand(2, 7, 40, 64, device=DEVICE, generator=gen) * 255)
    shifts = -12.0 + 24.0 * torch.rand(2, 40, device=DEVICE, generator=gen)
    cases += [("misaligned", img, shifts, 72, 8, t) for t in (False, True)]
    for label, img, shifts, out_w, pad, t in cases:
        k = shear.hshear(img, shifts, out_w, pad, transpose_out=t)
        p = shear.hshear_plain(img, shifts, out_w, pad, transpose_out=t)
        torch.cuda.synchronize()
        err = (k - p).abs().max().item()
        differ = int((k != p).sum())
        worst = max(worst, err)
        ok = err <= SHEAR_TOL and differ == 0 and k.shape == p.shape
        print(f"[check] hshear {label:<10} in {tuple(img.shape)} out_w "
              f"{out_w} pad {pad} {_layout_name(t):<10}: {differ} of "
              f"{k.numel()} outputs differ from plain, max_abs_err "
              f"{err:.3e} (tol {SHEAR_TOL:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"hshear kernel disagrees ({label})")
    with mock.patch.object(shear, "hshear", shear.hshear_plain):
        want = shear.fused_augment_shear(u8, params, CROP)
    err = (got - want).abs().max().item()
    print(f"[check] fused_augment_shear b{AUG_BATCH} {DATA_HW[0]}x"
          f"{DATA_HW[1]}x7 -> {CROP}: kernel vs plain max_abs_err "
          f"{err:.3e} (tol {AUG_TOL:.0e})")
    if err > AUG_TOL or got.shape != (AUG_BATCH, 7, CROP, CROP):
        raise SystemExit("fused_augment_shear disagrees with its plain path")
    return worst


def _snapshot(trainer) -> dict:
    return {k: [t.detach().clone() for t in
                (*net.parameters(), *net.buffers())]
            for k, net in zip(("G1", "G2", "D1", "D2"),
                              trainer.state.models.all())}


def _check_history(trainer, label) -> None:
    for i, h in enumerate(trainer.history):
        bad = [k for k, v in h.items() if not math.isfinite(v)]
        print(f"[train] {label} epoch {i}: " + ", ".join(
            f"{k} {h[k]:.4f}" for k in ("G", "D", "data1", "data2", "vis1",
                                        "vis2")))
        if bad:
            raise SystemExit(f"{label} epoch {i}: non-finite {bad}")
    total = trainer.last_valid["total"]
    print(f"[train] {label} validation total {total:.4f}")
    if not math.isfinite(total):
        raise SystemExit(f"{label}: non-finite validation total")


def write_vgg_npz(path: Path) -> None:
    """A seeded random VGG-19-BN as the converted ``.npz`` that
    ``--vgg-weights`` reads (``models/vgg.py::load_vgg_npz``'s keys,
    kernels HWIO)."""
    from shadow_removal_istd_tpu_torch.models.vgg import (
        VGG19Features,
        init_vgg_,
    )

    vgg = init_vgg_(VGG19Features(), torch.Generator().manual_seed(0))
    arrays = {}
    for i, m in enumerate(vgg.convbns()):
        for key, t in ((f"conv{i}_kernel", m.weight.permute(2, 3, 1, 0)),
                       (f"conv{i}_bias", m.bias),
                       (f"bn{i}_scale", m.bn_weight),
                       (f"bn{i}_bias", m.bn_bias),
                       (f"bn{i}_mean", m.running_mean),
                       (f"bn{i}_var", m.running_var)):
            arrays[key] = t.detach().contiguous().numpy()
    np.savez(path, **arrays)


def phase_training(vgg_path: Path) -> dict:
    from shadow_removal_istd_tpu_torch.data.synthetic import (
        synthetic_triplets,
    )
    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
    from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer
    from shadow_removal_istd_tpu_torch.ops.decoder import decoder_upsample
    from shadow_removal_istd_tpu_torch.ops.shear import hshear

    t0 = time.perf_counter()
    train = synthetic_triplets(N_TRAIN, *DATA_HW, seed=0)
    valid = synthetic_triplets(N_VALID, *DATA_HW, seed=1)
    print(f"[train] {N_TRAIN} + {N_VALID} synthetic {DATA_HW[0]}x"
          f"{DATA_HW[1]} triplets in {time.perf_counter() - t0:.1f} s")
    out = {}
    for dtype, epochs in (("float32", 2), ("bfloat16", 1)):
        cfg = TrainConfig(aug_method="shear", compute_dtype=dtype,
                          **TRAIN_KW)
        files = SMOKE_DIR / f"train_{dtype}"
        run = RunConfig(seed=0, valid_every=1, vgg_weights=str(vgg_path),
                        weights_dir=str(files), logs_dir=str(files),
                        checkpoint_path=str(files / "checkpoint.msgpack"),
                        device_cache=True)
        t0 = time.perf_counter()
        trainer = Trainer(cfg, run, train_streams=train,
                          valid_streams=valid, device=DEVICE)
        before = _snapshot(trainer)
        hshear.launches = 0
        reset_decoder_counts()
        trainer.train(epochs)
        torch.cuda.synchronize()
        n_shear, n_dec = hshear.launches, decoder_upsample.launches
        by_variant = dict(decoder_upsample.launches_by_variant)
        wall = time.perf_counter() - t0
        steps = epochs * trainer.cfg.steps_per_epoch
        # validation batches, one image log per validation and the
        # epoch-0 training image log (vis_every 50), whose augmentation
        # is 3 more hshear launches
        n_valid = epochs * -(-N_VALID // cfg.batch_size)
        n_fwd = n_valid + epochs + 1
        print(f"[train] {dtype}: {epochs} epochs x "
              f"{trainer.cfg.steps_per_epoch} steps + {epochs} validations "
              f"in {wall:.1f} s (build, first calls and the epoch-0 weight "
              f"and checkpoint files included); hshear "
              f"launches {n_shear} ({steps} steps + the image log's "
              f"augmentation), decoder launches {n_dec} {by_variant} "
              f"({n_valid} validation batches + {epochs + 1} image logs)")
        _check_history(trainer, dtype)
        if n_shear != 3 * (steps + 1):
            raise SystemExit(f"expected {3 * (steps + 1)} hshear launches, "
                             f"got {n_shear}")
        wide = 8 * n_fwd
        want = {"tensor_core": wide if dtype == "bfloat16" else 0,
                "cuda_core": 0 if dtype == "bfloat16" else wide,
                "narrow": 2 * n_fwd}
        if n_dec != 10 * n_fwd or by_variant != want:
            raise SystemExit(f"expected {10 * n_fwd} decoder launches "
                             f"{want}, got {n_dec} {by_variant}")
        after = _snapshot(trainer)
        for net in before:
            moved = [float((a.float() - b.float()).abs().max())
                     for a, b in zip(before[net], after[net])]
            n_params = len(list(getattr(
                trainer.state.models, net.lower()).parameters()))
            print(f"[train] {dtype} {net}: largest move "
                  f"{max(moved[:n_params]):.3e} (parameters), "
                  f"{max(moved[n_params:]):.3e} (BN running stats)")
            if min(max(moved[:n_params]), max(moved[n_params:])) <= 0:
                raise SystemExit(f"{net} did not train")
        out[dtype] = dict(trainer=trainer, shear_launches=n_shear,
                          decoder_launches=n_dec)
    return out


def _leaves_differ(a: dict, b: dict) -> tuple[int, int]:
    """(leaves, leaves not bit-identical) of two flax-form state trees."""
    from shadow_removal_istd_tpu_torch.tools.convert import flatten_tree

    fa, fb = flatten_tree(a), flatten_tree(b)
    if fa.keys() != fb.keys():
        return len(fa), len(fa.keys() ^ fb.keys())
    bad = sum(1 for k in fa if fa[k] is not None and not (
        np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype
        and np.array_equal(fa[k], fb[k])))
    return len(fa), bad


def _adam_steps(state) -> list:
    """Every parameter's Adam ``step`` as (dtype, device, value), in the
    optimizers' order."""
    return [(t.dtype, t.device, float(t))
            for o in (state.opt_g, state.opt_d)
            for g in o.param_groups for p in g["params"]
            for t in (o.state[p]["step"],)]


def phase_cli(vgg_path: Path) -> dict:
    """``cli.main`` over an ISTD directory: train -> checkpoint -> infer,
    the same infer on the plain decoder, then a run resumed from the
    checkpoint. Returns the kernels' launch counts in the train + infer
    run."""
    import logging

    from shadow_removal_istd_tpu_torch.cli.main import build_parser
    from shadow_removal_istd_tpu_torch.cli.main import main as cli_main
    from shadow_removal_istd_tpu_torch.data.istd import ISTDDataset
    from shadow_removal_istd_tpu_torch.data.synthetic import (
        write_istd_layout,
    )
    from shadow_removal_istd_tpu_torch.engine import loop
    from shadow_removal_istd_tpu_torch.models import layers
    from shadow_removal_istd_tpu_torch.ops.decoder import (
        decoder_upsample,
        decoder_upsample_plain,
    )
    from shadow_removal_istd_tpu_torch.ops.shear import hshear
    from shadow_removal_istd_tpu_torch.tools.convert import (
        load_train_state,
        train_state_to_flax,
    )
    from shadow_removal_istd_tpu_torch.utils import image_io
    from shadow_removal_istd_tpu_torch.utils.msgpack_codec import (
        from_bytes,
        to_bytes,
    )

    t_phase = time.perf_counter()
    root = SMOKE_DIR / "cli"
    istd = root / "istd"
    t0 = time.perf_counter()
    write_istd_layout(str(istd), CLI_TRAIN, CLI_TEST, *DATA_HW)
    print(f"[cli] wrote an ISTD directory of {CLI_TRAIN} + {CLI_TEST} "
          f"{DATA_HW[0]}x{DATA_HW[1]} triplets (port PNG encoder, rows in "
          f"all five filter types) in {time.perf_counter() - t0:.1f} s")
    lib = image_io._library_decoder()
    lib_name = ("the stdlib codec" if lib is None else
                "cv2" if importlib.util.find_spec("cv2") else "PIL")
    decoders = [(lib_name, lib)] + ([("the stdlib codec", None)]
                                    if lib is not None else [])
    for name, dec in decoders:
        with mock.patch.object(image_io, "_library_decoder", lambda: dec):
            for stream in ("img", "matte", "target"):
                t0 = time.perf_counter()
                ISTDDataset(str(istd), "train", datas=(stream,)).load_all(
                    native=False)
                dt = time.perf_counter() - t0
                threads = os.cpu_count() if dec is not None else 1
                print(f"[time] istd load {stream:<6} {DATA_HW[0]}x"
                      f"{DATA_HW[1]}: {dt / CLI_TRAIN:.4f} s per image "
                      f"({CLI_TRAIN} images, {name}, {threads} threads)")
    one = (istd / "train" / "train_A" / "000-train.png").read_bytes()
    t0 = time.perf_counter()
    for _ in range(3):
        image_io.png_decode(one)
    print(f"[time] istd load one {DATA_HW[0]}x{DATA_HW[1]} RGB PNG, stdlib "
          f"codec, one thread: {(time.perf_counter() - t0) / 3:.4f} s")

    base = ["--data-dir", str(istd), "--vgg-weights", str(vgg_path),
            "--weights", str(root / "w"), "--logs", str(root / "l"),
            *CLI_ARGS]
    suffix = "_lr0.00050_SGAN"
    wdir = root / f"w{suffix}"
    seen: dict = {"save": [], "load": [], "infer": [], "trainers": []}
    orig = {k: getattr(loop.Trainer, k)
            for k in ("train", "save", "load", "infer")}

    def train(self, epochs):
        seen["trainers"].append(self)
        return orig["train"](self, epochs)

    def save(self, epoch):
        t0 = time.perf_counter()
        orig["save"](self, epoch)
        seen["save"].append(time.perf_counter() - t0)

    def load(self, path=None):
        t0 = time.perf_counter()
        orig["load"](self, path)
        seen["load"].append(time.perf_counter() - t0)
        seen["loaded"] = (self.start_epoch, train_state_to_flax(self.state),
                          _adam_steps(self.state))

    def infer(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = orig["infer"](self)
        torch.cuda.synchronize()
        seen["infer"].append((n, time.perf_counter() - t0))
        return n

    def run_cli(*argv):
        handlers = list(logging.getLogger().handlers)
        try:
            with mock.patch.multiple(loop.Trainer, train=train, save=save,
                                     load=load, infer=infer):
                cli_main(build_parser().parse_args([*argv, *base]))
        finally:    # each run adds its log handlers to the root logger
            for h in logging.getLogger().handlers[len(handlers):]:
                h.close()
            logging.getLogger().handlers[:] = handlers
        torch.cuda.synchronize()

    # 1. train 2 epochs (validating and saving after each), then infer
    t0 = time.perf_counter()
    hshear.launches = 0
    reset_decoder_counts()
    run_cli("--tasks", "train", "infer", "--epochs", "2", "--valid-every",
            "1", "--save-every", "1", "--log-every", "1", "--infered",
            str(root / "out"))
    n_shear, n_dec = hshear.launches, decoder_upsample.launches
    by_variant = dict(decoder_upsample.launches_by_variant)
    wall = time.perf_counter() - t0
    trainer = seen["trainers"][0]
    b = trainer.cfg.batch_size
    steps = 2 * trainer.cfg.steps_per_epoch
    # 2 validations + infer, an image log per validation and the epoch-0
    # training one (vis_every 50), whose augmentation is 3 hshear launches
    forwards = 3 * -(-CLI_TEST // b) + 3
    print(f"[cli] --tasks train infer: 2 epochs x "
          f"{trainer.cfg.steps_per_epoch} steps + 2 validations + infer of "
          f"{CLI_TEST} in {wall:.1f} s (data load, first calls and files "
          f"included); hshear launches {n_shear} ({steps} steps + the image "
          f"log's augmentation), decoder launches {n_dec} {by_variant} "
          f"({forwards} stacked forwards with the 3 image logs)")
    _check_history(trainer, "cli")
    if n_shear != 3 * (steps + 1):
        raise SystemExit(f"cli: expected {3 * (steps + 1)} hshear "
                         f"launches, got {n_shear}")
    want = {"tensor_core": 0, "cuda_core": 8 * forwards,
            "narrow": 2 * forwards}
    if n_dec != 10 * forwards or by_variant != want:
        raise SystemExit(f"cli: expected {10 * forwards} decoder launches "
                         f"{want}, got {n_dec} {by_variant}")
    names = sorted(f"{n}_{c}_{s}.msgpack" for n, c in (
        ("G1", "MNet"), ("G2", "MNet"), ("D1", "PatchGAN"),
        ("D2", "PatchGAN")) for s in ("best", "latest"))
    missing = [f for f in [*names, "checkpoint.msgpack"]
               if not (wdir / f).is_file()]
    if missing:
        raise SystemExit(f"cli: missing files {missing}")
    mb = (wdir / "checkpoint.msgpack").stat().st_size / 1e6
    weights_mb = sum((wdir / f).stat().st_size for f in names) / 2e6
    print(f"[time] checkpoint save ({mb:.1f} MB): " + ", ".join(
        f"{t * 1e3:.1f}" for t in seen["save"]) + " ms; the 4 weight "
        f"files of one suffix: {weights_mb:.1f} MB")
    # the save and the load by part, on the trained state (the load puts
    # the same values back)
    t = [time.perf_counter()]
    tree = train_state_to_flax(trainer.state)
    t.append(time.perf_counter())
    data = to_bytes({"epoch": 2, "state": tree})
    t.append(time.perf_counter())
    (root / "parts.msgpack").write_bytes(data)
    t.append(time.perf_counter())
    data = (root / "parts.msgpack").read_bytes()
    t.append(time.perf_counter())
    tree = from_bytes(data)["state"]
    t.append(time.perf_counter())
    load_train_state(tree, trainer.state)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    ms = [(b_ - a) * 1e3 for a, b_ in zip(t, t[1:])]
    print(f"[time] checkpoint parts: state -> host tree {ms[0]:.1f} ms, "
          f"encode {ms[1]:.1f}, write {ms[2]:.1f}; read {ms[3]:.1f}, "
          f"decode {ms[4]:.1f}, into the state {ms[5]:.1f}")
    del data, tree
    (n_img, dt), = seen["infer"]
    print(f"[time] cli infer: {n_img} images {DATA_HW[0]}x{DATA_HW[1]} "
          f"in {dt:.3f} s = "
          f"{n_img / dt:.1f} img/s (G1 -> G2 f32 and PNG writes, batch {b})")
    outs = {}
    for sub, read, shape in (("shadowless", image_io.imread_color,
                              (*DATA_HW, 3)),
                             ("matte", image_io.imread_gray, DATA_HW)):
        files = sorted((root / "out" / sub / "istd").glob("*.png"))
        arrays = [read(str(f)) for f in files]
        if len(files) != CLI_TEST or any(a.shape != shape for a in arrays):
            raise SystemExit(f"cli infer: {sub}: {len(files)} PNGs of "
                             f"shapes {sorted({a.shape for a in arrays})}")
        outs[sub] = arrays

    # 2. the same inference on the plain decoder
    with mock.patch.object(layers, "decoder_upsample",
                           decoder_upsample_plain):
        run_cli("--tasks", "infer", "--load-weights-g1",
                str(wdir / "G1_MNet_latest.msgpack"), "--load-weights-g2",
                str(wdir / "G2_MNet_latest.msgpack"), "--infered",
                str(root / "out_plain"))
    diff = 0
    for sub, read in (("shadowless", image_io.imread_color),
                      ("matte", image_io.imread_gray)):
        files = sorted((root / "out_plain" / sub / "istd").glob("*.png"))
        for got, f in zip(outs[sub], files):
            diff = max(diff, int(np.abs(got.astype(np.int16)
                                        - read(str(f))).max()))
    print(f"[cli] infer, kernel vs plain decoder: max diff {diff} gray "
          f"levels over 2 x {CLI_TEST} PNGs (limit 2)")
    if diff > 2:
        raise SystemExit("cli infer disagrees with the plain decoder")

    # 3. resume from the checkpoint for a third epoch
    saved = train_state_to_flax(trainer.state)
    saved_steps = _adam_steps(trainer.state)
    hshear.launches = 0
    reset_decoder_counts()
    run_cli("--tasks", "train", "--epochs", "3", "--valid-every", "1",
            "--save-every", "1", "--log-every", "1", "--load-checkpoint",
            str(wdir / "checkpoint.msgpack"))
    start, loaded, steps_loaded = seen["loaded"]
    leaves, bad = _leaves_differ(saved, loaded)
    step_ok = steps_loaded == saved_steps
    resumed = seen["trainers"][-1]
    n_steps = resumed.cfg.steps_per_epoch
    print(f"[time] checkpoint load ({mb:.1f} MB): "
          f"{seen['load'][0] * 1e3:.1f} ms")
    print(f"[cli] resume: started at epoch {start}; the loaded state vs "
          f"the saved run's: {leaves} leaves (weights, BN statistics, both "
          f"Adam states, step), {bad} not bit-identical; {len(saved_steps)} "
          f"Adam steps equal in value, dtype and device: {step_ok}; then "
          f"{len(resumed.history)} epoch, hshear launches "
          f"{hshear.launches}, decoder launches {decoder_upsample.launches}")
    _check_history(resumed, "cli resumed")
    if (start != 2 or bad or not step_ok or len(resumed.history) != 1
            or hshear.launches != 3 * n_steps
            or decoder_upsample.launches != 10 * (-(-CLI_TEST // b) + 1)):
        raise SystemExit("cli: the resumed run did not continue the saved "
                         "one")
    print(f"[time] cli phase: {time.perf_counter() - t_phase:.1f} s")
    seen.clear()
    return {"decoder": n_dec, "hshear": n_shear}


def _device_busy(prof) -> tuple[float, float]:
    """(device busy ms, span ms) of a profiled region: the union of the
    card's kernel and copy intervals, and the region's span from its
    first to its last event of either clock."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, dev = [], []
    for e in prof.events():
        iv = (e.time_range.start, e.time_range.end)
        spans.append(iv)
        if getattr(e, "device_type", None) == cuda:
            dev.append(iv)
    if not spans:
        return 0.0, 0.0
    busy, end = 0.0, -math.inf
    for a, b in sorted(dev):
        if b > end:
            busy += b - max(a, end)
            end = b
    span = max(b for _, b in spans) - min(a for a, _ in spans)
    return busy / 1e3, span / 1e3


def _host_tags() -> dict:
    """Every tag the JAX trainer writes, by event file (its
    ``_METRIC_KEYS`` and ``_log_*`` methods; ``--eval-metrics`` off)."""
    from shadow_removal_istd_tpu_torch.engine.steps import METRIC_KEYS

    common = ({f"Loss/{k}" for k in (*METRIC_KEYS[:10], "total")}
              | {f"{d}_output/{k}" for d in ("D1", "D2")
                 for k in ("real", "fake", "diff")}
              | {"input", "matte", "output"})
    return {"train": common | {"perf/images_per_sec"}, "valid": common}


def _check_event_files(logs: Path, epochs: int) -> int:
    """Reads both event files back (CRCs checked): every JAX tag at every
    epoch, scalars finite, images PNG. Returns the record count."""
    from shadow_removal_istd_tpu_torch.utils.tb_writer import read_events

    n = 0
    for which, tags in _host_tags().items():
        files = sorted((logs / which).glob("events.out.tfevents.*"))
        if len(files) != 1:
            raise SystemExit(f"host: {len(files)} event files in "
                             f"{logs / which}")
        events = read_events(str(files[0]))
        n += len(events)
        if events[0].get("file_version") != "brain.Event:2":
            raise SystemExit("host: the event file has no version record")
        got: dict = {}
        for e in events[1:]:
            got.setdefault(e["tag"], []).append(e)
        bad = [t for t, evs in got.items() for e in evs
               if not (isinstance(e["value"], dict)
                       and e["value"]["png"].startswith(b"\x89PNG")
                       or isinstance(e["value"], float)
                       and math.isfinite(e["value"]))]
        steps = {t: sorted(e["step"] for e in evs) for t, evs in got.items()}
        if (set(got) != tags or bad
                or any(v != list(range(epochs)) for v in steps.values())):
            raise SystemExit(f"host: {which} event file: tags "
                             f"{sorted(set(got) ^ tags)} differ, bad "
                             f"{bad}, steps {steps}")
    return n


def _cli_subprocess(argv: list, env: dict) -> subprocess.Popen:
    """``cli.main`` in a new process with cuDNN's deterministic
    algorithms (runs compared byte for byte), output merged."""
    code = ("import sys, torch; torch.backends.cudnn.deterministic = True; "
            "from shadow_removal_istd_tpu_torch.cli.main import "
            "build_parser, main; main(build_parser().parse_args("
            "sys.argv[1:]))")
    return subprocess.Popen([sys.executable, "-c", code, *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env)


def _read_until(proc, text: str, timeout: float, seen: list) -> None:
    deadline = time.monotonic() + timeout
    for line in iter(proc.stdout.readline, ""):
        seen.append(line)
        if text in line:
            return
        if time.monotonic() > deadline:
            break
    proc.kill()
    raise SystemExit(f"host: no {text!r} from the CLI process:\n"
                     + "".join(seen[-30:]))


def _host_sigterm(vgg_path: Path, istd: Path) -> dict:
    """SIGTERM to ``cli.main --tasks train infer`` after its second
    epoch: exit 0, the checkpoint and ``latest`` files, infer skipped;
    the run resumed for one more epoch ends with the files of an
    uninterrupted run, byte for byte."""
    from shadow_removal_istd_tpu_torch.utils.msgpack_codec import from_bytes

    root = SMOKE_DIR / "sigterm"
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
           "PYTHONPATH": os.pathsep.join(
               [str(Path(__file__).resolve().parent),
                os.environ.get("PYTHONPATH", "")])}
    common = ["--data-dir", str(istd), "--vgg-weights", str(vgg_path),
              "--devices", DEVICE, "--log-every", "1", "--valid-every",
              "1000", "--vis-every", "1000", *HOST_CLI_ARGS]

    def files(name):
        return ["--weights", str(root / name / "w"), "--logs",
                str(root / name / "l"), "--infered", str(root / name / "o")]

    seen: list = []
    t0 = time.perf_counter()
    proc = _cli_subprocess(["--tasks", "train", "infer", "--epochs", "1000",
                            "--save-every", "1000", *common, *files("a")],
                           env)
    try:
        _read_until(proc, "start training", 300, seen)
        t_start = time.perf_counter() - t0
        _read_until(proc, "train epoch 1:", 300, seen)
        proc.send_signal(signal.SIGTERM)
        t_sig = time.perf_counter()
        out, _ = proc.communicate(timeout=300)
        t_exit = time.perf_counter() - t_sig
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(seen) + out
    suffix = "_lr0.00050_SGAN"
    wa, wb = root / "a" / f"w{suffix}", root / "b" / f"w{suffix}"
    ck = wa / "checkpoint.msgpack"
    epochs = (int(from_bytes(ck.read_bytes())["epoch"]) if ck.is_file()
              else -1)
    names = sorted(p.name for p in wa.glob("*.msgpack"))
    print(f"[host] SIGTERM: cli.main (a subprocess, {DEVICE}) logged "
          f"'start training' {t_start:.1f} s after its start, took the "
          f"signal after epoch 1's log line and exited {proc.returncode} "
          f"{t_exit:.1f} s later; checkpoint epoch {epochs}, "
          f"{len(names)} files; infer skipped: "
          f"{'preempted: skipping remaining tasks' in out}")
    if (proc.returncode != 0 or epochs < 2 or len(names) != 9
            or "preemption checkpoint written" not in out
            or "preempted: skipping remaining tasks" not in out
            or (root / "a" / "o" / "shadowless").exists()):
        raise SystemExit("host: the SIGTERM run did not checkpoint and "
                         "exit cleanly:\n" + out[-3000:])

    def run(name, *extra):
        p = _cli_subprocess(["--tasks", "train", "--save-every", "1",
                             *common, *files(name), *extra], env)
        log, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            raise SystemExit(f"host: cli run {name} failed:\n{log[-3000:]}")

    t0 = time.perf_counter()
    run("a", "--epochs", str(epochs + 1), "--load-checkpoint", str(ck))
    run("b", "--epochs", str(epochs + 1))
    differ = [n for n in names
              if (wa / n).read_bytes() != (wb / n).read_bytes()]
    print(f"[host] SIGTERM: resumed to epoch {epochs + 1} and an "
          f"uninterrupted run of {epochs + 1} epochs in "
          f"{time.perf_counter() - t0:.1f} s; of their {len(names)} weight "
          f"and checkpoint files {len(differ)} differ {differ}")
    if differ or sorted(p.name for p in wb.glob("*.msgpack")) != names:
        raise SystemExit("host: the resumed run is not the uninterrupted "
                         "one")
    return {"epochs": epochs, "exit_s": t_exit}


def _host_native(istd: Path) -> None:
    """The native PNG loader on the ``cli`` phase's ISTD directory: each
    stream's files equal cv2 byte for byte, ``load_all`` goes through it,
    and its time per image beside cv2's and the stdlib codec's."""
    from shadow_removal_istd_tpu_torch.data import native_loader
    from shadow_removal_istd_tpu_torch.data.istd import (
        GRAY_STREAMS,
        STREAM_DIRS,
        ISTDDataset,
    )
    from shadow_removal_istd_tpu_torch.utils import image_io

    n_files = 0
    for subset in ("train", "test"):
        for stream in ("img", "mask", "matte", "target"):
            d = istd / subset / STREAM_DIRS[stream].format(s=subset)
            paths = sorted(str(p) for p in d.glob("*.png"))
            gray = stream in GRAY_STREAMS
            got = native_loader.decode_batch(paths, gray=gray)
            read = image_io.imread_gray if gray else image_io.imread_color
            want = np.stack([read(p) for p in paths])
            if gray:
                want = want[..., None]
            if not np.array_equal(got, want):
                raise SystemExit(f"host: native decode of {d} differs from "
                                 f"the image library's")
            n_files += len(paths)
    lib = ("cv2" if importlib.util.find_spec("cv2") else "PIL"
           if importlib.util.find_spec("PIL") else "the stdlib codec")
    print(f"[host] native PNG loader: {n_files} files of the cli phase's "
          f"directory equal {lib}'s decode byte for byte")
    ds = ISTDDataset(str(istd), "train", datas=("img", "matte", "target"))
    n = len(ds)
    times = {}
    t0 = time.perf_counter()
    ds.load_all()
    times["native"] = time.perf_counter() - t0
    if set(ds.decoded_by.values()) != {"native"}:
        raise SystemExit(f"host: load_all decoded by {ds.decoded_by}")
    t0 = time.perf_counter()
    ds.load_all(native=False)
    times[lib] = time.perf_counter() - t0
    one = ISTDDataset(str(istd), "train", datas=("img",))
    k = min(n, 8)
    with mock.patch.object(image_io, "_library_decoder", lambda: None):
        t0 = time.perf_counter()
        for i in range(k):
            one._read("img", i)
        stdlib = (time.perf_counter() - t0) / k
    threads = {"native": min(os.cpu_count() or 1, 16), lib: os.cpu_count()}
    for name, t in times.items():
        print(f"[time] istd load native vs library: {name}, {threads[name]} "
              f"threads: {t / (3 * n):.5f} s per image ({n} triplets, "
              f"img + matte + target, {DATA_HW[0]}x{DATA_HW[1]})")
    print(f"[time] istd load native vs library: the stdlib codec, one "
          f"thread: {stdlib:.5f} s per RGB image ({k} images); native "
          f"{stdlib * 3 * n / times['native']:.1f}x faster")


def _daemon_answer(flags: list, img, what: str,
                   reload: bool = False) -> tuple:
    """Start ``python -m shadow_removal_istd_tpu_torch.serving`` with
    ``flags`` on a free port, POST ``img`` as one PNG request once it is
    healthy, read ``/stats``, SIGTERM it; returns (HTTP status, reply
    body, exit code, /stats, seconds from start to exit). ``reload``:
    also POST a weight reload, its HTTP status in /stats'
    ``reload_status``."""
    import socket

    from shadow_removal_istd_tpu_torch.utils.image_io import imencode_png

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "shadow_removal_istd_tpu_torch.serving",
         "--device", DEVICE, "--port", str(port), "--warmup", "", *flags],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline, up = time.monotonic() + 300, False
        while not up:
            if proc.poll() is not None or time.monotonic() > deadline:
                raise SystemExit(f"{what}: the daemon did not come up: "
                                 + proc.communicate(timeout=30)[1][-2000:])
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=5)
                conn.request("GET", "/healthz")
                up = conn.getresponse().status == 200
                conn.close()
            except OSError:
                time.sleep(0.2)
        status, body = _post(("127.0.0.1", port), imencode_png(img))
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
        if reload:
            stats["reload_status"] = _post(
                ("127.0.0.1", port), json.dumps({"g1": "g1.msgpack",
                                                 "g2": "g2.msgpack"}),
                "/admin/reload")[0]
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return status, body, rc, stats, time.perf_counter() - t0


def _host_selu_daemon() -> None:
    """The serving daemon with ``--use-selu --droprate``: a SELU UNet at
    ngf 64, f32, answers a 480x640 request as the engine in this process
    does on the same weight files."""
    from shadow_removal_istd_tpu_torch.serving import InferenceEngine
    from shadow_removal_istd_tpu_torch.tools.convert import (
        flatten_tree,
        torch_to_flax_tree,
    )
    from shadow_removal_istd_tpu_torch.utils.image_io import imdecode_color

    root = SMOKE_DIR / "selu"
    root.mkdir(parents=True, exist_ok=True)
    engine = InferenceEngine("unet", ngf=NGF, use_selu=True, droprate=0.05,
                             dtype="float32", max_batch=1, seed=3,
                             device=DEVICE)
    for name, g in (("g1", engine.g1), ("g2", engine.g2)):
        np.savez(root / f"{name}.npz", **{"/".join(k): v for k, v in
                                          flatten_tree(torch_to_flax_tree(
                                              g)).items()})
    img = np.random.default_rng(9).integers(0, 256, (*DATA_HW, 3),
                                            dtype=np.uint8)
    (_, want), = engine.infer_group([img])
    status, body, rc, _, secs = _daemon_answer(
        ["--net-G", "unet", "--ngf", str(NGF), "--use-selu", "--droprate",
         "0.05", "--dtype", "float32", "--max-batch", "1",
         "--load-weights-g1", str(root / "g1.npz"),
         "--load-weights-g2", str(root / "g2.npz")], img, "host")
    got = imdecode_color(body) if status == 200 else None
    diff = (int(np.abs(got.astype(int) - want).max())
            if got is not None and got.shape == want.shape else -1)
    print(f"[host] serving daemon --net-G unet --use-selu --droprate 0.05 "
          f"(ngf {NGF}, f32): HTTP {status}, exit {rc}, "
          f"{secs:.1f} s with start-up; max diff "
          f"{diff} gray levels from this process's engine (limit 1)")
    if status != 200 or rc != 0 or not 0 <= diff <= 1:
        raise SystemExit("host: the SELU daemon's answer is wrong")


def phase_host(vgg_path: Path) -> dict:
    """The trainer's host side on the card (see the module docstring,
    phase 7); returns the kernels' launch counts in its training run."""
    from shadow_removal_istd_tpu_torch.data.synthetic import (
        synthetic_triplets,
    )
    from shadow_removal_istd_tpu_torch.engine import loop
    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
    from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer
    from shadow_removal_istd_tpu_torch.ops.decoder import decoder_upsample
    from shadow_removal_istd_tpu_torch.ops.shear import hshear
    from shadow_removal_istd_tpu_torch.parallel.prefetch import (
        prefetch_to_device,
    )
    from shadow_removal_istd_tpu_torch.utils.profiling import trace_path
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    root = SMOKE_DIR / "host"
    train = synthetic_triplets(HOST_TRAIN, *DATA_HW, seed=4)
    valid = synthetic_triplets(HOST_VALID, *DATA_HW, seed=5)
    cfg = TrainConfig(aug_method="shear", **TRAIN_KW)
    prof_dir = root / "prof"

    def make(name, device_cache, **run):
        return Trainer(cfg, RunConfig(
            seed=0, vgg_weights=str(vgg_path), device_cache=device_cache,
            weights_dir=str(root / name / "w"), logs_dir=str(root / name /
                                                             "l"),
            checkpoint_path=str(root / name / "c.msgpack"), **run),
            train_streams=train, valid_streams=valid, device=DEVICE)

    # 1. two host-pipeline epochs, every writer on, the second traced
    host = make("h", False, log_every=1, vis_every=1, valid_every=1,
                profile_dir=str(prof_dir))
    logs: list = []
    orig = {k: getattr(loop.Trainer, k) for k in ("_log_images",
                                                  "_log_scalars")}

    def log_images(self, which, epoch, batch, n_images=8):
        torch.cuda.synchronize()
        before = dict(decoder_upsample.launches_by_variant)
        t0 = time.perf_counter()
        orig["_log_images"](self, which, epoch, batch, n_images)
        torch.cuda.synchronize()
        logs.append(("images", time.perf_counter() - t0, {
            k: v - before[k]
            for k, v in decoder_upsample.launches_by_variant.items()}))

    def log_scalars(self, *a):
        t0 = time.perf_counter()
        orig["_log_scalars"](self, *a)
        logs.append(("scalars", time.perf_counter() - t0, None))

    hshear.launches = 0
    reset_decoder_counts()
    t0 = time.perf_counter()
    with mock.patch.multiple(loop.Trainer, _log_images=log_images,
                             _log_scalars=log_scalars):
        host.train(2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_shear, n_dec = hshear.launches, decoder_upsample.launches
    by_variant = dict(decoder_upsample.launches_by_variant)
    steps = 2 * host.cfg.steps_per_epoch
    b = host.cfg.batch_size
    n_valid = 2 * -(-HOST_VALID // b)
    images = [c for k, _, c in logs if k == "images"]
    n_fwd = n_valid + len(images)
    print(f"[host] host-pipeline training ({HOST_TRAIN} + {HOST_VALID} "
          f"{DATA_HW[0]}x{DATA_HW[1]} triplets, batch {b}, "
          f"{cfg.image_size} crops, {cfg.compute_dtype}, {cfg.aug_method}): "
          f"2 epochs x {host.cfg.steps_per_epoch} steps + 2 validations + "
          f"{len(images)} image logs in {wall:.1f} s; hshear launches "
          f"{n_shear} ({steps} steps), decoder launches {n_dec} "
          f"{by_variant} ({n_fwd} stacked forwards); per image log "
          f"{images}")
    _check_history(host, "host")
    per_fwd = {"tensor_core": 0, "cuda_core": 8, "narrow": 2}
    want = {k: v * n_fwd for k, v in per_fwd.items()}
    if (n_shear != 3 * steps or len(images) != 4
            or any(c != per_fwd for c in images) or by_variant != want):
        raise SystemExit(f"host: expected {3 * steps} hshear launches, 4 "
                         f"image logs of {per_fwd} and {want} in all")
    n_events = _check_event_files(root / "h" / "l", 2)
    trace_file = Path(trace_path(str(prof_dir)))
    if not trace_file.is_file():
        raise SystemExit(f"host: no trace at {trace_file}")
    events = json.loads(trace_file.read_text())["traceEvents"]
    shear_k = sum(1 for e in events if e.get("cat") == "kernel"
                  and "hshear" in e.get("name", ""))
    print(f"[host] event files: {n_events} records, every JAX tag at "
          f"epochs 0 and 1, CRCs checked; trace {trace_file.name} "
          f"({trace_file.stat().st_size / 1e6:.1f} MB, {len(events)} "
          f"events): {shear_k} hshear kernel events (epoch 1, "
          f"{host.cfg.steps_per_epoch} steps)")
    if shear_k != 3 * host.cfg.steps_per_epoch:
        raise SystemExit("host: the trace does not name the hshear kernel "
                         "3 times a step")
    t_img = [t for k, t, _ in logs if k == "images"]
    t_sc = [t for k, t, _ in logs if k == "scalars"]

    # 2. the host epoch against the fused epoch, on the same data
    fused = make("f", True)
    rows = {}
    for turn in range(3):
        for name, tr in (("host", host), ("fused", fused)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.run_train_epoch(10 + turn)
            torch.cuda.synchronize()
            rows.setdefault(name, []).append(time.perf_counter() - t0)
    n_img = host.cfg.steps_per_epoch * b
    idle = {}
    for name, tr in (("host", host), ("fused", fused)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.run_train_epoch(20)
            torch.cuda.synchronize()
        idle[name] = _device_busy(prof)
    for name, ts in rows.items():
        busy, span = idle[name]
        share = f"{1 - busy / span:.2%}" if span > 0 else "not measured"
        for i, t in enumerate(ts):
            print(f"[time] {name} epoch (turn {i}): {t * 1e3:.1f} ms, "
                  f"{n_img / t:.2f} img/s ({host.cfg.steps_per_epoch} "
                  f"steps of {b})")
        print(f"[time] {name} epoch profiled: device busy {busy:.1f} ms of "
              f"{span:.1f} ms, idle share {share}")
    host_s, fused_s = _median(rows["host"]), _median(rows["fused"])
    print(f"[time] host epoch vs fused epoch: {n_img / host_s:.2f} vs "
          f"{n_img / fused_s:.2f} img/s (median of 3), host "
          f"{100 * (fused_s / host_s - 1):+.2f} %")
    epoch_ms = 1e3 * host_s
    print(f"[time] tensorboard: scalars {_median(t_sc) * 1e3:.2f} ms per "
          f"call ({len(t_sc)} calls), image grids {_median(t_img) * 1e3:.1f}"
          f" ms per call (3 PNG grids + a stacked forward, {len(t_img)} "
          f"calls); a log of both per epoch is "
          f"{100 * (_median(t_sc) + _median(t_img)) * 1e3 / epoch_ms:.2f} %"
          f" of a {epoch_ms:.0f} ms epoch")
    # the host pipeline's parts for one batch: gather, pinned copy, H2D
    pipe = host.train_pipe
    t0 = time.perf_counter()
    raws = list(pipe.epoch(0))
    gather_ms = (time.perf_counter() - t0) * 1e3 / len(raws)
    nbytes = sum(a.nbytes for a in raws[0])
    pinned = [torch.empty(a.shape, dtype=torch.uint8, pin_memory=True)
              for a in raws[0]]
    t0 = time.perf_counter()
    for a, p in zip(raws[1], pinned):
        np.copyto(p.numpy(), a)
    pin_ms = (time.perf_counter() - t0) * 1e3
    h2d = time_ms(lambda: [p.to(DEVICE, non_blocking=True) for p in pinned],
                  10)
    t0 = time.perf_counter()
    for _ in prefetch_to_device(iter(raws), 2, DEVICE):
        pass
    torch.cuda.synchronize()
    walk_ms = (time.perf_counter() - t0) * 1e3 / len(raws)
    print(f"[time] host pipeline per batch of {b} ({nbytes / 1e6:.1f} MB "
          f"uint8): gather {gather_ms:.2f} ms, copy into pinned memory "
          f"{pin_ms:.2f} ms, H2D {h2d:.3f} ms ({nbytes / h2d / 1e6:.1f} "
          f"GB/s); prefetch_to_device alone {walk_ms:.2f} ms a batch")
    del fused
    torch.cuda.empty_cache()

    # 3. SIGTERM, 4. the native loader, 5. the SELU daemon
    istd = SMOKE_DIR / "cli" / "istd"
    sig = _host_sigterm(vgg_path, istd)
    _host_native(istd)
    _host_selu_daemon()
    print(f"[time] host phase: {time.perf_counter() - t_phase:.1f} s")
    return {"decoder": n_dec, "hshear": n_shear, "sigterm": sig,
            "host_img_s": round(n_img / host_s, 2),
            "fused_img_s": round(n_img / fused_s, 2)}


def _resize_f64(x64: np.ndarray, size, method: str) -> np.ndarray:
    """``ops/resize.py``'s two contractions in float64 numpy, with its
    own (float32) weight matrices."""
    from shadow_removal_istd_tpu_torch.ops import resize as rs

    mat = {"linear": rs.resize_matrix_linear, "area": rs.resize_matrix_area}
    rh = mat[method](x64.shape[1], size[0]).astype(np.float64)
    rw = mat[method](x64.shape[2], size[1]).astype(np.float64)
    out = np.einsum("oh,nhwc->nowc", rh, x64)
    return np.einsum("pw,nowc->nopc", rw, out)


def _lab_f64(rgb: np.ndarray) -> np.ndarray:
    """sRGB [0, 1] -> CIELAB in float64: ``ops/color.py``'s formulas and
    constants."""
    from shadow_removal_istd_tpu_torch.ops import color

    lin = np.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                   rgb / 12.92)
    xyz = lin @ color._XYZ_FROM_RGB.astype(np.float64).T
    t = xyz / color._WHITE_D65.astype(np.float64)
    f = np.where(t > 0.008856, np.cbrt(t), 7.787 * t + 16.0 / 116.0)
    return np.stack([116.0 * f[..., 1] - 16.0, 500.0 * (f[..., 0] - f[..., 1]),
                     200.0 * (f[..., 1] - f[..., 2])], axis=-1)


def _regions_f64(lab1, lab2, mask) -> dict:
    dist = np.sqrt(((lab1 - lab2) ** 2).sum(-1))
    ad = np.abs(lab1 - lab2).sum(-1)
    inv = ~mask
    return {"rmse_sum": dist[mask].sum(), "mae_sum": ad[mask].sum(),
            "pixels": float(mask.sum()), "rmse_non_sum": dist[inv].sum(),
            "mae_non_sum": ad[inv].sum(), "pixels_non": float(inv.sum())}


def _gather_f64(u8: np.ndarray, params: dict, crop: int) -> np.ndarray:
    """The fused warp + flip + crop in float64 numpy, image by image:
    ``cv.getRotationMatrix2D`` about the center, its inverse, and the
    bilinear blend of the four neighbours, each counting zero outside
    the image; (N, crop, crop, C) in [-1, 1]."""
    n, h, w, c = u8.shape
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    p = {k: v.cpu().numpy() for k, v in params.items()}
    out = np.empty((n, crop, crop, c))
    for i in range(n):
        th = np.deg2rad(np.float64(p["angle"][i]))
        a = p["scale"][i] * np.cos(th)
        b = p["scale"][i] * np.sin(th)
        fwd = np.array([[a, b, (1 - a) * cx - b * cy],
                        [-b, a, b * cx + (1 - a) * cy]])
        inv = np.linalg.inv(np.vstack([fwd, [0.0, 0.0, 1.0]]))[:2]
        rows = np.arange(crop) + float(p["row_off"][i])
        cols = np.arange(crop) + float(p["col_off"][i])
        if p["flip"][i]:
            cols = (w - 1.0) - cols
        xg, yg = np.meshgrid(cols, rows)
        xs = inv[0, 0] * xg + inv[0, 1] * yg + inv[0, 2]
        ys = inv[1, 0] * xg + inv[1, 1] * yg + inv[1, 2]
        x0, y0 = np.floor(xs).astype(np.int64), np.floor(ys).astype(np.int64)
        fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]

        def tap(yy, xx):
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            v = u8[i, np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
            return v * ok[..., None]

        out[i] = ((1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1))
                  + fy * ((1 - fx) * tap(y0 + 1, x0)
                          + fx * tap(y0 + 1, x0 + 1)))
    return out * (2.0 / 255.0) - 1.0


def _identity_crop(img, ro: int, co: int, flip: bool, crop: int):
    """The (crop, crop) window of an (H, W, C) image at (ro, co) of the
    image, or of its mirror image when ``flip``."""
    w = img.shape[1]
    rows = img[ro:ro + crop]
    return rows[:, w - co - crop:w - co].flip(1) if flip else rows[
        :, co:co + crop]


def _run_cli(argv: list) -> None:
    """``cli.main`` on ``argv``, its log handlers removed after."""
    import logging

    from shadow_removal_istd_tpu_torch.cli.main import build_parser
    from shadow_removal_istd_tpu_torch.cli.main import main as cli_main

    handlers = list(logging.getLogger().handlers)
    try:
        cli_main(build_parser().parse_args(argv))
    finally:
        for h in logging.getLogger().handlers[len(handlers):]:
            h.close()
        logging.getLogger().handlers[:] = handlers
    torch.cuda.synchronize()


def _timed_all_metrics(*args, **kw) -> tuple[dict, dict]:
    """``eval_cli.all_metrics`` with its wall time split into the host's
    PNG decode, the host's gaussian mask filter, and the rest (device
    resizes, LAB, sums, transfers and their waits)."""
    from scipy import ndimage

    from shadow_removal_istd_tpu_torch.metrics import eval_cli

    spent = {"decode": 0.0, "filter": 0.0}

    def timed(key, fn):
        def inner(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0
        return inner

    with mock.patch.multiple(
            eval_cli, _load_rgb01=timed("decode", eval_cli._load_rgb01),
            _load_mask01=timed("decode", eval_cli._load_mask01)), \
            mock.patch.object(ndimage, "gaussian_filter",
                              timed("filter", ndimage.gaussian_filter)):
        t0 = time.perf_counter()
        out = eval_cli.all_metrics(*args, **kw)
        spent["wall"] = time.perf_counter() - t0
    spent["device"] = spent["wall"] - spent["decode"] - spent["filter"]
    return out, spent


def _same_metrics(a: dict, b: dict, rtol: float) -> float:
    """Largest relative difference over the keys (NaN equal to NaN);
    raises if the keys differ."""
    if a.keys() != b.keys():
        raise SystemExit(f"metric keys differ: {sorted(a)} vs {sorted(b)}")
    worst = 0.0
    for k in a:
        if math.isnan(a[k]) or math.isnan(b[k]):
            if not (math.isnan(a[k]) and math.isnan(b[k])):
                return math.inf
            continue
        worst = max(worst, abs(a[k] - b[k]) / max(abs(b[k]), 1e-30))
    return worst


def phase_eval(vgg_path: Path, trainer) -> dict:
    """The evaluation protocol and the gather augmentation on the card:
    resize, LAB and region sums against float64; the eval CLI's dataset
    metrics on the card against the CPU; ``--eval-metrics`` end to end
    against the offline CLI on the PNGs ``infer`` wrote; the gather
    augmentation against float64 and beside the shear path; 3 training
    steps on it. Returns the kernels' launch counts on these paths."""
    import copy
    import dataclasses

    from shadow_removal_istd_tpu_torch.data.synthetic import (
        write_istd_layout,
    )
    from shadow_removal_istd_tpu_torch.engine import loop
    from shadow_removal_istd_tpu_torch.metrics.eval_cli import all_metrics
    from shadow_removal_istd_tpu_torch.metrics.metrics import (
        aggregate_regions,
        region_metrics,
    )
    from shadow_removal_istd_tpu_torch.ops.augment import (
        AugmentConfig,
        augment_batch,
        sample_augment_params,
    )
    from shadow_removal_istd_tpu_torch.ops.color import rgb_to_lab
    from shadow_removal_istd_tpu_torch.ops.decoder import decoder_upsample
    from shadow_removal_istd_tpu_torch.ops.resize import resize
    from shadow_removal_istd_tpu_torch.ops.shear import hshear

    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    b, (h, w), crop = AUG_BATCH, DATA_HW, CROP

    # 1. resize against float64 numpy with the same matrices
    for (src, dst, method) in ((DATA_HW, (crop, crop), "area"),
                               (DATA_HW, RESIZE_TO, "area"),
                               ((crop, crop), DATA_HW, "linear")):
        x = torch.rand(b, *src, 3, device=DEVICE, generator=gen)
        got = resize(x, dst)
        ref = _resize_f64(x[:4].double().cpu().numpy(), dst, method)
        err = float(np.abs(got[:4].double().cpu().numpy() - ref).max())
        ms = time_ms(lambda: resize(x, dst), 10)
        print(f"[eval] resize {src[0]}x{src[1]} -> {dst[0]}x{dst[1]} "
              f"({method}, b{b}, 3 channels, f32): max abs err vs float64 "
              f"{err:.2e} (tol {RESIZE_TOL:.0e})")
        print(f"[time] resize {src[0]}x{src[1]} -> {dst[0]}x{dst[1]} "
              f"{method} b{b}: {ms:.4f} ms")
        if not err <= RESIZE_TOL:
            raise SystemExit("resize disagrees with float64")

    # 2. LAB and the region sums against float64 numpy
    rgb1 = torch.rand(b, h, w, 3, device=DEVICE, generator=gen)
    rgb2 = (rgb1 + 0.1 * torch.rand(b, h, w, 3, device=DEVICE,
                                    generator=gen)).clamp(0, 1)
    mask = torch.rand(b, h, w, device=DEVICE, generator=gen) > 0.7
    lab1, lab2 = rgb_to_lab(rgb1), rgb_to_lab(rgb2)
    ref = _lab_f64(rgb1[:4].double().cpu().numpy())
    lab_err = float(np.abs(lab1[:4].double().cpu().numpy() - ref).max())
    got = aggregate_regions([region_metrics(lab1, lab2, mask)])
    want = aggregate_regions([_regions_f64(
        lab1.double().cpu().numpy(), lab2.double().cpu().numpy(),
        mask.cpu().numpy())])
    agg_err = _same_metrics(got, want, EVAL_RTOL)
    ms = time_ms(lambda: region_metrics(rgb_to_lab(rgb1), rgb_to_lab(rgb2),
                                        mask), 10)
    print(f"[eval] rgb_to_lab {b}x{h}x{w}: max abs err vs float64 "
          f"{lab_err:.2e} LAB units (tol {LAB_TOL:.0e}); aggregate_regions "
          f"of region_metrics vs float64 sums: max rel err {agg_err:.2e} "
          f"(tol {EVAL_RTOL:.0e})")
    print(f"[time] 2 x rgb_to_lab + region_metrics {b}x{h}x{w}: {ms:.4f} ms "
          f"per batch")
    if not (lab_err <= LAB_TOL and agg_err <= EVAL_RTOL):
        raise SystemExit("LAB or region metrics disagree with float64")

    # 3. the eval CLI's dataset metrics, card against CPU
    root = SMOKE_DIR / "eval"
    istd = root / "istd"
    t0 = time.perf_counter()
    write_istd_layout(str(istd), EVAL_TRAIN, EVAL_TEST, h, w, seed=2)
    print(f"[eval] wrote an ISTD directory of {EVAL_TRAIN} + {EVAL_TEST} "
          f"{h}x{w} triplets in {time.perf_counter() - t0:.1f} s")
    test = istd / "test"
    dirs = (str(test / "test_C_fixed"), str(test / "test_A"))
    masks = str(test / "test_B")
    for label, kw in ((f"mask, size {crop}", dict(maskdir=masks, size=crop)),
                      ("mask, native size", dict(maskdir=masks, size=None)),
                      (f"maskless PSNR/SSIM, size {crop}", dict(size=crop))):
        on_card, t = _timed_all_metrics(*dirs, device=DEVICE, **kw)
        on_cpu = all_metrics(*dirs, device="cpu", **kw)
        err = _same_metrics(on_card, on_cpu, EVAL_RTOL)
        n = EVAL_TEST
        print(f"[eval] all_metrics ({label}): card vs CPU max rel diff "
              f"{err:.2e} (tol {EVAL_RTOL:.0e}); " + ", ".join(
                  f"{k} {v:.4f}" for k, v in on_card.items()))
        print(f"[time] eval cli ({label}) {n} images {h}x{w} on the card: "
              f"{n / t['wall']:.1f} img/s; host decode {t['decode']:.3f} s "
              f"({1e3 * t['decode'] / n:.2f} ms/image), host mask filter "
              f"{t['filter']:.3f} s, device metric and transfers "
              f"{t['device']:.3f} s ({1e3 * t['device'] / n:.2f} ms/image)")
        if not err <= EVAL_RTOL:
            raise SystemExit(f"all_metrics ({label}): card and CPU disagree")

    # 4. --eval-metrics end to end: Eval/* of the last validation against
    # the offline CLI on the PNGs infer wrote
    seen: dict = {"valid": []}
    orig_train, orig_valid = loop.Trainer.train, loop.Trainer.run_valid_epoch

    def train(self, epochs):
        seen["trainer"] = self
        return orig_train(self, epochs)

    def run_valid_epoch(self, epoch):
        before = dict(decoder_upsample.launches_by_variant)
        out = orig_valid(self, epoch)
        seen["valid"].append({k: v - before[k] for k, v in
                              decoder_upsample.launches_by_variant.items()})
        return out

    hshear.launches = 0
    reset_decoder_counts()
    t0 = time.perf_counter()
    with mock.patch.multiple(loop.Trainer, train=train,
                             run_valid_epoch=run_valid_epoch):
        _run_cli(["--tasks", "train", "infer", "--eval-metrics", "--epochs",
                  "1", "--data-dir", str(istd), "--vgg-weights",
                  str(vgg_path), "--weights", str(root / "w"), "--logs",
                  str(root / "l"), "--infered", str(root / "out"),
                  *CLI_ARGS])
    wall = time.perf_counter() - t0
    n_shear, n_dec = hshear.launches, decoder_upsample.launches
    tr = seen["trainer"]
    per_batch = -(-EVAL_TEST // tr.cfg.batch_size)
    offline = all_metrics(str(test / "test_C_fixed"),
                          str(root / "out" / "shadowless" / "istd"),
                          maskdir=str(test / "test_B"), device=DEVICE)
    got = {k: tr.last_eval[f"Eval/{k}"] for k in loop.EVAL_KEYS}
    err = _same_metrics(got, {k: offline[k] for k in loop.EVAL_KEYS},
                        EVAL_CLI_RTOL)
    # each validation: its batches and its image log's stacked forward
    want = {"tensor_core": 0, "cuda_core": 8 * (per_batch + 1),
            "narrow": 2 * (per_batch + 1)}
    print(f"[eval] --tasks train infer --eval-metrics: {wall:.1f} s (data "
          f"load, 1 step, validation, infer of {EVAL_TEST}); Eval/* " +
          ", ".join(f"{k} {v:.4f}" for k, v in got.items()) +
          f"; vs the offline CLI on the infer PNGs: max rel diff {err:.2e} "
          f"(tol {EVAL_CLI_RTOL:.0e}); decoder launches in the validation "
          f"{seen['valid']} ({per_batch} batches), in the run {n_dec}, "
          f"hshear {n_shear}")
    if not err <= EVAL_CLI_RTOL:
        raise SystemExit("Eval/* disagrees with the offline CLI")
    # the run: the validation, infer and the epoch-0 training image log
    if seen["valid"] != [want] or n_dec != 10 * (2 * per_batch + 2):
        raise SystemExit(f"expected {want} decoder launches per validation "
                         f"and {10 * (2 * per_batch + 2)} in the run")

    # 5. the gather augmentation: against float64, flips and offsets
    # exact, timed beside the shear path
    u8 = torch.randint(0, 256, (b, h, w, 7), dtype=torch.uint8,
                       device=DEVICE, generator=gen)
    streams = (u8[..., :3], u8[..., 3:4], u8[..., 4:])
    g_cfg = AugmentConfig(crop_size=crop)
    s_cfg = AugmentConfig(crop_size=crop, method="shear")
    params = sample_augment_params(gen, b, (h, w), g_cfg, DEVICE)
    hshear.launches = 0
    got = torch.cat(augment_batch(None, streams, g_cfg, params=params),
                    dim=1).permute(0, 2, 3, 1)
    ref = _gather_f64(u8.cpu().numpy(), params, crop)
    g_err = float(np.abs(got.double().cpu().numpy() - ref).max())
    # no rotation, no scale: the crop at its offsets, mirrored where drawn
    eye = dict(params, scale=torch.ones_like(params["scale"]),
               angle=torch.zeros_like(params["angle"]))
    warped = torch.cat(augment_batch(None, streams, g_cfg, params=eye), 1)
    exact = all(
        torch.equal(warped[i], _identity_crop(u8[i], ro, co, f, crop)
                    .permute(2, 0, 1).float() * (2.0 / 255.0) - 1.0)
        for i, (ro, co, f) in enumerate(zip(eye["row_off"].tolist(),
                                            eye["col_off"].tolist(),
                                            eye["flip"].tolist())))
    n_aug = hshear.launches
    g_ms = time_ms(lambda: augment_batch(None, streams, g_cfg,
                                         params=params), 10)
    s_ms = time_ms(lambda: augment_batch(None, streams, s_cfg,
                                         params=params), 10)
    print(f"[eval] gather augmentation b{b} {h}x{w}x7 uint8 -> {crop}x"
          f"{crop}: max abs err vs float64 {g_err:.2e} on [-1, 1] (tol "
          f"{GATHER_TOL:.0e}); identity warp = the crop at its offsets, "
          f"flipped where drawn, exactly: {exact}; hshear launches "
          f"{n_aug}")
    print(f"[time] augmentation b{b} {h}x{w}x7 -> {crop}x{crop}: gather "
          f"{g_ms:.4f} ms, shear {s_ms:.4f} ms (gather / shear "
          f"{g_ms / s_ms:.2f})")
    if not (g_err <= GATHER_TOL and exact and n_aug == 0):
        raise SystemExit("gather augmentation disagrees")

    # 6. training steps on the gather path beside the shear path
    gather_tr = copy.copy(trainer)
    gather_tr.aug_cfg = dataclasses.replace(trainer.aug_cfg, method="gather")
    hshear.launches = 0
    g_step = time_train_steps(gather_tr, 3)["step"]
    n_gather = hshear.launches
    s_step = time_train_steps(trainer, 3)["step"]
    tb = trainer.cfg.batch_size
    print(f"[time] train step {crop}x{crop} b{tb} f32, median of 3: gather "
          f"augmentation {g_step:.3f} ms = {tb * 1e3 / g_step:.1f} img/s, "
          f"shear {s_step:.3f} ms = {tb * 1e3 / s_step:.1f} img/s; hshear "
          f"launches on the gather steps {n_gather}")
    if n_gather != 0:
        raise SystemExit("the gather path launched hshear")
    print(f"[time] eval phase: {time.perf_counter() - t_phase:.1f} s")
    return {"decoder": n_dec, "hshear": n_shear, "hshear_gather": n_gather}


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else 0.5 * (
        xs[len(xs) // 2 - 1] + xs[len(xs) // 2])


def _cache_of(trainer):
    """The trainer's device cache; for a host-pipeline trainer, a cache
    of its training streams made for the timing."""
    if trainer.cache is not None:
        return trainer.cache
    from shadow_removal_istd_tpu_torch.data.device_cache import (
        DeviceDatasetCache,
    )
    return DeviceDatasetCache(trainer.train_pipe.streams, DEVICE)


def time_train_steps(trainer, steps: int = 7) -> dict:
    """Per-step device time by phase (CUDA events), median over
    ``steps`` steps after one warm-up step: gather + augmentation, then
    ``train_step``'s phases (its ``mark`` hook)."""
    from shadow_removal_istd_tpu_torch.engine.epoch import RngStreams
    from shadow_removal_istd_tpu_torch.engine.steps import train_step
    from shadow_removal_istd_tpu_torch.ops.augment import augment_batch

    gen = RngStreams(1, 100, DEVICE)
    cache = _cache_of(trainer)
    idx = cache.epoch_indices(gen.generator("shuffle"),
                              trainer.cfg.batch_size)
    rows = []
    for s in range(steps + 1):
        evs = [("start", torch.cuda.Event(enable_timing=True))]
        evs[0][1].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            evs.append((name, ev))

        raw = cache.gather(idx[s % idx.shape[0]])
        batch = augment_batch(gen.generator("augment", s), raw,
                              trainer.aug_cfg)
        mark("augment")
        train_step(trainer.state, batch, (gen.generator("dropout_g1", s),
                                          gen.generator("dropout_g2", s)),
                   mark=mark)
        rows.append(evs)
    torch.cuda.synchronize()
    phases = {}
    for evs in rows[1:]:
        for (_, a), (name, b) in zip(evs, evs[1:]):
            phases.setdefault(name, []).append(a.elapsed_time(b))
        phases.setdefault("step", []).append(
            evs[0][1].elapsed_time(evs[-1][1]))
    return {k: _median(v) for k, v in phases.items()}


def profile_train_step(trainer,
                       label: str = "train step 256x256 b16 f32") -> None:
    """Device time by kernel over one training step (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from shadow_removal_istd_tpu_torch.engine.epoch import RngStreams
    from shadow_removal_istd_tpu_torch.engine.steps import train_step
    from shadow_removal_istd_tpu_torch.ops.augment import augment_batch

    gen = RngStreams(2, 0, DEVICE)
    cache = _cache_of(trainer)
    idx = cache.epoch_indices(gen.generator("shuffle"),
                              trainer.cfg.batch_size)

    def step():
        raw = cache.gather(idx[0])
        batch = augment_batch(gen.generator("augment"), raw,
                              trainer.aug_cfg)
        train_step(trainer.state, batch, (gen.generator("dropout_g1"),
                                          gen.generator("dropout_g2")))

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    rows = [e for e in prof.key_averages() if dev_us(e) > 0]
    # kernel rows only (an aten op and the kernels it launches are
    # separate rows); older profilers lack device_type: keep every row
    kern = [e for e in rows if getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA] or rows
    total = sum(dev_us(e) for e in kern)
    print(f"[profile] {label}: kernel time "
          f"{total / 1e3:.3f} ms over {sum(e.count for e in kern)} "
          f"launches, {len(kern)} names")
    for e in sorted(kern, key=lambda e: -dev_us(e))[:14]:
        print(f"[profile] {dev_us(e) / 1e3:9.3f} ms "
              f"{100 * dev_us(e) / max(total, 1):5.1f}% x{e.count:<4} "
              f"{e.key[:90]}")
    shear = [e for e in kern if "hshear" in e.key]
    print(f"[profile] hshear kernel: {sum(e.count for e in shear)} "
          f"launches, {sum(dev_us(e) for e in shear) / 1e3:.3f} ms in "
          "the step")


def time_shear_passes(others: dict | None = None) -> dict:
    """Each ``hshear`` pass of one augmentation at the slice's shapes, on
    one real draw, in the layout the path gives it: the kernel alone
    (taps formed beforehand), the wrapper, the kernel in the normal
    layout, the plain version (in the path's layout), ``F.grid_sample``
    (normal layout) and the bound; then the whole rotation
    (:func:`time_rotation`). ``others`` maps a name to the C entry of
    another ``hshear`` source (:func:`build_renamed`): one with
    ``transpose_out`` runs the path's layout, one without (e.g. the
    kernel's first version) the normal layout; each is compared bit for
    bit with the checkout's kernel in the same layout, and all are timed
    in turns."""
    from shadow_removal_istd_tpu_torch.ops import shear

    others = others or {}
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    u8, params = _aug_inputs(gen)
    _, calls = _record_passes(
        lambda: shear.fused_augment_shear(u8, params, CROP))
    tot: dict[str, float] = {}
    for i, (img, shifts, out_w, pad, t) in enumerate(calls):
        grid = grid_for(img, shifts, out_w)
        kint, frac = shear._taps(img, shifts, out_w, pad)
        wrapped = time_ms(lambda: shear.hshear(img, shifts, out_w, pad,
                                               transpose_out=t))
        plain = time_ms(lambda: shear.hshear_plain(img, shifts, out_w, pad,
                                                   transpose_out=t))
        lib = time_ms(lambda: torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True))
        runs = {"kernel": lambda: shear.launch(img, kint, frac, out_w, pad,
                                               t),
                "normal": lambda: shear.launch(img, kint, frac, out_w, pad)}
        for name, fn in others.items():
            lay = t and fn.transposes

            def run(fn=fn, lay=lay):
                return _launch_entry(fn, img, kint, frac, out_w, pad, lay)
            differ = int((run() != runs["kernel" if lay else "normal"]()
                          ).sum())
            print(f"[compare] hshear pass {i + 1} {name} "
                  f"({_layout_name(lay)}): {differ} outputs differ from "
                  "the checkout's kernel")
            if differ:
                raise SystemExit(f"{name} disagrees with the checkout")
            runs[name] = run
        times: dict[str, list] = {}
        for name in list(runs) + list(runs)[::-1]:
            times.setdefault(name, []).append(time_ms(runs[name]))
        ms = sum(times["kernel"]) / 2
        ops, nbytes = shear_cost(img, shifts, out_w, pad)
        bound = max(ops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3
        row = {"ms": ms, "wrapped_ms": wrapped, "plain_ms": plain,
               "library_ms": lib, "bound_ms": bound,
               **{f"{k}_ms": sum(v) / len(v) for k, v in times.items()
                  if k != "kernel"}}
        print(f"[time] hshear pass {i + 1} in {tuple(img.shape)} out_w "
              f"{out_w} pad {pad} {_layout_name(t)}: kernel {ms:.4f} ms "
              f"(wrapper, taps formed: {wrapped:.4f}) | "
              + " | ".join(f"{k} " + "/".join(f"{x:.4f}" for x in v)
                           for k, v in times.items() if k != "kernel")
              + f" | plain {plain:.4f} | grid_sample {lib:.4f} | bound "
              f"{bound:.4f} (bytes, {nbytes / 1e6:.1f} MB) | "
              f"{nbytes / ms / 1e6:.0f} GB/s ({100 * bound / ms:.0f} % of "
              f"the bound)")
        for k, v in row.items():
            tot[k] = tot.get(k, 0.0) + v
    print(f"[time] hshear per augmentation (3 launches): kernel "
          f"{tot['ms']:.4f} ms ({100 * tot['bound_ms'] / tot['ms']:.0f} % of "
          f"the bound), wrapper {tot['wrapped_ms']:.4f}, "
          + ", ".join(f"{k[:-3]} {v:.4f}" for k, v in tot.items()
                      if k not in ("ms", "wrapped_ms", "plain_ms",
                                   "library_ms", "bound_ms"))
          + f", plain {tot['plain_ms']:.4f}, grid_sample "
          f"{tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f}")
    tot.update(time_rotation(u8, params, tot["bound_ms"], others))
    return tot


def _launch_entry(fn, img, kint, frac, out_w, pad, transpose_out=False):
    """One launch of another ``hshear`` source's C entry on formed taps
    (``transpose_out`` only where its entry takes it)."""
    b, c, h, _ = img.shape
    out = torch.empty((b, c, out_w, h) if transpose_out else
                      (b, c, h, out_w), device=img.device)
    flag = (int(transpose_out),) if fn.transposes else ()
    rc = fn(img.data_ptr(), kint.data_ptr(), frac.data_ptr(),
            out.data_ptr(), *img.shape, out_w, pad, *flag,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"hshear launch of another source failed ({rc})")
    return out


def _entry_hshear(fn):
    """``hshear`` through another source's C entry, the taps formed as
    the wrapper forms them: ``transpose_out`` passed on where the entry
    takes it, else the normal layout and a transpose copy."""
    from shadow_removal_istd_tpu_torch.ops.shear import _taps

    def entry(img, shifts, out_w, pad, *, transpose_out=False):
        kint, frac = _taps(img, shifts, out_w, pad)
        lay = transpose_out and fn.transposes
        out = _launch_entry(fn, img, kint, frac, out_w, pad, lay)
        if transpose_out and not lay:
            out = out.transpose(2, 3).contiguous()
        return out
    return entry


def _unfolded_hshear(real):
    """``hshear`` as the rotation ran it before the transposes were
    folded into the kernel: the normal layout, then a transpose copy."""
    def unfolded(img, shifts, out_w, pad, *, transpose_out=False):
        out = real(img, shifts, out_w, pad)
        return out.transpose(2, 3).contiguous() if transpose_out else out
    return unfolded


def time_rotation(u8, params, bound_ms: float, others: dict) -> dict:
    """``shear_rotate_crop`` on one augmentation's scaled input, folded (3
    kernels writing the next pass's layout) beside unfolded (normal
    layout and two transpose copies), outputs compared bit for bit: the
    time between CUDA events over 20 calls (host launch gaps included:
    ~20 small per-row ops a call), in turns, and the device time summed
    over one call's kernels (torch.profiler). The folded call must launch
    exactly 3 ``hshear`` kernels, no op on an image-sized tensor, and take
    less device time than the unfolded one. Each of ``others`` (C
    entries of other ``hshear`` sources) runs the unfolded composition
    too: the whole rotation as that source's tree ran it."""
    from shadow_removal_istd_tpu_torch.ops import shear

    x = shear.scale_center(u8.permute(0, 3, 1, 2).float(),
                           params["scale"].float())
    args = (params["angle"], params["row_off"], params["col_off"], CROP)

    def through(fn):
        def run():
            with mock.patch.object(shear, "hshear", fn):
                return shear.shear_rotate_crop(x, *args)
        return run

    def run_folded():
        return shear.shear_rotate_crop(x, *args)

    runs = {"folded": run_folded,
            "unfolded": through(_unfolded_hshear(shear.hshear)),
            **{f"{k} {'folded' if fn.transposes else 'unfolded'}":
               through(_entry_hshear(fn)) for k, fn in others.items()}}
    ref = run_folded()
    differ = {k: int((fn() != ref).sum()) for k, fn in runs.items()}
    times: dict[str, list] = {}
    for name in list(runs) + list(runs)[::-1]:
        times.setdefault(name, []).append(time_ms(runs[name]))
    limit = x.shape[0] * (x.shape[2] + x.shape[3] + CROP)
    dev = {k: profile_rotation(k, fn, limit) for k, fn in runs.items()}
    print(f"[time] shear_rotate_crop b{AUG_BATCH} {DATA_HW[0]}x{DATA_HW[1]}x7"
          f" -> {CROP}, whole rotation (unfolded: the normal layout + 2 "
          "transpose copies): " + " | ".join(
              f"{k} " + "/".join(f"{t:.4f}" for t in times[k])
              + f" ms by events, {dev[k][0]:.4f} ms of kernels, "
              f"{differ[k]} outputs differ" for k in runs)
          + f" | kernels' bound {bound_ms:.4f}")
    n_differ = sum(differ.values())
    n_shear, big = dev["folded"][1:]
    if n_differ or n_shear != 3 or big or dev["folded"][0] >= \
            dev["unfolded"][0]:
        raise SystemExit(f"folded shear_rotate_crop: {n_differ} outputs "
                         f"differ, {n_shear} hshear kernels, {len(big)} "
                         "image-sized ops, or not less device time than "
                         "unfolded")
    return {"rotate_ms": sum(times["folded"]) / 2,
            "rotate_unfolded_ms": sum(times["unfolded"]) / 2,
            "rotate_device_ms": dev["folded"][0],
            "rotate_unfolded_device_ms": dev["unfolded"][0]}


def profile_rotation(label, fn, limit: int) -> tuple[float, int, list]:
    """Kernels of one ``fn()`` (torch.profiler), printed as ``[profile]``
    rows; returns (kernel ms, ``hshear`` launches, the aten ops whose
    input holds more than ``limit`` elements: the per-row shift arrays
    are smaller, an image-sized copy or transpose is not)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # one warm-up step under the profiler first: a 0.25 ms region right
    # after the profiler starts was seen to lose its first kernels
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # the schedule's ProfilerStep* row spans the step: not a kernel
    kern = [e for e in prof.key_averages() if dev_us(e) > 0
            and getattr(e, "device_type", torch.autograd.DeviceType.CUDA)
            == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]
    total = sum(dev_us(e) for e in kern)
    n_shear = sum(e.count for e in kern if "hshear" in e.key)
    print(f"[profile] shear_rotate_crop {label}: kernel time "
          f"{total / 1e3:.4f} ms over {sum(e.count for e in kern)} "
          f"launches, {n_shear} hshear")
    for e in sorted(kern, key=lambda e: -dev_us(e)):
        print(f"[profile] {dev_us(e) / 1e3:9.4f} ms "
              f"{100 * dev_us(e) / max(total, 1):5.1f}% x{e.count:<3} "
              f"{e.key[:90]}")
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.key.startswith("aten::")]
    if not any(any(e.input_shapes or []) for e in ops):
        raise SystemExit("the profiler recorded no input shapes")
    big = [e for e in ops if any(math.prod(s) > limit
                                 for s in (e.input_shapes or []) if s
                                 and all(isinstance(d, int) for d in s))]
    for e in big:
        print(f"[profile] {label}: image-sized op {e.key} {e.input_shapes}")
    return total / 1e3, n_shear, big


def phase_train_timings(runs: dict, shear_err: float) -> tuple[dict, dict]:
    from shadow_removal_istd_tpu_torch.engine.steps import eval_step
    from shadow_removal_istd_tpu_torch.ops.decoder import (
        decoder_upsample,
        decoder_upsample_plain,
    )

    trainer = runs["float32"]["trainer"]
    b = trainer.cfg.batch_size
    torch.cuda.reset_peak_memory_stats()
    ph = time_train_steps(trainer)
    print(f"[time] train step 256x256 b{b} f32 (TF32 off), median of 7: "
          f"{ph['step']:.3f} ms = {b * 1e3 / ph['step']:.1f} img/s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    bf = time_train_steps(runs["bfloat16"]["trainer"])
    print(f"[time] train step 256x256 b{b} bf16 compute (VGG in f32), "
          f"median of 7: {bf['step']:.3f} ms = {b * 1e3 / bf['step']:.1f} "
          f"img/s (" + ", ".join(f"{k} {v:.3f}" for k, v in bf.items()
                                 if k != "step") + " ms)")
    for name in ("augment", "g_forward", "d_phase", "g_adv", "g_visual",
                 "g_backward", "adam_g"):
        print(f"[time]   {name:<10} {ph[name]:9.3f} ms "
              f"{100 * ph[name] / ph['step']:5.1f}%")
    # the visual loss alone (both terms: matte and shadow-free), its VGG
    # forwards and the backward to the predictions, as in the step
    from shadow_removal_istd_tpu_torch.losses import visual_loss

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    preds = [torch.rand(b, c, CROP, CROP, device=DEVICE, generator=gen)
             * 2 - 1 for c in (1, 3)]
    targets = [torch.rand_like(p) * 2 - 1 for p in preds]

    def vis():
        for p, t in zip(preds, targets):
            visual_loss(trainer.state.vgg, p.requires_grad_(True),
                        t).backward()

    vis_ms = time_ms(vis, 5)
    print(f"[time]   visual loss alone (2 terms, VGG forwards + backward "
          f"to the predictions): {vis_ms:.3f} ms "
          f"{100 * vis_ms / ph['step']:5.1f}% of the step")
    profile_train_step(trainer)

    tot = time_shear_passes()

    # the decoder kernels' zero-pad (ConvTranspose) form at the
    # validation shapes: 480x640, batch 16, f32, one part; the final
    # steps also through the CUDA-core kernel (before/after)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    dec = {f"{g}{k}": 0.0 for g in ("", "wide_", "final_")
           for k in ("ms", "cuda_core_ms", "plain_ms", "library_ms",
                     "bound_ms")}
    dec["err"] = 0.0
    for label, sh, sw, parts, co, final in decoder_steps(*DATA_HW):
        parts = (sum(parts),)
        xs, w4, s4, b4 = step_inputs(b, sh, sw, parts, co, final,
                                     torch.float32, gen)
        kw = dict(leaky=not final, zero_pad=True)
        got, variant = counted(xs, w4, s4, b4, **kw)
        err = (got - decoder_upsample_plain(xs, w4, s4, b4, **kw)
               ).abs().max().item()
        dec["err"] = max(dec["err"], err)
        if (err > TOL[torch.float32]
                or variant != expected_variant(torch.float32, final)):
            raise SystemExit(f"zero-pad kernel disagrees at {label} "
                             f"({variant})")
        ms = time_ms(lambda: decoder_upsample(xs, w4, s4, b4, **kw), 10)
        ms_cc = (ms if variant == "cuda_core" else time_ms(
            lambda: cuda_core_only(xs, w4, s4, b4, **kw), 10))
        plain = time_ms(
            lambda: decoder_upsample_plain(xs, w4, s4, b4, **kw), 10)
        a = torch.nn.functional.pad(xs[0], (1, 1, 1, 1))
        k = w4.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = time_ms(lambda: torch.nn.functional.conv2d(a, k), 10)
        flops, nbytes = step_cost(b, sh, sw, parts, co, final, 4)
        bound = fma_ceiling_ms(flops, nbytes)
        print(f"[time] zero-pad 480x640 b{b} f32 step {label:<24} {variant} "
              f"{ms:.4f} ms | cuda_core {ms_cc:.4f} | plain {plain:.4f} | "
              f"cudnn conv {lib:.4f} | bound {bound:.4f} | max_abs_err "
              f"{err:.2e} | {flops / ms / 1e9:.1f} TFLOP/s, "
              f"{100 * flops / ms * 1e3 / PEAK_F32:.0f} % of the f32 FMA "
              f"rate (cudnn {flops / lib / 1e9:.1f} TFLOP/s)")
        reps = 1 if final else 2
        group = "final_" if final else "wide_"
        for key, v in (("ms", ms), ("cuda_core_ms", ms_cc),
                       ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bound)):
            dec[key] += reps * v
            dec[group + key] += reps * v
    print(f"[time] zero-pad per stacked forward 480x640 b{b} f32 (10 "
          f"launches): kernels {dec['ms']:.4f} ms, cuda_core only "
          f"{dec['cuda_core_ms']:.4f}, plain {dec['plain_ms']:.4f}, cudnn "
          f"conv {dec['library_ms']:.4f}, bound {dec['bound_ms']:.4f}; "
          f"max_abs_err {dec['err']:.2e} (tol 2e-5)")
    for group, name, n in (("wide_", "cuda_core", 8), ("final_", "narrow", 2)):
        print(f"[time] zero-pad 480x640 b{b} f32 {group[:-1]} steps ({n} "
              f"launches): {name} {dec[group + 'ms']:.4f} ms, cuda_core "
              f"{dec[group + 'cuda_core_ms']:.4f}, plain "
              f"{dec[group + 'plain_ms']:.4f}, cudnn conv "
              f"{dec[group + 'library_ms']:.4f}, bound "
              f"{dec[group + 'bound_ms']:.4f}")

    # validation throughput: eval_step on one full-resolution batch
    batch = next(trainer.valid_batches())
    ms = time_ms(lambda: eval_step(trainer.state, batch), 5)
    print(f"[time] validation eval_step 480x640 b{b} f32: {ms:.3f} ms = "
          f"{b * 1e3 / ms:.1f} img/s")

    shear_entry = {
        "name": "hshear", "route": "cuda", "source": SHEAR_SOURCE,
        "replaces": SHEAR_REPLACES,
        "launches": runs["float32"]["shear_launches"],
        "max_abs_err": shear_err,
        "ms": round(tot["ms"], 5), "plain_ms": round(tot["plain_ms"], 5),
        "bound_ms": round(tot["bound_ms"], 5), "bound_by": "bytes",
        "library_ms": round(tot["library_ms"], 5),
        "normal_layout_ms": round(tot["normal_ms"], 5),
        **{k: round(tot[k], 5) for k in (
            "rotate_ms", "rotate_unfolded_ms", "rotate_device_ms",
            "rotate_unfolded_device_ms")},
        "shape": "one augmentation = 3 passes (2 written transposed), "
                 "batch 16, 7 channels, 480x640 -> 256, f32"}
    extra = {"launches_valid": runs["float32"]["decoder_launches"],
             "zero_pad_ms": round(dec["ms"], 5),
             "zero_pad_wide_ms": round(dec["wide_ms"], 5),
             "zero_pad_wide_library_ms": round(dec["wide_library_ms"], 5),
             "zero_pad_wide_bound_ms": round(dec["wide_bound_ms"], 5),
             "zero_pad_narrow_ms": round(dec["final_ms"], 5),
             "zero_pad_narrow_cuda_core_ms": round(
                 dec["final_cuda_core_ms"], 5)}
    return shear_entry, extra


def unet_upconv_steps(h: int, w: int, ngf: int = NGF):
    """UNet's decoder up-convs of an HxW input (depth 4), innermost
    first: (label, H, W, Ci, Co) at the step's input resolution. Each
    runs without LeakyReLU and BN, so it is a ``final``-form decoder
    step with Co >= 64."""
    return [(f"{h >> k}x{w >> k} {ngf << k}->{ngf << (k - 1)}", h >> k,
             w >> k, ngf << k, ngf << (k - 1)) for k in (4, 3, 2, 1)]


def _zoo_kernels(gen) -> dict:
    """K1 at UNet's four up-conv shapes, both pads, f32 and bf16: held
    to the plain version (and, at the K = 4096 step, to float64), then
    timed at a 256x256 batch-32 bf16 forward's shapes (edge pad) and a
    480x640 batch-16 f32 validation's (zero pad) beside the plain
    version, cuDNN's phase conv and ``conv_transpose2d``, and the
    bound."""
    from shadow_removal_istd_tpu_torch.ops.decoder import (
        decoder_upsample,
        decoder_upsample_plain,
    )

    F = torch.nn.functional
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for label, sh, sw, ci, co in unet_upconv_steps(*ZOO_HW):
        for dtype in (torch.float32, torch.bfloat16):
            xs, w4, _, _ = step_inputs(2, sh, sw, (ci,), co, True, dtype,
                                       gen)
            for zero_pad in (False, True):
                kw = dict(leaky=False, zero_pad=zero_pad)
                got, variant = counted(xs, w4, None, None, **kw)
                want = decoder_upsample_plain(xs, w4, None, None, **kw)
                err = (got.float() - want.float()).abs().max().item()
                exp = ("tensor_core" if dtype == torch.bfloat16
                       else "cuda_core")
                ok = err <= TOL[dtype] and variant == exp
                worst[dtype] = max(worst[dtype], err)
                extra = ""
                if 4 * ci == 4096:
                    exact = decoder_f64(xs, w4, None, None, **kw)
                    off = (got.double() - exact).abs().max().item()
                    extra = f", f64 {off:.2e}"
                    ok = ok and off <= TOL[dtype]
                print(f"[zoo] K1 UNet step {label:<18} {str(dtype)[6:]:<8} "
                      f"{'zero' if zero_pad else 'edge'} {variant:<11} "
                      f"max_abs_err {err:.3e}{extra} (tol {TOL[dtype]:.0e}) "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"zoo: K1 disagrees or wrong variant "
                                     f"at UNet step {label} {dtype} {kw}")
    out = {"worst": worst}
    # bf16 serving (the engine's edge-pad form) and f32 validation (the
    # CLI's ConvTranspose form, zero pad), each step's 2 launches summed
    for key, dt, (h, w), n, zero_pad in (
            ("bf16", torch.bfloat16, ZOO_HW, ZOO_SERVE_BATCH, False),
            ("f32", torch.float32, DATA_HW, ZOO_VALID, True)):
        tot = dict.fromkeys(("ms", "plain_ms", "conv_ms", "convt_ms",
                             "bound_ms", "ops_ms", "bytes_ms", "flops"), 0.0)
        peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32
        for label, sh, sw, ci, co in unet_upconv_steps(h, w):
            xs, w4, _, _ = step_inputs(n, sh, sw, (ci,), co, True, dt, gen)
            kw = dict(leaky=False, zero_pad=zero_pad)
            got, variant = counted(xs, w4, None, None, **kw)
            err = (got.float() - decoder_upsample_plain(
                xs, w4, None, None, **kw).float()).abs().max().item()
            exp = "tensor_core" if dt == torch.bfloat16 else "cuda_core"
            if err > TOL[dt] or variant != exp:
                raise SystemExit(f"zoo: timed UNet step {label} {key}: "
                                 f"{variant} {err:.3e}")
            ms = time_ms(lambda: decoder_upsample(xs, w4, None, None, **kw))
            plain = time_ms(lambda: decoder_upsample_plain(
                xs, w4, None, None, **kw), 5)
            # one cuDNN call of the same work: the phase conv over the
            # padded input, and the up-conv as conv_transpose2d
            a = F.pad(xs[0], (1, 1, 1, 1),
                      mode="constant" if zero_pad else "replicate")
            k = w4.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            conv = time_ms(lambda: F.conv2d(a, k))
            wt = (torch.randn(ci, co, 4, 4, device=DEVICE, generator=gen)
                  / (16 * ci) ** 0.5).to(dt)
            convt = time_ms(lambda: F.conv_transpose2d(xs[0], wt, stride=2,
                                                       padding=1))
            flops, nbytes = step_cost(n, sh, sw, (ci,), co, True,
                                      xs[0].element_size())
            t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
            print(f"[time] zoo UNet {h}x{w} b{n} {key} "
                  f"{'zero' if zero_pad else 'edge'} step {label:<18} "
                  f"{variant} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s) "
                  f"| plain {plain:.4f} | cudnn conv {conv:.4f} | cudnn "
                  f"conv_transpose2d {convt:.4f} | bound "
                  f"{max(t_ops, t_bytes):.4f} "
                  f"({'ops' if t_ops >= t_bytes else 'bytes'})")
            for name, v in (("ms", ms), ("plain_ms", plain),
                            ("conv_ms", conv), ("convt_ms", convt),
                            ("bound_ms", max(t_ops, t_bytes)),
                            ("ops_ms", t_ops), ("bytes_ms", t_bytes),
                            ("flops", flops)):
                tot[name] += 2 * v          # G1 and G2 each run the step
        print(f"[time] zoo UNet {h}x{w} b{n} {key} up-convs (8 launches, "
              f"{tot['flops']:.4g} FLOP): {exp} {tot['ms']:.4f} ms, plain "
              f"{tot['plain_ms']:.4f}, cudnn conv {tot['conv_ms']:.4f}, "
              f"cudnn conv_transpose2d {tot['convt_ms']:.4f}, bound "
              f"{tot['bound_ms']:.4f}")
        out[key] = {k: round(v, 5) for k, v in tot.items()}
    return out


def _zoo_serving(gen) -> dict:
    """UNet bf16 stacked serving through ``InferenceEngine(net_g="unet")``
    at 256x256, batch 32: 8 tensor-core and no narrow launches a
    forward, uint8 within 2 gray levels of the plain path, img/s beside
    MNet's in the same turns."""
    from shadow_removal_istd_tpu_torch.models import layers
    from shadow_removal_istd_tpu_torch.ops.decoder import (
        decoder_upsample,
        decoder_upsample_plain,
    )
    from shadow_removal_istd_tpu_torch.serving import InferenceEngine

    n = ZOO_SERVE_BATCH
    engines = {k: InferenceEngine(k, ngf=NGF, dtype="bfloat16",
                                  max_batch=n, seed=0, device=DEVICE)
               for k in ("unet", "mnet")}
    x = torch.randint(0, 256, (n, *ZOO_HW, 3), dtype=torch.uint8,
                      device=DEVICE, generator=gen)
    unet = engines["unet"]
    unet._stacked(x)
    torch.cuda.synchronize()
    reset_decoder_counts()
    m_k, y_k = unet._stacked(x)
    torch.cuda.synchronize()
    by_variant = dict(decoder_upsample.launches_by_variant)
    with mock.patch.object(layers, "decoder_upsample",
                           decoder_upsample_plain):
        m_p, y_p = unet._stacked(x)
    diff = max(int((a.int() - b.int()).abs().max())
               for a, b in ((m_k, m_p), (y_k, y_p)))
    print(f"[zoo] UNet bf16 stacked forward 256x256 b{n}: decoder launches "
          f"{by_variant}; kernel vs plain decoder max diff {diff} gray "
          f"levels (limit 2)")
    if by_variant != {"tensor_core": 8, "cuda_core": 0, "narrow": 0}:
        raise SystemExit(f"zoo: UNet bf16 forward: expected 8 tensor_core "
                         f"launches, got {by_variant}")
    if diff > 2:
        raise SystemExit("zoo: UNet kernel path disagrees with the plain "
                         "decoder")
    runs = {}
    for name in ("unet", "mnet", "mnet", "unet"):
        runs.setdefault(name, []).append(
            time_ms(lambda: engines[name]._stacked(x), iters=5))
    profile_stacked(unet, x, f"zoo UNet stacked 256x256 b{n} bf16")
    img_s = {k: n * 1e3 * len(v) / sum(v) for k, v in runs.items()}
    print(f"[time] zoo stacked G1+G2 256x256 b{n} bf16: " + "; ".join(
        f"{k} {img_s[k]:.1f} img/s (" + ", ".join(f"{t:.3f}" for t in v)
        + " ms/batch)" for k, v in runs.items()))
    return {"by_variant": by_variant, "diff": diff,
            **{f"{k}_img_s": round(v, 2) for k, v in img_s.items()}}


def _zoo_trainer(cfg_kw: dict, vgg_path, train, valid, name: str):
    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
    from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer

    files = SMOKE_DIR / f"zoo_{name}"
    run = RunConfig(seed=0, valid_every=1, vgg_weights=str(vgg_path),
                    weights_dir=str(files), logs_dir=str(files),
                    checkpoint_path=str(files / "checkpoint.msgpack"),
                    device_cache=True)
    return Trainer(TrainConfig(**{**cfg_kw, **TRAIN_KW}), run,
                   train_streams=train, valid_streams=valid, device=DEVICE)


def _step_img_s(trainer, label: str) -> float:
    ph = time_train_steps(trainer, steps=3)
    img_s = trainer.cfg.batch_size * 1e3 / ph["step"]
    print(f"[time] zoo train step {label}: {ph['step']:.3f} ms, "
          f"{img_s:.1f} img/s (median of 3, CUDA events; " + ", ".join(
              f"{k} {v:.2f}" for k, v in ph.items() if k != "step") + ")")
    return img_s


def _zoo_training(vgg_path) -> dict:
    """UNet G + BEGAN D at the CLI's defaults (f32, 256 crops, batch
    16, full widths) for one epoch and a 480x640 validation: k1/k2 in
    [0, 1] (and moved by the timed steps from 0.5), 8 CUDA-core decoder
    launches per stacked forward; then DenseUNet G + dummy D with
    SoftAdapt for one epoch."""
    from shadow_removal_istd_tpu_torch.data.synthetic import (
        synthetic_triplets,
    )
    from shadow_removal_istd_tpu_torch.ops.decoder import decoder_upsample

    train = synthetic_triplets(ZOO_TRAIN, *DATA_HW, seed=2)
    valid = synthetic_triplets(ZOO_VALID, *DATA_HW, seed=3)
    out = {}
    t0 = time.perf_counter()
    tr = _zoo_trainer(dict(net_g="unet", net_d="began", aug_method="shear"),
                      vgg_path, train, valid, "began")
    k0 = (float(tr.state.k1), float(tr.state.k2))
    reset_decoder_counts()
    tr.train(1)
    torch.cuda.synchronize()
    by_variant = dict(decoder_upsample.launches_by_variant)
    # the validation batches, its image log and the epoch-0 training one
    forwards = -(-ZOO_VALID // tr.cfg.batch_size) + 2
    k = (float(tr.state.k1), float(tr.state.k2))
    print(f"[zoo] UNet + BEGAN f32: 1 epoch x {tr.cfg.steps_per_epoch} "
          f"steps + a {DATA_HW[0]}x{DATA_HW[1]} validation in "
          f"{time.perf_counter() - t0:.1f} s; k1 {k0[0]} -> {k[0]:.6g}, k2 "
          f"{k0[1]} -> {k[1]:.6g}; decoder launches {by_variant} "
          f"({forwards} stacked forwards)")
    _check_history(tr, "zoo UNet + BEGAN")
    if not all(0.0 <= v <= 1.0 for v in k):
        raise SystemExit(f"zoo: BEGAN k1/k2 {k} left [0, 1]")
    if by_variant != {"tensor_core": 0, "cuda_core": 8 * forwards,
                      "narrow": 0}:
        raise SystemExit(f"zoo: UNet f32 validation: expected "
                         f"{8 * forwards} cuda_core launches, got "
                         f"{by_variant}")
    # from k = 0.5 the clip cannot hold k still: the timed steps must
    # move both, on the card, within [0, 1]
    tr.state.k1 = torch.full((), 0.5, device=DEVICE)
    tr.state.k2 = torch.full((), 0.5, device=DEVICE)
    img_s = _step_img_s(tr, "UNet + BEGAN f32")
    k = (float(tr.state.k1), float(tr.state.k2))
    profile_train_step(tr, "zoo train step UNet + BEGAN 256x256 b16 f32")
    print(f"[zoo] BEGAN k1, k2 after 4 more steps from 0.5: {k[0]:.6g}, "
          f"{k[1]:.6g}")
    if not all(0.0 <= v <= 1.0 and v != 0.5 for v in k):
        raise SystemExit(f"zoo: BEGAN k1/k2 {k} did not move within [0, 1]")
    out.update(began_decoder=sum(by_variant.values()),
               unet_began_img_s=round(img_s, 2))
    del tr
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tr = _zoo_trainer(dict(net_g="denseunet", net_d="dummy", softadapt=True,
                           aug_method="shear"), vgg_path, train, None,
                      "softadapt")
    w0 = tr.state.softadapt.weights.clone()
    tr.train(1)
    w = tr.state.softadapt.weights
    print(f"[zoo] DenseUNet + dummy D + SoftAdapt f32: 1 epoch x "
          f"{tr.cfg.steps_per_epoch} steps in {time.perf_counter() - t0:.1f}"
          f" s; weights {[round(v, 5) for v in w0.tolist()]} -> "
          f"{[round(v, 5) for v in w.tolist()]} (sum {float(w.sum()):.6f})")
    for i, h in enumerate(tr.history):
        if not all(math.isfinite(v) for v in h.values()):
            raise SystemExit(f"zoo: DenseUNet epoch {i}: non-finite {h}")
    if torch.equal(w, w0) or abs(float(w.sum()) - 1.0) > 1e-5:
        raise SystemExit("zoo: SoftAdapt weights did not move or lost "
                         "their sum")
    out["denseunet_softadapt_img_s"] = round(
        _step_img_s(tr, "DenseUNet + dummy + SoftAdapt f32"), 2)
    del tr
    torch.cuda.empty_cache()
    return out


def _zoo_legacy() -> dict:
    """``cli.stcgan_main --tasks train infer`` at full width on the
    ``cli`` phase's ISTD directory (train_B masks as G1's targets): 2
    epochs with plateau, DCGAN init and the legacy resizes, then infer
    to 192x256 PNGs; no decoder launch. Then the legacy G1 -> G2 at
    480x640 (odd halvings in pix2pix) through the engine, finite."""
    import logging

    from shadow_removal_istd_tpu_torch.cli import stcgan_main
    from shadow_removal_istd_tpu_torch.data.synthetic import (
        write_istd_layout,
    )
    from shadow_removal_istd_tpu_torch.engine import loop
    from shadow_removal_istd_tpu_torch.ops.decoder import decoder_upsample
    from shadow_removal_istd_tpu_torch.serving import InferenceEngine
    from shadow_removal_istd_tpu_torch.utils import image_io
    from shadow_removal_istd_tpu_torch.utils.msgpack_codec import from_bytes

    istd = SMOKE_DIR / "cli" / "istd"
    if not istd.is_dir():
        write_istd_layout(str(istd), CLI_TRAIN, CLI_TEST, *DATA_HW)
    root = SMOKE_DIR / "legacy"
    trainers = []
    orig_train = loop.Trainer.train

    def train(self, epochs):
        trainers.append(self)
        return orig_train(self, epochs)

    t0 = time.perf_counter()
    reset_decoder_counts()
    handlers = list(logging.getLogger().handlers)
    try:
        with mock.patch.object(loop.Trainer, "train", train):
            stcgan_main.main(stcgan_main.build_parser().parse_args([
                "--tasks", "train", "infer", "--devices", DEVICE,
                "--data-dir", str(istd), "--epochs", "2", "--log-every",
                "1", "--valid-every", "1", "--weights", str(root / "w"),
                "--logs", str(root / "l"), "--infered", str(root / "out"),
                *LEGACY_ARGS]))
    finally:
        for h in logging.getLogger().handlers[len(handlers):]:
            h.close()
        logging.getLogger().handlers[:] = handlers
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_dec = decoder_upsample.launches
    tr = trainers[0]
    print(f"[zoo] legacy CLI (pix2pix ngf {tr.cfg.ngf}, NLayer ndf "
          f"{tr.cfg.ndf}, plateau, DCGAN init, resize 300x400 -> "
          f"{tr.cfg.image_size} crops, batch {tr.cfg.batch_size}): 2 epochs "
          f"x {tr.cfg.steps_per_epoch} steps + 2 validations at 256x256 + "
          f"infer of {CLI_TEST} in {wall:.1f} s; decoder launches {n_dec}")
    _check_history(tr, "zoo legacy")
    ck = from_bytes((root / "w" / "checkpoint.msgpack").read_bytes())
    plateau = {k: ck.get("host", {}).get(k) for k in ("plateau_g",
                                                      "plateau_d")}
    print(f"[zoo] legacy checkpoint epoch {ck['epoch']}, host plateau "
          f"state {plateau}")
    if n_dec != 0 or None in plateau.values() or ck["epoch"] != 2:
        raise SystemExit("zoo: legacy run reached the decoder or lost its "
                         "plateau state")
    shapes = set()
    for sub, read in (("shadowless", image_io.imread_color),
                      ("matte", image_io.imread_gray)):
        files = sorted((root / "out" / sub / "istd").glob("*.png"))
        shapes |= {read(str(f)).shape[:2] for f in files}
        if len(files) != CLI_TEST:
            raise SystemExit(f"zoo: legacy infer wrote {len(files)} {sub}")
    print(f"[zoo] legacy infer PNG sizes {sorted(shapes)} (want 192x256)")
    if shapes != {(192, 256)}:
        raise SystemExit("zoo: legacy infer outputs are not 192x256")
    img_s = _step_img_s(tr, "legacy pix2pix + NLayer f32")
    del tr, trainers[:]
    torch.cuda.empty_cache()
    engine = InferenceEngine("stcgan", ngf=LEGACY_NGF, dtype="float32",
                             max_batch=2, device=DEVICE)
    w = root / "w"
    engine.load_weights(str(w / "G1_Pix2PixUNet_latest.msgpack"),
                        str(w / "G2_Pix2PixUNet_latest.msgpack"))
    img = np.random.default_rng(5).integers(0, 256, (*DATA_HW, 3),
                                            dtype=np.uint8)
    reset_decoder_counts()
    (m, y), _ = engine.infer_group([img, img[::-1]])
    print(f"[zoo] legacy G1 -> G2 f32 at {DATA_HW[0]}x{DATA_HW[1]} "
          f"(bucket {engine.bucket_of(*DATA_HW)}): matte {m.shape}, "
          f"shadow-free {y.shape}, decoder launches "
          f"{decoder_upsample.launches}")
    if m.shape != DATA_HW or y.shape != (*DATA_HW, 3):
        raise SystemExit("zoo: legacy 480x640 inference has wrong shapes")
    return {"legacy_img_s": round(img_s, 2)}


def phase_zoo(vgg_path: Path) -> dict:
    """The model zoo and the legacy tree on the card (see the module
    docstring, phase 9); returns the K1 numbers and launch counts."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    kern = _zoo_kernels(gen)
    serve = _zoo_serving(gen)
    trained = _zoo_training(vgg_path)
    legacy = _zoo_legacy()
    print(f"[time] zoo phase: {time.perf_counter() - t0:.1f} s")
    return {"kernels": kern, "serve": serve, **trained, **legacy,
            "decoder": sum(serve["by_variant"].values())
            + trained["began_decoder"]}


# ---------------------------------------------------------------------------
# rematerialized training and the HDF5 dataset


def _state_leaves(state) -> dict[str, torch.Tensor]:
    """Every tensor a train step updates, keyed ``kind name``: kind is
    ``param``, ``bn`` (running statistics), ``adam_g`` or ``adam_d``."""
    out = {}
    for name, net in zip(("G1", "G2", "D1", "D2"), state.models.all()):
        out.update({f"param {name}.{k}": v
                    for k, v in net.named_parameters()})
        out.update({f"bn {name}.{k}": v for k, v in net.named_buffers()})
    for which, opt in (("adam_g", state.opt_g), ("adam_d", state.opt_d)):
        for i, p in enumerate(opt.param_groups[0]["params"]):
            out.update({f"{which} {i}.{k}": v
                        for k, v in opt.state[p].items()})
    return out


def _gib(nbytes: float) -> float:
    return nbytes / 2 ** 30


def phase_remat(vgg_path: Path) -> dict:
    """Rematerialized training on the card (see the module docstring,
    phase 11); returns the ``hshear`` launches of its remat steps."""
    import copy
    import dataclasses

    from shadow_removal_istd_tpu_torch.data.synthetic import (
        synthetic_triplets,
    )
    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
    from shadow_removal_istd_tpu_torch.engine.epoch import RngStreams
    from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer
    from shadow_removal_istd_tpu_torch.engine.steps import (
        METRIC_KEYS,
        train_step,
    )
    from shadow_removal_istd_tpu_torch.ops.augment import augment_batch
    from shadow_removal_istd_tpu_torch.ops.shear import hshear

    t_phase = time.perf_counter()
    root = SMOKE_DIR / "remat"
    train = synthetic_triplets(REMAT_TRAIN, *DATA_HW, seed=6)

    def make(**kw):
        files = root / "_".join(f"{v}" for v in kw.values())
        return Trainer(TrainConfig(aug_method="shear", **{**TRAIN_KW, **kw}),
                       RunConfig(seed=0, vgg_weights=str(vgg_path),
                                 device_cache=True, weights_dir=str(files),
                                 logs_dir=str(files),
                                 checkpoint_path=str(files / "c.msgpack")),
                       train_streams=train, device=DEVICE)

    trainer = make()
    plain = trainer.state
    remat = copy.deepcopy(plain)
    remat.cfg = dataclasses.replace(plain.cfg, remat=True)
    arrays = trainer.cache.arrays
    gen = RngStreams(3, 0, DEVICE)
    b16, aug256 = trainer.cfg.batch_size, trainer.aug_cfg

    def raw(s, b):
        idx = torch.arange(s * b, (s + 1) * b, device=DEVICE) % len(arrays[0])
        return tuple(a.index_select(0, idx) for a in arrays)

    def gens(s):
        return (gen.generator("dropout_g1", s),
                gen.generator("dropout_g2", s))

    # 1. two steps each from one state on the same batches and
    # generators, cuDNN's deterministic algorithms
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        batches = [augment_batch(gen.generator("augment", s), raw(s, b16),
                                 aug256) for s in range(2)]
        used = {name: [gens(s) for s in range(2)]
                for name in ("plain", "remat")}
        mets = {name: [train_step(st, batches[s], used[name][s])
                       for s in range(2)]
                for name, st in (("plain", plain), ("remat", remat))}
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = prev
    worst = {"metrics": 0.0, "metrics_rel": 0.0}
    for a, b in zip(mets["plain"], mets["remat"]):
        for k in METRIC_KEYS:
            d = float((a[k] - b[k]).abs())
            worst["metrics"] = max(worst["metrics"], d)
            worst["metrics_rel"] = max(worst["metrics_rel"],
                                       d / max(abs(float(a[k])), 1e-30))
            if not math.isfinite(float(b[k])):
                raise SystemExit(f"remat: non-finite {k}")
    la, lb = _state_leaves(plain), _state_leaves(remat)
    for key in la:
        kind = key.split()[0]
        worst[kind] = max(worst.get(kind, 0.0), float(
            (la[key].detach().float() - lb[key].detach().float()).abs()
            .max()))
    gens_equal = all(torch.equal(x.get_state(), y.get_state())
                     for px, py in zip(used["plain"], used["remat"])
                     for x, y in zip(px, py))
    print(f"[remat] 2 plain and 2 remat steps from one state ({CROP}x{CROP} "
          f"b{b16}, droprate {plain.cfg.droprate}, deterministic cuDNN), "
          "max abs difference: " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items())
          + f"; bit-identical: {all(v == 0 for v in worst.values())}; "
          f"dropout generators' states equal: {gens_equal}")
    if worst["param"] > REMAT_PARAM_TOL or worst["metrics_rel"] > \
            REMAT_METRIC_RTOL or not gens_equal:
        raise SystemExit(f"remat: steps differ from the plain steps "
                         f"{worst}")

    def timed(state, aug, b, s):
        """One step (gather, augmentation, train_step): its phases in ms
        (CUDA events), the bytes allocated before it and its peak."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        evs = [("start", torch.cuda.Event(enable_timing=True))]
        evs[0][1].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            evs.append((name, ev))

        batch = augment_batch(gen.generator("augment", s), raw(s, b), aug)
        mark("augment")
        train_step(state, batch, gens(s), mark=mark)
        torch.cuda.synchronize()
        ph = {n: a.elapsed_time(e) for (_, a), (n, e) in zip(evs, evs[1:])}
        ph["step"] = evs[0][1].elapsed_time(evs[-1][1])
        return ph, base, torch.cuda.max_memory_allocated()

    def summary(rows):
        """Median phases and the largest peak of rows after the first
        (the warm-up)."""
        rows = rows[1:]
        ph = {k: _median([r[0][k] for r in rows]) for k in rows[0][0]}
        base = max(r[1] for r in rows)
        peak = max(r[2] for r in rows)
        return ph, base, peak

    # 2. 256x256 b16: plain and remat in turns, 1 warm-up + REMAT_STEPS
    rows = {"plain": [], "remat": []}
    n_shear = 0
    for r in range(REMAT_STEPS + 1):
        for name in (("plain", "remat") if r % 2 == 0 else ("remat",
                                                             "plain")):
            before = hshear.launches
            rows[name].append(timed(plain if name == "plain" else remat,
                                    aug256, b16, 2 + r))
            if name == "remat":
                n_shear += hshear.launches - before
    res = {name: summary(v) for name, v in rows.items()}
    for name, (ph, base, peak) in res.items():
        print(f"[remat] {CROP}x{CROP} b{b16} f32 {name}: {ph['step']:.3f} "
              f"ms = {b16 * 1e3 / ph['step']:.1f} img/s (median of "
              f"{REMAT_STEPS}, CUDA events); peak {_gib(peak):.2f} GiB, "
              f"{_gib(peak - base):.2f} GiB above the {_gib(base):.2f} GiB "
              "held before the step")
    (pp, pb, pk), (rp, rb, rk) = res["plain"], res["remat"]
    print(f"[remat] remat / plain: step time {rp['step'] / pp['step']:.3f}x, "
          f"peak {rk / pk:.3f}x, step's own peak "
          f"{(rk - rb) / (pk - pb):.3f}x")
    for k in ("augment", "g_forward", "d_phase", "g_adv", "g_visual",
              "g_backward", "adam_g"):
        print(f"[remat]   {k:<10} plain {pp[k]:9.3f} ms  remat "
              f"{rp[k]:9.3f} ms")
    if n_shear != 3 * (REMAT_STEPS + 1):
        raise SystemExit(f"remat: expected {3 * (REMAT_STEPS + 1)} hshear "
                         f"launches over the remat steps, got {n_shear}")

    # 3. full-resolution crops: plain and remat at the small batch, remat
    # alone at three times it; plain's peak there is reckoned, not run
    aug_full = dataclasses.replace(aug256, crop_size=REMAT_CROP)
    small, large = REMAT_BATCHES
    total = torch.cuda.get_device_properties(0).total_memory
    full = {}
    for name, state, b in (("plain", plain, small), ("remat", remat, small),
                           ("remat", remat, large)):
        if b == large:
            _, base, peak = full[("remat", small)]
            reckoned = base + large / small * (peak - base)
            if reckoned > 0.97 * total:
                raise SystemExit(f"remat: b{large} at {REMAT_CROP}^2 "
                                 f"reckoned {_gib(reckoned):.1f} GiB of "
                                 f"the card's {_gib(total):.1f} GiB")
        torch.cuda.empty_cache()
        before = hshear.launches
        full[(name, b)] = summary([timed(state, aug_full, b, 10 + s)
                                   for s in range(3)])
        if hshear.launches - before != 9:
            raise SystemExit(f"remat: {REMAT_CROP}^2 crops took "
                             f"{hshear.launches - before} hshear launches "
                             "in 3 steps, not 9 (the shear path)")
        ph, base, peak = full[(name, b)]
        print(f"[remat] {REMAT_CROP}x{REMAT_CROP} crops of {DATA_HW[0]}x"
              f"{DATA_HW[1]} b{b} {name}: {ph['step']:.3f} ms = "
              f"{b * 1e3 / ph['step']:.1f} img/s (median of 2); peak "
              f"{_gib(peak):.2f} GiB ({_gib(peak - base):.2f} GiB above "
              f"the {_gib(base):.2f} GiB held before the step)")
    _, base, peak = full[("plain", small)]
    print(f"[remat] {REMAT_CROP}x{REMAT_CROP} b{large} plain, reckoned from "
          f"b{small} (not run): {_gib(base):.2f} GiB held + {large // small} "
          f"x {_gib(peak - base):.2f} GiB = "
          f"{_gib(base + large / small * (peak - base)):.2f} GiB of the "
          f"card's {_gib(total):.2f} GiB")

    # 4. one remat step each of the zoo's other pairs
    del trainer, plain, remat, batches
    torch.cuda.empty_cache()
    for kw in (dict(net_g="unet", net_d="began"),
               dict(net_g="denseunet", net_d="dummy", softadapt=True)):
        t = make(remat=True, **kw)
        batch = augment_batch(gen.generator("augment", 0), raw(0, b16),
                              aug256)
        m = {k: float(v) for k, v in train_step(t.state, batch,
                                                gens(0)).items()}
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        extra = ""
        if t.cfg.began:
            k1, k2 = float(t.state.k1), float(t.state.k2)
            extra = f", k1 {k1:.5f}, k2 {k2:.5f}"
            if not (0 <= k1 <= 1 and 0 <= k2 <= 1):
                bad.append("k1/k2 outside [0, 1]")
        if t.cfg.softadapt:
            w = t.state.softadapt.weights
            extra = f", SoftAdapt weights {w.tolist()}"
            if abs(float(w.sum()) - 1) > 1e-5:
                bad.append("SoftAdapt weights do not sum to 1")
        print(f"[remat] one remat step {kw['net_g']} + {kw['net_d']}"
              f"{' + softadapt' if t.cfg.softadapt else ''}: G "
              f"{m['G']:.4f}, D {m['D']:.4f}{extra}")
        if bad:
            raise SystemExit(f"remat {kw}: {bad}")
        del t
        torch.cuda.empty_cache()
    print(f"[time] remat phase: {time.perf_counter() - t_phase:.1f} s")
    return {"hshear": n_shear}


def phase_h5(vgg_path: Path) -> dict:
    """The HDF5 dataset on the card's host (see the module docstring,
    phase 12); returns the kernels' launch counts of its CLI run."""
    import logging

    from shadow_removal_istd_tpu_torch.cli.main import build_parser
    from shadow_removal_istd_tpu_torch.cli.main import main as cli_main
    from shadow_removal_istd_tpu_torch.data.h5 import (
        ISTDH5Dataset,
        build_h5,
    )
    from shadow_removal_istd_tpu_torch.data.istd import ISTDDataset
    from shadow_removal_istd_tpu_torch.engine import loop
    from shadow_removal_istd_tpu_torch.ops.decoder import decoder_upsample
    from shadow_removal_istd_tpu_torch.ops.shear import hshear

    t_phase = time.perf_counter()
    istd = SMOKE_DIR / "cli" / "istd"
    root = SMOKE_DIR / "h5"
    root.mkdir(parents=True, exist_ok=True)
    path = root / "istd.h5"
    t0 = time.perf_counter()
    build_h5(str(path), str(istd))
    build_s = time.perf_counter() - t0
    print(f"[h5] build_h5 of the cli phase's ISTD directory ({CLI_TRAIN} + "
          f"{CLI_TEST} {DATA_HW[0]}x{DATA_HW[1]} triplets, the port's "
          f"writer): {build_s:.2f} s, {path.stat().st_size / 1e6:.1f} MB")
    streams = ("img", "mask", "matte", "target")
    names = {}
    for subset, n in (("train", CLI_TRAIN), ("test", CLI_TEST)):
        ds = ISTDH5Dataset(str(path), subset)
        t0 = time.perf_counter()
        got = ds.load_streams(streams)
        dt = time.perf_counter() - t0
        names[subset] = ds.filenames()
        ds.close()
        d = ISTDDataset(str(istd), subset, datas=streams)
        want = d.load_all()
        same = all(got[k].dtype == want[k].dtype
                   and got[k].shape == want[k].shape
                   and got[k].tobytes() == want[k].tobytes()
                   for k in streams)
        same_names = names[subset] == [d.filename(i) for i in range(len(d))]
        print(f"[h5] {subset}: load_streams {dt / n:.4f} s per image "
              f"({n} images, {len(streams)} streams); equal to "
              f"ISTDDataset.load_all byte for byte: {same}; names equal: "
              f"{same_names}")
        if not (same and same_names):
            raise SystemExit(f"h5: the {subset} split differs from the "
                             "directory's")

    seen = []
    orig_train = loop.Trainer.train

    def train(self, epochs):
        seen.append(self)
        return orig_train(self, epochs)

    handlers = list(logging.getLogger().handlers)
    hshear.launches = 0
    reset_decoder_counts()
    t0 = time.perf_counter()
    try:
        with mock.patch.object(loop.Trainer, "train", train):
            cli_main(build_parser().parse_args([
                "--data-h5", str(path), "--tasks", "train", "--epochs",
                "1", "--vgg-weights", str(vgg_path), "--weights",
                str(root / "w"), "--logs", str(root / "l"), *CLI_ARGS]))
    finally:   # each run adds its log handlers to the root logger
        for h in logging.getLogger().handlers[len(handlers):]:
            h.close()
        logging.getLogger().handlers[:] = handlers
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_shear, n_dec = hshear.launches, decoder_upsample.launches
    by_variant = dict(decoder_upsample.launches_by_variant)
    (trainer,) = seen
    steps = trainer.cfg.steps_per_epoch
    # one validation, its image log and the epoch-0 training image log,
    # whose augmentation is 3 more hshear launches
    forwards = -(-CLI_TEST // trainer.cfg.batch_size) + 2
    print(f"[h5] cli.main --data-h5 --tasks train --epochs 1: {steps} steps "
          f"+ a validation in {wall:.1f} s; hshear launches {n_shear}, "
          f"decoder launches {n_dec} {by_variant} ({forwards} stacked "
          f"forwards); validation names from the file: "
          f"{trainer.valid_names == names['test']}")
    _check_history(trainer, "h5")
    if n_shear != 3 * (steps + 1):
        raise SystemExit(f"h5: expected {3 * (steps + 1)} hshear launches, "
                         f"got {n_shear}")
    want = {"tensor_core": 0, "cuda_core": 8 * forwards,
            "narrow": 2 * forwards}
    if n_dec != 10 * forwards or by_variant != want:
        raise SystemExit(f"h5: expected {10 * forwards} decoder launches "
                         f"{want}, got {n_dec} {by_variant}")
    if trainer.valid_names != names["test"]:
        raise SystemExit("h5: validation names are not the file's")
    print(f"[h5] h5py imported in this process: {'h5py' in sys.modules}")
    if "h5py" in sys.modules:
        raise SystemExit("h5: the port imported h5py")
    print(f"[time] h5 phase: {time.perf_counter() - t_phase:.1f} s")
    return {"hshear": n_shear, "decoder": n_dec}


# ---------------------------------------------------------------------------
# int8 serving


def _record_int8(fn):
    """Run ``fn()`` with ``models.quant``'s ``quantize_pad`` and
    ``int8_conv`` wrapped to record each call's arguments and output;
    returns (fn's result, {"quantize_pad": [...], "int8_conv": [...]})."""
    from shadow_removal_istd_tpu_torch.models import quant

    calls: dict = {"quantize_pad": [], "int8_conv": []}
    real_qp, real_cv = quant.quantize_pad, quant.int8_conv

    def qp(parts, sx, **kw):
        out = real_qp(parts, sx, **kw)
        calls["quantize_pad"].append(((tuple(parts), sx), kw, out))
        return out

    def cv(xq, wk, scale=None, bias=None, **kw):
        out = real_cv(xq, wk, scale, bias, **kw)
        calls["int8_conv"].append(((xq, wk, scale, bias), kw, out))
        return out

    with mock.patch.multiple(quant, quantize_pad=qp, int8_conv=cv):
        result = fn()
    return result, calls


def int8_conv_cost(args, kw) -> tuple[float, float]:
    """(operations, bytes) one ``int8_conv`` call must do and move: the
    products of the real channels at the outputs kept, the padded int8
    input, the weight, scales and bias read once, the output written
    once."""
    xq, wk, _, _ = args
    n, hp, wp, cp = xq.shape
    rows, k, _, _ = wk.shape
    phase = kw["phase"]
    co = rows // 4 if phase else rows
    # (N, 2H, 2W, Co) kept outputs, or (N, H/2, W/2, Co)
    outputs = n * (hp - 2) * (wp - 2) * co * (4 if phase else 1)
    if not phase:
        outputs //= 4
    # the channels that carry data: the weight's zero padding is no work
    ci = int((wk.reshape(-1, cp) != 0).any(0).nonzero().max()) + 1
    ops = 2.0 * outputs * k * k * ci
    elt = torch.tensor([], dtype=kw.get("out_dtype", torch.float32)
                       ).element_size()
    nbytes = (xq.numel() + wk.numel() + 4 * rows + 4 * co
              + outputs * elt)
    return ops, nbytes


def _int_mm_operands(xq, wk, phase: bool):
    """``torch._int_mm``'s operands for the same conv: ``Tensor.unfold``
    patches of the padded input (M x K) and the weight (K x N, N padded
    to a multiple of 8); the phase form at every (H+1) x (W+1) position
    and all 4*Co rows, as one matrix product computes it."""
    k, step = (2, 1) if phase else (4, 2)
    p = xq.unfold(1, k, step).unfold(2, k, step)      # (n, h, w, cp, k, k)
    a = p.permute(0, 1, 2, 4, 5, 3).reshape(-1, k * k * xq.shape[3])
    b = wk.reshape(wk.shape[0], -1)
    pad = -b.shape[0] % 8
    if pad:
        b = torch.cat([b, b.new_zeros(pad, b.shape[1])])
    return a.contiguous(), b.t().contiguous()


def _int8_kernels_vs_plain(q1, q2, gen) -> dict:
    """Both int8 kernels against their plain versions at every conv site
    of the stacked pair (20 of each), at 256x256 and 480x640, batch 2,
    in f32 and bf16 compute: the int8 tensors, the s32 sums and the
    dequantized outputs bit for bit."""
    from shadow_removal_istd_tpu_torch.models.quant import make_stacked_int8
    from shadow_removal_istd_tpu_torch.ops.int8_conv import (
        int8_conv,
        int8_conv_plain,
        quantize_pad_plain,
    )

    worst = 0.0
    for h, w in INT8_CHECK_HW:
        x = torch.rand((2, 3, h, w), device=DEVICE, generator=gen) * 2 - 1
        for dtype in (torch.float32, torch.bfloat16):
            fn = make_stacked_int8(q1, q2, compute_dtype=dtype)
            _, calls = _record_int8(lambda: fn(x))
            torch.cuda.synchronize()
            bad = []
            for (parts, sx), kw, got in calls["quantize_pad"]:
                if not torch.equal(got, quantize_pad_plain(parts, sx,
                                                           **kw)):
                    bad.append(f"quantize_pad {tuple(parts[0].shape)} "
                               f"{len(parts)} parts {kw}")
            n_acc = 0
            for args, kw, got in calls["int8_conv"]:
                acc = int8_conv(args[0], args[1], phase=kw["phase"])
                want_acc = int8_conv_plain(args[0], args[1],
                                           phase=kw["phase"])
                want = int8_conv_plain(*args, **kw)
                n_acc += int((acc != want_acc).sum())
                err = (got.float() - want.float()).abs().max().item()
                worst = max(worst, err)
                if not torch.equal(acc, want_acc) or not torch.equal(got,
                                                                     want):
                    bad.append(f"int8_conv {tuple(args[0].shape)} -> "
                               f"{tuple(got.shape)} {kw} s32 differ "
                               f"{int((acc != want_acc).sum())}, max abs "
                               f"{err:.3e}")
            print(f"[int8] {h}x{w} b2 {str(dtype)[6:]}: "
                  f"{len(calls['quantize_pad'])} quantize_pad and "
                  f"{len(calls['int8_conv'])} int8_conv sites vs plain: "
                  f"{len(bad)} differ (int8 tensors, s32 sums: {n_acc} "
                  f"differ, dequantized outputs: bit for bit)")
            if (bad or len(calls["quantize_pad"]) != 20
                    or len(calls["int8_conv"]) != 20):
                raise SystemExit("int8 kernels disagree with their plain "
                                 "versions: " + "; ".join(bad[:5]))
            del calls
            torch.cuda.empty_cache()
    return {"max_abs_err": worst}


def _int8_weights(vgg_path: Path) -> tuple[Path, Path, Path]:
    """``cli.main --tasks train --NN-upconv yes`` for one epoch on the
    ``cli`` phase's ISTD directory (the int8 path takes the nearest-
    upsample MNet; the ``cli`` phase trains the CLI's default
    ConvTranspose one); returns the G1 and G2 weight files and the test
    images' directory."""
    from shadow_removal_istd_tpu_torch.data.synthetic import (
        write_istd_layout,
    )

    istd = SMOKE_DIR / "cli" / "istd"
    if not istd.is_dir():
        write_istd_layout(str(istd), CLI_TRAIN, CLI_TEST, *DATA_HW)
    root = SMOKE_DIR / "int8"
    t0 = time.perf_counter()
    _run_cli(["--tasks", "train", "--epochs", "1", "--NN-upconv", "yes",
              "--data-dir", str(istd), "--vgg-weights", str(vgg_path),
              "--weights", str(root / "w"), "--logs", str(root / "l"),
              *CLI_ARGS])
    g1, = root.glob("w*/G1_MNet_latest.msgpack")
    g2, = root.glob("w*/G2_MNet_latest.msgpack")
    print(f"[int8] cli.main --tasks train --NN-upconv yes, 1 epoch: "
          f"{g1.name}, {g2.name} in {time.perf_counter() - t0:.1f} s")
    return g1, g2, istd / "test" / "test_A"


def _int8_daemon(g1: Path, g2: Path, calib_dir: Path, img, want) -> None:
    """The serving daemon with ``--dtype int8 --int8-calib``: one 480x640
    request, answered as this process's int8 engine answers it."""
    from shadow_removal_istd_tpu_torch.utils.image_io import imdecode_color

    status, body, rc, stats, secs = _daemon_answer(
        ["--ngf", str(NGF), "--dtype", "int8", "--int8-calib",
         str(calib_dir), "--max-batch", "1", "--load-weights-g1", str(g1),
         "--load-weights-g2", str(g2)], img, "int8")
    got = imdecode_color(body) if status == 200 else None
    diff = (int(np.abs(got.astype(int) - want).max())
            if got is not None and got.shape == want.shape else -1)
    print(f"[int8] serving daemon --dtype int8 --int8-calib (ngf {NGF}): "
          f"HTTP {status}, /stats dtype {stats.get('dtype')}, exit {rc}, "
          f"{secs:.1f} s with start-up and calibration; max diff {diff} "
          f"gray levels from this process's int8 engine (limit 2)")
    if (status != 200 or rc != 0 or stats.get("dtype") != "int8"
            or not 0 <= diff <= 2):
        raise SystemExit("int8: the daemon's answer is wrong")


def _psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    """PSNR of two [-1, 1] tensors (peak-to-peak 2)."""
    rms = (a.double() - b.double()).square().mean().sqrt().item()
    return 20 * math.log10(2.0 / max(rms, 1e-12))


def _int8_profile(engine, x) -> dict:
    """Device time of one int8 stacked forward by kernel group, with the
    launches the profiler saw of each int8 kernel (20 each when none was
    lost)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    engine._stacked(x)
    torch.cuda.synchronize()
    # a warm-up step under the profiler first, as profile_rotation does
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            engine._stacked(x)
            torch.cuda.synchronize()
            prof.step()
    groups = dict.fromkeys(("int8_conv", "quantize_pad", "elementwise",
                            "copies", "other"), 0.0)
    seen = {"int8_conv": 0, "quantize_pad": 0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if (us <= 0 or e.key.startswith("ProfilerStep")
                or getattr(e, "device_type", None)
                != torch.autograd.DeviceType.CUDA):
            continue
        key = e.key.lower()
        group = ("int8_conv" if "int8_conv_kernel" in key else
                 "quantize_pad" if "quantize_pad_kernel" in key else
                 "copies" if any(k in key for k in ("copy", "cat", "memcpy",
                                                    "memset")) else
                 "elementwise" if "elementwise" in key else "other")
        groups[group] += us / 1e3
        if group in seen:
            seen[group] += e.count
    total = sum(groups.values())
    print(f"[profile] int8 stacked 256x256 b{x.shape[0]}: device time "
          f"{total:.3f} ms: " + ", ".join(
              f"{k} {v:.3f} ({100 * v / max(total, 1e-9):.1f} %)"
              for k, v in groups.items())
          + f"; launches seen {seen}")
    return {**{k + "_ms": round(v, 4) for k, v in groups.items()},
            "launches_seen": seen}


def _int8_timings(engine, x) -> dict:
    """Each kernel's time over the 20 launches of one 256x256 b32 int8
    stacked forward, on that forward's inputs, beside its plain version,
    ``torch._int_mm`` on unfold patches (``int8_conv``) and its bound."""
    from shadow_removal_istd_tpu_torch.ops.int8_conv import (
        int8_conv,
        int8_conv_plain,
        quantize_pad,
        quantize_pad_plain,
    )

    _, calls = _record_int8(lambda: engine._stacked(x))
    tot = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   ops_ms=0.0, bytes_ms=0.0)
           for k in ("int8_conv", "quantize_pad")}
    lib_ok = True
    for (parts, sx), kw, out in calls["quantize_pad"]:
        ms = time_ms(lambda: quantize_pad(parts, sx, **kw), 10)
        plain = time_ms(lambda: quantize_pad_plain(parts, sx, **kw), 3)
        nbytes = sum(p.numel() * p.element_size() for p in parts) \
            + out.numel()
        bound = nbytes / PEAK_BYTES * 1e3
        print(f"[time] int8 quantize_pad {tuple(parts[0].shape)}"
              f"{' + ' + str(parts[1].shape[1]) if len(parts) == 2 else ''}"
              f" {str(parts[0].dtype)[6:]} -> {tuple(out.shape)}: "
              f"{ms:.4f} ms | plain {plain:.4f} | bound {bound:.4f} "
              f"(bytes)")
        t = tot["quantize_pad"]
        t["ms"] += ms
        t["plain_ms"] += plain
        t["bound_ms"] += bound
        t["bytes_ms"] += bound
    for args, kw, out in calls["int8_conv"]:
        ms = time_ms(lambda: int8_conv(*args, **kw), 10)
        plain = time_ms(lambda: int8_conv_plain(*args, **kw), 2)
        ops, nbytes = int8_conv_cost(args, kw)
        t_ops, t_bytes = ops / PEAK_INT8 * 1e3, nbytes / PEAK_BYTES * 1e3
        try:
            a, b = _int_mm_operands(args[0], args[1], kw["phase"])
            lib = time_ms(lambda: torch._int_mm(a, b), 10)
            del a, b
        except RuntimeError as exc:
            lib, lib_ok = float("nan"), False
            print(f"[time] int8 _int_mm n/a: {str(exc).splitlines()[0]}")
        print(f"[time] int8 int8_conv {'phase' if kw['phase'] else 's2'} "
              f"{tuple(args[0].shape)} x {tuple(args[1].shape)} -> "
              f"{tuple(out.shape)}: {ms:.4f} ms ({ops / ms / 1e9:.1f} "
              f"TOPS) | plain {plain:.4f} | _int_mm {lib:.4f} | bound "
              f"{max(t_ops, t_bytes):.4f} "
              f"({'ops' if t_ops >= t_bytes else 'bytes'})")
        t = tot["int8_conv"]
        t["ms"] += ms
        t["plain_ms"] += plain
        t["library_ms"] += lib
        t["bound_ms"] += max(t_ops, t_bytes)
        t["ops_ms"] += t_ops
        t["bytes_ms"] += t_bytes
    del calls
    torch.cuda.empty_cache()
    for k, t in tot.items():
        print(f"[time] int8 {k} per stacked forward 256x256 b{x.shape[0]} "
              f"(20 launches): kernels {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.4f}"
              + (f", _int_mm {t['library_ms']:.4f}" if k == "int8_conv"
                 else ""))
    if not lib_ok:
        tot["int8_conv"]["library_ms"] = None
    return tot


def phase_int8(vgg_path: Path) -> dict:
    """int8 serving on the card (see the module docstring, phase 13);
    returns the two kernels' JSON entries."""
    from shadow_removal_istd_tpu_torch.engine.steps import infer_step
    from shadow_removal_istd_tpu_torch.models import quant
    from shadow_removal_istd_tpu_torch.ops.int8_conv import (
        int8_conv,
        int8_conv_plain,
        quantize_pad,
        quantize_pad_plain,
    )
    from shadow_removal_istd_tpu_torch.serving import InferenceEngine
    from shadow_removal_istd_tpu_torch.utils.image_io import imread_color

    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    g1_path, g2_path, calib_dir = _int8_weights(vgg_path)
    calib = [imread_color(str(p)) for p in sorted(calib_dir.glob("*.png"))]
    t0 = time.perf_counter()
    engine = InferenceEngine("mnet", ngf=NGF, dtype="int8", max_batch=8,
                             calib_images=calib, device=DEVICE)
    engine.load_weights(str(g1_path), str(g2_path))
    torch.cuda.synchronize()
    print(f"[int8] engine ngf {NGF}: weights loaded, folded, calibrated on "
          f"{len(calib)} {calib[0].shape[0]}x{calib[0].shape[1]} images "
          f"and quantized in {time.perf_counter() - t0:.1f} s")
    f1, f2 = quant.fold_mnet(engine.g1), quant.fold_mnet(engine.g2)
    batches = engine._calib_batches()
    s1, m1 = quant.calibrate_mnet(f1, batches, return_outputs=True)
    s2 = quant.calibrate_mnet(f2, [torch.cat([x, m], 1)
                                   for x, m in zip(batches, m1)])
    q1, q2 = quant.quantize_mnet(f1, s1), quant.quantize_mnet(f2, s2)
    del batches, m1
    check = _int8_kernels_vs_plain(q1, q2, gen)

    # the main path: one stacked forward of a 480x640 batch of 4
    imgs = calib[:4]
    size = f"{imgs[0].shape[0]}x{imgs[0].shape[1]} b{len(imgs)}"
    engine.infer_group(imgs)
    torch.cuda.synchronize()
    quantize_pad.launches = int8_conv.launches = 0
    got = engine.infer_group(imgs)
    torch.cuda.synchronize()
    launches = {"int8_conv": int8_conv.launches,
                "quantize_pad": quantize_pad.launches}
    print(f"[int8] engine infer_group {size}: launches per stacked "
          f"forward {launches}")
    if launches != {"int8_conv": 20, "quantize_pad": 20}:
        raise SystemExit(f"int8: expected 20 launches of each kernel per "
                         f"stacked forward, got {launches}")
    with mock.patch.multiple(quant, quantize_pad=quantize_pad_plain,
                             int8_conv=int8_conv_plain):
        want = engine.infer_group(imgs)
    diffs = [np.abs(g.astype(np.int16) - p)
             for gp, pp in zip(got, want) for g, p in zip(gp, pp)]
    diff = max(int(d.max()) for d in diffs)
    share = sum(int((d > 0).sum()) for d in diffs) / sum(d.size
                                                          for d in diffs)
    print(f"[int8] kernels vs plain path, {size} uint8: max diff "
          f"{diff} gray levels (limit 2), {100 * share:.4f} % of values "
          f"differ")
    if diff > 2:
        raise SystemExit("int8 kernel path disagrees with the plain path")

    # accuracy on the same inputs: folded f32, bf16 engine, int8
    x_u8 = torch.from_numpy(np.stack(imgs)).to(DEVICE)
    x = x_u8.permute(0, 3, 1, 2).float() * (2.0 / 255.0) - 1.0
    with torch.inference_mode():
        m_ref = quant.mnet_apply_folded(f1, x)
        y_ref = quant.mnet_apply_folded(f2, torch.cat([x, m_ref], 1))
        m8, y8 = engine._int8_fn(x)
    bf16 = InferenceEngine("mnet", ngf=NGF, dtype="bfloat16", max_batch=32,
                           device=DEVICE)
    bf16.load_weights(str(g1_path), str(g2_path))
    with torch.inference_mode():
        mb, yb = infer_step(bf16.g1, bf16.g2, x)
    acc = {"psnr_int8_vs_f32": _psnr(y8, y_ref),
           "psnr_int8_vs_bf16": _psnr(y8, yb.float()),
           "psnr_bf16_vs_f32": _psnr(yb.float(), y_ref),
           "psnr_matte_int8_vs_f32": _psnr(m8, m_ref)}
    print(f"[int8] accuracy {size} (shadow-free output; matte apart): "
          + ", ".join(f"{k} {v:.2f} dB" for k, v in acc.items()))
    _int8_daemon(g1_path, g2_path, calib_dir, calib[0], got[0][1])
    del m_ref, y_ref, m8, y8, mb, yb, x

    # throughput, int8 and bf16 in turns
    xs = torch.randint(0, 256, (INT8_BATCH, 256, 256, 3), dtype=torch.uint8,
                       device=DEVICE, generator=gen)
    runs: dict = {}
    for name, eng in (("int8", engine), ("bf16", bf16), ("bf16", bf16),
                      ("int8", engine)):
        runs.setdefault(name, []).append(
            time_ms(lambda: eng._stacked(xs), iters=10))
    img_s = {k: INT8_BATCH * 1e3 * len(v) / sum(v) for k, v in runs.items()}
    print(f"[time] stacked G1+G2 256x256 b{INT8_BATCH}, in turns: " + "; ".join(
        f"{k} {img_s[k]:.1f} img/s (" + ", ".join(f"{t:.3f}" for t in v)
        + " ms/batch)" for k, v in runs.items()))
    split = _int8_profile(engine, xs)
    tot = _int8_timings(engine, xs)
    print(f"[time] int8 phase: {time.perf_counter() - t_phase:.1f} s")

    def entry(name, t):
        return {"name": name, "route": "cuda", "source": INT8_SOURCE,
                "replaces": INT8_REPLACES[name], "launches": launches[name],
                "max_abs_err": check["max_abs_err"],
                "ms": round(t["ms"], 5), "plain_ms": round(t["plain_ms"], 5),
                "bound_ms": round(t["bound_ms"], 5),
                "bound_by": ("operations" if t["ops_ms"] >= t["bytes_ms"]
                             else "bytes"),
                "library_ms": (round(t["library_ms"], 5)
                               if name == "int8_conv"
                               and t["library_ms"] is not None else None),
                "shape": f"one int8 stacked G1+G2 forward, 256x256, batch "
                         f"{INT8_BATCH}"}

    conv = entry("int8_conv", tot["int8_conv"])
    conv.update(stacked_img_s=round(img_s["int8"], 2),
                bf16_stacked_img_s=round(img_s["bf16"], 2),
                profile=split, **{k: round(v, 3) for k, v in acc.items()})
    return {"kernels": [conv, entry("quantize_pad", tot["quantize_pad"])]}


def _direct_decoder(parts, w4, scale4=None, bias4=None, *, leaky,
                    zero_pad=False):
    """The decoder step through the kernels' launcher ``_launch``
    directly, not through the op ``srit::decoder_upsample`` (the other
    side of the op route's dispatch timing; not counted)."""
    from shadow_removal_istd_tpu_torch.ops.decoder import _check, _launch

    parts = tuple(parts)
    co = _check(parts, w4, scale4, bias4)
    return _launch(parts, w4, scale4, bias4, co, leaky, zero_pad)[0]


def _op_dispatch(engine, x_u8) -> dict:
    """The eager stacked forward with K1 through the op (the port's one
    route) beside the same forward calling ``_launch`` directly, in
    turns; then the host time of one call of each on a small step."""
    from shadow_removal_istd_tpu_torch.models import layers
    from shadow_removal_istd_tpu_torch.ops.decoder import decoder_upsample

    runs: dict = {}
    for name, fn in (("op", decoder_upsample), ("direct", _direct_decoder),
                     ("op", decoder_upsample), ("direct", _direct_decoder),
                     ("op", decoder_upsample), ("direct", _direct_decoder)):
        with mock.patch.object(layers, "decoder_upsample", fn):
            runs.setdefault(name, []).append(
                time_ms(lambda: engine._stacked(x_u8), iters=10))
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    n = x_u8.shape[0]
    cost = 100 * (ms["op"] - ms["direct"]) / ms["direct"]
    print(f"[time] K1 op dispatch, stacked G1+G2 {x_u8.shape[1]}x"
          f"{x_u8.shape[2]} b{n} bf16 eager, in turns: " + "; ".join(
              f"{k} {n * 1e3 / ms[k]:.1f} img/s (" + ", ".join(
                  f"{t:.3f}" for t in v) + " ms/batch)"
              for k, v in runs.items())
          + f"; op route costs {cost:+.2f} % of the direct call's time")
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    xs, w4, s4, b4 = step_inputs(1, 4, 4, (64,), 64, False,
                                 torch.bfloat16, gen)
    host = {}
    for name, fn in (("op", decoder_upsample), ("direct", _direct_decoder)):
        for _ in range(20):
            fn(xs, w4, s4, b4, leaky=True)
        _sync(xs[0].device)
        t0 = time.perf_counter()
        for _ in range(500):
            fn(xs, w4, s4, b4, leaky=True)
        host[name] = (time.perf_counter() - t0) / 500 * 1e6
        _sync(xs[0].device)
    print(f"[time] K1 op dispatch, host time of one call (b1 4x4 64->64 "
          f"bf16, 500 calls, enqueue only): op {host['op']:.1f} us, direct "
          f"{host['direct']:.1f} us")
    return {"op_img_s": round(n * 1e3 / ms["op"], 2),
            "direct_img_s": round(n * 1e3 / ms["direct"], 2),
            "op_cost_pct": round(cost, 3),
            "op_call_us": round(host["op"], 2),
            "direct_call_us": round(host["direct"], 2)}


def _polyfit_timing() -> dict:
    """``compute_sp_polyfit`` on one DATA_HW synthetic pair, seconds per
    image, for each (ksize, deg) of POLYFIT_CASES (host numpy)."""
    from shadow_removal_istd_tpu_torch.data.synthetic import (
        synthetic_triplets,
    )
    from shadow_removal_istd_tpu_torch.tools.preprocess import (
        apply_sp_poly,
        compute_sp_polyfit,
    )

    data = synthetic_triplets(1, *DATA_HW, seed=3)
    img, tgt = data["img"][0], data["target"][0]
    out = {}
    for ksize, deg in POLYFIT_CASES:
        t0 = time.perf_counter()
        sp = compute_sp_polyfit(img, tgt, ksize=ksize, deg=deg)
        secs = time.perf_counter() - t0
        err = np.abs(apply_sp_poly(img, sp).astype(float) - tgt).mean()
        print(f"[time] compute_sp_polyfit {DATA_HW[0]}x{DATA_HW[1]} ksize "
              f"{ksize} deg {deg}: {secs:.3f} s an image on the host "
              f"({os.cpu_count()} cores); restored mean abs error "
              f"{err:.2f} gray levels")
        if not np.isfinite(sp).all() or sp.shape != (*DATA_HW, 3, deg + 1):
            raise SystemExit("compute_sp_polyfit: wrong or non-finite sp")
        out[f"k{ksize}_deg{deg}_s"] = round(secs, 3)
    return out


def phase_export() -> dict:
    """Serving export on the card (see the module docstring, phase 14);
    returns K1's launches over the artifacts' forwards and the
    readings."""
    from shadow_removal_istd_tpu_torch.engine.steps import infer_step
    from shadow_removal_istd_tpu_torch.ops.decoder import decoder_upsample
    from shadow_removal_istd_tpu_torch.serving import (
        ArtifactEngine,
        InferenceEngine,
    )
    from shadow_removal_istd_tpu_torch.tools.export import (
        export_stacked_inference,
    )
    from shadow_removal_istd_tpu_torch.utils.image_io import imdecode_color

    t_phase = time.perf_counter()
    root = SMOKE_DIR / "export"
    root.mkdir(exist_ok=True)
    n, (h, w) = EXPORT_BATCH, EXPORT_HW
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    engines = {k: InferenceEngine("mnet", ngf=NGF, dtype=k, split_skip=True,
                                  max_batch=n, seed=0, device=DEVICE)
               for k in dtypes}
    specs = ((f"bf16 b{n}", "bfloat16", EXPORT_HW, n),
             ("bf16 symbolic", "bfloat16", EXPORT_HW, None),
             (f"f32 b{n}", "float32", EXPORT_HW, n),
             ("bf16 symbolic", "bfloat16", EXPORT_SERVE_HW, None))
    paths = {}
    for label, dt, hw, b in specs:
        key = f"{label} {hw[0]}x{hw[1]}"
        paths[key] = root / (key.replace(" ", "_") + ".pt2")
        t0 = time.perf_counter()
        nbytes = export_stacked_inference(
            str(paths[key]), None, engines[dt], image_shape=hw,
            batch_size=b, dtype=dtypes[dt])
        print(f"[export] ngf {NGF} split-skip MNet pair {key}: exported "
              f"in {time.perf_counter() - t0:.1f} s, {nbytes / 1e6:.1f} MB")

    gen = torch.Generator(device=DEVICE).manual_seed(15)
    x_u8 = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8,
                         device=DEVICE, generator=gen)
    rng = np.random.default_rng(15)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(min(4, n))]
    launches, arts, worst = 0, {}, {}
    for label, dt, hw, _ in specs[:3]:
        key = f"{label} {hw[0]}x{hw[1]}"
        t0 = time.perf_counter()
        art = arts[key] = ArtifactEngine(str(paths[key]), max_batch=n,
                                         device=DEVICE)
        art._stacked(x_u8)
        _sync(DEVICE)
        load_s = time.perf_counter() - t0
        reset_decoder_counts()
        art._stacked(x_u8)
        _sync(DEVICE)
        by_variant = dict(decoder_upsample.launches_by_variant)
        launches += decoder_upsample.launches
        want = ({"tensor_core": 8, "cuda_core": 0, "narrow": 2}
                if dt == "bfloat16" else
                {"tensor_core": 0, "cuda_core": 8, "narrow": 2})
        eng = engines[dt]
        x = x_u8.float() * (2.0 / 255.0) - 1.0
        with torch.inference_mode():
            m, y = art._fn(x.to(dtypes[dt]))
            me, ye = infer_step(eng.g1, eng.g2, x.permute(0, 3, 1, 2))
        err = max((m.float() - me.permute(0, 2, 3, 1).float()).abs().max()
                  .item(), (y.float() - ye.permute(0, 2, 3, 1).float())
                  .abs().max().item())
        worst[dt] = max(worst.get(dt, 0.0), err)
        got, ref = art.infer_group(imgs), eng.infer_group(imgs)
        diff = max(int(np.abs(g.astype(np.int16) - r).max())
                   for gp, rp in zip(got, ref) for g, r in zip(gp, rp))
        tol = TOL[dtypes[dt]]
        print(f"[export] artifact {key} (input {art.dtype}, batch "
              f"{art.fixed_batch or 'symbolic'}): loaded and first forward "
              f"{load_s:.1f} s; K1 launches a forward {by_variant}; max abs "
              f"vs eager infer_step {err:.3e} (tol {tol:.0e}); uint8 vs "
              f"InferenceEngine, {len(imgs)} images: max diff {diff} gray levels "
              f"(limit 2)")
        if by_variant != want:
            raise SystemExit(f"export: artifact {key} launched K1 "
                             f"{by_variant}, expected {want}")
        if err > tol or diff > 2:
            raise SystemExit(f"export: artifact {key} disagrees with the "
                             f"eager engine")

    # throughput, the pinned bf16 artifact and the eager engine in turns
    art, eng = arts[f"bf16 b{n} {h}x{w}"], engines["bfloat16"]
    runs: dict = {}
    for name, e in (("artifact", art), ("engine", eng), ("artifact", art),
                    ("engine", eng)):
        runs.setdefault(name, []).append(
            time_ms(lambda: e._stacked(x_u8), iters=10))
    img_s = {k: n * 1e3 * len(v) / sum(v) for k, v in runs.items()}
    print(f"[time] artifact stacked {h}x{w} b{n} bf16, in turns: "
          + "; ".join(f"{k} {img_s[k]:.1f} img/s (" + ", ".join(
              f"{t:.3f}" for t in v) + " ms/batch)" for k, v in runs.items()))
    dispatch = _op_dispatch(eng, x_u8)
    del arts, art, x_u8

    # 480x640: a larger image refused; the daemon answers and refuses a
    # reload
    key = f"bf16 symbolic {EXPORT_SERVE_HW[0]}x{EXPORT_SERVE_HW[1]}"
    big = ArtifactEngine(str(paths[key]), max_batch=4, device=DEVICE)
    sh, sw = EXPORT_SERVE_HW
    try:
        big.bucket_of(sh + 32, sw)
        raise SystemExit(f"export: a {sh + 32}x{sw} image was not refused")
    except ValueError as exc:
        print(f"[export] artifact {key}: a {sh + 32}x{sw} image refused "
              f"({exc})")
    img = rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
    (_, want), = big.infer_group([img])
    status, body, rc, stats, secs = _daemon_answer(
        ["--artifact", str(paths[key]), "--max-batch", "1"], img, "export",
        reload=True)
    got = imdecode_color(body) if status == 200 else None
    diff = (int(np.abs(got.astype(int) - want).max())
            if got is not None and got.shape == want.shape else -1)
    print(f"[export] serving daemon --artifact ({key}): HTTP {status}, "
          f"reload HTTP {stats.get('reload_status')}, exit {rc}, "
          f"{secs:.1f} s with start-up; max diff {diff} gray levels from "
          f"this process's ArtifactEngine (limit 2)")
    if (status != 200 or rc != 0 or stats.get("reload_status") != 501
            or not 0 <= diff <= 2):
        raise SystemExit("export: the --artifact daemon's answer is wrong")
    del big, engines
    torch.cuda.empty_cache()
    polyfit = _polyfit_timing()
    shutil.rmtree(root, ignore_errors=True)
    print(f"[time] export phase: {time.perf_counter() - t_phase:.1f} s")
    return {"decoder": launches, "max_abs_err": worst,
            "artifact_img_s": round(img_s["artifact"], 2),
            "engine_img_s": round(img_s["engine"], 2),
            "dispatch": dispatch, "polyfit": polyfit}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _par_trainer(spec: dict, mesh=None):
    """The parallel phase's trainer (``spec``: its sizes, configuration
    and devices), on ``mesh`` or, without one, on one device."""
    from shadow_removal_istd_tpu_torch.data.synthetic import (
        synthetic_triplets,
    )
    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
    from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer

    files = Path(spec["dir"]) / ("single" if mesh is None
                                 else f"rank{mesh.rank}")
    h, w = spec["hw"]
    run = RunConfig(seed=0, valid_every=1, vgg_weights=spec["vgg"],
                    device_cache=True, weights_dir=str(files),
                    logs_dir=str(files),
                    checkpoint_path=str(files / "checkpoint.msgpack"))
    return Trainer(TrainConfig(**spec["cfg"]), run,
                   train_streams=synthetic_triplets(spec["n_train"], h, w,
                                                    seed=7),
                   valid_streams=synthetic_triplets(spec["n_valid"], h, w,
                                                    seed=8),
                   device=spec["devices"][0], mesh=mesh)


def _par_state(trainer) -> dict:
    return {k: v.detach().float().cpu().clone()
            for k, v in _state_leaves(trainer.state).items()}


def _par_copy(state):
    """A deep copy of a train state sharing its mesh (a process group
    does not copy)."""
    import copy

    mesh, state.mesh = state.mesh, None
    try:
        out = copy.deepcopy(state)
    finally:
        state.mesh = mesh
    out.mesh = mesh
    return out


def _par_epochs(trainer, epochs=(0, 1), loop: bool = True) -> dict:
    """``epochs`` (one step each, each validated), through
    ``Trainer.train`` (``loop``) or its epochs alone (no image logs or
    saves): the state before the first, after each step, and every
    metric."""
    out = {"metrics": {}, "state0": _par_state(trainer)}
    for epoch in epochs:
        if loop:
            trainer.start_epoch = epoch
            trainer.train(epoch + 1)
        else:
            trainer.run_train_epoch(epoch)
            trainer.run_valid_epoch(epoch)
        _sync(trainer.device)
        out[f"state{epoch + 1}"] = _par_state(trainer)
        out["metrics"].update(
            {f"train{epoch + 1} {k}": v
             for k, v in trainer.history[-1].items()})
        out["metrics"].update({f"valid{epoch + 1} {k}": v
                               for k, v in trainer.last_valid.items()})
    return out


@contextlib.contextmanager
def _par_planted(name: str):
    """The enclosed steps with ``name`` planted: an order of PAR_ORDERS,
    no fault: the batch and its dropout masks in that order (the same
    function, every batch reduction in another order); the data-parallel
    faults ``bn_local`` (BatchNorm on the rank's slice alone),
    ``bn_backward_local`` (the global statistics, their gradient not
    summed over the ranks) and ``rank_grad_dropped`` (the last rank's
    parameter gradients zeroed before the sum)."""
    from unittest import mock

    from shadow_removal_istd_tpu_torch.engine import epoch, steps
    from shadow_removal_istd_tpu_torch.models import layers
    from shadow_removal_istd_tpu_torch.parallel.mesh import sum_across

    order = {"rolled by 1": lambda t: t.roll(1, 0),
             "rolled by -1": lambda t: t.roll(-1, 0),
             "rolled by half": lambda t: t.roll(t.shape[0] // 2, 0),
             "reversed": lambda t: t.flip(0),
             "halves reversed": lambda t: t.flip(0).roll(t.shape[0] // 2,
                                                         0),
             "odd rows first": lambda t: torch.cat([t[1::2], t[0::2]]),
             }.get(name)
    step, rand, reduce = (epoch.train_step, layers.global_rand,
                          steps.all_reduce_grads)

    def dropped(params, mesh):
        if mesh is not None and mesh.rank == mesh.world - 1:
            for p in params:
                if p.grad is not None:
                    p.grad.zero_()
        reduce(params, mesh)

    if order is not None:
        patches = [(epoch, "train_step", lambda state, batch, gens: step(
                        state, tuple(order(t) for t in batch), gens)),
                   (layers, "global_rand", lambda *a: order(rand(*a)))]
    else:
        patches = {
            "bn_local": [(layers, "active_mesh", lambda: None)],
            "bn_backward_local": [(layers, "all_reduce_sum",
                                   lambda t, mesh: t + (sum_across(
                                       t.detach(), mesh) - t.detach()))],
            "rank_grad_dropped": [(steps, "all_reduce_grads", dropped)],
        }[name]
    with contextlib.ExitStack() as stack:
        for module, attr, fn in patches:
            stack.enter_context(mock.patch.object(module, attr, fn))
        yield


def _par_run(trainer, mesh=None) -> dict:
    """Epochs 0 and 1 with the launches counted from 0, then 2 more
    steps timed; then from the starting state again: in one process
    (``mesh`` None) both epochs in each order of PAR_ORDERS, on a rank
    epoch 0's step with each fault of PAR_FAULTS planted (see
    :func:`_par_planted`)."""
    from shadow_removal_istd_tpu_torch.ops.decoder import decoder_upsample
    from shadow_removal_istd_tpu_torch.ops.shear import hshear
    from shadow_removal_istd_tpu_torch.parallel.mesh import barrier

    start = _par_copy(trainer.state)
    hshear.launches = 0
    reset_decoder_counts()
    out = _par_epochs(trainer)
    out["hshear"] = hshear.launches
    out["decoder"] = dict(decoder_upsample.launches_by_variant)
    barrier(mesh)
    t0 = time.perf_counter()
    for epoch in (2, 3):
        trainer.run_train_epoch(epoch)
    _sync(trainer.device)
    barrier(mesh)
    out["steps_s"] = time.perf_counter() - t0
    for name in PAR_ORDERS if mesh is None else PAR_FAULTS:
        trainer.state, trainer.best_loss = _par_copy(start), float("inf")
        with _par_planted(name):
            if mesh is None:
                out[name] = _par_epochs(trainer, loop=False)
            else:
                trainer.run_train_epoch(0)
                out[name] = {"state1": _par_state(trainer)}
    return out


def _par_rank(local: int, world: int, init: str, spec: dict) -> None:
    """One rank of the parallel phase's data-parallel run (a spawned
    process): joins the group, runs :func:`_par_run`, saves its result."""
    import datetime

    from shadow_removal_istd_tpu_torch.parallel.mesh import (
        barrier,
        distributed_init,
        make_mesh,
    )

    torch.backends.cudnn.deterministic = True
    timeout = datetime.timedelta(seconds=300)
    distributed_init(init, world, local, timeout=timeout)
    mesh = make_mesh(spec["devices"][local], timeout=timeout)
    try:
        out = _par_run(_par_trainer(spec, mesh), mesh)
        out["backend"] = mesh.backend
        torch.save(out, Path(spec["dir"]) / f"rank{local}.pt")
    finally:
        barrier(mesh)
        torch.distributed.destroy_process_group()


def _par_read(ref: dict, other: dict, after: str) -> tuple[dict, dict]:
    """Each leaf of ``other``'s state ``after`` a step against ``ref``'s:
    its largest difference over the leaf's own change from ``ref``'s
    start (at least PAR_FLOOR of the largest change of its kind; Adam's
    moments start at 0). Returns the largest reading of each kind
    (``adam_g m``: G's first moments) and the leaf it was read on."""
    change: dict = {}
    diff: dict = {}
    for key, r in ref[after].items():
        kind = key.split()[0]
        if kind.startswith("adam"):
            if key.endswith(".step"):
                if not torch.equal(r, other[after][key]):
                    raise SystemExit(f"parallel: Adam step {key} differs")
                continue
            kind += " m" if key.endswith("exp_avg") else " v"
        r0 = ref["state0"].get(key, torch.zeros_like(r))
        change[key] = (kind, float((r - r0).abs().max()))
        diff[key] = float((other[after][key] - r).abs().max())
    largest: dict = {}
    for kind, c in change.values():
        largest[kind] = max(largest.get(kind, 0.0), c)
    worst: dict = {}
    where: dict = {}
    for key, (kind, c) in change.items():
        v = diff[key] / max(c, PAR_FLOOR * largest[kind], 1e-30)
        if v >= worst.get(kind, 0.0):
            worst[kind], where[kind] = v, key
    return worst, where


def _par_metrics(ref: dict, other: dict) -> float:
    """The largest difference of ``other``'s metrics from ``ref``'s,
    relative to the larger of the value and 1."""
    return max(abs(v - ref["metrics"][k]) / max(abs(ref["metrics"][k]), 1.0)
               for k, v in other["metrics"].items())


def _par_limits(single: dict) -> tuple[dict, dict, dict, float]:
    """The single run's readings in each order of PAR_ORDERS after each
    step, their largest per kind (the spread), the limit each kind is
    held to (the larger of PAR_REL_TOL and PAR_SPREAD_K x the spread),
    and the metrics' limit."""
    steps = ("state1", "state2")
    orders = {o: {s: _par_read(single, single[o], s)[0] for s in steps}
              for o in PAR_ORDERS}
    spread = {s: {k: max(orders[o][s][k] for o in PAR_ORDERS)
                  for k in orders[PAR_ORDERS[0]][s]} for s in steps}
    m_spread = max(_par_metrics(single, single[o]) for o in PAR_ORDERS)
    limit = {s: {k: max(PAR_REL_TOL, PAR_SPREAD_K * v)
                 for k, v in spread[s].items()} for s in steps}
    return orders, spread, limit, max(PAR_REL_TOL, PAR_SPREAD_K * m_spread)


def _par_hold(single: dict, ranks: list) -> dict:
    """DP against the single run, within the limit that the single run's
    own reduction-order spread (PAR_ORDERS) sets; every planted fault
    beyond it. Returns the readings."""
    def line(w):
        return ", ".join(f"{k} {v:.3e}" for k, v in w.items())

    steps = ("state1", "state2")
    orders, spread, limit, m_limit = _par_limits(single)
    dp = {s: _par_read(single, ranks[0], s) for s in steps}
    m_dp = _par_metrics(single, ranks[0])
    print(f"[parallel] reading: each state leaf's largest |difference| "
          f"from the single run over the leaf's own change from the "
          f"start (at least {PAR_FLOOR} of its kind's largest change), the "
          f"largest per kind; metrics relative to max(|value|, 1)")
    for o in PAR_ORDERS:
        print(f"[parallel] reduction order: the single run again on its "
              f"batch and dropout masks {o} (the same shapes and "
              f"deterministic cuDNN algorithms): after step 1: "
              f"{line(orders[o]['state1'])}; after step 2: "
              f"{line(orders[o]['state2'])}; metrics "
              f"{_par_metrics(single, single[o]):.3e}")
    for s in steps:
        print(f"[parallel] DP - single after {s}: {line(dp[s][0])} "
              f"(largest at {dp[s][1]})")
    print(f"[parallel] DP - single metrics (both steps and validations) "
          f"{m_dp:.3e}")
    print(f"[parallel] held: each kind within max({PAR_REL_TOL}, "
          f"{PAR_SPREAD_K} x its largest reading in the {len(PAR_ORDERS)} "
          f"orders): after step 1 "
          f"{line(limit['state1'])}; after step 2 {line(limit['state2'])}; "
          f"metrics {m_limit:.3e}")
    bad = [f"{k} after {s}" for s in steps for k, v in dp[s][0].items()
           if v > limit[s][k]]
    bad += ["metrics"] if m_dp > m_limit else []
    faults = {}
    for name in PAR_FAULTS:
        read, where = _par_read(single, ranks[0][name], "state1")
        over = {k: v / limit["state1"][k] for k, v in read.items()}
        faults[name] = max(over.values())
        print(f"[parallel] planted fault {name}, after step 1: "
              f"{line(read)}; the largest {faults[name]:.1f} x its limit "
              f"(at {where[max(over, key=over.get)]}; seen: "
              f"{faults[name] > 1})")
    if bad:
        raise SystemExit(f"parallel: DP differs from single beyond the "
                         f"limit in {bad}")
    unseen = [n for n, v in faults.items() if v <= 1]
    if unseen:
        raise SystemExit(f"parallel: the DP check does not see the planted "
                         f"faults {unseen}")
    return {"dp": {s: dp[s][0] for s in steps}, "metrics": m_dp,
            "spread": spread, "faults_x_limit": faults}


def _par_cli(vgg_path: Path, root: Path) -> dict:
    """Two ``cli.main`` processes joined by ``--coordinator``: identical
    validation lines, rank 0's files only."""
    import re
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    istd = SMOKE_DIR / "cli" / "istd"
    batch = min(8, TRAIN_KW.get("batch_size", 8))
    # the card's CLI defaults but the batch; a CPU rehearsal's widths
    flags = ["--batch-size", str(batch), "--image-size", str(CROP),
             "--ngf", str(NGF), "--ndf", str(TRAIN_KW.get("ndf", NGF))]
    flags += [] if DEVICE == "cuda" else ["--devices", DEVICE]
    t0 = time.perf_counter()
    procs = [_cli_subprocess(
        ["--tasks", "train", "--data-dir", str(istd), "--epochs", "1",
         "--vgg-weights", str(vgg_path),
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i), "--weights", str(root / f"cli_w{i}"),
         "--logs", str(root / f"cli_l{i}"),
         "--infered", str(root / f"cli_out{i}"), *flags], env)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wall = time.perf_counter() - t0
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise SystemExit(f"parallel: CLI process {i} exited "
                             f"{p.returncode}:\n{out[-3000:]}")
    lines = [re.findall(r"valid epoch \d+: .*", out) for out in outs]
    suffix = "_lr0.00050_SGAN"
    files = [sorted(str(f.relative_to(root / f"cli_w{i}{suffix}"))
                    for f in (root / f"cli_w{i}{suffix}").rglob("*")
                    if f.is_file()) for i in range(2)]
    events = [sorted(str(f) for f in (root / f"cli_l{i}{suffix}").rglob(
        "events.out.tfevents.*")) for i in range(2)]
    print(f"[parallel] cli: 2 processes (--coordinator 127.0.0.1:{port} "
          f"--num-processes 2, --devices {DEVICE} each) trained 1 epoch "
          f"({CLI_TRAIN} + {CLI_TEST} triplets, batch {batch}) in "
          f"{wall:.1f} s "
          f"wall; validation lines {lines[0]} and {lines[1]}; rank 0 "
          f"wrote {len(files[0])} files (checkpoint "
          f"{'checkpoint.msgpack' in files[0]}), rank 1 {len(files[1])}; "
          f"event files {len(events[0])} and {len(events[1])}")
    if not lines[0] or lines[0] != lines[1]:
        raise SystemExit("parallel: the two CLI processes logged different "
                         "validation lines")
    if "checkpoint.msgpack" not in files[0] or files[1] or not events[0] \
            or events[1]:
        raise SystemExit("parallel: files not written by rank 0 alone: "
                         f"{files}, {events}")
    return {"wall_s": wall}


def _par_pipeline(n_cards: int) -> dict:
    """``StackedPipeline`` at DATA_HW, batch PIPE_BATCH, bf16 beside the
    fused forward: bit-identical outputs, K1's launches, a stream of
    PIPE_STREAM batches in order, the times in turns."""
    from shadow_removal_istd_tpu_torch.engine.steps import infer_step
    from shadow_removal_istd_tpu_torch.ops.decoder import decoder_upsample
    from shadow_removal_istd_tpu_torch.parallel.pipeline import (
        StackedPipeline,
    )
    from shadow_removal_istd_tpu_torch.serving import InferenceEngine

    dev = torch.device(DEVICE, 0) if DEVICE == "cuda" else \
        torch.device("cpu")
    eng = InferenceEngine(ngf=NGF, dtype="bfloat16", device=dev, seed=3)
    g1, g2 = eng.g1, eng.g2
    stages = ([dev, torch.device("cuda", 1)] if n_cards >= 2
              else [dev, dev])
    gen = torch.Generator(device=dev).manual_seed(5)
    xs = [torch.rand((PIPE_BATCH, 3, *DATA_HW), generator=gen, device=dev)
          * 2 - 1 for _ in range(PIPE_STREAM)]
    pipe = StackedPipeline(g1, g2, stages)
    with torch.inference_mode():
        refs = [infer_step(g1, g2, x) for x in xs]
        _sync(dev)
        reset_decoder_counts()
        m, y = pipe(xs[0])
        for d in stages:
            _sync(d)
        by_variant = dict(decoder_upsample.launches_by_variant)
        same = [torch.equal(m.to(dev), refs[0][0])
                and torch.equal(y.to(dev), refs[0][1])]
        outs = list(pipe.stream(iter(xs)))
        same += [torch.equal(a.to(dev), ra) and torch.equal(b.to(dev), rb)
                 for (a, b), (ra, rb) in zip(outs, refs)]

        def fused():
            for x in xs:
                infer_step(g1, g2, x)
            _sync(dev)

        def piped():
            for _ in pipe.stream(iter(xs)):
                pass
            for d in stages:
                _sync(d)

        times = {"fused": [], "pipeline": []}
        for name, fn in (("fused", fused), ("pipeline", piped),
                         ("pipeline", piped), ("fused", fused)):
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3
                               / PIPE_STREAM)
    want = {"tensor_core": 8, "narrow": 2, "cuda_core": 0}
    where = (f"stage A {stages[0]}, stage B {stages[1]}"
             + ("" if n_cards >= 2 else " (one card: two streams)"))
    print(f"[parallel] pipeline {where}, {DATA_HW[0]}x{DATA_HW[1]} "
          f"b{PIPE_BATCH} bf16 ngf {NGF}: one batch launched K1 "
          f"{by_variant} (want {want}); bit-identical to the fused "
          f"infer_step: {all(same)} (1 call + a stream of {len(outs)} "
          f"batches, in order)")
    print(f"[time] pipeline vs fused, {PIPE_STREAM} batches in turns "
          f"(fused, pipeline, pipeline, fused; host clock around "
          f"synchronize): fused {times['fused'][0]:.3f} / "
          f"{times['fused'][1]:.3f} ms a batch, pipeline "
          f"{times['pipeline'][0]:.3f} / {times['pipeline'][1]:.3f}")
    if DEVICE == "cuda" and by_variant != want:
        raise SystemExit(f"parallel: pipeline launched {by_variant}")
    if not all(same) or len(outs) != PIPE_STREAM:
        raise SystemExit("parallel: the pipeline differs from the fused "
                         "forward")
    return {"by_variant": by_variant, "ms": times}


def _par_serving(n_cards: int) -> dict:
    """``InferenceEngine(devices=2)`` (two replicas on one card where
    there is one) answers as the one-device engine does, each replica's
    forward through K1 (8 tensor-core + 2 narrow launches). Returns the
    launches of the two replicas' forwards."""
    from shadow_removal_istd_tpu_torch.ops.decoder import decoder_upsample
    from shadow_removal_istd_tpu_torch.serving import InferenceEngine

    dev = torch.device(DEVICE, 0) if DEVICE == "cuda" else \
        torch.device("cpu")
    devices = 2 if n_cards >= 2 else [dev, dev]
    one = InferenceEngine(ngf=NGF, dtype="bfloat16", device=dev, seed=3)
    many = InferenceEngine(ngf=NGF, dtype="bfloat16", device=dev, seed=3,
                           devices=devices)
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, (*DATA_HW, 3), dtype=np.uint8)
            for _ in range(4)]
    reset_decoder_counts()
    got = many.infer_group(imgs)
    by_variant = dict(decoder_upsample.launches_by_variant)
    want_out = one.infer_group(imgs)
    same = all(np.array_equal(a, b) for ga, wa in zip(got, want_out)
               for a, b in zip(ga, wa))
    r = len(many.devices)
    want = {"tensor_core": 8 * r, "narrow": 2 * r, "cuda_core": 0}
    print(f"[parallel] serving: InferenceEngine(devices="
          f"{[str(d) for d in many.devices]}) on 4 {DATA_HW[0]}x"
          f"{DATA_HW[1]} images equals the one-device engine: {same}; "
          f"its {r} replicas' forwards launched K1 {by_variant} (want "
          f"{want})")
    if not same:
        raise SystemExit("parallel: multi-device serving differs")
    if DEVICE == "cuda" and by_variant != want:
        raise SystemExit(f"parallel: the serving replicas launched "
                         f"{by_variant}")
    return by_variant


def phase_parallel(vgg_path: Path) -> dict:
    """Data parallelism, the two-process CLI, pipeline inference and
    multi-device serving (see the module docstring, phase 15). Returns
    each rank's launches and the pipeline's."""
    import torch.multiprocessing as mp

    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig

    t_phase = time.perf_counter()
    root = (SMOKE_DIR / "parallel").resolve()
    root.mkdir(parents=True, exist_ok=True)
    n_cards = torch.cuda.device_count() if DEVICE == "cuda" else 0
    world = max(n_cards, 2)
    if n_cards >= 2:
        devices = [f"cuda:{i}" for i in range(world)]
        how = f"NCCL, one card each of {n_cards}"
    else:
        devices = ["cuda:0" if DEVICE == "cuda" else "cpu"] * 2
        how = ("gloo, 2 ranks sharing the one card: this shows "
               "correctness and overhead, no scaling")
    print(f"[parallel] {world} data-parallel ranks on {devices} ({how}); "
          f"card: {nvidia_smi() if DEVICE == 'cuda' else 'none'}")
    spec = {"dir": str(root), "hw": tuple(DATA_HW), "n_train": PAR_TRAIN,
            "n_valid": PAR_VALID, "vgg": str(vgg_path.resolve()),
            "devices": devices,
            "cfg": dict(aug_method="shear", adam_eps=PAR_ADAM_EPS,
                        **TRAIN_KW)}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        single = _par_run(_par_trainer(spec))
        t_single = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = prev
    t0 = time.perf_counter()
    mp.start_processes(_par_rank, args=(world, f"file://{root}/rendezvous",
                                        spec),
                       nprocs=world, start_method="spawn")
    t_dp = time.perf_counter() - t0
    ranks = [torch.load(root / f"rank{r}.pt") for r in range(world)]
    # every rank the same state, from the single run's starting state
    identical = all(torch.equal(r[s][k], ranks[0][s][k])
                    for r in ranks[1:] for s in ("state0", "state1", "state2")
                    for k in ranks[0][s])
    identical &= all(torch.equal(ranks[0]["state0"][k], v)
                     for k, v in single["state0"].items())
    identical &= all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    batch = TrainConfig(**spec["cfg"]).batch_size
    n_fwd_valid = -(-PAR_VALID // batch)
    print(f"[parallel] DP train: {world} ranks x {batch // world} of a "
          f"global batch {batch}, 2 epochs of 1 step, each validated at "
          f"{DATA_HW[0]}x{DATA_HW[1]} ({world} x {PAR_VALID // world}), "
          f"backend {ranks[0]['backend']}, deterministic cuDNN, Adam eps "
          f"{PAR_ADAM_EPS}; single process {t_single:.1f} s, {world} "
          f"ranks {t_dp:.1f} s wall (process start, kernel loads, data "
          f"and the planted runs included); every rank's state identical "
          f"and started from the single run's: {identical}")
    for r, out in enumerate(ranks):
        print(f"[parallel] rank {r}: hshear {out['hshear']}, K1 "
              f"{out['decoder']}")
    img_s = {"single": 2 * batch / single["steps_s"],
             "dp": 2 * batch / max(r["steps_s"] for r in ranks)}
    print(f"[time] parallel train, 2 steps of {batch} ({CROP}x{CROP} f32, "
          f"host clock around synchronize and a barrier): single "
          f"{img_s['single']:.1f} img/s, {world} ranks "
          f"{img_s['dp']:.1f} img/s"
          + ("" if n_cards >= 2 else " (one card shared: no scaling)"))
    if not identical:
        raise SystemExit("parallel: the ranks' states differ")
    held = _par_hold(single, ranks)
    if DEVICE == "cuda":
        for r, out in enumerate(ranks):
            # 2 validations; rank 0 also logs the images of epoch 0's
            # training batch (3 hshear) and of each validation
            fwd = 2 * n_fwd_valid + (3 if r == 0 else 0)
            want = {"cuda_core": 8 * fwd, "narrow": 2 * fwd,
                    "tensor_core": 0}
            if out["hshear"] != 3 * 2 + (3 if r == 0 else 0) or \
                    out["decoder"] != want:
                raise SystemExit(f"parallel: rank {r} launched hshear "
                                 f"{out['hshear']}, K1 {out['decoder']}")
    cli = _par_cli(vgg_path.resolve(), root)
    pipe = _par_pipeline(n_cards)
    serving = _par_serving(n_cards)
    print(f"[time] parallel phase {time.perf_counter() - t_phase:.1f} s")
    return {"hshear": [r["hshear"] for r in ranks],
            "decoder": [r["decoder"] for r in ranks], "single": single,
            "spec": spec,
            "pipeline": pipe["by_variant"], "serving": serving,
            "img_s": img_s, "cli_s": cli["wall_s"],
            "pipeline_ms": pipe["ms"], "faults_x_limit":
            held["faults_x_limit"]}


@contextlib.contextmanager
def _shard_planted(name: str | None):
    """A backward fault of the column-parallel pair planted in the
    enclosed steps: ``no_reduce``, the identity before a split conv
    passes its partial input gradient on unsummed; ``gather_sums``, the
    channel gather's backward sums the gradient over the model ranks
    before keeping its slice."""
    if name is None:
        yield
        return
    from shadow_removal_istd_tpu_torch.parallel import tensor

    cls = (tensor._CopyToModel if name == "no_reduce"
           else tensor._GatherChannels)
    old = cls.backward

    def no_reduce(ctx, grad):
        return grad, None

    def gather_sums(ctx, grad):
        grad = grad.contiguous()
        torch.distributed.all_reduce(grad,
                                     group=tensor._active.groups["model"])
        return old(ctx, grad)

    cls.backward = staticmethod(no_reduce if name == "no_reduce"
                                else gather_sums)
    try:
        yield
    finally:
        cls.backward = staticmethod(old)


def _shard_engine(dtype: str, device, ngf: int):
    """The serving engine's split-skip MNet pair (seeded)."""
    from shadow_removal_istd_tpu_torch.serving import InferenceEngine

    eng = InferenceEngine(ngf=ngf, dtype=dtype, device=device, seed=3)
    return eng.g1, eng.g2


def _shard_input(hw, batch: int, device, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((batch, 3, *hw), generator=gen, device=device) * 2 - 1


def _shard_3d_state(device, ngf: int):
    """The composed mesh's state: the nearest-decoder MNet pair and
    PatchGANs at ``ngf``, f32, seeded."""
    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
    from shadow_removal_istd_tpu_torch.engine.state import init_state

    cfg = TrainConfig(ngf=ngf, ndf=ngf, nn_upconv=True, droprate=0.0)
    return init_state(cfg, torch.Generator().manual_seed(4), device)


def _shard_time(fn, device, mesh, iters: int) -> float:
    """ms a call of ``fn`` over ``iters`` calls after one, on the host
    clock around synchronize (and a barrier over ``mesh``)."""
    from shadow_removal_istd_tpu_torch.parallel.mesh import barrier

    fn()
    _sync(device)
    barrier(mesh)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    barrier(mesh)
    return (time.perf_counter() - t0) * 1e3 / iters


def _shard_counted(fn) -> tuple:
    """``fn()`` with the decoder's and the row gathers' counts from 0:
    its result, K1's launches by variant, the gathers."""
    from shadow_removal_istd_tpu_torch.ops.decoder import decoder_upsample
    from shadow_removal_istd_tpu_torch.parallel import spatial

    reset_decoder_counts()
    spatial.gather_rows.count = 0
    out = fn()
    return (out, dict(decoder_upsample.launches_by_variant),
            spatial.gather_rows.count)


def _shard_state_bytes(state) -> int:
    """Bytes of the networks' parameters and statistics and of Adam's
    moments (not its step counts)."""
    return sum(v.numel() * v.element_size()
               for k, v in _state_leaves(state).items()
               if not k.endswith(".step"))


def _shard_full_state(trainer, mesh) -> dict:
    """The trainer's state gathered to full over the model axis (every
    rank takes part), as ``_par_state`` reads it; split again after."""
    from shadow_removal_istd_tpu_torch.parallel.mesh import (
        shard_state,
        unshard_state,
    )

    unshard_state(mesh, trainer.state)
    try:
        return _par_state(trainer)
    finally:
        shard_state(mesh, trainer.state)


def _shard_rank(local: int, world: int, init: str, spec: dict) -> None:
    """One rank of the shard phase (a spawned process): on 2 ranks the
    spatial forwards and the TP step, on 4 the composed mesh's forward;
    saves what the phase reads."""
    import datetime

    from shadow_removal_istd_tpu_torch.engine.steps import infer_step
    from shadow_removal_istd_tpu_torch.ops.shear import hshear
    from shadow_removal_istd_tpu_torch.parallel.mesh import (
        barrier,
        distributed_init,
        make_mesh_2d,
        make_mesh_3d,
        make_mesh_tp,
        shard_images,
        shard_state,
    )

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    timeout = datetime.timedelta(seconds=600)
    distributed_init(init, world, local, timeout=timeout)
    dev = torch.device(spec["devices"][local])
    sh = spec["shard"]
    out: dict = {}
    mesh = None
    try:
        if world == 2:
            mesh = make_mesh_2d(1, 2, dev, timeout=timeout)
            out["backend"] = mesh.backend
            for dtype in ("bfloat16", "float32"):
                g1, g2 = _shard_engine(dtype, dev, sh["ngf"])
                x = shard_images(mesh, _shard_input(sh["hw"], 1, dev, 11))
                with torch.no_grad():
                    (m, y), k1, gathers = _shard_counted(
                        lambda: infer_step(g1, g2, x, mesh))
                    ms = _shard_time(lambda: infer_step(g1, g2, x, mesh),
                                     dev, mesh, sh["iters"])
                out[dtype] = {"m": m.float().cpu(), "y": y.float().cpu(),
                              "k1": k1, "gathers": gathers, "ms": ms}
                del g1, g2
            tp = make_mesh_tp(1, 2, dev, timeout=timeout)
            trainer = _par_trainer(spec, tp)
            start = _par_copy(trainer.state)
            res = {"state0": _shard_full_state(trainer, tp)}
            hshear.launches = 0
            _, k1, _ = _shard_counted(lambda: trainer.run_train_epoch(0))
            _sync(dev)
            res.update(hshear=hshear.launches, decoder=k1,
                       bytes=_shard_state_bytes(trainer.state),
                       state1=_shard_full_state(trainer, tp),
                       metrics={f"train1 {k}": v for k, v in
                                trainer.history[-1].items()})
            barrier(tp)
            t0 = time.perf_counter()
            for epoch in (2, 3):
                trainer.run_train_epoch(epoch)
            _sync(dev)
            barrier(tp)
            res["steps_s"] = time.perf_counter() - t0
            for name in SHARD_FAULTS:
                trainer.state = _par_copy(start)
                with _shard_planted(name):
                    trainer.run_train_epoch(0)
                res[name] = {"state1": _shard_full_state(trainer, tp)}
            out["tp"] = res
            mesh = tp
        else:
            mesh = make_mesh_3d(1, 2, 2, dev, timeout=timeout)
            out["backend"] = mesh.backend
            state = _shard_3d_state(dev, sh["ngf"])
            shard_state(mesh, state)
            g1, g2 = state.models.g1, state.models.g2
            g1.eval()
            g2.eval()
            x = shard_images(mesh, _shard_input(sh["hw3"], 2, dev, 12))
            with torch.no_grad():
                (m, y), k1, gathers = _shard_counted(
                    lambda: infer_step(g1, g2, x, mesh))
                ms = _shard_time(lambda: infer_step(g1, g2, x, mesh), dev,
                                 mesh, 3)
            out["3d"] = {"m": m.cpu(), "y": y.cpu(), "k1": k1,
                         "gathers": gathers, "ms": ms,
                         "coord": (mesh.coord("spatial"),
                                   mesh.coord("model"))}
        torch.save(out, Path(spec["dir"]) / f"shard{world}_{local}.pt")
    finally:
        barrier(mesh)
        torch.distributed.destroy_process_group()


def _shard_gathers(h: int, n: int, depth: int = 4) -> int:
    """Row gathers of a stacked MNet forward on ``h`` rows over ``n``
    spatial ranks: a generator gathers once, at the first of its
    ``depth + 1`` stride-2 convs whose slab has an odd row count, and
    runs whole below it."""
    h //= n
    for _ in range(depth + 1):
        if h % 2:
            return 2
        h //= 2
    return 0


def _shard_rows(full: torch.Tensor, r: int, n: int) -> torch.Tensor:
    b = full.shape[2] // n
    return full[:, :, r * b:(r + 1) * b]


def phase_shard(par: dict) -> dict:
    """Spatial row sharding, tensor parallelism and the composed mesh
    (see the module docstring, phase 16), on ``par``, the parallel
    phase's result (its single run and configuration). Returns each
    rank's launches and the readings."""
    import torch.multiprocessing as mp

    from shadow_removal_istd_tpu_torch.engine.steps import infer_step

    t_phase = time.perf_counter()
    root = Path(par["spec"]["dir"])
    n_cards = torch.cuda.device_count() if DEVICE == "cuda" else 0
    dev = torch.device(DEVICE, 0) if DEVICE == "cuda" else \
        torch.device("cpu")
    print(f"[shard] card: {nvidia_smi() if DEVICE == 'cuda' else 'none'}")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ref, one_ms = {}, {}
    try:
        with torch.no_grad():
            for dtype in ("bfloat16", "float32"):
                g1, g2 = _shard_engine(dtype, dev, NGF)
                x = _shard_input(SHARD_HW, 1, dev, 11)
                ref[dtype] = [t.float().cpu() for t in infer_step(g1, g2, x)]
                one_ms[dtype] = _shard_time(lambda: infer_step(g1, g2, x),
                                            dev, None, SHARD_ITERS)
                del g1, g2
            state = _shard_3d_state(dev, NGF)
            g1, g2 = state.models.g1, state.models.g2
            g1.eval()
            g2.eval()
            ref["3d"] = [t.cpu() for t in infer_step(
                g1, g2, _shard_input(SHARD_3D_HW, 2, dev, 12))]
            del state, g1, g2
    finally:
        torch.backends.cudnn.deterministic = prev
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    outs = {}
    for world in (2, 4):
        if n_cards >= world:
            devices = [f"{DEVICE}:{i}" for i in range(world)]
            how = f"NCCL, one card each of {n_cards}"
        else:
            devices = [str(dev)] * world
            how = (f"gloo, {world} ranks sharing {dev}: correctness and "
                   "overhead, no scaling")
        print(f"[shard] {world} ranks on {devices} ({how})")
        spec = {**par["spec"], "devices": devices,
                "shard": {"ngf": NGF, "hw": SHARD_HW, "hw3": SHARD_3D_HW,
                          "iters": SHARD_ITERS}}
        t0 = time.perf_counter()
        mp.start_processes(_shard_rank, args=(
            world, f"file://{root}/shard_rendezvous{world}", spec),
            nprocs=world, start_method="spawn")
        print(f"[shard] {world} ranks took {time.perf_counter() - t0:.1f} "
              "s wall (process start, kernel loads and the runs)")
        outs[world] = [torch.load(root / f"shard{world}_{r}.pt")
                       for r in range(world)]
    tol = {"bfloat16": TOL[torch.bfloat16], "float32": TOL[torch.float32]}
    bad = []
    spatial = {}
    n_gather = _shard_gathers(SHARD_HW[0], 2)
    for dtype in ("bfloat16", "float32"):
        err = max(float((o[dtype][k] - _shard_rows(full, r, 2)).abs()
                        .max())
                  for r, o in enumerate(outs[2])
                  for k, full in zip(("m", "y"), ref[dtype]))
        final = "cuda_core" if dtype == "float32" else "tensor_core"
        want = {"tensor_core": 0, "cuda_core": 0, "narrow": 2}
        want[final] = 8
        for r, o in enumerate(outs[2]):
            print(f"[shard] spatial {dtype} rank {r}: K1 {o[dtype]['k1']} "
                  f"(want {want}), row gathers {o[dtype]['gathers']} "
                  f"(want {n_gather}), {o[dtype]['ms']:.3f} ms a forward")
            if DEVICE == "cuda" and o[dtype]["k1"] != want:
                bad.append(f"spatial {dtype} rank {r} K1 {o[dtype]['k1']}")
            if o[dtype]["gathers"] != n_gather:
                bad.append(f"spatial {dtype} rank {r} gathers")
        ms = max(o[dtype]["ms"] for o in outs[2])
        print(f"[shard] spatial {dtype}: {SHARD_HW[0]}x{SHARD_HW[1]} b1 "
              f"stacked ngf {NGF} over "
              f"2 spatial ranks ({outs[2][0]['backend']}): max |slab - "
              f"one-process rows| {err:.3e} (limit {tol[dtype]})")
        print(f"[time] spatial {dtype} {SHARD_HW[0]}x{SHARD_HW[1]} b1: one "
              f"process "
              f"{one_ms[dtype]:.3f} ms a forward, 2 spatial ranks "
              f"{ms:.3f} ms (host clock around synchronize and a barrier, "
              f"{SHARD_ITERS} forwards after one"
              + ("" if n_cards >= 2 else "; one card shared: no scaling")
              + ")")
        if err > tol[dtype]:
            bad.append(f"spatial {dtype} error {err:.3e}")
        spatial[dtype] = {"err": err, "ms": ms, "one_ms": one_ms[dtype],
                          "k1": [o[dtype]["k1"] for o in outs[2]]}
    single = par["single"]
    _, _, limit, m_limit = _par_limits(single)
    tps = [o["tp"] for o in outs[2]]

    def line(w):
        return ", ".join(f"{k} {v:.3e}" for k, v in w.items())

    same = all(torch.equal(t["state1"][k], tps[0]["state1"][k])
               for t in tps[1:] for k in tps[0]["state1"])
    same &= all(torch.equal(tps[0]["state0"][k], v)
                for k, v in single["state0"].items())
    read, where = _par_read(single, tps[0], "state1")
    m_tp = _par_metrics(single, tps[0])
    print(f"[shard] TP step (1x2 data x model, {outs[2][0]['backend']}): "
          f"gathered states of both ranks identical and started from the "
          f"single run's: {same}; TP - single after step 1: {line(read)} "
          f"(largest at {where}); metrics {m_tp:.3e}; held within "
          f"{line(limit['state1'])}, metrics {m_limit:.3e}")
    bad += [f"TP {k}" for k, v in read.items() if v > limit["state1"][k]]
    bad += ["TP metrics"] if m_tp > m_limit else []
    bad += [] if same else ["TP ranks' states"]
    faults = {}
    for name in SHARD_FAULTS:
        f_read, f_where = _par_read(single, tps[0][name], "state1")
        over = {k: v / limit["state1"][k] for k, v in f_read.items()}
        faults[name] = max(over.values())
        print(f"[shard] planted fault {name}, after step 1: "
              f"{line(f_read)}; the largest {faults[name]:.1f} x its limit "
              f"(at {f_where[max(over, key=over.get)]}; seen: "
              f"{faults[name] > 1})")
        if faults[name] <= 1:
            bad.append(f"planted {name} unseen")
    one_bytes = sum(v.numel() * v.element_size()
                    for k, v in single["state1"].items()
                    if not k.endswith(".step"))
    batch = par["spec"]["cfg"].get("batch_size", 16)
    tp_img_s = 2 * batch / max(t["steps_s"] for t in tps)
    for r, t in enumerate(tps):
        print(f"[shard] TP rank {r}: hshear {t['hshear']} (want 3), K1 "
              f"{t['decoder']}; parameters + BN + Adam "
              f"{t['bytes'] / 2 ** 20:.1f} MiB beside one process's "
              f"{one_bytes / 2 ** 20:.1f} MiB ({t['bytes'] / one_bytes:.3f}"
              f" x)")
        if DEVICE == "cuda" and (t["hshear"] != 3
                                 or sum(t["decoder"].values())):
            bad.append(f"TP rank {r} launches")
    print(f"[time] TP train, 2 steps of {batch} ({CROP}x{CROP} f32, host "
          f"clock around synchronize and a barrier): 2 model ranks "
          f"{tp_img_s:.1f} img/s beside the single run's "
          f"{par['img_s']['single']:.1f} img/s")
    err3 = 0.0
    for o in outs[4]:
        r_sp, _ = o["3d"]["coord"]
        err3 = max(err3, *(float((got - _shard_rows(full, r_sp, 2)).abs()
                                 .max())
                           for got, full in zip((o["3d"]["m"], o["3d"]["y"]),
                                                ref["3d"])))
    want3 = {"tensor_core": 0, "cuda_core": 8, "narrow": 2}
    for r, o in enumerate(outs[4]):
        print(f"[shard] 3-D rank {r} (spatial, model) {o['3d']['coord']}: "
              f"K1 {o['3d']['k1']} (want {want3}), row gathers "
              f"{o['3d']['gathers']}, {o['3d']['ms']:.1f} ms a forward")
        if DEVICE == "cuda" and o["3d"]["k1"] != want3:
            bad.append(f"3-D rank {r} K1 {o['3d']['k1']}")
    print(f"[shard] 3-D forward (1x2x2, {outs[4][0]['backend']}, weights "
          f"gathered at use, {SHARD_3D_HW[0]}x{SHARD_3D_HW[1]} b2 f32): max "
          f"|slab - one-process rows| {err3:.3e} (limit "
          f"{TOL[torch.float32]})")
    if err3 > TOL[torch.float32]:
        bad.append(f"3-D error {err3:.3e}")
    print(f"[time] shard phase {time.perf_counter() - t_phase:.1f} s")
    if bad:
        raise SystemExit(f"shard: {bad}")
    return {"spatial": spatial, "tp": {"read": read, "metrics": m_tp,
                                       "faults_x_limit": faults,
                                       "img_s": tp_img_s,
                                       "bytes": [t["bytes"] for t in tps],
                                       "one_bytes": one_bytes},
            "hshear": [t["hshear"] for t in tps],
            "decoder": {"spatial_bf16": spatial["bfloat16"]["k1"],
                        "spatial_f32": spatial["float32"]["k1"],
                        "tp_step": [t["decoder"] for t in tps],
                        "3d": [o["3d"]["k1"] for o in outs[4]]},
            "err_3d": err3}


def build_renamed(name: str, path: str,
                  entry: str = "srit_decoder_upsample"):
    """A kernel source (e.g. an earlier commit's
    ``csrc/decoder_upsample.cu``, whose C entry is ``entry``) built with
    its C entry renamed, so it loads beside the checkout's; typed like
    the checkout's CUDA-core decoder entry, or like ``hshear``'s with or
    without ``transpose_out`` (``fn.transposes``), as the source has it."""
    import ctypes

    from shadow_removal_istd_tpu_torch.ops import _build, decoder

    renamed = f"{entry}_{name}"
    lib = _build.BUILD_DIR / f"libcompare_{entry}_{name}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                           f"-D{entry}={renamed}", "-o",
                           str(lib), path], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {path}:\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if any(k in line for k in ("registers", "spill")):
            print(f"[ptxas] {name}: {line.strip()}")
    fn = getattr(ctypes.CDLL(str(lib)), renamed)
    fn.restype = ctypes.c_int
    fn.transposes = "int transpose_out" in Path(path).read_text()
    fn.argtypes = (decoder._kernel_fn("cuda_core").argtypes
                   if entry == "srit_decoder_upsample" else
                   [ctypes.c_void_p] * 4 + [ctypes.c_int] * (
                       6 + fn.transposes) + [ctypes.c_void_p])
    return fn


def compare_cuda_core(sources: dict[str, str]) -> None:
    """The checkout's CUDA-core kernel beside other sources of it, at the
    wide steps of f32 validation (480x640, batch 16, zero pad, one part)
    and f32 serving (256x256, batch 32, edge pad, two parts): each output
    held to the plain version and compared bit for bit with the
    checkout's, then timed in turns (checkout, others, others reversed,
    checkout) beside one cuDNN f32 convolution and the f32 FMA ceiling."""
    from shadow_removal_istd_tpu_torch.ops import decoder

    decoder._kernel_fn("cuda_core")     # the checkout's, built first
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        fns = dict(zip(sources, pool.map(build_renamed, sources,
                                         sources.values())))
    real = decoder._kernel_fn
    names = ["cuda_core", *fns]
    order = names + names[:0:-1] + names[:1]
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    for (h, w), n, zero_pad in (((480, 640), 16, True),
                                ((256, 256), 32, False)):
        tot: dict[str, float] = {}
        for label, sh, sw, parts, co, final in decoder_steps(h, w):
            if final:
                continue
            if zero_pad:
                parts = (sum(parts),)   # the validation MNet's one part
            xs, w4, s4, b4 = step_inputs(n, sh, sw, parts, co, final,
                                         torch.float32, gen)
            kw = dict(leaky=True, zero_pad=zero_pad)

            def run(name):
                return decoder._launch(tuple(xs), w4, s4, b4, co, True,
                                       zero_pad, name)[0]

            want = decoder.decoder_upsample_plain(xs, w4, s4, b4, **kw)
            line = f"[compare] {h}x{w} b{n} f32 step {label:<24}"
            with mock.patch.object(decoder, "_kernel_fn",
                                   lambda v: fns.get(v) or real(v)):
                ref = run("cuda_core")
                for name in names:
                    got = run(name)
                    err = (got - want).abs().max().item()
                    if err > TOL[torch.float32]:
                        raise SystemExit(f"{name} disagrees at {label}: "
                                         f"{err:.3e}")
                    line += (f" | {name} err {err:.2e}, "
                             f"{int((got != ref).sum())} differ")
                times: dict[str, list] = {}
                for name in order:
                    times.setdefault(name, []).append(
                        time_ms(lambda: run(name), 10))
            a = torch.nn.functional.pad(torch.cat(xs, 1), (1, 1, 1, 1),
                                        mode="constant" if zero_pad
                                        else "replicate")
            k = w4.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib = time_ms(lambda: torch.nn.functional.conv2d(a, k), 10)
            flops, nbytes = step_cost(n, sh, sw, parts, co, final, 4)
            bound = fma_ceiling_ms(flops, nbytes)
            for name, v in times.items():
                ms = sum(v) / len(v)
                tot[name] = tot.get(name, 0.0) + 2 * ms
                line += (f" | {name} " + "/".join(f"{t:.4f}" for t in v)
                         + f" ms ({flops / ms / 1e9:.1f} TFLOP/s)")
            for key, v in (("cudnn", lib), ("bound", bound)):
                tot[key] = tot.get(key, 0.0) + 2 * v
            print(f"{line} | cudnn conv {lib:.4f} ({flops / lib / 1e9:.1f} "
                  f"TFLOP/s) | bound {bound:.4f}", flush=True)
        print(f"[compare] {h}x{w} b{n} f32 8 wide launches: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in tot.items()), flush=True)


def compare_reflect_pad() -> None:
    """The train step at the CLI's defaults (f32, and bf16 compute) with
    the models' reflect pad (its deterministic backward folds the
    border's gradient) beside torch's ``F.pad(mode="reflect")``, whose
    backward scatters by atomic adds: step and phase medians of 7 steps,
    3 turns each, in one process (``[compare-pad]`` lines)."""
    import torch.nn.functional as F

    from shadow_removal_istd_tpu_torch.data.synthetic import (
        synthetic_triplets,
    )
    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
    from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer
    from shadow_removal_istd_tpu_torch.models import layers

    fold = layers.reflect_pad

    def torch_pad(x, p):
        return F.pad(x, (p, p, p, p), mode="reflect") if p else x

    SMOKE_DIR.mkdir(exist_ok=True)
    try:
        vgg = SMOKE_DIR / "vgg19_bn_random.npz"
        write_vgg_npz(vgg)
        train = synthetic_triplets(2 * AUG_BATCH, *DATA_HW, seed=0)
        for dtype in ("bfloat16", "float32"):
            t = Trainer(TrainConfig(aug_method="shear", compute_dtype=dtype,
                                    **TRAIN_KW),
                        RunConfig(seed=0, vgg_weights=str(vgg),
                                  device_cache=True,
                                  logs_dir=str(SMOKE_DIR / "l")),
                        train_streams=train, device=DEVICE)
            rows: dict = {}
            for turn in range(3):
                for name, fn in (("fold", fold), ("torch", torch_pad)):
                    layers.reflect_pad = fn
                    try:
                        rows.setdefault(name, []).append(
                            time_train_steps(t, steps=7))
                    finally:
                        layers.reflect_pad = fold
            for name, phs in rows.items():
                print(f"[compare-pad] {dtype} {name}: " + ", ".join(
                    f"{k} {_median([p[k] for p in phs]):.3f}"
                    for k in ("step", "d_phase", "g_forward", "g_adv",
                              "g_backward")) + " ms (medians of 3 turns)")
            del t
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--compare"]:
        # python3 chip_smoke.py --compare NAME=PATH [NAME=PATH ...]
        torch.backends.cudnn.allow_tf32 = False
        print(f"[card] {nvidia_smi()}")
        compare_cuda_core(dict(a.split("=", 1) for a in sys.argv[2:]))
        return 0
    if sys.argv[1:2] == ["--compare-hshear"]:
        # python3 chip_smoke.py --compare-hshear NAME=PATH [NAME=PATH ...]
        print(f"[card] {nvidia_smi()}")
        sources = dict(a.split("=", 1) for a in sys.argv[2:])
        time_shear_passes({name: build_renamed(name, path, "srit_hshear")
                           for name, path in sources.items()})
        return 0
    if sys.argv[1:2] == ["--compare-reflect-pad"]:
        print(f"[card] {nvidia_smi()}")
        compare_reflect_pad()
        return 0
    # f32 comparisons hold full f32: no TF32 in cuDNN or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    SMOKE_DIR.mkdir(exist_ok=True)
    try:
        phase_build()
        worst = phase_kernel_vs_plain()
        shear_err = phase_shear_vs_plain()
        launches, by_variant = phase_serving()
        vgg_path = SMOKE_DIR / "vgg19_bn_random.npz"
        write_vgg_npz(vgg_path)
        runs = phase_training(vgg_path)
        cli = phase_cli(vgg_path)
        host = phase_host(vgg_path)
        ev = phase_eval(vgg_path, runs["float32"]["trainer"])
        zoo = phase_zoo(vgg_path)
        kernel = phase_timings(worst, launches, by_variant)
        shear_entry, extra = phase_train_timings(runs, shear_err)
        runs.clear()        # the training phase's trainers: card memory
        torch.cuda.empty_cache()
        remat = phase_remat(vgg_path)
        h5 = phase_h5(vgg_path)
        int8 = phase_int8(vgg_path)
        exp = phase_export()
        par = phase_parallel(vgg_path)
        shard = phase_shard(par)
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    zk = zoo["kernels"]
    kernel.update(extra, launches_cli=cli["decoder"],
                  launches_host=host["decoder"],
                  launches_eval=ev["decoder"], launches_zoo=zoo["decoder"],
                  launches_h5=h5["decoder"],
                  launches_parallel={"dp_ranks": par["decoder"],
                                     "pipeline": par["pipeline"],
                                     "serving": par["serving"]},
                  launches_shard=shard["decoder"],
                  launches_export=exp["decoder"],
                  export_artifact_img_s=exp["artifact_img_s"],
                  export_engine_img_s=exp["engine_img_s"],
                  op_dispatch=exp["dispatch"],
                  max_abs_err=max(kernel["max_abs_err"],
                                  *zk["worst"].values(),
                                  *exp["max_abs_err"].values()),
                  **{f"zoo_unet_upconv_{key}": {
                      "ms": t["ms"], "plain_ms": t["plain_ms"],
                      "library_ms": t["convt_ms"], "conv_ms": t["conv_ms"],
                      "bound_ms": t["bound_ms"],
                      "bound_by": ("operations" if t["ops_ms"] >= t[
                          "bytes_ms"] else "bytes")}
                     for key, t in ((k, zk[k]) for k in ("bf16", "f32"))},
                  zoo_stacked_img_s={k: zoo["serve"][f"{k}_img_s"]
                                     for k in ("unet", "mnet")},
                  zoo_train_img_s={k: zoo[f"{k}_img_s"] for k in (
                      "unet_began", "denseunet_softadapt", "legacy")})
    shear_entry.update(launches_cli=cli["hshear"],
                       launches_host=host["hshear"],
                       host_epoch_img_s=host["host_img_s"],
                       fused_epoch_img_s=host["fused_img_s"],
                       launches_eval=ev["hshear"],
                       launches_gather=ev["hshear_gather"],
                       launches_remat=remat["hshear"],
                       launches_h5=h5["hshear"],
                       launches_parallel=par["hshear"],
                       parallel_train_img_s=par["img_s"],
                       launches_shard=shard["hshear"],
                       shard_tp_train_img_s=shard["tp"]["img_s"])
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": [kernel, shear_entry, *int8["kernels"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
