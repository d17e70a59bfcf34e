#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vit_cnn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before
the result lines:

1. device  — the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the build of the kernels from csrc/.
2. kernels — each hand-written kernel against its plain PyTorch version
   on the card, in float32 (tight) and bfloat16 (one bf16 step), with
   median times of kernel and plain version (CUDA events): the forwards
   (K1 selective scan, K2 dir_conv_silu, K3 inv_perm_weighted_sum, K4
   attention) at the flagship's serving shapes and one ragged batch (K1,
   K2 and K3 timed at both stages in bf16, K4 at both NonLocal shapes
   beside SDPA, each with its bound and share), the
   adjoints (K5-K7) at its train shapes (batch 1024 and a ragged 1001;
   K5 timed in bf16 at all four of a train step's launches, K6 and K7 at
   both train stages, each printed with its bound and share), and the
   gradients of the four autograd Functions against autograd through
   their plain versions. Then the eval-mode BatchNorm pass (``bn_act``)
   at FusAtNet's largest tensor (a band of 7,580 windows, 11 x 11 x
   1,024), with the conv bias and the ReLU, equal to its plain chain bit
   for bit in bf16 (timed beside the chain, with its bound) and float32,
   and at a flagship band's BatchNorms (C = 1, 25, 49, 144, 256; both of
   its load paths), with and without the conv bias and the ReLU. Then
   train-mode BatchNorm's four passes (``bn_train``) at FusAtNet's largest
   train-mode tensor (batch 1,024 at 11 x 11 x 1,024) with the ReLU, in
   bf16 and in float32 at a tenth of the rows: the moments within 2e-6
   of float64's sums, the forward equal bit for bit to ``normalize`` of
   the passes' own statistics, y, dx, dw, db and the running statistics
   no further from float64 autograd of the plain chain than the chain's
   own, four launches; in bf16 the forward and the forward + backward
   timed beside the plain chain, against the bytes bound of 16 bytes an
   element.
3. slice   — the port's ``--serve`` daemon on the Synthetic scene at
   Houston2013 size (349 x 1905, 144 + 1 bands, 15 classes) under the bf16
   policy, with seeded random weights loaded through convert.py: three
   requests, seconds and windows/s each, a finite (349, 1905, 15) map,
   and every forward kernel's launch count in that run (the BatchNorm
   pass's exactly once a BatchNorm, band and request).
4. crop    — a 12 x 64 crop of the scene served on the card (kernels,
   float32 and bf16) and on the CPU in float32 (plain versions).
5. train   — the port's training run (the CLI without ``--serve``) on the
   same scene from the same seeded weights: bf16 over float32 master
   weights, batch 1024, flip/rotate on, a few epochs of a few steps, then
   the full-scene map of the best weights and OA/AA/Kappa. Then steady
   steps on one fixed batch of 1024 centers (ms/step, patches/s, peak
   device memory). Every loss finite, the loss falling over the steady
   steps, all seven kernels launched (K5-K7 once per backward per use
   site, train-mode BatchNorm's passes four times a BatchNorm and step,
   three for a BatchNorm of an input, which needs no dx, and never in
   serving), every parameter still float32.
6. train-crop — one float32 step on the card and one on the CPU (plain
   versions) from the same weights and 32 centers, flip off: loss, every
   gradient and the updated BatchNorm statistics compared; the card's
   bf16 loss within a bound of the float32 one.
6b. runloop — the CLI's run loop (``run_experiments``) in a working
   directory of its own: 2 runs of 2 epochs, bf16, batch 1024, flip on,
   200 centers a class; each run's best-epoch and final-epoch checkpoint
   files under the JAX package's names, the reports (each run's and the
   aggregate), the map PNGs read back (349, 1905, 3), and K1-K7 launched
   as in phase 5 (the adjoints exactly once per step and use site). Then
   run 1's best file served through ``--serve --restore`` for 2 requests:
   the served OA, AA and Kappa equal the run's own, and the file's tensors
   equal the best state the run held, bit for bit. Then resume at full
   width in float32: 3 unbroken epochs against 2, save, restore into a
   trainer of another seed, 1 more, under the deterministic algorithms
   (rtol 1e-5), and the same with the default ones (printed: the card's
   default step is not bitwise repeatable, so its spread is shown). Wall
   time, checkpoint bytes and write / read seconds, and the restored
   serving's request seconds and windows/s, each beside the card's name
   and power limit.
7. zoo     — the transformer zoo's ``--serve`` path on the same scene, bf16,
   seeded weights through convert.py: MHST for three requests, then
   SpectralFormer, S2EFT and GLT_Net for one each; seconds and windows/s,
   a finite (349, 1905, 15) map, and the head-last attention kernels (K8,
   K9) and the BatchNorm pass launched exactly as often as the models'
   layers and bands say.
8. zoo-crop — each zoo model on a 12 x 64 crop on the card (float32 and
   bf16) and on the CPU in float32, held to phase 4's limits; for MHST
   the number of head selections, for S2EFT the number of its band gate's
   decisions (g >= 0.4), that differ between card and CPU, and for S2EFT
   the bf16 map's largest difference in windows with and without a
   flipped gate.
9. variants — run right after phase 2: the kernel-tuning sweeps
   (``tools/scan_sweep.py``, ``tools/heads_attn_variants.py``) at their
   shapes with fewer repetitions, plus a ragged batch and one token. The
   grid of K1's own kernel template (V1: channels per block x staged time
   steps) and the batch-major scan (V2) beside K1 and K1 fed by permute
   copies; the tensor-core (V3, per-head and head-masked) and CUDA-core
   outer-product (V4) forms of head-last attention beside K8 and SDPA.
   Every variant against its plain version, V1's instance at K1's plan
   equal to K1 bit for bit, forward and reverse, and each variant kernel
   launched.

10. cnn_zoo — run after the zoo phases: the CNN zoo (EndNet, the four
   Hong fusion CNNs, S2ENet, FusAtNet, MFT, HCTnet) at registry widths
   on the same scene, seeded weights through convert.py, model by model:
   ``--serve`` under the bf16 policy for a warm and a resident request
   (seconds and windows/s each, a finite (349, 1905, 15) map, request 2
   uploading nothing; HCTnet on the 30-component PCA of the HSI, held
   reduced in the scene cache), the 12 x 64 crop gates of phase 4, the
   float32 train-crop step against the CPU (phase 6's limits; the bf16
   loss within 5%; MFT's and HCTnet's dropout drawn on the CPU and
   replayed), and steady bf16 train steps (ms/step, patches/s, peak
   memory); then HCTnet's ``run_train`` (PCA on the way in) and its best
   file through ``--serve --restore`` with the run's OA / AA / Kappa
   exactly. No kernel of K1-K9 lies on this path (the JAX CNN models
   reach no Pallas kernel): every K1-K9 count stays 0; serving launches
   the eval-mode BatchNorm pass once a BatchNorm, band and request and
   nothing else (``run_train``'s validation and maps launch it too); a
   train step launches train-mode BatchNorm's passes four times a
   BatchNorm (``BN_SITES``; none of these models normalises an input)
   and nothing else.

11. run_modes — run after the CNN zoo: the port's remaining run modes.
   The flagship through ``--serve`` with ``{"stride": 3}`` requests (bf16;
   seconds and windows/s, mass only at window centers, K1-K4 launched),
   and the 12 x 64 crop at stride 2 (origin rows 0, 2, 3; 87 windows and
   9 padding origins in one chunk of 96, so the padding shares the
   scatter with (0, 0)) on the card in
   float32 against the CPU within CROP_TOL. ``run_train`` with flip,
   radiation and mixture augmentation (bf16, batch 1024, 2 epochs, maps at
   stride 3; K1-K7 launched, the adjoints once per step and use site),
   steady steps with and without the two noises in turns (ms/step each),
   and the noise gates over 20 draws of 1024 within 4 sigma of 0.1 and
   0.2. ``--pretrain --cos`` with both noises through the CLI on a
   49 x 169 scene (2 epochs at batch 64, queue 2048; the best file read
   back bit for bit), steady pretraining steps on the full scene at batch
   64 and 1024 (ms/step, patches/s, peak memory), and one float32
   pretraining step on the card against the CPU's from the same weights,
   views and queue (phase 6's limits); K1-K9 launched 0 times in
   pretraining. ``--debug_nans``: the clean bf16 step's cost with and
   without the checks, and a poisoned parameter raising
   ``FloatingPointError`` naming a module.

12. path_types — run right after phase 9: every path type of the Mamba
   layer (the 13 of ``path_spec``) at the flagship's stage-1 width (hidden
   144, d 72, 81 tokens), seeded weights: one float32 forward + backward at
   batch 32 on the card against the CPU (forward within 1e-3 of max(1,
   max|cpu|), every gradient within phase 6's limit), the card's bf16
   forward within 2e-2 of the float32 one's largest entry, the shuffle
   permutations drawn on the CPU and replayed, and K1-K3 / K5-K7 launched
   exactly as the path's streams say (no K3 for the per-sample gate); bf16
   times of the forward at the serving band and of forward + backward at
   the train batch. The batch-major ``MambaMixer`` at batch 1,024, and
   2-layer backbones over the cls positions, output types, sine and no
   position embedding, 'multi_clock_gate' (no kernel) and dropout 0.1 in
   train mode (masks replayed), each card against CPU. K2, K3, K6 and K7
   at the shuffle paths' stream counts (nb, nr) = (1, 0), (2, 1), (3, 1)
   on freshly drawn rows against their plain versions (their errors join
   phase 2's rows).

13. mesh — run after run_modes: the port's mesh (vit_cnn_tpu_torch/parallel/mesh.py)
   on this one-card host. The default run's mesh has world size 1 (one
   card: off, as in JAX), so every phase above runs as before. Then two
   gloo ranks share the card (``make_mesh(2, "cuda", share=True)``, this
   process rank 0) against world size 1 on the card, the flagship at full
   width on a 40 x 200 crop, float32, batch 64 split 32 + 32
   (``tools/mesh_check.py``'s tasks): 3 train steps with flip (step-1 loss
   within 1e-5 + 1e-4 |L|, the trajectory within rtol 5e-3 / atol 1e-4,
   the BatchNorm statistics after step 1 within 1e-5 + 1e-4 |v|, the
   ranks' parameters equal bit for bit, K1-K7 launched on both ranks, the
   adjoints once per step and use site), the stride-1 and stride-2 maps
   of the 12 x 64 crop within 1e-5 x max(1, max|map|), a resumable file
   saved under the mesh and restored bit for bit then one more finite
   step, and one MoCo step (loss within phase 6's 1e-3, queue within
   1e-6, pointer equal); the host time a step of both beside the card's
   name and power limit. Two processes sharing one card say nothing of a
   multi-GPU speed.

14. bench_models — run after the mesh: the per-model table tool
   (``tools/bench_models.py``, the twin of the JAX package's
   ``perf/bench_models.py``) for EndNet and the flagship on the full
   scene, serving (bf16, chunk 8192, a 4-band crop) and training (bf16,
   batch 1024), 1 s and 1 run each: every rate finite and positive, both
   trains at batch 1024 (no halving), K1-K7 launched in the flagship's
   runs.

Phase 2 also holds K8 and K9 (float32 and bf16, at every zoo band shape,
a ragged batch, one token, 17 tokens, odd hd and the 512-token limit) and
times both dtypes beside their plain versions,
``scaled_dot_product_attention`` (K8 without the residual; K4 too) and,
for K9, the composition of the plain group LayerNorm with K8.

Then one JSON line with the kernel table (time, plain time, bound and what
bounds it, library time, launches per path: serve, train, runloop,
serve_zoo, train_zoo, cnn_zoo, serve_stride, train_aug, path_types,
sweep, mesh and bench_models), and as the last line
``{"ok": true, "device": {...}}``.
"""

import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time

SCENE = {"VCT_SYN_H": "349", "VCT_SYN_W": "1905", "VCT_SYN_BANDS": "144",
         "VCT_SYN_CLASSES": "15"}
SEED = 0
BAND_WINDOWS = 4 * 1897       # windows per band at --infer_chunk 8192
RAGGED = 1001
TRAIN_BATCH = 1024
CROP_TOL = 1e-3               # max|diff| of the f32 crop map, relative
# train-crop, card f32 against CPU f32 (plain versions):
# - the whole step's gradients, per tensor: ||diff|| <= GRAD_TOL * ||cpu||
#   + GRAD_ATOL * (the model's largest gradient norm). The flagship's
#   gradients at batch 32 are ill-conditioned: the CPU against itself with
#   1 thread instead of 8 (only the summation order changes) moves some
#   small gradients by 2.6e-2 of their largest entry (measured on the
#   H100 host's CPU). The floor is for gradients that vanish
#   mathematically (biases ahead of a train-mode BatchNorm, phi's bias
#   under the softmax): float32 rounding noise of 1e-9..1e-7 on both sides.
# - the updated BatchNorm statistics (forward values): max|diff| <=
#   STAT_TOL * max|cpu|.
# - each Mamba backbone alone (no BatchNorm, no ReLU: well conditioned),
#   the kernels' path in place at full width: every gradient max|diff| <=
#   BACKBONE_TOL * max|cpu|.
GRAD_TOL, GRAD_ATOL = 5e-2, 1e-5
STAT_TOL = 1e-3
BACKBONE_TOL = 1e-3
BF16_LOSS_TOL = 0.05          # |bf16 loss - f32 loss| / f32 loss on the card
STEADY_STEPS = 20
FORWARD = ("selective_scan", "dir_conv_silu", "inv_perm_weighted_sum",
           "fused_attention")
ADJOINTS = ("selective_scan_backward", "dir_conv_silu_backward",
            "inv_perm_weighted_sum_backward")
# launches per train step: two Mamba layers, each with a forward and a
# reverse scan, one dir_conv and one inverse sum; two NonLocal blocks
PER_STEP = {"selective_scan": 4, "dir_conv_silu": 2,
            "inv_perm_weighted_sum": 2, "fused_attention": 2,
            "selective_scan_backward": 4, "dir_conv_silu_backward": 2,
            "inv_perm_weighted_sum_backward": 2}
# phase runloop: runs and epochs of run_experiments, requests of the
# restored serving, and resume: 3 unbroken float32 epochs against 2 + 1
RUNLOOP_RUNS, RUNLOOP_EPOCHS, RUNLOOP_REQUESTS = 2, 2, 2
RESUME_EPOCHS, RESUME_SAVED = 3, 2
RESUME_RTOL = 1e-5
HEADS = ("fused_attention_heads", "pooled_heads_attention")
ZOO = ("MHST", "SpectralFormer", "S2EFT", "GLT_Net")
MHST_REQUESTS = 2
# K8 / K9 launches per full-scene request at --infer_chunk 8192 on the
# 349 x 1905 scene: bands (4 origin rows each) x launches per band. MHST
# (patch 8): 86 bands x 5 ViT layers, 86 x 8 pooled blocks; SpectralFormer
# (patch 1): 88 x 5; S2EFT (patch 7): 86 x 5; GLT_Net (patch 8): 86 x
# (5 encoder + 5 decoder layers)
ZOO_LAUNCHES = {"MHST": (430, 688), "SpectralFormer": (440, 0),
                "S2EFT": (430, 0), "GLT_Net": (860, 0)}
# windows per band: 4 origin rows x (1905 - patch + 1)
ZOO_BANDS = {"MHST": 4 * 1898, "SpectralFormer": 4 * 1905,
             "S2EFT": 4 * 1899}
# phase zoo_train: run_train of each zoo model at 2 epochs, then steady
# steps on one batch of TRAIN_BATCH; K8 launches per train step: one per ViT
# layer (MHST, SpectralFormer, S2EFT: 5; GLT_Net: 5 encoder + 5 decoder);
# the backward launches none, and MHST's pooled blocks (attn_drop 0.1)
# take the unfused formula, so no K9. The crop step: 32 centers; MHST at
# attn_drop 0 launches K9 once per pooled block
ZOO_TRAIN_EPOCHS, ZOO_STEADY_STEPS, ZOO_CROP_CENTERS = 2, 10, 32
ZOO_TRAIN_K8 = {"MHST": 5, "SpectralFormer": 5, "S2EFT": 5, "GLT_Net": 10}
MHST_POOLED_BLOCKS = 8
# the tokens of each zoo ViT in training (K8's train shapes)
ZOO_TRAIN_TOKENS = ((65, "MHST, GLT_Net"), (145, "S2EFT"),
                    (146, "SpectralFormer"))
# phase cnn_zoo: the CNN zoo (none of K1-K9 on its path), and the
# model whose run_train and best file it checks (PCA on the way in)
CNN_ZOO = ("EndNet", "Early_fusion_CNN", "Middle_fusion_CNN",
           "Late_fusion_CNN", "Cross_fusion_CNN", "S2ENet", "FusAtNet",
           "MFT", "HCTnet")
CNN_HANDOFF = "HCTnet"
PATH_KERNELS = FORWARD + ADJOINTS + HEADS
# the eval-mode BatchNorm pass: every model's serving with a BatchNorm
BN_PASS = ("bn_act",)
# its launches a forward in eval mode: one per BatchNorm the model calls
# (FusAtNet: its 35 ConvBNReLU units; the flagship: 16 BatchNorms)
BN_SITES = {"Multimodality_Mamba": 16, "MHST": 9, "SpectralFormer": 0,
            "S2EFT": 0, "GLT_Net": 13, "EndNet": 10, "Early_fusion_CNN": 6,
            "Middle_fusion_CNN": 10, "Late_fusion_CNN": 12,
            "Cross_fusion_CNN": 16, "S2ENet": 11, "FusAtNet": 35, "MFT": 3,
            "HCTnet": 3}
# phase 2's shapes for it: FusAtNet's largest tensor, a band of windows at
# its 1,024-channel 11 x 11 units (timed, with the conv bias and the ReLU);
# then a flagship band's BatchNorms (7,588 windows), one-value path
# (C = 1, 25, 49) and 16-byte path, each with and without the ReLU and the
# conv bias
BN_SHAPE = (7580, 11, 11, 1024)
# train-mode BatchNorm's passes: every train step of a model with a
# BatchNorm, BN_TRAIN_PER_SITE launches a BatchNorm a step (moments and
# apply forward, sums and dx backward), none in serving; phase 2 times them
# at FusAtNet's largest train-mode tensor, batch 1,024 at 11 x 11 x 1,024
BN_TRAIN = ("bn_train",)
BN_TRAIN_PER_SITE = 4
# BatchNorms of a model's own inputs (the flagship's HSI and LiDAR): their
# input needs no gradient, so the dx pass is skipped, 3 launches a step
BN_INPUTS = {"Multimodality_Mamba": 2}
BN_TRAIN_SHAPE = (1024, 11, 11, 1024)
# the passes' gap from float64 autograd of the chain (relative, in norm)
# may exceed the chain's own gap by this factor, or reach this floor
# (eight float32 ulps), as tests/test_torch_bn_train_cuda.py holds them;
# their moments lie within BN_TRAIN_MOMENTS of float64's sums
BN_TRAIN_ROOM, BN_TRAIN_FLOOR, BN_TRAIN_MOMENTS = 1.02, 2.0 ** -21, 2e-6
BN_FLAGSHIP = ((7588, 9, 9, 1), (7588, 7, 7, 25), (7588, 9, 9, 49),
               (7588, 5, 5, 144), (7588, 7, 7, 256))
# phase run_modes: the flagship served at stride 3 (and the 12 x 64 crop at
# stride 2: origin rows 0, 2, 3, the last clamped; its 87 windows and 9
# padding origins in one chunk of 96), its
# run_train with both noises (maps at stride 3), steady steps with and
# without them in turns, the noise gates over GATE_BATCHES draws; MoCo
# pretraining through the CLI on a scene of 40 x 160 interior centers (~100
# steps an epoch at batch 64), steady pretraining steps on the full scene,
# the card-vs-CPU pretraining step; --debug_nans clean and poisoned
STRIDE, STRIDE_CROP, STRIDE_CROP_CHUNK = 3, 2, 96
AUG_EPOCHS, NOISE_STEPS, GATE_BATCHES = 2, 10, 20
PRETRAIN_SCENE = {"VCT_SYN_H": "49", "VCT_SYN_W": "169"}
PRETRAIN_EPOCHS, PRETRAIN_QUEUE, PRETRAIN_STEADY = 2, 2048, 20
PRETRAIN_BATCHES = (64, 1024)
NAN_STEPS = 5
# phase 9: the sweep tools' variant kernels (rows 10-13 of the table);
# their cases at fewer repetitions, plus a ragged batch and one token
VARIANTS = ("selective_scan_tiled", "selective_scan_batch_major",
            "heads_attention_mma", "heads_attention_outer")
SWEEP_REPS, SWEEP_PLAIN_REPS = 3, 1
RAGGED_SCANS = (("ragged", 6, 81, 72, RAGGED, False),
                ("ragged", 4, 81, 72, RAGGED, True))
RAGGED_HEADS = (("ragged", RAGGED, 65, 16, 4), ("ragged", RAGGED, 65, 4, 16),
                ("one token", RAGGED, 1, 16, 4),
                ("one token", RAGGED, 1, 4, 16))
# phase path_types: every path type of the Mamba layer at the flagship's
# stage-1 width (hidden 144, d 72, 81 tokens; the sequence paths at 81
# too), card against CPU at PATH_BATCH in float32 (forward within PATH_TOL
# of max(1, max|cpu|), every gradient within phase 6's GRAD_TOL), card
# bf16 against card float32 within PATH_BF16_TOL of the largest entry;
# the shuffle permutations and dropout masks drawn on the CPU and
# replayed on the card. Times: bf16 forward at the serving band and bf16
# forward + backward at the train batch, PATH_REPS repetitions each.
PATH_TYPES = ("forward", "shuffle", "eight_directions_gate", "9twoclock",
              "25twoclock", "49twoclock", "81twoclock", "49_2+8", "81_2+8",
              "forward_reverse_mean", "forward_reverse_gate",
              "forward_reverse_shuffle_gate", "forward_reverse_shuffle_mean")
PATH_HIDDEN, PATH_D, PATH_L, PATH_BATCH = 144, 72, 81, 32
PATH_TOL, PATH_BF16_TOL = 1e-3, 2e-2
PATH_REPS = 10
# K2 / K3 / K6 / K7 stream counts (nb, nr) of the shuffle paths ('shuffle';
# 'forward_reverse_shuffle_*'; and one more static base)
SHUFFLE_STREAMS = ((1, 0), (2, 1), (3, 1))
# 2-layer backbones: (path_type, pe_type, cls_position, out_type, drop_rate)
PATH_BACKBONES = (
    ("forward_reverse_shuffle_gate", "learnable", "head", "cls_token", 0.0),
    ("forward", "learnable", "tail", "cls_token", 0.0),
    ("forward_reverse_gate", "learnable", "head_tail", "cls_token", 0.0),
    ("shuffle", "learnable", "middle", "cls_token", 0.0),
    ("forward_reverse_mean", "learnable", "middle", "featmap", 0.0),
    ("forward_reverse_shuffle_mean", "learnable", "head_tail",
     "avg_featmap", 0.0),
    ("forward", "none", "tail", "raw", 0.0),
    ("81_2+8", "sine", "none", "featmap", 0.0),
    ("81twoclock", "none", "none", "avg_featmap", 0.0),
    ("multi_clock_gate", "learnable", "none", "raw", 0.0),
    ("forward_reverse_shuffle_gate", "sine", "none", "featmap", 0.1),
    ("eight_directions_gate", "learnable", "none", "featmap", 0.1))


# phase mesh: two gloo ranks sharing the card against world size 1, the
# flagship at full width on a MESH_CROP crop, float32, MESH_BATCH split in
# two (tools/mesh_check.py's STEPS steps; the 12 x 64 crop's maps at its
# MAP_CHUNK: stride 1 in 4 bands of 1 origin row, 2 for each rank; stride
# 2: 87 origins in 3 chunks, 2 for rank 0); MoCo at the same batch and
# PRETRAIN_QUEUE
MESH_CROP, MESH_BATCH = (40, 200), 64
# phase bench_models: the cheapest model of the registry and the flagship,
# 1 s and 1 run a phase each
BENCH_MODELS, BENCH_BUDGET_S = ("EndNet", "Multimodality_Mamba"), 1.0


class Failed(Exception):
    pass


def _compare(name, got, want, dtype_name, summed=()):
    """max|diff| of the kernel's output against the plain version's, held
    elementwise to the dtype's limits (``tools.compare``: |d| <= atol +
    rtol * |want|); the outputs listed in ``summed`` to |d| <= atol + rtol
    * max|want|. Those are the adjoints' sums: dA, dD, dcw, dcb and dw add
    up ~10^5 float32 terms, and every K5 output is a sum over the state or
    the channels whose terms cancel, so an entry near zero keeps the
    rounding of its large terms (the two sides' exp and reduction order
    differ on the card). K6's du (at most 40 terms per entry) and K7's dy
    are held elementwise. A summed output's line reports max|diff| /
    max|want|."""
    import torch

    from vit_cnn_tpu_torch.tools import TOL, compare

    rtol, atol = TOL[dtype_name]
    outs_g = got if isinstance(got, (tuple, list)) else (got,)
    outs_w = want if isinstance(want, (tuple, list)) else (want,)
    worst, ok = 0.0, True
    for i, (g, w) in enumerate(zip(outs_g, outs_w)):
        if g.numel() == 0:
            continue
        if i in summed:
            g, w = g.float(), w.float()
            d, top = float((g - w).abs().max()), float(w.abs().max())
            this_ok = bool(torch.isfinite(g).all()) and d <= atol + rtol * top
            print("    output {}: max|diff| {:.3e} of max|want| {:.3e}"
                  .format(i, d, top), flush=True)
        else:
            d, this_ok = compare(g, w, dtype_name)
        worst, ok = max(worst, d), ok and this_ok
    print("  {:<44s} {:<8s} max|diff| {:.3e}  (rtol {:g}, atol {:g})  {}"
          .format(name, dtype_name, worst, rtol, atol,
                  "ok" if ok else "FAIL"), flush=True)
    if not ok:
        raise Failed("{} {} disagrees with its plain version".format(
            name, dtype_name))
    return worst


def _record(rows, key, err, dtype_name, ms=None, plain_ms=None,
            bound=None, **timed):
    """Keep a kernel's worst error per dtype, and at its timed shape its
    time, its plain version's, its bound (``_bound``) and any other timed
    field (library_ms, ...)."""
    row = rows.setdefault(key, {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0,
                                "library_ms": None})
    field = "max_abs_err" if dtype_name == "float32" else "max_abs_err_bf16"
    row[field] = max(row[field], err)
    if ms is not None:
        row["ms"], row["plain_ms"] = ms, plain_ms
        row["bound_ms"], row["bound_by"] = bound
        row.update(timed)


def _timed(rows, key, shape, dtype_name, **fields):
    """Keep one timed shape and dtype of a kernel under its row's
    ``timed``."""
    _record(rows, key, 0.0, dtype_name)          # the row exists
    rows[key].setdefault("timed", {}).setdefault(shape, {})[dtype_name] = \
        fields


def phase_device():
    import torch

    from vit_cnn_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi failed: " + smi.stderr.strip()
    print("[device] {}".format(card), flush=True)
    print("[device] torch {} cuda {} {} x{}".format(
        torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0), torch.cuda.device_count()),
        flush=True)
    t0 = time.perf_counter()
    paths = _build.build(*_build.LIBRARIES)       # all sources together
    for name in _build.LIBRARIES:
        _build.lib(name)
    print("[device] kernels {} in {:.1f} s ({}; {})".format(
        "built" if _build.build_seconds else "loaded",
        time.perf_counter() - t0, ", ".join(p.name for p in paths.values()),
        ", ".join("{} {:.1f} s".format(name, s)
                  for name, s in _build.build_seconds.items())), flush=True)
    return card


def _tables(L):
    import numpy as np
    import torch

    from vit_cnn_tpu_torch.ops.scan_paths import (base_paths,
                                                  inverse_permutation)

    orders, bases, fwd_dir, rev_dir = base_paths("{}_2+8".format(L), L)
    i32 = dict(dtype=torch.int32, device="cuda")
    order_t = torch.tensor(np.stack([orders[i] for i in bases]), **i32)
    inv_t = torch.tensor(np.stack([inverse_permutation(orders[i])
                                   for i in bases]), **i32)
    rev_t = torch.tensor([i for i, r in enumerate(rev_dir) if r >= 0], **i32)
    return order_t, inv_t, rev_t


def phase_kernels():
    """Each kernel against its plain version; returns the JSON rows."""
    import torch
    import torch.nn.functional as F

    from vit_cnn_tpu_torch.ops import attention, dirstream, selective_scan
    from vit_cnn_tpu_torch.tools import bound as _bound
    from vit_cnn_tpu_torch.tools import median_ms as _median_ms
    from vit_cnn_tpu_torch.tools import scan_inputs as _scan_inputs

    g = torch.Generator(device="cuda").manual_seed(SEED)
    stages = [(81, 72), (49, 128)]          # (L, d) of hsi1 and hsi2
    rows = {}

    record = functools.partial(_record, rows)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        timed = dtype == torch.bfloat16     # the serving dtype
        for (L, d) in stages:
            for b in (BAND_WINDOWS, RAGGED):
                band = timed and b == BAND_WINDOWS    # timed, both stages
                main = band and L == 81               # the table's shape
                stage = "serving stage {} (L={}, d={}, b={})".format(
                    1 if L == 81 else 2, L, d, b)
                # K1: forward over the 6 base streams, reverse over the 4
                for ns, rev in ((6, False), (4, True)):
                    args = _scan_inputs(g, ns, L, d, 16, b, dtype)
                    got = selective_scan.selective_scan(*args, reverse=rev)
                    want = selective_scan.selective_scan_reference(
                        *args, reverse=rev)
                    err = _compare("K1 scan ns={} L={} d={} b={}{}".format(
                        ns, L, d, b, " rev" if rev else ""), got, want, dn)
                    t = p = bound = None
                    extra = {}
                    if band and not rev:
                        t = _median_ms(lambda: selective_scan.selective_scan(
                            *args, reverse=rev))
                        p = _median_ms(
                            lambda: selective_scan.selective_scan_reference(
                                *args, reverse=rev), reps=3)
                        # one exp(dt A) per state element and step
                        bound = _bound(list(args) + [got], dn,
                                       exps=ns * L * d * 16 * b)
                        print("    K1 {}: kernel {:.3f} ms, plain {:.3f}, "
                              "bound {:.3f} ({})".format(stage, t, p, *bound),
                              flush=True)
                        _timed(rows, "selective_scan", stage, dn, ms=t,
                               plain_ms=p, bound_ms=bound[0],
                               bound_by=bound[1])
                        if not main:
                            t = p = bound = None
                    record("selective_scan", err, dn, t, p, bound)
                    del args, got, want
                # K2 / K3 with the real '{L}_2+8' orders
                orders, inv, rev_rows = _tables(L)
                u = torch.randn((L, d, b), generator=g,
                                device="cuda").to(dtype)
                cw = 0.5 * torch.randn((4, d), generator=g, device="cuda")
                cb = 0.1 * torch.randn((d,), generator=g, device="cuda")
                got = dirstream.dir_conv_silu(u, cw, cb, orders, rev_rows)
                want = dirstream.dir_conv_silu_reference(u, cw, cb, orders,
                                                         rev_rows)
                err = _compare("K2 dir_conv_silu L={} d={} b={}".format(
                    L, d, b), got, want, dn)
                t = p = bound = None
                if band:
                    t = _median_ms(lambda: dirstream.dir_conv_silu(
                        u, cw, cb, orders, rev_rows))
                    p = _median_ms(lambda: dirstream.dir_conv_silu_reference(
                        u, cw, cb, orders, rev_rows), reps=3)
                    # one SiLU exp per output
                    bound = _bound([u, cw, cb, orders, rev_rows, *got], dn,
                                   exps=10 * L * d * b)
                    print("    K2 {}: kernel {:.3f} ms, plain {:.3f}, bound "
                          "{:.3f} ({})".format(stage, t, p, *bound),
                          flush=True)
                    _timed(rows, "dir_conv_silu", stage, dn, ms=t,
                           plain_ms=p, bound_ms=bound[0], bound_by=bound[1])
                    if not main:
                        t = p = bound = None
                record("dir_conv_silu", err, dn, t, p, bound)
                yf, yr = got
                wts = torch.softmax(torch.randn((10,), generator=g,
                                                device="cuda"), 0)
                wf, wr = wts[:6], wts[6:]
                got = dirstream.inv_perm_weighted_sum(yf, yr, wf, wr, inv,
                                                      rev_rows)
                want = dirstream.inv_perm_weighted_sum_reference(
                    yf, yr, wf, wr, inv, rev_rows)
                err = _compare("K3 inv_perm_weighted_sum L={} d={} b={}"
                               .format(L, d, b), got, want, dn)
                t = p = bound = None
                if band:
                    t = _median_ms(lambda: dirstream.inv_perm_weighted_sum(
                        yf, yr, wf, wr, inv, rev_rows))
                    p = _median_ms(
                        lambda: dirstream.inv_perm_weighted_sum_reference(
                            yf, yr, wf, wr, inv, rev_rows), reps=3)
                    bound = _bound([yf, yr, wf, wr, inv, rev_rows, got], dn,
                                   flops=2 * 10 * L * d * b)
                    print("    K3 {}: kernel {:.3f} ms, plain {:.3f}, bound "
                          "{:.3f} ({}), share {:.1%}".format(
                              stage, t, p, *bound, bound[0] / t), flush=True)
                    _timed(rows, "inv_perm_weighted_sum", stage, dn, ms=t,
                           plain_ms=p, bound_ms=bound[0], bound_by=bound[1])
                    if not main:
                        t = p = bound = None
                record("inv_perm_weighted_sum", err, dn, t, p, bound)
                del u, got, want, yf, yr
        # K4 at the NonLocal shapes of hsi1 and hsi2
        for (lq, lk, dh) in ((49, 9, 128), (25, 4, 72)):
            for G in (BAND_WINDOWS, RAGGED):
                q = torch.randn((G, lq, dh), generator=g, device="cuda")
                k = torch.randn((G, lk, dh), generator=g, device="cuda")
                v = torch.randn((G, lk, dh), generator=g, device="cuda")
                q, k, v = (0.3 * x for x in (q, k, v))
                q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
                got = attention.fused_attention(q, k, v, 1.0)
                want = attention.attention_reference(q, k, v, 1.0)
                err = _compare("K4 attention G={} {}x{} dh={}".format(
                    G, lq, lk, dh), got, want, dn)
                t = p = bound = None
                extra = {}
                if timed and G == BAND_WINDOWS:       # timed, both shapes
                    shape = "serving {}x{} dh={} (G={})".format(lq, lk, dh,
                                                                 G)
                    t = _median_ms(lambda: attention.fused_attention(
                        q, k, v, 1.0))
                    p = _median_ms(lambda: attention.attention_reference(
                        q, k, v, 1.0))
                    bound = _bound([q, k, v, got], dn, exps=G * lq * lk,
                                   flops=4 * G * lq * lk * dh)
                    extra["library_ms"] = _median_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, scale=1.0))
                    print("    K4 {}: kernel {:.3f} ms, plain {:.3f}, SDPA "
                          "{:.3f}, bound {:.3f} ({}), share {:.1%}".format(
                              shape, t, p, extra["library_ms"], *bound,
                              bound[0] / t), flush=True)
                    _timed(rows, "fused_attention", shape, dn, ms=t,
                           plain_ms=p, bound_ms=bound[0], bound_by=bound[1],
                           **extra)
                    if lq != 49:                      # the table's shape
                        t = p = bound = None
                        extra = {}
                record("fused_attention", err, dn, t, p, bound, **extra)
    torch.cuda.synchronize()
    phase_heads_kernels(rows)
    phase_bn_act(rows)
    phase_bn_train(rows)
    return rows


def phase_bn_act(rows):
    """The eval-mode BatchNorm pass against its plain chain, the outputs
    equal bit for bit each time, and one launch a call: at BN_SHAPE with
    the conv bias and the ReLU, bf16 (timed, beside the chain, against the
    bytes bound of one read of x and one write of y) and float32 at a
    tenth of the windows; then at BN_FLAGSHIP in bf16 (timed with the
    ReLU, no conv bias, as the flagship calls it) and float32, each with
    and without the ReLU and the conv bias."""
    import torch

    from vit_cnn_tpu_torch.ops import _build, bn_act
    from vit_cnn_tpu_torch.tools import bound as _bound
    from vit_cnn_tpu_torch.tools import median_ms as _median_ms

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(shape, dtype):
        c = shape[-1]
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        mean, cb, bias = (0.2 * torch.randn(c, generator=g, device="cuda")
                          .to(dtype) for _ in range(3))
        var = (torch.rand(c, generator=g, device="cuda") + 0.5).to(dtype)
        weight = (1 + 0.2 * torch.randn(c, generator=g, device="cuda")).to(
            dtype)
        return x, (mean, var, weight, bias, 1e-5), cb

    def same(args):
        before = _build.launches["bn_act"]
        with torch.no_grad():
            got = bn_act.bn_act(*args)
        want = bn_act.bn_act_reference(*args)
        ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
        if _build.launches["bn_act"] != before + 1 or not torch.equal(
                got.view(ints), want.view(ints)):
            raise Failed("bn_act {} differs from its plain chain at {} "
                         "(conv bias {}, relu {}) or did not launch once"
                         .format(got.dtype, tuple(got.shape),
                                 args[6] is not None, args[7]))
        return got

    def timed(args, got, dn):
        with torch.no_grad():
            t = _median_ms(lambda: bn_act.bn_act(*args))
        p = _median_ms(lambda: bn_act.bn_act_reference(*args), reps=3)
        return t, p, _bound([args[0], got], dn)

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        shape = BN_SHAPE if dtype == torch.bfloat16 else (
            BN_SHAPE[0] // 10,) + BN_SHAPE[1:]
        x, vectors, cb = inputs(shape, dtype)
        args = (x, *vectors, cb, True)
        got = same(args)
        t = p = bound = None
        if dtype == torch.bfloat16:
            t, p, bound = timed(args, got, dn)
            same(args)
        print("  {:<44s} {:<8s} equal bit for bit{}".format(
            "bn_act {}".format(shape), dn, "" if t is None else
            ": kernel {:.3f} ms, plain {:.3f}, bound {:.3f} ({}), share "
            "{:.1%}".format(t, p, *bound, bound[0] / t)), flush=True)
        _record(rows, "bn_act", 0.0, dn, t, p, bound)
        del x, got, args
    for shape in BN_FLAGSHIP:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            x, vectors, cb = inputs(shape, dtype)
            for bias in (None, cb):
                for relu in (False, True):
                    got = same((x, *vectors, bias, relu))
            line = ""
            if dtype == torch.bfloat16:
                t, p, bound = timed((x, *vectors, None, True), got, dn)
                _timed(rows, "bn_act", str(shape), dn, ms=t, plain_ms=p,
                       bound_ms=bound[0], bound_by=bound[1])
                line = (": kernel {:.3f} ms, plain {:.3f}, bound {:.3f} "
                        "({}), share {:.1%}".format(t, p, *bound,
                                                    bound[0] / t))
            print("  {:<44s} {:<8s} equal bit for bit, bias and ReLU each "
                  "on and off{}".format("bn_act {}".format(shape), dn, line),
                  flush=True)
            del x, got
    torch.cuda.synchronize()


def phase_bn_train(rows):
    """Train-mode BatchNorm's four passes at BN_TRAIN_SHAPE with the ReLU,
    bf16 (timed) and float32 (a tenth of the rows), each held to the plain
    chain on the same inputs: the moments within BN_TRAIN_MOMENTS of
    float64's sums (relative to the sums of |x| and of x^2); the forward
    equal bit for bit to ``normalize`` fed the passes' own statistics;
    y, dx, dw, db and the updated running statistics no further from
    float64 autograd of the chain than the chain's own autograd in the
    same dtype (relative gaps in norm, BN_TRAIN_ROOM and BN_TRAIN_FLOOR;
    the gradients against float64 fed each side's own ReLU mask, whose
    signs unlike float64's are counted); two launches forward and two
    backward. The row's error is the worst
    relative gap of the passes from float64. Then the forward and the
    forward + backward timed beside the plain chain's, against the bytes
    bound of 16 bytes a bf16 element (x read twice and y written forward;
    dy and x read twice and dx written backward)."""
    import torch

    from vit_cnn_tpu_torch.nn.layers import ChannelLastBatchNorm
    from vit_cnn_tpu_torch.ops import _build, bn_act, bn_train
    from vit_cnn_tpu_torch.tools import bound as _bound
    from vit_cnn_tpu_torch.tools import median_ms as _median_ms

    g = torch.Generator(device="cuda").manual_seed(SEED)
    eps = ChannelLastBatchNorm.eps
    names = ("y", "dx", "dw", "db", "running mean", "running var")

    def gap(got, want):
        return float((got.double() - want).norm() / want.norm())

    def layer(module, x, dy, weight, bias, kernels, backward=True,
              relu=True):
        """y and x (its gradient taken where ``backward``) of ``module``'s
        train-mode forward, with the ReLU where ``relu``, by the passes or
        (``kernels`` False) the plain chain."""
        real = bn_train.engages
        if not kernels:
            bn_train.engages = lambda t: False
        try:
            xs = x.detach().requires_grad_(backward)
            y = torch.func.functional_call(
                module, {"weight": weight, "bias": bias}, (xs,),
                {"relu": relu})
            if backward:
                y.backward(dy)
        finally:
            bn_train.engages = real
        return y, xs

    def results(module, x, dy, weight, bias, kernels, relu=True):
        """(y, dx, dw, db, running mean, running var) of one step on fresh
        leaves, the running statistics starting at 0 and 1."""
        with torch.no_grad():
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
        w, b = (t.detach().requires_grad_() for t in (weight, bias))
        y, xs = layer(module, x, dy, w, b, kernels, relu=relu)
        return (y.detach(), xs.grad, w.grad, b.grad,
                module.running_mean.clone(), module.running_var.clone())

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        shape = BN_TRAIN_SHAPE if dtype == torch.bfloat16 else (
            BN_TRAIN_SHAPE[0] // 10,) + BN_TRAIN_SHAPE[1:]
        c = shape[-1]
        x = (torch.randn(shape, generator=g, device="cuda")
             + torch.randn(c, generator=g, device="cuda")).to(dtype)
        dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
        weight, bias = ((s + 0.2 * torch.randn(c, generator=g, device="cuda"))
                        .to(dtype).requires_grad_() for s in (1.0, 0.0))
        module = ChannelLastBatchNorm(c).cuda().train()

        sums = bn_train.moments(x)
        x64 = x.double().reshape(-1, c)
        s1, s2 = x64.sum(0), (x64 * x64).sum(0)
        got = sums.double()
        moments_gap = max(
            float(((got[:c] - s1).abs() / x64.abs().sum(0)).max()),
            float(((got[c:2 * c] - s2).abs() / s2).max()))
        del x64, s1, s2
        if not moments_gap <= BN_TRAIN_MOMENTS or got[-1] != x.numel() // c:
            raise Failed("bn_train {} at {}: the moments lie {:.3g} from "
                         "float64's sums (limit {:g}) or miscount the rows"
                         .format(dn, shape, moments_gap, BN_TRAIN_MOMENTS))
        mean, var, _ = bn_train.statistics(sums)
        want = bn_act.normalize(x.float(), mean, var, weight.detach(),
                                bias.detach(), eps, dtype, True)
        before = _build.launches["bn_train"]
        passes = results(module, x, dy, weight, bias, True)
        torch.cuda.synchronize()
        ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
        if (_build.launches["bn_train"] != before + 4
                or not torch.equal(passes[0].view(ints), want.view(ints))):
            raise Failed("bn_train {} at {}: the forward differs from "
                         "normalize of its own statistics, or it did not "
                         "launch 4 times".format(dn, shape))
        del want
        chain = results(module, x, dy, weight, bias, False)
        if _build.launches["bn_train"] != before + 4:
            raise Failed("bn_train {} at {}: the plain chain launched the "
                         "passes".format(dn, shape))
        wide = [t.double() for t in (x, dy, weight, bias)]
        ref = results(module.double(), *wide, False)
        # The ReLU's gradient steps at 0, and a float32 forward and
        # float64's give a different sign on about one element in 10^7;
        # one such element moves dx by ~1/sqrt(elements) of its norm, on
        # either side, by chance. So each side's gradients are held to
        # float64 autograd of the chain before the ReLU, fed dy masked by
        # that side's own output (the mask its backward applies).
        flips = [int(((side[0] > 0) != (ref[0] > 0)).sum())
                 for side in (passes, chain)]
        own = [ref[:1] + results(module, wide[0], wide[1] * (side[0] > 0),
                                 *wide[2:], False, relu=False)[1:4] + ref[4:]
               for side in (passes, chain)]
        module.float()
        worst, gaps = 0.0, []
        for name, a, p, wa, wp in zip(names, passes, chain, *own):
            ga, gp = gap(a, wa), gap(p, wp)
            worst = max(worst, ga)
            gaps.append("{} {:.3g} ({:.3g})".format(name, ga, gp))
            if a.dtype != p.dtype or not ga <= max(BN_TRAIN_ROOM * gp,
                                                  BN_TRAIN_FLOOR):
                raise Failed("bn_train {} at {}: {} lies {:.4g} from float64 "
                             "autograd of the chain, the chain's own {} "
                             "{:.4g} (limit: {} x it, at least {:.3g})"
                             .format(dn, shape, name, ga, p.dtype, gp,
                                     BN_TRAIN_ROOM, BN_TRAIN_FLOOR))
        del ref, own, chain
        t = p = t_fwd = p_fwd = bound = None
        line = ""
        if dtype == torch.bfloat16:
            stats = [torch.zeros(c, device="cuda"),
                     torch.ones(c, device="cuda")]

            def pair(backward=True):
                xs = x.detach().requires_grad_(backward)
                y = bn_train.bn_train(xs, weight, bias, *stats, eps, 0.9,
                                      True)
                if backward:
                    y.backward(dy)
                return y

            def plain(backward=True):
                return layer(module, x, dy, weight, bias, False, backward)[0]

            with torch.no_grad():
                t_fwd = _median_ms(lambda: pair(False))
                p_fwd = _median_ms(lambda: plain(False), reps=3)
            t = _median_ms(pair)
            p = _median_ms(plain, reps=3)
            bound = _bound([x, x, passes[0], dy, x, dy, x, passes[1]], dn)
            line = ("; forward + backward {:.3f} ms, plain {:.3f}, bound "
                    "{:.3f} ({}), share {:.1%}; forward {:.3f} ms, plain "
                    "{:.3f}".format(t, p, *bound, bound[0] / t, t_fwd,
                                    p_fwd))
        print("  {:<44s} {:<8s} moments {:.3g} from float64, forward equal "
              "bit for bit; ReLU signs unlike float64's {} ({}); from "
              "float64 (chain's): {}{}".format(
                  "bn_train {}".format(shape), dn, moments_gap, *flips,
                  ", ".join(gaps), line), flush=True)
        _record(rows, "bn_train", worst, dn, t, p, bound,
                **({} if t is None else {"forward_ms": t_fwd,
                                         "plain_forward_ms": p_fwd}))
        del x, dy, passes
    torch.cuda.synchronize()


def _bands(h, w, p, chunk):
    """Bands of one full-scene request (infer/fullscene.py): origin rows
    in bands of as many rows as ``chunk`` windows hold."""
    total, wc = h - p + 1, w - p + 1
    rows = max(1, min(total, chunk // max(wc, 1)))
    return -(-total // rows)


def _heads_qkv(g, B, n, h, hd, dtype):
    """q, k, v as the ViT hands them to K8: (B, n, h, hd) views of one
    fused (B, n, 3 h hd) projection."""
    import torch

    qkv = torch.randn((B, n, 3 * h * hd), generator=g, device="cuda")
    return tuple(t.view(B, n, h, hd) for t in qkv.to(dtype).chunk(3, -1))


def phase_heads_kernels(rows):
    """K8 and K9 against their plain versions at every zoo band shape, a
    ragged batch, one token, 17 tokens (a last key tile that is mostly
    padding), odd hd (5) and the 512-token limit at C = 256 (in bf16 the
    heads split over blocks); timed in both dtypes at the ViT and
    SpectralFormer bands (K8) and MHST's pooled band (K9) beside the plain
    versions, SDPA and, for K9, the plain group LayerNorm followed by K8.
    The kernel table keeps the bf16 times (the serving dtype) and, under
    ``timed``, every timed shape and dtype."""
    import torch
    import torch.nn.functional as F

    from vit_cnn_tpu_torch.ops import attention
    from vit_cnn_tpu_torch.tools import bound as _bound
    from vit_cnn_tpu_torch.tools import median_ms as _median_ms

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    record = functools.partial(_record, rows)
    mhst_b, sf_b = ZOO_BANDS["MHST"], ZOO_BANDS["SpectralFormer"]
    bands = {mhst_b: "ViT band", sf_b: "SpectralFormer band"}
    # (B, n, h, hd); the residual on and off except at the two long bands
    k8_cases = [(mhst_b, 65, 4, 16), (sf_b, 146, 4, 16),
                (ZOO_BANDS["S2EFT"], 145, 4, 16), (RAGGED, 65, 4, 16),
                (RAGGED, 1, 4, 16), (RAGGED, 17, 4, 16), (7, 65, 4, 5),
                (2, 512, 8, 32)]
    k9_cases = [(mhst_b, 65, 16, 4), (RAGGED, 65, 16, 4), (RAGGED, 1, 16, 4),
                (RAGGED, 17, 16, 4), (7, 65, 4, 5), (2, 512, 1, 32)]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for B, n, h, hd in k8_cases:
            for res in ((False,) if n in (145, 146) else (False, True)):
                q, k, v = _heads_qkv(g, B, n, h, hd, dtype)
                scale = hd ** -0.5
                got = attention.fused_attention_heads(q, k, v, scale, res)
                want = attention.attention_reference_heads(q, k, v, scale,
                                                           res)
                err = _compare("K8 heads attention B={} n={} {}x{}{}".format(
                    B, n, h, hd, " +q" if res else ""), got, want, dn)
                t = p = bnd = None
                extra = {}
                if not res and B in bands:
                    t = _median_ms(lambda: attention.fused_attention_heads(
                        q, k, v, scale))
                    p = _median_ms(
                        lambda: attention.attention_reference_heads(
                            q, k, v, scale), reps=3)
                    lib = _median_ms(lambda: F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), scale=scale))
                    bnd = _bound([q, k, v, got], dn, exps=B * h * n * n,
                                 flops=4 * B * h * n * n * hd)
                    print("    {} n={} {}: kernel {:.3f} ms, plain {:.3f}, "
                          "sdpa {:.3f}, bound {:.3f} ({}); K8 {} / SDPA "
                          "{:.3f}".format(bands[B], n, dn, t, p, lib, *bnd,
                                          dn, t / lib), flush=True)
                    _timed(rows, "fused_attention_heads",
                           "{} (B={}, n={}, {}x{})".format(bands[B], B, n, h,
                                                           hd), dn,
                           ms=t, plain_ms=p, library_ms=lib,
                           bound_ms=bnd[0], bound_by=bnd[1])
                    extra = {"library_ms": lib}
                    if dtype != torch.bfloat16 or B != mhst_b:
                        t = p = bnd = None          # the row keeps bf16's
                        extra = {}
                record("fused_attention_heads", err, dn, t, p, bnd, **extra)
                del q, k, v, got, want
        for B, n, h, hd in k9_cases:
            c = h * hd
            q, k, v = (torch.randn((B, n, c), generator=g, device="cuda")
                       .to(dtype) for _ in range(3))
            lns = [((1 + 0.2 * torch.randn(hd, generator=g, device="cuda"))
                    .to(dtype), (0.1 * torch.randn(hd, generator=g,
                                                   device="cuda")).to(dtype))
                   for _ in range(3)]
            scale = hd ** -0.5
            got = attention.pooled_heads_attention_auto(q, k, v, *lns, h,
                                                        scale)
            # float32: against the plain version in float64 (K9 takes its
            # LN statistics in float64 there; in float32 the fast variance
            # of a group with a large mean cancels, the plain version's too)
            wide = (lambda x: x.double()) if dtype == torch.float32 else (
                lambda x: x)
            want = attention.pooled_attention_reference(
                wide(q), wide(k), wide(v),
                *[tuple(map(wide, ln)) for ln in lns], h, scale)
            err = _compare("K9 pooled attention B={} n={} {}x{}".format(
                B, n, h, hd), got, want, dn)
            t = p = bnd = None
            extra = {}
            if B == mhst_b:
                if dtype == torch.float32:
                    # the float32 plain version's own distance from float64
                    plain32 = attention.pooled_attention_reference(
                        q, k, v, *lns, h, scale)
                    spread = float((plain32.double() - want).abs().max())
                    print("    plain float32 vs float64: max|diff| {:.3e}"
                          .format(spread), flush=True)
                    _record(rows, "pooled_heads_attention", 0.0, dn)
                    rows["pooled_heads_attention"]["plain_f32_vs_f64"] = \
                        spread
                    del plain32
                t = _median_ms(lambda: attention.pooled_heads_attention_auto(
                    q, k, v, *lns, h, scale))
                p = _median_ms(lambda: attention.pooled_attention_reference(
                    q, k, v, *lns, h, scale), reps=3)

                def composition():
                    heads = lambda x, ln: attention.ln_groups_reference(
                        x, *ln, hd).view(B, n, h, hd)
                    return attention.fused_attention_heads(
                        heads(q, lns[0]), heads(k, lns[1]), heads(v, lns[2]),
                        scale, True)

                comp = _median_ms(composition)
                bnd = _bound([q, k, v, *[x for ln in lns for x in ln], got],
                             dn, exps=B * h * n * n,
                             flops=4 * B * h * n * n * hd)
                print("    MHST pooled band {}: kernel {:.3f} ms, plain "
                      "{:.3f}, group LN + K8 {:.3f}, bound {:.3f} ({})"
                      .format(dn, t, p, comp, *bnd), flush=True)
                _timed(rows, "pooled_heads_attention",
                       "MHST pooled band (B={}, n={}, {}x{})".format(
                           B, n, h, hd), dn, ms=t, plain_ms=p,
                       composition_ms=comp, bound_ms=bnd[0],
                       bound_by=bnd[1])
                extra = {"composition_ms": comp}
                if dtype != torch.bfloat16:
                    t = p = bnd = None
                    extra = {}
            record("pooled_heads_attention", err, dn, t, p, bnd, **extra)
            del q, k, v, got, want
    torch.cuda.synchronize()


def phase_adjoints(rows):
    """K5-K7 against autograd through the plain forwards at the train
    shapes, then every autograd Function's gradients against autograd
    through its plain version; adds to the JSON rows."""
    import torch

    from vit_cnn_tpu_torch.ops import attention, dirstream, selective_scan
    from vit_cnn_tpu_torch.tools import bound as _bound
    from vit_cnn_tpu_torch.tools import median_ms as _median_ms
    from vit_cnn_tpu_torch.tools import scan_inputs as _scan_inputs

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")

    record = functools.partial(_record, rows)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for (L, d) in ((81, 72), (49, 128)):
            for b in (TRAIN_BATCH, RAGGED):
                train = dtype == torch.bfloat16 and b == TRAIN_BATCH
                main = train and L == 81
                for ns, rev in ((6, False), (4, True)):
                    args = _scan_inputs(g, ns, L, d, 16, b, dtype)
                    cot = randn(ns, L, d, b).to(dtype)
                    got = selective_scan.selective_scan_backward(
                        *args, cot, reverse=rev)
                    want = selective_scan.selective_scan_backward_reference(
                        *args, cot, rev)
                    err = _compare("K5 scan bwd ns={} L={} d={} b={}{}".format(
                        ns, L, d, b, " rev" if rev else ""), got, want, dn,
                        summed=range(6))
                    t = p = bound = None
                    if train:
                        # each of the train step's four K5 launches
                        t = _median_ms(
                            lambda: selective_scan.selective_scan_backward(
                                *args, cot, reverse=rev))
                        bound = _bound(list(args) + [cot, *got], dn,
                                       exps=ns * L * d * 16 * b)
                        print("  K5 {} ns={} L={} d={} b={}: {:.3f} ms, "
                              "bound {:.3f} ms ({}), share {:.1%}".format(
                                  dn, ns, L, d, b, t, bound[0], bound[1],
                                  bound[0] / t), flush=True)
                    if main and not rev:
                        p = _median_ms(lambda: selective_scan.
                                       selective_scan_backward_reference(
                                           *args, cot, rev), reps=3)
                    else:
                        t = bound = None
                    record("selective_scan_backward", err, dn, t, p, bound)
                    del args, cot, got, want
                orders, inv, rev_rows = _tables(L)
                u = randn(L, d, b).to(dtype)
                cw, cb = 0.5 * randn(4, d), 0.1 * randn(d)
                gf, gr = randn(6, L, d, b).to(dtype), randn(4, L, d, b).to(
                    dtype)
                bwd = lambda: dirstream.dir_conv_silu_backward(
                    u, cw, cb, orders, rev_rows, gf, gr)
                plain = lambda: dirstream.dir_conv_silu_backward_reference(
                    u, cw, cb, orders, rev_rows, gf, gr)
                out = bwd()
                err = _compare("K6 dir_conv_silu bwd L={} d={} b={}".format(
                    L, d, b), out, plain(), dn, summed=(1, 2))
                stage = "train stage {} (L={}, d={}, b={})".format(
                    1 if L == 81 else 2, L, d, b)
                t = p = bound = None
                if train:                     # timed, both stages
                    t, p = _median_ms(bwd), _median_ms(plain, reps=3)
                    # one sigmoid exp per stream output
                    bound = _bound([u, cw, cb, orders, rev_rows, gf, gr,
                                    *out], dn, exps=10 * L * d * b)
                    print("    K6 {}: kernel {:.3f} ms, plain {:.3f}, bound "
                          "{:.3f} ({}), share {:.1%}".format(
                              stage, t, p, *bound, bound[0] / t), flush=True)
                    _timed(rows, "dir_conv_silu_backward", stage, dn, ms=t,
                           plain_ms=p, bound_ms=bound[0], bound_by=bound[1])
                    if not main:              # the table's shape
                        t = p = bound = None
                record("dir_conv_silu_backward", err, dn, t, p, bound)
                wts = torch.softmax(randn(10), 0)
                wf, wr = wts[:6], wts[6:]
                cot = randn(L, d, b).to(dtype)
                bwd = lambda: dirstream.inv_perm_weighted_sum_backward(
                    gf, gr, wf, wr, inv, rev_rows, cot)
                plain = lambda: dirstream.\
                    inv_perm_weighted_sum_backward_reference(
                        gf, gr, wf, wr, inv, rev_rows, cot)
                out = bwd()
                err = _compare("K7 inv_perm_weighted_sum bwd L={} d={} b={}"
                               .format(L, d, b), out, plain(), dn,
                               summed=(2, 3))
                t = p = bound = None
                if train:
                    t, p = _median_ms(bwd), _median_ms(plain, reps=3)
                    bound = _bound([gf, gr, wf, wr, inv, rev_rows, cot, *out],
                                   dn, flops=2 * 10 * L * d * b)
                    print("    K7 {}: kernel {:.3f} ms, plain {:.3f}, bound "
                          "{:.3f} ({}), share {:.1%}".format(
                              stage, t, p, *bound, bound[0] / t), flush=True)
                    _timed(rows, "inv_perm_weighted_sum_backward", stage, dn,
                           ms=t, plain_ms=p, bound_ms=bound[0],
                           bound_by=bound[1])
                    if not main:
                        t = p = bound = None
                record("inv_perm_weighted_sum_backward", err, dn, t, p,
                       bound)
                del u, gf, gr, cot, out

    # the autograd Functions (forward kernel, backward kernel or plain
    # formula) against autograd through the plain versions, float32
    def grads(fn, inputs, cot):
        leaves = [x.detach().requires_grad_() for x in inputs]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        if any(o.grad_fn is None for o in outs):
            raise Failed("an autograd Function's output has no grad_fn")
        torch.autograd.backward(outs, cot)
        return [x.grad for x in leaves]

    f32 = torch.float32
    args = _scan_inputs(g, 6, 81, 72, 16, RAGGED, f32)
    cot = (randn(6, 81, 72, RAGGED),)
    _compare("K1/K5 Function grads", grads(
        lambda *a: selective_scan.selective_scan(*a), args, cot), grads(
        lambda *a: selective_scan.selective_scan_reference(*a), args, cot),
        "float32", summed=range(6))
    orders, inv, rev_rows = _tables(81)
    conv_in = (randn(81, 72, RAGGED), 0.5 * randn(4, 72), 0.1 * randn(72))
    cot = (randn(6, 81, 72, RAGGED), randn(4, 81, 72, RAGGED))
    _compare("K2/K6 Function grads", grads(
        lambda *a: dirstream.dir_conv_silu(*a, orders, rev_rows), conv_in,
        cot), grads(lambda *a: dirstream.dir_conv_silu_reference(
            *a, orders, rev_rows), conv_in, cot), "float32", summed=(1, 2))
    wts = torch.softmax(randn(10), 0)
    sum_in = cot + (wts[:6], wts[6:])
    cot = (randn(81, 72, RAGGED),)
    _compare("K3/K7 Function grads", grads(
        lambda *a: dirstream.inv_perm_weighted_sum(*a, inv, rev_rows),
        sum_in, cot), grads(
        lambda *a: dirstream.inv_perm_weighted_sum_reference(
            *a, inv, rev_rows), sum_in, cot), "float32", summed=(2, 3))
    att_in = tuple(0.3 * randn(RAGGED, n, 128) for n in (49, 9, 9))
    cot = (randn(RAGGED, 49, 128),)
    _compare("K4 Function grads", grads(
        lambda *a: attention.fused_attention(*a, 1.0), att_in, cot), grads(
        lambda *a: attention.attention_reference(*a, 1.0), att_in, cot),
        "float32")
    heads_in = _heads_qkv(g, RAGGED, 65, 4, 16, f32)
    cot = (randn(RAGGED, 65, 4, 16),)
    _compare("K8 Function grads", grads(
        lambda *a: attention.fused_attention_heads(*a, 0.25), heads_in, cot),
        grads(lambda *a: attention.attention_reference_heads(*a, 0.25),
              heads_in, cot), "float32")
    pooled_in = tuple(randn(RAGGED, 65, 64) for _ in range(3)) + tuple(
        x for _ in range(3) for x in (1 + 0.2 * randn(4), 0.1 * randn(4)))
    cot = (randn(RAGGED, 65, 64),)
    # the LN scales and biases sum over every token and head
    _compare("K9 Function grads", grads(
        lambda *a: attention.pooled_heads_attention(*a, 16, 0.5), pooled_in,
        cot), grads(lambda q, k, v, a, b, c, d, e, f:
                    attention.pooled_attention_reference(
                        q, k, v, (a, b), (c, d), (e, f), 16, 0.5), pooled_in,
                    cot), "float32", summed=range(3, 9))
    torch.cuda.synchronize()


def phase_variants(rows):
    """The two sweep tools' functions (tools/scan_sweep.py,
    tools/heads_attn_variants.py) at their cases with fewer repetitions,
    plus a ragged batch and one token: every variant against its plain
    version (``tools.TOL``, as every kernel here: V1, V2 and V4 in float32
    and bf16; V3 in bf16 only, held to bf16's limit since it rounds
    P to bf16 before P.V as the TPU probes' F and G do; V1's instance at
    K1's plan also equal to K1 bit for bit, forward and reverse), timed
    beside
    K1 or K8, the plain version and SDPA. Adds rows 10-13 to the JSON
    rows (row 12 also with G's time at every bf16 sweep shape and F's at
    the hd = 16 bands, under ``timed``) and returns the run's launches
    (the path ``sweep``)."""
    import torch

    from vit_cnn_tpu_torch.ops import _build
    from vit_cnn_tpu_torch.tools import (all_ok, heads_attn_variants,
                                         scan_sweep)

    _build.launches.clear()
    t0 = time.perf_counter()
    scans, heads = [], []
    for case in scan_sweep.CASES + RAGGED_SCANS:
        for dtype in scan_sweep.DTYPES:
            scans.append(scan_sweep.sweep(*case, dtype, reps=SWEEP_REPS,
                                          plain_reps=SWEEP_PLAIN_REPS))
            print("[variants] {}".format(json.dumps(scans[-1])), flush=True)
            torch.cuda.empty_cache()
    for shape in heads_attn_variants.SHAPES + RAGGED_HEADS:
        for dtype in heads_attn_variants.DTYPES:
            heads.append(heads_attn_variants.sweep(
                *shape, dtype, reps=SWEEP_REPS, plain_reps=SWEEP_PLAIN_REPS))
            print("[variants] {}".format(json.dumps(heads[-1])), flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()     # the float32 scans' GBs, unused after
    counts = dict(_build.launches)
    print("[variants] {}".format(json.dumps(scan_sweep.summary(scans))),
          flush=True)
    print("[variants] {}".format(json.dumps(
        heads_attn_variants.summary(heads))), flush=True)
    print("[variants] {:.1f} s, launches {}".format(
        time.perf_counter() - t0, json.dumps(counts)), flush=True)
    bad = [(r.get("case", r.get("shape")), r["dtype"], r.get("reverse"),
            [v["variant"] for v in r["variants"] if not v["ok"]])
           for r in scans + heads if not all_ok(r)]
    if bad:
        raise Failed("variants disagree with their plain versions (V1's "
                     "instance at K1's plan: or with K1): {}".format(bad))
    missing = [k for k in VARIANTS if counts.get(k, 0) <= 0]
    if missing:
        raise Failed("variant kernels never launched: {}".format(missing))

    record = functools.partial(_record, rows)
    for r in scans + heads:
        for v in r["variants"]:
            if v["kernel"] in VARIANTS:
                record(v["kernel"], v["max_abs_err"], r["dtype"])
    # timed row: the best instance at the main band shape in bf16 (the
    # flagship's stage 1 forward over 6 streams; MHST's pooled band)
    main_scan = next(r for r in scans if r["case"] == "serving stage 1"
                     and not r["reverse"] and r["dtype"] == "bfloat16")
    main_heads = next(r for r in heads if r["shape"] == "MHST pooled band"
                      and r["dtype"] == "bfloat16")
    for key, res in ((VARIANTS[0], main_scan), (VARIANTS[1], main_scan),
                     (VARIANTS[2], main_heads), (VARIANTS[3], main_heads)):
        best = min((v for v in res["variants"] if v["kernel"] == key),
                   key=lambda v: v["ms"])
        record(key, 0.0, "bfloat16", best["ms"], best["plain_ms"],
               (res["bound_ms"], res["bound_by"]), share=best["share"],
               best=best["variant"], library_ms=best.get("library_ms"))
    # V3's own entries: G (masked) at every bf16 sweep shape, F at the
    # hd = 16 bands (its wgmma form), each with its bound, share and SDPA
    shapes = {shape[0] for shape in heads_attn_variants.SHAPES}
    for r in heads:
        if r["dtype"] != "bfloat16" or r["shape"] not in shapes:
            continue
        for v in r["variants"]:
            if v["variant"] == "V3 masked" or (
                    v["variant"] == "V3 per-head" and r["hd"] == 16):
                _timed(rows, VARIANTS[2], "{}, {}".format(
                    r["shape"], v["variant"]), "bfloat16", ms=v["ms"],
                    bound_ms=v["bound_ms"], share=v["share"],
                    plain_ms=v["plain_ms"], library_ms=v["library_ms"])
    # V3 has no float32 path: its error is its bf16 one
    rows[VARIANTS[2]]["max_abs_err"] = rows[VARIANTS[2]]["max_abs_err_bf16"]
    return counts


def _seeded_state(name, n_bands, n_classes):
    """The seeded state_dict of a registered model (convert.py)."""
    from vit_cnn_tpu_torch.convert import seeded_state_dict
    from vit_cnn_tpu_torch.models.registry import get_model

    model = get_model(name, n_classes=n_classes, n_bands=n_bands)[0]
    return seeded_state_dict(model, SEED)


def phase_slice(tmp):
    import numpy as np

    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.cli import build_parser, run_serve
    from vit_cnn_tpu_torch.ops import _build

    img1, img2, gt = get_dataset("Synthetic", tmp)[:3]
    h, w = img1.shape[:2]
    n_classes = int(SCENE["VCT_SYN_CLASSES"])
    windows = (h - 8) * (w - 8)
    print("[slice] scene {} x {} x {} + {}, {} windows".format(
        h, w, img1.shape[2], img2.shape[2], windows), flush=True)
    state = _seeded_state("Multimodality_Mamba",
                          (img1.shape[2], img2.shape[2]), n_classes)
    gt_path = os.path.join(tmp, "gt.npy")
    np.save(gt_path, gt)
    out, pred = os.path.join(tmp, "probs.npy"), os.path.join(tmp, "pred.npy")
    requests = [{}, {}, {"pred": pred, "out": out, "gt": gt_path},
                {"cmd": "quit"}]
    args = build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", tmp, "--model",
        "Multimodality_Mamba", "--bf16", "--serve", "--seed", str(SEED)])
    in_s = io.StringIO("\n".join(json.dumps(r) for r in requests) + "\n")
    out_s = io.StringIO()
    _build.launches.clear()
    served = run_serve(args, in_stream=in_s, out_stream=out_s,
                       state_dict=state)
    counts = dict(_build.launches)
    resps = [json.loads(l) for l in out_s.getvalue().splitlines() if l]
    for r in resps:
        print("[slice] response {}".format(json.dumps(r)), flush=True)
        if r.get("ok"):
            print("[slice]   {:.3f} s/request, {:.0f} windows/s".format(
                r["seconds"], windows / r["seconds"]), flush=True)
    if served != 3 or len(resps) != 3 or not all(r["ok"] for r in resps):
        raise Failed("serving did not answer 3 requests ok")
    probs = np.load(out)
    finite = bool(np.isfinite(probs).all())
    print("[slice] map {} finite={} max|p|={:.4f}".format(
        probs.shape, finite, float(np.abs(probs).max())), flush=True)
    if probs.shape != (h, w, n_classes) or not finite:
        raise Failed("bad map")
    print("[slice] launches {}".format(json.dumps(counts)), flush=True)
    missing = [k for k in ("selective_scan", "dir_conv_silu",
                           "inv_perm_weighted_sum", "fused_attention",
                           "bn_act") if counts.get(k, 0) <= 0]
    if missing:
        raise Failed("kernels never launched on the main path: {}".format(
            missing))
    bn = BN_SITES["Multimodality_Mamba"] * _bands(
        h, w, 9, args.infer_chunk) * served
    if counts["bn_act"] != bn:
        raise Failed("bn_act launched {} times, not once a BatchNorm and "
                     "band ({})".format(counts["bn_act"], bn))
    _check_bn_train(counts, "Multimodality_Mamba", 0, "slice")
    return counts, resps, state


def phase_crop(tmp, state):
    import numpy as np
    import torch

    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.infer.fullscene import full_scene_probabilities
    from vit_cnn_tpu_torch.models.registry import get_model

    img1, img2 = (x[:12, :64] for x in get_dataset("Synthetic", tmp)[:2])
    n_classes = int(SCENE["VCT_SYN_CLASSES"])

    def serve(device, bf16):
        model, _, hp = get_model("Multimodality_Mamba", n_classes=n_classes,
                                 n_bands=(img1.shape[2], img2.shape[2]))
        model.load_state_dict(state)
        model.to(device).eval()
        return full_scene_probabilities(model, img1, img2,
                                        dict(hp, bf16=bf16))

    cpu = serve("cpu", False)
    f32 = serve("cuda", False)
    b16 = serve("cuda", True)
    inner = (slice(4, 12 - 4), slice(4, 64 - 4))     # window centers
    scale = max(1.0, float(np.abs(cpu).max()))
    d32 = float(np.abs(f32 - cpu).max())
    d16 = float(np.abs(b16 - cpu).max())
    agree32 = float((f32[inner].argmax(-1) == cpu[inner].argmax(-1)).mean())
    agree16 = float((b16[inner].argmax(-1) == cpu[inner].argmax(-1)).mean())
    print("[crop] card f32 vs cpu f32: max|diff| {:.3e} (limit {:.1e}), "
          "argmax agreement {:.4f}".format(d32, CROP_TOL * scale, agree32),
          flush=True)
    print("[crop] card bf16 vs cpu f32: max|diff| {:.3e}, argmax agreement "
          "{:.4f} (limit 0.99) over {} windows".format(
              d16, agree16, cpu[inner].shape[0] * cpu[inner].shape[1]),
          flush=True)
    if d32 > CROP_TOL * scale or agree16 < 0.99:
        raise Failed("crop map disagrees with the CPU plain path")


def _bn_train_launches(name, steps):
    """Train-mode BatchNorm's launches in ``steps`` train steps of
    ``name``: BN_TRAIN_PER_SITE a BatchNorm a step, one fewer a BatchNorm
    of an input (BN_INPUTS)."""
    return (BN_SITES[name] * BN_TRAIN_PER_SITE
            - BN_INPUTS.get(name, 0)) * steps


def _check_bn_train(counts, name, steps, where):
    """The train-mode BatchNorm passes launched exactly as ``steps`` train
    steps of ``name`` call them."""
    want = _bn_train_launches(name, steps)
    if counts.get("bn_train", 0) != want:
        raise Failed("{}: bn_train launched {} times in {} steps, not {} "
                     "({} a BatchNorm a step, {} of its {} input "
                     "BatchNorms)".format(
                         where, counts.get("bn_train", 0), steps, want,
                         BN_TRAIN_PER_SITE, BN_TRAIN_PER_SITE - 1,
                         BN_INPUTS.get(name, 0)))


def _check_counts(counts, steps, where):
    """Every kernel launched; the adjoints exactly once per backward per
    use site, train-mode BatchNorm's passes BN_TRAIN_PER_SITE times a
    BatchNorm a step."""
    print("[{}] launches {}".format(where, json.dumps(counts)), flush=True)
    missing = [k for k in FORWARD + ADJOINTS + BN_TRAIN
               if counts.get(k, 0) <= 0]
    if missing:
        raise Failed("kernels never launched in {}: {}".format(where,
                                                              missing))
    if steps is not None:
        off = {k: counts.get(k, 0) for k in ADJOINTS
               if counts.get(k, 0) != PER_STEP[k] * steps}
        if off:
            raise Failed("{}: {} steps but adjoint launches {}".format(
                where, steps, off))
        _check_bn_train(counts, "Multimodality_Mamba", steps, where)


def phase_train(tmp, state):
    """The CLI's training run at full width, then steady steps."""
    import numpy as np
    import torch

    from vit_cnn_tpu_torch.cli import build_parser, run_train
    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.ops import _build
    from vit_cnn_tpu_torch.tools import train_step

    args = build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", tmp, "--model",
        "Multimodality_Mamba", "--bf16", "--batch_size", str(TRAIN_BATCH),
        "--flip_augmentation", "--epoch", "3", "--training_sample", "200",
        "--log_every", "1", "--seed", str(SEED)])
    _build.launches.clear()
    t0 = time.perf_counter()
    result = run_train(args, state_dict=state)
    wall = time.perf_counter() - t0
    counts = dict(_build.launches)
    print("[train] run_train {:.1f} s: {} centers, epoch losses {}, val {}, "
          "OA {:.2f} AA {:.4f} Kappa {:.4f}".format(
              wall, result["train_samples"], result["losses"],
              result["val_accuracies"], result["OA"], result["AA"],
              result["Kappa"]), flush=True)
    if not all(np.isfinite(result["losses"])):
        raise Failed("non-finite epoch loss")
    steps_per_epoch = -(-result["train_samples"] // TRAIN_BATCH)
    _check_counts(counts, steps_per_epoch * result["epochs"], "train")

    # steady steps on one fixed batch (as bench.py's measure_train_ours)
    trainer, step_args = train_step(
        get_dataset("Synthetic", tmp)[:3], state, "cuda", TRAIN_BATCH,
        bf16=True, flip=True, seed=SEED)
    first = trainer._step(*step_args)                      # not timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    losses = []
    t0 = time.perf_counter()
    for _ in range(STEADY_STEPS):
        losses.append(trainer._step(*step_args))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts_steady = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(first)] + [float(x) for x in losses]
    ms = 1e3 * secs / STEADY_STEPS
    print("[train] steady: {} steps of {} in {:.3f} s: {:.2f} ms/step, "
          "{:.0f} patches/s, peak device memory {:.2f} GB".format(
              STEADY_STEPS, TRAIN_BATCH, secs, ms,
              STEADY_STEPS * TRAIN_BATCH / secs, peak / 1e9), flush=True)
    print("[train] steady losses {}".format(
        " ".join("{:.4f}".format(x) for x in losses)), flush=True)
    if not all(np.isfinite(losses)):
        raise Failed("non-finite loss in the steady steps")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise Failed("the loss did not fall over the steady steps")
    _check_counts(counts_steady, STEADY_STEPS, "train steady")
    off = [k for k, p in trainer.model.named_parameters()
           if p.dtype != torch.float32]
    if off:
        raise Failed("bf16 training changed parameter dtypes: {}".format(off))
    return counts, {"ms_per_step": ms,
                    "patches_per_s": STEADY_STEPS * TRAIN_BATCH / secs,
                    "peak_gb": peak / 1e9}


def phase_train_crop(tmp, state):
    """One float32 step on the card and on the CPU from the same weights
    and centers; and the card's bf16 loss against its float32 one."""
    import numpy as np
    import torch

    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.models.registry import get_model
    from vit_cnn_tpu_torch.tools import train_step

    scene = tuple(x[:40, :200] for x in get_dataset("Synthetic", tmp)[:3])
    img1, img2, _ = scene
    n_classes = int(SCENE["VCT_SYN_CLASSES"])

    def one_step(device, bf16):
        trainer, step_args = train_step(scene, state, device, 32,
                                        bf16=bf16, seed=SEED)
        loss = trainer._step(*step_args)
        model = trainer.model
        grads = {k: p.grad.detach().cpu() for k, p in
                 model.named_parameters()}
        stats = {k: v.detach().cpu() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        return float(loss), grads, stats

    loss_cpu, g_cpu, s_cpu = one_step("cpu", False)
    loss_gpu, g_gpu, s_gpu = one_step("cuda", False)
    loss_b16 = one_step("cuda", True)[0]
    floor = GRAD_ATOL * max(float(g.norm()) for g in g_cpu.values())
    worst_g = max((float((g_gpu[k] - g).norm()) / (GRAD_TOL * float(g.norm())
                                                  + floor), k)
                  for k, g in g_cpu.items())
    worst_s = max((float((s_gpu[k] - v).abs().max())
                   / (STAT_TOL * float(v.abs().max())), k)
                  for k, v in s_cpu.items())
    dl = abs(loss_gpu - loss_cpu)
    db = abs(loss_b16 - loss_gpu) / abs(loss_gpu)
    print("[train-crop] loss card f32 {:.6f} cpu f32 {:.6f} |diff| {:.2e}"
          .format(loss_gpu, loss_cpu, dl), flush=True)
    print("[train-crop] {} gradients: worst ||diff|| is {:.3f} of its limit "
          "({}; limit {:g} x ||cpu|| + {:.2e})".format(
              len(g_cpu), worst_g[0], worst_g[1], GRAD_TOL, floor),
          flush=True)
    print("[train-crop] {} BN statistics: worst max|diff| is {:.3f} of its "
          "limit ({}; limit {:g} x max|cpu|)".format(
              len(s_cpu), worst_s[0], worst_s[1], STAT_TOL), flush=True)
    print("[train-crop] card bf16 loss {:.6f}: {:.2%} from f32 (limit "
          "{:.0%})".format(loss_b16, db, BF16_LOSS_TOL), flush=True)

    # each Mamba backbone alone, card against CPU, a seeded cotangent
    model = get_model("Multimodality_Mamba", n_classes=n_classes,
                      n_bands=(img1.shape[2], img2.shape[2]))[0]
    model.load_state_dict(state)
    rng = np.random.RandomState(SEED)
    worst_b = (0.0, "")
    for blk in ("hsi1", "hsi2"):
        net = getattr(model, blk).global_view
        side = int(round(net.pos_embed.shape[1] ** 0.5))
        x = rng.randn(32, side, side, net.embed_dims).astype(np.float32)
        cot = rng.randn(32, side, side, net.embed_dims).astype(np.float32)
        grads = {}
        for device in ("cpu", "cuda"):
            net.to(device).zero_grad(set_to_none=True)
            xt = torch.tensor(x, device=device, requires_grad=True)
            net(xt).backward(torch.tensor(cot, device=device))
            # copies: moving the module to the card moves its grads too
            grads[device] = {"input": xt.grad.to("cpu", copy=True), **{
                k: p.grad.to("cpu", copy=True)
                for k, p in net.named_parameters()}}
        for k, want in grads["cpu"].items():
            ratio = float((grads["cuda"][k] - want).abs().max()) / (
                BACKBONE_TOL * float(want.abs().max()))
            worst_b = max(worst_b, (ratio, "{}.{}".format(blk, k)))
    print("[train-crop] Mamba backbones alone: worst max|diff| is {:.3f} of "
          "its limit ({}; limit {:g} x max|cpu|)".format(
              worst_b[0], worst_b[1], BACKBONE_TOL), flush=True)
    if dl > 1e-3 * abs(loss_cpu) or worst_g[0] > 1.0 or worst_s[0] > 1.0 \
            or worst_b[0] > 1.0 or db > BF16_LOSS_TOL:
        raise Failed("the card's train step disagrees with the CPU's")


def _resume_trainer(scene, state, train_gt, seed, epochs):
    """A float32 Trainer of the flagship on the card from ``state``:
    batch 1024, flip on, no val pipeline (the metric is -loss), no
    checkpoint files."""
    from vit_cnn_tpu_torch.models.registry import get_model
    from vit_cnn_tpu_torch.pipeline.patches import AugmentConfig, \
        PatchPipeline
    from vit_cnn_tpu_torch.train.loop import Trainer

    img1, img2, _ = scene
    n_classes = int(SCENE["VCT_SYN_CLASSES"])
    model, _, hp = get_model(
        "Multimodality_Mamba", dataset="Synthetic", n_classes=n_classes,
        n_bands=(img1.shape[2], img2.shape[2]), ignored_labels=[0],
        batch_size=TRAIN_BATCH, epoch=epochs, flip_augmentation=True)
    model.load_state_dict(state)
    model.to("cuda")
    pipe = PatchPipeline(img1, img2, train_gt, hp["patch_size"], [0],
                         n_classes, augment=AugmentConfig(flip=True),
                         device="cuda")
    return Trainer(model, hp, pipe, seed=seed, save_checkpoints=False)


def _trajectory_diff(a, b):
    """Largest relative difference of two trainers' last epochs' losses
    and final state: |loss diff| / |loss|, and per tensor max|diff| /
    max|a|."""
    n = len(b.log.losses)
    worst = max(abs(x - y) / abs(x) for x, y in zip(a.log.losses[-n:],
                                                   b.log.losses))
    sb = b.model.state_dict()
    for k, v in a.model.state_dict().items():
        top = float(v.abs().max())
        if top > 0:
            worst = max(worst, float((sb[k] - v).abs().max()) / top)
    return worst


def _resume_check(tmp, scene, state, deterministic):
    """3 unbroken float32 epochs twice (their spread), and 2 + save +
    restore into a trainer of another seed + 1; with ``deterministic``,
    under cuDNN's deterministic algorithms and
    ``torch.use_deterministic_algorithms``."""
    import torch

    before = (torch.backends.cudnn.deterministic,
              torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = deterministic
    torch.use_deterministic_algorithms(deterministic)
    try:
        return _resume_runs(tmp, scene, state)
    finally:
        torch.backends.cudnn.deterministic = before[0]
        torch.use_deterministic_algorithms(before[1])


def _resume_runs(tmp, scene, state):
    import numpy as np

    from vit_cnn_tpu_torch.data.sampling import sample_gt

    np.random.seed(SEED)
    train_gt = sample_gt(scene[2], 200, mode="random_fixednumber",
                         seed=SEED)[0]
    unbroken = []
    for _ in range(2):
        t = _resume_trainer(scene, state, train_gt, SEED, RESUME_EPOCHS)
        t.fit(dataset_name="Synthetic")
        unbroken.append(t)
    first = _resume_trainer(scene, state, train_gt, SEED, RESUME_SAVED)
    first.fit(dataset_name="Synthetic")
    path = first.save_resumable(os.path.join(tmp, "resume", "state"),
                                epoch=RESUME_SAVED)
    resumed = _resume_trainer(scene, state, train_gt, SEED + 123,
                              RESUME_EPOCHS)
    start = resumed.restore_resumable(path)
    resumed.fit(dataset_name="Synthetic", start_epoch=start)
    spread = _trajectory_diff(unbroken[0], unbroken[1])
    diff = _trajectory_diff(unbroken[0], resumed)
    return start, spread, diff, unbroken[0].log.losses, resumed.log.losses


def phase_runloop(tmp, state, card):
    """The CLI's run loop at full width in a working directory of its own,
    run 1's best file served back through --serve --restore, and resume at
    full width in float32. Returns the run loop's kernel launches."""
    import contextlib
    import re

    import numpy as np
    import torch

    from vit_cnn_tpu_torch import cli
    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.ops import _build
    from vit_cnn_tpu_torch.train import checkpoint as ckpt
    from vit_cnn_tpu_torch.utils.viz import read_png

    work = os.path.join(tmp, "runloop")
    os.makedirs(work)
    scene = get_dataset("Synthetic", tmp)[:3]
    h, w = scene[0].shape[:2]
    n_classes = int(SCENE["VCT_SYN_CLASSES"])
    # what the runs hold in memory: each trainer's best state, each split
    trainers, splits = [], []

    class Recording(cli.Trainer):
        def fit(self, *args, **kwargs):
            self.best_state = super().fit(*args, **kwargs)
            trainers.append(self)
            return self.best_state

    def load_gt_pair(*args, **kwargs):
        splits.append(real_load(*args, **kwargs))
        return splits[-1]

    real_trainer, real_load = cli.Trainer, cli._load_gt_pair
    cwd = os.getcwd()
    os.chdir(work)                      # ./checkpoints and ./results here
    stdout = io.StringIO()
    try:
        cli.Trainer, cli._load_gt_pair = Recording, load_gt_pair
        args = cli.build_parser().parse_args([
            "--dataset", "Synthetic", "--folder", tmp, "--model",
            "Multimodality_Mamba", "--bf16", "--batch_size",
            str(TRAIN_BATCH), "--flip_augmentation", "--runs",
            str(RUNLOOP_RUNS), "--epoch", str(RUNLOOP_EPOCHS),
            "--training_sample", "200", "--out_dir",
            os.path.join(work, "results"), "--log_every", "1"])
        _build.launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            results = cli.run_experiments(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launches)
    finally:
        cli.Trainer, cli._load_gt_pair = real_trainer, real_load
        os.chdir(cwd)
    lines = [json.loads(l) for l in stdout.getvalue().splitlines() if l]
    for line in lines:
        print("[runloop] {}".format(json.dumps(line)), flush=True)
    print("[runloop] run_experiments: {} runs of {} epochs in {:.1f} s "
          "({})".format(RUNLOOP_RUNS, RUNLOOP_EPOCHS, wall, card),
          flush=True)
    if len(results) != RUNLOOP_RUNS or len(lines) != RUNLOOP_RUNS + 1 or \
            lines[-1].get("runs") != RUNLOOP_RUNS:
        raise Failed("run_experiments did not report {} runs and their "
                     "aggregate".format(RUNLOOP_RUNS))
    steps = 0
    for r in results:
        if not all(np.isfinite(r["losses"])):
            raise Failed("run {}: non-finite epoch loss".format(r["run"]))
        steps += -(-r["train_samples"] // TRAIN_BATCH) * r["epochs"]
        for kind in ("best", "final"):
            path = r[kind + "_checkpoint"] or ""
            name = r"{}_epoch/\d{{4}}(_\d\d){{5}}Multimodality_Mamba_run{}_" \
                r"epoch\d+_\d+\.\d\d\.msgpack$".format(kind, r["run"])
            if not (path.startswith("./checkpoints/multimodalitymamba/"
                                    "Synthetic/train/")
                    and re.search(name, path)
                    and os.path.isfile(os.path.join(work, path))):
                raise Failed("run {}: no {}-epoch file under the JAX name "
                             "({})".format(r["run"], kind, path))
    out = os.path.join(work, "results", "Synthetic_Multimodality_Mamba")
    with open(os.path.join(out, "report.txt")) as f:
        report = f.read()
    want = ["Confusion matrix (run:{})".format(r) for r in
            range(RUNLOOP_RUNS)] + ["Agregated results", "Kappa: "]
    if not all(x in report for x in want):
        raise Failed("report.txt lacks a run's report or the aggregate")
    for r in range(RUNLOOP_RUNS):
        for name in ("Prediction_run{}.png", "Prediction_All_run{}.png"):
            shape = read_png(os.path.join(out, name.format(r))).shape
            if shape != (h, w, 3):
                raise Failed("{} decodes to {}".format(name.format(r),
                                                       shape))
    print("[runloop] files: {} checkpoints, report and {} map PNGs of "
          "({}, {}, 3)".format(2 * RUNLOOP_RUNS, 2 * RUNLOOP_RUNS, h, w),
          flush=True)
    _check_counts(counts, steps, "runloop")

    # run 1's best file: bit for bit the best state, then served back
    run = results[-1]
    best_path = os.path.join(work, run["best_checkpoint"])
    size = os.path.getsize(best_path)
    model = trainers[-1].model
    t0 = time.perf_counter()
    restored = ckpt.restore_state_dict(best_path, model)
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = trainers[-1]._save(trainers[-1].best_state, "best_epoch", 9,
                               "rewrite", 0, 0.0)
    t_write = time.perf_counter() - t0
    off = [k for k, v in trainers[-1].best_state.items()
           if not torch.equal(restored[k], v)]
    print("[runloop] checkpoint {} bytes, write {:.3f} s, read {:.3f} s "
          "({})".format(size, t_write, t_read, card), flush=True)
    if off or set(restored) != set(trainers[-1].best_state):
        raise Failed("the best file differs from the best state: {}".format(
            off[:5]))
    os.remove(again)
    gt_path = os.path.join(work, "test_gt_run{}.npy".format(run["run"]))
    np.save(gt_path, splits[-1][1])
    requests = [{"gt": gt_path}] * RUNLOOP_REQUESTS + [{"cmd": "quit"}]
    serve = cli.build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", tmp, "--model",
        "Multimodality_Mamba", "--bf16", "--serve", "--restore", best_path])
    in_s = io.StringIO("\n".join(json.dumps(r) for r in requests) + "\n")
    out_s = io.StringIO()
    _build.launches.clear()
    served = cli.run_serve(serve, in_stream=in_s, out_stream=out_s)
    serve_counts = dict(_build.launches)
    resps = [json.loads(l) for l in out_s.getvalue().splitlines() if l]
    windows = (h - 8) * (w - 8)
    for r in resps:
        print("[runloop] restored serving: {} ({:.0f} windows/s; {})".format(
            json.dumps(r), windows / r["seconds"] if r.get("ok") else 0,
            card), flush=True)
    if served != RUNLOOP_REQUESTS or not all(r.get("ok") for r in resps):
        raise Failed("--serve --restore did not answer {} requests".format(
            RUNLOOP_REQUESTS))
    mismatch = [(r[k], run[k]) for r in resps for k in ("OA", "AA", "Kappa")
                if r[k] != run[k]]
    print("[runloop] served OA {} AA {} Kappa {} against run {}'s {} {} {}: "
          "{}".format(resps[0]["OA"], resps[0]["AA"], resps[0]["Kappa"],
                      run["run"], run["OA"], run["AA"], run["Kappa"],
                      "equal" if not mismatch else "DIFFERENT"), flush=True)
    print("[runloop] restored serving launches {}".format(
        json.dumps(serve_counts)), flush=True)
    if mismatch:
        raise Failed("the restored model's OA / AA / Kappa differ from the "
                     "run's: {}".format(mismatch))
    missing = [k for k in FORWARD if serve_counts.get(k, 0) <= 0]
    if missing:
        raise Failed("restored serving never launched {}".format(missing))
    _check_bn_train(serve_counts, "Multimodality_Mamba", 0,
                    "restored serving")

    # the card's default algorithms are not bitwise repeatable (two
    # unbroken 3-epoch runs part by ~1e-2 of a tensor's largest entry), so
    # resume is held under the deterministic ones; the default spread and
    # the default resumed run's distance are printed beside it
    for deterministic in (True, False):
        start, spread, diff, unbroken, resumed = _resume_check(
            os.path.join(tmp, "resume{}".format(int(deterministic))), scene,
            state, deterministic)
        print("[runloop] resume (float32, {} algorithms): epoch losses "
              "unbroken {} resumed from epoch {} {}; largest relative "
              "difference {:.3e}, two unbroken runs {:.3e}{}".format(
                  "deterministic" if deterministic else "default", unbroken,
                  start, resumed, diff, spread, " (limit {:g})".format(
                      RESUME_RTOL) if deterministic else ""), flush=True)
        if deterministic and (start != RESUME_SAVED or diff > RESUME_RTOL):
            raise Failed("the resumed run parts from the unbroken one")
    return counts


def phase_zoo(tmp):
    """The zoo's --serve path at full width; returns each model's kernel
    launches."""
    import numpy as np

    from vit_cnn_tpu_torch.cli import build_parser, run_serve
    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.models.registry import MODELS
    from vit_cnn_tpu_torch.ops import _build

    img1, img2 = get_dataset("Synthetic", tmp)[:2]
    h, w = img1.shape[:2]
    n_bands = (img1.shape[2], img2.shape[2])
    n_classes = int(SCENE["VCT_SYN_CLASSES"])
    counts = {}
    for name in ZOO:
        p = MODELS[name].patch_size
        windows = (h - p + 1) * (w - p + 1)
        n_req = MHST_REQUESTS if name == "MHST" else 1
        out = os.path.join(tmp, "{}.npy".format(name))
        requests = [{}] * (n_req - 1) + [{"out": out}, {"cmd": "quit"}]
        args = build_parser().parse_args([
            "--dataset", "Synthetic", "--folder", tmp, "--model", name,
            "--bf16", "--serve", "--seed", str(SEED)])
        state = _seeded_state(name, n_bands, n_classes)
        in_s = io.StringIO("\n".join(json.dumps(r) for r in requests)
                           + "\n")
        out_s = io.StringIO()
        _build.launches.clear()
        served = run_serve(args, in_stream=in_s, out_stream=out_s,
                           state_dict=state)
        counts[name] = dict(_build.launches)
        resps = [json.loads(l) for l in out_s.getvalue().splitlines() if l]
        for r in resps:
            print("[zoo] {} {:.3f} s/request, {:.0f} windows/s ({} windows)"
                  .format(name, r["seconds"], windows / r["seconds"], windows)
                  if r.get("ok") else "[zoo] {} {}".format(name, r),
                  flush=True)
        if served != n_req or len(resps) != n_req or not all(
                r["ok"] for r in resps):
            raise Failed("{} did not answer {} requests ok".format(name,
                                                                  n_req))
        probs = np.load(out)
        finite = bool(np.isfinite(probs).all())
        print("[zoo] {} map {} finite={} max|p|={:.4f}".format(
            name, probs.shape, finite, float(np.abs(probs).max())),
            flush=True)
        if probs.shape != (h, w, n_classes) or not finite:
            raise Failed("bad {} map".format(name))
        want = {k: n * n_req for k, n in zip(HEADS, ZOO_LAUNCHES[name])}
        want["bn_act"] = BN_SITES[name] * _bands(
            h, w, p, args.infer_chunk) * n_req
        got = {k: counts[name].get(k, 0) for k in HEADS + BN_PASS}
        others = {k: c for k, c in counts[name].items()
                  if k not in HEADS + BN_PASS}
        print("[zoo] {} launches {} (expected {})".format(
            name, json.dumps(counts[name]), json.dumps(want)), flush=True)
        if got != want or others:
            raise Failed("{}: kernel launches {} differ from {}".format(
                name, counts[name], want))
    return counts


def phase_zoo_crop(tmp):
    """Each zoo model on a 12 x 64 crop: card float32 and bf16 against the
    CPU's float32 plain path, the flagship crop's limits."""
    import numpy as np
    import torch

    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.infer.fullscene import full_scene_probabilities
    from vit_cnn_tpu_torch.models.registry import get_model

    img1, img2 = (x[:12, :64] for x in get_dataset("Synthetic", tmp)[:2])
    n_bands = (img1.shape[2], img2.shape[2])
    n_classes = int(SCENE["VCT_SYN_CLASSES"])
    failed = []
    for name in ZOO:
        state = _seeded_state(name, n_bands, n_classes)

        def serve(device, bf16):
            model, _, hp = get_model(name, n_classes=n_classes,
                                     n_bands=n_bands)
            model.load_state_dict(state)
            model.to(device).eval()
            # MHST: every head-select decision; S2EFT: its band gate's
            # decisions g >= 0.4, one (windows, bands) block a band call
            selects = []
            for m in model.modules():
                if hasattr(m, "head_select"):
                    m.head_select.register_forward_hook(
                        lambda mod, a, out: selects.append(
                            (out > 0).cpu().flatten()))
                if hasattr(m, "gate_conv"):
                    m.gate_conv.register_forward_hook(
                        lambda mod, a, out: selects.append(
                            (torch.sigmoid(out) >= 0.4)[..., 0].cpu()))
            probs = full_scene_probabilities(model, img1, img2,
                                             dict(hp, bf16=bf16))
            sel = (np.concatenate([x.numpy() for x in selects]) if selects
                   else None)
            return probs, sel, hp["patch_size"]

        cpu, sel_cpu, p = serve("cpu", False)
        f32, sel_f32, _ = serve("cuda", False)
        b16, sel_b16, _ = serve("cuda", True)
        inner = (slice(p // 2, p // 2 + 12 - p + 1),
                 slice(p // 2, p // 2 + 64 - p + 1))
        scale = max(1.0, float(np.abs(cpu).max()))
        d32 = float(np.abs(f32 - cpu).max())
        d16 = float(np.abs(b16 - cpu).max())
        agree16 = float((b16[inner].argmax(-1) == cpu[inner].argmax(-1))
                        .mean())
        print("[zoo-crop] {}: card f32 vs cpu f32 max|diff| {:.3e} (limit "
              "{:.1e}); card bf16 vs cpu f32 max|diff| {:.3e}, argmax "
              "agreement {:.4f} (limit 0.99) over {} windows".format(
                  name, d32, CROP_TOL * scale, d16, agree16,
                  cpu[inner].shape[0] * cpu[inner].shape[1]), flush=True)
        if sel_cpu is not None:
            print("[zoo-crop] {}: {} differing from the CPU's: card f32 {} "
                  "of {}, card bf16 {} of {}".format(
                      name, "gate decisions (g >= 0.4)" if name == "S2EFT"
                      else "head selections",
                      int((sel_f32 != sel_cpu).sum()), sel_cpu.size,
                      int((sel_b16 != sel_cpu).sum()), sel_cpu.size),
                  flush=True)
        if name == "S2EFT":
            # the bf16 map's largest difference where a window's gate
            # flipped and where it did not (one band: windows row-major)
            rows, cols = 12 - p + 1, 64 - p + 1
            flipped = (sel_b16 != sel_cpu)[:rows * cols].any(axis=1) \
                .reshape(rows, cols)
            d = np.abs(b16 - cpu)[inner].max(axis=-1)
            print("[zoo-crop] S2EFT bf16: {} of {} windows with a flipped "
                  "gate, max|diff| {:.3e} there, {:.3e} in the others "
                  "(max|cpu| {:.3e})".format(
                      int(flipped.sum()), flipped.size,
                      float(d[flipped].max()) if flipped.any() else 0.0,
                      float(d[~flipped].max()) if (~flipped).any() else 0.0,
                      float(np.abs(cpu).max())), flush=True)
        if d32 > CROP_TOL * scale or agree16 < 0.99:
            failed.append(name)
    if failed:
        raise Failed("zoo crop maps disagree with the CPU plain path: {}"
                     .format(failed))


def _zoo_train_kernels(rows):
    """K8 and K9 under autograd at the zoo's train shapes (batch 1024): K8
    on the strided q, k, v views of a fused qkv at 65, 145 and 146 tokens,
    4 heads of 16; K9 at MHST's (65, 16 x 4). Forward and gradients
    against the plain version's autograd, float32 and bf16; timed forward
    and forward + (plain) backward beside the plain version's and, for K8,
    SDPA's (its own fused backward) on the same transposed views."""
    import torch
    import torch.nn.functional as F

    from vit_cnn_tpu_torch.ops import attention
    from vit_cnn_tpu_torch.tools import bound as _bound
    from vit_cnn_tpu_torch.tools import median_ms as _median_ms

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    B = TRAIN_BATCH
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")

    def fwd_bwd(fn, leaves, cot):
        for x in leaves:
            x.grad = None
        out = fn(*leaves)
        out.backward(cot)
        return out.detach(), [x.grad for x in leaves]

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for n, who in ZOO_TRAIN_TOKENS:
            qkv = randn(B, n, 3 * 64).to(dtype).requires_grad_()
            cot = randn(B, n, 4, 16).to(dtype)
            heads = lambda t: t.view(B, n, 4, 16)

            def kernel(x):
                return attention.fused_attention_heads(
                    *map(heads, x.chunk(3, -1)), 0.25)

            def plain(x):
                return attention.attention_reference_heads(
                    *map(heads, x.chunk(3, -1)), 0.25)

            def sdpa(x):
                q, k, v = (heads(t).transpose(1, 2) for t in x.chunk(3, -1))
                return F.scaled_dot_product_attention(
                    q, k, v, scale=0.25).transpose(1, 2)

            got, (g_got,) = fwd_bwd(kernel, [qkv], cot)
            want, (g_want,) = fwd_bwd(plain, [qkv], cot)
            err = _compare("K8 train B={} n={} 4x16 ({})".format(B, n, who),
                           got, want, dn)
            _compare("K8 train gradient B={} n={}".format(B, n), g_got,
                     g_want, dn)
            lib_out, (g_lib,) = fwd_bwd(sdpa, [qkv], cot)
            # SDPA is timed, not held: its distance from the plain version
            # shows that it computes the same function
            print("    SDPA against the plain version: max|diff| {:.3e}, "
                  "gradient {:.3e}".format(
                      float((lib_out.float() - want.float()).abs().max()),
                      float((g_lib.float() - g_want.float()).abs().max())),
                  flush=True)
            with torch.no_grad():
                t = _median_ms(lambda: kernel(qkv))
                p = _median_ms(lambda: plain(qkv), reps=3)
                lib = _median_ms(lambda: sdpa(qkv))
            tb = _median_ms(lambda: fwd_bwd(kernel, [qkv], cot))
            pb = _median_ms(lambda: fwd_bwd(plain, [qkv], cot), reps=3)
            lb = _median_ms(lambda: fwd_bwd(sdpa, [qkv], cot))
            q, k, v = map(heads, qkv.detach().chunk(3, -1))
            bnd = _bound([q, k, v, got], dn, exps=B * 4 * n * n,
                         flops=4 * B * 4 * n * n * 16)
            print("    zoo train n={} {} ({}): kernel {:.3f} ms, plain "
                  "{:.3f}, sdpa {:.3f}; forward + backward: K8 with the "
                  "plain backward {:.3f}, plain {:.3f}, sdpa {:.3f}; bound "
                  "{:.3f} ({})".format(n, dn, who, t, p, lib, tb, pb, lb,
                                       *bnd), flush=True)
            _timed(rows, "fused_attention_heads",
                   "zoo train (B={}, n={}, 4x16)".format(B, n), dn, ms=t,
                   plain_ms=p, library_ms=lib, fwd_bwd_ms=tb,
                   plain_fwd_bwd_ms=pb, library_fwd_bwd_ms=lb,
                   bound_ms=bnd[0], bound_by=bnd[1])
            _record(rows, "fused_attention_heads", err, dn)
            del qkv, cot, got, want, g_got, g_want, lib_out, g_lib
        n, h, hd = 65, 16, 4
        leaves = [randn(B, n, h * hd).to(dtype).requires_grad_()
                  for _ in range(3)]
        leaves += [(1 + 0.2 * randn(hd)).to(dtype).requires_grad_()
                   if i % 2 == 0 else (0.1 * randn(hd)).to(dtype)
                   .requires_grad_() for i in range(6)]
        cot = randn(B, n, h * hd).to(dtype)

        def kernel9(*a):
            return attention.pooled_heads_attention(*a, h, 0.5)

        def plain9(q, k, v, a, b, c, d, e, f):
            return attention.pooled_attention_reference(
                q, k, v, (a, b), (c, d), (e, f), h, 0.5)

        got, g_got = fwd_bwd(kernel9, leaves, cot)
        want, g_want = fwd_bwd(plain9, leaves, cot)
        if dtype == torch.float32:
            # K9 takes its LN statistics in float64 there (phase 2)
            with torch.no_grad():
                want = plain9(*[x.double() for x in leaves]).float()
        err = _compare("K9 train B={} n={} 16x4 (MHST)".format(B, n), got,
                       want, dn)
        # the LN scales and biases sum over every token and head
        _compare("K9 train gradients B={} n={}".format(B, n), g_got, g_want,
                 dn, summed=range(3, 9))
        with torch.no_grad():
            t = _median_ms(lambda: kernel9(*leaves))
            p = _median_ms(lambda: plain9(*leaves), reps=3)
        tb = _median_ms(lambda: fwd_bwd(kernel9, leaves, cot))
        pb = _median_ms(lambda: fwd_bwd(plain9, leaves, cot), reps=3)
        bnd = _bound(leaves + [got], dn, exps=B * h * n * n,
                     flops=4 * B * h * n * n * hd)
        print("    zoo train MHST pooled {}: kernel {:.3f} ms, plain {:.3f}; "
              "forward + plain backward {:.3f}, plain both {:.3f}; bound "
              "{:.3f} ({})".format(dn, t, p, tb, pb, *bnd), flush=True)
        _timed(rows, "pooled_heads_attention",
               "zoo train (B={}, n={}, 16x4)".format(B, n), dn, ms=t,
               plain_ms=p, fwd_bwd_ms=tb, plain_fwd_bwd_ms=pb,
               bound_ms=bnd[0], bound_by=bnd[1])
        _record(rows, "pooled_heads_attention", err, dn)
        del leaves, cot, got, want, g_got, g_want
    torch.cuda.synchronize()


def _zoo_train_crop(tmp, name, state, attn_drop_0=False, tag="zoo_train"):
    """One float32 train step of ``name`` on the card and on the CPU
    (plain versions) from ``state`` and the same 32 centers, flip off, the
    dropout and Gumbel noise drawn once on the CPU and replayed on the
    card; the card's bf16 step on the same noise. ``attn_drop_0`` sets
    MHST's attention dropout to 0, so that its pooled blocks run K9 under
    autograd. Returns the card f32 step's kernel launches."""
    import torch

    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.nn import noise
    from vit_cnn_tpu_torch.ops import _build
    from vit_cnn_tpu_torch.tools import train_step

    scene = tuple(x[:40, :200] for x in get_dataset("Synthetic", tmp)[:3])
    label = name + (" attn_drop 0" if attn_drop_0 else "")

    def one_step(device, bf16, source):
        trainer, step_args = train_step(scene, state, device,
                                        ZOO_CROP_CENTERS, model=name,
                                        bf16=bf16, seed=SEED)
        if attn_drop_0:
            for m in trainer.model.modules():
                if isinstance(getattr(m, "attn_drop", None), noise.Dropout):
                    m.attn_drop.rate = 0.0
        trainer.noise = source
        loss = trainer._step(*step_args)
        model = trainer.model
        grads = {k: p.grad.detach().cpu() for k, p in
                 model.named_parameters()}
        stats = {k: v.detach().cpu() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        return float(loss), grads, stats

    rec = noise.Recorder(torch.Generator().manual_seed(SEED))
    loss_cpu, g_cpu, s_cpu = one_step("cpu", False, rec)
    _build.launches.clear()
    loss_gpu, g_gpu, s_gpu = one_step("cuda", False, noise.Replay(rec.draws))
    counts = dict(_build.launches)
    loss_b16 = one_step("cuda", True, noise.Replay(rec.draws))[0]
    floor = GRAD_ATOL * max(float(g.norm()) for g in g_cpu.values())
    worst_g = max((float((g_gpu[k] - g).norm()) / (GRAD_TOL * float(g.norm())
                                                  + floor), k)
                  for k, g in g_cpu.items())
    worst_s = max([(float((s_gpu[k] - v).abs().max())
                    / (STAT_TOL * float(v.abs().max())), k)
                   for k, v in s_cpu.items()] or [(0.0, "none")])
    dl = abs(loss_gpu - loss_cpu)
    db = abs(loss_b16 - loss_gpu) / abs(loss_gpu)
    print("[{}] {} crop step ({} draws of noise): loss card f32 "
          "{:.6f} cpu f32 {:.6f} |diff| {:.2e}; {} gradients: worst "
          "||diff|| {:.3f} of its limit ({}); {} BN statistics: worst {:.3f} "
          "of its limit ({}); card bf16 loss {:.6f}, {:.2%} from f32 (limit "
          "{:.0%}); card launches {}".format(
              tag, label, len(rec.draws), loss_gpu, loss_cpu, dl, len(g_cpu),
              worst_g[0], worst_g[1], len(s_cpu), worst_s[0], worst_s[1],
              loss_b16, db, BF16_LOSS_TOL, json.dumps(counts)), flush=True)
    if dl > 1e-3 * abs(loss_cpu) or worst_g[0] > 1.0 or worst_s[0] > 1.0 \
            or db > BF16_LOSS_TOL:
        raise Failed("{}: the card's train step disagrees with the CPU's"
                     .format(label))
    return counts


def _zoo_handoff(tmp, work, result, test_gt, card, name="MHST",
                 tag="zoo_train"):
    """``name``'s best file served through --serve --restore: the served
    OA, AA and Kappa equal the run's exactly."""
    import numpy as np

    from vit_cnn_tpu_torch import cli

    best = os.path.join(work, result["best_checkpoint"])
    gt_path = os.path.join(work, "{}_test_gt.npy".format(name))
    np.save(gt_path, test_gt)
    args = cli.build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", tmp, "--model", name,
        "--bf16", "--serve", "--restore", best])
    in_s = io.StringIO(json.dumps({"gt": gt_path}) + "\n"
                       + json.dumps({"cmd": "quit"}) + "\n")
    out_s = io.StringIO()
    served = cli.run_serve(args, in_stream=in_s, out_stream=out_s)
    resps = [json.loads(l) for l in out_s.getvalue().splitlines() if l]
    if served != 1 or not resps or not resps[0].get("ok"):
        raise Failed("{}'s best file was not served: {}".format(name, resps))
    r = resps[0]
    same = all(r[k] == result[k] for k in ("OA", "AA", "Kappa"))
    print("[{}] {} best file served ({:.3f} s; {}): OA {} AA {} "
          "Kappa {} against the run's {} {} {}: {}".format(
              tag, name, r["seconds"], card, r["OA"], r["AA"], r["Kappa"],
              result["OA"], result["AA"], result["Kappa"],
              "equal" if same else "DIFFERENT"), flush=True)
    if not same:
        raise Failed("{}'s restored OA / AA / Kappa differ from the run's"
                     .format(name))


def _run_train(tmp, work, name, state, card, tag):
    """run_train of ``name`` at registry width from ``state`` (bf16, batch
    TRAIN_BATCH, flip on, 200 centers a class, ZOO_TRAIN_EPOCHS epochs) in
    ``work``; returns (result, its test split, its kernel launches)."""
    import contextlib

    import numpy as np
    import torch

    from vit_cnn_tpu_torch import cli
    from vit_cnn_tpu_torch.ops import _build

    splits = []
    real_load = cli._load_gt_pair

    def load_gt_pair(*args, **kwargs):
        splits.append(real_load(*args, **kwargs))
        return splits[-1]

    cwd = os.getcwd()
    os.chdir(work)                  # ./checkpoints and ./results here
    stdout = io.StringIO()
    try:
        cli._load_gt_pair = load_gt_pair
        args = cli.build_parser().parse_args([
            "--dataset", "Synthetic", "--folder", tmp, "--model", name,
            "--bf16", "--batch_size", str(TRAIN_BATCH),
            "--flip_augmentation", "--runs", "1", "--epoch",
            str(ZOO_TRAIN_EPOCHS), "--training_sample", "200",
            "--out_dir", os.path.join(work, "results"), "--log_every", "1"])
        _build.launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            result = cli.run_train(args, state_dict=state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launches)
    finally:
        cli._load_gt_pair = real_load
        os.chdir(cwd)
    print("[{}] {} run_train {:.1f} s ({}): {} centers, epoch losses {}, "
          "val {}, OA {:.2f} AA {:.4f} Kappa {:.4f}; launches {}".format(
              tag, name, wall, card, result["train_samples"],
              result["losses"], result["val_accuracies"], result["OA"],
              result["AA"], result["Kappa"], json.dumps(counts)), flush=True)
    files = [os.path.join(work, result[k] or "")
             for k in ("best_checkpoint", "final_checkpoint")]
    if not all(np.isfinite(result["losses"])) or \
            not all(os.path.isfile(f) for f in files):
        raise Failed("{}: run_train gave a non-finite loss or no checkpoint "
                     "file".format(name))
    return result, splits[-1][1], counts


def _run_steps(result):
    """The train steps of a run_train result: its epochs of batches of
    TRAIN_BATCH, the last one padded."""
    return -(-result["train_samples"] // TRAIN_BATCH) * result["epochs"]


def _steady(scene, state, name, card, tag, want):
    """ZOO_STEADY_STEPS bf16 steps of ``name`` on one batch of TRAIN_BATCH
    centers (flip on) after one untimed step: ms/step, patches/s and peak
    memory; fails unless the launches equal ``want``, every loss is
    finite and every parameter is still float32."""
    import numpy as np
    import torch

    from vit_cnn_tpu_torch.ops import _build
    from vit_cnn_tpu_torch.tools import train_step

    trainer, step_args = train_step(scene, state, "cuda", TRAIN_BATCH,
                                    model=name, bf16=True, flip=True,
                                    seed=SEED)
    first = trainer._step(*step_args)                  # not timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    t0 = time.perf_counter()
    losses = [trainer._step(*step_args) for _ in range(ZOO_STEADY_STEPS)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(first)] + [float(x) for x in losses]
    figures = {"ms_per_step": 1e3 * secs / ZOO_STEADY_STEPS,
               "patches_per_s": ZOO_STEADY_STEPS * TRAIN_BATCH / secs,
               "peak_gb": peak / 1e9}
    print("[{}] {} steady: {} steps of {}: {:.2f} ms/step, {:.0f} "
          "patches/s, peak device memory {:.2f} GB ({}); losses {}; "
          "launches {} (expected {})".format(
              tag, name, ZOO_STEADY_STEPS, TRAIN_BATCH,
              figures["ms_per_step"], figures["patches_per_s"], peak / 1e9,
              card, " ".join("{:.4f}".format(x) for x in losses),
              json.dumps(got), json.dumps(want)), flush=True)
    off = [k for k, p in trainer.model.named_parameters()
           if p.dtype != torch.float32]
    if got != want or not all(np.isfinite(losses)) or off:
        raise Failed("{}: steady steps launched {} (expected {}), or a "
                     "non-finite loss, or parameters left float32: {}"
                     .format(name, got, want, off))
    return figures, got


def phase_zoo_train(tmp, rows, card):
    """Each zoo model trained through run_train at registry widths (bf16,
    batch 1024, flip on, 200 centers a class, 2 epochs), then steady steps
    on one batch (ms, patches/s, peak memory; K8 launched exactly once per
    ViT layer a step), the card-against-CPU crop step, and MHST's best
    file served back. Returns (run_train's launches per model, the steady
    figures per model)."""
    from vit_cnn_tpu_torch.data import get_dataset

    _zoo_train_kernels(rows)
    work = os.path.join(tmp, "zoo_train")
    os.makedirs(work)
    scene = get_dataset("Synthetic", tmp)[:3]
    n_bands = (scene[0].shape[2], scene[1].shape[2])
    n_classes = int(SCENE["VCT_SYN_CLASSES"])
    counts, steady = {}, {}
    for name in ZOO:
        state = _seeded_state(name, n_bands, n_classes)
        result, test_gt, counts[name] = _run_train(tmp, work, name, state,
                                                   card, "zoo_train")
        if counts[name].get("fused_attention_heads", 0) <= 0:
            raise Failed("{}: run_train launched no K8".format(name))
        _check_bn_train(counts[name], name, _run_steps(result),
                        "{} run_train".format(name))
        want = {"fused_attention_heads": ZOO_TRAIN_K8[name] * ZOO_STEADY_STEPS}
        if BN_SITES[name]:
            want["bn_train"] = _bn_train_launches(name, ZOO_STEADY_STEPS)
        steady[name], got = _steady(scene, state, name, card, "zoo_train",
                                    want)
        steady[name]["k8_per_step"] = got.get("fused_attention_heads", 0) \
            / ZOO_STEADY_STEPS
        _zoo_train_crop(tmp, name, state)
        if name == "MHST":
            k9 = _zoo_train_crop(tmp, name, state, attn_drop_0=True).get(
                "pooled_heads_attention", 0)
            if k9 != MHST_POOLED_BLOCKS:
                raise Failed("MHST at attn_drop 0 launched K9 {} times in a "
                             "step, not {}".format(k9, MHST_POOLED_BLOCKS))
            _zoo_handoff(tmp, work, result, test_gt, card)
    return counts, steady


def phase_cnn_zoo(tmp, card):
    """The CNN zoo at registry widths on the same scene, seeded weights,
    model by model: the --serve path (bf16, a warm and a resident request;
    HCTnet on 30 PCA components, its reduced scene resident on request 2),
    the 12 x 64 crop on the card (float32, bf16) against the CPU's float32,
    the float32 train step on the card against the CPU's (32 centers, flip
    off; the bf16 loss beside it), steady bf16 train steps; then HCTnet's
    run_train and its best file served back. None of K1-K9 lies on this
    path: every K1-K9 count stays 0; serving launches the BatchNorm pass
    once a BatchNorm and band (BN_SITES), a train step train-mode
    BatchNorm's passes BN_TRAIN_PER_SITE times a BatchNorm. Returns (the
    serving runs' launches per model, the training run's, the figures per
    model)."""
    import numpy as np

    from vit_cnn_tpu_torch.cli import build_parser, run_serve
    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.infer.fullscene import full_scene_probabilities
    from vit_cnn_tpu_torch.models.registry import MODELS, get_model
    from vit_cnn_tpu_torch.ops import _build

    scene = get_dataset("Synthetic", tmp)[:3]
    img1, img2 = scene[:2]
    h, w = img1.shape[:2]
    n_bands = (img1.shape[2], img2.shape[2])
    n_classes = int(SCENE["VCT_SYN_CLASSES"])
    crop = tuple(x[:12, :64] for x in (img1, img2))
    serve_counts, figures, failed = {}, {}, []
    for name in CNN_ZOO:
        state = _seeded_state(name, n_bands, n_classes)
        p = MODELS[name].patch_size
        windows = (h - p + 1) * (w - p + 1)
        out = os.path.join(tmp, "{}.npy".format(name))
        args = build_parser().parse_args([
            "--dataset", "Synthetic", "--folder", tmp, "--model", name,
            "--bf16", "--serve", "--seed", str(SEED)])
        in_s = io.StringIO("{}\n" + json.dumps({"out": out}) + "\n")
        out_s = io.StringIO()
        _build.launches.clear()
        served = run_serve(args, in_stream=in_s, out_stream=out_s,
                           state_dict=state)
        serve_counts[name] = dict(_build.launches)
        bn = BN_SITES[name] * _bands(h, w, p, args.infer_chunk) * served
        resps = [json.loads(l) for l in out_s.getvalue().splitlines() if l]
        if served != 2 or not all(r.get("ok") for r in resps):
            raise Failed("{} did not answer 2 requests ok: {}".format(
                name, resps))
        probs = np.load(out)
        finite = bool(np.isfinite(probs).all())
        f = figures[name] = {
            "request_s": [r["seconds"] for r in resps],
            "windows_per_s": [windows / r["seconds"] for r in resps],
            "uploads": [r["uploads"] for r in resps]}
        print("[cnn_zoo] {} serve ({}): {} windows; warm {:.3f} s ({:.0f} "
              "windows/s), resident {:.3f} s ({:.0f} windows/s); uploads "
              "{}; map {} finite={}; launches {}".format(
                  name, card, windows, f["request_s"][0],
                  f["windows_per_s"][0], f["request_s"][1],
                  f["windows_per_s"][1], f["uploads"], probs.shape, finite,
                  json.dumps(serve_counts[name])), flush=True)
        if probs.shape != (h, w, n_classes) or not finite or \
                f["uploads"][1] != 0 or serve_counts[name] != (
                    {"bn_act": bn} if bn else {}):
            raise Failed("{}: bad map, a scene uploaded again, or launches "
                         "other than bn_act's {} (once a BatchNorm and band)"
                         .format(name, bn))

        def crop_map(device, bf16):
            model, _, hp = get_model(name, n_classes=n_classes,
                                     n_bands=n_bands)
            model.load_state_dict(state)
            model.to(device).eval()
            return full_scene_probabilities(model, crop[0], crop[1],
                                            dict(hp, bf16=bf16))

        cpu, f32, b16 = (crop_map("cpu", False), crop_map("cuda", False),
                         crop_map("cuda", True))
        inner = (slice(p // 2, p // 2 + 12 - p + 1),
                 slice(p // 2, p // 2 + 64 - p + 1))
        scale = max(1.0, float(np.abs(cpu).max()))
        d32 = float(np.abs(f32 - cpu).max())
        agree16 = float((b16[inner].argmax(-1) == cpu[inner].argmax(-1))
                        .mean())
        print("[cnn_zoo] {} crop: card f32 vs cpu f32 max|diff| {:.3e} "
              "(limit {:.1e}); card bf16 argmax agreement {:.4f} (limit "
              "0.99) over {} windows".format(
                  name, d32, CROP_TOL * scale, agree16,
                  cpu[inner].shape[0] * cpu[inner].shape[1]), flush=True)
        if d32 > CROP_TOL * scale or agree16 < 0.99:
            failed.append(name)
        bn = ({"bn_train": _bn_train_launches(name, 1)} if BN_SITES[name]
              else {})
        if _zoo_train_crop(tmp, name, state, tag="cnn_zoo") != bn:
            raise Failed("{}'s train step launched a kernel other than "
                         "bn_train's {}".format(name, bn))
        f.update(_steady(scene, state, name, card, "cnn_zoo", {
            k: n * ZOO_STEADY_STEPS for k, n in bn.items()})[0])
    if failed:
        raise Failed("CNN crop maps disagree with the CPU plain path: {}"
                     .format(failed))
    work = os.path.join(tmp, "cnn_zoo")
    os.makedirs(work)
    name = CNN_HANDOFF
    state = _seeded_state(name, n_bands, n_classes)
    result, test_gt, train_counts = _run_train(tmp, work, name, state, card,
                                               "cnn_zoo")
    _check_bn_train(train_counts, name, _run_steps(result),
                    "{} run_train".format(name))
    _zoo_handoff(tmp, work, result, test_gt, card, name, "cnn_zoo")
    launched = {}
    for c in [train_counts, *serve_counts.values()]:
        for k, n in c.items():
            # serving, run_train's val and maps, and its train steps
            if k not in BN_PASS + BN_TRAIN:
                launched[k] = launched.get(k, 0) + n
    print("[cnn_zoo] K1-K9 launches over the CNN zoo's serving and {}'s "
          "training: {}".format(name, json.dumps(
              {k: launched.get(k, 0) for k in PATH_KERNELS})), flush=True)
    if launched:
        raise Failed("the CNN zoo launched kernels: {}".format(launched))
    return serve_counts, {name: train_counts}, figures


def _stride_serve(tmp, state, card, scene):
    """The flagship through --serve with two stride-3 requests (bf16):
    seconds and windows/s each, the map finite with mass only at window
    centers, K1-K4 launched. Returns (launches, figures)."""
    import numpy as np

    from vit_cnn_tpu_torch.cli import build_parser, run_serve
    from vit_cnn_tpu_torch.infer.fullscene import sliding_window_origins
    from vit_cnn_tpu_torch.ops import _build

    h, w = scene[0].shape[:2]
    origins = sliding_window_origins(h, w, 9, STRIDE)
    out = os.path.join(tmp, "stride.npy")
    requests = [{"stride": STRIDE, "out": out}, {"stride": STRIDE},
                {"cmd": "quit"}]
    args = build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", tmp, "--model",
        "Multimodality_Mamba", "--bf16", "--serve", "--seed", str(SEED)])
    in_s = io.StringIO("\n".join(json.dumps(r) for r in requests) + "\n")
    out_s = io.StringIO()
    _build.launches.clear()
    served = run_serve(args, in_stream=in_s, out_stream=out_s,
                       state_dict=state)
    counts = dict(_build.launches)
    resps = [json.loads(l) for l in out_s.getvalue().splitlines() if l]
    if served != 2 or not all(r.get("ok") for r in resps):
        raise Failed("stride serving did not answer 2 requests: {}".format(
            resps))
    figures = {"windows": len(origins),
               "request_s": [r["seconds"] for r in resps],
               "windows_per_s": [len(origins) / r["seconds"] for r in resps]}
    probs = np.load(out)
    centers = np.zeros((h, w), bool)
    centers[origins[:, 0] + 4, origins[:, 1] + 4] = True
    finite = bool(np.isfinite(probs).all())
    outside = bool(probs[~centers].any())
    print("[run_modes] stride {} serve ({}): {} windows; warm {:.3f} s "
          "({:.0f} windows/s), resident {:.3f} s ({:.0f} windows/s); map {} "
          "finite={} mass outside the centers={}; launches {}".format(
              STRIDE, card, len(origins), figures["request_s"][0],
              figures["windows_per_s"][0], figures["request_s"][1],
              figures["windows_per_s"][1], probs.shape, finite, outside,
              json.dumps(counts)), flush=True)
    missing = [k for k in FORWARD if counts.get(k, 0) <= 0]
    if probs.shape[:2] != (h, w) or not finite or outside or \
            not (np.abs(probs[centers]).sum(-1) > 0).all() or missing:
        raise Failed("stride serving: bad map or kernels never launched "
                     "{}".format(missing))
    _check_bn_train(counts, "Multimodality_Mamba", 0, "stride serving")
    return counts, figures


def _stride_crop(state, scene):
    """The 12 x 64 crop at stride 2 (origin rows 0, 2, 3, one chunk) on
    the card in float32 against the CPU's plain versions."""
    import numpy as np

    from vit_cnn_tpu_torch.infer.fullscene import (full_scene_probabilities,
                                                   sliding_window_origins)
    from vit_cnn_tpu_torch.models.registry import get_model

    img1, img2 = (x[:12, :64] for x in scene[:2])
    n_classes = int(SCENE["VCT_SYN_CLASSES"])
    origins = sliding_window_origins(12, 64, 9, STRIDE_CROP)
    rows = sorted(set(origins[:, 0]))

    def serve(device):
        model, _, hp = get_model("Multimodality_Mamba", n_classes=n_classes,
                                 n_bands=(img1.shape[2], img2.shape[2]))
        model.load_state_dict(state)
        model.to(device).eval()
        return full_scene_probabilities(
            model, img1, img2, dict(hp, test_stride=STRIDE_CROP),
            chunk=STRIDE_CROP_CHUNK)

    cpu, f32 = serve("cpu"), serve("cuda")
    scale = max(1.0, float(np.abs(cpu).max()))
    d32 = float(np.abs(f32 - cpu).max())
    print("[run_modes] crop at stride {} (origin rows {}; {} windows in one "
          "chunk of {}): card f32 vs cpu f32 max|diff| {:.3e} (limit {:.1e}); "
          "mass at (4, 4) {:.4f}".format(
              STRIDE_CROP, [int(r) for r in rows], len(origins),
              STRIDE_CROP_CHUNK, d32, CROP_TOL * scale,
              float(np.abs(f32[4, 4]).sum())), flush=True)
    if rows != [0, 2, 3] or len(origins) >= STRIDE_CROP_CHUNK or \
            d32 > CROP_TOL * scale or not f32[4, 4].any():
        raise Failed("the stride-2 crop disagrees with the CPU plain path")


def _timed_steps(trainer, step_args, steps):
    """ms per step of ``steps`` steps after one untimed step, and the
    losses."""
    import torch

    losses = [trainer._step(*step_args)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [trainer._step(*step_args) for _ in range(steps)]
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps, \
        [float(x) for x in losses]


def _aug_train(tmp, state, card, scene):
    """run_train of the flagship with flip, radiation and mixture (bf16,
    batch 1024), steady steps with and without the noises in turns, and
    the gate rates. Returns (run_train's launches, figures)."""
    import numpy as np
    import torch

    from vit_cnn_tpu_torch.cli import build_parser, run_train
    from vit_cnn_tpu_torch.ops import _build
    from vit_cnn_tpu_torch.pipeline.patches import MIXTURE_P, RADIATION_P
    from vit_cnn_tpu_torch.tools import median_ms, train_step

    args = build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", tmp, "--model",
        "Multimodality_Mamba", "--bf16", "--batch_size", str(TRAIN_BATCH),
        "--flip_augmentation", "--radiation_augmentation",
        "--mixture_augmentation", "--epoch", str(AUG_EPOCHS),
        "--training_sample", "200", "--test_stride", str(STRIDE),
        "--log_every", "1", "--seed", str(SEED)])
    _build.launches.clear()
    t0 = time.perf_counter()
    result = run_train(args, state_dict=state)
    wall = time.perf_counter() - t0
    counts = dict(_build.launches)
    print("[run_modes] augmented run_train {:.1f} s ({}): {} centers, epoch "
          "losses {}, val {}, OA {:.2f}".format(
              wall, card, result["train_samples"], result["losses"],
              result["val_accuracies"], result["OA"]), flush=True)
    if not all(np.isfinite(result["losses"])):
        raise Failed("non-finite loss in augmented training")
    _check_counts(counts, -(-result["train_samples"] // TRAIN_BATCH)
                  * result["epochs"], "run_modes aug")

    trainers = {noise: train_step(scene, state, "cuda", TRAIN_BATCH,
                                  bf16=True, flip=True, seed=SEED,
                                  radiation=noise, mixture=noise)
                for noise in (False, True)}
    ms = {False: [], True: []}
    for noise in (False, True, True, False):
        t, losses = _timed_steps(*trainers[noise], NOISE_STEPS)
        if not all(np.isfinite(losses)):
            raise Failed("non-finite loss in the steady augmented steps")
        ms[noise].append(t)
    figures = {"ms_per_step_flip": ms[False], "ms_per_step_noises": ms[True]}
    print("[run_modes] steady bf16 steps of {} ({}), in turns off on on off: "
          "flip only {} ms/step, flip + radiation + mixture {} ms/step; the "
          "noises cost {:.2f} ms/step".format(
              TRAIN_BATCH, card, " ".join("{:.2f}".format(x) for x in
                                          ms[False]),
              " ".join("{:.2f}".format(x) for x in ms[True]),
              np.mean(ms[True]) - np.mean(ms[False])), flush=True)

    # the batch assembly alone (gather, flip, noises), CUDA events
    batch_ms = {noise: median_ms(functools.partial(
        trainers[noise][0].pipeline.make_batch, trainers[noise][0].generator,
        trainers[noise][1][0])) for noise in (False, True)}
    figures.update(batch_ms_flip=batch_ms[False],
                   batch_ms_noises=batch_ms[True])
    print("[run_modes] batch assembly of {} ({}): flip only {:.3f} ms, flip "
          "+ radiation + mixture {:.3f} ms".format(
              TRAIN_BATCH, card, batch_ms[False], batch_ms[True]), flush=True)

    pipe = trainers[True][0].pipeline
    g = torch.Generator(device="cuda").manual_seed(SEED)
    fired = {"radiation_gate": 0, "mixture_gate": 0}
    for _ in range(GATE_BATCHES):
        draws = pipe.draw_noise(g, (TRAIN_BATCH, 9, 9, scene[0].shape[2]))
        fired["radiation_gate"] += int((draws["radiation_gate"]
                                        < RADIATION_P).sum())
        fired["mixture_gate"] += int((draws["mixture_gate"]
                                      < MIXTURE_P).sum())
    n = GATE_BATCHES * TRAIN_BATCH
    for name, p in (("radiation_gate", RADIATION_P),
                    ("mixture_gate", MIXTURE_P)):
        rate, sigma = fired[name] / n, (p * (1 - p) / n) ** 0.5
        figures[name + "_rate"] = rate
        print("[run_modes] {} rate {:.4f} over {} samples (p {}, {:.2f} "
              "sigma)".format(name, rate, n, p, (rate - p) / sigma),
              flush=True)
        if abs(rate - p) > 4 * sigma:
            raise Failed("{} fires at {:.4f}, not {}".format(name, rate, p))
    return counts, figures


def _pretrain_cli(tmp, card):
    """--pretrain --cos with both noises through the CLI on a 49 x 169
    scene; the best file read back bit for bit. Returns its launches."""
    import contextlib

    import numpy as np
    import torch

    from vit_cnn_tpu_torch import cli
    from vit_cnn_tpu_torch.models.moco import DualModalEncoder
    from vit_cnn_tpu_torch.ops import _build
    from vit_cnn_tpu_torch.train.checkpoint import restore_state_dict

    best = []

    class Capture(cli.Pretrainer):
        def fit(self, *a, **kw):
            best.append(super().fit(*a, **kw))
            return best[-1]

    work = os.path.join(tmp, "pretrain")
    os.makedirs(work)
    saved = {k: os.environ[k] for k in PRETRAIN_SCENE}
    cwd, real = os.getcwd(), cli.Pretrainer
    stdout = io.StringIO()
    try:
        os.environ.update(PRETRAIN_SCENE)
        os.chdir(work)
        cli.Pretrainer = Capture
        _build.launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            result = cli.main([
                "--dataset", "Synthetic", "--folder", tmp, "--pretrain",
                "--cos", "--radiation_augmentation", "--mixture_augmentation",
                "--epoch", str(PRETRAIN_EPOCHS), "--batch_size", "64",
                "--queue_size", str(PRETRAIN_QUEUE), "--log_every", "1",
                "--seed", str(SEED)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launches)
    finally:
        os.environ.update(saved)
        os.chdir(cwd)
        cli.Pretrainer = real
    steps = -(-result["centers"] // 64) * PRETRAIN_EPOCHS
    print("[run_modes] --pretrain ({}): {} centers, {} steps of 64 in {:.1f} "
          "s ({:.2f} ms/step with the epochs' set-up), queue {}, epoch losses "
          "{}".format(card, result["centers"], steps, wall,
                      1e3 * wall / steps, result["queue_size"],
                      result["losses"]), flush=True)
    encoder = DualModalEncoder(int(SCENE["VCT_SYN_BANDS"]), 1)
    restored = restore_state_dict(os.path.join(work,
                                               result["best_checkpoint"]),
                                  encoder)
    same = set(restored) == set(best[-1]) and all(
        torch.equal(restored[k], best[-1][k]) for k in restored)
    print("[run_modes] best file {}: read back {}".format(
        os.path.basename(result["best_checkpoint"]),
        "bit for bit" if same else "DIFFERENT"), flush=True)
    if not all(np.isfinite(result["losses"])) or not same:
        raise Failed("pretraining gave a non-finite loss or its best file "
                     "does not read back")
    return counts


def _pretrain_steady(card, scene):
    """Steady pretraining steps on one batch of the full scene at each of
    PRETRAIN_BATCHES: ms/step, patches/s, peak memory. Returns
    (launches, figures)."""
    import numpy as np
    import torch

    from vit_cnn_tpu_torch.models.moco import DualModalEncoder
    from vit_cnn_tpu_torch.nn.layers import init_parameters
    from vit_cnn_tpu_torch.ops import _build
    from vit_cnn_tpu_torch.pipeline.patches import AugmentConfig
    from vit_cnn_tpu_torch.pipeline.twoview import TwoViewPipeline
    from vit_cnn_tpu_torch.train.pretrain import Pretrainer

    img1, img2, gt = scene
    pipe = TwoViewPipeline(img1, img2, gt, 9, [0], int(
        SCENE["VCT_SYN_CLASSES"]), augment=AugmentConfig(flip=True),
        device="cuda")
    figures, counts = {}, {}
    for batch in PRETRAIN_BATCHES:
        encoder = init_parameters(DualModalEncoder(img1.shape[2], 1), SEED)
        pre = Pretrainer(encoder.cuda(), {"batch_size": batch, "epoch": 1,
                                          "lr": 5e-4}, pipe,
                         queue_size=PRETRAIN_QUEUE, seed=SEED,
                         save_checkpoints=False)
        centers = torch.as_tensor(pipe.epoch_order(
            np.random.RandomState(SEED))[:batch], device="cuda")
        args = (centers, torch.ones(batch, device="cuda"),
                torch.zeros((), device="cuda"), 5e-4)
        pre._step(*args)                                  # not timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        t0 = time.perf_counter()
        loss_sum = args[2]
        for _ in range(PRETRAIN_STEADY):
            loss_sum = pre._step(centers, args[1], loss_sum, args[3])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts.update(_build.launches)
        f = figures[batch] = {
            "ms_per_step": 1e3 * secs / PRETRAIN_STEADY,
            "patches_per_s": PRETRAIN_STEADY * batch / secs,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print("[run_modes] steady pretraining steps ({}): {} of {} on the "
              "{} centers of the full scene: {:.2f} ms/step, {:.0f} "
              "patches/s, peak device memory {:.2f} GB; mean loss {:.4f}"
              .format(card, PRETRAIN_STEADY, batch, len(pipe),
                      f["ms_per_step"], f["patches_per_s"], f["peak_gb"],
                      float(loss_sum) / PRETRAIN_STEADY), flush=True)
        if not np.isfinite(float(loss_sum)):
            raise Failed("non-finite loss in the steady pretraining steps")
    return counts, figures


def _pretrain_crop(scene):
    """One float32 pretraining step (batch 64) on the card and on the CPU
    from the same weights, views, key variables and queue: the loss,
    every gradient (phase 6's limits), the new key variables and queue."""
    import numpy as np
    import torch

    from vit_cnn_tpu_torch.models.moco import DualModalEncoder, MoCoState
    from vit_cnn_tpu_torch.nn.layers import init_parameters
    from vit_cnn_tpu_torch.pipeline.patches import AugmentConfig
    from vit_cnn_tpu_torch.pipeline.twoview import TwoViewPipeline
    from vit_cnn_tpu_torch.train.pretrain import Pretrainer

    img1, img2, gt = (x[:40, :200] for x in scene)
    bands, batch = img1.shape[2], 64
    online = init_parameters(DualModalEncoder(bands, 1), SEED).state_dict()
    key = init_parameters(DualModalEncoder(bands, 1), SEED + 1).state_dict()
    pipe = TwoViewPipeline(img1, img2, gt, 9, [0], 15, augment=AugmentConfig(
        flip=True, radiation=True, mixture=True))
    centers = torch.as_tensor(pipe.indices[:batch])
    views = pipe.make_views(torch.Generator().manual_seed(SEED), centers)[:4]
    g = torch.Generator().manual_seed(SEED)
    queue = torch.randn((PRETRAIN_QUEUE, 128), generator=g)
    queue = queue / queue.norm(dim=1, keepdim=True)
    valid = torch.ones(batch)
    valid[-3:] = 0.0

    def one(device):
        encoder = DualModalEncoder(bands, 1)
        encoder.load_state_dict(online)
        encoder.to(device)
        pre = Pretrainer(encoder, {"batch_size": batch, "epoch": 1,
                                   "lr": 5e-4},
                         TwoViewPipeline(img1, img2, gt, 9, [0], 15,
                                         device=device),
                         queue_size=PRETRAIN_QUEUE, seed=SEED,
                         save_checkpoints=False)
        pre.moco = MoCoState({k: v.to(device) for k, v in key.items()},
                             queue.to(device), PRETRAIN_QUEUE - batch)
        loss = pre.loss([v.to(device) for v in views], valid.to(device))
        pre.optimizer.zero_grad()
        loss.backward()
        grads = {k: p.grad.cpu() for k, p in encoder.named_parameters()}
        pre.optimizer.step()
        state = {"queue": pre.moco.queue.cpu(), **{
            "key." + k: v.cpu() for k, v in pre.moco.key_variables.items()},
            **{"param." + k: v.detach().cpu()
               for k, v in encoder.named_parameters()}}
        return float(loss.detach()), grads, state, pre.moco.queue_ptr

    loss_cpu, g_cpu, s_cpu, ptr_cpu = one("cpu")
    loss_gpu, g_gpu, s_gpu, ptr_gpu = one("cuda")
    floor = GRAD_ATOL * max(float(x.norm()) for x in g_cpu.values())
    worst_g = max((float((g_gpu[k] - x).norm()) / (GRAD_TOL * float(x.norm())
                                                  + floor), k)
                  for k, x in g_cpu.items())
    worst_s = max((float((s_gpu[k] - v).abs().max())
                   / (STAT_TOL * max(float(v.abs().max()), 1e-30)), k)
                  for k, v in s_cpu.items() if not k.startswith("param."))
    dl = abs(loss_gpu - loss_cpu)
    print("[run_modes] pretraining step, card f32 vs cpu f32: loss {:.6f} / "
          "{:.6f} |diff| {:.2e}; {} gradients: worst ||diff|| {:.3f} of its "
          "limit ({}); queue and {} key variables: worst max|diff| {:.3f} of "
          "its limit ({}; limit {:g} x max|cpu|); pointer {} / {}".format(
              loss_gpu, loss_cpu, dl, len(g_cpu), worst_g[0], worst_g[1],
              len(s_cpu) - len(g_cpu) - 1, worst_s[0], worst_s[1], STAT_TOL,
              ptr_gpu, ptr_cpu), flush=True)
    if dl > 1e-3 * abs(loss_cpu) or worst_g[0] > 1.0 or worst_s[0] > 1.0 \
            or ptr_gpu != ptr_cpu or not np.isfinite(loss_gpu):
        raise Failed("the card's pretraining step disagrees with the CPU's")


def _debug_nans(state, card, scene):
    """The clean bf16 flagship step with and without --debug_nans' checks
    in turns, then a NaN parameter: FloatingPointError naming a module.
    Returns figures."""
    import numpy as np
    import torch

    from vit_cnn_tpu_torch.tools import train_step

    trainers = {flag: train_step(scene, state, "cuda", TRAIN_BATCH,
                                 bf16=True, flip=True, seed=SEED,
                                 debug_nans=flag) for flag in (False, True)}
    ms = {False: [], True: []}
    for flag in (False, True, True, False):
        t, losses = _timed_steps(*trainers[flag], NAN_STEPS)
        ms[flag].append(t)
    trainer, step_args = trainers[True]
    name, param = next(iter(trainer.model.named_parameters()))
    with torch.no_grad():
        param.view(-1)[0] = float("nan")
    try:
        trainer._step(*step_args)
        torch.cuda.synchronize()
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    print("[run_modes] --debug_nans ({}): clean bf16 steps of {} without "
          "the checks {} ms/step, with them {} ms/step; {} poisoned: {}"
          .format(card, TRAIN_BATCH, " ".join("{:.2f}".format(x)
                                              for x in ms[False]),
                  " ".join("{:.2f}".format(x) for x in ms[True]), name,
                  "FloatingPointError: " + raised if raised else
                  "NOTHING RAISED"), flush=True)
    if not raised or "output of" not in raised:
        raise Failed("--debug_nans did not stop the poisoned step at a "
                     "module")
    return {"ms_per_step_off": ms[False], "ms_per_step_on": ms[True],
            "raised": raised}


def phase_run_modes(tmp, state, card):
    """The port's remaining run modes on the card: stride > 1 serving,
    augmented training, MoCo pretraining and --debug_nans. Returns (the
    stride serving's launches, the augmented run_train's, the figures)."""
    from vit_cnn_tpu_torch.data import get_dataset

    t0 = time.perf_counter()
    marks = []

    def mark(what):
        marks.append("{} {:.1f} s".format(what, time.perf_counter() - t0))

    scene = get_dataset("Synthetic", tmp)[:3]
    figures = {}
    serve_counts, figures["serve_stride"] = _stride_serve(tmp, state, card,
                                                          scene)
    mark("stride serving")
    _stride_crop(state, scene)
    mark("stride crop")
    train_counts, figures["train_aug"] = _aug_train(tmp, state, card, scene)
    mark("augmented training")
    pre_counts = _pretrain_cli(tmp, card)
    mark("pretraining CLI")
    steady_counts, figures["pretrain"] = _pretrain_steady(card, scene)
    mark("pretraining steady")
    _pretrain_crop(scene)
    mark("pretraining crop")
    launched = {k: pre_counts.get(k, 0) + steady_counts.get(k, 0)
                for k in PATH_KERNELS}
    print("[run_modes] K1-K9 launches in pretraining: {}".format(
        json.dumps(launched)), flush=True)
    if any(launched.values()):
        raise Failed("pretraining launched kernels: {}".format(launched))
    figures["debug_nans"] = _debug_nans(state, card, scene)
    mark("debug_nans")
    print("[run_modes] phase {:.1f} s (cumulative: {})".format(
        time.perf_counter() - t0, "; ".join(marks)), flush=True)
    return serve_counts, train_counts, figures


def _shuffle_stream_kernels(rows):
    """K2 and K3 (and their adjoints K6, K7) at the shuffle paths' stream
    counts (nb, nr) of SHUFFLE_STREAMS, on a row drawn anew for every
    call after nb - 1 static ones, against their plain versions; the
    errors join phase 2's rows."""
    import torch

    from vit_cnn_tpu_torch.ops import dirstream

    g = torch.Generator(device="cuda").manual_seed(SEED)
    L, d, b = PATH_L, PATH_D, BAND_WINDOWS
    i32 = dict(dtype=torch.int32, device="cuda")
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for nb, nr in SHUFFLE_STREAMS:
            perms = [torch.randperm(L, generator=g, device="cuda")
                     for _ in range(nb)]
            orders = torch.stack(perms).to(torch.int32)
            inv = torch.stack([torch.argsort(p) for p in perms]).to(
                torch.int32)
            rev_rows = torch.arange(nr, **i32)
            u = randn(L, d, b).to(dtype)
            cw, cb = 0.5 * randn(4, d), 0.1 * randn(d)
            tag = "nb={} nr={} L={} d={} b={}".format(nb, nr, L, d, b)
            yf, yr = dirstream.dir_conv_silu(u, cw, cb, orders, rev_rows)
            err = _compare("K2 dir_conv_silu " + tag, (yf, yr),
                           dirstream.dir_conv_silu_reference(
                               u, cw, cb, orders, rev_rows), dn)
            _record(rows, "dir_conv_silu", err, dn)
            w = torch.softmax(randn(nb + nr), 0)
            wf, wr = w[:nb], w[nb:]
            err = _compare("K3 inv_perm_weighted_sum " + tag,
                           dirstream.inv_perm_weighted_sum(
                               yf, yr, wf, wr, inv, rev_rows),
                           dirstream.inv_perm_weighted_sum_reference(
                               yf, yr, wf, wr, inv, rev_rows), dn)
            _record(rows, "inv_perm_weighted_sum", err, dn)
            gf, gr = randn(nb, L, d, b).to(dtype), randn(nr, L, d, b).to(
                dtype)
            err = _compare("K6 dir_conv_silu bwd " + tag,
                           dirstream.dir_conv_silu_backward(
                               u, cw, cb, orders, rev_rows, gf, gr),
                           dirstream.dir_conv_silu_backward_reference(
                               u, cw, cb, orders, rev_rows, gf, gr), dn,
                           summed=(1, 2))
            _record(rows, "dir_conv_silu_backward", err, dn)
            cot = randn(L, d, b).to(dtype)
            err = _compare("K7 inv_perm_weighted_sum bwd " + tag,
                           dirstream.inv_perm_weighted_sum_backward(
                               gf, gr, wf, wr, inv, rev_rows, cot),
                           dirstream.inv_perm_weighted_sum_backward_reference(
                               gf, gr, wf, wr, inv, rev_rows, cot), dn,
                           summed=(2, 3))
            _record(rows, "inv_perm_weighted_sum_backward", err, dn)
            del u, yf, yr, gf, gr, cot
    torch.cuda.synchronize()


def _path_want(layer):
    """K1-K3 and K5-K7 launches of one float32 forward + backward of a
    Mamba layer: a forward (and a reverse) scan, one directional conv, one
    inverse sum unless the per-sample gate restores the directions
    apart."""
    nr = 1 if layer.rev_rows.numel() else 0
    k3 = 0 if layer.combine == "dynamic" else 1
    fwd = {"selective_scan": 1 + nr, "dir_conv_silu": 1,
           "inv_perm_weighted_sum": k3}
    return dict(fwd, **{k + "_backward": v for k, v in fwd.items()})


def _grad_ratio(g_card, g_cpu):
    """Worst ||card - cpu|| of a set of gradients against phase 6's limit
    GRAD_TOL ||cpu|| + GRAD_ATOL max ||cpu||, and its name."""
    floor = GRAD_ATOL * max(float(g.norm()) for g in g_cpu.values())
    return max((float((g_card[k] - g).norm())
                / (GRAD_TOL * float(g.norm()) + floor), k)
               for k, g in g_cpu.items())


def _card_vs_cpu(net, x, cot, draws=None):
    """One float32 forward + backward of ``net`` on the CPU (its draws
    recorded) and on the card (the draws replayed); returns (out_cpu,
    out_card, grads_cpu, grads_card, card launches). ``net`` ends on the
    card."""
    import torch

    from vit_cnn_tpu_torch.nn import noise
    from vit_cnn_tpu_torch.ops import _build

    rec = noise.Recorder(torch.Generator().manual_seed(SEED))
    outs, grads = {}, {}
    for device in ("cpu", "cuda"):
        net.to(device).zero_grad(set_to_none=True)
        xt = torch.tensor(x, device=device, requires_grad=True)
        source = rec if device == "cpu" else noise.Replay(rec.draws)
        if device == "cuda":
            torch.cuda.synchronize()
            _build.launches.clear()
        with noise.drawing(source):
            out = net(xt)
        out.backward(torch.tensor(cot, device=device))
        if device == "cuda":
            torch.cuda.synchronize()
            counts = dict(_build.launches)
        outs[device] = out.detach().to("cpu", copy=True)
        grads[device] = {"input": xt.grad.to("cpu", copy=True), **{
            k: p.grad.to("cpu", copy=True)
            for k, p in net.named_parameters() if p.grad is not None}}
    if draws is not None:
        draws.extend(rec.draws)
    return outs["cpu"], outs["cuda"], grads["cpu"], grads["cuda"], counts


def phase_path_types(rows, card):
    """Every path type of the Mamba layer, MambaMixer and the backbone's
    variants on the card against the CPU; returns (the launches of the
    checked float32 runs, summed, and the figures)."""
    import copy
    import numpy as np
    import torch

    from vit_cnn_tpu_torch.convert import seeded_state_dict
    from vit_cnn_tpu_torch.nn import MambaMixer, noise
    from vit_cnn_tpu_torch.nn.mamba import (DirectionalMambaBackbone,
                                            MultiDirMambaLayer)
    from vit_cnn_tpu_torch.nn.precision import bf16_train_apply
    from vit_cnn_tpu_torch.ops import _build
    from vit_cnn_tpu_torch.tools import median_ms as _median_ms

    t_phase = time.perf_counter()
    _shuffle_stream_kernels(rows)
    H, L, B = PATH_HIDDEN, PATH_L, PATH_BATCH
    rng = np.random.RandomState(SEED)
    total, figures, failed = {}, {"card": card, "layers": {}}, []

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def check(label, d, limit):
        ok = d <= limit
        if not ok:
            failed.append(label)
        return "ok" if ok else "FAIL"

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x_band = torch.randn((BAND_WINDOWS, L, H), generator=gen,
                         device="cuda").to(torch.bfloat16)
    x_train = torch.randn((TRAIN_BATCH, L, H), generator=gen, device="cuda",
                          requires_grad=True)
    for path in PATH_TYPES:
        layer = MultiDirMambaLayer(H, PATH_D, path, L)
        layer.load_state_dict(seeded_state_dict(layer, SEED))
        x = rng.randn(B, L, H).astype(np.float32)
        cot = rng.randn(B, L, H).astype(np.float32)
        draws = []
        want, got, g_cpu, g_card, counts = _card_vs_cpu(layer, x, cot, draws)
        add(counts)
        top = float(want.abs().max())
        d = float((got - want).abs().max())
        st = check(path + " f32", d, PATH_TOL * max(1.0, top))
        ratio, worst = _grad_ratio(g_card, g_cpu)
        st_g = check(path + " gradients", ratio, 1.0)
        expect = _path_want(layer)
        st_n = "ok" if all(counts.get(k, 0) == v for k, v in expect.items()) \
            else "FAIL"
        if st_n != "ok":
            failed.append(path + " launches")
        # bf16 on the card against its float32 output, same draws
        l16 = copy.deepcopy(layer).to(torch.bfloat16)
        with torch.no_grad(), noise.drawing(noise.Replay(draws)):
            o16 = l16(torch.tensor(x, device="cuda").to(torch.bfloat16))
        d16 = float((o16.float().cpu() - got).abs().max())
        st_b = check(path + " bf16", d16, PATH_BF16_TOL * top)
        # times: bf16 forward at the serving band, bf16 forward + backward
        # (float32 master weights, as training) at the train batch
        with torch.no_grad(), noise.drawing(gen):
            ms_fwd = _median_ms(lambda: l16(x_band), reps=PATH_REPS)
        train_fn = bf16_train_apply(layer)

        def step():
            with noise.drawing(gen):
                train_fn(x_train).sum().backward()

        ms_step = _median_ms(step, reps=PATH_REPS)
        layer.zero_grad(set_to_none=True)
        print("[path_types] {:<29s} f32 max|diff| {:.2e} of max|cpu| {:.2e} "
              "{}; {} gradients worst ||diff|| {:.2e} of its limit ({}) {}; "
              "bf16 vs f32 {:.2e} {}; launches {} {}; bf16 forward b={} "
              "{:.3f} ms, forward + backward b={} {:.3f} ms".format(
                  path, d, top, st, len(g_cpu), ratio, worst, st_g, d16,
                  st_b, json.dumps(counts, sort_keys=True), st_n,
                  BAND_WINDOWS, ms_fwd, TRAIN_BATCH, ms_step), flush=True)
        figures["layers"][path] = dict(
            f32_max_abs_diff=d, f32_max_abs=top, grad_worst_ratio=ratio,
            bf16_max_abs_diff=d16, launches=counts, shuffle_draws=len(draws),
            bf16_forward_ms=ms_fwd, bf16_forward_backward_ms=ms_step)
        del layer, l16, train_fn
    del x_band, x_train

    # the single MambaMixer, batch-major at the train batch
    mixer = MambaMixer(H, PATH_D)
    mixer.load_state_dict(seeded_state_dict(mixer, SEED))
    x = rng.randn(TRAIN_BATCH, L, H).astype(np.float32)
    cot = rng.randn(TRAIN_BATCH, L, H).astype(np.float32)
    want, got, g_cpu, g_card, counts = _card_vs_cpu(mixer, x, cot)
    add(counts)
    top = float(want.abs().max())
    d = float((got - want).abs().max())
    st = check("MambaMixer f32", d, PATH_TOL * max(1.0, top))
    ratio, worst = _grad_ratio(g_card, g_cpu)
    st_g = check("MambaMixer gradients", ratio, 1.0)
    expect = {"selective_scan": 1, "dir_conv_silu": 1,
              "selective_scan_backward": 1, "dir_conv_silu_backward": 1}
    st_n = "ok" if counts == expect else "FAIL"
    if st_n != "ok":
        failed.append("MambaMixer launches")
    print("[path_types] MambaMixer b={} L={} hidden={} d={}: f32 max|diff| "
          "{:.2e} of max|cpu| {:.2e} {}; {} gradients worst ||diff|| {:.2e} "
          "of its limit ({}) {}; launches {} {}".format(
              TRAIN_BATCH, L, H, PATH_D, d, top, st, len(g_cpu), ratio,
              worst, st_g, json.dumps(counts, sort_keys=True), st_n),
          flush=True)
    figures["MambaMixer"] = dict(f32_max_abs_diff=d, f32_max_abs=top,
                                 grad_worst_ratio=ratio, launches=counts)
    del mixer

    # 2-layer backbones: cls positions, output types, position embeddings,
    # 'multi_clock_gate' and dropout in train mode
    side = int(round(L ** 0.5))
    for path, pe, cls, out, rate in PATH_BACKBONES:
        net = DirectionalMambaBackbone(H, 2, PATH_D, side, H, path_type=path,
                                       out_type=out, pe_type=pe,
                                       cls_position=cls, drop_rate=rate)
        net.load_state_dict(seeded_state_dict(net, SEED))
        net.train(rate > 0)
        x = rng.randn(B, side, side, H).astype(np.float32)
        with torch.no_grad(), noise.drawing(torch.Generator()):
            shape = net(torch.tensor(x)).shape
        cot = rng.randn(*shape).astype(np.float32)
        draws = []
        want, got, g_cpu, g_card, counts = _card_vs_cpu(net, x, cot, draws)
        add(counts)
        top = float(want.abs().max())
        d = float((got - want).abs().max())
        label = "backbone {} pe={} cls={} out={} drop={}".format(
            path, pe, cls, out, rate)
        st = check(label, d, PATH_TOL * max(1.0, top))
        ratio, worst = _grad_ratio(g_card, g_cpu)
        st_g = check(label + " gradients", ratio, 1.0)
        mixers = 0 if path == "multi_clock_gate" else 2
        fwd = _path_want(net.mixer0) if mixers else {}
        expect = {k: mixers * v for k, v in fwd.items()}
        st_n = "ok" if all(counts.get(k, 0) == v for k, v in expect.items()) \
            else "FAIL"
        if st_n != "ok":
            failed.append(label + " launches")
        print("[path_types] {}: out {} f32 max|diff| {:.2e} of max|cpu| "
              "{:.2e} {}; {} gradients worst ||diff|| {:.2e} of its limit "
              "({}) {}; {} draws; launches {} {}".format(
                  label, tuple(shape), d, top, st, len(g_cpu), ratio, worst,
                  st_g, len(draws), json.dumps(counts, sort_keys=True),
                  st_n), flush=True)
        figures.setdefault("backbones", {})[label] = dict(
            f32_max_abs_diff=d, f32_max_abs=top, grad_worst_ratio=ratio,
            draws=len(draws), launches=counts)
        del net
    torch.cuda.synchronize()
    figures["seconds"] = time.perf_counter() - t_phase
    print("[path_types] {:.1f} s".format(figures["seconds"]), flush=True)
    if failed:
        raise Failed("path_types: {}".format(", ".join(failed)))
    return total, figures


def phase_mesh(tmp, state, card):
    """The mesh on the one-card host: the default run's world size (1),
    then two gloo ranks sharing the card (``make_mesh(2, share=True)``)
    against world size 1 on the card, the flagship at full width on a crop
    of the scene in float32 (``tools/mesh_check.py`` ``compare``): train
    steps (loss, trajectory, BatchNorm statistics, replicas, K1-K7 on both
    ranks), the stride-1 and stride-2 maps, a resumable file round trip
    and one MoCo step. Returns (K1-K7's launches in the 2-rank steps,
    summed over the ranks; the figures)."""
    import torch

    from vit_cnn_tpu_torch import cli
    from vit_cnn_tpu_torch.convert import seeded_state_dict
    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.models.moco import DualModalEncoder
    from vit_cnn_tpu_torch.tools import mesh_check as mc

    t0 = time.perf_counter()
    size = cli._mesh_size(cli.build_parser().parse_args(
        ["--dataset", "Synthetic"]))
    print("[mesh] {} CUDA device(s); the default run's mesh: world size {}"
          .format(torch.cuda.device_count(), size), flush=True)
    if torch.cuda.device_count() == 1 and size != 1:
        raise Failed("one card, yet the default run makes a mesh")

    img1, img2, gt = get_dataset("Synthetic", tmp)[:3]
    hp = dict(dataset="Synthetic", n_classes=int(SCENE["VCT_SYN_CLASSES"]),
              n_bands=(img1.shape[2], img2.shape[2]), ignored_labels=[0],
              batch_size=MESH_BATCH, epoch=1, flip_augmentation=True)
    crop = tuple(x[:MESH_CROP[0], :MESH_CROP[1]] for x in (img1, img2, gt))
    case = dict(model="Multimodality_Mamba", scene=crop, hp=hp, state=state,
                dtype="float32", device="cuda", seed=SEED)
    map_case = dict(case, scene=tuple(x[:12, :64] for x in (img1, img2, gt)))
    moco_case = dict(
        scene=crop, device="cuda", seed=SEED,
        state=seeded_state_dict(DualModalEncoder(img1.shape[2], 1), SEED),
        hp=dict(patch_size=9, lr=5e-4, epoch=1, batch_size=MESH_BATCH,
                radiation=True, mixture=True))
    figures, bad = mc.compare(
        2, "cuda", True, case, map_case, moco_case, PRETRAIN_QUEUE, tmp,
        say=lambda text: print("[mesh] " + text, flush=True))
    launches = figures.pop("launches")
    for r, counts in enumerate(launches):
        _check_counts(counts, mc.STEPS, "mesh rank {}".format(r))
    print("[mesh] ({}) host time a step, steps 2-{}: world size 1 {:.2f} ms, "
          "2 ranks sharing the card {:.2f} ms (two processes on one card: "
          "no measure of a multi-GPU speed); group start {:.1f} s".format(
              card, mc.STEPS, figures["ms_per_step_world_1"],
              figures["ms_per_step"], figures["group_start_s"]), flush=True)
    print("[mesh] phase {:.1f} s (world size 1 {:.1f} s, the 2-rank group "
          "{:.1f} s)".format(time.perf_counter() - t0, figures["world_1_s"],
                             figures["group_s"]), flush=True)
    if bad:
        raise Failed("mesh: {}".format("; ".join(bad)))
    return {k: sum(c.get(k, 0) for c in launches)
            for k in PATH_KERNELS + BN_TRAIN}, figures


def phase_bench_models(card):
    """``tools/bench_models.py``'s serving and train measurements of
    ``BENCH_MODELS`` on the full scene. Returns (the launches of their
    runs; the reports and the phase's seconds)."""
    import math

    import torch

    from vit_cnn_tpu_torch.ops import _build
    from vit_cnn_tpu_torch.tools import bench_models as bm
    from vit_cnn_tpu_torch.tools import load_scene

    t0 = time.perf_counter()
    scene = load_scene()
    _build.launches.clear()
    reports = [bm.bench(name, scene, torch.device("cuda"), "both",
                        BENCH_BUDGET_S, 1) for name in BENCH_MODELS]
    counts = dict(_build.launches)
    bad = []
    for r in reports:
        print("[bench_models] ({}) {}".format(card, bm.row(r)), flush=True)
        rates = [r[k] for k in ("windows_per_s", "request_s",
                                "patches_per_s", "host_ms_per_step",
                                "device_ms_per_step")]
        if not all(math.isfinite(v) and v > 0 for v in rates):
            bad.append("{}: a rate not finite and positive".format(
                r["model"]))
        if r["batch"] != bm.BATCH:
            bad.append("{}: trained at batch {}, not {}".format(
                r["model"], r["batch"], bm.BATCH))
    _check_counts(counts, None, "bench_models")
    seconds = time.perf_counter() - t0
    print("[bench_models] phase {:.1f} s".format(seconds), flush=True)
    if bad:
        raise Failed("bench_models: {}".format("; ".join(bad)))
    return counts, {"reports": reports, "seconds": seconds}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    os.environ.update(SCENE)      # the Synthetic registry reads these
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import vit_cnn_tpu_torch  # noqa: F401
    except ImportError as e:
        print("chip_smoke: the port is not beside this script: {}".format(e),
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = phase_device()
        print("[kernels]", flush=True)
        rows = phase_kernels()
        phase_adjoints(rows)
        sweep_counts = phase_variants(rows)
        path_counts, path_figures = phase_path_types(rows, card)
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)       # the CLI's ./checkpoints and ./results
            try:
                counts, _, state = phase_slice(tmp)
                phase_crop(tmp, state)
                train_counts, steady = phase_train(tmp, state)
                phase_train_crop(tmp, state)
                runloop_counts = phase_runloop(tmp, state, card)
                zoo_counts = phase_zoo(tmp)
                phase_zoo_crop(tmp)
                zoo_train_counts, zoo_steady = phase_zoo_train(tmp, rows,
                                                               card)
                cnn_serve_counts, cnn_train_counts, cnn_figures = \
                    phase_cnn_zoo(tmp, card)
                stride_counts, aug_counts, mode_figures = \
                    phase_run_modes(tmp, state, card)
                mesh_counts, mesh_figures = phase_mesh(tmp, state, card)
                bench_counts, bench_figures = phase_bench_models(card)
            finally:
                os.chdir(here)
    except Failed as e:
        print("chip_smoke: FAILED: {}".format(e), file=sys.stderr)
        return 1

    sources = {
        "selective_scan": ("vit_cnn_tpu_torch/csrc/selective_scan_fwd.cu",
                           "vit_cnn_tpu/ops/selective_scan.py:60"),
        "dir_conv_silu": ("vit_cnn_tpu_torch/csrc/dirstream.cu",
                          "vit_cnn_tpu/ops/dirstream.py:104"),
        "inv_perm_weighted_sum": ("vit_cnn_tpu_torch/csrc/dirstream.cu",
                                  "vit_cnn_tpu/ops/dirstream.py:308"),
        "fused_attention": ("vit_cnn_tpu_torch/csrc/attention.cu",
                            "vit_cnn_tpu/ops/attention.py:34"),
        "bn_act": ("vit_cnn_tpu_torch/csrc/bn_act.cu",
                   "none: XLA fuses the JAX package's BatchNorm chain"),
        "bn_train": ("vit_cnn_tpu_torch/csrc/bn_train.cu",
                     "none: XLA fuses the JAX package's BatchNorm chain"),
        "selective_scan_backward": (
            "vit_cnn_tpu_torch/csrc/selective_scan_bwd.cu",
            "vit_cnn_tpu/ops/selective_scan.py:215"),
        "dir_conv_silu_backward": ("vit_cnn_tpu_torch/csrc/dirstream_bwd.cu",
                                   "vit_cnn_tpu/ops/dirstream.py:224"),
        "inv_perm_weighted_sum_backward": (
            "vit_cnn_tpu_torch/csrc/dirstream_bwd.cu",
            "vit_cnn_tpu/ops/dirstream.py:377"),
        "fused_attention_heads": ("vit_cnn_tpu_torch/csrc/heads_attention.cu",
                                  "vit_cnn_tpu/ops/attention.py:108"),
        "pooled_heads_attention": (
            "vit_cnn_tpu_torch/csrc/heads_attention.cu",
            "vit_cnn_tpu/ops/attention.py:314"),
        "selective_scan_tiled": (
            "vit_cnn_tpu_torch/csrc/selective_scan_fwd.cu",
            "perf/scan_sweep.py:47"),
        "selective_scan_batch_major": (
            "vit_cnn_tpu_torch/csrc/scan_variants.cu",
            "perf/scan_bm_sweep.py:27"),
        "heads_attention_mma": ("vit_cnn_tpu_torch/csrc/heads_variants.cu",
                                "perf/mhst_attn_variants.py:111"),
        "heads_attention_outer": ("vit_cnn_tpu_torch/csrc/heads_variants.cu",
                                  "perf/mhst_attn_vpu.py:55"),
    }
    # the probe variants each row 12 / 13 kernel also stands for
    # (V3: F, G; V4: H, C, E, and A and B, whose float32 dots and float32 P
    # are V4's arithmetic on bf16 inputs, not V3's bf16 operands)
    also = {"heads_attention_mma": ["perf/mhst_attn_variants.py:90",
                                    "perf/mhst_attn_vpu.py:79"],
            "heads_attention_outer": ["perf/mhst_attn_variants.py:41",
                                      "perf/mhst_attn_variants.py:58",
                                      "perf/mhst_attn_variants.py:74",
                                      "perf/mhst_attn_variants.py:138"]}
    # launches: the flagship forward kernels' count from its serving run,
    # the adjoints' from the training run, K8 and K9 from the zoo's
    # serving runs, the variants' from the sweep (each run's counts were
    # set to 0 just before it); launches_by_path has every path
    zoo = {k: sum(c.get(k, 0) for c in zoo_counts.values())
           for k in sources}
    zoo_train = {k: sum(c.get(k, 0) for c in zoo_train_counts.values())
                 for k in sources}
    cnn = {k: sum(c.get(k, 0) for c in list(cnn_serve_counts.values())
                  + list(cnn_train_counts.values())) for k in sources}
    paths = {"serve": counts, "train": train_counts,
             "runloop": runloop_counts, "serve_zoo": zoo,
             "train_zoo": zoo_train, "cnn_zoo": cnn,
             "serve_stride": stride_counts, "train_aug": aug_counts,
             "path_types": path_counts, "sweep": sweep_counts,
             "mesh": mesh_counts, "bench_models": bench_counts}
    table = [dict(name=name, route="cuda", source=src, replaces=rep,
                  launches=paths["train" if name in ADJOINTS + BN_TRAIN else
                                 "serve_zoo" if name in HEADS else
                                 "sweep" if name in VARIANTS else
                                 "serve"].get(name, 0),
                  launches_by_path={k: c.get(name, 0)
                                    for k, c in paths.items()},
                  **({"also_replaces": also[name]} if name in also else {}),
                  **rows[name])
             for name, (src, rep) in sources.items()]
    print("[train] {}".format(json.dumps(steady)), flush=True)
    print("[zoo_train] {}".format(json.dumps(zoo_steady)), flush=True)
    print("[cnn_zoo] {}".format(json.dumps(cnn_figures)), flush=True)
    print("[run_modes] {}".format(json.dumps(mode_figures)), flush=True)
    print("[path_types] {}".format(json.dumps(path_figures)), flush=True)
    print("[mesh] {}".format(json.dumps(mesh_figures)), flush=True)
    print("[bench_models] {}".format(json.dumps(bench_figures)), flush=True)
    print(card, flush=True)                  # nvidia-smi name, power.limit
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
