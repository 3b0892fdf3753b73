#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pbe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py    # every phase; exits 0 only if all pass

Phases:
  1. card name and power limit, torch/CUDA versions; build the kernels
     from csrc/flash_fwd.cu (the models' forward kernels), flash_variants.cu
     (the resident and pipelined kernels), flash_bwd.cu (the backward
     kernels, the d = 512 pair among them), one nvcc each, started
     together, and flash_fp32.cu (the fp32 forward, resident, pipelined, dQ
     and dK/dV kernels; minutes to build) and flash_anyd.cu (the forward,
     dQ and dK/dV kernels at any head dim), started together after phase
     13; print each kernel's registers and spills from their -Xptxas -v
     reports.
  2. each kernel against its plain PyTorch version at the shapes the 512^2
     edit gives it (bf16), at ragged N for every padded head dim, and with
     peaked scores, a row max rising at every key tile and packed q/k/v
     views at the edit's head dims; then timed beside the plain version and
     the one PyTorch call that computes the same function (CUDA events
     around a CUDA graph of 20 calls, and the kernel's eager launches too).
  3. one full-width v1 CFG UNet call (64^2 latent, batch 2, bf16) with the
     flash kernel and with plain attention.
  4. the slice: load_pipeline("configs/v1.yaml") with random weights, a
     512^2 50-step PLMS edit at CFG scale 5 with every kernel's launch count
     set to 0 just before and read just after, then timed warm edits, and
     one edit with block=False polled with is_ready() and read back
     against the same edit with block=True.
  5. device time of one warm v1 CFG UNet call by kernel (torch.profiler)
     and the device's idle share.
  6. a small edit (configs/tiny.yaml, 64^2) on the card in bf16 against the
     same edit on the CPU in fp32, the path the CPU tests hold against JAX.
Training (the second slice):
  7. the backward kernels (csrc/flash_bwd.cu) against their plain versions
     at the v1 training shapes (batch 4), with peaked scores and packed
     q/k/v views there, and at ragged N for every padded head dim, each
     launched twice and compared bitwise; then timed beside the plain
     versions and SDPA's backward alone (all around CUDA graphs); the
     forward kernel with the LSE timed at the same shapes. Then
     flash_attention(q, k, v) backpropagated from three cotangents it
     cannot read in place (out.sum()'s expanded one, a permuted one with
     a head-dim stride of H, one at a 2-element offset) at (4, 4096, 8,
     40) and (4, 1024, 1, 512), each gradient against the plain backward
     on the same cotangent.
  8. one v1 UNet loss at batch 4 (bf16, remat) backpropagated through the
     flash kernels and through plain attention: the gradients compared.
  9. the slice: Trainer.fit on v1 at full width, batch 4, 512^2, with the
     launch counts per step checked, loss, grad_norm, frozen weights and
     AdamW state checked, step p50, images/s, peak memory and one step's
     device time by group (torch.profiler).
 10. 3 training steps of configs/tiny.yaml on the card in bf16 against the
     same steps on the CPU in fp32 (the path the CPU tests hold against
     JAX).

The attention benchmark (the third slice, its kernels redesigned in the
sixth):
 11. the resident and pipelined kernels (csrc/flash_variants.cu) against
     the plain version at ragged and odd shapes, at every key block they
     instantiate and every cluster size of the resident kernel; at the
     benchmark's shapes (the VAE's included) every
     flash_forward(variant=...) call against the plain version and counted
     as one launch of its kernel, both kernels on inputs whose row max
     rises at every key tile, and at every key block and cluster size;
     each timed (a CUDA graph of 20 calls) beside the plain version and
     SDPA, the resident kernel at clusters of 1, 2 and 4; then the bench
     entry (pbe_tpu_torch.scripts.bench_attention) over every shape and
     impl, with every kernel's launch count set to 0 just before and read
     just after. Then K3 and K4 at fp32 (csrc/flash_fp32.cu) by the same
     recipe: against the plain version at fp32 (max|err| <= 2^-14
     max|ref|, rel L2 <= 1e-5, the LSE too) at the same shapes, every fp32
     key block and cluster size, on randn, peaked and rising-max scores;
     each flash_forward(variant=...) call on fp32 operands one launch of
     its fp32 kernel and of no other; each timed beside the plain version,
     SDPA at fp32 and the FMA bound (rows with "dtype": "float32", their
     launches those of the flash_forward calls, counted from 0).

The edit CLIs (the seventh slice):
 12. on phase 4's v1 pipeline, a checkpoint of the tensors that
     randomize_zero_params changed (so the CLIs load the same weights) and
     512^2 input PNGs; pbe_tpu_torch.scripts.inference.main in-process:
     (a) DDIM 50 at scale 5, three iterations, the result PNG against
     edit_batch's and 802 flash launches an edit; (b) PLMS with
     --paste_back 8, the watermark read back from the stamped result and
     every mask==1 pixel of an unstamped twin equal to the source PNG's,
     818 launches each; (c) the default scale 1 (batch 1, 802 launches);
     then inference_test_bench.main over 6 synthetic COCOEE pairs at
     --n_samples 4 (2 x 818 launches, 6 results, 6 grids, its steady-state
     edits/s). Each run's launches are counted from 0. Then the forward
     kernel against its plain version and timed at the shapes those runs
     gave it (batch 1, 4 and 8; the VAE at batch 2 and 4). Last of all, a
     tiny DDIM (eta 0.5) and full-chain DDPM edit on the card in bf16
     against the same edit on the CPU in fp32, noise injected.

Serving and int8 (the eighth slice), on phase 4's v1 pipeline:
 13. EditServer (PLMS 50, scale 5, buckets 1/2/4/8, uint8 out): warmup()
     with 818 flash launches a bucket; a request's result within bucket 4
     bitwise equal whatever its batch-mates, its difference across buckets
     1 and 4 printed; 8 threads submitting 16 requests (every future
     resolved, each request counted once, 818 launches a batch, latency p50,
     edits/s, occupancy); a burst of 4 at bucket 1 against the same 4 one at
     a time (what the double-buffered dispatch hides); two servers, one
     seed, the same bits; the HTTP front (pbe_tpu_torch.scripts.serve) on
     a loopback port, its PNGs equal to EditServer.edit's; the forward
     kernel against its plain version and timed at bucket 8's shapes.
 14. w8a8 int8: at three v1 ops in bf16 the card's int8 operands and int32
     accumulators equal the CPU's, each op within rel L2 0.02 of the fp op;
     a 512^2 dynamic and a calibrated static int8 edit at 10 PLMS steps
     (INT8_STEPS), each within mean abs 0.05 of the fp edit and not equal
     to it, every eligible op of the 11 UNet calls through the int8
     product; fp/dynamic/static edit p50; a single-bucket int8 server
     reproducible bit for bit.

The training CLI (the ninth slice), after phase 9 has freed its model:
 15. a synthetic OpenImages tree (16 + 4 images at 512², seed 0, the port's
     writer) and a data YAML at batch 4; pbe_tpu_torch.scripts.train.main
     in-process on configs/v1.yaml with --scale_lr --bf16_moments, 8 steps,
     validation at step 8 with 10-step DDIM grids at CFG batch 8 and the FID
     trio (random Inception weights), then --resume to step 9. Checked:
     finite losses, step 1's within 1 +- 0.1 (the zero-init eps head),
     trainable weights moved and frozen ones bitwise unchanged, bf16 first
     and fp32 second moments, every step's launches equal to phase 9's, the
     validation's K1/K2 launches, 4 grids and finite FIDs in the JSONL, the
     native mask helpers used, the checkpoint restored bit for bit. Printed
     beside the card line: the CLI's step p50 and images/s against phase
     9's, the host's wait on the DataLoader, peak memory against phase 9's,
     and the validation's time by part.

Evaluation and first-stage training (the tenth slice):
 16. the evaluation CLIs in-process: 64 + 64 synthetic 512^2 PNGs (the
     port's writer), eval_fid on Inception and on --clip-features (random
     weights), eval_clip_score over a 16-pair COCOEE directory and its
     results, eval_gmm on a pickled k=20, 2048-d full-covariance GMM
     stand-in built from numpy, create_square_gt_for_fid; every number
     finite and in range, the card's float64 GMM log-likelihoods within
     1e-9 of a CPU run of the same code, the bf16 CLIP B/32 embeddings
     within 2e-2 cosine of the fp32 CPU ones; each CLI's time.
 17. the backward kernels at the VAE's head dim 512 (csrc/flash_bwd.cu's
     wide pair on wgmma: clusters of 2 blocks that split the head dim, 64
     rows a block, 32-row tiles by TMA) against their plain versions at
     (4, 1024, 1, 512) (phase 18's shape) and (2, 4096, 1, 512), at N = 20,
     77 and 1000, one row short of and past a 64-row block and a 32-row
     tile (N = 33, 63, 65, 129), on peaked scores and on q/k/v as views of
     one packed (B, N, 3, 1, 512) tensor, each launched twice and compared
     bitwise; the forward with the LSE at the same shapes; each timed (CUDA
     graphs) beside its plain version, SDPA's (its backward alone), naming
     SDPA's backend, and the bound; the pair's launch geometry printed.
 18. the slice: make_vae_train_step on v1's first stage at full width
     (256^2, batch 4, bf16, flash, PatchDiscriminator(64, 3), the VGG16
     term, disc_start=0) for 8 steps with every kernel's launch count set
     to 0 just before and read just after (6 K2, 2 of them with the LSE, 2
     K5 and 2 K6 a step); finite losses, d_weight in [0, 5000], weights
     moved; step p50, images/s, peak memory and one step's device time by
     group (torch.profiler) with the K5/K6 share.
 19. 3 training steps of a configs/tiny.yaml-sized first stage on the card
     in bf16 against the same steps on the CPU in fp32, noise injected.

--precision full, tiling and the safety checker (the eleventh slice):
 20. the fp32 kernels (csrc/flash_fp32.cu) against their plain versions at
     fp32: the forward at every edit shape and the VAE's, with and without
     the LSE, at ragged N for every padded head dim and every tile it picks
     by size, on peaked scores, on a row max rising at every key tile and on
     packed q/k/v views; the dQ and dK/dV kernels at the training shapes and
     (4, 1024, 1, 512), at ragged N and on the same stress inputs; every
     kernel launched twice and compared bitwise; max|err| <= 2^-14 max|ref|
     and rel L2 <= 1e-5. Each timed beside its plain version and SDPA at
     fp32 (its backend named), with its bound at fp32 accuracy (rows with
     "dtype": "float32"; S on FMA, the other products, P V in the forward,
     as 3xTF32 on the tensor cores), the all-FMA bound in the log.
     On the rising-max inputs, controls for the dQ check: dQ's distance
     from the plain version and from float64 when computed in other orders
     and with 3xTF32 products (logged, not checked).
 21. --precision full at full width, each run's launches counted from 0:
     scripts.inference.main on v1 (512^2, PLMS 50, CFG 5; 818 fp32 forward
     launches and no bf16 one), scripts.train.main --precision full on v1
     at batch 4, 512^2, 4 steps (the fp32 forward, dQ and dK/dV kernels as
     often a step as phase 9's bf16 ones, finite losses, step p50, peak
     memory), and make_vae_train_step on an fp32 first stage for 2 steps.
 22. phase 6's tiny edit and phase 10's 3 training steps in fp32 on the
     card against fp32 on the CPU: the edit within max 2e-3 / mean 2e-4 of
     [0,1], losses and gradient norms within 1e-4 relative.
 23. scripts.inference.main at 1024^2 (bf16, PLMS 50, CFG 5) un-tiled and
     with --tile_ks 64 --tile_stride 32 (9 crops, UNet calls at batch 18),
     the launches by shape printed; K1 at (2, 16384, 8, 40) and K2 at (1,
     16384, 1, 512) against the plain version (a few heads at a time) and
     timed beside it and SDPA; a tiny tiled edit, card bf16 against CPU
     fp32 with phase 6's bounds.
 24. the safety checker at ViT-L/14 geometry from a seeded diffusers-layout
     state_dict (torch.save to a .bin) through scripts.inference.main
     --safety_ckpt --n_samples 2: thresholds from a first pass's
     embeddings so that exactly sample 0 flags; under --enforce_safety its
     result is black and the other equal to the first pass's; the card's
     fp32 cosines and scores within 1e-4 of the CPU's.

The frozen edit program (the sixteenth slice):
 25. on phase 4's weights (its seeded checkpoint), the 512^2 50-step PLMS
     edit at CFG 5, bf16, det_first_stage, frozen by
     pbe_tpu_torch.scripts.verify_frozen_program.main (export_edit_program:
     a prologue, one step body run 47 times, an epilogue; params.npz) and
     run in its own process holding no model code: max|diff| <= 0.02
     against the live edit, 818 flash launches (816 K1 by phase 4's
     shapes, 2 K2), two frozen calls bitwise equal; its row (export,
     params load, the live and frozen first and warm call seconds, MB)
     printed with the card line, and the FLOPs of one CFG UNet call (torch.utils.flop_counter,
     the flash ops by their formulas) with the flash share. The int8
     program at v1's widths, its UNet cut to one res block a level
     (FROZEN_INT8_RES_BLOCKS) with its own seeded weights, runs beside it
     (two processes started together) at 10 PLMS steps (FROZEN_STEPS).

The remaining user scripts and the legacy models (the seventeenth slice):
 26. on phase 4's weights (its seeded checkpoint), pbe_tpu_torch.scripts.test
     .main on configs/v1.yaml over a synthetic OpenImages tree (512^2, 2
     batches of 4): the loss of each batch (Trainer.validate), 50-step DDIM
     at CFG 5 with 6-panel grids, the FID trio on random Inception; the JAX
     CLI's result keys, every value finite, K1/K2 launches by shape (820 a
     batch); the forward kernel at those shapes against its plain version
     and timed. Then weights_runbook --dry_run on configs/tiny.yaml
     (--skip_int8 --skip_frozen --bench_size 64): every step, a port CLI
     in a subprocess on the card, exits 0.
 27. scripts.train_overfit_demo.main on v1 at 512^2 (bf16, remat, constant
     LR), batch 8, 30 steps, then its 50-step DDIM at scales 1 and 5: step
     p50, images/s, peak memory, first and last loss_simple, latent rel-MSE,
     launches a step (34 K1/K2, 16 K5, 16 K6); the JAX demo's files; the
     kernels at the step's shapes against their plain versions and timed;
     a tiny (configs/tiny.yaml, 64^2) 2-step demo and its sampling, fp32,
     card against CPU with the draws injected.
 28. the legacy models at published widths, fp32, card against CPU on the
     same seeded weights (max|diff| <= 1e-4 of the output's RMS):
     EncoderUNetModel (guided-diffusion's 64x64 classifier) and
     classifier_loss, TextTransformer (LDM's BERTEmbedder, 1280 x 32),
     vae_legacy.Model (DDPM CIFAR-10; also with attn_impl="flash" on the
     same weights against "plain" on the card: six flash_fwd_anyd
     launches), LatentRescaler with "flash" (one K2 launch at (2, 4096, 1, 512), also
     against "plain" on the card, its row timed), MergedRescaleEncoder and
     Decoder at the v1 VAE's widths at 256^2.

The flash kernels at any head dim (the eighteenth slice):
 29. csrc/flash_anyd.cu's build seconds, each kernel's ptxas registers
     and spills, and the tensor-core instructions (HMMA) of the bf16
     forward, dQ and dK/dV and the fp32 forward and dK/dV in the library's
     SASS (cuobjdump; the phase fails without them, with no SIMT kernel
     left in their place, or where the dQ, the fp32 forward or the fp32
     dK/dV spills); its forward, dQ
     and dK/dV kernels, bf16 and fp32, against their plain versions at
     d = 1 ... 1024 (ANYD_DIMS; N = 77), on peaked and rising-max scores
     and packed q/k/v views, each launched twice and compared bitwise, and
     the bf16 forward, dQ and dK/dV and the fp32 forward and dK/dV at the
     DDPM shape on operands at odd offsets (load pieces of 8, 4, 2, 1
     elements),
     checked and timed; then the DDPM CIFAR-10 UNet
     (vae_legacy.Model, Ho et al. 2020's widths, attn_impl="flash") at
     batch 128: a forward and the gradient of its epsilon-MSE loss at fp32
     and bf16, each run 6 flash_fwd_anyd launches (5 at (128, 256, 1,
     256), 1 at (128, 16, 1, 256)) and the gradient 6 of each backward
     kernel, nothing else; held against plain attention on the card and
     the CPU at batch 16; step p50 and peak memory; each kernel timed at
     the DDPM shapes and at d = 64 and 128 beside its plain version,
     SDPA (rows named *_anyd), the log lines of the bf16 dQ, the fp32
     forward and the fp32 dK/dV rows with their times before their
     redesign (ANYD_BEFORE_MS).

The resident and pipelined kernels at any head dim (the twenty-first slice):
 30. csrc/flash_variants_anyd.cu's build seconds, each kernel's ptxas
     registers and spills and its HMMA count (the phase fails on a spill,
     a missing instantiation, a K3/K4 kernel without HMMA or a SIMT fp32
     K3/K4 left in the library); K3 and
     K4 at bf16 and fp32 against the plain version at every key block at
     d = 1 ... 1024 (ANYD_DIMS, 36, 150, 832, 833; N = 77) and at the
     tuned head dims' blocks their tables lack, on peaked and rising-max
     scores, packed q/k/v views, d = 1 at a head-dim stride of 2 and N =
     1, 5 and 17, each launched twice, counted by kernel name and compared
     bitwise; then one flash_forward(variant=...) call of each at its
     default block at (128, 256, 1, d) for d = 64, 128, 256 and at (2,
     4096, 8, 64), counted from 0, and each kernel timed there beside the
     plain version, SDPA and flash_fwd_anyd (rows named
     flash_{resident,pipelined}_anyd; the fp32 rows' log lines with their
     times before the tensor-core body, VARIANT_ANYD_BEFORE_MS).

A run takes them in the order 1, 2, 7, 17, 11's bf16 part, 3, 4, 12, 13,
14, 5, 8, 9, 15, 16, 18, 6, 10, 19, 12's tiny edits, 27, then 20, 11's
fp32 part, 21, 22, 23, 24, 25, 26, 28, 29, 30: kernels first, the timed
edits before the profiler, the card-vs-CPU comparisons last.
csrc/flash_fp32.cu, the slowest build (minutes, one host core),
csrc/flash_anyd.cu and csrc/flash_variants_anyd.cu start after phase 13, so that no nvcc runs beside the host-bound timings of
phases 4, 12 and 13; they build beside phases 14, 5, 8, 9, 15, 16, 18, 6,
10, 19, 12's tiny edits and 27 (which needs neither), and phase 20 waits
for them. Phase 26 runs the runbook in a thread beside scripts.test, and
12's tiny edits their CPU side in a second process beside the card's.
Every phase logs its seconds ("[clock]"), and the run its total.

Prints a {"kernels": [...]} line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when any phase fails or there is no CUDA device.

    python3 chip_smoke.py --only edit,serving[,frozen-bf16][,frozen-int8]
        [,test-split][,overfit][,legacy][,ddpm][,variants-anyd]

runs v1 with phase 4's random weights through just the named phases (4,
13, 25 with the named precisions: one alone, both side by side, 26, 27,
28, 29, 30), each kernel built at its first use, and prints their summaries (and
the kernel rows they add) as its last line instead of the contract line. Run from two trees in one call, it compares
their host paths on one card.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

# peak rates of one H100 SXM (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# special-function (exp2) throughput of H100 SXM5 as the FlashAttention-3
# paper gives it: B*H*N^2 exponentials bind before the products at d=40
EXP2_PER_S = 3.9e12
# fp32 FMA outside the tensor cores (132 SMs x 128 lanes x 2 x 1.98 GHz): the
# rate of csrc/flash_fp32.cu's forward kernels and of the backward's S
FP32_FLOP_PER_S = 66.9e12
# TF32 on the tensor cores (dense): the fp32 backward's other products run
# there as 3xTF32, three TF32 products each
TF32_FLOP_PER_S = 495e12

K1 = "pbe_tpu/ops/flash_attention.py:85"   # _flash_kernel_rowblock
K2 = "pbe_tpu/ops/flash_attention.py:218"  # _flash_kernel (streamed)
K3 = "pbe_tpu/ops/flash_attention.py:182"  # _flash_kernel_resident
K4 = "pbe_tpu/ops/flash_attention.py:111"  # _flash_kernel_pipelined
K5 = "pbe_tpu/ops/flash_attention.py:408"  # _flash_bwd_dq_kernel
K6 = "pbe_tpu/ops/flash_attention.py:445"  # _flash_bwd_dkv_kernel
# (name, (B, N, H, D), TPU kernel it replaces, launches per 512^2 CFG edit):
# UNet self-attention at CFG batch 2 (8 heads) and the VAE mid attention
FLASH_SHAPES = (
    ("unet_ds1", (2, 4096, 8, 40), K1, 5 * 51),
    ("unet_ds2", (2, 1024, 8, 80), K1, 5 * 51),
    ("unet_ds4", (2, 256, 8, 160), K1, 5 * 51),
    ("unet_ds8", (2, 64, 8, 160), K1, 1 * 51),
    ("vae_mid", (1, 4096, 1, 512), K2, 2),
)
LAUNCHES_PER_EDIT = sum(s[3] for s in FLASH_SHAPES)  # 818
# phase 25's PLMS steps: the bf16 frozen edit at phase 4's 50, the int8 one
# at 10 (the run's clock: its export, save and load, a host core each for
# minutes, do not shrink with the steps, but its eight timed calls do)
FROZEN_STEPS = {"bf16": 50, "int8": 10}
# ... and the int8 one's UNet depth: v1's widths at this many res blocks a
# level (v1: 2), its own seeded weights, since its export, save and program
# load (~350 s of one host core at full depth on a slow host) set the run's
# clock and shrink only with the model's depth
FROZEN_INT8_RES_BLOCKS = 1
# phase 14's int8 edits (dynamic, static, their timed turns beside fp and
# the server's) run this many PLMS steps: the checks hold every eligible
# op of every UNet call, and the steps only repeat them on a host-bound
# clock (a slow host took ~100 s at 50)
INT8_STEPS = 10
# a 50-step DDIM edit: 50 UNet calls of 16 self-attentions, 2 VAE ones
DDIM_LAUNCHES = 50 * 16 + 2  # 802
# phase 12, the CLIs: (name, (B, N, H, D), TPU kernel, CLI run, launches in
# that run). The inference CLI at its default --scale 1 runs the UNet once
# a step at batch 1 (DDIM, 50 calls); the test bench at --n_samples 4,
# scale 5, PLMS over 6 pairs runs a batch of 4 (8 at CFG) and the ragged
# last batch of 2 (4 at CFG), each 51 UNet calls, one VAE encode and one
# decode
CLI_SHAPES = (
    ("cli_b1_ds1", (1, 4096, 8, 40), K1, "scale 1", 5 * 50),
    ("cli_b1_ds2", (1, 1024, 8, 80), K1, "scale 1", 5 * 50),
    ("cli_b1_ds4", (1, 256, 8, 160), K1, "scale 1", 5 * 50),
    ("cli_b1_ds8", (1, 64, 8, 160), K1, "scale 1", 1 * 50),
    ("bench_b8_ds1", (8, 4096, 8, 40), K1, "test bench", 5 * 51),
    ("bench_b8_ds2", (8, 1024, 8, 80), K1, "test bench", 5 * 51),
    ("bench_b8_ds4", (8, 256, 8, 160), K1, "test bench", 5 * 51),
    ("bench_b8_ds8", (8, 64, 8, 160), K1, "test bench", 1 * 51),
    ("bench_b4_ds1", (4, 4096, 8, 40), K1, "test bench", 5 * 51),
    ("bench_b4_ds2", (4, 1024, 8, 80), K1, "test bench", 5 * 51),
    ("bench_b4_ds4", (4, 256, 8, 160), K1, "test bench", 5 * 51),
    ("bench_b4_ds8", (4, 64, 8, 160), K1, "test bench", 1 * 51),
    ("bench_vae_b4", (4, 4096, 1, 512), K2, "test bench", 2),
    ("bench_vae_b2", (2, 4096, 1, 512), K2, "test bench", 2),
)
# phase 13, the server's largest default bucket: 8 requests at CFG batch 16
# (launches in the warmup of bucket 8: 51 UNet calls, one encode, one decode)
SERVE_SHAPES = (
    ("serve_b8_ds1", (16, 4096, 8, 40), K1, 5 * 51),
    ("serve_b8_ds2", (16, 1024, 8, 80), K1, 5 * 51),
    ("serve_b8_ds4", (16, 256, 8, 160), K1, 5 * 51),
    ("serve_b8_ds8", (16, 64, 8, 160), K1, 1 * 51),
    ("serve_b8_vae", (8, 4096, 1, 512), K2, 2),
)
# bf16 tolerance of kernel vs plain, relative to the output's scale (|O| is
# ~0.02 at N=4096 with randn inputs, not ~1): both round q*scale, P and O to
# bf16 the same way, but the kernel's online softmax rounds P against a
# running max, so an element of O may land one bf16 ulp (<= 2^-7 of its
# value) away. Allowed: max|err| <= 2^-6 max|O| and rel L2 <= 1e-2; a wrong
# rescale or PV of even a few percent fails the L2 check.
OUT_MAX_REL = 2.0 ** -6
OUT_L2_REL = 1e-2
LSE_ATOL = 1e-3  # fp32 log2-domain statistics (~12), summed in another order
# N that no q tile (256 rows at d=40, 128 at 80, 64 at 8-32 and 160, 32 at
# 512) or key tile (128, 64 or 32) of flash_fwd divides, at every padded
# head dim: 48, 80, 512, 16 (d=8 and 16), 32, 160; and at each tile that
# the fp32 forward picks by size, one ragged N: at d = 160 N <= 256 takes
# 32-row q tiles and (1, 257, 2, 160) 64-row ones; at d = 512 fewer than
# 132 64-row tiles in all take 32-row ones, and (3, 2753, 1, 512), 3 x 44
# = 132 tiles with one row in the last, 64-row ones
RAGGED_CHECKS = ((1, 100, 2, 40), (2, 333, 3, 80), (1, 77, 1, 512), (2, 130, 4, 8),
                 (2, 130, 4, 16), (1, 90, 2, 32), (1, 70, 2, 160), (1, 1000, 1, 512),
                 (3, 47, 2, 48), (1, 257, 2, 160), (3, 2753, 1, 512))
# the shapes at which phase 2 also feeds inputs that randn's nearly uniform
# softmax cannot stand in for: the four head dims of the edit's path
STRESS_SHAPES = ((2, 4096, 8, 40), (2, 1024, 8, 80), (2, 256, 8, 160), (1, 4096, 1, 512))

# (name, (B, N, H, D), launches of each backward kernel per v1 training step):
# the UNet self-attention at batch 4. Under remat the forward kernel runs
# twice per step at each (once more in the backward's recompute), and the
# frozen VAE's mid attention (4, 4096, 1, 512) twice (the two encodes).
TRAIN_SHAPES = (
    ("unet_ds1", (4, 4096, 8, 40), 5),
    ("unet_ds2", (4, 1024, 8, 80), 5),
    ("unet_ds4", (4, 256, 8, 160), 5),
    ("unet_ds8", (4, 64, 8, 160), 1),
)
BWD_PER_STEP = sum(s[2] for s in TRAIN_SHAPES)  # 16 each of dQ and dK/dV
FWD_PER_STEP = 2 * BWD_PER_STEP + 2             # 34
VAE_TRAIN_SHAPE = (4, 4096, 1, 512)  # the frozen VAE's mid attention, 2 a step
# bf16 tolerance of the backward kernels vs their plain versions, relative
# to the gradient's scale: both round P and dS to bf16 at the same points
# and differ only in the order of the fp32 sums (and in the ulp of S that
# order moves), so an element may land a few bf16 ulps away, never more.
GRAD_MAX_REL = 2.0 ** -5
GRAD_L2_REL = 1e-2
# flash_attention's backward from cotangents the kernels cannot read in
# place: the UNet's ds1 training shape and first-stage training's d = 512
COTANGENT_CHECKS = ((4, 4096, 8, 40), (4, 1024, 1, 512))
# the backward kernels beyond the training shapes: N that no q or key tile
# divides at every padded head dim (48, 80, 16, 32, 160), and N below one
# tile
BWD_CHECKS = ((1, 100, 2, 40), (2, 333, 3, 80), (2, 130, 4, 16), (1, 90, 2, 32),
              (1, 70, 2, 160), (3, 47, 2, 48))

# phases 17-18, first-stage (VAE) training: the v1 VAE's single-head mid
# attention at d = 512. Phase 18 trains at 256^2 (configs/v1.yaml
# ddconfig.resolution) and batch 4: a 32^2 latent, N = 1024. A step runs the
# forward kernel 6 times there, 2 of them with the LSE (the adaptive
# weight's encode and decode and the D step's without it, the G step's with
# it), and each backward kernel twice (the G step's encode and decode);
# (2, 4096, 1, 512), a 512^2 pair, is held and timed but is not on phase
# 18's path. (name, (B, N, H, D), backward launches a step)
VAE_BWD_SHAPES = (("vae_256_b4", (4, 1024, 1, 512), 2), ("vae_512_b2", (2, 4096, 1, 512), 0))
VAE_STEP_FWD, VAE_STEP_FWD_LSE, VAE_STEP_BWD = 6, 2, 2
# N below one tile (32 rows) of the d = 512 kernels and one that no tile divides
VAE_BWD_CHECKS = ((1, 77, 1, 512), (1, 1000, 1, 512), (1, 20, 1, 512))
# ... and N one row past a 32-row tile, one short of and one past a 64-row
# block (the wgmma pair's cluster of 2 blocks a 64 rows), past two blocks
VAE_BWD_EDGES = ((1, 33, 1, 512), (1, 63, 1, 512), (1, 65, 1, 512), (2, 129, 1, 512))

# K3 and K4 beyond the benchmark's shapes: ds8, N that no tile divides, head
# dims 16 and 512; K3 runs each at clusters of 1, 2 and 4, so a cluster's
# last q tiles lie wholly past N ((1,100,2,40): 2 q tiles of 64, (1,77,1,512):
# 3 of 32, (2,333,3,80): 6 of 64); then N one row past a q tile of the fp32
# kernels (128 rows at d <= 80, 64 at block_k 128 and at 512, 32 at 160) at
# the head dims DP - 8 of 48, 160 and 512
VARIANT_CHECKS = ((2, 64, 8, 160), (1, 100, 2, 40), (2, 333, 3, 80), (1, 70, 2, 160),
                  (2, 130, 4, 16), (1, 1000, 2, 80), (1, 4000, 2, 40), (1, 77, 1, 512),
                  (1, 129, 2, 48), (2, 33, 2, 152), (1, 65, 1, 504))


# phase 20, the fp32 kernels (csrc/flash_fp32.cu) against their plain
# versions: both keep every value in fp32 and differ in the order of the
# sums and in the exp2 (exp2f against torch.exp2), so an element lands a few
# fp32 ulps of the largest partial sum away: max|err| <= 2^-14 max|ref| (the
# LSE's too) and rel L2 <= 1e-5
F32_MAX_REL = 2.0 ** -14
F32_L2_REL = 1e-5
# first-stage training's single-head attention (phase 21's fp32 step, as
# phase 18's): backward launches a step
F32_VAE_STAGE1 = ("vae_256_b4", (4, 1024, 1, 512), 2)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, stream=None) -> float:
    """Device time of one fn() call: `iters` calls captured into one CUDA
    graph, replayed between two CUDA events. Back-to-back eager launches
    of the small shapes (ds4, ds8) run at the host's launch rate, which
    this takes out for the kernel, its plain version and SDPA alike.
    `stream` (default: a new one) is where fn is warmed up and captured:
    an autograd backward runs on its forward's stream, so a backward is
    captured on the stream its forward ran on."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


# csrc/flash_fp32.cu takes minutes to build on one host core: it starts
# after phase 13, so that the edit and serving timings (phases 4, 12 and
# 13) run with no nvcc beside them, and phase 20 waits for it; so do
# csrc/flash_anyd.cu, which only phases 28-30 run, and
# csrc/flash_variants_anyd.cu, which only phase 30 runs
LATE_BUILDS = ("flash_fp32", "flash_anyd", "flash_variants_anyd")
_START = time.perf_counter()
BUILD_SECONDS: dict = {}  # each source's nvcc seconds, as start_builds timed it


def clocked(phase):
    """A phase that logs its seconds and the run's clock as it returns (or
    fails)."""
    @functools.wraps(phase)
    def run(*args, **kw):
        t0 = time.perf_counter()
        try:
            return phase(*args, **kw)
        finally:
            now = time.perf_counter()
            log(f"[clock] {phase.__name__} {now - t0:.1f} s (the run at {now - _START:.1f} s)")
    return run


def start_builds(names: tuple):
    """One nvcc per source in ``names``, all started together -> a function
    that waits for them and logs their times and ptxas reports."""
    from concurrent.futures import ThreadPoolExecutor

    from pbe_tpu_torch.ops import cuda_build
    from pbe_tpu_torch.scripts.sweep_flash_tiles import ptxas_report

    def timed_build(name):
        t = time.perf_counter()
        cuda_build.build(name)
        BUILD_SECONDS[name] = time.perf_counter() - t
        return f"{name}.cu {BUILD_SECONDS[name]:.1f} s"

    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(len(names))
    futures = [pool.submit(timed_build, n) for n in names]
    pool.shutdown(wait=False)

    def wait():
        each = [f.result() for f in futures]
        log(f"[build] {', '.join(n + '.cu' for n in names)} built side by side in "
            f"{time.perf_counter() - t0:.1f} s ({', '.join(each)})")
        for n in names:
            log(f"[build] {n}.cu registers and spills (ptxas):\n"
                f"{ptxas_report(cuda_build.build_log(n))}")
    return wait


@clocked
def phase_build():
    """Every kernel source but LATE_BUILDS, one nvcc each, started together."""
    start_builds(("flash_fwd", "flash_variants", "flash_bwd"))()


def check_flash(fa, q, k, v, label: str) -> tuple[float, float]:
    """flash_fwd against its plain version on the same inputs -> (max abs
    err of O, max abs err of the LSE); raises past the tolerances above."""
    return compare_flash(fa.flash_fwd(q, k, v, return_lse=True),
                         fa.flash_attention_plain(q, k, v, return_lse=True), label)


def compare_flash(got, want, label: str) -> tuple[float, float]:
    """(O, LSE) of a kernel against (O, LSE) of the plain version; raises
    past the tolerances above (bf16) or F32_MAX_REL / F32_L2_REL (fp32)."""
    import torch

    (out, lse), (want, want_lse) = got, want
    diff = out.float() - want.float()
    err = diff.abs().max().item()
    scale = want.float().abs().max().item()
    rel_l2 = (diff.norm() / want.float().norm()).item()
    lerr = (lse - want_lse).abs().max().item()
    if want.dtype == torch.float32:
        max_rel, l2_rel = F32_MAX_REL, F32_L2_REL
        lse_tol = F32_MAX_REL * want_lse.abs().max().item()
    else:
        max_rel, l2_rel, lse_tol = OUT_MAX_REL, OUT_L2_REL, LSE_ATOL
    ok = err <= max_rel * scale and rel_l2 <= l2_rel and lerr <= lse_tol
    log(f"[kernel] {label}: out max|err| {err:.3e} (max|O| {scale:.3e}, tol "
        f"{max_rel * scale:.3e}), rel L2 {rel_l2:.3e} (tol {l2_rel}), "
        f"rms O {want.float().square().mean().sqrt().item():.3e}; lse max|err| "
        f"{lerr:.3e} (tol {lse_tol:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash kernel disagrees with its plain version at {label}")
    del out, lse, diff
    torch.cuda.synchronize()
    return err, lerr


def check_flash_f32(fa, q, k, v, label: str) -> tuple[float, float]:
    """check_flash (on fp32 operands, or any of csrc/flash_anyd.cu's), then
    a second launch on the same inputs that must give the same bits of O
    and of the LSE (every output tile has one owner and no atomics)."""
    import torch

    res = check_flash(fa, q, k, v, label)
    (o1, l1), (o2, l2) = (fa.flash_fwd(q, k, v, return_lse=True) for _ in range(2))
    if not (torch.equal(o1, o2) and torch.equal(l1, l2)):
        raise AssertionError(f"{q.dtype} forward is not bitwise repeatable at {label}")
    return res


def rising_scores(shape, gen, dtype=None):
    """q and k (bf16 or ``dtype``, on the card) whose scores grow with the key's position:
    q[..., 0] = 1 and k[:, j, :, 0] = j * 0.02 / (d^-1/2 log2 e), so a score
    rises by 0.02 a key in the exp2 domain (1.28 a 64-key tile), far above
    the other columns' noise (0.1 randn each): every key tile raises the row
    max, and O is rescaled at every tile."""
    import torch

    from pbe_tpu_torch.ops.flash_attention import LOG2E

    n, d = shape[1], shape[3]
    q = 0.1 * torch.randn(shape, generator=gen, device="cuda")
    k = 0.1 * torch.randn(shape, generator=gen, device="cuda")
    q[..., 0] = 1.0
    step = 0.02 / (d ** -0.5 * LOG2E)
    k[..., 0] = (torch.arange(n, device="cuda", dtype=torch.float32) * step)[None, :, None]
    return q.to(dtype or torch.bfloat16), k.to(dtype or torch.bfloat16)


def check_stress(fa, rand, gen) -> None:
    """flash_fwd where a wrong rescale cannot hide (with randn inputs at
    N=4096 the softmax is nearly uniform, |O| ~ 0.02): peaked scores (q and
    k x8), a row max that rises at every key tile, and q, k, v as the three
    strided views of one packed (B, N, 3, H, D) tensor, as the UNet hands
    them over; the same tolerances as every other check."""
    import torch

    for shape in STRESS_SHAPES:
        b, n, h, d = shape
        q, k, v = rand(shape), rand(shape), rand(shape)
        check_flash(fa, q * 8, k * 8, v, f"peaked (q, k x8) {shape}")
        qr, kr = rising_scores(shape, gen)
        check_flash(fa, qr, kr, v, f"rising max {shape}")
        q, k, v = rand((b, n, 3, h, d)).unbind(2)
        check_flash(fa, q, k, v, f"packed qkv views {shape} strides {q.stride()}")
        del q, k, v, qr, kr
        torch.cuda.empty_cache()


@clocked
def phase_kernels() -> list[dict]:
    import torch

    from pbe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    # masking and padding beyond the main-path shapes: ragged N, every
    # padded head dim
    for shape in RAGGED_CHECKS:
        check_flash(fa, rand(shape), rand(shape), rand(shape), f"check {shape}")
    check_stress(fa, rand, gen)

    return [kernel_row(fa, name, shape, replaces, rand)
            for name, shape, replaces, _ in FLASH_SHAPES]


def kernel_row(fa, name: str, shape, replaces: str, rand, source: str | None = None) -> dict:
    """flash_fwd against its plain version on randn inputs at one shape,
    then timed beside the plain version and SDPA: one row of the kernels
    line (launches filled in by the main path's run). ``rand`` gives bf16
    or fp32 inputs; an fp32 row is the fp32 kernel's (csrc/flash_fp32.cu),
    launched twice and compared bitwise, its bound at fp32 accuracy's rates
    (bound_3xtf32: S on FMA, P V as 3xTF32; the all-FMA bound is logged)."""
    import torch
    import torch.nn.functional as F

    b, n, h, d = shape
    q, k, v = rand(shape), rand(shape), rand(shape)
    f32 = q.dtype == torch.float32
    err, lerr = (check_flash_f32 if f32 else check_flash)(fa, q, k, v, f"{name} {shape}")
    # the least time for this work: products at the bf16 tensor-core rate
    # (fp32: the FMA rate), exponentials at the special-function rate (both
    # operations), or q, k, v read once and o written once at the HBM rate;
    # at fp32 the row's bound is fp32 accuracy's (bound_3xtf32), these the log's
    t_mma = 4.0 * b * h * n * n * d / (FP32_FLOP_PER_S if f32 else BF16_FLOP_PER_S) * 1e3
    t_exp2 = 1.0 * b * h * n * n / EXP2_PER_S * 1e3
    t_bytes = 4.0 * b * n * h * d * q.element_size() / HBM_BYTES_PER_S * 1e3
    binding = max(("fma" if f32 else "mma", t_mma), ("exp2", t_exp2), ("bytes", t_bytes),
                  key=lambda x: x[1])
    if f32:
        t_fma, binding = t_mma, bound_3xtf32(4.0, b, n, h, d, 4.0 * b * n * h * d * 4)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    row = {"name": f"flash_fwd/{name}", "route": "cuda",
           "source": source or f"pbe_tpu_torch/csrc/{'flash_fp32' if f32 else 'flash_fwd'}.cu",
           "replaces": replaces, "dtype": str(q.dtype).removeprefix("torch."),
           "launches": None, "max_abs_err": err, "lse_max_abs_err": lerr,
           "ms": graph_ms(lambda: fa.flash_fwd(q, k, v), 20),
           "plain_ms": graph_ms(lambda: fa.flash_attention_plain(q, k, v), 5),
           "bound_ms": binding[1],
           "bound_by": "bytes" if binding[0] == "bytes" else "operations",
           "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20),
           "eager_ms": cuda_ms(lambda: fa.flash_fwd(q, k, v), 20)}
    if f32:  # at fp32 SDPA's flash backend does not run: name the one that does
        row["library"] = f"sdpa ({sdpa_backend(qt, kt, vt)})"
    log(f"[kernel] {name}: kernel {row['ms']:.4f} ms ({row['eager_ms']:.4f} launched "
        f"eagerly), plain {row['plain_ms']:.4f} ms, {row.get('library', 'sdpa')} "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by {binding[0]} "
        + (f"(all-FMA bound {t_fma:.4f}, exp2 {t_exp2:.4f}, bytes {t_bytes:.4f})" if f32 else
           f"(mma {t_mma:.4f}, exp2 {t_exp2:.4f}, bytes {t_bytes:.4f})"))
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def check_bwd(fa, q, k, v, do, label: str) -> dict:
    """The dQ and dK/dV kernels against their plain versions on the same
    inputs (O and the LSE from the forward kernel) -> {output: (max abs
    err, max|g|, rel L2)}; raises past the tolerances above."""
    import torch

    out, lse = fa.flash_fwd(q, k, v, return_lse=True)
    dd = fa.rowsum_do_o(do, out)
    launch = lambda: (fa.flash_bwd_dq(q, k, v, do, lse, dd),
                      *fa.flash_bwd_dkv(q, k, v, do, lse, dd))
    got = launch()
    want = (fa.flash_bwd_dq_plain(q, k, v, do, lse, dd),
            *fa.flash_bwd_dkv_plain(q, k, v, do, lse, dd))
    # every output tile has one owner and no atomics: a second launch on
    # the same inputs gives the same bits
    if not all(torch.equal(a, b) for a, b in zip(got, launch())):
        raise AssertionError(f"flash backward kernels are not bitwise repeatable at {label}")
    torch.cuda.synchronize()
    res, ok = {}, True
    max_rel, l2_rel = ((F32_MAX_REL, F32_L2_REL) if q.dtype == torch.float32
                       else (GRAD_MAX_REL, GRAD_L2_REL))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        diff = g.float() - w.float()
        err, scale = diff.abs().max().item(), w.float().abs().max().item()
        rel_l2 = (diff.norm() / w.float().norm()).item()
        res[name] = (err, scale, rel_l2)
        ok = ok and err <= max_rel * scale and rel_l2 <= l2_rel
    log(f"[bwd] {label} (repeat bitwise equal): " + "; ".join(
        f"{n} max|err| {e:.3e} (max|g| {m:.3e}, tol {max_rel * m:.3e}) rel L2 {r:.3e}"
        for n, (e, m, r) in res.items()) + f" (tol {l2_rel}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash backward kernels disagree with their plain versions "
                             f"at {label}")
    return res


def check_cotangents(fa, rand, shape) -> None:
    """flash_attention's backward on the card from cotangents the kernels
    cannot read in place: out.sum()'s (expanded, every stride 0), a
    permuted one (head-dim stride H) and one at a 2-element offset; each
    gradient against the plain backward on the same cotangent, at phase 7's
    tolerances."""
    import torch

    b, n, h, d = shape
    q, k, v = (rand(shape).requires_grad_() for _ in range(3))
    out = fa.flash_attention(q, k, v)
    o, lse = fa.flash_fwd(q.detach(), k.detach(), v.detach(), return_lse=True)
    flat = rand((b * n * h * d + 2,))
    cotangents = {"out.sum()": None,
                  "permuted": rand((b, n, d, h)).permute(0, 1, 3, 2),
                  "offset 2": flat[2:].view(shape)}
    for name, do in cotangents.items():
        if do is None:
            got = torch.autograd.grad(out.sum(), (q, k, v), retain_graph=True)
            do = torch.ones((), dtype=out.dtype, device=out.device).expand(shape)
        else:
            got = torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
        if fa.layout_error(do) is None:
            raise AssertionError(f"cotangent {name} at {shape} is one the kernels read in "
                                 f"place; the check needs one they cannot")
        want = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o, lse, do)
        res = []
        for gname, g, w in zip(("dq", "dk", "dv"), got, want):
            diff = g.float() - w.float()
            err, scale = diff.abs().max().item(), w.float().abs().max().item()
            rel_l2 = (diff.norm() / w.float().norm()).item()
            res.append(f"{gname} max|err| {err:.3e} (tol {GRAD_MAX_REL * scale:.3e}) "
                       f"rel L2 {rel_l2:.3e}")
            if not (err <= GRAD_MAX_REL * scale and rel_l2 <= GRAD_L2_REL):
                raise AssertionError(f"flash_attention's {gname} from the {name} cotangent "
                                     f"at {shape} disagrees with the plain backward")
        log(f"[bwd] cotangent {name} {shape} strides {tuple(do.stride())}: "
            + "; ".join(res) + f" (tol {GRAD_L2_REL}) ok")
    del q, k, v, out, o, lse, flat
    torch.cuda.empty_cache()


def dq_order_controls(fa, q, k, v, do, label: str) -> None:
    """Controls for phase 20's dQ check (fp32 inputs): the rel L2 distance
    of dQ from flash_bwd_dq_plain's and from the exact dQ given the plain
    version's fp32 P (dP, dS and dS K in float64) when it is computed (a)
    by the kernel, (b) in the plain version's order again (this harness,
    expected 0), (c) with the keys summed in 64-key fp32 partials, (d) with
    dP rounded once from float64, (e) with dP and (f) with dS K as 3xTF32
    splits (hi = tf32(x) rounded to nearest, lo = x - hi; lo hi + hi lo +
    hi hi, each product by cuBLAS at fp32 with TF32 off), (g) exactly after
    the fp32 P and (h) all in float64, S too. Logged; none is a check."""
    import torch

    b, n, h, d = q.shape
    out, lse = fa.flash_fwd(q, k, v, return_lse=True)
    dd = fa.rowsum_do_o(do, out)
    got = fa.flash_bwd_dq(q, k, v, do, lse, dd)
    want = fa.flash_bwd_dq_plain(q, k, v, do, lse, dd)
    hd = lambda x: x.permute(0, 2, 1, 3).float()  # (B,N,H,D) -> (B,H,N,D)
    got, want = hd(got), hd(want)
    lse, dd = lse.reshape(b, h, n, 1), dd.reshape(b, h, n, 1)
    q2, kh, vh, doh = hd(fa.prescale(q)), hd(k), hd(v), hd(do)
    vt, c = vh.transpose(-1, -2), d ** -0.5

    def tf32(x):
        return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    def mm3(x, y):
        xh, yh = tf32(x), tf32(y)
        return (x - xh) @ yh + xh @ (y - yh) + xh @ yh

    p = torch.exp2(q2 @ kh.transpose(-1, -2) - lse)
    dp64 = doh.double() @ vt.double()
    ds = p * (doh @ vt - dd) * c
    ways = {"kernel": got, "plain order (harness)": ds @ kh,
            "64-key fp32 partials": sum(ds[..., i:i + 64] @ kh[:, :, i:i + 64]
                                        for i in range(0, n, 64)),
            "dS K as 3xTF32": mm3(ds, kh)}
    del ds
    ways["dP as 3xTF32"] = p * (mm3(doh, vt) - dd) * c @ kh
    ways["dP rounded once from float64"] = p * (dp64.float() - dd) * c @ kh
    exact = p.double() * (dp64 - dd.double()) * c @ kh.double()
    ways["exact after the fp32 P"] = exact
    del p
    pd = torch.exp2(q2.double() @ kh.double().transpose(-1, -2) - lse.double())
    ways["all float64 (S too)"] = pd * (dp64 - dd.double()) * c @ kh.double()
    del pd, dp64
    rel = lambda x, ref: ((x.double() - ref.double()).norm() / ref.double().norm()).item()
    log(f"[fp32] dQ controls, {label}: rel L2 from the plain version / from the exact dQ "
        f"after the fp32 P: " + "; ".join(f"{w} {rel(x, want):.3e} / {rel(x, exact):.3e}"
                                         for w, x in ways.items())
        + f" (the check allows {F32_L2_REL} from the plain version)")
    del got, want, ways, exact
    torch.cuda.empty_cache()


def bound(flop_per_n2d: float, b: int, n: int, h: int, d: int, nbytes: float,
          f32: bool = False):
    """(binding term, least ms) for B*H*N^2*D*flop_per_n2d tensor-core FLOP
    (fp32 FMA with ``f32``), B*H*N^2 exponentials and nbytes of device
    memory traffic."""
    terms = (("fma" if f32 else "mma",
              flop_per_n2d * b * h * n * n * d / (FP32_FLOP_PER_S if f32 else BF16_FLOP_PER_S)
              * 1e3),
             ("exp2", 1.0 * b * h * n * n / EXP2_PER_S * 1e3),
             ("bytes", nbytes / HBM_BYTES_PER_S * 1e3))
    return max(terms, key=lambda x: x[1])


def bound_3xtf32(flop_per_n2d: float, b: int, n: int, h: int, d: int, nbytes: float):
    """(binding term, least ms) of an fp32 flash kernel at fp32 accuracy on
    this card: S (2 FLOP a B*H*N^2*D) on fp32 FMA, as the forward's and the
    backward's must be equal, the other products (flop_per_n2d - 2: P V in
    the forward) as 3xTF32 on the tensor cores (three TF32 products each),
    B*H*N^2 exponentials and nbytes of device memory traffic, each unit at
    its peak beside the others."""
    bhn2d = b * h * n * n * d
    terms = (("fma", 2.0 * bhn2d / FP32_FLOP_PER_S * 1e3),
             ("tf32", 3.0 * (flop_per_n2d - 2.0) * bhn2d / TF32_FLOP_PER_S * 1e3),
             ("exp2", 1.0 * b * h * n * n / EXP2_PER_S * 1e3),
             ("bytes", nbytes / HBM_BYTES_PER_S * 1e3))
    return max(terms, key=lambda x: x[1])


def sdpa_backend(q, k, v) -> str:
    """The backend torch's scaled_dot_product_attention picks for these
    (B, H, N, D) inputs, as its dispatcher decides it."""
    import torch
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v)).name
    except (AttributeError, RuntimeError, ValueError) as e:  # a private entry
        return f"not determined ({type(e).__name__})"


def bwd_rows(fa, name: str, shape, per_step: int, fwd_per_step: int, fwd_replaces: str,
             rand, source: str | None = None) -> list[dict]:
    """At one training shape: the dQ and dK/dV kernels and the forward
    kernel with the LSE against their plain versions on randn inputs, then
    each timed (CUDA graphs) beside its plain version and SDPA (its
    backward alone for the pair, its forward for the forward): the dq, dkv
    and fwd+lse rows of the kernels line, each expecting per_step (the
    forward fwd_per_step) launches a training step."""
    import torch
    import torch.nn.functional as F

    b, n, h, d = shape
    q, k, v, do = (rand(shape) for _ in range(4))
    f32 = q.dtype == torch.float32
    errs = check_bwd(fa, q, k, v, do, f"{name} {shape}")
    ferr, flerr = (check_flash_f32 if f32 else check_flash)(fa, q, k, v,
                                                           f"{name} fwd+lse {shape}")
    out, lse = fa.flash_fwd(q, k, v, return_lse=True)
    dd = fa.rowsum_do_o(do, out)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    backend = sdpa_backend(qt, kt, vt)
    # SDPA's backward alone: the gradient of one saved output, taken on
    # the stream its forward ran on and captured there
    sdpa_stream = torch.cuda.Stream()
    sdpa_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(sdpa_stream):
        o_sdpa = F.scaled_dot_product_attention(qt, kt, vt)
    sdpa_bwd_ms = graph_ms(lambda: torch.autograd.grad(o_sdpa, (qt, kt, vt), dot,
                                                       retain_graph=True),
                           20, stream=sdpa_stream)
    bnhd, bhn = b * n * h * d * q.element_size(), b * h * n * 4
    dtype = {"dtype": str(q.dtype).removeprefix("torch.")}
    common = {"route": "cuda",
              "source": source or f"pbe_tpu_torch/csrc/{'flash_fp32' if f32 else 'flash_bwd'}.cu",
              "library": f"sdpa backward ({backend})", **dtype}
    rows, fma_bound = [], {}
    for kname, replaces, flop, nbytes, launch, plain in (
            ("flash_bwd_dq", K5, 6.0, 5 * bnhd + 2 * bhn,
             lambda: fa.flash_bwd_dq(q, k, v, do, lse, dd),
             lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, dd)),
            ("flash_bwd_dkv", K6, 8.0, 6 * bnhd + 2 * bhn,
             lambda: fa.flash_bwd_dkv(q, k, v, do, lse, dd),
             lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, dd))):
        by, ms_bound = bound(flop, b, n, h, d, nbytes, f32)
        fma_bound[kname] = ms_bound
        if f32:
            # the least time at fp32 accuracy: S on FMA, the other products
            # as 3xTF32 (the dK/dV kernel's design; the dQ kernel runs all
            # on FMA); the all-FMA bound goes to the log
            by, ms_bound = bound_3xtf32(flop, b, n, h, d, nbytes)
        outs = ("dq",) if kname == "flash_bwd_dq" else ("dk", "dv")
        rows.append({"name": f"{kname}/{name}", **common, "replaces": replaces,
                     "launches": None, "expected_launches_per_step": per_step,
                     "max_abs_err": max(errs[o][0] for o in outs),
                     "max_abs_g": max(errs[o][1] for o in outs),
                     "rel_l2": max(errs[o][2] for o in outs),
                     "ms": graph_ms(launch, 20), "plain_ms": graph_ms(plain, 3),
                     "bound_ms": ms_bound,
                     "bound_by": "bytes" if by == "bytes" else "operations",
                     # SDPA's whole backward (dQ, dK and dV), the yardstick
                     # of the two kernels' sum
                     "library_ms": sdpa_bwd_ms, "eager_ms": cuda_ms(launch, 20)})
    by, ms_bound = bound(4.0, b, n, h, d, 4 * bnhd + bhn, f32)
    fma_bound["flash_fwd_lse"] = ms_bound
    if f32:  # as the backward's: S on FMA, P V as 3xTF32
        by, ms_bound = bound_3xtf32(4.0, b, n, h, d, 4 * bnhd + bhn)
    fwd_source = f"pbe_tpu_torch/csrc/{'flash_fp32' if f32 else 'flash_fwd'}.cu"
    rows.append({"name": f"flash_fwd_lse/{name}_train", "route": "cuda",
                 "source": source or fwd_source,
                 "replaces": fwd_replaces, **dtype,
                 "launches": None, "expected_launches_per_step": fwd_per_step,
                 "max_abs_err": ferr, "lse_max_abs_err": flerr,
                 "ms": graph_ms(lambda: fa.flash_fwd(q, k, v, return_lse=True), 20),
                 "plain_ms": graph_ms(lambda: fa.flash_attention_plain(
                     q, k, v, return_lse=True), 3),
                 "bound_ms": ms_bound,
                 "bound_by": "bytes" if by == "bytes" else "operations",
                 "library": f"sdpa ({sdpa_backend(*(x.detach() for x in (qt, kt, vt)))})",
                 "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                        20)})
    dq_row, dkv_row, f_row = rows
    fma = lambda r: (f", all-FMA bound {fma_bound[r['name'].split('/')[0]]:.4f}" if f32
                     else "")
    log(f"[bwd] {name} {shape} (graph-timed): dq {dq_row['ms']:.4f} ms (eager "
        f"{dq_row['eager_ms']:.4f}, plain {dq_row['plain_ms']:.4f}, bound "
        f"{dq_row['bound_ms']:.4f}{fma(dq_row)}); dkv {dkv_row['ms']:.4f} ms (eager "
        f"{dkv_row['eager_ms']:.4f}, plain {dkv_row['plain_ms']:.4f}, bound "
        f"{dkv_row['bound_ms']:.4f}{fma(dkv_row)}); pair {dq_row['ms'] + dkv_row['ms']:.4f} ms vs SDPA "
        f"backward {sdpa_bwd_ms:.4f} ms ({backend}); fwd+lse {f_row['ms']:.4f} ms (plain "
        f"{f_row['plain_ms']:.4f}, SDPA {f_row['library_ms']:.4f} {f_row['library']}, bound "
        f"{f_row['bound_ms']:.4f}{fma(f_row)})")
    del q, k, v, do, out, lse, dd, qt, kt, vt, dot, o_sdpa
    torch.cuda.empty_cache()
    return rows


@clocked
def phase_train_kernels() -> list[dict]:
    """The backward kernels, and the forward kernel with the LSE, at the
    v1 training shapes (plus ragged and odd ones for the backward): each
    against its plain version, then timed beside it and beside SDPA."""
    import torch
    import torch.nn.functional as F

    from pbe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(10)
    rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    for shape in BWD_CHECKS:
        check_bwd(fa, rand(shape), rand(shape), rand(shape), rand(shape), f"check {shape}")
    # where a wrong register layout or prescale cannot hide behind randn's
    # nearly uniform P: peaked scores (q and k x8, P nearly one-hot) and q,
    # k, v as the strided views of one packed (B, N, 3, H, D) tensor
    for _, shape, _ in TRAIN_SHAPES:
        b, n, h, d = shape
        q, k, v, do = (rand(shape) for _ in range(4))
        check_bwd(fa, q * 8, k * 8, v, do, f"peaked (q, k x8) {shape}")
        q, k, v = rand((b, n, 3, h, d)).unbind(2)
        check_bwd(fa, q, k, v, do, f"packed qkv views {shape} strides {q.stride()}")
        del q, k, v, do
        torch.cuda.empty_cache()

    for shape in COTANGENT_CHECKS:
        check_cotangents(fa, rand, shape)

    rows = []
    for name, shape, per_step in TRAIN_SHAPES:
        # under remat the forward runs twice a step at each shape
        rows += bwd_rows(fa, name, shape, per_step, 2 * per_step, K1, rand)

    # K2 at the frozen VAE's mid attention in the training step (no LSE)
    b, n, h, d = VAE_TRAIN_SHAPE
    q, k, v = (rand(VAE_TRAIN_SHAPE) for _ in range(3))
    err, lerr = check_flash(fa, q, k, v, f"vae_mid_train {VAE_TRAIN_SHAPE}")
    by, ms_bound = bound(4.0, b, n, h, d, 4 * b * n * h * d * 2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rows.append({"name": "flash_fwd/vae_mid_train", "route": "cuda",
                 "source": "pbe_tpu_torch/csrc/flash_fwd.cu", "replaces": K2,
                 "launches": None, "expected_launches_per_step": 2,
                 "max_abs_err": err, "lse_max_abs_err": lerr,
                 "ms": graph_ms(lambda: fa.flash_fwd(q, k, v), 20),
                 "plain_ms": graph_ms(lambda: fa.flash_attention_plain(q, k, v), 3),
                 "bound_ms": ms_bound, "bound_by": "bytes" if by == "bytes" else "operations",
                 "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                        20)})
    r = rows[-1]
    log(f"[bwd] vae_mid_train {VAE_TRAIN_SHAPE}: fwd {r['ms']:.4f} ms (plain "
        f"{r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by {by})")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


@clocked
def phase_vae_kernels() -> list[dict]:
    """Phase 17: the backward kernels at the VAE's head dim 512 and the
    forward kernel with the LSE there (the G step of first-stage training):
    each against its plain version at VAE_BWD_SHAPES, at ragged N below and
    above a tile and on peaked scores, each backward launched twice and
    compared bitwise; then timed beside the plain versions and SDPA."""
    import torch
    import torch.nn.functional as F

    from pbe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(17)
    rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    for shape in VAE_BWD_CHECKS:
        q, k, v, do = (rand(shape) for _ in range(4))
        check_bwd(fa, q, k, v, do, f"check {shape}")
        check_flash(fa, q, k, v, f"fwd+lse check {shape}")
    for shape in VAE_BWD_EDGES:
        check_bwd(fa, *(rand(shape) for _ in range(4)), f"block and tile edge {shape}")
    for _, shape, _ in VAE_BWD_SHAPES:
        q, k, v, do = (rand(shape) for _ in range(4))
        check_bwd(fa, q * 8, k * 8, v, do, f"peaked (q, k x8) {shape}")
        check_flash(fa, q * 8, k * 8, v, f"fwd+lse peaked (q, k x8) {shape}")
        del q, k, v, do
        torch.cuda.empty_cache()
        plan = fa.wide_bwd_launch(shape)
        log(f"[bwd] d = 512 pair at {shape}: grid {plan['grid']} blocks in clusters of "
            f"{plan['cluster']} ({plan['rows']} rows and a head-dim half a block, "
            f"{plan['tile']}-row tiles), {plan['threads']} threads, {plan['smem']} B of shared "
            f"memory a block")
    # q, k and v as the strided views of one packed (B, N, 3, 1, 512) tensor
    b, n, h, d = VAE_BWD_SHAPES[0][1]
    q, k, v = rand((b, n, 3, h, d)).unbind(2)
    check_bwd(fa, q, k, v, rand((b, n, h, d)), f"packed qkv views {(b, n, h, d)} strides "
              f"{q.stride()}")
    del q, k, v
    torch.cuda.empty_cache()
    rows = []
    for name, shape, per_step in VAE_BWD_SHAPES:
        rows += bwd_rows(fa, name, shape, per_step, VAE_STEP_FWD_LSE if per_step else 0, K2,
                         rand)
    # K2 without the LSE at phase 18's shape: the passes without a gradient
    name, shape, _ = VAE_BWD_SHAPES[0]
    b, n, h, d = shape
    q, k, v = (rand(shape) for _ in range(3))
    err, lerr = check_flash(fa, q, k, v, f"{name} fwd {shape}")
    by, ms_bound = bound(4.0, b, n, h, d, 4 * b * n * h * d * 2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rows.append({"name": f"flash_fwd/{name}_train", "route": "cuda",
                 "source": "pbe_tpu_torch/csrc/flash_fwd.cu", "replaces": K2,
                 "launches": None,
                 "expected_launches_per_step": VAE_STEP_FWD - VAE_STEP_FWD_LSE,
                 "max_abs_err": err, "lse_max_abs_err": lerr,
                 "ms": graph_ms(lambda: fa.flash_fwd(q, k, v), 20),
                 "plain_ms": graph_ms(lambda: fa.flash_attention_plain(q, k, v), 3),
                 "bound_ms": ms_bound, "bound_by": "bytes" if by == "bytes" else "operations",
                 "library": f"sdpa ({sdpa_backend(qt, kt, vt)})",
                 "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                        20)})
    r = rows[-1]
    log(f"[bwd] {name} fwd {shape}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, SDPA "
        f"{r['library_ms']:.4f} {r['library']}, bound {r['bound_ms']:.4f} by {by})")
    return rows


@clocked
def phase_fp32_kernels() -> list[dict]:
    """Phase 20: the fp32 kernels (csrc/flash_fp32.cu) against their plain
    versions at fp32: the forward at every edit shape and the VAE's, with
    the LSE and without it (the same bits of O), at ragged N for every
    padded head dim and every tile it picks by size, on peaked scores, on a
    row max rising at every key tile and on packed q/k/v views; the
    backward at the training shapes and first-stage training's (4, 1024, 1,
    512), at ragged N and on the same stress inputs; every kernel launched
    twice and compared bitwise; then each timed (CUDA graphs) beside its
    plain version and SDPA at fp32 with its bound at fp32 accuracy's rates
    (bound_3xtf32; the all-FMA bound in the log). Returns the rows of the
    kernels line (dtype "float32"), their launches filled in by phase 21."""
    import torch

    from pbe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(20)
    rand = lambda shape: torch.randn(shape, generator=gen, device="cuda")
    t0 = time.perf_counter()
    for shape in RAGGED_CHECKS + tuple(s for _, s, _, _ in FLASH_SHAPES):
        q, k, v = rand(shape), rand(shape), rand(shape)
        check_flash_f32(fa, q, k, v, f"fp32 check {shape}")
        if not torch.equal(fa.flash_fwd(q, k, v), fa.flash_fwd(q, k, v, return_lse=True)[0]):
            raise AssertionError(f"fp32 forward: O without the LSE differs from O with it "
                                 f"at {shape}")
    for shape in STRESS_SHAPES:
        b, n, h, d = shape
        q, k, v = rand(shape), rand(shape), rand(shape)
        check_flash_f32(fa, q * 8, k * 8, v, f"fp32 peaked (q, k x8) {shape}")
        qr, kr = rising_scores(shape, gen, torch.float32)
        check_flash_f32(fa, qr, kr, v, f"fp32 rising max {shape}")
        q, k, v = rand((b, n, 3, h, d)).unbind(2)
        check_flash_f32(fa, q, k, v, f"fp32 packed qkv views {shape} strides {q.stride()}")
        del q, k, v, qr, kr
        torch.cuda.empty_cache()
    for shape in BWD_CHECKS + VAE_BWD_CHECKS:
        check_bwd(fa, rand(shape), rand(shape), rand(shape), rand(shape), f"fp32 check {shape}")
    for _, shape, _ in TRAIN_SHAPES + (F32_VAE_STAGE1,):
        b, n, h, d = shape
        q, k, v, do = (rand(shape) for _ in range(4))
        check_bwd(fa, q * 8, k * 8, v, do, f"fp32 peaked (q, k x8) {shape}")
        qr, kr = rising_scores(shape, gen, torch.float32)
        check_bwd(fa, qr, kr, v, do, f"fp32 rising max {shape}")
        dq_order_controls(fa, qr, kr, v, do, f"rising max {shape}")
        q, k, v = rand((b, n, 3, h, d)).unbind(2)
        check_bwd(fa, q, k, v, do, f"fp32 packed qkv views {shape} strides {q.stride()}")
        del q, k, v, do, qr, kr
        torch.cuda.empty_cache()
    log(f"[fp32] every check passed in {time.perf_counter() - t0:.1f} s")

    rows = []
    for name, shape, replaces, per_edit in FLASH_SHAPES:
        rows.append({**kernel_row(fa, f"f32_{name}", shape, replaces, rand),
                     "expected_launches": per_edit})
    # the frozen VAE's mid attention in the fp32 training step (no LSE)
    rows.append({**kernel_row(fa, "f32_vae_mid_train", VAE_TRAIN_SHAPE, K2, rand),
                 "expected_launches_per_step": 2})
    for name, shape, per_step in TRAIN_SHAPES:
        rows += bwd_rows(fa, f"f32_{name}", shape, per_step, 2 * per_step, K1, rand)
    name, shape, per_step = F32_VAE_STAGE1
    rows += bwd_rows(fa, f"f32_{name}", shape, per_step, VAE_STEP_FWD_LSE, K2, rand)
    rows.append({**kernel_row(fa, f"f32_{name}_train", shape, K2, rand),
                 "expected_launches_per_step": VAE_STEP_FWD - VAE_STEP_FWD_LSE})
    return rows


@clocked
def phase_variants() -> list[dict]:
    """K3 (resident) and K4 (pipelined) against the plain version at
    VARIANT_CHECKS; at the attention benchmark's shapes, every
    flash_forward(variant=...) call against the plain version with one
    launch of the matching kernel and of no other, K3 and K4 on rising
    scores and at each key block (and K3 at each cluster size); kernel
    (CUDA-graph timed), plain and SDPA times and the function's bound; then
    the bench entry over every shape and impl, with every kernel's count set
    to 0 just before and read just after."""
    import torch
    import torch.nn.functional as F

    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.scripts import bench_attention as bench

    gen = torch.Generator(device="cuda").manual_seed(20)
    rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    kernels = {"resident": fa.flash_fwd_resident, "pipelined": fa.flash_fwd_pipelined}
    blocks = {"resident": fa.RESIDENT_BLOCKS, "pipelined": fa.PIPELINED_BLOCKS}

    def every_launch(variant, dp):
        """(label, kwargs) of every key block, and for K3 every cluster size"""
        clusters = fa.CLUSTER_SIZES if variant == "resident" else (None,)
        return [(f"block {blk}" + (f" cluster {c}" if c else ""), {"block": blk, "cluster": c}
                 if c else {"block": blk}) for blk in blocks[variant][dp] for c in clusters]

    def check_all(q, k, v, label):
        """every launch of K3 and K4 on (q, k, v) -> {variant: (max err, max lse err)}"""
        want = fa.flash_attention_plain(q, k, v, return_lse=True)
        dp = (q.shape[3] + 15) // 16 * 16
        errs = {}
        for variant, kern in kernels.items():
            e = [compare_flash(kern(q, k, v, return_lse=True, **kw), want,
                               f"{variant} {label} {tuple(q.shape)} {what}")
                 for what, kw in every_launch(variant, dp)]
            errs[variant] = (max(x for x, _ in e), max(y for _, y in e))
        return errs

    for shape in VARIANT_CHECKS:
        check_all(rand(shape), rand(shape), rand(shape), "check")

    fwd_kernels = (fa.flash_fwd, fa.flash_fwd_resident, fa.flash_fwd_pipelined)
    kernel_of = {"resident": 1, "pipelined": 2}  # index in fwd_kernels; others 0
    rows = []
    for name, shape in bench.SHAPES.items():
        b, n, h, d = shape
        dp = (d + 15) // 16 * 16
        q, k, v = rand(shape), rand(shape), rand(shape)
        want = fa.flash_attention_plain(q, k, v, return_lse=True)
        # every flash_forward(variant=...) call: the plain version's O and
        # LSE, and one launch of its kernel
        for variant in fa.VARIANTS:
            before = [x.launches for x in fwd_kernels]
            compare_flash(fa.flash_forward(q, k, v, variant=variant, return_lse=True),
                          want, f"flash_forward(variant={variant!r}) {name} {shape}")
            diff = [x.launches - b0 for x, b0 in zip(fwd_kernels, before)]
            if diff != [int(i == kernel_of.get(variant, 0)) for i in range(3)]:
                raise AssertionError(f"flash_forward(variant={variant!r}) at {shape} launched "
                                     f"{diff} of (flash_fwd, resident, pipelined)")
        log(f"[variants] {name}: each flash_forward variant launched its own kernel once")
        # K4's pass-1 max and K3's rescale where every key tile raises the
        # row max; then every key block and cluster size on randn inputs
        qr, kr = rising_scores(shape, gen)
        check_all(qr, kr, v, "rising max")
        del qr, kr
        errs = check_all(q, k, v, name)

        plain_ms = graph_ms(lambda: fa.flash_attention_plain(q, k, v), 3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
        by, ms_bound = bound(4.0, b, n, h, d, 4 * b * n * h * d * 2)
        for variant, kern in kernels.items():
            row = {"name": f"flash_fwd_{variant}/{name}", "route": "cuda",
                   "source": "pbe_tpu_torch/csrc/flash_variants.cu",
                   "replaces": K3 if variant == "resident" else K4, "launches": None,
                   "max_abs_err": errs[variant][0], "lse_max_abs_err": errs[variant][1],
                   "ms": graph_ms(lambda: kern(q, k, v), 20), "plain_ms": plain_ms,
                   "bound_ms": ms_bound, "bound_by": "bytes" if by == "bytes" else "operations",
                   "library_ms": sdpa_ms, "block": fa.key_block(variant, d)}
            extra = ""
            if variant == "resident":
                row["cluster"] = fa.resident_cluster(
                    shape, sms=torch.cuda.get_device_properties(0).multi_processor_count)
                row["cluster_ms"] = {c: graph_ms(lambda: kern(q, k, v, cluster=c), 20)
                                     for c in fa.CLUSTER_SIZES}
                extra = (f", cluster {row['cluster']}; at C = 1/2/4: "
                         + " / ".join(f"{t:.4f}" for t in row["cluster_ms"].values()))
            else:
                # the second QK^T: 6*BH*N^2*DP tensor-core FLOP in all, a
                # floor the run computes (the row holds measured times only)
                floor_ms = 6.0 * b * h * n * n * dp / BF16_FLOP_PER_S * 1e3
                extra = f", product floor {floor_ms:.4f}"
            log(f"[variants] {variant} {name} {shape} (block {row['block']}{extra}): "
                f"{row['ms']:.4f} ms (graph), plain {plain_ms:.4f}, SDPA {sdpa_ms:.4f}, "
                f"bound {ms_bound:.4f} by {by}")
            rows.append(row)
        del q, k, v, qt, kt, vt, want
        torch.cuda.empty_cache()

    # this slice's path: the bench entry, every kernel's count from 0
    every = (*fwd_kernels, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for kern in every:
        kern.launches = 0
        kern.launches_by_shape.clear()
    t0 = time.perf_counter()
    bench.main(["--repeats", "10"])
    counts = {kern.symbol: (kern.launches, dict(kern.launches_by_shape)) for kern in every}
    log(f"[variants] bench entry in {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps({s: c[0] for s, c in counts.items()})}")
    if not all(kern.launches for kern in fwd_kernels) or fa.flash_bwd_dq.launches \
            or fa.flash_bwd_dkv.launches:
        raise AssertionError("the bench entry did not launch every forward kernel, or "
                             "launched a backward one")
    for row in rows:
        kern = kernels[row["name"].split("/")[0].removeprefix("flash_fwd_")]
        row["launches"] = counts[kern.symbol][1].get(bench.SHAPES[row["name"].split("/")[1]], 0)
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch on the bench entry's path")
    return rows


@clocked
def phase_variants_f32() -> list[dict]:
    """Phase 11 at fp32: K3 and K4 of csrc/flash_fp32.cu against
    flash_attention_plain at fp32 (F32_MAX_REL, F32_L2_REL, the LSE too) at
    VARIANT_CHECKS and the benchmark's shapes, at every fp32 key block and
    every cluster size of K3, on randn, peaked (q, k x8) and rising-max
    scores, each launch repeated and compared bitwise; each
    flash_forward(variant=...) call on fp32 operands launching its fp32
    kernel once and no other kernel (counted by dtype); then each kernel
    timed (a CUDA graph of 20 calls) beside the plain version, SDPA at fp32,
    the fp32 forward (K1/K2) at the same shape and the function's bound at
    fp32 accuracy's rates (bound_3xtf32: S on FMA beside P V as 3xTF32, for
    K3 and K4 alike; the all-FMA bound in the log, and for K4 the floors of
    its algorithm, which computes S twice: 4*B*H*N^2*D on FMA beside P V,
    and 6*B*H*N^2*D all on FMA). A row's launches ("dtype": "float32") are its kernel's fp32
    launches by the flash_forward calls at its shape, every count set to 0
    just before them; no path of the edit or of training runs K3 or K4
    (phase 21 counts them there)."""
    import torch
    import torch.nn.functional as F

    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.scripts import bench_attention as bench

    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(11)
    rand = lambda shape: torch.randn(shape, generator=gen, device="cuda")
    kernels = {"resident": fa.flash_fwd_resident, "pipelined": fa.flash_fwd_pipelined}
    fwd_kernels = {"flash_fwd": fa.flash_fwd, **{f"flash_fwd_{v}": k for v, k in kernels.items()}}
    t0 = time.perf_counter()

    def check_one(kern, q, k, v, want, label, **kw):
        """one launch against the plain version, then a second launch that
        must give the same bits of O and of the LSE"""
        got = kern(q, k, v, return_lse=True, **kw)
        again = kern(q, k, v, return_lse=True, **kw)
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            raise AssertionError(f"{label}: two launches differ")
        return compare_flash(got, want, label)

    def check_all(q, k, v, label):
        """every fp32 launch of K3 and K4 on (q, k, v) -> {variant: (max
        err, max lse err)}"""
        want = fa.flash_attention_plain(q, k, v, return_lse=True)
        dp = (q.shape[3] + 15) // 16 * 16
        errs = {}
        for variant, kern in kernels.items():
            clusters = fa.CLUSTER_SIZES if variant == "resident" else (None,)
            e = [check_one(kern, q, k, v, want,
                           f"fp32 {variant} {label} {tuple(q.shape)} block {blk}"
                           + (f" cluster {c}" if c else ""),
                           block=blk, **({"cluster": c} if c else {}))
                 for blk in fa.block_table(variant, f32)[dp] for c in clusters]
            errs[variant] = (max(x for x, _ in e), max(y for _, y in e))
        return errs

    for shape in VARIANT_CHECKS:
        check_all(rand(shape), rand(shape), rand(shape), "check")

    rows = []
    for name, shape in bench.SHAPES.items():
        b, n, h, d = shape
        q, k, v = rand(shape), rand(shape), rand(shape)
        want = fa.flash_attention_plain(q, k, v, return_lse=True)
        # every flash_forward(variant=...) call on fp32 operands: the plain
        # version's O and LSE, and one fp32 launch of its kernel
        for kern in fwd_kernels.values():
            kern.reset()
        for variant in fa.VARIANTS:
            before = {kn: dict(kern.launches_by_dtype) for kn, kern in fwd_kernels.items()}
            compare_flash(fa.flash_forward(q, k, v, variant=variant, return_lse=True), want,
                          f"fp32 flash_forward(variant={variant!r}) {name} {shape}")
            diff = {kn: {dt: c - before[kn].get(dt, 0) for dt, c in
                         kern.launches_by_dtype.items() if c != before[kn].get(dt, 0)}
                    for kn, kern in fwd_kernels.items()}
            mine = f"flash_fwd_{variant}" if variant in kernels else "flash_fwd"
            if diff != {kn: ({"float32": 1} if kn == mine else {}) for kn in fwd_kernels}:
                raise AssertionError(f"fp32 flash_forward(variant={variant!r}) at {shape} "
                                     f"launched {diff}")
        launches = {kn: kern.launches_by_dtype["float32"] for kn, kern in fwd_kernels.items()}
        log(f"[variants-f32] {name}: each fp32 flash_forward variant launched its own fp32 "
            f"kernel once: {launches}")
        qr, kr = rising_scores(shape, gen, f32)
        check_all(qr, kr, v, "rising max")
        check_all(q * 8, k * 8, v, "peaked (q, k x8)")
        del qr, kr
        errs = check_all(q, k, v, name)

        plain_ms = graph_ms(lambda: fa.flash_attention_plain(q, k, v), 3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
        backend = sdpa_backend(qt, kt, vt)
        fwd_ms = graph_ms(lambda: fa.flash_fwd(q, k, v), 20)
        nbytes = 4 * b * n * h * d * 4
        _, fma_ms = bound(4.0, b, n, h, d, nbytes, f32=True)
        # the function's bound: S on FMA beside P V as 3xTF32
        by, ms_bound = bound_3xtf32(4.0, b, n, h, d, nbytes)
        for variant, kern in kernels.items():
            row = {"name": f"flash_fwd_{variant}/f32_{name}", "route": "cuda",
                   "source": "pbe_tpu_torch/csrc/flash_fp32.cu",
                   "replaces": K3 if variant == "resident" else K4, "dtype": "float32",
                   "launches": launches[f"flash_fwd_{variant}"],
                   "max_abs_err": errs[variant][0],
                   "lse_max_abs_err": errs[variant][1],
                   "ms": graph_ms(lambda: kern(q, k, v), 20), "plain_ms": plain_ms,
                   "bound_ms": ms_bound, "bound_by": "bytes" if by == "bytes" else "operations",
                   "library": f"sdpa ({backend})", "library_ms": sdpa_ms,
                   "block": fa.key_block(variant, d), "fwd_f32_ms": fwd_ms}
            if variant == "resident":
                row["cluster"] = fa.flash_fwd_resident.plan(
                    shape, sms=torch.cuda.get_device_properties(0).multi_processor_count,
                    dtype=f32)[1]
                row["cluster_ms"] = {c: graph_ms(lambda: kern(q, k, v, cluster=c), 20)
                                     for c in fa.CLUSTER_SIZES}
                extra = (f", cluster {row['cluster']}; at C = 1/2/4: "
                         + " / ".join(f"{t:.4f}" for t in row["cluster_ms"].values()))
            else:
                # K4's algorithm computes S twice: 4*BH*N^2*D FLOP on FMA
                # (P V as 3xTF32 beside it takes less), and 6 all on FMA
                s_twice, all_fma = (x * b * h * n * n * d / FP32_FLOP_PER_S * 1e3
                                    for x in (4.0, 6.0))
                extra = f", S-twice floor {s_twice:.4f}, all-FMA floor {all_fma:.4f}"
            log(f"[variants-f32] {variant} {name} {shape} (block {row['block']}{extra}): "
                f"{row['ms']:.4f} ms (graph), plain {plain_ms:.4f}, SDPA {sdpa_ms:.4f} "
                f"({backend}), fp32 flash_fwd {fwd_ms:.4f}, bound {ms_bound:.4f} by {by} "
                f"(all-FMA bound {fma_ms:.4f})")
            rows.append(row)
        del q, k, v, qt, kt, vt, want
        torch.cuda.empty_cache()
    log(f"[variants-f32] every check passed and timed in {time.perf_counter() - t0:.1f} s")
    return rows


def set_attn_impl(model, impl: str) -> None:
    for m in model.modules():
        if hasattr(m, "attn_impl"):
            m.attn_impl = impl


@clocked
def phase_unet(model) -> None:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    x9 = torch.randn((2, 64, 64, 9), generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((2, 1, 768), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.tensor([500.0, 500.0], device="cuda")
    with torch.inference_mode():
        eps_flash = model.apply_model(x9, t, ctx).float()
        set_attn_impl(model, "plain")
        eps_plain = model.apply_model(x9, t, ctx).float()
        set_attn_impl(model, "flash")
    rel = ((eps_flash - eps_plain).norm() / eps_plain.norm()).item()
    finite = bool(torch.isfinite(eps_flash).all())
    # bf16 through 16 transformer blocks and 25 res blocks: the attention
    # outputs differ by bf16 rounding (2^-8), which the residual stream
    # carries; a wrong kernel gives O(1)
    log(f"[unet] v1 CFG call (2,64,64,9) bf16: flash vs plain eps rel L2 {rel:.3e} "
        f"(tol 5e-2), eps rms {eps_plain.square().mean().sqrt().item():.4f}")
    if not (finite and rel <= 5e-2):
        raise AssertionError("full UNet with the flash kernel disagrees with plain attention")


DEV_MS = lambda e: getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0)) / 1e3


def kernel_group(name: str) -> str:
    n = name.lower()
    return ("flash_fwd" if "flash_fwd" in n else
            "flash_bwd_dq" if "flash_bwd_dq" in n else
            "flash_bwd_dkv" if "flash_bwd_dkv" in n else
            "optimizer (adamw, grad norm)" if "multi_tensor" in n or "adam" in n else
            "layout (nchw<->nhwc)" if "nchwtonhwc" in n or "nhwctonchw" in n else
            "conv" if any(s in n for s in ("conv", "fprop", "implicit", "dgrad", "wgrad")) else
            "gemm" if any(s in n for s in ("gemm", "nvjet", "cublas", "cutlass")) else
            "norm" if "norm" in n or "moments" in n else
            "copy/cast" if "copy" in n else "elementwise/other")


def device_time(prof):
    """Device-side kernels of a profile, slowest first, their summed time
    (ms) and that time by kernel_group; the CPU ops' entries, and the user
    annotations drawn on the device timeline (Optimizer.step#AdamW.step),
    repeat their kernels' time and are left out."""
    from torch.autograd import DeviceType

    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and DEV_MS(e) > 0
                      and not getattr(e, "is_user_annotation", False)),
                     key=DEV_MS, reverse=True)
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    groups: dict[str, float] = {}
    for e in kernels:
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + DEV_MS(e)
    return kernels, sum(DEV_MS(e) for e in kernels), groups


@clocked
def phase_profile(model) -> None:
    """Where one warm v1 CFG UNet call spends the card's time: device time
    by kernel (torch.profiler) and the device's idle share, taken against
    the call's wall time without the profiler (which slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(7)
    x9 = torch.randn((2, 64, 64, 9), generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((2, 1, 768), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.tensor([500.0, 500.0], device="cuda")
    calls = 5
    with torch.inference_mode():
        for _ in range(2):
            model.apply_model(x9, t, ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            model.apply_model(x9, t, ctx)
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                model.apply_model(x9, t, ctx)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # and once more without it: whether the host stays slower after a
        # profile, which would bear on every phase timed after this one
        t0 = time.perf_counter()
        for _ in range(calls):
            model.apply_model(x9, t, ctx)
        torch.cuda.synchronize()
        after_ms = (time.perf_counter() - t0) * 1e3
    kernels, busy, groups = device_time(prof)
    log(f"[profile] v1 CFG UNet call x{calls}: wall {plain_wall_ms / calls:.3f} ms/call "
        f"({wall_ms / calls:.3f} under the profiler, {after_ms / calls:.3f} after it), "
        f"device busy {busy / calls:.3f} ms/call, idle share "
        f"{1 - busy / plain_wall_ms:.3f}")
    log(f"[profile] by group (ms/call): "
        f"{json.dumps({k: round(v / calls, 4) for k, v in sorted(groups.items())})}")
    for e in kernels[:15]:
        log(f"[profile]   {DEV_MS(e) / calls:9.4f} ms/call  x{e.count // calls:4d}  "
            f"{e.key[:110]}")


def edit_inputs(size: int, ref_size: int, seed: int):
    g = np.random.default_rng(seed)
    image = g.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    mask = np.ones((1, size, size, 1), np.float32)
    q = size // 4
    mask[:, q:3 * q, q:3 * q] = 0.0
    ref = g.standard_normal((1, ref_size, ref_size, 3)).astype(np.float32)
    return image, mask, ref


@clocked
def phase_edit(pipe, card: str, rows: list[dict]) -> dict:
    import torch

    from pbe_tpu_torch.ops import flash_attention as fa

    image, mask, ref = edit_inputs(512, 224, seed=2)
    variants = (fa.flash_fwd_resident, fa.flash_fwd_pipelined)
    for kern in (fa.flash_fwd, *variants):
        kern.reset()
    t0 = time.perf_counter()
    out = pipe.edit_batch(image, mask, ref, steps=50, scale=5.0, seed=3)
    first_s = time.perf_counter() - t0
    launches = fa.flash_fwd.launches
    by_shape = dict(fa.flash_fwd.launches_by_shape)
    by_kernel = dict(fa.flash_fwd.launches_by_kernel)
    log(f"[edit] 512^2 50-step PLMS scale 5 batch 1: first edit {first_s:.3f} s, "
        f"flash launches {launches} (expected {LAUNCHES_PER_EDIT}), by shape {by_shape}, by "
        f"kernel {by_kernel}; resident {variants[0].launches}, pipelined "
        f"{variants[1].launches} (expected 0)")
    if any(kern.launches for kern in variants):
        raise AssertionError("the edit launched the resident or pipelined kernel")
    if by_kernel != {"flash_fwd": launches}:
        raise AssertionError(f"the edit's forward launches by kernel {by_kernel}: not all the "
                             f"tuned kernels'")
    if out.shape != (1, 512, 512, 3) or not np.isfinite(out).all():
        raise AssertionError(f"edit output shape {out.shape} or non-finite values")
    if out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"edit output outside [0,1]: [{out.min()}, {out.max()}]")
    digest = hashlib.sha256(out.tobytes()).hexdigest()[:16]
    log(f"[edit] output mean {out.mean():.4f} std {out.std():.4f}, sha256 {digest}")
    if launches != LAUNCHES_PER_EDIT:
        raise AssertionError(f"flash kernel launched {launches} times, not "
                             f"{LAUNCHES_PER_EDIT}")
    for row, (_, shape, _, per_edit) in zip(rows, FLASH_SHAPES):
        row["launches"] = by_shape.get(shape, 0)
        if row["launches"] != per_edit:
            raise AssertionError(f"{row['name']}: {row['launches']} launches, expected "
                                 f"{per_edit}")
    times = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.edit_batch(image, mask, ref, steps=50, scale=5.0, seed=4 + i)
        times.append(time.perf_counter() - t0)
    p50 = float(np.median(times))
    log(f"[edit] warm edits {['%.4f' % t for t in times]} s: p50 {p50:.4f} s, "
        f"{1.0 / p50:.4f} edits/s ({card})")
    # the block=False handle the reference's server polls: is_ready() turns
    # True within a time limit, and the host copy is the blocking edit's
    kw = dict(steps=10, scale=5.0, seed=9)
    pending = pipe.edit_batch(image, mask, ref, block=False, **kw)
    t0 = time.perf_counter()
    polls = 1
    while not pending.is_ready():
        if time.perf_counter() - t0 > 120.0:
            raise AssertionError("a block=False edit was not ready within 120 s")
        time.sleep(0.001)
        polls += 1
    ready_s = time.perf_counter() - t0
    got = np.asarray(pending)
    want = pipe.edit_batch(image, mask, ref, **kw)
    log(f"[edit] block=False 10-step edit: ready after {polls} polls, {ready_s:.4f} s after "
        f"edit_batch returned; equal to block=True: {np.array_equal(got, want)}")
    if not np.array_equal(got, want):
        raise AssertionError("the block=False edit differs from the block=True edit")
    return {"first_edit_s": first_s, "warm_edit_s": times, "p50_s": p50,
            "edits_per_s": 1.0 / p50, "output_sha256": digest}


@clocked
def phase_reference() -> None:
    """configs/tiny.yaml 64^2 edit: bf16 + flash kernel on the card against
    fp32 + plain attention on the CPU, the same seeded weights."""
    import torch

    from pbe_tpu_torch.pipelines.loading import load_pipeline, randomize_zero_params

    gpu, _ = load_pipeline("configs/tiny.yaml", device="cuda", verbose=False)
    randomize_zero_params(gpu.model, seed=0)
    cpu, _ = load_pipeline("configs/tiny.yaml", device="cpu", dtype=torch.float32,
                           attn_impl="plain", verbose=False)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    image, mask, ref = edit_inputs(64, gpu.ref_size, seed=5)
    n = 64 // gpu.model.latent_downsample
    x_T = np.random.default_rng(6).standard_normal((1, n, n, 4)).astype(np.float32)
    kw = dict(steps=4, scale=5.0, x_T=x_T, det_first_stage=True)
    got = gpu.edit_batch(image, mask, ref, **kw)
    want = cpu.edit_batch(image, mask, ref, **kw)
    diff = np.abs(got - want)
    # bf16 activations and weights (rel 2^-8) through 5 UNet calls and the
    # VAE decode, against fp32: a few bf16 ulps of the [0,1] image on average
    log(f"[reference] tiny 64^2 4-step edit, card bf16 vs CPU fp32: max|diff| "
        f"{diff.max():.4f} (tol 0.15), mean {diff.mean():.5f} (tol 0.02)")
    if not (np.isfinite(got).all() and diff.max() <= 0.15 and diff.mean() <= 0.02):
        raise AssertionError("card edit disagrees with the CPU fp32 reference")


def counted(fa, fn):
    """fn() with every forward kernel's launch count set to 0 just before
    and read just after -> (fn's result, flash_fwd launches, flash_fwd
    launches by shape); raises if the resident or pipelined kernel ran."""
    variants = (fa.flash_fwd_resident, fa.flash_fwd_pipelined)
    for kern in (fa.flash_fwd, *variants):
        kern.launches = 0
        kern.launches_by_shape.clear()
    out = fn()
    if any(kern.launches for kern in variants):
        raise AssertionError("a CLI launched the resident or pipelined kernel")
    return out, fa.flash_fwd.launches, dict(fa.flash_fwd.launches_by_shape)


def write_test_bench(root: str, n: int, size: int, seed: int) -> list[str]:
    """A COCOEE-layout dir (pbe_tpu_torch/data/test_bench.py) of n seeded
    pairs: smooth GT images, exemplars cut from them, white-box masks."""
    from PIL import Image

    g = np.random.default_rng(seed)
    for sub in ("GT_3500", "Ref_3500", "Mask_bbox_3500"):
        os.makedirs(os.path.join(root, sub))
    ids = list(range(1, n + 1))
    np.save(os.path.join(root, "id_list.npy"), np.asarray(ids))
    for i in ids:
        gt = smooth_image(g, size)
        y, x = g.integers(0, size // 2, 2)
        m = np.zeros((size, size), np.uint8)
        m[y:y + size // 3, x:x + size // 3] = 255
        Image.fromarray(gt).save(os.path.join(root, "GT_3500", f"{i:012d}_GT.png"))
        Image.fromarray(gt[y:y + size // 3, x:x + size // 3]).save(
            os.path.join(root, "Ref_3500", f"{i:012d}_ref.png"))
        Image.fromarray(m).save(os.path.join(root, "Mask_bbox_3500", f"{i:012d}_mask.png"))
    return [f"{i:012d}" for i in ids]


def smooth_image(g, size: int) -> np.ndarray:
    """Seeded (size, size, 3) uint8 of 8x8 flat blocks in [40, 215): the
    watermark's chroma steps stay clear of 0 and 255."""
    blocks = g.integers(40, 215, (size // 8, size // 8, 3), np.uint8)
    return np.kron(blocks, np.ones((8, 8, 1), np.uint8))


@clocked
def phase_cli(pipe, zero_names: list[str], card: str, rows: list[dict]) -> dict:
    """The edit CLIs in-process at full width (v1, 512^2, bf16), on a
    checkpoint of the tensors randomize_zero_params changed (the rest is
    load_pipeline's seeded init, so the CLIs' weights are pipe's bit for
    bit): (a) DDIM 50 at scale 5, three iterations, against edit_batch;
    (b) PLMS with --paste_back 8, watermarked and not; (c) the default
    scale 1; then the test bench over 6 pairs at --n_samples 4. Every run's
    flash launches are counted from 0; the kernel at the new shapes is
    checked and timed after."""
    import gc
    import tempfile

    import torch
    from PIL import Image

    from pbe_tpu_torch.data import transforms as T
    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.scripts import inference, inference_test_bench
    from pbe_tpu_torch.utils.watermark import extract_watermark

    def run(fn, *argv):
        out = counted(fa, lambda: fn(list(argv)))
        gc.collect()
        torch.cuda.empty_cache()
        return out

    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        params = dict(pipe.model.named_parameters())
        ckpt = os.path.join(tmp, "seeded.ckpt")
        torch.save({"state_dict": {n: params[n].detach().cpu() for n in zero_names}}, ckpt)
        g = np.random.default_rng(21)
        src, mask_png, ref_png = (os.path.join(tmp, f) for f in ("src.png", "mask.png",
                                                                 "ref.png"))
        Image.fromarray(smooth_image(g, 512)).save(src)
        m = np.zeros((512, 512), np.uint8)
        # white = the region to edit, 8% of the image. The watermark votes
        # each payload bit over blocks spread through the image; an edit
        # region half the image tall, saturated by random weights, can
        # outvote the rest for the bits whose blocks it covers
        m[192:320, 176:336] = 255
        Image.fromarray(m).save(mask_png)
        Image.fromarray(smooth_image(g, 224)).save(ref_png)
        log(f"[cli] checkpoint of {len(zero_names)} tensors and inputs written in "
            f"{time.perf_counter() - t0:.1f} s")
        common = ["--config", "configs/v1.yaml", "--ckpt", ckpt, "--image_path", src,
                  "--mask_path", mask_png, "--reference_path", ref_png, "--seed", "321"]

        # (a) DDIM, 50 steps, scale 5: three edits, the seed advancing
        out_a = os.path.join(tmp, "a")
        times, n, _ = run(inference.main, *common, "--outdir", out_a, "--scale", "5",
                          "--n_iter", "3", "--no_watermark")
        image = T.load_image(src, (512, 512))
        keep = T.load_mask(mask_png, (512, 512))
        ref = T.load_reference(ref_png, pipe.ref_size)
        want = T.to_uint8(pipe.edit_batch(image[None], keep[None], ref[None], steps=50,
                                          scale=5.0, sampler="ddim", seed=321)[0])
        got = np.asarray(Image.open(os.path.join(out_a, "results", "src_321.png")))
        steady = float(np.mean(times[1:]))
        log(f"[cli] (a) DDIM 50 scale 5 x3: flash launches {n} ({n / 3:.0f} an edit, "
            f"expected {DDIM_LAUNCHES}); edits {['%.4f' % t for t in times]} s, steady "
            f"{steady:.4f} s ({card}); result PNG equal to edit_batch's: "
            f"{np.array_equal(got, want)}")
        if n != 3 * DDIM_LAUNCHES:
            raise AssertionError(f"the DDIM CLI edit launched {n / 3} flash kernels an edit")
        if not np.array_equal(got, want):
            diff = np.abs(got.astype(int) - want)
            raise AssertionError(f"the CLI's DDIM result differs from edit_batch's: max "
                                 f"{diff.max()}, {(diff > 0).mean():.4f} of the values")
        summary["ddim_edit_s"], summary["ddim_steady_s"] = times, steady

        # (b) PLMS with --paste_back 8: stamped, and a twin without the
        # watermark (which moves pixels everywhere) for the bit-exact check
        counts = {}
        for name, extra in (("stamped", []), ("twin", ["--no_watermark"])):
            times, counts[name], _ = run(inference.main, *common, "--outdir",
                                         os.path.join(tmp, name), "--scale", "5", "--plms",
                                         "--paste_back", "8", "--n_iter", "1", *extra)
        stamped, twin = (np.asarray(Image.open(os.path.join(tmp, name, "results",
                                                            "src_321.png")))
                         for name in ("stamped", "twin"))
        source = np.asarray(Image.open(src))
        kept = keep[..., 0] == 1.0
        mark = extract_watermark(stamped)
        log(f"[cli] (b) PLMS --paste_back 8: launches {counts} (expected "
            f"{LAUNCHES_PER_EDIT} each); mask==1 pixels equal to the source: "
            f"{np.array_equal(twin[kept], source[kept])} ({kept.sum()} pixels); edit region "
            f"max|result - source| {np.abs(twin[~kept].astype(int) - source[~kept]).max()}; "
            f"watermark reads {mark!r}; stamped vs twin max|diff| "
            f"{np.abs(stamped.astype(int) - twin).max()}")
        if any(c != LAUNCHES_PER_EDIT for c in counts.values()):
            raise AssertionError(f"the PLMS CLI edits launched {counts} flash kernels")
        if not np.array_equal(twin[kept], source[kept]):
            raise AssertionError("paste_back changed a pixel the mask keeps")
        if mark != b"Paint-by-Example" or np.array_equal(stamped, twin):
            raise AssertionError("the CLI's watermark does not read back")

        # (c) the CLI's default --scale 1: one UNet call a step at batch 1
        times, n, by_shape = run(inference.main, *common, "--outdir",
                                 os.path.join(tmp, "c"), "--n_iter", "1")
        log(f"[cli] (c) default scale 1, DDIM 50: flash launches {n} (expected "
            f"{DDIM_LAUNCHES}), by shape {by_shape}; edit {times[0]:.4f} s ({card})")
        if n != DDIM_LAUNCHES:
            raise AssertionError(f"the scale-1 CLI edit launched {n} flash kernels")
        runs = {"scale 1": by_shape}
        summary["scale1_edit_s"] = times[0]

        # the test bench: 6 pairs in batches of 4, the last one ragged
        bench = os.path.join(tmp, "bench")
        ids = write_test_bench(bench, 6, 512, seed=22)
        out_b = os.path.join(tmp, "bench_out")
        res, n, by_shape = run(inference_test_bench.main, "--config", "configs/v1.yaml",
                               "--ckpt", ckpt, "--test_bench_dir", bench, "--outdir", out_b,
                               "--plms", "--n_samples", "4", "--scale", "5", "--seed", "321")
        results = sorted(os.listdir(os.path.join(out_b, "results")))
        grids = sorted(f for f in os.listdir(os.path.join(out_b, "grid"))
                       if f.startswith("grid_"))
        log(f"[cli] test bench, 6 pairs, --n_samples 4 scale 5 PLMS 50: batches "
            f"{[(b, round(t, 4)) for b, t in res['batches']]} (pairs, s); flash launches "
            f"{n} (expected {2 * LAUNCHES_PER_EDIT}), by shape {by_shape}; {len(results)} "
            f"results, {len(grids)} grids; steady-state {res['steady_edits_per_s']:.4f} "
            f"edits/s wall incl. host IO; first batch {4 / res['batches'][0][1]:.4f} "
            f"edits/s ({card})")
        if n != 2 * LAUNCHES_PER_EDIT:
            raise AssertionError(f"the test bench launched {n} flash kernels")
        if results != [f"{i}.png" for i in ids] or grids != [f"grid_{i}.png" for i in ids]:
            raise AssertionError(f"the test bench wrote {results} and {grids}")
        runs["test bench"] = by_shape
        summary["bench"] = res

    gen = torch.Generator(device="cuda").manual_seed(23)
    rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    for name, shape, replaces, run_name, want_n in CLI_SHAPES:
        row = kernel_row(fa, name, shape, replaces, rand)
        row["launches"] = runs[run_name].get(shape, 0)
        if row["launches"] != want_n:
            raise AssertionError(f"{name}: {row['launches']} launches in the {run_name} "
                                 f"run, expected {want_n}")
        rows.append(row)
    return summary


@clocked
def phase_serving(pipe, card: str, rows: list[dict]) -> dict:
    """The micro-batching EditServer on phase 4's v1 pipeline (512^2, PLMS
    50, scale 5, uint8 out): warmup() with 818 flash launches a bucket;
    (a) one request alone at bucket 1, in a burst of 3 (bucket 4, 1 pad
    row) and alone at a buckets=(4,) server: bitwise equal within bucket 4,
    the difference across buckets printed; (b) 8 threads submitting 16
    requests: every future resolves, each request counted once, 818 flash
    launches a batch; a burst of 4 at bucket 1 against the same 4 one at a
    time (what the double-buffered dispatch hides); (c) two fresh servers,
    one seed, the same bits; (d) the HTTP front (serve.make_handler) on a
    loopback port; (e) the forward kernel at bucket 8's shapes."""
    import base64
    import http.client
    import io
    import threading
    from http.server import ThreadingHTTPServer

    import torch
    from PIL import Image

    from pbe_tpu_torch.data import transforms as T
    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.scripts import serve
    from pbe_tpu_torch.serving import EditServer

    if torch.backends.cudnn.benchmark:
        raise AssertionError("cudnn.benchmark is on: the convs' algorithms would vary by run")
    kw = dict(steps=50, sampler="plms", scale=5.0, output_uint8=True)
    g = np.random.default_rng(31)
    reqs = [tuple(a[0] for a in edit_inputs(512, pipe.ref_size, seed=40 + i)) for i in range(4)]
    summary = {}

    srv = EditServer(pipe, buckets=(1, 2, 4, 8), **kw)
    t0 = time.perf_counter()
    _, n, by_shape = counted(fa, lambda: srv.warmup(512, 512))
    log(f"[serve] warmup of buckets {srv.buckets} in {time.perf_counter() - t0:.1f} s: flash "
        f"launches {n} (expected {4 * LAUNCHES_PER_EDIT}), by shape {by_shape}")
    if n != 4 * LAUNCHES_PER_EDIT:
        raise AssertionError(f"warmup launched {n} flash kernels")

    # (a) batch invariance: R alone at bucket 1, R last in a burst of 3
    # (bucket 4, one pad row), R alone at a buckets=(4,) server
    image, mask, ref = reqs[0]
    solo1 = srv.edit(image, mask, ref, seed=11)
    before = srv.stats()
    futs = [srv.submit(*reqs[k], seed=100 + k) for k in (1, 2)]
    futs.append(srv.submit(image, mask, ref, seed=11))
    burst = [f.result(600) for f in futs]
    after = srv.stats()
    srv.close()
    delta = {k: after[k] - before[k] for k in ("requests", "batches", "padded_rows")}
    with EditServer(pipe, buckets=(4,), **kw) as srv4:
        solo4 = srv4.edit(image, mask, ref, seed=11)
    across = np.abs(solo1.astype(np.int16) - burst[2]) / 255.0
    log(f"[serve] (a) burst of 3: {delta} (expected 3 requests, 1 batch, 1 pad row); "
        f"within bucket 4 (R last of 3 vs R alone, padded with itself) bitwise equal: "
        f"{np.array_equal(burst[2], solo4)}; across buckets 1 and 4: max|diff| "
        f"{across.max():.4f}, mean {across.mean():.6f} of [0,1], "
        f"{(across > 0).mean():.4f} of the values differ")
    if delta != {"requests": 3, "batches": 1, "padded_rows": 1}:
        raise AssertionError(f"the burst of 3 was not one batch at bucket 4: {delta}")
    if not np.array_equal(burst[2], solo4):
        diff = np.abs(burst[2].astype(np.int16) - solo4)
        raise AssertionError(f"within bucket 4 a request's result depends on its "
                             f"batch-mates: max {diff.max()}, {(diff > 0).mean():.4f} differ")
    summary["across_buckets_max"] = float(across.max())
    summary["across_buckets_mean"] = float(across.mean())

    # (b) concurrent load: 8 threads x 2 requests
    lat, errors, lock = [], [], threading.Lock()
    with EditServer(pipe, buckets=(1, 2, 4, 8), **kw) as srv:
        def client(k):
            for j in range(2):
                t = time.perf_counter()
                try:
                    out = srv.edit(*reqs[(k + j) % 4], seed=1000 + 2 * k + j, timeout=900)
                    assert out.shape == (512, 512, 3) and out.dtype == np.uint8
                except Exception as e:  # every failure is reported below
                    with lock:
                        errors.append(repr(e))
                    continue
                with lock:
                    lat.append(time.perf_counter() - t)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]

        def run():
            for th in threads:
                th.start()
            for th in threads:
                th.join(1200)
        t0 = time.perf_counter()
        _, n, _ = counted(fa, run)
        wall = time.perf_counter() - t0
        st = srv.stats()
    log(f"[serve] (b) 8 threads x 2 requests: {len(lat)} resolved, errors {errors}; stats "
        f"{json.dumps(st)}; flash launches {n} (expected {LAUNCHES_PER_EDIT} x "
        f"{st['batches']} batches); latency p50 {np.median(lat):.4f} s, max {max(lat):.4f} s; "
        f"{16 / wall:.4f} edits/s over the burst ({wall:.3f} s); mean occupancy "
        f"{st['mean_batch_occupancy']:.4f} ({card})")
    if errors or len(lat) != 16 or any(th.is_alive() for th in threads):
        raise AssertionError(f"the concurrent burst lost requests: {errors}")
    if st["requests"] != 16 or st["errors"] or n != LAUNCHES_PER_EDIT * st["batches"]:
        raise AssertionError(f"the burst's accounting is off: {st}, {n} launches")
    summary.update(burst_p50_s=float(np.median(lat)), burst_edits_per_s=16 / wall,
                   burst_occupancy=st["mean_batch_occupancy"], burst_batches=st["batches"])

    # what the double-buffered dispatch hides: 4 requests at bucket 1 one at
    # a time (each waits for its result) and submitted together, in turns
    walls = {"one at a time": [], "together": []}
    lats = {"one at a time": [], "together": []}
    first = None
    with EditServer(pipe, buckets=(1,), **kw) as srv:
        for mode in ("one at a time", "together", "together", "one at a time"):
            t0 = time.perf_counter()
            if mode == "one at a time":
                outs = []
                for k in range(4):
                    outs.append(srv.edit(*reqs[k], seed=200 + k))
                    lats[mode].append(time.perf_counter() - t0)
            else:
                futs = [srv.submit(*reqs[k], seed=200 + k) for k in range(4)]
                done_at = [0.0] * 4
                for k, f in enumerate(futs):
                    f.add_done_callback(
                        lambda _, k=k: done_at.__setitem__(k, time.perf_counter()))
                outs = [f.result(900) for f in futs]
                lats[mode] += [t - t0 for t in done_at]
            walls[mode].append(time.perf_counter() - t0)
            first = first or outs
            if not all(np.array_equal(a, b) for a, b in zip(first, outs)):
                raise AssertionError("the double-buffered burst changed a result")
    seq, piped = (float(np.mean(walls[m])) for m in ("one at a time", "together"))
    log(f"[serve] (b) 4 requests at bucket 1, in turns: one at a time "
        f"{['%.4f' % w for w in walls['one at a time']]} s, submitted together "
        f"(double-buffered) {['%.4f' % w for w in walls['together']]} s: hidden "
        f"{seq - piped:.4f} s of {seq:.4f} ({(seq - piped) / seq:.4f}); mean time to a "
        f"result {np.mean(lats['one at a time']):.4f} s one at a time (counted from the "
        f"first submit), {np.mean(lats['together']):.4f} s together; results equal ({card})")
    summary.update(sequential_4_s=walls["one at a time"], pipelined_4_s=walls["together"],
                   hidden_share=(seq - piped) / seq)

    # (c) two fresh servers, one seed
    outs = []
    for _ in range(2):
        with EditServer(pipe, buckets=(1,), **kw) as srv:
            outs.append(srv.edit(*reqs[3], seed=77))
    log(f"[serve] (c) two fresh servers, seed 77: bitwise equal {np.array_equal(*outs)}")
    if not np.array_equal(*outs):
        raise AssertionError("two servers gave one seed different results")

    # (d) the HTTP front on a loopback port
    def b64(arr, mode):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    m = np.zeros((512, 512), np.uint8)
    m[160:352, 128:384] = 255
    payloads = [{"image": b64(smooth_image(g, 512), "RGB"), "mask": b64(m, "L"),
                 "reference": b64(smooth_image(g, 224), "RGB"), "seed": s} for s in (5, 6)]
    with EditServer(pipe, buckets=(1, 2, 4, 8), **kw) as srv:
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(srv, (512, 512)))
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            def request(method, path, payload=None):
                conn = http.client.HTTPConnection(*httpd.server_address, timeout=600)
                body = None if payload is None else json.dumps(payload).encode()
                conn.request(method, path, body=body)
                resp = conn.getresponse()
                out = json.loads(resp.read())
                conn.close()
                return resp.status, out

            health = request("GET", "/healthz")
            results = [request("POST", "/edit", p) for p in payloads]
            stats = request("GET", "/stats")
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(30)
        equal = []
        for p, (status, out) in zip(payloads, results):
            if status != 200:
                raise AssertionError(f"POST /edit answered {status}: {out}")
            got = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["result"]))))
            dec = lambda k: io.BytesIO(base64.b64decode(p[k]))
            want = srv.edit(T.load_image(dec("image"), (512, 512)),
                            T.load_mask(dec("mask"), (512, 512)),
                            T.load_reference(dec("reference"), pipe.ref_size), seed=p["seed"])
            equal.append(np.array_equal(got, want))
    log(f"[serve] (d) HTTP: /healthz {health}; /stats {stats[0]} requests "
        f"{stats[1]['requests']}; POST /edit x2 latency_ms "
        f"{[r[1]['latency_ms'] for r in results]}; PNGs equal to EditServer.edit: {equal}")
    if health != (200, {"ok": True}) or stats[0] != 200 or stats[1]["requests"] != 2:
        raise AssertionError(f"the HTTP front answered {health}, {stats}")
    if not all(equal):
        raise AssertionError("an HTTP result differs from EditServer.edit's")

    # (e) the forward kernel at bucket 8's shapes, launches from the warmup
    gen = torch.Generator(device="cuda").manual_seed(33)
    rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    for name, shape, replaces, want_n in SERVE_SHAPES:
        row = kernel_row(fa, name, shape, replaces, rand)
        row["launches"] = by_shape.get(shape, 0)
        if row["launches"] != want_n:
            raise AssertionError(f"{name}: {row['launches']} launches in the warmup of "
                                 f"bucket 8, expected {want_n}")
        rows.append(row)
    return summary


@clocked
def phase_int8(pipe, card: str) -> dict:
    """w8a8 int8 on the card: (a) at three v1 ops (a ds1 3x3 conv, a ds2
    1x1 proj_in, a ds1 to_q) in bf16, the card's int8 operands and int32
    accumulators equal the CPU's bit for bit, per-row and static, and each
    op is within rel L2 0.02 of the fp op; (b) a 512^2 dynamic int8 edit,
    (c) calibrate_int8 at 512^2 and the static edit, each within mean abs
    0.05 of the fp edit and not equal to it, every eligible op of the
    INT8_STEPS + 1 UNet calls through the int8 product; (d) fp, dynamic
    and static edit p50 of 3 warm edits; (e) a single-bucket int8 server
    twice, one seed. Every edit runs INT8_STEPS PLMS steps."""
    import torch
    import torch.nn.functional as F

    from pbe_tpu_torch.ops import quant
    from pbe_tpu_torch.pipelines.inference import EditPipeline
    from pbe_tpu_torch.serving import EditServer

    unet = pipe.model.model.diffusion_model
    gen = torch.Generator(device="cuda").manual_seed(41)
    ops = (("ds1 conv3x3 in_layers", unet.input_blocks[1][0].in_layers[2], (2, 320, 64, 64)),
           ("ds2 proj_in 1x1", unet.input_blocks[4][1].proj_in, (2, 640, 32, 32)),
           ("ds1 to_q", unet.input_blocks[1][1].transformer_blocks[0].attn1.to_q,
            (2, 4096, 320)))
    for name, layer, shape in ops:
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        w = layer.weight
        dense = w.dim() == 2
        wq_in = w.to(x.dtype)
        conv_args = () if dense else (tuple(layer.stride), tuple(layer.padding))
        acc_fn = quant.int8_linear_acc if dense else (
            lambda a, b: quant.int8_conv_acc(a, b, *conv_args))
        dims = (x.dim() - 1,) if dense else (1, 2, 3)
        with quant.calibration() as col:
            fp = (F.linear(x, wq_in) if dense else F.conv2d(x, wq_in, None, *conv_args))
            (quant.linear_int8(x, w) if dense else quant.conv2d_int8(x, w, None, *conv_args))
        scales = quant.scales_from_records([col.records])
        for mode in ("per_row", "static"):
            operands = []
            for dev_x, dev_w in ((x, wq_in), (x.cpu(), wq_in.cpu())):
                if mode == "per_row":
                    qx, qw = quant.quantize_rows(dev_x, dims)[0], quant.quantize_per_channel(dev_w)[0]
                else:
                    s_act, s_w = scales[0]
                    qx = quant.quantize_static(dev_x, s_act)
                    qw = quant.quantize_static_weight(dev_w, torch.tensor(s_w, device=dev_w.device))
                operands.append((qx, qw, acc_fn(qx, qw)))
            (cqx, cqw, cacc), (hqx, hqw, hacc) = operands
            # differing operand values (activations, weights), 0 and 0 when equal
            ndiff = ((cqx.cpu() != hqx).sum().item(), (cqw.cpu() != hqw).sum().item())
            same_ops = ndiff == (0, 0)
            same_acc = torch.equal(cacc.cpu(), hacc)
            knobs = {"static": scales} if mode == "static" else {}
            with quant.quantized("int8", **knobs):
                out = (quant.linear_int8(x, w) if dense
                       else quant.conv2d_int8(x, w, None, *conv_args))
            rel = ((out.float() - fp.float()).norm() / fp.float().norm()).item()
            log(f"[int8] (a) {name} {tuple(shape)} -> {tuple(cacc.shape)} {mode}: int8 "
                f"operands card == CPU {same_ops} {ndiff}, int32 accumulators card == CPU "
                f"{same_acc} "
                f"(max|acc| {cacc.abs().max().item()}); rel L2 to the fp op {rel:.4e} (tol 0.02)")
            if not (same_ops and same_acc and rel <= 0.02):
                raise AssertionError(f"int8 {name} {mode} disagrees")
        del x, fp, out, operands
        torch.cuda.empty_cache()

    # count the int8 products: each edit must run every eligible op of its
    # INT8_STEPS + 1 UNet calls through them (no op the gates admit may stay fp)
    calls = {"n": 0}
    real_mm = quant._int_mm

    def counting_mm(a, b):
        calls["n"] += 1
        return real_mm(a, b)

    image, mask, ref = edit_inputs(512, pipe.ref_size, seed=2)
    dyn = EditPipeline(pipe.model, quantize="int8")
    t0 = time.perf_counter()
    scales = dyn.calibrate_int8(image, mask, ref)
    calib_s = time.perf_counter() - t0
    static = EditPipeline(pipe.model, quantize="int8", quant_scales=scales)
    log(f"[int8] (c) calibrate_int8 at 512^2 (8 CFG UNet calls): {len(scales)} static op "
        f"scales in {calib_s:.3f} s")
    ekw = dict(steps=INT8_STEPS, scale=5.0, seed=3)
    unet_calls = INT8_STEPS + 1  # PLMS: two UNet calls at its first step
    fp_img = pipe.edit_batch(image, mask, ref, **ekw)
    summary = {"n_scales": len(scales)}
    for name, p in (("dynamic", dyn), ("static", static)):
        quant._int_mm = counting_mm
        calls["n"] = 0
        try:
            got = p.edit_batch(image, mask, ref, **ekw)
        finally:
            quant._int_mm = real_mm
        diff = np.abs(got - fp_img)
        log(f"[int8] ({'b' if name == 'dynamic' else 'c'}) {name} int8 512^2 PLMS "
            f"{INT8_STEPS} edit: int8 products {calls['n']} (expected {unet_calls} x "
            f"{len(scales)}); mean|int8 - fp| {diff.mean():.5f} (tol 0.05, > 0), max "
            f"{diff.max():.4f}")
        if calls["n"] != unet_calls * len(scales) or not 0 < diff.mean() < 0.05:
            raise AssertionError(f"the {name} int8 edit is off")
        summary[f"{name}_mean_abs_vs_fp"] = float(diff.mean())

    # (d) p50 of 3 warm edits each, in turns
    times = {"fp": [], "dynamic": [], "static": []}
    for i in range(3):
        for name, p in (("fp", pipe), ("dynamic", dyn), ("static", static)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.edit_batch(image, mask, ref, steps=INT8_STEPS, scale=5.0, seed=10 + i)
            times[name].append(time.perf_counter() - t0)
    p50 = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[int8] (d) 512^2 PLMS {INT8_STEPS} edit p50 of 3 warm edits: fp {p50['fp']:.4f} s, dynamic "
        f"int8 {p50['dynamic']:.4f} s, static int8 {p50['static']:.4f} s "
        f"({json.dumps({k: [round(t, 4) for t in v] for k, v in times.items()})}) ({card})")
    summary[f"plms{INT8_STEPS}_edit_p50_s"] = p50

    # (e) a single-bucket int8 server, one seed twice
    with EditServer(static, buckets=(1,), steps=INT8_STEPS, output_uint8=True) as srv:
        a = srv.edit(image[0], mask[0], ref[0], seed=9)
        b = srv.edit(image[0], mask[0], ref[0], seed=9)
    log(f"[int8] (e) single-bucket static int8 server, seed 9 twice: bitwise equal "
        f"{np.array_equal(a, b)}")
    if not np.array_equal(a, b):
        raise AssertionError("the int8 server is not reproducible")
    return summary


@clocked
def phase_reference_samplers() -> None:
    """configs/tiny.yaml 16^2 edits with DDIM (eta 0.5, 10 steps) and the
    full 1000-step DDPM chain: bf16 with the flash kernel on the card
    against fp32 with plain attention on the CPU, the same seeded weights
    (zero-init heads at 0.02) and the same injected x_T and per-step
    noise. The CPU edits run in a second process (reference_edits_cpu)
    while the card's run here."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from pbe_tpu_torch.pipelines.loading import load_pipeline, randomize_zero_params

    gpu, _ = load_pipeline("configs/tiny.yaml", device="cuda", verbose=False)
    randomize_zero_params(gpu.model, seed=0, scale=0.02)
    image, mask, ref = edit_inputs(16, gpu.ref_size, seed=15)
    n = 16 // gpu.model.latent_downsample
    g = np.random.default_rng(16)
    x_T = g.standard_normal((1, n, n, 4)).astype(np.float32)
    # tolerances on the [0,1] image, set from these edits in bf16 and fp32
    # on the CPU (plain attention): DDIM max 0.0128, mean 0.0020 (phase 6's
    # tolerance holds them); DDPM max 0.1165, mean 0.0220, as it rounds a
    # latent of |x| up to ~70 to bf16 at each of its 1000 steps. A noise
    # row off by one step moves the DDIM mean by 0.048 but the DDPM mean by
    # only 0.014, under bf16's drift: the CPU tests hold the DDPM chain to
    # JAX at 1e-5
    runs = []
    for sampler, steps, eta, tol in (("ddim", 10, 0.5, (0.15, 0.02)),
                                     ("ddpm", None, 0.0, (0.35, 0.05))):
        rows = steps if sampler == "ddim" else gpu.model.schedule.num_timesteps
        noise = g.standard_normal((rows, 1, n, n, 4)).astype(np.float32)
        runs.append((sampler, rows, tol, dict(steps=steps, scale=5.0, sampler=sampler, eta=eta,
                                              x_T=x_T, det_first_stage=True, noise=noise)))
    with tempfile.TemporaryDirectory() as root:
        state = os.path.join(root, "tiny.pt")
        torch.save({k: v.cpu() for k, v in gpu.model.state_dict().items()}, state)
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
            cpu = pool.submit(reference_edits_cpu, state, (image, mask, ref),
                              [kw for *_, kw in runs])
            got = []
            for sampler, _, _, kw in runs:
                t0 = time.perf_counter()
                got.append((gpu.edit_batch(image, mask, ref, **kw), time.perf_counter() - t0))
            want = cpu.result(timeout=900)
    for (sampler, rows, tol, kw), (img, t_gpu), ref_img in zip(runs, got, want):
        eta = kw["eta"]
        diff = np.abs(img - ref_img)
        log(f"[reference] tiny 16^2 {sampler} ({rows} steps{', eta 0.5' if eta else ''}), "
            f"card bf16 ({t_gpu:.1f} s) vs CPU fp32: max|diff| {diff.max():.4f} (tol "
            f"{tol[0]}), mean {diff.mean():.5f} (tol {tol[1]})")
        if not (np.isfinite(img).all() and diff.max() <= tol[0] and diff.mean() <= tol[1]):
            raise AssertionError(f"card {sampler} edit disagrees with the CPU fp32 reference")


def reference_edits_cpu(state: str, inputs: tuple, runs: list[dict]) -> list:
    """phase_reference_samplers' CPU side, in its own process: configs/tiny.yaml
    at fp32 with plain attention on the card model's weights (the state
    dict saved at ``state``), each of ``runs`` an edit_batch of ``inputs``."""
    import torch

    from pbe_tpu_torch.pipelines.loading import load_pipeline

    cpu, _ = load_pipeline("configs/tiny.yaml", device="cpu", dtype=torch.float32,
                           attn_impl="plain", verbose=False)
    cpu.model.load_state_dict(torch.load(state))
    return [cpu.edit_batch(*inputs, **kw) for kw in runs]


def build_v1_for_training():
    """configs/v1.yaml at full width on the card, bf16, flash attention and
    remat (use_checkpoint), random weights with the zero-init heads
    randomized so that every layer gets a gradient. At scale 0.02 the eps
    of random inputs has rms 0.57 (0.29 at 0.01, 2.6 at 0.1; measured on
    the card), so the eps-MSE against a unit-variance target starts near
    1 + 0.57^2."""
    import torch

    from pbe_tpu_torch.models.pbe import build_from_yaml
    from pbe_tpu_torch.pipelines.loading import init_parameters, randomize_zero_params

    t0 = time.perf_counter()
    model, _ = build_from_yaml("configs/v1.yaml", dtype=torch.bfloat16, attn_impl="flash",
                               device="cuda")
    init_parameters(model, seed=0)
    randomize_zero_params(model, seed=0, scale=0.02)
    torch.cuda.synchronize()
    log(f"[train] v1 built for training (remat {model.model.diffusion_model.remat}) in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


@clocked
def phase_unet_grad(model) -> None:
    """One v1 UNet eps-MSE at batch 4 (64^2 latent, bf16) backpropagated
    through the flash autograd function and through plain attention; the
    gradients over the UNet's parameters compared as one vector."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(11)
    x9 = torch.randn((4, 64, 64, 9), generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((4, 1, 768), generator=gen, device="cuda").to(torch.bfloat16)
    noise = torch.randn((4, 64, 64, 4), generator=gen, device="cuda")
    t = torch.tensor([10, 300, 600, 990], device="cuda")
    params = list(model.model.diffusion_model.parameters())

    def grad(impl):
        set_attn_impl(model, impl)
        loss = (model.apply_model(x9, t, ctx).float() - noise).square().mean()
        # attn2's norm2 gets none: one context token makes attn2 ignore it
        g = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        return loss.item(), torch.cat([x.float().flatten() for x in g])

    loss_f, g_flash = grad("flash")
    loss_p, g_plain = grad("plain")
    set_attn_impl(model, "flash")
    rel = ((g_flash - g_plain).norm() / g_plain.norm()).item()
    finite = bool(torch.isfinite(g_flash).all())
    # bf16 through 16 transformer and 25 res blocks, forward and backward:
    # P and dS are rounded to bf16 at other points than in the plain
    # einsum path (2^-8), which the residual streams carry; a wrong
    # backward kernel gives O(1)
    log(f"[grad] v1 UNet loss batch 4 bf16: loss flash {loss_f:.5f} plain {loss_p:.5f}; "
        f"global gradient over {len(params)} tensors ({g_plain.numel()} values) flash vs "
        f"plain rel L2 {rel:.3e} (tol 5e-2), |g| {g_plain.norm().item():.4e}")
    if not (finite and rel <= 5e-2):
        raise AssertionError("the v1 UNet gradient through the flash kernels disagrees "
                             "with plain attention")
    del g_flash, g_plain
    torch.cuda.empty_cache()


def train_batches(n: int, size: int, ref_size: int, batch: int, seed: int) -> list[dict]:
    """Seeded numpy batches as scripts/bench_train.py makes them: image
    U[-1,1], a square hole in the mask, ref N(0,1)."""
    g = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        image = g.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
        mask = np.ones((batch, size, size, 1), np.float32)
        mask[:, size // 4:3 * size // 4, size // 4:3 * size // 4] = 0.0
        ref = g.standard_normal((batch, ref_size, ref_size, 3)).astype(np.float32)
        out.append({"image": image, "inpaint_image": image * mask, "mask": mask, "ref": ref})
    return out


@clocked
def phase_train(model, card: str, rows: list[dict]) -> dict:
    """The slice: Trainer.fit on v1 at full width, batch 4, 512^2: 4 warm
    steps, then 12 steps with every kernel's launch count set to 0 just
    before and read just after, timed by CUDA events recorded as the
    trainer pulls each batch (no host sync inside the run: the one metric
    log falls on the last step)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.training.trainer import Trainer

    warm, steps = 4, 12
    batches = train_batches(warm + steps, 512, 224, 4, seed=12)
    with tempfile.TemporaryDirectory() as logdir:
        trainer = Trainer(model, logdir=logdir, seed=0)
        frozen = [p for p in model.parameters() if not p.requires_grad]
        checksum = lambda: torch.stack([torch.stack([p.double().sum(), p.double().square().sum()])
                                        for p in frozen]).cpu()
        before = checksum()
        t0 = time.perf_counter()
        trainer.fit(batches[:warm], max_steps=warm, log_every=warm, ckpt_every=10**9)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0

        events = []

        def timed(bs):
            for b in bs:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
                yield b

        kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_fwd_resident,
                   fa.flash_fwd_pipelined)
        for k in kernels:
            k.launches = 0
            k.launches_by_shape.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.fit(timed(batches[warm:]), max_steps=warm + steps,
                    log_every=warm + steps, ckpt_every=10**9)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {k.symbol: (k.launches, dict(k.launches_by_shape)) for k in kernels}
        peak = torch.cuda.max_memory_allocated()
        with open(trainer.logger.path) as f:
            last = json.loads(f.readlines()[-1])
        after = checksum()

        # step i's time: from batch i+1's pull to batch i+2's (one batch ahead)
        step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(1, len(events) - 1)]
        p50 = float(np.median(step_ms))
        log(f"[train] v1 batch 4 512^2 Trainer.fit: {warm} warm steps {warm_s:.2f} s; "
            f"{steps} steps {wall_s:.3f} s wall; step ms {['%.2f' % t for t in step_ms]}: "
            f"p50 {p50:.3f} ms, {4e3 / p50:.4f} images/s; peak memory "
            f"{peak / 2**30:.3f} GiB ({card})")
        log(f"[train] last step: loss {last['train/loss']:.5f} grad_norm "
            f"{last['train/grad_norm']:.5f} loss_vlb {last['train/loss_vlb']:.6f} (step "
            f"{last['step']})")
        log(f"[train] launches in {steps} steps: {json.dumps({k: v[0] for k, v in counts.items()})}; "
            f"by shape {counts}")
        if not (np.isfinite(last["train/loss"]) and np.isfinite(last["train/grad_norm"])
                and 0.5 <= last["train/loss"] <= 2.0):
            raise AssertionError(f"training loss {last['train/loss']} or grad_norm "
                                 f"{last['train/grad_norm']} out of range")
        if not torch.equal(before, after):
            raise AssertionError("a frozen parameter changed during training")
        state = trainer.optimizer.state
        trainable = list(trainer.params.values())
        if not (len(state) == len(trainable) and all("exp_avg" in state[p] for p in trainable)
                and not any(p in state for p in frozen)):
            raise AssertionError("AdamW state is not exactly the trainable parameters'")
        log(f"[train] frozen parameters unchanged ({len(frozen)} tensors); AdamW state for "
            f"all {len(trainable)} trainable tensors and no frozen one")
        per_step = {"pbe_flash_fwd_bf16": FWD_PER_STEP, "pbe_flash_bwd_dq_bf16": BWD_PER_STEP,
                    "pbe_flash_bwd_dkv_bf16": BWD_PER_STEP, "pbe_flash_resident_bf16": 0,
                    "pbe_flash_pipelined_bf16": 0}
        for sym, want in per_step.items():
            if counts[sym][0] != want * steps:
                raise AssertionError(f"{sym}: {counts[sym][0]} launches in {steps} steps, "
                                     f"expected {want} per step")
        sym_of = {"flash_bwd_dq": "pbe_flash_bwd_dq_bf16",
                  "flash_bwd_dkv": "pbe_flash_bwd_dkv_bf16",
                  "flash_fwd_lse": "pbe_flash_fwd_bf16", "flash_fwd": "pbe_flash_fwd_bf16"}
        shape_of = {**{n: sh for n, sh, _ in TRAIN_SHAPES}, "vae_mid": VAE_TRAIN_SHAPE}
        for row in rows:
            kname, sname = row["name"].split("/")
            shape = shape_of[sname.removesuffix("_train")]
            n = counts[sym_of[kname]][1].get(shape, 0)
            want = row.pop("expected_launches_per_step")
            if n != want * steps:
                raise AssertionError(f"{row['name']}: {n} launches in {steps} steps, "
                                     f"expected {want} per step")
            row["launches"] = n // steps  # per training step
            row["launches_in_run"], row["run_steps"] = n, steps

        # where one step's device time goes: one more step under the
        # profiler, against the unprofiled p50
        dbatch = trainer._put_batch(batches[-1])
        trainer.train_step(dbatch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.train_step(dbatch)
            torch.cuda.synchronize()
        kern, busy, groups = device_time(prof)
        log(f"[train-profile] one step: device busy {busy:.3f} ms, idle share "
            f"{1 - busy / p50:.3f} of the p50 step")
        log(f"[train-profile] by group (ms/step): "
            f"{json.dumps({k: round(v, 4) for k, v in sorted(groups.items())})}")
        for e in kern[:15]:
            log(f"[train-profile]   {DEV_MS(e):9.4f} ms/step  x{e.count:4d}  {e.key[:110]}")
        trainer.logger.close()
    return {"step_ms": step_ms, "p50_ms": p50, "images_per_s": 4e3 / p50,
            "peak_gib": peak / 2**30, "loss": last["train/loss"],
            "launches_per_step": {sym: n // steps for sym, (n, _) in counts.items()},
            "grad_norm": last["train/grad_norm"], "device_busy_ms": busy,
            "idle_share": 1 - busy / p50, "groups_ms": groups}


# phase 15, the training CLI: launches of the validation at step 8 with
# batch 4 — validate() runs the UNet forward once (no LSE) and the two VAE
# encodes; the grids' 10-step DDIM runs the UNet at CFG batch 8 ten times,
# one VAE encode and one decode at batch 4
CLI_TRAIN_STEPS, CLI_SAMPLE_STEPS = 8, 10
VAL_LAUNCHES = {"validate": {"K1": BWD_PER_STEP, "K2": 2},
                "sampling": {"K1": CLI_SAMPLE_STEPS * BWD_PER_STEP, "K2": 2}}


def fwd_by_kernel(before: dict, after: dict) -> dict:
    """flash_fwd launches between two launches_by_shape snapshots, split
    into K1 (d <= 160) and K2 (the d=512 wide kernel)."""
    out = {"K1": 0, "K2": 0}
    for shape, n in after.items():
        out["K2" if shape[3] == 512 else "K1"] += n - before.get(shape, 0)
    return out


CLI_TRAIN_ARGS = ("--base", "configs/v1.yaml", "{tmp}/data.yaml", "--scale_lr", "--bf16_moments",
                  "--val_every", "8", "--log_every", "1", "--sample_images", "--fid_every", "8",
                  "--fid_batches", "1", "--sample_steps", str(CLI_SAMPLE_STEPS),
                  "--logdir", "{tmp}/run")


@clocked
def phase_train_cli(card: str, phase9: dict, cli_args=CLI_TRAIN_ARGS,
                    workers: int = 8) -> dict:
    """The ninth slice: pbe_tpu_torch.scripts.train.main in-process on v1 at
    full width (batch 4, 512², bf16, remat, bf16 Adam moments, --scale_lr)
    over a synthetic OpenImages tree written by the port's writer, with
    validation-time grids and the FID trio at step 8; then --resume to step
    9. The Trainer's methods are wrapped here (and restored after) to count
    launches per step, time the steps (CUDA events at each step's start, no
    host sync added inside the training steps), the loader's host wait and
    the validation's parts, and to check the weights and the optimizer.
    ``cli_args`` ("{tmp}" is the run's directory) and ``workers`` (the
    data module's loader threads) are the CLI's; other values than the
    defaults are for measurements (pbe_tpu_torch.scripts.diag_train_cli),
    whose checks may then fail."""
    import tempfile

    import torch

    from pbe_tpu_torch.data import native
    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.scripts import train as train_cli
    from pbe_tpu_torch.scripts.make_synthetic_openimages import make_tree
    from pbe_tpu_torch.training import trainer as trainer_mod

    Trainer = trainer_mod.Trainer
    saved = {n: getattr(Trainer, n) for n in ("__init__", "fit", "train_step", "validate",
                                              "log_images", "sample_and_score", "restore")}
    saved_bezier = native.bezier_eval
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_fwd_resident,
               fa.flash_fwd_pipelined)
    rec = {"trainers": [], "starts": [], "per_step": [], "wait_s": [], "val": {},
           "bezier": [], "peaks": []}

    def snap():
        return ({k.symbol: k.launches for k in kernels}, dict(fa.flash_fwd.launches_by_shape))

    def init(self, *a, **kw):
        saved["__init__"](self, *a, **kw)
        rec["trainers"].append(self)
        if len(rec["trainers"]) == 1:  # the first run: its starting weights on the host
            host = lambda p: p.detach().to("cpu", copy=True)
            rec["frozen0"] = [host(p) for p in self.model.parameters() if not p.requires_grad]
            rec["train0"] = {k: host(p) for k, p in self.params.items()}

    def fit(self, train_loader, *a, **kw):
        class Timed:  # the host's wait for each train batch
            def __iter__(_):
                it = iter(train_loader)
                while True:
                    t = time.perf_counter()
                    try:
                        b = next(it)
                    except StopIteration:
                        return
                    rec["wait_s"].append(time.perf_counter() - t)
                    yield b
        return saved["fit"](self, Timed(), *a, **kw)

    def train_step(self, batch):
        if not rec["starts"]:
            torch.cuda.reset_peak_memory_stats()
        rec["starts"].append(torch.cuda.Event(enable_timing=True))
        rec["starts"][-1].record()
        (c0, s0) = snap()
        out = saved["train_step"](self, batch)
        (c1, s1) = snap()
        rec["per_step"].append(({k: c1[k] - c0[k] for k in c1}, fwd_by_kernel(s0, s1)))
        rec["peaks"].append(torch.cuda.max_memory_allocated())
        return out

    def timed_part(name):
        def run(self, *a, **kw):
            torch.cuda.synchronize()
            (c0, s0), t = snap(), time.perf_counter()
            out = saved[name](self, *a, **kw)
            torch.cuda.synchronize()
            ms, (c1, s1) = (time.perf_counter() - t) * 1e3, snap()
            got = rec["val"].setdefault(name, {"ms": 0.0, "K1": 0, "K2": 0, "calls": 0})
            got["ms"] += ms
            got["calls"] += 1
            for k, n in fwd_by_kernel(s0, s1).items():
                got[k] += n
            return out
        return run

    def restore(self, *a, **kw):
        ok = saved["restore"](self, *a, **kw)
        first = rec["trainers"][0]
        # the restored state is the first run's final state, bit for bit
        same = ok and self.step == first.step and all(
            torch.equal(p, first.params[k]) for k, p in self.params.items())
        st0, st1 = first.optimizer.state, self.optimizer.state
        same = same and all(
            torch.equal(st1[p]["exp_avg"], st0[first.params[k]]["exp_avg"])
            and torch.equal(st1[p]["exp_avg_sq"], st0[first.params[k]]["exp_avg_sq"])
            and st1[p]["exp_avg"].dtype == torch.bfloat16 for k, p in self.params.items())
        rec["restored_equal"] = bool(same)
        return ok

    def bezier(*a, **kw):
        rec["bezier"].append(1)  # list.append: atomic across the loader threads
        return saved_bezier(*a, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_tree(f"{tmp}/oi", n_train=16, n_val=4, size=512, seed=0)
        split = lambda state: {"target": "ldm.data.open-images.OpenImageDataset",
                               "params": {"state": state, "dataset_dir": f"{tmp}/oi",
                                          "arbitrary_mask_percent": 0.5, "image_size": 512}}
        with open(f"{tmp}/data.yaml", "w") as f:
            json.dump({"data": {"target": "main.DataModuleFromConfig",
                                "params": {"batch_size": 4, "num_workers": workers,
                                           "train": split("train"),
                                           "validation": split("validation")}}}, f)
        log(f"[train-cli] synthetic OpenImages tree (16 + 4 at 512^2, seed 0) written in "
            f"{time.perf_counter() - t0:.2f} s; native mask helpers "
            f"{'built' if native.available() else 'NOT built'}")
        args = [a.format(tmp=tmp) for a in cli_args]
        Trainer.__init__, Trainer.fit, Trainer.train_step, Trainer.restore = (
            init, fit, train_step, restore)
        for name in ("validate", "log_images", "sample_and_score"):
            setattr(Trainer, name, timed_part(name))
        native.bezier_eval = bezier
        try:
            for k in kernels:
                k.launches = 0
                k.launches_by_shape.clear()
            t0 = time.perf_counter()
            trainer = train_cli.main(args + ["--max_steps", str(CLI_TRAIN_STEPS)])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = {k.symbol: k.launches for k in kernels}
            frozen1 = [p for p in trainer.model.parameters() if not p.requires_grad]
            frozen_same = len(frozen1) == len(rec["frozen0"]) and all(
                torch.equal(p.cpu(), q) for p, q in zip(frozen1, rec["frozen0"]))
            moved = [k for k, p in trainer.params.items()
                     if not torch.equal(p.detach().cpu(), rec["train0"][k])]
            n_trainable = len(trainer.params)
            state = trainer.optimizer.state
            dtypes = {(str(state[p]["exp_avg"].dtype), str(state[p]["exp_avg_sq"].dtype))
                      for p in trainer.params.values()}
            del rec["frozen0"], rec["train0"], frozen1, state
            t0 = time.perf_counter()
            resumed = train_cli.main(args + ["--max_steps", str(CLI_TRAIN_STEPS + 1),
                                             "--resume"])
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
        finally:
            for n, fn in saved.items():
                setattr(Trainer, n, fn)
            native.bezier_eval = saved_bezier
        with open(f"{tmp}/run/metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
        grids = sorted(os.listdir(f"{tmp}/run/samples/step_{CLI_TRAIN_STEPS:08d}"))
        grids = [g for g in grids if g.startswith("grid_")]
        ckpts = sorted(os.listdir(f"{tmp}/run/checkpoints"))
        resumed_step = resumed.step
        del trainer, resumed
        rec["trainers"].clear()
        torch.cuda.empty_cache()

    train_rows = [r for r in rows if "train/loss" in r]
    losses = [r["train/loss"] for r in train_rows]
    fid = [r for r in rows if "val/fid_global" in r]
    # step i's time: from its start to step i+1's start (the log line of
    # every step syncs the host; the loader's wait and the batch's copy
    # fall between); the last step's interval would hold the validation
    ev = rec["starts"][:CLI_TRAIN_STEPS]
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)]
    p50 = float(np.median(step_ms))
    wait_ms = [w * 1e3 for w in rec["wait_s"][:CLI_TRAIN_STEPS]]  # the first run's
    val = rec["val"]
    trio_ms = val["sample_and_score"]["ms"] - val["log_images"]["ms"]
    # since the first step's start (reset there), read after step 8: the
    # resumed run holds a second model beside the first
    peak_gib, p9_gib = rec["peaks"][CLI_TRAIN_STEPS - 1] / 2**30, phase9["peak_gib"]
    log(f"[train-cli] v1 batch 4 512^2 bf16 remat, bf16 Adam moments, --scale_lr: "
        f"train.main to step {CLI_TRAIN_STEPS} in {run_s:.2f} s, --resume to step "
        f"{resumed_step} in {resume_s:.2f} s ({card})")
    log(f"[train-cli] step ms {['%.2f' % t for t in step_ms]}: p50 {p50:.3f} ms, "
        f"{4e3 / p50:.4f} images/s; phase 9's Trainer.fit p50 {phase9['p50_ms']:.3f} ms "
        f"(ratio {p50 / phase9['p50_ms']:.4f}) ({card})")
    log(f"[train-cli] host wait on the DataLoader per train batch (ms) "
        f"{['%.2f' % w for w in wait_ms]}: mean {np.mean(wait_ms):.3f}, max "
        f"{max(wait_ms):.3f} ({card})")
    log(f"[train-cli] peak memory over the {CLI_TRAIN_STEPS} steps {peak_gib:.3f} GiB "
        f"(bf16 first moments) against phase 9's {p9_gib:.3f} GiB (fp32 moments): "
        f"{p9_gib - peak_gib:+.3f} GiB saved ({card})")
    log(f"[train-cli] validation at step {CLI_TRAIN_STEPS}: validate() "
        f"{val['validate']['ms']:.1f} ms, {CLI_SAMPLE_STEPS}-step DDIM grids at CFG batch 8 "
        f"{val['log_images']['ms']:.1f} ms, FID trio {trio_ms:.1f} ms; launches "
        f"validate() K1 {val['validate']['K1']} K2 {val['validate']['K2']}, sampling K1 "
        f"{val['log_images']['K1']} K2 {val['log_images']['K2']} ({card})")
    log(f"[train-cli] losses {['%.5f' % x for x in losses]}; val {json.dumps(fid[-1] if fid else {})}")
    log(f"[train-cli] launches per step {rec['per_step'][0]} (phase 9: "
        f"{phase9['launches_per_step']}); in the first run {counts}")
    log(f"[train-cli] trainable tensors moved: {len(moved)} of {n_trainable}; frozen bitwise "
        f"unchanged: {frozen_same}; optimizer (exp_avg, exp_avg_sq) dtypes {sorted(dtypes)}; "
        f"native Bezier calls {len(rec['bezier'])}; grids {len(grids)}; checkpoints {ckpts}; "
        f"restored bit for bit: {rec.get('restored_equal')}")

    fails = []
    if not (len(losses) == CLI_TRAIN_STEPS + 1 and all(np.isfinite(losses))):
        fails.append(f"losses {losses} (want {CLI_TRAIN_STEPS + 1} finite)")
    if not (train_rows and train_rows[0]["step"] == 1 and abs(losses[0] - 1.0) <= 0.1):
        fails.append(f"step 1 loss {losses[:1]} not within 1 +- 0.1")
    if [r["step"] for r in train_rows] != list(range(1, CLI_TRAIN_STEPS + 2)):
        fails.append(f"train rows at steps {[r['step'] for r in train_rows]}")
    if not (moved and "model.diffusion_model.out.2.weight" in moved):
        fails.append(f"trainable parameters did not move ({len(moved)} moved)")
    if not frozen_same:
        fails.append("a frozen parameter changed")
    if dtypes != {("torch.bfloat16", "torch.float32")}:
        fails.append(f"optimizer moment dtypes {dtypes}")
    want_step = dict(phase9["launches_per_step"])
    for i, (c, kk) in enumerate(rec["per_step"]):
        if c != want_step or kk != {"K1": FWD_PER_STEP - 2, "K2": 2}:
            fails.append(f"step {i + 1} launches {c} {kk}, phase 9 {want_step}")
            break
    for part, key in (("validate", "validate"), ("log_images", "sampling")):
        got = {k: val[part][k] for k in ("K1", "K2")}
        if got != VAL_LAUNCHES[key]:
            fails.append(f"{key} launches {got}, expected {VAL_LAUNCHES[key]}")
    if not (fid and all(np.isfinite(fid[-1][k])
                        for k in ("val/fid_global", "val/fid_local", "val/fid_ref"))):
        fails.append(f"FID row {fid}")
    if len(grids) != 4:
        fails.append(f"{len(grids)} grids, expected 4")
    if not (native.available() and rec["bezier"]):
        fails.append(f"native mask path not used ({len(rec['bezier'])} calls)")
    if not (rec.get("restored_equal") and resumed_step == CLI_TRAIN_STEPS + 1):
        fails.append(f"--resume: restored equal {rec.get('restored_equal')}, step {resumed_step}")
    if fails:
        raise AssertionError("phase 15 (train CLI): " + "; ".join(fails))
    return {"step_ms": step_ms, "p50_ms": p50, "images_per_s": 4e3 / p50,
            "phase9_p50_ms": phase9["p50_ms"], "loader_wait_ms": wait_ms,
            "peak_gib": peak_gib, "phase9_peak_gib": p9_gib,
            "validate_ms": val["validate"]["ms"], "sampling_ms": val["log_images"]["ms"],
            "fid_trio_ms": trio_ms, "val_launches": {"validate": VAL_LAUNCHES["validate"],
                                                     "sampling": VAL_LAUNCHES["sampling"]},
            "losses": losses, "fid": {k: fid[-1][k] for k in fid[-1] if k.startswith("val/")},
            "trainable_moved": len(moved), "run_s": run_s, "resume_s": resume_s}


@clocked
def phase_train_reference() -> None:
    """configs/tiny.yaml: 3 train steps on the card (bf16, the kernels)
    against the same steps on the CPU (fp32, the kernels' plain versions):
    the same seeded weights, batches and draws, the posterior mode, a
    constant LR multiplier."""
    import torch

    from pbe_tpu_torch.models.pbe import build_from_yaml
    from pbe_tpu_torch.pipelines.loading import init_parameters, randomize_zero_params
    from pbe_tpu_torch.training.partition import split_parameters
    from pbe_tpu_torch.training.train_step import make_optimizer, train_step

    gpu, _ = build_from_yaml("configs/tiny.yaml", dtype=torch.bfloat16, attn_impl="flash",
                             device="cuda")
    init_parameters(gpu, seed=0)
    randomize_zero_params(gpu, seed=0)
    cpu, _ = build_from_yaml("configs/tiny.yaml", dtype=torch.float32, attn_impl="flash",
                             device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    batches = train_batches(3, 64, 224, 2, seed=13)
    g = np.random.default_rng(14)
    n = 64 // gpu.latent_downsample
    draws = [(g.integers(0, 1000, (2,)), g.standard_normal((2, n, n, 4)).astype(np.float32))
             for _ in batches]
    losses = {}
    for name, model, dev in (("card", gpu, "cuda"), ("cpu", cpu, "cpu")):
        params, _ = split_parameters(model)
        opt, sched = make_optimizer(params, base_lr=1e-4, scheduler=lambda n: 1.0)
        out = []
        for batch, (t, noise) in zip(batches, draws):
            tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            m = train_step(model, params, opt, sched, tb, torch.from_numpy(t).to(dev),
                           torch.from_numpy(noise).to(dev), torch.tensor(0.5, device=dev))
            out.append((m["loss"].item(), m["grad_norm"].item()))
        losses[name] = out
    # bf16 activations round each element by up to 2^-8 (3.9e-3); the
    # loss and the gradient norm are sums over thousands of elements, in
    # which that rounding mostly cancels, so they stay well inside 1e-2 of
    # the fp32 values; a wrong kernel, LR step or optimizer state moves
    # them further by the second or third step
    rel = [(abs(a[0] - b[0]) / b[0], abs(a[1] - b[1]) / b[1])
           for a, b in zip(losses["card"], losses["cpu"])]
    log(f"[train-reference] tiny 3 steps, card bf16 vs CPU fp32: (loss, grad_norm) card "
        f"{losses['card']} cpu {losses['cpu']}; rel diff {rel} (tol 1e-2 each)")
    if not all(np.isfinite(x).all() and max(r) <= 1e-2 for x, r in zip(losses["card"], rel)):
        raise AssertionError("card training disagrees with the CPU fp32 reference")


# phase 16, evaluation: 64 + 64 synthetic 512^2 images, a 16-pair COCOEE
# directory and its results, and a k=20 GMM over 2048-d pool3 features with
# full covariances (the reference's COCO GMM's shape)
EVAL_IMAGES, EVAL_PAIRS, GMM_K, GMM_D = 64, 16, 20, 2048


def gmm_stand_in(feats: np.ndarray, seed: int):
    """A fitted-GMM stand-in built from numpy (no sklearn): k=20 components
    with full covariances, sklearn's attribute names. The means are 20 of
    the given feature rows, each precision Cholesky factor upper triangular
    (sklearn's form): s on the diagonal and seeded noise of 1e-3 s above it,
    with s such that a feature at its mean scores 250, inside QS's (0, 300)
    window, and the rest of the rows fall wherever their distance puts
    them."""
    from types import SimpleNamespace

    g = np.random.default_rng(seed)
    k, d = GMM_K, feats.shape[1]
    log_s = (250.0 + 0.5 * d * np.log(2 * np.pi) + np.log(k)) / d
    s = np.exp(log_s)
    chol = np.triu(g.standard_normal((k, d, d)) * 1e-3 * s, 1)
    chol[:, np.arange(d), np.arange(d)] = s
    return SimpleNamespace(covariance_type="full", weights_=np.full(k, 1.0 / k),
                           means_=feats[g.choice(len(feats), k, replace=False)].astype(np.float64),
                           precisions_cholesky_=chol)


@clocked
def phase_eval(card: str) -> dict:
    """Phase 16, the evaluation CLIs in-process on the card: eval_fid
    (Inception, then --clip-features), eval_clip_score over a synthetic
    COCOEE directory and its results, eval_gmm on a pickled stand-in GMM,
    create_square_gt_for_fid; each number finite and in range, the card's
    GMM log-likelihoods against a float64 CPU run of the same code, and the
    card's bf16 CLIP embeddings against the CPU's fp32 ones."""
    import pickle
    import tempfile

    import torch
    from PIL import Image

    from pbe_tpu_torch.data.transforms import save_image
    from pbe_tpu_torch.evaltools.clip_score import VIT_B32, CLIPImageEmbedder
    from pbe_tpu_torch.evaltools.fid import list_images, make_inception_feature_fn
    from pbe_tpu_torch.evaltools.gmm_score import gmm_log_likelihood
    from pbe_tpu_torch.scripts import (create_square_gt_for_fid, eval_clip_score, eval_fid,
                                       eval_gmm)

    g = np.random.default_rng(16)
    times, out = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return r

    with tempfile.TemporaryDirectory() as tmp:
        dirs = []
        for name in ("a", "b"):
            os.makedirs(os.path.join(tmp, name))
            for i in range(EVAL_IMAGES):
                save_image(smooth_image(g, 512) / 255.0, os.path.join(tmp, name, f"{i:03d}.png"))
            dirs.append(os.path.join(tmp, name))
        out["fid_inception"] = timed("eval_fid", lambda: eval_fid.main(dirs))
        out["fid_clip"] = timed("eval_fid --clip-features",
                                lambda: eval_fid.main(dirs + ["--clip-features"]))

        bench, results = os.path.join(tmp, "bench"), os.path.join(tmp, "results")
        os.makedirs(results)
        for i in write_test_bench(bench, EVAL_PAIRS, 512, seed=17):
            save_image(smooth_image(g, 512) / 255.0, os.path.join(results, f"{i}.png"))
        out["clip_score"] = timed("eval_clip_score", lambda: eval_clip_score.main(
            ["--result_dir", results, "--test_bench_dir", bench]))

        images = np.stack([np.asarray(Image.open(f).convert("RGB").resize(
            (299, 299), Image.BILINEAR), np.float32) / 255.0 for f in list_images(dirs[0])])
        feats = make_inception_feature_fn()(images)
        gmm = gmm_stand_in(feats, seed=18)
        with open(os.path.join(tmp, "gmm.pkl"), "wb") as f:
            pickle.dump(gmm, f)
        out["qs"] = timed("eval_gmm", lambda: eval_gmm.main(
            [dirs[0], "--gmm", os.path.join(tmp, "gmm.pkl")]))
        ll_card = gmm_log_likelihood(feats, gmm, device="cuda")
        ll_cpu = gmm_log_likelihood(feats, gmm, device="cpu")
        ll_rel = float(np.abs(ll_card - ll_cpu).max() / np.abs(ll_cpu).max())
        in_window = int(((ll_cpu > 0) & (ll_cpu < 300)).sum())

        n_sq = timed("create_square_gt_for_fid", lambda: create_square_gt_for_fid.main(
            [os.path.join(bench, "GT_3500"), os.path.join(tmp, "square")]))

    # the bf16 tower on the card against the fp32 tower on the CPU, one
    # set of weights
    cpu = CLIPImageEmbedder(VIT_B32, device="cpu")
    gpu = CLIPImageEmbedder(VIT_B32, state_dict=cpu.tower.state_dict(), device="cuda")
    crops = np.stack([np.asarray(Image.fromarray(smooth_image(g, 512)).resize(
        (224, 224), Image.BICUBIC), np.float32) / 255.0 for _ in range(8)])
    cos = (gpu(crops) * cpu(crops)).sum(-1)
    out.update({"gmm_loglik_rel_err": ll_rel, "gmm_rows_in_window": in_window,
                "clip_min_cosine": float(cos.min()), "seconds": times})
    log(f"[eval] FID (Inception, random weights) {out['fid_inception']:.4f}, FID (CLIP) "
        f"{out['fid_clip']:.6f}, region CLIP score {out['clip_score']:.4f} over {EVAL_PAIRS} "
        f"pairs, QS {out['qs']:.4f} ({in_window} of {EVAL_IMAGES} log-likelihoods inside "
        f"(0, 300)); {n_sq} square GT images")
    log(f"[eval] GMM k={GMM_K} d={GMM_D} full: card vs CPU float64 log-likelihood max rel "
        f"{ll_rel:.3e} (tol 1e-9); CLIP B/32 bf16 card vs fp32 CPU min cosine "
        f"{out['clip_min_cosine']:.5f} (tol 1 - 2e-2)")
    log(f"[eval] seconds by CLI ({card}): " + ", ".join(f"{k} {v:.2f}" for k, v in times.items()))
    ok = (all(np.isfinite(out[k]) for k in ("fid_inception", "fid_clip", "clip_score", "qs"))
          and 0.0 <= out["qs"] <= 100.0 and -100.0 <= out["clip_score"] <= 100.0
          and n_sq == EVAL_PAIRS and ll_rel <= 1e-9 and out["clip_min_cosine"] >= 1 - 2e-2
          and feats.shape == (EVAL_IMAGES, GMM_D))
    if not ok:
        raise AssertionError(f"evaluation CLIs: a number out of range or off its reference {out}")
    return out


def build_first_stage(config: str, dtype, device: str, seed: int = 0):
    """The first stage of a config YAML, built in dtype on device with
    attn_impl="flash", fp32 weights drawn as flax initializes them; returns
    (vae, its ddconfig.resolution)."""
    from pbe_tpu_torch.config import load_config
    from pbe_tpu_torch.models.layers import init_like_flax
    from pbe_tpu_torch.models.vae import AutoencoderKLConfig

    p = load_config(config)["model"]["params"]["first_stage_config"]["params"]
    vae = AutoencoderKLConfig(ddconfig=p["ddconfig"], embed_dim=p["embed_dim"]).build(
        dtype, attn_impl="flash").to(device)
    return init_like_flax(vae, seed), p["ddconfig"]["resolution"]


def vae_trainer(vae, device: str, dtype, disc_ch: int, disc_layers: int, lr: float = 4.5e-6):
    """State and step of make_vae_train_step with everything on: the
    PatchDiscriminator from step 0 (disc_start=0), so the GAN term and the
    adaptive weight run, and the VGG16 perceptual term. The discriminator
    and VGG16 get seeded weights drawn on the host, so that every device
    gets the same ones."""
    from pbe_tpu_torch.models.layers import init_like_flax
    from pbe_tpu_torch.training.perceptual import VGG16Features, make_vgg_perceptual_fn
    from pbe_tpu_torch.training.vae_train import (PatchDiscriminator, create_vae_train_state,
                                                  make_vae_train_step)

    disc = init_like_flax(PatchDiscriminator(ch=disc_ch, n_layers=disc_layers, dtype=dtype),
                          seed=1).to(device)
    state = create_vae_train_state(vae, disc, lr=lr)
    vgg = init_like_flax(VGG16Features(dtype=dtype), seed=2).to(device)
    step = make_vae_train_step(vae, disc, disc_start=0,
                               perceptual_fn=make_vgg_perceptual_fn(vgg))
    return state, step


@clocked
def phase_vae_train(card: str, rows: list[dict]) -> dict:
    """Phase 18, the slice: make_vae_train_step on v1's first stage at full
    width (configs/v1.yaml ddconfig: ch 128, ch_mult 1-2-4-4, 2 res blocks)
    at its 256^2 resolution, batch 4, bf16 compute and fp32 weights, flash
    attention, PatchDiscriminator(64, 3), the VGG16 term: 2 warm steps, then
    8 with every kernel's launch count set to 0 just before and read just
    after; losses, the adaptive weight and moved weights checked; step p50,
    images/s, peak memory and one step's device time by group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pbe_tpu_torch.ops import flash_attention as fa

    vae, size = build_first_stage("configs/v1.yaml", torch.bfloat16, "cuda")
    state, step = vae_trainer(vae, "cuda", torch.bfloat16, 64, 3)
    g = torch.Generator(device="cuda").manual_seed(18)
    warm, steps, batch = 2, 8, 4
    images = [torch.rand((batch, size, size, 3), generator=g, device="cuda") * 2 - 1
              for _ in range(warm + steps)]
    checksum = lambda m: torch.stack([p.double().square().sum() for p in m.parameters()])
    before = checksum(state.vae), checksum(state.disc)
    for x in images[:warm]:
        step(state, x, generator=g)
    torch.cuda.synchronize()

    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_fwd_resident,
               fa.flash_fwd_pipelined)
    for k in kernels:
        k.launches = 0
        k.launches_by_shape.clear()
    fa.flash_fwd.lse_launches = 0
    torch.cuda.reset_peak_memory_stats()
    events, metrics = [torch.cuda.Event(enable_timing=True)], []
    events[0].record()
    for x in images[warm:]:
        metrics.append(step(state, x, generator=g))
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    torch.cuda.synchronize()
    counts = {k.symbol: (k.launches, dict(k.launches_by_shape)) for k in kernels}
    lse = fa.flash_fwd.lse_launches
    peak = torch.cuda.max_memory_allocated()
    metrics = [{k: v.item() for k, v in m.items()} for m in metrics]
    after = checksum(state.vae), checksum(state.disc)
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    p50 = float(np.median(step_ms))
    log(f"[vae-train] v1 first stage {size}^2 batch {batch} bf16: step ms "
        f"{['%.2f' % t for t in step_ms]}: p50 {p50:.3f} ms, {batch * 1e3 / p50:.4f} images/s; "
        f"peak memory {peak / 2**30:.3f} GiB ({card})")
    for i, m in enumerate(metrics):
        log(f"[vae-train] step {warm + i}: " + ", ".join(f"{k} {v:.6g}" for k, v in m.items()))
    log(f"[vae-train] launches in {steps} steps: {json.dumps({k: v[0] for k, v in counts.items()})}"
        f" ({lse} forward launches with the LSE); by shape {counts}")

    shape = VAE_BWD_SHAPES[0][1]
    want = {"pbe_flash_fwd_bf16": VAE_STEP_FWD, "pbe_flash_bwd_dq_bf16": VAE_STEP_BWD,
            "pbe_flash_bwd_dkv_bf16": VAE_STEP_BWD, "pbe_flash_resident_bf16": 0,
            "pbe_flash_pipelined_bf16": 0}
    for sym, per_step in want.items():
        n, by_shape = counts[sym]
        if n != per_step * steps or (n and by_shape != {shape: n}):
            raise AssertionError(f"{sym}: {n} launches {by_shape} in {steps} steps, expected "
                                 f"{per_step} a step at {shape}")
    if lse != VAE_STEP_FWD_LSE * steps:
        raise AssertionError(f"{lse} forward launches with the LSE in {steps} steps, expected "
                             f"{VAE_STEP_FWD_LSE} a step")
    if not all(np.isfinite([m[k] for k in ("g_loss", "rec", "kl", "d_loss")]).all()
               and 0.0 <= m["d_weight"] <= 0.5e4 for m in metrics):
        raise AssertionError(f"a VAE training metric is not finite or d_weight is out of range: "
                             f"{metrics}")
    moved = [int((b != a).sum()) for b, a in zip(before, after)]
    if not all(moved):
        raise AssertionError(f"weights did not move (changed tensors: vae, disc = {moved})")
    log(f"[vae-train] weights moved: {moved[0]} of {len(before[0])} VAE tensors, {moved[1]} of "
        f"{len(before[1])} discriminator tensors")
    sym_of = {"flash_bwd_dq": "pbe_flash_bwd_dq_bf16", "flash_bwd_dkv": "pbe_flash_bwd_dkv_bf16"}
    for row in rows:
        kname, sname = row["name"].split("/")
        n = (lse if kname == "flash_fwd_lse" else
             counts["pbe_flash_fwd_bf16"][0] - lse if kname == "flash_fwd" else
             counts[sym_of[kname]][0])
        if not sname.startswith(VAE_BWD_SHAPES[0][0]):
            n = 0  # a shape phase 18 does not run
        wanted = row.pop("expected_launches_per_step")
        if n != wanted * steps:
            raise AssertionError(f"{row['name']}: {n} launches in {steps} steps, expected "
                                 f"{wanted} a step")
        row["launches"] = n // steps
        row["launches_in_run"], row["run_steps"] = n, steps

    # one step's device time by group, against the unprofiled p50
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, images[-1], generator=g)
        torch.cuda.synchronize()
    kern, busy, groups = device_time(prof)
    bwd = groups.get("flash_bwd_dq", 0.0) + groups.get("flash_bwd_dkv", 0.0)
    log(f"[vae-train-profile] one step: device busy {busy:.3f} ms, idle share "
        f"{1 - busy / p50:.3f} of the p50 step; K5+K6 {bwd:.4f} ms ({bwd / busy:.4f} of busy)")
    log(f"[vae-train-profile] by group (ms/step): "
        f"{json.dumps({k: round(v, 4) for k, v in sorted(groups.items())})}")
    for e in kern[:12]:
        log(f"[vae-train-profile]   {DEV_MS(e):9.4f} ms/step  x{e.count:4d}  {e.key[:110]}")
    return {"step_ms": step_ms, "p50_ms": p50, "images_per_s": batch * 1e3 / p50,
            "peak_gib": peak / 2**30, "metrics": metrics,
            "launches_per_step": {sym: n // steps for sym, (n, _) in counts.items()},
            "lse_launches_per_step": lse // steps, "device_busy_ms": busy,
            "idle_share": 1 - busy / p50, "groups_ms": groups, "k5_k6_share": bwd / busy}


@clocked
def phase_vae_train_reference() -> None:
    """Phase 19: 3 training steps of a configs/tiny.yaml-sized first stage
    (ch 16, ch_mult 1-2, one res block) at 64^2, batch 2, on the card in
    bf16 (the kernels) against the same steps on the CPU in fp32 (their
    plain versions): one set of weights, the same images and latent draws."""
    import torch

    torch.manual_seed(0)
    gpu, size = build_first_stage("configs/tiny.yaml", torch.bfloat16, "cuda")
    cpu, _ = build_first_stage("configs/tiny.yaml", torch.float32, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    runs = {}
    for name, vae, dev, dtype in (("card", gpu, "cuda", torch.bfloat16),
                                  ("cpu", cpu, "cpu", torch.float32)):
        state, step = vae_trainer(vae, dev, dtype, 16, 2, lr=1e-4)
        g = np.random.default_rng(19)
        out = []
        for _ in range(3):
            x = torch.from_numpy(g.uniform(-1, 1, (2, size, size, 3)).astype(np.float32))
            eps = torch.from_numpy(g.standard_normal(vae.latent_shape(x.shape)).astype(np.float32))
            m = step(state, x.to(dev), noise=eps.to(dev))
            out.append({k: v.item() for k, v in m.items()})
        runs[name] = out
    # bf16 activations round each element by up to 2^-8; the losses are
    # means over thousands of elements, in which that rounding mostly
    # cancels (1e-2); d_weight is a ratio of two gradient norms over one
    # conv's weight, each a sum of bf16 products (5e-2)
    tol = {"g_loss": 1e-2, "rec": 1e-2, "kl": 1e-2, "d_loss": 1e-2, "d_weight": 5e-2}
    rel = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in tol}
           for a, b in zip(runs["card"], runs["cpu"])]
    log(f"[vae-train-reference] tiny first stage 3 steps, card bf16 vs CPU fp32: card "
        f"{runs['card']}; cpu {runs['cpu']}; rel diff {rel} (tol {tol})")
    if not all(r[k] <= tol[k] for r in rel for k in tol):
        raise AssertionError("card VAE training disagrees with the CPU fp32 reference")


KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_resident",
           "flash_fwd_pipelined")


def counted_all(fa, fn):
    """fn() with every kernel's counts set to 0 just before and read just
    after -> (fn's result, {wrapper name: (launches by dtype, launches by
    shape)}, forward launches with the LSE)."""
    for name in KERNELS:
        getattr(fa, name).reset()
    out = fn()
    counts = {name: (dict(getattr(fa, name).launches_by_dtype),
                     dict(getattr(fa, name).launches_by_shape)) for name in KERNELS}
    return out, counts, fa.flash_fwd.lse_launches


def write_edit_inputs(root: str, size: int, seed: int, box: tuple) -> tuple[str, str, str]:
    """A smooth size^2 source PNG, a mask PNG whose white box (y0, y1, x0,
    x1) is the region to edit, and a 224^2 exemplar PNG under root."""
    from PIL import Image

    g = np.random.default_rng(seed)
    paths = tuple(os.path.join(root, f) for f in ("src.png", "mask.png", "ref.png"))
    Image.fromarray(smooth_image(g, size)).save(paths[0])
    m = np.zeros((size, size), np.uint8)
    m[box[0]:box[1], box[2]:box[3]] = 255
    Image.fromarray(m).save(paths[1])
    Image.fromarray(smooth_image(g, 224)).save(paths[2])
    return paths


@clocked
def phase_precision_full(ckpt: str, card: str, rows: list[dict]) -> dict:
    """Phase 21: --precision full through the CLIs on the card at full
    width, with every kernel's counts set to 0 just before each run and
    read just after: (a) scripts.inference.main on configs/v1.yaml, a 512^2
    50-step PLMS edit at CFG 5 (818 fp32 forward launches, no bf16 one and
    no other kernel);
    (b) scripts.train.main --precision full on v1, batch 4, 512^2, 4 steps
    over a synthetic OpenImages tree: each step launches the fp32 forward,
    dQ and dK/dV kernels as often as phase 9's bf16 step launches the bf16
    ones, and no bf16 kernel; finite losses, step p50 and peak memory; (c)
    make_vae_train_step on v1's first stage in fp32, 2 steps at 256^2, batch
    4. Fills the launches of phase 20's rows."""
    import torch
    from PIL import Image

    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.scripts import inference
    from pbe_tpu_torch.scripts import train as train_cli
    from pbe_tpu_torch.scripts.make_synthetic_openimages import make_tree
    from pbe_tpu_torch.training import trainer as trainer_mod

    def only_fp32(counts, label):
        bf16 = {k: v[0]["bfloat16"] for k, v in counts.items() if v[0].get("bfloat16")}
        if bf16:
            raise AssertionError(f"{label}: bf16 kernels launched under --precision full: {bf16}")

    row_of = {r["name"]: r for r in rows}
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the edit CLI
        src, mask, ref = write_edit_inputs(tmp, 512, 31, (128, 384, 96, 352))
        out = os.path.join(tmp, "edit")
        times, counts, _ = counted_all(fa, lambda: inference.main([
            "--config", "configs/v1.yaml", "--ckpt", ckpt, "--image_path", src, "--mask_path",
            mask, "--reference_path", ref, "--plms", "--scale", "5", "--n_iter", "1",
            "--seed", "321", "--precision", "full", "--outdir", out]))
        fwd_dtype, fwd_shape = counts["flash_fwd"]
        result = np.asarray(Image.open(os.path.join(out, "results", "src_321.png")))
        log(f"[fp32] (a) inference CLI --precision full, v1 512^2 PLMS 50 scale 5: edit "
            f"{times[0]:.3f} s ({card}); forward launches {fwd_dtype} (expected float32 "
            f"{LAUNCHES_PER_EDIT}), by shape {fwd_shape}; result {result.shape} mean "
            f"{result.mean():.2f}")
        only_fp32(counts, "the fp32 edit")
        others = {k: v[0] for k, v in counts.items() if k != "flash_fwd" and v[0]}
        if others:
            raise AssertionError(f"the fp32 edit launched other kernels than the forward: "
                                 f"{others}")
        if fwd_dtype != {"float32": LAUNCHES_PER_EDIT} or result.shape != (512, 512, 3):
            raise AssertionError(f"the fp32 edit launched {fwd_dtype} or wrote {result.shape}")
        for name, shape, _, per_edit in FLASH_SHAPES:
            row = row_of[f"flash_fwd/f32_{name}"]
            row["launches"] = fwd_shape.get(shape, 0)
            if row.pop("expected_launches") != row["launches"]:
                raise AssertionError(f"{row['name']}: {row['launches']} launches, expected "
                                     f"{per_edit}")
        summary["edit_s"] = times[0]

        # (b) the training CLI
        make_tree(f"{tmp}/oi", n_train=8, n_val=4, size=512, seed=0)
        split = lambda state: {"target": "ldm.data.open-images.OpenImageDataset",
                               "params": {"state": state, "dataset_dir": f"{tmp}/oi",
                                          "arbitrary_mask_percent": 0.5, "image_size": 512}}
        with open(f"{tmp}/data.yaml", "w") as f:
            json.dump({"data": {"target": "main.DataModuleFromConfig",
                                "params": {"batch_size": 4, "num_workers": 4,
                                           "train": split("train"),
                                           "validation": split("validation")}}}, f)
        Trainer = trainer_mod.Trainer
        saved_step = Trainer.train_step
        rec = {"starts": [], "per_step": []}

        def train_step(self, batch):
            if not rec["starts"]:
                torch.cuda.reset_peak_memory_stats()
            rec["starts"].append(torch.cuda.Event(enable_timing=True))
            rec["starts"][-1].record()
            out, c, _ = counted_all(fa, lambda: saved_step(self, batch))
            rec["per_step"].append(c)
            return out

        Trainer.train_step = train_step
        steps = 4
        try:
            t0 = time.perf_counter()
            trainer = train_cli.main(["--base", "configs/v1.yaml", f"{tmp}/data.yaml",
                                      "--precision", "full", "--max_steps", str(steps),
                                      "--log_every", "1", "--val_every", "1000",
                                      "--logdir", f"{tmp}/run"])
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        finally:
            Trainer.train_step = saved_step
        peak = torch.cuda.max_memory_allocated()
        marks = rec["starts"] + [end]
        step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(len(rec["starts"]))]
        with open(trainer.logger.path) as f:
            losses = [json.loads(line)["train/loss"] for line in f if "train/loss" in line]
        p50 = float(np.median(step_ms[1:]))
        per_step = [{k: v[0] for k, v in c.items() if v[0]} for c in rec["per_step"]]
        log(f"[fp32] (b) train CLI --precision full, v1 batch 4 512^2, {steps} steps in "
            f"{run_s:.1f} s: step ms {['%.1f' % t for t in step_ms]}, p50 of steps 2-{steps} "
            f"{p50:.3f} ms; peak memory {peak / 2**30:.3f} GiB ({card}); losses {losses}; "
            f"launches a step {per_step}")
        want = {"flash_fwd": {"float32": FWD_PER_STEP}, "flash_bwd_dq": {"float32": BWD_PER_STEP},
                "flash_bwd_dkv": {"float32": BWD_PER_STEP}}
        if len(per_step) != steps or any(c != want for c in per_step):
            raise AssertionError(f"the fp32 training steps launched {per_step}, expected "
                                 f"{want} a step")
        if len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"fp32 training losses {losses}")
        by_shape = {k: v[1] for k, v in rec["per_step"][-1].items()}
        shape_of = {**{n: sh for n, sh, _ in TRAIN_SHAPES}, "vae_mid": VAE_TRAIN_SHAPE}
        for row in rows:
            kname, sname = row["name"].split("/")
            base = sname.removeprefix("f32_").removesuffix("_train")
            if "expected_launches_per_step" not in row or base not in shape_of:
                continue
            n = by_shape["flash_fwd" if kname.startswith("flash_fwd") else kname].get(
                shape_of[base], 0)
            if n != row.pop("expected_launches_per_step"):
                raise AssertionError(f"{row['name']}: {n} launches in the last fp32 step")
            row["launches"] = n  # per training step
        summary["train"] = {"step_ms": step_ms, "p50_ms": p50, "peak_gib": peak / 2**30,
                            "losses": losses}
        del trainer
        torch.cuda.empty_cache()

    # (c) first-stage training in fp32
    vae, size = build_first_stage("configs/v1.yaml", torch.float32, "cuda")
    state, step = vae_trainer(vae, "cuda", torch.float32, 64, 3)
    g = torch.Generator(device="cuda").manual_seed(21)
    vae_steps, metrics, lse = 2, [], 0
    per_step = []
    for _ in range(vae_steps):
        x = torch.rand((4, size, size, 3), generator=g, device="cuda") * 2 - 1
        m, c, n_lse = counted_all(fa, lambda: step(state, x, generator=g))
        metrics.append({k: v.item() for k, v in m.items()})
        per_step.append({k: v[0] for k, v in c.items() if v[0]})
        lse = n_lse
    log(f"[fp32] (c) make_vae_train_step on v1's first stage in fp32, {size}^2 batch 4, "
        f"{vae_steps} steps: {metrics}; launches a step {per_step} ({lse} with the LSE)")
    want = {"flash_fwd": {"float32": VAE_STEP_FWD}, "flash_bwd_dq": {"float32": VAE_STEP_BWD},
            "flash_bwd_dkv": {"float32": VAE_STEP_BWD}}
    if any(c != want for c in per_step) or lse != VAE_STEP_FWD_LSE:
        raise AssertionError(f"the fp32 first-stage steps launched {per_step} ({lse} with the "
                             f"LSE), expected {want} ({VAE_STEP_FWD_LSE})")
    if not all(np.isfinite([m[k] for k in ("g_loss", "rec", "kl", "d_loss")]).all()
               for m in metrics):
        raise AssertionError(f"an fp32 first-stage metric is not finite: {metrics}")
    name = F32_VAE_STAGE1[0]
    for kname, n in (("flash_bwd_dq", VAE_STEP_BWD), ("flash_bwd_dkv", VAE_STEP_BWD),
                     ("flash_fwd_lse", lse), ("flash_fwd", VAE_STEP_FWD - lse)):
        row = row_of[f"{kname}/f32_{name}" + ("_train" if "fwd" in kname else "")]
        if row.pop("expected_launches_per_step") != n:
            raise AssertionError(f"{row['name']}: {n} launches a step")
        row["launches"] = n
    summary["vae_train"] = metrics
    del vae, state, step
    torch.cuda.empty_cache()
    return summary


@clocked
def phase_fp32_reference() -> None:
    """Phase 22: phase 6's tiny 4-step edit and phase 10's 3 training steps
    in fp32 on the card (the fp32 kernels) against fp32 on the CPU: max
    |diff| <= 2e-3 and mean <= 2e-4 of the [0,1] edit, losses and gradient
    norms within 1e-4 relative."""
    import torch

    from pbe_tpu_torch.models.pbe import build_from_yaml
    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.pipelines.loading import (init_parameters, load_pipeline,
                                                 randomize_zero_params)
    from pbe_tpu_torch.training.partition import split_parameters
    from pbe_tpu_torch.training.train_step import make_optimizer, train_step

    gpu, _ = load_pipeline("configs/tiny.yaml", device="cuda", dtype=torch.float32,
                           verbose=False)
    randomize_zero_params(gpu.model, seed=0)
    cpu, _ = load_pipeline("configs/tiny.yaml", device="cpu", dtype=torch.float32,
                           attn_impl="plain", verbose=False)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    image, mask, ref = edit_inputs(64, gpu.ref_size, seed=5)
    n = 64 // gpu.model.latent_downsample
    x_T = np.random.default_rng(6).standard_normal((1, n, n, 4)).astype(np.float32)
    kw = dict(steps=4, scale=5.0, x_T=x_T, det_first_stage=True)
    got, counts, _ = counted_all(fa, lambda: gpu.edit_batch(image, mask, ref, **kw))
    want = cpu.edit_batch(image, mask, ref, **kw)
    diff = np.abs(got - want)
    # fp32 on both sides: the sums run in other orders (the kernels'
    # against the plain einsum attention, cuBLAS and cuDNN against the
    # CPU's), a few fp32 ulps per op through 5 UNet calls and the decode
    log(f"[fp32-reference] tiny 64^2 4-step edit, card fp32 ({counts['flash_fwd'][0]}) vs "
        f"CPU fp32: max|diff| {diff.max():.3e} (tol 2e-3), mean {diff.mean():.3e} (tol 2e-4)")
    if counts["flash_fwd"][0].get("float32", 0) == 0 or "bfloat16" in counts["flash_fwd"][0]:
        raise AssertionError(f"the fp32 card edit launched {counts['flash_fwd'][0]}")
    if not (np.isfinite(got).all() and diff.max() <= 2e-3 and diff.mean() <= 2e-4):
        raise AssertionError("the fp32 card edit disagrees with the CPU fp32 reference")
    del gpu, cpu

    card, _ = build_from_yaml("configs/tiny.yaml", dtype=torch.float32, attn_impl="flash",
                              device="cuda")
    init_parameters(card, seed=0)
    randomize_zero_params(card, seed=0)
    host, _ = build_from_yaml("configs/tiny.yaml", dtype=torch.float32, attn_impl="flash",
                              device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batches = train_batches(3, 64, 224, 2, seed=13)
    g = np.random.default_rng(14)
    n = 64 // card.latent_downsample
    draws = [(g.integers(0, 1000, (2,)), g.standard_normal((2, n, n, 4)).astype(np.float32))
             for _ in batches]
    losses = {}
    for name, model, dev in (("card", card, "cuda"), ("cpu", host, "cpu")):
        params, _ = split_parameters(model)
        opt, sched = make_optimizer(params, base_lr=1e-4, scheduler=lambda n: 1.0)
        out = []
        for batch, (t, noise) in zip(batches, draws):
            tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            m = train_step(model, params, opt, sched, tb, torch.from_numpy(t).to(dev),
                           torch.from_numpy(noise).to(dev), torch.tensor(0.5, device=dev))
            out.append((m["loss"].item(), m["grad_norm"].item()))
        losses[name] = out
    rel = [(abs(a[0] - b[0]) / b[0], abs(a[1] - b[1]) / b[1])
           for a, b in zip(losses["card"], losses["cpu"])]
    log(f"[fp32-reference] tiny 3 train steps, card fp32 vs CPU fp32: (loss, grad_norm) card "
        f"{losses['card']} cpu {losses['cpu']}; rel diff {rel} (tol 1e-4 each)")
    if not all(np.isfinite(x).all() and max(r) <= 1e-4 for x, r in zip(losses["card"], rel)):
        raise AssertionError("fp32 card training disagrees with the CPU fp32 reference")


# phase 23: the un-tiled 1024^2 edit's shapes at N = 16384 (launches in one
# PLMS 50 CFG edit: 5 self-attentions a UNet call at the 128^2 latent, 51
# calls; the VAE's mid attention at 128^2 in the encode and the decode)
LONG_SHAPES = (("unet_1024_ds1", (2, 16384, 8, 40), K1, 5 * 51),
               ("vae_1024_mid", (1, 16384, 1, 512), K2, 2))
TILE_KS, TILE_STRIDE = 64, 32  # 1024^2: a 128^2 latent, 3 x 3 crops of 64^2


def plain_by_head(fa, q, k, v, heads: int = 2):
    """flash_attention_plain over a few heads at a time: the same function,
    without the (B, H, N, N) fp32 scores of all heads at once (17 GB at
    (2, 16384, 8, 40))."""
    import torch

    return torch.cat([torch.cat([fa.flash_attention_plain(q[b:b + 1, :, h:h + heads],
                                                          k[b:b + 1, :, h:h + heads],
                                                          v[b:b + 1, :, h:h + heads])
                                 for h in range(0, q.shape[2], heads)], dim=2)
                      for b in range(q.shape[0])], dim=0)


def long_row(fa, name: str, shape, replaces: str, launches: int) -> dict:
    """The bf16 forward kernel at an N = 16384 shape against its plain
    version (taken a few heads at a time), timed beside it and SDPA."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(23)
    b, n, h, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out = fa.flash_fwd(q, k, v)
    want = plain_by_head(fa, q, k, v)
    diff = out.float() - want.float()
    err, scale = diff.abs().max().item(), want.float().abs().max().item()
    rel_l2 = (diff.norm() / want.float().norm()).item()
    ok = err <= OUT_MAX_REL * scale and rel_l2 <= OUT_L2_REL
    log(f"[long] {name} {shape}: out max|err| {err:.3e} (tol {OUT_MAX_REL * scale:.3e}), rel "
        f"L2 {rel_l2:.3e} (tol {OUT_L2_REL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash kernel disagrees with its plain version at {shape}")
    del out, want, diff
    by, ms_bound = bound(4.0, b, n, h, d, 4 * b * n * h * d * 2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    row = {"name": f"flash_fwd/{name}", "route": "cuda",
           "source": "pbe_tpu_torch/csrc/flash_fwd.cu", "replaces": replaces,
           "dtype": "bfloat16", "launches": launches, "max_abs_err": err,
           "ms": graph_ms(lambda: fa.flash_fwd(q, k, v), 5),
           "plain_ms": cuda_ms(lambda: plain_by_head(fa, q, k, v), 2, warmup=1),
           "bound_ms": ms_bound, "bound_by": "bytes" if by == "bytes" else "operations",
           "library": f"sdpa ({sdpa_backend(qt, kt, vt)})",
           "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 5)}
    log(f"[long] {name}: kernel {row['ms']:.4f} ms, plain (by heads) {row['plain_ms']:.4f} ms, "
        f"{row['library']} {row['library_ms']:.4f} ms, bound {ms_bound:.4f} ms by {by} (mma "
        f"{4.0 * b * h * n * n * d / BF16_FLOP_PER_S * 1e3:.4f}, exp2 "
        f"{b * h * n * n / EXP2_PER_S * 1e3:.4f})")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


@clocked
def phase_tiling(ckpt: str, card: str, rows: list[dict]) -> dict:
    """Phase 23: scripts.inference.main at --H 1024 --W 1024 (bf16, PLMS 50,
    CFG 5) un-tiled, then with --tile_ks 64 --tile_stride 32 (9 crops: UNet
    calls at batch 18 on 64^2 latents), each run's launches counted from 0;
    K1 at (2, 16384, 8, 40) and K2 at (1, 16384, 1, 512) against the plain
    version and timed; a tiny tiled edit in bf16 on the card against fp32
    on the CPU with phase 6's bounds."""
    import torch
    from PIL import Image

    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.ops.tiling import TilingSpec
    from pbe_tpu_torch.pipelines.loading import load_pipeline, randomize_zero_params
    from pbe_tpu_torch.scripts import inference

    summary, runs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        src, mask, ref = write_edit_inputs(tmp, 1024, 33, (256, 768, 192, 704))
        common = ["--config", "configs/v1.yaml", "--ckpt", ckpt, "--image_path", src,
                  "--mask_path", mask, "--reference_path", ref, "--H", "1024", "--W", "1024",
                  "--plms", "--scale", "5", "--n_iter", "1", "--seed", "321"]
        for label, extra in (("untiled", []), ("tiled", ["--tile_ks", str(TILE_KS),
                                                         "--tile_stride", str(TILE_STRIDE)])):
            out = os.path.join(tmp, label)
            times, counts, _ = counted_all(fa, lambda: inference.main(
                common + extra + ["--outdir", out]))
            result = np.asarray(Image.open(os.path.join(out, "results", "src_321.png")))
            by_dtype, by_shape = counts["flash_fwd"]
            log(f"[tiling] 1024^2 CLI edit {label} (bf16, PLMS 50, CFG 5): {times[0]:.3f} s "
                f"({card}); forward launches {by_dtype}, by shape {by_shape}; result "
                f"{result.shape}")
            if result.shape != (1024, 1024, 3) or sum(by_dtype.values()) != LAUNCHES_PER_EDIT:
                raise AssertionError(f"the {label} 1024^2 edit wrote {result.shape} with "
                                     f"{by_dtype} launches")
            if any(v[0] for k, v in counts.items() if k != "flash_fwd"):
                raise AssertionError(f"the {label} edit launched {counts}")
            runs[label] = by_shape
            summary[f"{label}_edit_s"] = times[0]
        crops = ((1024 // 8 - TILE_KS) // TILE_STRIDE + 1) ** 2
        tiled_ds1 = (2 * crops, 4096, 8, 40)
        if runs["tiled"].get(tiled_ds1) != 5 * 51:
            raise AssertionError(f"the tiled edit ran the UNet's ds1 attention "
                                 f"{runs['tiled'].get(tiled_ds1)} times at {tiled_ds1}")
    for name, shape, replaces, per_edit in LONG_SHAPES:
        if runs["untiled"].get(shape) != per_edit:
            raise AssertionError(f"{name}: {runs['untiled'].get(shape)} launches in the "
                                 f"un-tiled 1024^2 edit, expected {per_edit}")
        rows.append(long_row(fa, name, shape, replaces, per_edit))

    # the tiny tiled edit: bf16 on the card against fp32 on the CPU
    spec = TilingSpec(ks=(8, 8), stride=(4, 4))
    gpu, _ = load_pipeline("configs/tiny.yaml", device="cuda", verbose=False, tiling=spec)
    randomize_zero_params(gpu.model, seed=0)
    cpu, _ = load_pipeline("configs/tiny.yaml", device="cpu", dtype=torch.float32,
                           attn_impl="plain", verbose=False, tiling=spec)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    image, mask, ref = edit_inputs(64, gpu.ref_size, seed=5)
    n = 64 // gpu.model.latent_downsample
    x_T = np.random.default_rng(6).standard_normal((1, n, n, 4)).astype(np.float32)
    kw = dict(steps=4, scale=5.0, x_T=x_T, det_first_stage=True)
    got, counts, _ = counted_all(fa, lambda: gpu.edit_batch(image, mask, ref, **kw))
    want = cpu.edit_batch(image, mask, ref, **kw)
    diff = np.abs(got - want)
    log(f"[tiling] tiny 64^2 4-step edit tiled (8, 4) card bf16 vs CPU fp32: launches by "
        f"shape {counts['flash_fwd'][1]}; max|diff| {diff.max():.4f} (tol 0.15), mean "
        f"{diff.mean():.5f} (tol 0.02)")
    if not (np.isfinite(got).all() and diff.max() <= 0.15 and diff.mean() <= 0.02):
        raise AssertionError("the tiled card edit disagrees with the CPU fp32 reference")
    return summary


@clocked
def phase_safety(ckpt: str, card: str) -> dict:
    """Phase 24: the safety checker at full geometry (ViT-L/14: 24 layers,
    width 1024, 224^2, projection 768, 17 + 3 concepts) from a seeded
    diffusers-layout state_dict written with torch.save, through
    scripts.inference.main --safety_ckpt --n_samples 2. A first pass
    (nothing can flag) records the two frames the checker sees; the concept
    0 embedding becomes the direction between their embeddings and its
    threshold their midpoint, so the second pass (--enforce_safety) flags
    sample 0 alone, each score >= 0.005 from a rounding edge. Checked: the
    flagged result is black, the other equal to the first pass's, and the
    card's fp32 cosines and scores within 1e-4 of the CPU's."""
    import torch
    from PIL import Image

    from pbe_tpu_torch.models import safety
    from pbe_tpu_torch.models.layers import init_like_flax
    from pbe_tpu_torch.scripts import inference

    module = init_like_flax(safety.SafetyChecker().to("cuda"), seed=24)
    g = torch.Generator(device="cuda").manual_seed(24)
    with torch.no_grad():
        module.concept_embeds.normal_(generator=g)
        module.special_care_embeds.normal_(generator=g)
        module.concept_embeds_weights.fill_(2.0)  # cos <= 1 < 2: nothing flags
        module.special_care_embeds_weights.fill_(2.0)
    sd = {k: v.cpu() for k, v in module.state_dict().items()}
    sd["vision_model.vision_model.embeddings.position_ids"] = torch.arange(257)[None]
    del module
    seen = []
    saved_check = safety.LoadedSafetyChecker.check

    def check(self, images01, enforce=False):
        seen.append(np.array(images01, copy=True))
        out, flags = saved_check(self, images01, enforce)
        seen.append(flags)
        return out, flags

    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        src, mask, ref = write_edit_inputs(tmp, 512, 34, (64, 448, 64, 448))
        path = os.path.join(tmp, "safety.bin")
        t0 = time.perf_counter()
        torch.save(sd, path)
        log(f"[safety] ViT-L/14 checker state_dict ({len(sd)} tensors, "
            f"{sum(v.numel() for v in sd.values()) / 1e6:.1f}M values) written in "
            f"{time.perf_counter() - t0:.1f} s")
        common = ["--config", "configs/v1.yaml", "--ckpt", ckpt, "--image_path", src,
                  "--mask_path", mask, "--reference_path", ref, "--ddim_steps", "20",
                  "--scale", "5", "--n_iter", "1", "--n_samples", "2", "--seed", "321",
                  "--no_watermark", "--safety_ckpt", path]
        safety.LoadedSafetyChecker.check = check
        try:
            times = inference.main(common + ["--outdir", os.path.join(tmp, "first")])
            frames, flags0 = seen[0], seen[1]
            checker = safety.load_safety_checker(path, device="cuda")
            with torch.no_grad():
                pix = safety.preprocess_for_safety(torch.from_numpy(frames).cuda())
                e = checker.module.embed(pix).double()
            e = e / e.norm(dim=-1, keepdim=True)
            direction = (e[0] - e[1]) / (e[0] - e[1]).norm()
            cos = (e @ direction).tolist()
            sd["concept_embeds"][0] = direction.float().cpu()
            sd["concept_embeds_weights"][0] = float(sum(cos) / 2)
            margin = (cos[0] - cos[1]) / 2 - 0.0005
            log(f"[safety] first pass ({times[0]:.2f} s, flags {flags0}): the frames' "
                f"embeddings at cosine {float(e[0] @ e[1]):.6f}; concept 0 := their "
                f"difference, cosines {cos}, threshold their midpoint: scores +-"
                f"{(cos[0] - cos[1]) / 2:.4f}, {margin:.4f} from a rounding edge")
            if flags0 != [False, False] or margin < 0.005:
                raise AssertionError(f"first pass flags {flags0}, margin {margin}")
            torch.save(sd, path)
            inference.main(common + ["--enforce_safety", "--outdir", os.path.join(tmp, "second")])
            flags = seen[3]
        finally:
            safety.LoadedSafetyChecker.check = saved_check
        png = lambda run, k: np.asarray(Image.open(os.path.join(tmp, run, "results",
                                                                f"src_321{k}.png")))
        black, kept, first = png("second", ""), png("second", "_1"), png("first", "_1")
        log(f"[safety] second pass --enforce_safety: flags {flags}; sample 0 max {black.max()}, "
            f"sample 1 equal to the first pass's: {np.array_equal(kept, first)}")
        if flags != [True, False] or black.any() or not np.array_equal(kept, first):
            raise AssertionError("the checker did not black out exactly sample 0")

        # the card's fp32 scores against the CPU's on the same frames
        card_checker = safety.load_safety_checker(path, device="cuda")
        cpu_checker = safety.load_safety_checker(path, device="cpu")
        got, want = card_checker.scores(frames), cpu_checker.scores(frames)
        with torch.no_grad():
            cosines = [safety.cosine_distance(
                c.module.embed(safety.preprocess_for_safety(torch.from_numpy(frames).to(
                    c.device))), c.module.concept_embeds).cpu().numpy()
                for c in (card_checker, cpu_checker)]
        cos_err = float(np.abs(cosines[0] - cosines[1]).max())
        score_err = max(float(np.abs(a - b).max()) for a, b in zip(got[1:], want[1:]))
        log(f"[safety] card vs CPU fp32 on the two frames: flags {got[0].tolist()} / "
            f"{want[0].tolist()}, max|cosine diff| {cos_err:.3e} (tol 1e-4), max|score diff| "
            f"{score_err:.3e} (tol 1e-4)")
        if (got[0].tolist() != want[0].tolist() or cos_err > 1e-4 or score_err > 1e-4):
            raise AssertionError("the card's safety scores disagree with the CPU's")
        summary.update(flags=flags, cos_err=cos_err, score_err=score_err, edit_s=times[0])
    return summary


def unet_call_flops(config: str = "configs/v1.yaml") -> dict:
    """FLOPs of one CFG UNet call at the 512^2 edit's shapes (batch 2, a
    64^2 latent, bf16, flash) by torch.utils.flop_counter, the flash ops by
    their registered formulas: traced on fake tensors, so nothing runs."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from pbe_tpu_torch.models.pbe import build_from_yaml
    from pbe_tpu_torch.utils.profiling import compiled_flops

    with FakeTensorMode(), torch.no_grad():
        model, _ = build_from_yaml(config, dtype=torch.bfloat16, attn_impl="flash",
                                   device="cuda", remat=False)
        x9 = torch.zeros((2, 64, 64, 9), dtype=torch.bfloat16, device="cuda")
        t = torch.zeros((2,), device="cuda")
        ctx = torch.zeros((2, 1, 768), dtype=torch.bfloat16, device="cuda")
        total, by_op = compiled_flops(model.apply_model, x9, t, ctx, by_op=True)
    flash = sum(n for op, n in by_op.items() if op.startswith("pbe."))
    return {"unet_call_tflop": total / 1e12, "flash_tflop": flash / 1e12,
            "flash_share": flash / total}


def int8_model(root: str) -> list[str]:
    """Phase 25's int8 model in ``root``: v1's YAML with the UNet cut to
    FROZEN_INT8_RES_BLOCKS res blocks a level (its widths unchanged), its
    zero-init tensors seeded as phase 4 seeds v1's, as a checkpoint ->
    verify_frozen_program's --config and --ckpt arguments."""
    import torch

    from pbe_tpu_torch.pipelines.loading import load_pipeline, randomize_zero_params

    with open("configs/v1.yaml") as f:
        v1_yaml = f.read()
    unet_blocks = "        num_res_blocks: 2\n        channel_mult: [ 1, 2, 4, 4 ]\n"
    if v1_yaml.count(unet_blocks) != 1:
        raise AssertionError("configs/v1.yaml's UNet geometry moved")
    config = os.path.join(root, "v1_int8.yaml")
    with open(config, "w") as f:
        f.write(v1_yaml.replace(unet_blocks, unet_blocks.replace(
            "2", str(FROZEN_INT8_RES_BLOCKS), 1)))
    pipe, _ = load_pipeline(config, device="cuda", verbose=False)
    zero = [n for n, p in pipe.model.named_parameters() if not torch.any(p)]
    randomize_zero_params(pipe.model, seed=0)
    ckpt = seeded_checkpoint(pipe, zero, root)
    del pipe
    torch.cuda.empty_cache()
    return ["--config", config, "--ckpt", ckpt]


@clocked
def phase_frozen(ckpt: str, card: str, precisions=("bf16", "int8")) -> dict:
    """Phase 25: the frozen edit on the card, by
    scripts.verify_frozen_program: bf16 at v1 on phase 4's weights (one
    params.npz written first), int8 at v1's widths with
    FROZEN_INT8_RES_BLOCKS res blocks a level on its own seeded weights,
    each at FROZEN_STEPS, the two runs started together (each exports on
    one host core for minutes; int8, the longer, first), the FLOPs of a UNet
    call traced meanwhile; or one of them alone."""
    import subprocess

    import torch

    from pbe_tpu_torch.export_runtime import save_params_npz
    from pbe_tpu_torch.pipelines.loading import load_pipeline

    want = {shape: n for _, shape, _, n in FLASH_SHAPES}
    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        procs = {}
        try:
            # the int8 run starts first: its export, save and load take longest
            for name in sorted(precisions, key=lambda name: name != "int8"):
                if name == "bf16":
                    params = os.path.join(root, "params.npz")
                    pipe, _ = load_pipeline("configs/v1.yaml", ckpt, device="cuda",
                                            verbose=False)
                    with torch.no_grad():
                        save_params_npz(params, pipe.model.state_dict())
                    del pipe
                    torch.cuda.empty_cache()
                    out["params_write_s"] = time.perf_counter() - t0
                    log(f"[frozen] v1 params.npz ({os.path.getsize(params) / 1e6:.1f} MB) "
                        f"written in {out['params_write_s']:.1f} s")
                    model = ["--config", "configs/v1.yaml", "--ckpt", ckpt, "--params", params]
                else:
                    model = [*int8_model(root), "--quantize", "int8"]
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "pbe_tpu_torch.scripts.verify_frozen_program",
                     "--outdir", os.path.join(root, name), *model, "--H", "512", "--W", "512",
                     "--steps", str(FROZEN_STEPS[name]), "--scale", "5",
                     "--det_first_stage", "1", "--device", "cuda"],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                    start_new_session=True)
            # traced on the host while the runs export
            out["unet_call"] = flops = unet_call_flops()
            log(f"[frozen] one CFG UNet call: {flops['unet_call_tflop']:.4f} TFLOP "
                f"(torch.utils.flop_counter), flash ops {flops['flash_tflop']:.4f} TFLOP, "
                f"share {flops['flash_share']:.4f}")
            for name in precisions:
                proc = procs[name]
                stdout, stderr = proc.communicate(timeout=900)
                if proc.returncode != 0:
                    raise AssertionError(f"verify_frozen_program ({name}) exited "
                                         f"{proc.returncode}: {stderr[-3000:]}")
                row = json.loads(stdout.strip().splitlines()[-1])
                row["phase_s"] = time.perf_counter() - t0
                by_shape = {tuple(int(x) for x in k.strip("()").split(",")): n
                            for k, n in row["flash_fwd_launches_by_shape"].items()}
                launches = row["flash_launches"]
                side = "the bf16 and int8 runs side by side" if len(procs) > 1 else "alone"
                log(f"[frozen] {name} 512^2 PLMS {FROZEN_STEPS[name]} CFG 5 ({side}): "
                    f"{json.dumps(row)} ({card})")
                expected = f" (expected {LAUNCHES_PER_EDIT})" if name == "bf16" else ""
                log(f"[frozen] {name}: step body run {row['step_runs']} times; flash launches "
                    f"{launches['flash_fwd']}{expected}, by shape {by_shape}")
                if not row["pass"]:
                    raise AssertionError(f"the frozen {name} edit is {row['max_abs_diff']} "
                                         f"from the live edit")
                if row["step_runs"] != FROZEN_STEPS[name] - 3:
                    raise AssertionError(f"the step body ran {row['step_runs']} times")
                if name == "bf16" and (by_shape != want or launches["flash_fwd"]
                                       != LAUNCHES_PER_EDIT):
                    raise AssertionError(f"the frozen edit launched {by_shape}, not {want}")
                if any(n for k, n in launches.items() if k != "flash_fwd"):
                    raise AssertionError(f"the frozen edit launched {launches}")
                out[name] = row
        finally:
            for proc in procs.values():  # and the frozen side each one started
                if proc.poll() is None:
                    os.killpg(proc.pid, 9)
                    proc.wait()
    return out


# phase 26, the test split (scripts/test.py): v1 at 512^2, bf16, on phase 4's
# weights, TEST_SPLIT_BATCHES batches of 4 from a synthetic tree. A batch
# validates (one UNet forward at batch 4, two VAE encodes) and samples 50
# DDIM steps at CFG 5 (50 UNet calls at batch 8, one VAE encode and one
# decode at batch 4). (name, (B, N, H, D), TPU kernel, launches a batch)
TEST_SPLIT_BATCHES = 2
TEST_SPLIT_SHAPES = (
    ("test_val_ds1", (4, 4096, 8, 40), K1, 5),
    ("test_val_ds2", (4, 1024, 8, 80), K1, 5),
    ("test_val_ds4", (4, 256, 8, 160), K1, 5),
    ("test_val_ds8", (4, 64, 8, 160), K1, 1),
    ("test_cfg_ds1", (8, 4096, 8, 40), K1, 5 * 50),
    ("test_cfg_ds2", (8, 1024, 8, 80), K1, 5 * 50),
    ("test_cfg_ds4", (8, 256, 8, 160), K1, 5 * 50),
    ("test_cfg_ds8", (8, 64, 8, 160), K1, 1 * 50),
    ("test_vae_b4", (4, 4096, 1, 512), K2, 2 + 2),
)
# the JAX CLI's test_results.json keys (scripts/test.py: the eval step's
# metrics and the FID trio)
TEST_SPLIT_KEYS = {f"test/{k}" for k in ("loss_simple", "loss_vlb", "loss", "fid_global",
                                          "fid_local", "fid_ref")}
# phase 27, the overfit demo: v1, 512^2, bf16, remat, constant LR; the
# demo's default batch of 8, OVERFIT_STEPS steps, then its 50-step DDIM
OVERFIT_BATCH = 8
OVERFIT_STEPS = 30
# phase 28: the legacy models at fp32 (TF32 off), card against CPU on the
# same weights and inputs: max|diff| <= LEGACY_TOL x the output's RMS (the
# sums run in other orders on either side: a few fp32 ulps an op through
# tens of layers)
LEGACY_TOL = 1e-4
LATENT_RESCALER_SHAPE = (2, 4096, 1, 512)  # its mid attention on a 64^2 latent
# phases 28-29: the DDPM CIFAR-10 UNet at Ho et al. 2020's widths; its six
# attention blocks are single-head at d = 256, five at 16^2 (two down,
# three up), one in the middle at 4^2: at phase 29's batch of 128, the
# flash launches a forward by shape
DDPM_CIFAR = dict(ch=128, out_ch=3, num_res_blocks=2, resolution=32, in_channels=3,
                  ch_mult=(1, 2, 2, 2), attn_resolutions=(16,))
DDPM_BATCH = 128
DDPM_ATTN = {(DDPM_BATCH, 256, 1, 256): 5, (DDPM_BATCH, 16, 1, 256): 1}
# phase 29, csrc/flash_anyd.cu's kernels against their plain versions at
# these head dims (every one outside the tuned table, so kernel_entry names
# csrc/flash_anyd.cu there), N = 77 (one 64-row tile and 13 rows); peaked
# and rising-max scores at N = 200 (four key tiles) at ANYD_STRESS_DIMS,
# packed q/k/v views at ANYD_PACKED_DIMS; the edges of the launch plans
# (csrc/flash_anyd.cu launch_fwd_bf16, launch_dq_bf16, launch_dkv_bf16,
# launch_dkv_f32) among them: 128 | 129 (the output slices, the bf16 dK/dV
# warp split, the fp32 dK/dV's 128 columns a warp | 256), 256 | 257 (one
# column split | two), 304 | 305 (the fp32 dK/dV's 64 key rows a block |
# 32), 336 | 337 (dQ's 8 warps | 4), 656 | 657 (the fp32 dK/dV's 32 key
# rows | 16), 672 | 673 (the bf16 dK/dV's 64 key rows | 32, dQ's 4 warps |
# 2), 784 | 785 (the forward's 8 warps | 4)
ANYD_DIMS = (1, 12, 28, 56, 64, 96, 100, 128, 129, 192, 200, 256, 257, 304, 305, 336, 337, 384,
             640, 656, 657, 672, 673, 784, 785, 1024)
ANYD_STRESS_DIMS = (28, 100, 256, 1024)
ANYD_PACKED_DIMS = (28, 100)
# ... and timed at the DDPM shapes and at d = 64 and 128 beside them:
# (name, (B, N, H, D))
ANYD_TIMED = (("ddpm_n256_d64", (DDPM_BATCH, 256, 1, 64)),
              ("ddpm_n256_d128", (DDPM_BATCH, 256, 1, 128)),
              ("ddpm_n256", (DDPM_BATCH, 256, 1, 256)),
              ("ddpm_mid_n16", (DDPM_BATCH, 16, 1, 256)))
# the times of the kernels of csrc/flash_anyd.cu redesigned for the
# tensor cores (the bf16 dQ on mma.sync, the fp32 dK/dV on 3xTF32; then the
# fp32 forward, S on FMA and P V on 3xTF32) at ANYD_TIMED before it, by
# (kernel row, shape name, dtype): phase 29's final run of the source before
# each redesign (H100 80GB HBM3, 700 W; SIMT fp32 FMA then), the fp32 dK/dV
# at d = 64 and 128 from `sweep_flash_tiles --anyd --baseline` on that
# source (the mean of its two timings, the same card), the fp32 forward at
# d = 64 and 128 from phase 30's flash_fwd_anyd times; for log lines only
ANYD_BEFORE_MS = {
    ("flash_bwd_dq", "ddpm_n256", "bfloat16"): 0.8264,
    ("flash_bwd_dq", "ddpm_mid_n16", "bfloat16"): 0.0427,
    ("flash_bwd_dq", "ddpm_n256_d64", "bfloat16"): 0.2857,
    ("flash_bwd_dq", "ddpm_n256_d128", "bfloat16"): 0.4713,
    ("flash_bwd_dkv", "ddpm_n256", "float32"): 0.9231,
    ("flash_bwd_dkv", "ddpm_mid_n16", "float32"): 0.0499,
    ("flash_bwd_dkv", "ddpm_n256_d64", "float32"): 0.4208,
    ("flash_bwd_dkv", "ddpm_n256_d128", "float32"): 0.5811,
    ("flash_fwd", "ddpm_n256", "float32"): 0.4607,
    ("flash_fwd", "ddpm_mid_n16", "float32"): 0.0334,
    ("flash_fwd", "ddpm_n256_d64", "float32"): 0.1974,
    ("flash_fwd", "ddpm_n256_d128", "float32"): 0.2764,
}
# the tensor-core kernels at the DDPM shape on operands at these element
# offsets from 16-byte aligned buffers: pieces of 8, 4, 2 and 1 elements
# at bf16 (load_log2), of 4, 2 and 1 at fp32, checked and timed
ANYD_OFFSETS = {"bfloat16": (0, 4, 2, 1), "float32": (0, 2, 1)}
# phase 29's bf16 UNet against the fp32 one on the card: the output within
# phase 6's bounds on the output's RMS in place of the image's [0, 1]
# range (max 0.15, mean 0.02), the loss within phase 19's 1e-2 relative
# and the parameter-gradient norm within its 5e-2 (its bound on d_weight,
# a ratio of gradient norms); fp32 flash against fp32 plain and card
# against CPU: the output within LEGACY_TOL of its RMS, the loss and the
# gradient norm within phase 22's 1e-4 relative
DDPM_BF16_TOL = {"max": 0.15, "mean": 0.02, "loss": 1e-2, "grad_norm": 5e-2}
DDPM_F32_REL = 1e-4
DDPM_STEPS = 5  # timed forward-plus-backward steps at each dtype
# phase 30, csrc/flash_variants_anyd.cu's K3 and K4 against the plain
# version at phase 29's forward tolerances: at every key block of
# KEY_BLOCKS, N = 77, at ANYD_DIMS, at two head dims that are not
# multiples of 8 but pad to a tuned one (36 -> 48, 150 -> 160: the tuned
# kernels cannot read them, so the any-head-dim kernels run them), at 832 |
# 833 (the bf16 kernels' 8 warps | 4 at block 32; ANYD_DIMS holds the edges
# at 64 and 128, 784 | 785 and 672 | 673), and at the tuned head dims'
# blocks their tables lack; peaked and rising-max
# scores at ANYD_STRESS_DIMS (N = 200), packed q/k/v views at
# ANYD_PACKED_DIMS, d = 1 at a head-dim stride of 2, and N below every
# key block (VARIANT_ANYD_SHORT)
VARIANT_ANYD_DIMS = ANYD_DIMS + (36, 150, 832, 833)
VARIANT_ANYD_SHORT = ((1, 1, 2, 100), (2, 5, 1, 28), (1, 17, 1, 1024))
# ... and timed at their default key blocks at ANYD_TIMED's N = 256 shapes
# of d = 64, 128, 256 and at the attention benchmark's ds1 geometry at d =
# 64: (name, (B, N, H, D))
VARIANT_ANYD_TIMED = (*ANYD_TIMED[:3], ("ds1_d64", (2, 4096, 8, 64)))
# the fp32 K3 and K4 at VARIANT_ANYD_TIMED before the tensor-core body
# (SIMT FMA), by row name: phase 30's final run of that source (H100 80GB
# HBM3, 700 W); for log lines only
VARIANT_ANYD_BEFORE_MS = {
    "flash_resident_anyd/ddpm_n256_d64": 0.2176, "flash_resident_anyd/ddpm_n256_d128": 0.3155,
    "flash_resident_anyd/ddpm_n256": 0.6302, "flash_resident_anyd/ds1_d64": 6.0964,
    "flash_pipelined_anyd/ddpm_n256_d64": 0.2722, "flash_pipelined_anyd/ddpm_n256_d128": 0.4211,
    "flash_pipelined_anyd/ddpm_n256": 0.9164, "flash_pipelined_anyd/ds1_d64": 7.9150,
}


def measured_row(measured: dict, fa, name: str, shape, replaces: str, rand) -> dict:
    """A kernels-line row at ``shape``: the numbers of the row this run
    already measured at the same shape and dtype (``measured``: shape ->
    row), renamed, or kernel_row's where there is none."""
    if shape not in measured:
        return kernel_row(fa, name, shape, replaces, rand)
    row = dict(measured[shape], name=f"flash_fwd/{name}", launches=None)
    row["timed_as"] = measured[shape]["name"]
    return row


@clocked
def phase_test_split(ckpt: str, card: str, rows: list[dict], measured: dict) -> dict:
    """Phase 26: pbe_tpu_torch.scripts.test.main in-process on configs/v1.yaml
    over a synthetic OpenImages tree (dotlist overrides point the test
    split at it), --limit 2 --ddim_steps 50 --scale 5, the FID trio on
    random Inception, every kernel's count set to 0 just before and read
    just after; beside it, in a thread, weights_runbook --dry_run on
    configs/tiny.yaml (its steps subprocesses on the card, each exiting 0,
    their launches not this process's). ``measured`` (shape -> row) holds
    the forward kernel's rows timed earlier in this run."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.scripts import make_synthetic_openimages
    from pbe_tpu_torch.scripts import test as test_cli
    from pbe_tpu_torch.scripts import weights_runbook

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        t_book = time.perf_counter()
        book = pool.submit(weights_runbook.main, [
            "--dry_run", "--config", "configs/tiny.yaml", "--skip_int8", "--skip_frozen",
            "--bench_size", "64", "--outdir", os.path.join(tmp, "runbook")])
        tree = os.path.join(tmp, "tree")
        make_synthetic_openimages.make_tree(tree, n_train=0, n_val=4 * TEST_SPLIT_BATCHES,
                                            size=512, seed=26)
        args = ["--base", "configs/v1.yaml", "--ckpt", ckpt, "--limit",
                str(TEST_SPLIT_BATCHES), "--ddim_steps", "50", "--scale", "5", "--logdir",
                os.path.join(tmp, "test"), f"data.params.test.params.dataset_dir={tree}",
                "data.params.test.params.state=validation"]
        t0 = time.perf_counter()
        results, counts, lse = counted_all(fa, lambda: test_cli.main(args))
        torch.cuda.synchronize()
        out["test_s"] = time.perf_counter() - t0
        by_shape = counts["flash_fwd"][1]
        log(f"[test-split] scripts.test v1 512^2 bf16, {TEST_SPLIT_BATCHES} batches of 4, "
            f"DDIM 50 at CFG 5, FID trio on random Inception: {out['test_s']:.1f} s (beside "
            f"the runbook); "
            f"results {json.dumps(results)}")
        log(f"[test-split] launches: {json.dumps({k: v[0] for k, v in counts.items()})}, "
            f"by shape {by_shape}, with the LSE {lse}")
        fails = []
        if set(results) != TEST_SPLIT_KEYS or not all(np.isfinite(v) for v in results.values()):
            fails.append(f"results {results} (want the keys {sorted(TEST_SPLIT_KEYS)}, finite)")
        if lse or any(sum(v[0].values()) for k, v in counts.items() if k != "flash_fwd"):
            fails.append(f"the test split ran a backward, variant or LSE kernel: {counts}")
        want = {}
        for _, shape, _, per in TEST_SPLIT_SHAPES:
            want[shape] = want.get(shape, 0) + per * TEST_SPLIT_BATCHES
        if by_shape != want:
            fails.append(f"forward launches by shape {by_shape}, expected {want}")
        out.update(results=results, launches=sum(by_shape.values()),
                   launches_per_batch=sum(by_shape.values()) / TEST_SPLIT_BATCHES)

        book = book.result(timeout=900)
        out["runbook_s"] = time.perf_counter() - t_book
        log(f"[test-split] weights_runbook --dry_run --config configs/tiny.yaml --skip_int8 "
            f"--skip_frozen --bench_size 64 (beside scripts.test): steps {book['steps']} each "
            f"exited 0, read {json.dumps(book['measured'])} (random weights: mechanics "
            f"only), {out['runbook_s']:.1f} s")
        steps = ["synthetic bench", "bench (fp)", "FID (fp)", "CLIP score (fp)"]
        if book["steps"] != steps or set(book["measured"]["fp"]) != {"FID", "CLIP"}:
            fails.append(f"the runbook ran {book['steps']} and read {book['measured']}")
        out["runbook"] = book["measured"]
    if fails:
        raise AssertionError("phase 26 (test split): " + "; ".join(fails))

    gen = torch.Generator(device="cuda").manual_seed(26)
    rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    for name, shape, replaces, per in TEST_SPLIT_SHAPES:
        row = measured_row(measured, fa, name, shape, replaces, rand)
        row["launches"] = by_shape.get(shape, 0)
        row["run"] = f"scripts.test, {TEST_SPLIT_BATCHES} batches: {per} a batch"
        rows.append(row)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[test-split] phase 26 {out['phase_s']:.1f} s ({card})")
    return out


def _step_timer(fa, events: list, deltas: list):
    """A Trainer.train_step wrapper that records a CUDA event as each step
    starts and each step's launches by kernel and shape."""
    import torch

    from pbe_tpu_torch.training.trainer import Trainer

    train_step = Trainer.train_step

    def timed(self, batch):
        snap = {k: dict(getattr(fa, k).launches_by_shape) for k in KERNELS}
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        metrics = train_step(self, batch)
        deltas.append({k: {s: n - snap[k].get(s, 0)
                           for s, n in getattr(fa, k).launches_by_shape.items()
                           if n - snap[k].get(s, 0)} for k in KERNELS})
        return metrics

    return train_step, timed


@clocked
def phase_overfit(card: str, rows: list[dict], measured: dict) -> dict:
    """Phase 27: pbe_tpu_torch.scripts.train_overfit_demo.main in-process on
    configs/v1.yaml at 512^2 (bf16, remat, constant LR, the posterior's
    mode), batch OVERFIT_BATCH (an OOM fails the phase with the peak),
    OVERFIT_STEPS steps, then its 50-step DDIM at scales 1 and 5: step p50, images/s,
    peak memory, the first and last loss_simple, the latent rel-MSE,
    launches a step by kernel; every loss and metric finite, the JAX demo's
    files written. Then the kernels at the step's shapes, and the tiny
    card-against-CPU check (overfit_tiny_reference)."""
    import torch

    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.scripts import train_overfit_demo as demo
    from pbe_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    out = {}
    batch = OVERFIT_BATCH
    events, deltas = [], []
    saved, timed = _step_timer(fa, events, deltas)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    Trainer.train_step = timed
    try:
        with tempfile.TemporaryDirectory() as tmp:
            res = demo.main(["--steps", str(OVERFIT_STEPS), "--batch", str(batch),
                             "--sample_steps", "50", "--log_every", "1", "--outdir", tmp])
            files = set(os.listdir(tmp))
    except torch.cuda.OutOfMemoryError as e:
        raise AssertionError(f"phase 27 (overfit demo): batch {batch} does not fit, peak "
                             f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB") from e
    finally:
        Trainer.train_step = saved
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(1, len(events) - 1)]
    p50 = float(np.median(step_ms))
    losses = [v for _, v in res["losses"]]
    summary = res["summary"]
    per_step = {k: sum(sum(d[k].values()) for d in deltas[1:]) / (len(deltas) - 1)
                for k in KERNELS}
    by_shape = deltas[-1]
    out.update(batch=batch, steps=OVERFIT_STEPS, step_p50_ms=p50,
               images_per_s=batch * 1e3 / p50, peak_gib=peak, train_s=res["train_s"],
               loss_first=losses[0], loss_last=losses[-1],
               latent_rel_mse={k: v["latent_rel_mse"] for k, v in summary.items()},
               psnr_mean={k: v["psnr_mean"] for k, v in summary.items()},
               launches_per_step=per_step)
    log(f"[overfit] v1 512^2 bf16 remat batch {batch}, {OVERFIT_STEPS} steps: step p50 "
        f"{p50:.3f} ms, {batch * 1e3 / p50:.4f} images/s, peak memory {peak:.3f} GiB, "
        f"loss_simple {losses[0]:.5f} (step 1) -> {losses[-1]:.5f} (step {OVERFIT_STEPS}); "
        f"latent rel-MSE {json.dumps(out['latent_rel_mse'])}, PSNR vs round trip "
        f"{json.dumps(out['psnr_mean'])} ({card})")
    log(f"[overfit] launches a step {json.dumps(per_step)}; the last step's by shape "
        f"{json.dumps({k: {str(s): n for s, n in v.items()} for k, v in by_shape.items()})}; "
        f"files {sorted(files)}")
    fails = []
    metrics = [*losses, *out["latent_rel_mse"].values(), *out["psnr_mean"].values()]
    if len(losses) != OVERFIT_STEPS or not all(np.isfinite(v) for v in metrics):
        fails.append(f"losses {losses}, summary {summary}")
    want_files = {"metrics.jsonl", "grids", "overfit_summary.json", "pred_scale1.npy",
                  "pred_scale5.npy", "roundtrip.npy", "loss_curve.json"}
    if not want_files <= files:
        fails.append(f"the demo wrote {sorted(files)}, not {sorted(want_files)}")
    want = {"flash_fwd": FWD_PER_STEP, "flash_bwd_dq": BWD_PER_STEP,
            "flash_bwd_dkv": BWD_PER_STEP, "flash_fwd_resident": 0, "flash_fwd_pipelined": 0}
    if per_step != want:
        fails.append(f"launches a step {per_step}, expected {want}")
    if fails:
        raise AssertionError("phase 27 (overfit demo): " + "; ".join(fails))

    gen = torch.Generator(device="cuda").manual_seed(27)
    rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    for name, (_, n, h, d), per in TRAIN_SHAPES:
        shape = (batch, n, h, d)
        got = {k: by_shape.get(k, {}).get(shape, 0)
               for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        for row in bwd_rows(fa, f"overfit_{name}", shape, per, 2 * per, K1, rand):
            row.pop("expected_launches_per_step")
            row["launches"] = got[row["name"].split("/")[0].removesuffix("_lse")]
            row["run"] = "overfit demo, a step"
            rows.append(row)
    vae = (batch, 4096, 1, 512)
    row = measured_row(measured, fa, "overfit_vae", vae, K2, rand)
    row["launches"], row["run"] = by_shape["flash_fwd"].get(vae, 0), "overfit demo, a step"
    rows.append(row)
    out["tiny"] = overfit_tiny_reference()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[overfit] phase 27 {out['phase_s']:.1f} s ({card})")
    return out


def overfit_tiny_reference() -> dict:
    """Phase 27's check: the demo's training (2 steps, batch 2, 64^2) and
    sampling (4-step DDIM, CFG 5) on configs/tiny.yaml in fp32 (TF32 off) on
    the card against the same on the CPU, the step's draws injected (t,
    noise, u from numpy) and the zero-init heads randomized: losses and
    gradient norms within 1e-4 relative (phase 22's bound); the sampling
    on the card's trained weights, copied to the CPU, within max 2e-3 and
    mean 2e-4 of [0,1] (phase 22's edit bound), z within 1e-3 of its RMS."""
    import argparse

    import torch

    from pbe_tpu_torch.models.pbe import build_from_yaml
    from pbe_tpu_torch.pipelines.loading import init_parameters, randomize_zero_params
    from pbe_tpu_torch.schedules import SamplerSchedule
    from pbe_tpu_torch.scripts import train_overfit_demo as demo
    from pbe_tpu_torch.training.trainer import Trainer

    card, _ = build_from_yaml("configs/tiny.yaml", dtype=torch.float32, attn_impl="flash",
                              device="cuda", remat=True)
    randomize_zero_params(init_parameters(card, seed=0), seed=0)
    host, _ = build_from_yaml("configs/tiny.yaml", dtype=torch.float32, attn_impl="flash",
                              device="cpu", remat=True)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    images, masks, refs = demo.make_pairs(8, 64)
    n = 64 // card.latent_downsample
    g = np.random.default_rng(27)
    draws = [(g.integers(0, 1000, (2,)), g.standard_normal((2, n, n, 4)).astype(np.float32),
              np.float32(g.uniform())) for _ in range(2)]
    saved = Trainer._draws
    curves = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, model in (("card", card), ("cpu", host)):
            it = iter(draws)
            Trainer._draws = lambda self, batch, gen: tuple(
                torch.from_numpy(np.array(a)).to(batch["image"].device) for a in next(it))
            opt = argparse.Namespace(steps=2, batch=2, lr=1e-4, log_every=1,
                                     sample_posterior=False,
                                     outdir=os.path.join(tmp, name))
            try:
                trainer = demo.train(model, images, masks, refs, opt)
            finally:
                Trainer._draws = saved
            with open(trainer.logger.path) as f:
                curves[name] = [(r["train/loss_simple"], r["train/grad_norm"])
                                for r in map(json.loads, f)]
    rel = max(abs(a - b) / abs(b) for ca, cb in zip(curves["card"], curves["cpu"])
              for a, b in zip(ca, cb))
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    sched = SamplerSchedule.create(card.schedule, 4)
    x_T = np.random.default_rng(28).standard_normal((8, n, n, 4)).astype(np.float32)
    outs = {}
    for name, model, dev in (("card", card, "cuda"), ("cpu", host, "cpu")):
        put = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        z0, z_hat, rt, pred = demo.build_eval_sample(model, sched)(
            put(images), put(masks), put(refs), put(x_T), 5.0)
        outs[name] = (z_hat.cpu().numpy(), pred.cpu().numpy())
    z_err = (np.abs(outs["card"][0] - outs["cpu"][0]).max()
             / np.sqrt(np.mean(outs["cpu"][0] ** 2)))
    diff = np.abs(outs["card"][1] - outs["cpu"][1])
    log(f"[overfit] tiny 64^2 demo fp32, 2 steps card vs CPU (draws injected): "
        f"(loss_simple, grad_norm) {curves['card']} / {curves['cpu']}, max rel diff "
        f"{rel:.3e} (tol 1e-4); 4-step DDIM at CFG 5 on the card's weights: z max|diff| / RMS "
        f"{z_err:.3e} (tol 1e-3), image max|diff| {diff.max():.3e} (tol 2e-3), mean "
        f"{diff.mean():.3e} (tol 2e-4)")
    if not (rel <= 1e-4 and z_err <= 1e-3 and diff.max() <= 2e-3 and diff.mean() <= 2e-4
            and all(np.isfinite(v).all() for v in outs["card"])):
        raise AssertionError("the tiny overfit demo on the card disagrees with the CPU's")
    return {"loss_rel": rel, "z_err": float(z_err), "image_max": float(diff.max()),
            "image_mean": float(diff.mean())}


def _legacy_pair(build, seed: int):
    """(module on the card, its copy on the CPU), seeded as flax
    initializes (init_like_flax) with the zero-init tensors randomized."""
    import copy

    import torch

    from pbe_tpu_torch.models.layers import init_like_flax
    from pbe_tpu_torch.pipelines.loading import randomize_zero_params

    with torch.device("cuda"):
        card = build()
    randomize_zero_params(init_like_flax(card, seed), seed)
    return card.eval(), copy.deepcopy(card).to("cpu").eval()


def _card_vs_cpu(name: str, card, host, args: tuple, fails: list, **kw) -> dict:
    """One forward on the card and on the CPU -> {card_s, cpu_s, err}: the
    largest |diff| over the CPU output's RMS, checked against LEGACY_TOL."""
    import torch

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = card(*(a.cuda() if isinstance(a, torch.Tensor) else a for a in args), **kw)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = host(*args, **kw)
        cpu_s = time.perf_counter() - t0
    got, want = got.double().cpu(), want.double()
    rms = float(want.square().mean().sqrt())
    err = float((got - want).abs().max()) / rms
    log(f"[legacy] {name}: output {tuple(want.shape)}, RMS {rms:.4e}, card vs CPU fp32 "
        f"max|diff| / RMS {err:.3e} (tol {LEGACY_TOL:g}); card {card_s:.3f} s, CPU "
        f"{cpu_s:.3f} s")
    if not (torch.isfinite(got).all() and err <= LEGACY_TOL):
        fails.append(f"{name}: {err:.3e}")
    return {"card_s": card_s, "cpu_s": cpu_s, "err": err}


@clocked
def phase_legacy(card: str, rows: list[dict]) -> dict:
    """Phase 28: the legacy models at their published widths, fp32 (TF32
    off), each on the card and on the CPU with the same seeded weights:
    EncoderUNetModel at guided-diffusion's 64x64 classifier (128 channels,
    4 res blocks, mult (1,2,3,4), attention at ds 2/4/8 with 64-channel
    heads, attention pool, 1000 classes, batch 8) and classifier_loss once;
    TextTransformer at LDM txt2img-1p4B's BERTEmbedder (1280 wide, 32
    layers, vocab 30522, 77 tokens, batch 2); vae_legacy.Model at DDPM's
    CIFAR-10 widths (128, mult (1,2,2,2), 2 res blocks, attention at 16,
    32^2, batch 16), "plain", and "flash" on the same weights against it on
    the card (its 256-wide heads run csrc/flash_anyd.cu); LatentRescaler
    (1.0, 4 -> 512 -> 4, depth 2) on a 64^2 latent at batch 2 with "flash"
    (K2 at LATENT_RESCALER_SHAPE), against "plain" on the card too;
    MergedRescaleEncoder/Decoder at the v1 VAE's widths at 256^2."""
    import torch

    from pbe_tpu_torch.models import encoder_unet as eu
    from pbe_tpu_torch.models import text_transformer as tt
    from pbe_tpu_torch.models import vae_legacy as vl
    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.schedules import DiffusionSchedule

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(28)
    fails, out = [], {}

    card_m, host = _legacy_pair(lambda: eu.EncoderUNetModel(
        image_size=64, in_channels=3, model_channels=128, out_channels=1000,
        num_res_blocks=4, attention_resolutions=(2, 4, 8), channel_mult=(1, 2, 3, 4),
        num_head_channels=64, pool="attention"), 1)
    x = torch.randn((8, 3, 64, 64), generator=g)
    t = torch.randint(0, 1000, (8,), generator=g)
    out["encoder_unet"] = _card_vs_cpu("EncoderUNetModel 64x64 classifier, batch 8", card_m,
                                       host, (x, t), fails)
    sched = DiffusionSchedule.create()
    labels = torch.randint(0, 1000, (8,), generator=g)
    noise = torch.randn(x.shape, generator=g)
    with torch.no_grad():
        loss_c, logits = eu.classifier_loss(card_m, sched, x.cuda(), labels.cuda(), t=t.cuda(),
                                            noise=noise.cuda())
        loss_h, _ = eu.classifier_loss(host, sched, x, labels, t=t, noise=noise)
    rel = float(((loss_c.cpu() - loss_h).abs() / loss_h.abs()).max())
    top5 = float(eu.top_k_accuracy(logits, labels.cuda(), 5))
    log(f"[legacy] classifier_loss at batch 8: mean {float(loss_c.mean()):.4f}, card vs CPU "
        f"max rel diff {rel:.3e} (tol {LEGACY_TOL:g}); top-5 accuracy {top5}")
    if not (torch.isfinite(loss_c).all() and rel <= LEGACY_TOL):
        fails.append(f"classifier_loss: {rel:.3e}")
    out["classifier_loss_rel"] = rel
    del card_m, host

    card_m, host = _legacy_pair(lambda: tt.BERTEmbedderConfig(n_embed=1280, n_layer=32).build(),
                                2)
    tokens = torch.randint(0, 30522, (2, 77), generator=g)
    out["text_transformer"] = _card_vs_cpu("TextTransformer (BERTEmbedder 1280 x 32), 2 x 77 "
                                           "tokens", card_m, host, (tokens,), fails,
                                           return_embeddings=True)
    del card_m, host

    card_m, host = _legacy_pair(lambda: vl.Model(**DDPM_CIFAR), 3)
    x16 = torch.randn((16, 3, 32, 32), generator=g)
    t16 = torch.randint(0, 1000, (16,), generator=g)
    out["ddpm_model"] = _card_vs_cpu("vae_legacy.Model (DDPM CIFAR-10), batch 16", card_m, host,
                                     (x16, t16), fails)
    # the same weights with "flash": its 256-wide heads run csrc/flash_anyd.cu
    with torch.device("cuda"):
        flash_m = vl.Model(**DDPM_CIFAR, attn_impl="flash").eval()
    flash_m.load_state_dict(card_m.state_dict())
    with torch.no_grad():
        got, _, _ = counted_all(fa, lambda: flash_m(x16.cuda(), t16.cuda()))
        want = card_m(x16.cuda(), t16.cuda())
    by_kernel = dict(fa.flash_fwd.launches_by_kernel)
    flash_vs_plain = float((got - want).abs().max() / want.square().mean().sqrt())
    log(f"[legacy] vae_legacy.Model (DDPM CIFAR-10) batch 16 with 'flash': launches "
        f"{by_kernel} {dict(fa.flash_fwd.launches_by_shape)}; against 'plain' on the card "
        f"max|diff| / RMS {flash_vs_plain:.3e} (tol {LEGACY_TOL:g})")
    if by_kernel != {"flash_fwd_anyd": 6} or flash_vs_plain > LEGACY_TOL:
        fails.append(f"DDPM Model flash: launches {by_kernel}, vs plain {flash_vs_plain}")
    out["ddpm_model"]["flash_vs_plain"] = flash_vs_plain
    del card_m, host, flash_m, got, want

    card_m, host = _legacy_pair(lambda: vl.LatentRescaler(1.0, 4, 512, 4, depth=2,
                                                          attn_impl="flash"), 4)
    plain = vl.LatentRescaler(1.0, 4, 512, 4, depth=2).cuda().eval()
    plain.load_state_dict(card_m.state_dict())
    z = torch.randn((2, 4, 64, 64), generator=g)
    with torch.no_grad():
        got, counts, _ = counted_all(fa, lambda: card_m(z.cuda()))
        want = plain(z.cuda())
    flash_vs_plain = float((got - want).abs().max() / want.square().mean().sqrt())
    launches = counts["flash_fwd"][1]
    log(f"[legacy] LatentRescaler (1.0, 4 -> 512 -> 4, depth 2) 64^2 latent, batch 2, flash: "
        f"launches {launches} ({counts['flash_fwd'][0]}); against 'plain' on the card "
        f"max|diff| / RMS {flash_vs_plain:.3e} (tol {LEGACY_TOL:g})")
    if launches != {LATENT_RESCALER_SHAPE: 1} or flash_vs_plain > LEGACY_TOL:
        fails.append(f"LatentRescaler flash: launches {launches}, vs plain {flash_vs_plain}")
    out["latent_rescaler"] = _card_vs_cpu("LatentRescaler flash", card_m, host, (z,), fails)
    out["latent_rescaler"]["flash_vs_plain"] = flash_vs_plain
    del card_m, host, plain, got, want
    gen = torch.Generator(device="cuda").manual_seed(28)
    rand32 = lambda shape: torch.randn(shape, generator=gen, device="cuda")
    row = kernel_row(fa, "latent_rescaler", LATENT_RESCALER_SHAPE, K2, rand32)
    row["launches"], row["run"] = launches.get(LATENT_RESCALER_SHAPE, 0), "phase 28, a forward"
    rows.append(row)

    v1 = dict(ch=128, num_res_blocks=2, ch_mult=(1, 2, 4, 4), resolution=256)
    card_m, host = _legacy_pair(lambda: vl.MergedRescaleEncoder(in_channels=3, out_ch=4, **v1),
                                5)
    out["merged_encoder"] = _card_vs_cpu("MergedRescaleEncoder (v1 VAE widths) 256^2, batch 2",
                                         card_m, host,
                                         (torch.randn((2, 3, 256, 256), generator=g),), fails)
    del card_m, host
    card_m, host = _legacy_pair(lambda: vl.MergedRescaleDecoder(z_channels=4, out_ch=3, **v1), 6)
    out["merged_decoder"] = _card_vs_cpu("MergedRescaleDecoder (v1 VAE widths) to 256^2, "
                                         "batch 2", card_m, host,
                                         (torch.randn((2, 4, 32, 32), generator=g),), fails)
    del card_m, host
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError("phase 28 (legacy models): " + "; ".join(fails))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[legacy] phase 28 {out['phase_s']:.1f} s ({card})")
    return out


def ddpm_xt(sched, x0, t, noise):
    """DDPM's forward process at the given timesteps and noise (injected, so
    the card and the CPU draw nothing): sqrt(abar_t) x0 + sqrt(1 - abar_t)
    noise."""
    import torch

    coef = lambda a: torch.as_tensor(a, dtype=torch.float32, device=x0.device)[t].view(-1, 1, 1, 1)
    return coef(sched.sqrt_alphas_cumprod) * x0 + coef(sched.sqrt_one_minus_alphas_cumprod) * noise


def ddpm_loss(model, x0, t, noise, sched):
    """DDPM's epsilon-MSE loss: the mean of (model(x_t, t) - noise)^2 in fp32."""
    return (model(ddpm_xt(sched, x0, t, noise), t).float() - noise).square().mean()


def ddpm_grad(model, x0, t, noise, sched) -> tuple[float, float]:
    """One backward of ddpm_loss -> (the loss, the parameter gradients' global
    L2 norm, in float64)."""
    import torch

    model.zero_grad(set_to_none=True)
    loss = ddpm_loss(model, x0, t, noise, sched)
    loss.backward()
    norm = torch.stack([p.grad.double().square().sum() for p in model.parameters()
                        if p.grad is not None]).sum().sqrt()
    return float(loss.detach()), float(norm)


def anyd_counted(fa, fn):
    """counted_all(fa, fn) -> (fn's result, {wrapper: (launches by kernel, by
    shape)}, forward launches with the LSE)."""
    out, _, lse = counted_all(fa, fn)
    return out, {name: (dict(getattr(fa, name).launches_by_kernel),
                        dict(getattr(fa, name).launches_by_shape)) for name in KERNELS}, lse


def expect_ddpm_launches(counts: dict, lse: int, grad: bool, label: str) -> None:
    """Every flash launch of one DDPM UNet forward (and, with ``grad``, its
    backward) is csrc/flash_anyd.cu's, DDPM_ATTN's by shape, the forward's
    with the LSE where a gradient follows; no other kernel runs."""
    want = {name: ({}, {}) for name in KERNELS}
    want["flash_fwd"] = ({"flash_fwd_anyd": 6}, DDPM_ATTN)
    if grad:
        want["flash_bwd_dq"] = ({"flash_bwd_dq_anyd": 6}, DDPM_ATTN)
        want["flash_bwd_dkv"] = ({"flash_bwd_dkv_anyd": 6}, DDPM_ATTN)
    log(f"[ddpm] {label}: launches {counts}, {lse} with the LSE")
    if counts != want or lse != (6 if grad else 0):
        raise AssertionError(f"the DDPM UNet's {label} launched {counts} ({lse} with the LSE), "
                             f"expected {want} ({6 if grad else 0})")


def hmma_by_kernel(lib) -> dict:
    """{kernel label: HMMA (tensor-core) instructions} of every kernel in the
    built library's SASS (cuobjdump -sass)."""
    import re
    import shutil
    import subprocess

    from pbe_tpu_torch.ops import cuda_build
    from pbe_tpu_torch.scripts.sweep_flash_tiles import kernel_label

    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(cuda_build.find_nvcc()),
                                                     "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    hmma, label = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            label = kernel_label(m[1]) or m[1]
            hmma[label] = 0
        elif label is not None and "HMMA" in line:
            hmma[label] += 1
    return hmma


def anyd_build_report() -> dict:
    """csrc/flash_anyd.cu's build (here, timed, where no earlier phase
    built it) and its kernels: each one's ptxas registers and spills, and
    its tensor-core instructions (HMMA) in the built library's SASS
    (cuobjdump -sass). Raises unless every instantiation of the bf16
    forward, dQ and dK/dV (flash_fwd_anyd_mma, flash_bwd_dq_anyd_mma,
    flash_bwd_dkv_anyd_mma) and of the fp32 forward and dK/dV
    (flash_fwd_anyd_tf32, flash_bwd_dkv_anyd_tf32) holds HMMA, the library
    holds no SIMT kernel in their place (a bf16 flash_bwd_dq_anyd, an fp32
    flash_fwd_anyd or flash_bwd_dkv_anyd), and the dQ and the fp32 forward
    and dK/dV spill nothing."""
    import re

    from pbe_tpu_torch.ops import cuda_build
    from pbe_tpu_torch.scripts.sweep_flash_tiles import ptxas_report

    if "flash_anyd" not in BUILD_SECONDS:
        t = time.perf_counter()
        cuda_build.build("flash_anyd")
        BUILD_SECONDS["flash_anyd"] = time.perf_counter() - t
    lib = cuda_build.build("flash_anyd")
    report = ptxas_report(cuda_build.build_log("flash_anyd"))
    log(f"[anyd] flash_anyd.cu built in {BUILD_SECONDS['flash_anyd']:.1f} s; registers and "
        f"spills (ptxas):\n{report}")
    spills = [line.strip() for line in report.splitlines()
              if ("_mma<" in line or "_tf32<" in line) and re.search(r"[1-9]\d* bytes spill", line)]
    if spills:
        log(f"[anyd] the tensor-core kernels spill: {spills}")
    hmma = hmma_by_kernel(lib)
    log(f"[anyd] HMMA instructions by kernel (cuobjdump -sass): {hmma}")
    mma = {k: v for k, v in hmma.items() if "_anyd_mma<" in k or "_anyd_tf32<" in k}
    kinds = {k.split("<")[0] for k in mma}
    want = {"flash_fwd_anyd_mma", "flash_bwd_dq_anyd_mma", "flash_bwd_dkv_anyd_mma",
            "flash_fwd_anyd_tf32", "flash_bwd_dkv_anyd_tf32"}
    simt = {"flash_bwd_dq_anyd<bf16>", "flash_fwd_anyd<fp32>",
            "flash_bwd_dkv_anyd<fp32>"} & set(hmma)
    if kinds != want or not all(mma.values()) or simt:
        raise AssertionError(f"the bf16 forward, dQ and dK/dV and the fp32 forward and dK/dV "
                             f"of flash_anyd.cu are not all on the tensor cores (or a SIMT "
                             f"kernel {simt} is left): HMMA by kernel {hmma}")
    new_spills = [line for line in spills if "flash_bwd_dq_anyd_mma<" in line
                  or "flash_fwd_anyd_tf32<" in line or "flash_bwd_dkv_anyd_tf32<" in line]
    if new_spills:
        raise AssertionError(f"the dQ or an fp32 kernel of flash_anyd.cu spills: {new_spills}")
    return {"build_s": BUILD_SECONDS["flash_anyd"], "hmma": hmma, "spills": spills}


def anyd_offsets(fa, gen) -> dict:
    """The tensor-core kernels at the DDPM shape on q, k, v and dO that
    start ANYD_OFFSETS elements past 16-byte aligned buffers (pieces of 8,
    4, 2, 1 elements at bf16, 4, 2, 1 at fp32), each against its plain
    version (phase 7's or phase 20's tolerances) and timed -> {dtype:
    {offset: {kernel: ms}}}: the bf16 forward, dQ and dK/dV, the fp32
    forward and dK/dV."""
    import torch

    shape = (DDPM_BATCH, 256, 1, 256)
    numel = int(np.prod(shape))
    out = {}
    for dname, offsets in ANYD_OFFSETS.items():
        dtype = getattr(torch, dname)
        out[dname] = {}
        for off in offsets:
            q, k, v, do = (torch.randn(numel + 8, generator=gen, device="cuda")
                           .to(dtype)[off:off + numel].view(shape) for _ in range(4))
            label = f"anyd {dname} {shape} at offset {off}"
            check_flash_f32(fa, q, k, v, label)
            check_bwd(fa, q, k, v, do, label)
            lse = fa.flash_fwd(q, k, v, return_lse=True)[1]
            dd = fa.rowsum_do_o(do, fa.flash_fwd(q, k, v))
            ms = {"flash_fwd": graph_ms(lambda: fa.flash_fwd(q, k, v), 20),
                  "flash_bwd_dkv": graph_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, dd), 20)}
            if dname == "bfloat16":
                ms["flash_bwd_dq"] = graph_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, dd), 20)
            out[dname][off] = ms
            log(f"[anyd] {label}: " + ", ".join(f"{k_} {t:.4f} ms" for k_, t in ms.items()))
            del q, k, v, do, lse, dd
    torch.cuda.empty_cache()
    return out


@clocked
def phase_ddpm(card: str, rows: list[dict]) -> dict:
    """Phase 29: csrc/flash_anyd.cu and the DDPM CIFAR-10 UNet with
    attn_impl="flash". (a) the build, ptxas and SASS report
    (anyd_build_report: HMMA in the bf16 forward, dQ and dK/dV and the
    fp32 forward and dK/dV, no SIMT kernel in their place, no spills in the
    dQ and the fp32 forward and dK/dV, or the phase fails); the forward, dQ
    and dK/dV kernels at both dtypes against their
    plain versions at ANYD_DIMS (ragged N = 77), on peaked and rising-max
    scores and packed q/k/v views, each launched twice and compared
    bitwise, and the tensor-core ones at ANYD_OFFSETS (anyd_offsets), no
    other kernel launched; d = 1025 refused. (b) vae_legacy.Model at DDPM_CIFAR, batch 128, seeded weights:
    a forward and the gradient of the epsilon-MSE loss at injected
    timesteps and noise, at fp32 and bf16,
    each run's launches counted from 0 (expect_ddpm_launches); fp32 flash
    against fp32 plain on the card (LEGACY_TOL, DDPM_F32_REL), bf16 flash
    against it (DDPM_BF16_TOL); forward-plus-backward p50 and peak memory at
    each dtype; card fp32 flash against the CPU at batch 16. (c) each kernel
    at ANYD_TIMED against its plain version and timed beside it and SDPA,
    its launches those of (b)'s runs at that shape: the kernels line's
    *_anyd rows; ANYD_BEFORE_MS's time of the bf16 dQ, the fp32 forward and
    the fp32 dK/dV, recorded before their redesign, is printed in their
    rows' log lines and not put in the rows."""
    import torch

    from pbe_tpu_torch.models import vae_legacy as vl
    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.schedules import DiffusionSchedule

    t_phase = time.perf_counter()
    build = anyd_build_report()
    gen = torch.Generator(device="cuda").manual_seed(29)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def checks():
        for dtype in dtypes.values():
            rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for d in ANYD_DIMS:
                shape = (2, 77, 2, d)
                q, k, v, do = (rand(shape) for _ in range(4))
                check_flash_f32(fa, q, k, v, f"anyd {dtype} {shape}")
                check_bwd(fa, q, k, v, do, f"anyd {dtype} {shape}")
            for d in ANYD_STRESS_DIMS:
                shape = (1, 200, 2, d)
                q, k, v, do = (rand(shape) for _ in range(4))
                check_flash_f32(fa, q * 8, k * 8, v, f"anyd peaked (q, k x8) {dtype} {shape}")
                check_bwd(fa, q * 8, k * 8, v, do, f"anyd peaked (q, k x8) {dtype} {shape}")
                qr, kr = rising_scores(shape, gen, dtype)
                check_flash_f32(fa, qr, kr, v, f"anyd rising max {dtype} {shape}")
                check_bwd(fa, qr, kr, v, do, f"anyd rising max {dtype} {shape}")
            for d in ANYD_PACKED_DIMS:
                q, k, v = rand((2, 77, 3, 2, d)).unbind(2)
                label = f"anyd packed qkv views {dtype} {tuple(q.shape)} strides {q.stride()}"
                check_flash_f32(fa, q, k, v, label)
                check_bwd(fa, q, k, v, rand(q.shape), label)
    def all_checks():
        checks()
        return anyd_offsets(fa, gen)

    # every head dim of ANYD_DIMS lies outside the tuned table: only
    # csrc/flash_anyd.cu's kernels ran
    offsets, by_kernel, _ = anyd_counted(fa, all_checks)
    ran = {name for kernels, _ in by_kernel.values() for name in kernels}
    log(f"[anyd] the checks launched {ran}")
    if ran != {"flash_fwd_anyd", "flash_bwd_dq_anyd", "flash_bwd_dkv_anyd"}:
        raise AssertionError(f"the any-head-dim checks launched {ran}")
    wide = torch.zeros((1, 8, 1, fa.ANYD_MAX_HEAD_DIM + 1), device="cuda")
    try:
        fa.flash_fwd(wide, wide, wide)
        raise AssertionError("flash_fwd took a head dim past ANYD_MAX_HEAD_DIM")
    except ValueError as e:
        log(f"[anyd] head dim {fa.ANYD_MAX_HEAD_DIM + 1} refused: {e}")
    checks_s = time.perf_counter() - t_phase
    log(f"[anyd] every check passed in {checks_s:.1f} s")
    out_build = {**build, "offsets": offsets}

    sched = DiffusionSchedule.create()
    g = torch.Generator().manual_seed(29)
    x0 = torch.randn((DDPM_BATCH, 3, 32, 32), generator=g)
    t = torch.randint(0, sched.num_timesteps, (DDPM_BATCH,), generator=g)
    noise = torch.randn(x0.shape, generator=g)
    flash32, host = _legacy_pair(lambda: vl.Model(**DDPM_CIFAR, attn_impl="flash"), 29)
    with torch.device("cuda"):
        models = {"float32": flash32,
                  "bfloat16": vl.Model(**DDPM_CIFAR, dtype=torch.bfloat16, attn_impl="flash"),
                  "plain": vl.Model(**DDPM_CIFAR)}
    for m in models.values():
        m.load_state_dict(flash32.state_dict())
    xc, tc, nc = x0.cuda(), t.cuda(), noise.cuda()
    xt = ddpm_xt(sched, xc, tc, nc)
    res, launches = {}, {}
    for name, m in models.items():
        with torch.no_grad():
            y, counts, lse = anyd_counted(fa, lambda: m(xt, tc).float())
        if name != "plain":
            expect_ddpm_launches(counts, lse, False, f"{name} forward at batch {DDPM_BATCH}")
        (loss, norm), gcounts, glse = anyd_counted(fa, lambda: ddpm_grad(m, xc, tc, nc, sched))
        if name != "plain":
            expect_ddpm_launches(gcounts, glse, True, f"{name} gradient at batch {DDPM_BATCH}")
            # by kernel row: the forward's, the gradient's forward (with the
            # LSE) and its backward pair's launches at each shape
            launches[name] = {"flash_fwd": counts["flash_fwd"][1],
                              "flash_fwd_lse": gcounts["flash_fwd"][1],
                              "flash_bwd_dq": gcounts["flash_bwd_dq"][1],
                              "flash_bwd_dkv": gcounts["flash_bwd_dkv"][1]}
        elif any(sum(c[0].values()) for c in (*counts.values(), *gcounts.values())):
            raise AssertionError(f"the plain DDPM UNet launched {counts} / {gcounts}")
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(DDPM_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ddpm_grad(m, xc, tc, nc, sched)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res[name] = {"y": y, "loss": loss, "grad_norm": norm,
                     "step_p50_ms": 1e3 * float(np.median(times)),
                     "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
        log(f"[ddpm] {name} batch {DDPM_BATCH}: loss {loss:.6f}, grad norm {norm:.6f}, "
            f"forward+backward p50 {res[name]['step_p50_ms']:.2f} ms over {DDPM_STEPS} steps "
            f"{['%.2f' % (1e3 * x) for x in times]}, peak {res[name]['peak_mb']:.0f} MB ({card})")
    ref = res.pop("plain")
    rms = float(ref["y"].square().mean().sqrt())
    fails, out = [], {"checks_s": checks_s, "build": out_build}
    for name, r in res.items():
        diff = (r["y"] - ref["y"]).abs()
        cmp = {"max": float(diff.max()) / rms, "mean": float(diff.mean()) / rms,
               "loss": abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
               "grad_norm": abs(r["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]}
        tol = (DDPM_BF16_TOL if name == "bfloat16" else
               {"max": LEGACY_TOL, "mean": LEGACY_TOL, "loss": DDPM_F32_REL,
                "grad_norm": DDPM_F32_REL})
        log(f"[ddpm] {name} flash against fp32 plain on the card: output |diff| / RMS max "
            f"{cmp['max']:.3e}, mean {cmp['mean']:.3e}; loss rel {cmp['loss']:.3e}; grad norm "
            f"rel {cmp['grad_norm']:.3e} (tol {tol})")
        if not (torch.isfinite(r["y"]).all() and all(cmp[k] <= tol[k] for k in tol)):
            fails.append(f"{name} flash against fp32 plain: {cmp}")
        out[name] = {**{f"{k}_rel": v for k, v in cmp.items()},
                     **{k: r[k] for k in ("loss", "grad_norm", "step_p50_ms", "peak_mb")}}
    out["plain_float32"] = {k: ref[k] for k in ("loss", "grad_norm", "step_p50_ms", "peak_mb")}
    del models, res, ref, xt
    torch.cuda.empty_cache()

    # card (flash, fp32) against the CPU (the kernels' plain versions) at batch 16
    args16 = (x0[:16], t[:16], noise[:16])
    cpu = _card_vs_cpu("DDPM CIFAR-10 UNet flash fp32, batch 16", flash32, host,
                       (ddpm_xt(sched, *args16), t[:16]), fails)
    card_lg = ddpm_grad(flash32, *(a.cuda() for a in args16), sched)
    host_lg = ddpm_grad(host, *args16, sched)
    rel = [abs(a - b) / abs(b) for a, b in zip(card_lg, host_lg)]
    log(f"[ddpm] batch 16 (loss, grad norm) card {card_lg}, CPU {host_lg}: rel {rel[0]:.3e}, "
        f"{rel[1]:.3e} (tol {DDPM_F32_REL})")
    if max(rel) > DDPM_F32_REL:
        fails.append(f"card against CPU at batch 16: loss and grad norm rel {rel}")
    out["card_vs_cpu"] = {**cpu, "loss_rel": rel[0], "grad_norm_rel": rel[1]}
    del flash32, host
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError("phase 29 (DDPM with flash): " + "; ".join(fails))

    source = "pbe_tpu_torch/csrc/flash_anyd.cu"
    for dname, dtype in dtypes.items():
        rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)
        for name, shape in ANYD_TIMED:
            per = DDPM_ATTN.get(shape, 0)
            new = [{**kernel_row(fa, name, shape, K1, rand, source), "expected_launches": per},
                   *bwd_rows(fa, name, shape, per, per, K1, rand, source)]
            for row in new:
                kname, rest = row["name"].split("/", 1)
                row["name"] = f"{kname}_anyd/{rest}"
                row["launches"] = launches[dname][kname].get(shape, 0)
                before = ANYD_BEFORE_MS.get((kname, name, dname))
                log(f"[anyd] {row['name']} {dname}: {row['ms']:.4f} ms ("
                    + (f"before the redesign {before:.4f}" if before else "not redesigned")
                    + f"), plain {row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}, bound "
                    f"{row['bound_ms']:.4f} ms ({card})")
                row["run"] = (f"phase 29: one forward and one gradient of the DDPM CIFAR-10 UNet "
                              f"at batch {DDPM_BATCH}, {dname}")
            rows += new
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[ddpm] phase 29 {out['phase_s']:.1f} s ({card})")
    return out


# csrc/flash_variants_anyd.cu's kernels by kind, and their instantiations:
# bf16 K3 and K4 at 4 and 8 warps, slices of 128 and 256 columns at key
# blocks of 32 and 64, of 128 at 128 (10 each); fp32 K3 and K4 at 4 and 8
# warps with the q2 rows resident (slices of 128 and 256) and at 8 warps
# streamed (192) at key blocks of 32 and 64, and K3 at 128 (resident 128 at
# 4 and 8 warps, streamed 64 at 8: 13), K4 at 128 as at 64 (15)
VARIANT_ANYD_KERNELS = {"flash_resident_anyd_mma": 10, "flash_pipelined_anyd_mma": 10,
                        "flash_resident_anyd_tf32": 13, "flash_pipelined_anyd_tf32": 15}


def variants_anyd_build_report() -> dict:
    """csrc/flash_variants_anyd.cu's build (timed where no earlier phase
    built it, beside csrc/flash_anyd.cu's where that is not built either)
    and its kernels: each one's ptxas registers and spills and its HMMA
    count (cuobjdump -sass). Raises unless every instantiation of
    VARIANT_ANYD_KERNELS is there and holds HMMA (bf16 on mma.sync, fp32
    on 3xTF32), no SIMT fp32 K3 or K4 (flash_resident_anyd<fp32, ...>,
    flash_pipelined_anyd<fp32, ...>) is left, and no kernel spills."""
    import re

    from pbe_tpu_torch.ops import cuda_build
    from pbe_tpu_torch.scripts.sweep_flash_tiles import ptxas_report

    missing = tuple(n for n in ("flash_anyd", "flash_variants_anyd") if n not in BUILD_SECONDS)
    if missing:
        start_builds(missing)()
    lib = cuda_build.build("flash_variants_anyd")
    report = ptxas_report(cuda_build.build_log("flash_variants_anyd"))
    log(f"[variants-anyd] flash_variants_anyd.cu built in "
        f"{BUILD_SECONDS['flash_variants_anyd']:.1f} s; registers and spills (ptxas):\n{report}")
    hmma = hmma_by_kernel(lib)
    log(f"[variants-anyd] HMMA instructions by kernel (cuobjdump -sass): {hmma}")
    kinds = {kind: sorted(k for k in hmma if k.split("<")[0] == kind)
             for kind in VARIANT_ANYD_KERNELS}
    spills = [line.strip() for line in report.splitlines()
              if re.search(r"[1-9]\d* bytes spill", line)]
    fails = [f"{kind}: {len(kinds[kind])} instantiations, expected {count}"
             for kind, count in VARIANT_ANYD_KERNELS.items() if len(kinds[kind]) != count]
    fails += [f"{k} holds no HMMA" for kind in VARIANT_ANYD_KERNELS for k in kinds[kind]
              if not hmma[k]]
    fails += [f"SIMT kernel {k} left" for k in hmma
              if k.split("<")[0] in ("flash_resident_anyd", "flash_pipelined_anyd")]
    fails += [f"spills: {line}" for line in spills]
    if fails:
        raise AssertionError("flash_variants_anyd.cu: " + "; ".join(fails))
    return {"build_s": BUILD_SECONDS["flash_variants_anyd"], "hmma": hmma,
            "ptxas": report.splitlines()}


@clocked
def phase_variants_anyd(card: str, rows: list[dict]) -> dict:
    """Phase 30: csrc/flash_variants_anyd.cu, K3 and K4 at every head dim
    from 1 to 1024. (a) the build, ptxas and SASS report
    (variants_anyd_build_report: every instantiation, each holding HMMA,
    no SIMT fp32 kernel, no spills). (b) at bf16 and fp32, each variant at
    every (head
    dim, key block) pair of VARIANT_ANYD_DIMS x KEY_BLOCKS and of the tuned
    head dims' blocks their tables lack (kernel_entry names the any-head-dim
    kernel there), N = 77, then on peaked and rising-max scores, packed
    q/k/v views, d = 1 at a head-dim stride of 2 and N below every block
    (VARIANT_ANYD_SHORT): each call launched twice, counted as two
    launches of its any-head-dim kernel and of no other, compared bitwise,
    and held against the plain version at phase 29's forward tolerances
    (compare_flash); a cluster of 2, a key block of 256 and d = 1025
    refused. (c) at VARIANT_ANYD_TIMED, every count set to
    0 just before one flash_forward(variant=...) call of each variant at its
    default key block and read just after (one launch of its any-head-dim
    kernel and of no other: the row's launches), then each kernel timed (a
    CUDA graph of 20 calls) beside the plain version, SDPA, flash_fwd_anyd
    at the same shape and the function's bound (phases 11 and 29's: bound,
    or bound_3xtf32 at fp32): the kernels line's flash_{resident,
    pipelined}_anyd rows, the fp32 ones' log lines with their times before
    the tensor-core body (VARIANT_ANYD_BEFORE_MS) and not in the rows.
    Every failure of (b) is collected, and the phase fails at its end
    naming them all."""
    import torch
    import torch.nn.functional as F

    from pbe_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    build = variants_anyd_build_report()
    gen = torch.Generator(device="cuda").manual_seed(30)
    kernels = {"resident": fa.flash_fwd_resident, "pipelined": fa.flash_fwd_pipelined}
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    fails, checked = [], 0

    def check(variant, q, k, v, want, block, label):
        """two launches of the any-head-dim kernel on (q, k, v): counted by
        kernel name, equal bit for bit, the first against the plain
        version -> (max err, max lse err), None where one of them fails"""
        nonlocal checked
        kern, name = kernels[variant], f"flash_{variant}_anyd"
        label = f"{variant} {label} {tuple(q.shape)} block {block}"
        try:
            lib = fa.kernel_entry(variant, q.shape[3], q.dtype, block)[0]
            if lib != "flash_variants_anyd":
                raise AssertionError(f"kernel_entry names {lib}")
            before = dict(kern.launches_by_kernel)
            got = [kern(q, k, v, return_lse=True, block=block) for _ in range(2)]
            diff = {kn: c - before.get(kn, 0) for kn, c in kern.launches_by_kernel.items()
                    if c != before.get(kn, 0)}
            if diff != {name: 2}:
                raise AssertionError(f"two calls launched {diff}")
            if not (torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])):
                raise AssertionError("two launches differ")
            errs = compare_flash(got[0], want, label)
            checked += 1
            return errs
        except (AssertionError, RuntimeError, ValueError) as e:
            fails.append(f"{label}: {type(e).__name__}: {e}")
            log(f"[variants-anyd] FAIL {label}: {e}")
            return None

    def check_all(q, k, v, label, blocks=fa.KEY_BLOCKS):
        want = fa.flash_attention_plain(q, k, v, return_lse=True)
        for variant in kernels:
            for block in blocks:
                if not fa.tuned_variant(variant, q.shape[3], block, q.dtype):
                    check(variant, q, k, v, want, block, label)

    for dname, dtype in dtypes.items():
        rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)
        for d in VARIANT_ANYD_DIMS + fa.SUPPORTED_HEAD_DIMS:
            shape = (2, 77, 2, d)
            check_all(rand(shape), rand(shape), rand(shape), f"{dname} check")
        for d in ANYD_STRESS_DIMS:
            shape = (1, 200, 2, d)
            q, k, v = rand(shape), rand(shape), rand(shape)
            check_all(q * 8, k * 8, v, f"{dname} peaked (q, k x8)")
            qr, kr = rising_scores(shape, gen, dtype)
            check_all(qr, kr, v, f"{dname} rising max")
        for d in ANYD_PACKED_DIMS:
            q, k, v = rand((2, 77, 3, 2, d)).unbind(2)
            check_all(q, k, v, f"{dname} packed qkv views strides {q.stride()}")
        q, k, v = (rand((2, 77, 1, 2)).permute(0, 1, 3, 2) for _ in range(3))
        check_all(q, k, v, f"{dname} d = 1 strides {q.stride()}")
        for shape in VARIANT_ANYD_SHORT:
            check_all(rand(shape), rand(shape), rand(shape), f"{dname} short")
    x = torch.zeros((1, 77, 2, 64), device="cuda", dtype=torch.bfloat16)
    refusals = {"cluster 2": lambda: fa.flash_fwd_resident(x, x, x, cluster=2),
                "block 256": lambda: fa.flash_forward(x, x, x, variant="pipelined",
                                                      block_c=256),
                "d = 1025": lambda: fa.flash_forward(*[torch.zeros(
                    (1, 8, 1, 1025), device="cuda")] * 3, variant="resident")}
    for what, call in refusals.items():
        try:
            call()
            fails.append(f"{what} was not refused")
        except ValueError as e:
            log(f"[variants-anyd] {what} refused: {e}")
    checks_s = time.perf_counter() - t_phase
    log(f"[variants-anyd] {checked} checks passed, {len(fails)} failed, in {checks_s:.1f} s")
    if fails:
        raise AssertionError(f"phase 30 (K3/K4 at any head dim): {len(fails)} failures: "
                             + "; ".join(fails[:40]))

    timed = {}
    for dname, dtype in dtypes.items():
        f32 = dtype == torch.float32
        rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)
        for name, shape in VARIANT_ANYD_TIMED:
            b, n, h, d = shape
            q, k, v = rand(shape), rand(shape), rand(shape)
            want = fa.flash_attention_plain(q, k, v, return_lse=True)
            # the path: one flash_forward(variant=...) call of each variant,
            # every count from 0
            for name_ in KERNELS:
                getattr(fa, name_).reset()
            errs, launches = {}, {}
            for variant, kern in kernels.items():
                errs[variant] = compare_flash(
                    fa.flash_forward(q, k, v, variant=variant, return_lse=True), want,
                    f"flash_forward(variant={variant!r}) {dname} {name} {shape}")
                launches[variant] = dict(kern.launches_by_kernel)
            others = {name_: dict(getattr(fa, name_).launches_by_kernel) for name_ in KERNELS
                      if name_ not in ("flash_fwd_resident", "flash_fwd_pipelined")}
            if (any(launches[v_] != {f"flash_{v_}_anyd": 1} for v_ in kernels)
                    or any(others.values())):
                raise AssertionError(f"flash_forward(variant=...) at {shape} {dname} launched "
                                     f"{launches}, others {others}")
            plain_ms = graph_ms(lambda: fa.flash_attention_plain(q, k, v), 3)
            qt, kt, vt = (x_.transpose(1, 2) for x_ in (q, k, v))
            sdpa_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
            anyd_ms = graph_ms(lambda: fa.flash_fwd(q, k, v), 20)
            nbytes = 4.0 * b * n * h * d * q.element_size()
            _, fma_ms = bound(4.0, b, n, h, d, nbytes, f32=True)
            by, ms_bound = (bound_3xtf32 if f32 else bound)(4.0, b, n, h, d, nbytes)
            # K4 computes S twice: 6 B H N^2 D of products in all
            _, floor_ms = bound(6.0, b, n, h, d, nbytes, f32=f32)
            for variant, kern in kernels.items():
                block = fa.key_block(variant, d)
                row = {"name": f"flash_{variant}_anyd/{name}", "route": "cuda",
                       "source": "pbe_tpu_torch/csrc/flash_variants_anyd.cu",
                       "replaces": K3 if variant == "resident" else K4, "dtype": dname,
                       "launches": launches[variant][f"flash_{variant}_anyd"],
                       "max_abs_err": errs[variant][0], "lse_max_abs_err": errs[variant][1],
                       "ms": graph_ms(lambda: kern(q, k, v), 20), "plain_ms": plain_ms,
                       "bound_ms": ms_bound,
                       "bound_by": "bytes" if by == "bytes" else "operations",
                       "library_ms": sdpa_ms, "block": block, "flash_fwd_anyd_ms": anyd_ms,
                       "run": f"phase 30: one flash_forward(variant={variant!r}) call at "
                              f"{shape}, {dname}"}
                if f32:
                    row["library"] = f"sdpa ({sdpa_backend(qt, kt, vt)})"
                timed[row["name"], dname] = row["ms"]
                before = VARIANT_ANYD_BEFORE_MS.get(row["name"]) if f32 else None
                log(f"[variants-anyd] {row['name']} {dname} (block {block}): {row['ms']:.4f} ms "
                    f"(graph" + (f"; before the redesign {before:.4f}" if before else "")
                    + f"), plain {plain_ms:.4f}, {row.get('library', 'sdpa')} "
                    f"{sdpa_ms:.4f}, flash_fwd_anyd {anyd_ms:.4f}, bound {ms_bound:.4f} by {by}"
                    + (f" (all-FMA {fma_ms:.4f})" if f32 else "")
                    + (f", S-twice floor {floor_ms:.4f}" if variant == "pipelined" else "")
                    + f" ({card})")
                rows.append(row)
            del q, k, v, qt, kt, vt, want
            torch.cuda.empty_cache()
    out = {"build": build, "checks": checked, "checks_s": checks_s,
           "ms": {f"{name} {dname}": ms for (name, dname), ms in timed.items()},
           "phase_s": time.perf_counter() - t_phase}
    log(f"[variants-anyd] phase 30 {out['phase_s']:.1f} s ({card})")
    return out


def seeded_checkpoint(pipe, zero_names: list[str], root: str) -> str:
    """The tensors randomize_zero_params changed, as a checkpoint in
    ``root`` for the CLIs of phases 21, 23, 24 and 25 (the rest is
    load_pipeline's seeded init)."""
    import torch

    ckpt = os.path.join(root, "seeded.ckpt")
    params = dict(pipe.model.named_parameters())
    torch.save({"state_dict": {n: params[n].detach().cpu() for n in zero_names}}, ckpt)
    return ckpt


ONLY = ("edit", "serving", "frozen-bf16", "frozen-int8", "test-split", "overfit", "legacy",
        "ddpm", "variants-anyd")


def run_only(only: list[str], card: str) -> dict:
    """``--only``: v1 with phase 4's random weights through the named
    phases -> their summaries (and the kernel rows they add)."""
    import torch

    from pbe_tpu_torch.pipelines.loading import load_pipeline, randomize_zero_params

    out, rows = {}, []
    frozen = [name.removeprefix("frozen-") for name in only if name.startswith("frozen-")]
    if {"edit", "serving", "test-split"} & set(only) or frozen:
        pipe, _ = load_pipeline("configs/v1.yaml", device="cuda")
        zero_names = [n for n, p in pipe.model.named_parameters() if not torch.any(p)]
        randomize_zero_params(pipe.model, seed=0)
        if "edit" in only:
            out["edit"] = phase_edit(pipe, card, [{"name": s[0]} for s in FLASH_SHAPES])
        if "serving" in only:
            out["serving"] = phase_serving(pipe, card, [])
        with tempfile.TemporaryDirectory() as root:
            ckpt = seeded_checkpoint(pipe, zero_names, root)
            del pipe
            torch.cuda.empty_cache()
            if frozen:
                out["frozen"] = phase_frozen(ckpt, card, frozen)
            if "test-split" in only:
                out["test_split"] = phase_test_split(ckpt, card, rows, {})
    if "overfit" in only:
        out["overfit"] = phase_overfit(card, rows, {})
    if "legacy" in only:
        out["legacy"] = phase_legacy(card, rows)
    if "ddpm" in only:
        out["ddpm"] = phase_ddpm(card, rows)
    if "variants-anyd" in only:
        out["variants_anyd"] = phase_variants_anyd(card, rows)
    if rows:
        out["kernels"] = rows
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Drive the port on one NVIDIA card.")
    parser.add_argument("--only", default="",
                        help=f"comma-separated phases of {ONLY} to run alone on v1 (see the "
                             f"module docstring); by default every phase runs")
    only = [name for name in parser.parse_args(argv).only.split(",") if name]
    if set(only) - set(ONLY):
        parser.error(f"--only takes {ONLY}, got {only}")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    try:
        import pbe_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the pbe_tpu_torch package is not next to this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from pbe_tpu_torch.scripts.bench_attention import card_line

    card = card_line()
    log(f"[env] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    if only:
        print(json.dumps({"only": run_only(only, card)}), flush=True)
        return 0
    phase_build()
    rows = phase_kernels()
    train_rows = phase_train_kernels()
    vae_rows = phase_vae_kernels()
    variant_rows = phase_variants()
    from pbe_tpu_torch.pipelines.loading import (eps_rms_probe, load_pipeline,
                                                 randomize_zero_params)

    t0 = time.perf_counter()
    pipe, _ = load_pipeline("configs/v1.yaml", device="cuda")
    zero_names = [n for n, p in pipe.model.named_parameters() if not torch.any(p)]
    randomize_zero_params(pipe.model, seed=0)
    torch.cuda.synchronize()
    log(f"[load] v1 built and initialized on the card in {time.perf_counter() - t0:.1f} s")
    rms = eps_rms_probe(pipe.model)
    log(f"[load] eps rms probe {rms:.4f} (must exceed 1e-3)")
    if not rms > 1e-3:
        raise AssertionError("eps is ~0: the zero-init heads were not randomized")
    phase_unet(pipe.model)
    edit = phase_edit(pipe, card, rows)
    cli_rows = []
    cli = phase_cli(pipe, zero_names, card, cli_rows)
    serve_rows = []
    serving = phase_serving(pipe, card, serve_rows)
    wait_late = start_builds(LATE_BUILDS)
    int8 = phase_int8(pipe, card)
    phase_profile(pipe.model)  # after the timed edits: the profiler slows the host
    seeded = tempfile.TemporaryDirectory()
    ckpt = seeded_checkpoint(pipe, zero_names, seeded.name)
    del pipe
    torch.cuda.empty_cache()
    model = build_v1_for_training()
    phase_unet_grad(model)
    train = phase_train(model, card, train_rows)
    del model
    torch.cuda.empty_cache()
    train_cli = phase_train_cli(card, train)
    evaluation = phase_eval(card)
    vae_train = phase_vae_train(card, vae_rows)
    torch.cuda.empty_cache()
    phase_reference()
    phase_train_reference()
    phase_vae_train_reference()
    phase_reference_samplers()
    # the forward kernel's rows timed above, by shape (bf16)
    measured = {shape: row for shapes, shape_rows in ((FLASH_SHAPES, rows),
                                                      (CLI_SHAPES, cli_rows),
                                                      (SERVE_SHAPES, serve_rows))
                for (_, shape, *_), row in zip(shapes, shape_rows)}
    # needs no late build: it runs while flash_fp32.cu may still build
    overfit_rows = []
    overfit = phase_overfit(card, overfit_rows, measured)
    wait_late()
    f32_rows = phase_fp32_kernels()
    variant_rows += phase_variants_f32()
    precision_full = phase_precision_full(ckpt, card, f32_rows)
    phase_fp32_reference()
    long_rows = []
    tiling = phase_tiling(ckpt, card, long_rows)
    safety = phase_safety(ckpt, card)
    frozen = phase_frozen(ckpt, card)
    slice_rows = []
    test_split = phase_test_split(ckpt, card, slice_rows, measured)
    seeded.cleanup()
    slice_rows += overfit_rows
    legacy = phase_legacy(card, slice_rows)
    ddpm = phase_ddpm(card, slice_rows)
    variants_anyd = phase_variants_anyd(card, slice_rows)
    log(f"[clock] every phase done at {time.perf_counter() - _START:.1f} s (limit 1200 s)")
    log(f"[edit] summary {json.dumps(edit)}")
    log(f"[train] summary {json.dumps(train)}")
    log(f"[train-cli] summary {json.dumps(train_cli)}")
    log(f"[cli] summary {json.dumps(cli)}")
    log(f"[serve] summary {json.dumps(serving)}")
    log(f"[int8] summary {json.dumps(int8)}")
    log(f"[eval] summary {json.dumps(evaluation)}")
    log(f"[vae-train] summary {json.dumps(vae_train)}")
    log(f"[fp32] summary {json.dumps(precision_full)}")
    log(f"[tiling] summary {json.dumps(tiling)}")
    log(f"[safety] summary {json.dumps(safety)}")
    log(f"[frozen] summary {json.dumps(frozen)}")
    log(f"[test-split] summary {json.dumps(test_split)}")
    log(f"[overfit] summary {json.dumps(overfit)}")
    log(f"[legacy] summary {json.dumps(legacy)}")
    log(f"[ddpm] summary {json.dumps(ddpm)}")
    log(f"[variants-anyd] summary {json.dumps(variants_anyd)}")
    kernels = (rows + train_rows + vae_rows + variant_rows + cli_rows + serve_rows + f32_rows
               + long_rows + slice_rows)
    for row in kernels:
        row.setdefault("dtype", "bfloat16")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
