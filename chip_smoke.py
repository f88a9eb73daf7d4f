#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device — the card's name and power limit, as nvidia-smi gives them;
2. build — the kernels built from this checkout's sources (one nvcc per
   CUDA source, all started together; the Triton one compiled by its
   first launch), timed; ptxas's registers and spills of each bf16 and
   float32 ``flash_attention`` instance, with its dynamic shared memory;
3. kernels — each step kernel held against its plain PyTorch version on
   the card at the serving shapes (S ∈ {8, 32} lanes of 128x128x1, f32 and
   bf16): inactive lanes bitwise, active lanes within the stated bound;
   kernel and plain-version device times with a cold L2 (held against the
   bound), the kernel's with a warm L2, and its eager call time.  Then
   ``flash_attention`` against ``attention_ref`` at one Yi-6B layer's
   prefill shape (q 4x2048x32x128, k and v 4x2048x4x128), causal in bf16
   and f32 and with a 1024 window, with its time, the plain version's, the
   bound (for f32 both the SIMT and the 3xTF32 one, the share against the
   latter), the FLOP it executes in whole tiles beside the visible ones,
   and ``scaled_dot_product_attention``'s time, timed in turns with the
   kernel; and at the Zamba2-7B shared block's shape (q, k, v
   4x2048x32x112, causal, bf16 and f32); the f32 time beside the SIMT
   design's before it.
   Then ``ssm_scan`` against ``ssm_scan_ref`` at one Zamba2-7B Mamba2
   layer's prefill shape (x 4x2048x112x64, N 64; float32 as
   ``ssm_forward`` feeds it, and bf16 x with float32 dt), two calls bitwise
   equal, with ptxas's registers and spills, its grid, rounds of the SMs
   and shared memory, its time beside the earlier design's, the plain
   version's, and the bounds on the float32 units and in 3xTF32;
4. slice — the paper U-Net (random weights from a seed) serving 8 requests
   through ``ServeEngine.serve()`` with each step backend: finite outputs,
   backends agree, each kernel launched on its own run, one lane replayed
   by ``split_sample_lane``, window depth k=4 against k=1, throughput;
4b. train — CollaFuse split training of the paper U-Net at full width
   (``UNetConfig()``, cosine T = 100, c = 0.8, 3 clients of 16 synthetic
   images, lr 1e-3, clip 1.0; random initial weights from a seed): (a) the
   batched trainer, a warm-up round and 8 timed rounds, each round's server
   and mean client loss, wall time and step times (CUDA events), the
   steps' rate against the f32 peak (3x ``flops_per_image`` an image),
   peak memory, a profiled round; the losses must fall; with obs on, one
   ``train_round`` span a round and the loss gauges equal to the losses
   (phase 4e (d)); (b) the looped
   trainer from the same models and draws: round 0's losses against (a)'s
   within the CPU tests' tolerance, its round and step times and memory;
   (c) one round at ``reduced()`` on the card and on the CPU: losses and
   parameters within the stated bounds; (d) ``trainer.sample`` through
   ``ddpm_step``; (e) each client's disclosed x at the cut against its
   real images: MSE and KID; (f) the trained server and 3 client models
   served through ``ServeEngine.serve()`` on phase 4's request mix
   (client i % 3) with each backend, backends agreeing, each kernel
   launched;
4c. guide — guided and gated serving at full width: the paper U-Net with
   a 4-class label embedding (random weights from a seed), the reference
   ``cfg_guidance`` gate's menu at T = 100 (DDPM, DDIM K = 20, their w = 0
   twins, DDPM w = 1.5, DDIM w = 2.0), cuts {0.5, 0.75}, 8 slots, k = 4,
   a KID gate calibrated on 16 synthetic 128x128 images: (a) each
   sampler's KID profile to its deepest nominal cut (one chain each, its
   time and U-Net calls), the w = 0 twins' bitwise the unguided ones, the
   floor; (b) w = 0 twins against unguided traffic, completions and
   decisions bitwise; (c) mixed guided and unguided traffic through each
   backend: finite, agreeing, each kernel launched, every shadow lane
   bitwise its primary at retirement, one ``traj_masked_step`` launch a
   tick; (d) every served KID above the floor, a fresh policy's decisions,
   an all-rejecting floor; (e) k = 4 against k = 1, bitwise; (f) guided
   against unguided ticks/s and images/s ungated, server FLOPs exactly 2x,
   the combine's device time inside a tick (eager windows); (g) the
   launcher, guided and gated;
4d. host — the serving engine's host path at full width (phase 4's U-Net,
   8 slots, k = 4, lane noise drawn on the card): (a) one window staged by
   hand, run eagerly and as a captured CUDA graph replayed on the same
   inputs, bitwise, and ms a tick of each; (b) the ``lane_noise`` kernel
   against its plain version at S = 8 and 32, bitwise on the card and on
   the CPU, cold and warm device times, the plain version's, its bound and
   an empty kernel's time; (c) phase 4's traffic on DDIM K = 20 served with
   async_depth 1 and 2 x drain, stream (finish_async_depth 1 and 2), each
   bitwise the synchronous drain run, ticks/s, images/s, overlap_frac, the
   the finisher's lane ticks, and the device's busy share
   (``torch.profiler``) of the first and the last;
   (g) launches counted through replays (one step and one draw a tick, one
   draw and one copy a window) and the device's busy share over a served
   run (``torch.profiler``) at async_depth 2 and 1; (f) k = 1 against
   k = 4, bitwise; (e) a sampler registered into spare columns bitwise the
   static menu's, no new capture; (d) guided against unguided ms a tick on
   one engine with graphs;
4e. obs — wave packing and the observability stack at full width (phase
   4d's engine at async_depth 2): (a) the reference ``hetero_packing``
   gate's mix scaled to 8 slots and 12 requests (batch-8 dense DDPM heads
   at cut 0.2 between batch-1 DDIM fillers, one sampler in spare columns)
   served pack off and pack on after a warm-up: x_mid bitwise, no new
   capture, one step a tick and k + 1 draws a window, ticks and every
   admit and retire tick equal to the same mix served on the CPU by a
   small U-Net; ticks, wall, images/s, ``fragmentation_frac`` and
   occupancy by class of each; (b) phase 4d (c)'s traffic streamed, obs
   off and on in turns: bitwise, captures and copies a window unchanged,
   ticks/s within 5 %, the trace valid with one ``dispatch`` span a
   window, timelines in stage order, the registry's JSON-lines, and each
   span's total host ms; (c) ``torch.profiler`` over each serve's first 4
   windows: bitwise, and both profiles name ``traj_masked_step`` and
   ``lane_noise``; its (d), one ``train_round`` span a round and the loss
   gauges, runs inside phase 4b's trainer;
4f. paper — the paper's healthcare experiment at its own batch, at full
   width (phase 4b's U-Net and protocol, f32 without TF32): (a) one
   batched round at 16 images a client in one piece and in chunks of 16
   under the allocator's history: each step's peak split into the
   parameters and AdamW state, one chunk's activations, the gradients and
   the rest (cuDNN workspace and temporaries), the blocks live at the
   peak, the largest allocation, and the reserved-but-free bytes; (b)
   round 0 in chunks of 5 (ragged) on both engines against the
   unchunked round from the same models and draws: losses within phase
   4b's tolerance, parameters within the card-against-CPU bound; (c) 150
   images a client (pooled 450) in chunks of 32, a warm-up and a timed
   round on the looped engine (and the batched one when the phase's
   budget allows): round and step ms, images/s, TFLOP/s against 67, peak
   memory under the card's, finite losses; (d) the trained trainer saved
   and restored into a fresh one, state bitwise, its ``trainer.sample``
   through ``ddpm_step`` bitwise the original's, and the restored models
   serving phase 4's mix on ``cuda_masked`` bitwise the originals'; (e)
   ``collafuse_healthcare.evaluate`` on 8 images a client: KID against
   train and holdout, disclosure MSE and KID; (f) ``cut_ratio_sweep`` at
   its default size, cuts {0, 0.8, 1}: the client FLOP share monotone in
   c and all the client's at c = 1;
4g. pod — pod mode as two host processes on the one card, joined by a
   gloo group (run before 4f, with the parent's cache emptied before each
   child): (a) two ``repro_torch.launch.pod_smoke`` processes (8 slots, 7
   requests, ``--clients 3 --pack --trace-out``) in stream and two in
   drain mode, all four at once: each mode's union of their owned rows
   (x_mid and x0) bitwise the in-process single host's artifact, retire ticks equal, guided pairs
   across the two blocks, the merged trace one pid a host; (b) the paper
   U-Net with 4 classes (random weights from a seed), T = 100, DDPM, DDIM
   K = 20 and guided DDPM (w 1.5), 8 slots, k = 4, async_depth 2, 6
   requests, served by ``serve_diffusion --devices 2 --mesh-shape 2x1``
   against ``--devices 1`` in this process: the union's difference from
   the single host (or, where a lane's bits follow the model call's width,
   within the stated tolerance), each pod host's measured serve bitwise
   its warm-up serve of the same requests, retire ticks equal, each
   host's ms a tick, images/s, kernel launches, halo lanes and peak
   memory, and the pod's images/s against the single host's;
4h. model_serve — the U-Net's model axis: the paper U-Net (random
   weights from a seed), DDIM K = 20, 6 requests at cuts 0.5 and 0.75 on
   8 slots, k = 4, one client, served by ``serve_diffusion --devices 2 --mesh-shape 1x2`` (a
   pod host over two model ranks, each convolving half of every
   convolution's output channels; eager windows, said on its first line)
   against ``--devices 1`` in this process: completions bitwise across the
   two model ranks, each rank's measured serve bitwise its warm-up, the
   rows within the stated tolerance of the single host, retire ticks
   equal, ``traj_masked_step`` and ``lane_noise`` launched; ms a tick and
   the collectives a tick;
5. LM slice — Yi-6B at full width and depth in bf16 (random weights from a
   seed): (a) prefill of 4x2048 tokens through the flash kernel, 32
   launches a call, timed and profiled; (b) the same batch through
   blockwise PyTorch attention, logits within the stated tolerance;
   (c) 64 chained cached decode steps against (a)'s logits; (d) the
   serving launcher at full width;
6. hybrid slice — Zamba2-7B at full width and depth in bf16 (81 Mamba2
   layers, the shared attention block 14 times; random weights from a
   seed): (a) prefill of 4x2048 tokens through the kernels, ``ssm_scan``
   81 and ``flash_attention`` 14 launches a call, timed and profiled;
   (b) the same batch through ``kernel="torch"`` (the chunk loop and
   blockwise attention), logits within the stated tolerance, and each
   block alone over 16 decode steps; (c) 16 chained cached decode steps
   against (a)'s logits; (d) the serving launcher at full width;
7. moe — the MoE family at full width, depth cut (bf16, random weights
   from a seed): DeepSeek-V2 (MLA, 160 experts top-6, 2 shared) at 4
   layers and Kimi-K2 (GQA 64/8, 384 experts top-8, 1 shared) at 2, each
   printed with its reduced depth.  For each: (a) prefill of 4x2048 tokens
   (2x2048 when a 1-row probe says the peak would pass 75 GB), timed,
   TFLOP/s, peak memory, profiled, the share of assignments dropped at
   capacity_factor 1.25, the first MoE layer's time split into router and
   dispatch, the expert products, the combine and the shared experts (CUDA
   events); ``flash_attention`` launched once a layer for Kimi-K2, never
   for MLA; (b) that MoE layer on (a)'s hidden states against a per-expert
   loop sharing no code with the capacity buffer: kept and dropped counts
   equal, outputs within the stated bound; for Kimi-K2 also the prefill
   through ``kernel="torch"``: the share of routing decisions that agree
   held to a floor, the logits' mean |Δ| to a bound; (c) 64 chained decode
   steps at batch 1 against the dropless prefill of the same tokens, ms a
   step and the device's launches a step; (d) the serving launcher on each
   reduced member and ``examples/serve_decode`` on DeepSeek-V2's;
8. families — the last three LM families at full width and depth (bf16,
   random weights from a seed): Qwen2-VL-2B (M-RoPE, 256 vision
   embeddings drawn at the embedding table's scale before 1792 text
   tokens), MusicGen-large (cross-attention to 64 conditioning
   embeddings) and xLSTM-125M (9 mLSTM and 3 sLSTM blocks).  For each:
   (a) prefill of 4x2048 positions, timed, TFLOP/s, peak memory,
   profiled (xLSTM's at 4x256), ``flash_attention`` launched once a layer
   (28, 48; never for xLSTM), and for xLSTM the sLSTM loops' share of the
   prefill (CUDA events around each); (b) for the attention families the
   same batch through ``kernel="torch"``, logits within Yi's bounds;
   (c) 16 chained decode steps at batch 1 against the forward: Qwen2-VL's
   text (pos on all three streams) against the same weights' forward as
   family "dense" with the same sections, MusicGen's with each layer's
   ``cross_kv`` filled from the conditioning, xLSTM's against its prefill
   and, in a float32 twin, 512 steps of the recurrence against the
   chunked form; ms and launches a step; (d) ``flash_attention`` against
   ``attention_ref`` at q 4x2048x12x128 with KV 2 and at 4x2048x32x64
   MHA, bf16, with its time, the plain version's, the bound and SDPA's in
   turns; (e) the serving launcher on each at full size;
9. lm_train — LM training through ``make_train_step`` (``lm_loss`` with
   ``kernel="torch"``: the kernels have no backward; autograd; the
   in-place ``apply_updates_``), after the earlier phases' memory is
   released (printed): (a) MiniCPM-2B at full width and depth in bf16
   (random weights from a seed), 10 steps of ``token_batches`` at 4 x 512
   (2 x 512 when a 1-row probe says the peak would pass 75 GB), lr 3e-4:
   the loss falls first to last; step ms (CUDA events), tokens/s, TFLOP/s
   against 989 (3x the forward's matmul FLOP), peak memory split into
   parameters and moments, gradients and the rest, ``apply_updates_``'s
   ms (CUDA events), the device's busy share over 3 profiled steps and
   its top kernels; (b) Qwen2-VL-2B, 8 steps on one batch of 4 x (256
   stubbed vision embeddings + 256 text tokens): the text region's loss
   finite and falling on that batch; (c) every LM arch at ``reduced()`` in float32 (TF32 off): the
   loss and every gradient on the card against the CPU from the same
   weights and batch (the CPU parity tolerances), ``remat`` against the
   plain step, ``apply_updates_`` bitwise ``apply_updates`` on the card,
   ``lm_loss(kernel="flash")`` raising under autograd where the forward
   reaches a kernel; (d) ``launch/train.py`` on MiniCPM-2B at full size (8
   steps at 4 x 256, "done: loss"), then at ``reduced()`` 6 steps saved
   and 6 resumed: the restored parameters and moments bitwise the saved
   ones, and the resumed run against 12 straight steps (printed);
10. mesh (run right after phase 3 in a process of its own, while the
   card is empty) — two ranks (``launch/mesh.py``'s ``run_ranks``), on the one
   card ("gloo+ipc": payloads through CUDA IPC, gloo's barriers; NCCL
   where the machine has a card a rank), the transport printed: (a) Yi-6B at full width and depth, 4 x 2048, mesh
   1x2: each rank's share of the weights, ``flash_attention``'s launches
   at the local 16 heads and 2 KV heads, the prefill's ms and the
   collectives' calls, bytes and ms, the logits against one
   rank's prefill of the same weights; (b) DeepSeek-V2 at phase 7's depth
   on 1x2 (80 experts a rank): the 4 x 2048 prefill through the
   all-to-all path and batch-1 decode through the replicated one, held on
   rank 0 against ``moe_local`` with the whole model's weights of the same
   seed on each shard's block of tokens at the block's capacity: each
   shard's kept and dropped assignments (a decode step's summed over the
   ranks) equal, a layer of each path within phase 7's bounds; the
   all-to-all layer's ms by part; (c) MiniCPM-2B at full width with FSDP on
   2x1, 2 x 256 tokens a rank, 2 steps: the first step's loss and grad
   norm against one rank's step on the global batch, the loss falling,
   each rank's state (half the one-rank state), gradients, the rest and
   peak, the step ms; (d) the serving launcher on Yi-6B at full size on
   1x2 and the training launcher on 2x1 with ``--fsdp``; (e) Zamba2-7B at
   full width and depth on 1x2 (56 Mamba2 heads and 16 attention heads a
   rank, the conv cache [x_r, B, C]): the 4 x 2048 prefill's launches
   (``ssm_scan`` 81, ``flash_attention`` 14 a rank), ms and collectives,
   2 decode steps against it, the logits against one rank's prefill of
   the same weights, one Mamba2 layer in float32 sharded against whole,
   and ``ssm_scan`` and ``flash_attention`` at the rank's shapes against
   their plain versions; (f) xLSTM-125M on 1x2 (2 mLSTM heads a rank, the
   sLSTM on both), 4 x 256 and 2 decode steps, checked the same way; (g)
   one train step of Zamba2 and xLSTM at ``reduced()`` on 1x2 against one
   rank's: the loss and every leaf's gradient; and 4i, the CollaFuse
   trainer on 2x1 (``CollaFuseTrainer(mesh=)``: the paper U-Net, 4
   clients of 8 images, 2 rounds, a block of client stacks and of the
   pooled server batch a rank) against the one-process trainer: round 0's
   losses and the parameters within the stated bounds, the server's the
   same bits on both ranks, the round ms and collectives, and
   ``trainer.sample`` through ``ddpm_step`` against the plain step;
11. roofline — the dry run (``launch/dryrun.py``: one rank's step on the
   meta device under the work counter, a dry mesh recording the
   collectives) held against the card: (a) Yi-6B's prefill of phase 5 (a)
   (4 x 2048, the kernel) dry on a 1x1 mesh against the same counter over
   a real prefill on the card: FLOPs, bytes, ops and kernel units equal
   exactly; its roofline terms beside phase 5 (a)'s ms; (b) the dry run's
   argument + temp bytes against that prefill's
   ``torch.cuda.max_memory_allocated`` within the stated tolerance; (c)
   phase 10 (a)'s prefill on 1x2, dry, each rank's collectives' calls and
   bytes equal to the rank's in phase 10; (d) every arch x ``prefill_32k``
   on 32 nodes of 8 cards with probes, in worker processes on the host
   started before phase 10 (they need no card): the terms, the dominant
   one and the argument bytes a card against 80 GB.

It then prints the kernels' JSON line, and last the device line.  It exits
non-zero, without the last line, when CUDA is absent or any phase fails.
Imports nothing of ``jax`` and nothing of the JAX package.
"""
import contextlib
import dataclasses
import functools
import gc
import hashlib
import io
import itertools
import json
import math
import multiprocessing as mp
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import (InputShape, UNetConfig,  # noqa: E402
                                 get_config, list_archs)
from repro_torch.core.collafuse import (CutPlan, lane_philox,  # noqa: E402
                                        split_sample_lane)
from repro_torch.core.privacy import (disclosure_report,  # noqa: E402
                                      feature_params)
from repro_torch.core.trainer import (CollaFuseTrainer,  # noqa: E402
                                      TrainerConfig, member_seed)
from repro_torch.data.synthetic import (ClientDataConfig,  # noqa: E402
                                        image_batches, make_client_datasets,
                                        token_batches)
from repro_torch.diffusion.backend import get_backend  # noqa: E402
from repro_torch.diffusion.sampler import make_sampler  # noqa: E402
from repro_torch.diffusion.schedule import cosine_schedule  # noqa: E402
from repro_torch.examples import collafuse_healthcare as hc  # noqa: E402
from repro_torch.examples import cut_ratio_sweep  # noqa: E402
from repro_torch.examples import serve_decode  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ddpm_step as kds  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import lane_noise as kln  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import ssm_scan as kssm  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.launch import serve_diffusion as sd_launch  # noqa: E402
from repro_torch.launch.counter import WorkCounter  # noqa: E402
from repro_torch.launch.mesh import (HBM_BW, close_mesh,  # noqa: E402
                                     init_mesh, run_ranks, transport_for)
from repro_torch.launch.steps import (make_ctx, make_decode_step,  # noqa: E402
                                      make_prefill_step, make_train_step)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.models.unet import UNet, flops_per_image  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.launch import pod_smoke  # noqa: E402
from repro_torch.obs import (STAGES, load_trace, merge_traces,  # noqa: E402
                             read_jsonl, validate_events)
from repro_torch.serve import (AdmissionPolicy, EngineConfig,  # noqa: E402
                               ObsConfig, Request, ServeEngine,
                               make_scheduler)
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.parallel.comm import Mesh  # noqa: E402
from repro_torch.serve import engine as serve_engine  # noqa: E402

# Published H100 rates (NVIDIA data sheets; dense, no sparsity): memory
# bandwidth, float32 rate outside the tensor cores, bf16 tensor-core rate.
CARD_RATES = {"SXM": (3.35e12, 67e12, 989e12),
              "PCIe": (2.0e12, 51e12, 756e12)}
TF32_RATES = {"SXM": 495e12, "PCIe": 378e12}   # dense TF32 tensor cores
CUDA_SOURCES = ("traj_masked_step", "flash_attention", "ssm_scan",
                "lane_noise")
# one Yi-6B layer's prefill: q (B, S, H, hd), k and v (B, S, KV, hd)
ATTN_SHAPE = (4, 2048, 32, 4, 128)
# Zamba2-7B's shared attention block at the same prefill (MHA, hd 112)
HYBRID_ATTN_SHAPE = (4, 2048, 32, 32, 112)
# one Zamba2-7B Mamba2 layer's prefill: x (B, S, nh, P), bm and cm (B, S, N)
SSM_SHAPE = (4, 2048, 112, 64, 64)
# the device kernels each wrapper launches, as a profiler names them
KERNEL_SYMBOLS = {"ssm_scan": ("ssd_scan_kernel", "ssd_gram_kernel"),
                  "flash_attention": ("flash_attention",)}
SSM_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}  # test_kernels.py,
#                                        relative to the plain version's max
# ssm_scan's float32 time at SSM_SHAPE before the Hopper redesign (the
# SIMT kernel; NVIDIA H100 80GB HBM3, 700 W; PERF.md's kernel table)
SSM_EARLIER_MS = 1.507
ATTN_WINDOW = 1024
# flash_attention's float32 time, causal, at ATTN_SHAPE (hd 128) and at
# HYBRID_ATTN_SHAPE (hd 112) before the 3xTF32 redesign (the SIMT kernel;
# NVIDIA H100 80GB HBM3, 700 W; PERF.md's kernel table)
ATTN_F32_EARLIER_MS = {128: 4.723, 112: 5.458}
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # test_kernels.py
# Yi-6B logits in bf16, prefill through the kernel against blockwise
# PyTorch attention and against the cached decode chain.  Logits of these
# random weights have std ~1 and reach ~6, where a bf16 ulp is 2^-5.  The
# paths round at different points (the kernel rounds p to bf16 inside its
# tiles, blockwise per 2048-chunk, decode per step; sums run in other
# orders; decode's GEMMs have other shapes), compounded over 32 layers.  A
# CPU proxy (Yi's width, 16 layers, 256 tokens, bf16) differs by 0.084 at
# most and 0.012 on average; an H100 by 0.11 and 0.016.  Held: max |Δ| <=
# 0.25 (8 ulps at the top) and mean |Δ| <= 0.03; a wrong mask or a wrong
# cache slot moves the mean by tenths.
LM_TOL_MAX, LM_TOL_MEAN = 0.25, 0.03
# Zamba2-7B in bf16, random weights.  The kernels' prefill against plain
# PyTorch's (the chunk loop, blockwise attention) and against the cached
# decode chain.  Each block alone differs from its other path by a bf16
# rounding here and there, but 81 Mamba2 layers of random weights amplify
# such differences: a CPU proxy at Zamba2's width (bf16, B 1, S 128, 64
# decode steps; the kernels' plain versions on the "flash" path) grew the
# mean |Δlogit| by ~0.0056 a layer, flash vs torch 0.030 / 0.134 / 0.268
# at 6 / 24 / 48 layers (decode vs prefill 0.036 / 0.175 / 0.330), the max
# to 2.3 (2.8) at 48 layers, with logits of std 0.99 and max ~5.5; at
# S 1024 the mean was the same (0.065 at 12 layers) and the max larger.
# So at 81 layers the end-to-end mean is expected near 0.45 (decode 0.5;
# an H100 gave 0.447 and 0.361), against ~1.04 between unrelated logits
# (neighbouring positions): it is held to mean |Δ| <= 0.6; the max, a tail
# of the chaos, is printed, not held.  Each block is also held alone,
# teacher-forced on the kernels' path, on its own output before the
# residual add (``block_gaps``), and its decode through decode_step's own
# chain at full depth: the proxy's worst block (36 layers, 42 blocks)
# differed by max |Δ| 0.0051 of the block's max |out| and mean 0.0021 of
# its mean |out| (its decode 0.0191 and 0.0053); held: 2^-4 and 2^-6.  On
# the CPU at reduced size, a 5 % error in the flash mixing reads 0.090 and
# 0.024, and one KV cache shared by the shared block's applications reads
# a decode mean of 1.3.
HYBRID_TOL_MEAN = 0.6
# (b') and (c)'s chained decode steps (64 before the model-axis phases
# and 32 until a run on a slower host took 1,188 s of the script's 1,200)
HYBRID_DECODE_STEPS = 16
BLOCK_TOL_MAX, BLOCK_TOL_MEAN = 2.0 ** -4, 2.0 ** -6
# phase 4b: CollaFuse split training of the paper U-Net (its §4 setup: cosine
# T = 100, c = 0.8, 3 clients, lr 1e-3, grad clip 1.0), 16 images a client
# in one piece (48 pooled; the allocator's peak reaches 62 GB of an H100's
# 80 in f32, PERF.md); phase 4f trains the paper's 150 a client in chunks.
TRAIN_CLIENTS, TRAIN_CUT, TRAIN_BATCH, TRAIN_ROUNDS = 3, 0.8, 16, 8
# batched against looped on the card: the CPU tests' loss tolerance
# (tests/test_torch_train.py)
TRAIN_LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
# the card against the CPU, one round at reduced(): the losses of round 0
# depend only on the shared weights and draws, but cuDNN may pick FFT or
# Winograd convolutions, whose f32 error exceeds a direct sum's: rtol 1e-4.
# AdamW's first step moves each parameter by ±lr by its gradient's sign, so
# a gradient near 0 can put one entry 2·lr apart: every entry within
# 2.002·lr, each model's mean |Δ| within 1 % of lr (tests/test_torch_cuda.py)
CPU_LOSS_RTOL = 1e-4
TRAIN_PARAM_MAX, TRAIN_PARAM_MEAN = 2 * 1.001 * 1e-3, 1e-5
T = 100
IMG = (128, 128, 1)
# bytes one pass of a cold-L2 timing moves: over 5x the H100's 50 MB L2
COLD_BYTES = 256 << 20


def card_rates(name: str):
    return CARD_RATES["PCIe" if "PCIe" in name else "SXM"]


def cuda_time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back eager calls, between
    CUDA events, after ``warmup`` calls.  For a short kernel this is the
    host's launch rate, not the device time (see :func:`graph_time_ms`)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_time_ms(fn, arg_sets, replays: int) -> float:
    """Device time of one call: ``fn(*args)`` for each ``args`` of
    ``arg_sets`` in turn, captured in one CUDA graph (outputs kept alive,
    so each call writes fresh memory), the graph replayed ``replays`` times
    between CUDA events.  No host launch cost is left in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*args) for args in arg_sets]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (len(arg_sets) * replays)
    del graph, outs
    return ms


def warm_time_ms(fn, args) -> float:
    """Device time of one ``fn(*args)`` with its inputs resident in L2:
    50 calls on the same inputs, as in the engine tick, where the model has
    just written ε̂.  Reads below ``bound_ms`` are possible here."""
    return graph_time_ms(fn, [args] * 50, replays=20)


def cold_time_ms(fn, args) -> float:
    """Device time of one ``fn(*args)`` with a cold L2, the time held
    against ``bound_ms``: the tensor arguments are cloned into as many sets
    as make one pass over them and their outputs move more than
    ``COLD_BYTES``, and each call of the graph takes the next set, so every
    call reads its inputs from device memory.  The median of three graphs
    captured on the copies: now and then one reads ~0.35 us low for a 3 us
    kernel on an H100, most often a process's first (PERF.md)."""
    out = fn(*args)
    per_set = out.numel() * out.element_size() + sum(
        a.numel() * a.element_size() for a in args if torch.is_tensor(a))
    n = max(8, -(-COLD_BYTES // per_set))
    sets = [[a.clone() if torch.is_tensor(a) else a for a in args]
            for _ in range(n)]
    ms = sorted(graph_time_ms(fn, sets, replays=5) for _ in range(3))[1]
    del sets
    torch.cuda.empty_cache()
    return ms


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------
def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}", flush=True)
    print(line, flush=True)
    return line


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def phase_build(dev) -> None:
    def timed_build(name):
        t0 = time.perf_counter()
        return build.build(name, verbose=True), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:    # one nvcc each
        built = list(pool.map(timed_build, CUDA_SOURCES))
    for name, (lib, t_cuda) in zip(CUDA_SOURCES, built):
        extra = "".join(" " + f for f in build.SOURCE_FLAGS.get(name, []))
        print(f"[build] {name}: nvcc{extra} -> {lib.relative_to(ROOT)} in "
              f"{t_cuda:.1f}s", flush=True)
    print(f"[build] CUDA sources built in parallel in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    instances = ptxas_attention(build.LOGS.get("flash_attention", ""))
    if not instances:
        print("[build] flash_attention: library already built, no ptxas "
              "output to show", flush=True)
    regs_split = {"bf16": "producer 24, consumers 240",
                  "f32": "producers 88, consumers 168"}
    smem = {"bf16": kfa.bf16_smem_bytes, "f32": kfa.f32_smem_bytes}
    for kind, hd, regs, spills in instances:
        print(f"[build] flash_attention {kind} kernel, hd {hd}: {regs} "
              f"registers at launch (setmaxnreg: {regs_split[kind]}), "
              f"{spills}, {smem[kind](hd)} bytes of dynamic shared memory",
              flush=True)
    t0 = time.perf_counter()
    for dt in (torch.float32, torch.bfloat16):
        x = torch.zeros((8,) + IMG, dtype=dt, device=dev)
        coefs = torch.zeros((8, 4), device=dev)
        ops.ddpm_step(x, x, x, coefs)
        ops.traj_masked_step(x, torch.zeros(8, dtype=torch.int32, device=dev),
                             x, x, torch.ones(8, dtype=torch.bool, device=dev),
                             torch.ones((5, 4), device=dev))
    lane = torch.zeros(8, dtype=torch.int64, device=dev)
    ops.lane_noise(lane, lane, lane, lane == 0, 1, IMG)
    torch.cuda.synchronize()
    print(f"[build] ddpm_step: triton compile + first launches (f32, bf16) "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)


def ptxas_attention(log: str):
    """(kind, hd, registers, spill line) of each flash_attention instance,
    kind "bf16" or "f32", in ``nvcc -Xptxas -v``'s output."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"flash_attention_(bf16|f32)_kernelILi(\d+)E", ln)
        if m and "Compiling entry function" in ln:
            cur = (m.group(1), int(m.group(2)))
        elif cur is not None and "spill" in ln:
            spills = ln.split(":", 1)[-1].strip()
        elif cur is not None and "Used" in ln:
            rows.append(cur + (int(re.search(r"Used (\d+) registers",
                                             ln).group(1)), spills))
            cur = None
    return rows


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def kernel_inputs(S: int, dtype, dev, tables):
    """Lanes hitting the edges of the concatenated table (dense T=100 +
    DDIM K=20 eta=0.3): lane 0 the DDIM column 0 (ar ≈ 4e-5), lane 1 the
    first dense column, lane 2 the last dense column (keep = 0); every
    fourth lane inactive, some with out-of-range columns."""
    g = torch.Generator().manual_seed(1234 + S)
    C = tables.shape[1]
    cols = torch.randint(0, C, (S,), generator=g, dtype=torch.int32)
    cols[:3] = torch.tensor([T, 0, T - 1], dtype=torch.int32)
    active = torch.ones(S, dtype=torch.bool)
    active[3::4] = False
    cols[3] = -7
    cols[7] = C + 50
    x = (1.5 * torch.randn((S,) + IMG, generator=g)).to(dtype)
    eps = torch.randn((S,) + IMG, generator=g).to(dtype)
    z = torch.randn((S,) + IMG, generator=g).to(dtype)
    return [t.to(dev) for t in (x, cols, eps, z, active)]


def lane_bound(tables, cols, dtype, plain):
    """Per-element bound of |kernel − plain| on active lanes: 4 f32 ulp of
    the value, times max(1, 1/√ar) for the division's amplification; in bf16
    plus one bf16 ulp (the two f32 results may round to neighbours)."""
    ar = tables[1, torch.clamp(cols.long(), 0, tables.shape[1] - 1)]
    amp = torch.clamp(torch.rsqrt(ar), min=1.0).reshape(-1, 1, 1, 1)
    mag = plain.float().abs() + 1.0
    bound = 4 * 2.0 ** -23 * mag * amp
    if dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * mag
    return bound


def check_pair(name, out, ref, x, active, bound):
    """Inactive lanes bitwise equal to x; active lanes within ``bound``.
    Returns (max abs err on active lanes, bitwise on active lanes)."""
    inact = ~active
    if inact.any():
        same = torch.equal(out[inact].view(torch.int16 if out.dtype ==
                                           torch.bfloat16 else torch.int32),
                           x[inact].view(torch.int16 if x.dtype ==
                                         torch.bfloat16 else torch.int32))
        if not same:
            raise AssertionError(f"{name}: inactive lanes not bit-unchanged")
    a = active
    diff = (out[a].float() - ref[a].float()).abs()
    if not torch.isfinite(out[a]).all():
        raise AssertionError(f"{name}: non-finite output")
    bad = diff > bound[a]
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond the "
                             f"bound (max err {float(diff.max()):.3e})")
    return float(diff.max()), bool(torch.equal(out[a], ref[a]))


def kernel_tables(dev):
    """The (5, 120) table phase 3 steps from: dense DDPM T=100, then DDIM
    K=20 eta=0.3, as the engine concatenates its menu."""
    sched = cosine_schedule(T)
    return torch.cat([make_sampler(T).tables(sched),
                      make_sampler(T, "ddim", 20, eta=0.3).tables(sched)],
                     dim=1).to(dev)


def phase_kernels(dev, card: str):
    bw, f32_peak, _ = card_rates(card)
    tables = kernel_tables(dev)
    C = tables.shape[1]
    print(f"[kernels] table (5, {C}): dense DDPM T={T} + DDIM K=20 eta=0.3; "
          f"DDIM column 0 ar={float(tables[1, T]):.3e}", flush=True)
    rows = {}
    for S in (8, 32):
        for dtype in (torch.float32, torch.bfloat16):
            x, cols, eps, z, active = kernel_inputs(S, dtype, dev, tables)
            tag = f"S={S} {str(dtype).split('.')[-1]}"
            # traj_masked_step (CUDA) against its plain version
            out = ops.traj_masked_step(x, cols, eps, z, active, tables)
            ref = kref.traj_masked_step_ref(x, cols, eps, z, active, tables)
            torch.cuda.synchronize()
            err_m, bit_m = check_pair(
                f"traj_masked_step {tag}", out, ref, x, active,
                lane_bound(tables, cols, dtype, ref))
            # ddpm_step (Triton) against its plain version, every lane
            coefs = kds.index_step_coefs(
                tables, torch.clamp(cols.long(), 0, C - 1))
            out_s = ops.ddpm_step(x, eps, z, coefs)
            ref_s = kref.ddpm_step_ref(x, eps, z, coefs)
            torch.cuda.synchronize()
            all_on = torch.ones_like(active)
            err_s, bit_s = check_pair(
                f"ddpm_step {tag}", out_s, ref_s, x, all_on,
                lane_bound(tables, cols, dtype, ref_s))
            n_act = int(active.sum())
            m_bytes = kds.masked_step_bytes(x, C, rows=tables.shape[0],
                                            n_active=n_act)
            s_bytes = 4 * x.numel() * x.element_size() + coefs.numel() * 4
            m_ops = 8 * n_act * (x.numel() // S)     # mul sub div mul add + clip
            s_ops = 5 * x.numel()
            m_args = (x, cols, eps, z, active, tables)
            s_args = (x, eps, z, coefs)
            t_m = cold_time_ms(ops.traj_masked_step, m_args)
            t_mp = cold_time_ms(kref.traj_masked_step_ref, m_args)
            t_s = cold_time_ms(ops.ddpm_step, s_args)
            t_sp = cold_time_ms(kref.ddpm_step_ref, s_args)
            w_m = warm_time_ms(ops.traj_masked_step, m_args)
            w_s = warm_time_ms(ops.ddpm_step, s_args)
            e_m = cuda_time_ms(lambda: ops.traj_masked_step(*m_args))
            e_s = cuda_time_ms(lambda: ops.ddpm_step(*s_args))
            block_s = kds.step_shape(x)
            blocks_s = -(-(x.numel() // S) // block_s[0]) * S
            b_m = max(m_bytes / bw, m_ops / f32_peak) * 1e3
            b_s = max(s_bytes / bw, s_ops / f32_peak) * 1e3
            by_m = "bytes" if m_bytes / bw >= m_ops / f32_peak else "operations"
            by_s = "bytes" if s_bytes / bw >= s_ops / f32_peak else "operations"
            print(f"[kernels] traj_masked_step {tag}: active {n_act}/{S} "
                  f"max_abs_err {err_m:.3e} bitwise {bit_m} | cold L2: "
                  f"kernel {t_m * 1e3:.3f}us plain {t_mp * 1e3:.3f}us bound "
                  f"{b_m * 1e3:.3f}us ({m_bytes} B, share "
                  f"{b_m / t_m:.1%}) | warm L2 kernel {w_m * 1e3:.3f}us | "
                  f"eager call {e_m * 1e3:.2f}us", flush=True)
            print(f"[kernels] ddpm_step {tag}: max_abs_err {err_s:.3e} "
                  f"bitwise {bit_s} | cold L2: kernel {t_s * 1e3:.3f}us "
                  f"plain {t_sp * 1e3:.3f}us bound {b_s * 1e3:.3f}us "
                  f"({s_bytes} B, share {b_s / t_s:.1%}) | warm L2 kernel "
                  f"{w_s * 1e3:.3f}us | eager call {e_s * 1e3:.2f}us | "
                  f"{blocks_s} programs of {block_s[1]} warps", flush=True)
            rows[(S, dtype)] = {
                "traj_masked_step": (err_m, t_m, t_mp, b_m, by_m),
                "ddpm_step": (err_s, t_s, t_sp, b_s, by_s)}
    return rows


# ---------------------------------------------------------------------------
# phase 4: the slice at full width
# ---------------------------------------------------------------------------
def slice_requests(n: int = 8, n_clients: int = 2):
    return [Request(req_id=i, seed=1000 + i, batch=1 + i % 2,
                    cut_ratio=(0.25, 0.5, 0.75)[i % 3],
                    client_idx=i % n_clients, arrival_tick=2 * i,
                    sampler=("ddpm", "ddim")[i % 2])
            for i in range(n)]


def slice_samplers():
    return {"ddpm": make_sampler(T), "ddim": make_sampler(T, "ddim", 20)}


def slice_engine(server, backend, k, dev):
    """Phase 4's engine: 8 slots, the cut-ratio scheduler, window depth
    ``k``, the {DDPM, DDIM K = 20} menu."""
    samplers = slice_samplers()
    return ServeEngine(EngineConfig(
        sched=cosine_schedule(T), image_shape=IMG, slots=8,
        scheduler=make_scheduler("cut_ratio", T, samplers=samplers),
        step_backend=backend, samplers=samplers, ticks_per_dispatch=k,
        device=dev), server)


def serve_backends(server, clients, dev, requests, tag, warm=None):
    """Serve ``requests`` with each step backend, the launch counts set to
    0 just before each run and read just after; hold finite outputs and
    each kernel launched on its own run.  ``warm`` requests are served
    first on the same engine (it builds the kernels and captures its window
    graphs).  Returns (results, counts)."""
    runs, counts = {}, {}
    for backend in ("cuda_masked", "triton", "torch"):
        eng = slice_engine(server, backend, 4, dev)
        if warm:
            eng.serve(warm, clients)
        ops.reset_launch_counts()
        res = eng.serve(requests, clients)
        counts[backend] = ops.launch_counts()
        eng.close()
        runs[backend] = res
        for comp in res.completions.values():
            if not (np.isfinite(comp.x_mid).all() and
                    np.isfinite(comp.x0).all()):
                raise AssertionError(f"{backend}: non-finite output for "
                                     f"request {comp.request.req_id}")
        s = res.summary
        print(f"[{tag}] {backend} k=4: {s['requests']} requests "
              f"({s['images']} images), {s['ticks']} ticks, wall "
              f"{res.wall_s:.3f}s | {s['ticks_per_s']:.2f} ticks/s "
              f"({1e3 / s['ticks_per_s']:.2f} ms/tick) | "
              f"{s['images_per_s']:.3f} images/s | finish "
              f"{s['finish_s']:.3f}s | launches {counts[backend]}",
              flush=True)
    if counts["cuda_masked"]["traj_masked_step"] == 0:
        raise AssertionError("traj_masked_step never launched on its run")
    if counts["triton"]["ddpm_step"] == 0:
        raise AssertionError("ddpm_step never launched on its run")
    return runs, counts


def check_backends_agree(runs, tag, tol=1e-2):
    """The kernels reproduce the plain arithmetic (f32), and a 1-ulp
    difference per step (x·(1/√ar) against x/√ar in the Triton path) is
    amplified through the chain, hence the bound."""
    base = runs["torch"]
    for backend in ("cuda_masked", "triton"):
        dm = max_diff(runs[backend], base, "x_mid")
        d0 = max_diff(runs[backend], base, "x0")
        print(f"[{tag}] {backend} vs torch: max |dx_mid| {dm:.3e} max |dx0| "
              f"{d0:.3e} bitwise {bitwise(runs[backend], base)} "
              f"(tolerance {tol})", flush=True)
        if max(dm, d0) > tol:
            raise AssertionError(f"{backend} disagrees with torch")


def max_diff(a, b, attr):
    return max(float(np.abs(getattr(a.completions[r], attr) -
                            getattr(b.completions[r], attr)).max())
               for r in a.completions)


def bitwise(a, b):
    return all(np.array_equal(a.completions[r].x0, b.completions[r].x0) and
               np.array_equal(a.completions[r].x_mid,
                              b.completions[r].x_mid)
               for r in a.completions)


def phase_slice(dev):
    ucfg = UNetConfig()
    t0 = time.perf_counter()
    server = UNet(ucfg, seed=0).to(dev).eval()
    clients = [UNet(ucfg, seed=1 + c).to(dev).eval() for c in range(2)]
    n_params = sum(p.numel() for p in server.parameters())
    print(f"[slice] paper U-Net {n_params} params ({n_params * 4 / 1e6:.1f} "
          f"MB f32) x 3 models, built in {time.perf_counter() - t0:.1f}s",
          flush=True)
    sched = cosine_schedule(T)
    samplers = slice_samplers()

    # warm-up on each engine: cuDNN heuristics, the allocator, the window
    # graphs, on two short ddim requests
    warm = [Request(req_id=i, seed=i, cut_ratio=0.75, sampler="ddim")
            for i in range(2)]
    runs, counts = serve_backends(server, clients, dev, slice_requests(),
                                  "slice", warm)
    tol = 1e-2
    check_backends_agree(runs, "slice", tol)

    # one lane against split_sample_lane (batch 1 instead of 8 lanes: other
    # convolution algorithms, so a tolerance)
    res = runs["cuda_masked"]
    for rid, img in ((0, 0), (1, 1)):
        r = res.completions[rid].request
        x0, xm = split_sample_lane(
            sched, CutPlan(T, r.cut_ratio), server, clients[r.client_idx],
            r.seed, img, IMG, return_intermediate=True,
            backend="cuda_masked", sampler=samplers[r.sampler], device=dev)
        dm = float(np.abs(xm.cpu().numpy() -
                          res.completions[rid].x_mid[img]).max())
        d0 = float(np.abs(x0.cpu().numpy() -
                          res.completions[rid].x0[img]).max())
        print(f"[slice] request {rid} image {img} ({r.sampler}, c="
              f"{r.cut_ratio}) vs split_sample_lane: max |dx_mid| {dm:.3e} "
              f"max |dx0| {d0:.3e} (tolerance {tol})", flush=True)
        if max(dm, d0) > tol:
            raise AssertionError("engine lane disagrees with "
                                 "split_sample_lane")

    # window depth: k=4 against k=1
    res1 = slice_engine(server, "cuda_masked", 1, dev).serve(
        slice_requests(), clients)
    dm = max_diff(res, res1, "x_mid")
    d0 = max_diff(res, res1, "x0")
    print(f"[slice] k=4 vs k=1: max |dx_mid| {dm:.3e} max |dx0| {d0:.3e} "
          f"bitwise {bitwise(res, res1)} | k=1 {res1.summary['ticks']} "
          f"ticks, {res1.summary['ticks_per_s']:.2f} ticks/s", flush=True)
    if max(dm, d0) > tol:
        raise AssertionError("k=4 disagrees with k=1")

    # where a tick's time goes: one server forward at 8 lanes
    x = torch.randn((8,) + IMG, device=dev)
    t = torch.full((8,), 50, dtype=torch.int64, device=dev)
    with torch.inference_mode():
        t_fwd = cuda_time_ms(lambda: server(x, t), iters=20, warmup=3)
    flops = 8 * flops_per_image(ucfg)
    s = res.summary
    print(f"[slice] U-Net forward at 8 lanes: {t_fwd:.2f} ms "
          f"({flops / t_fwd / 1e9:.1f} TFLOP/s on {flops / 1e9:.0f} GFLOP) "
          f"against {1e3 / s['ticks_per_s']:.2f} ms per engine tick over "
          "the loop, which covers the streamed client segment", flush=True)
    profile_device("U-Net forward at 8 lanes", lambda: server(x, t))
    return counts, t_fwd


# ---------------------------------------------------------------------------
# phase 4b: CollaFuse split training of the paper U-Net, then serving it
# ---------------------------------------------------------------------------
def event_ms(pair) -> float:
    start, stop = pair
    return start.elapsed_time(stop)


def timed_method(obj, name: str, pairs: list) -> None:
    """Wrap ``obj.name`` so each call is bracketed by CUDA events, appended
    to ``pairs`` (read after a synchronize)."""
    fn = getattr(obj, name)

    def wrapped(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        stop.record()
        pairs.append((start, stop))
        return out
    setattr(obj, name, wrapped)


def param_gap(a, b):
    """(max, mean) |a - b| over every entry of two parameter dicts."""
    d = torch.cat([(a[k].cpu() - b[k].cpu()).abs().ravel() for k in a])
    return float(d.max()), float(d.mean())


def check_losses(got, want, tol, what, tag="train"):
    pairs = [(got["server_loss"], want["server_loss"])] + list(
        zip(got["client_losses"], want["client_losses"]))
    worst = max(abs(g - w) / abs(w) for g, w in pairs)
    ok = all(abs(g - w) <= tol["atol"] + tol["rtol"] * abs(w)
             for g, w in pairs)
    print(f"[{tag}] {what}: losses max rel |d| {worst:.3e} (rtol "
          f"{tol['rtol']}, atol {tol['atol']})", flush=True)
    if not ok:
        raise AssertionError(f"{what}: losses disagree")


def phase_train(dev, card: str):
    t_phase = time.perf_counter()
    ucfg = UNetConfig()
    fpi = flops_per_image(ucfg)
    f32_peak = card_rates(card)[1]
    data, _ = make_client_datasets(ClientDataConfig(
        n_clients=TRAIN_CLIENTS, per_client=4 * TRAIN_BATCH,
        image_size=IMG[0], holdout=2))
    streams = [image_batches(d, TRAIN_BATCH, seed=k)
               for k, d in enumerate(data)]
    # warm-up, the timed rounds, one profiled round
    batches = [[next(st) for st in streams] for _ in range(TRAIN_ROUNDS + 2)]
    cfg = TrainerConfig(n_clients=TRAIN_CLIENTS, T=T, cut_ratio=TRAIN_CUT,
                        step_backend="triton")

    def factory(seed):
        return UNet(ucfg, seed=seed)

    t0 = time.perf_counter()
    # obs on (phase 4e (d)): a train_round span a round and the loss gauges
    tr = CollaFuseTrainer(cfg, factory, device=dev, flops_per_call=fpi,
                          obs=ObsConfig())
    n_img = TRAIN_CLIENTS * TRAIN_BATCH
    print(f"[train] paper U-Net x {TRAIN_CLIENTS + 1} (server + "
          f"{TRAIN_CLIENTS} clients), {tr.plan.describe()}, cosine T={T}, "
          f"lr {cfg.lr}, clip {cfg.grad_clip}; {TRAIN_BATCH} images a client "
          f"(the paper's 150: phase 4f), pooled server batch {n_img}; built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    steps = {"server": [], "client": []}
    timed_method(tr, "_server_update", steps["server"])
    timed_method(tr, "_client_round", steps["client"])
    # FLOP of a step, counted as 3x the forward's (forward + backward)
    step_flop = 3 * fpi * n_img
    torch.cuda.reset_peak_memory_stats(dev)
    hist, walls = [], []
    for r in range(TRAIN_ROUNDS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_round(batches[r])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        s_ms, c_ms = (event_ms(steps[k][-1]) for k in ("server", "client"))
        hist.append(m)
        losses = [m["server_loss"]] + m["client_losses"]
        if not all(np.isfinite(v) for v in losses):
            raise AssertionError(f"round {r}: non-finite loss {losses}")
        print(f"[train] round {r}{' (warm-up)' if r == 0 else ''}: server "
              f"loss {m['server_loss']:.5f}, client loss mean "
              f"{m['client_loss_mean']:.5f} | round {walls[-1]:.1f} ms | "
              f"server step {s_ms:.1f} ms ({step_flop / s_ms / 1e9:.1f} "
              f"TFLOP/s, {step_flop / s_ms / 1e9 / (f32_peak / 1e12):.1%} "
              f"of {f32_peak / 1e12:.0f}) | client step {c_ms:.1f} ms "
              f"({step_flop / c_ms / 1e9:.1f} TFLOP/s)", flush=True)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    timed = slice(1, TRAIN_ROUNDS + 1)
    s_ms = float(np.mean([event_ms(p) for p in steps["server"][timed]]))
    c_ms = float(np.mean([event_ms(p) for p in steps["client"][timed]]))
    w_ms = float(np.mean(walls[timed]))
    print(f"[train] {TRAIN_ROUNDS} timed rounds: round {w_ms:.1f} ms, server "
          f"step {s_ms:.1f} ms, client step {c_ms:.1f} ms, the rest "
          f"{w_ms - s_ms - c_ms:.1f} ms; a step's FLOP counted as 3x "
          f"flops_per_image ({fpi / 1e9:.2f} GFLOP) x {n_img} images = "
          f"{step_flop / 1e12:.2f} TFLOP: server "
          f"{step_flop / s_ms / 1e9:.1f} TFLOP/s, client "
          f"{step_flop / c_ms / 1e9:.1f} TFLOP/s against the "
          f"{f32_peak / 1e12:.0f} TFLOP/s f32 peak | peak memory "
          f"{peak_gb:.2f} GB (max_memory_allocated)", flush=True)
    print("[train] loss curve: server "
          f"{[round(m['server_loss'], 5) for m in hist]} client mean "
          f"{[round(m['client_loss_mean'], 5) for m in hist]}", flush=True)
    for key in ("server_loss", "client_loss_mean"):
        if not hist[-1][key] < hist[0][key]:
            raise AssertionError(f"{key} did not fall: {hist[0][key]} -> "
                                 f"{hist[-1][key]}")
    spans = [e for e in tr.obs.tracer.events()
             if e.get("ph") == "X" and e["name"] == "train_round"]
    snap = tr.obs.registry.snapshot()
    gauges = {k: snap[f"train_{k}"]["series"][0]["value"]
              for k in ("server_loss", "client_loss_mean")}
    span_ms = [round(e["dur"] / 1e3, 1) for e in spans]
    rounds = [e["args"]["round"] for e in spans]
    print(f"[obs] (d) trainer with obs on: {len(spans)} train_round spans "
          f"for {len(hist)} rounds (rounds {rounds}, host ms {span_ms}), "
          f"train_rounds_total "
          f"{snap['train_rounds_total']['series'][0]['value']:.0f} | loss "
          f"gauges {gauges} equal the last round's losses: "
          f"{all(gauges[k] == hist[-1][k] for k in gauges)}", flush=True)
    if rounds != list(range(len(hist))) or \
            any(gauges[k] != hist[-1][k] for k in gauges):
        raise AssertionError("train_round spans or loss gauges disagree "
                             "with the rounds")
    profile_device("training round (batched)",
                   lambda: tr.train_round(batches[-1]), reps=1,
                   mode=contextlib.nullcontext)

    # (b) batched against looped: the same initial models and draws
    lt = CollaFuseTrainer(dataclasses.replace(cfg, batched=False), factory,
                          device=dev, flops_per_call=fpi)
    lsteps = {"server": [], "client": []}
    timed_method(lt, "_server_update", lsteps["server"])
    timed_method(lt, "_client_update", lsteps["client"])
    torch.cuda.reset_peak_memory_stats(dev)
    lwalls, lhist = [], []
    for r in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lhist.append(lt.train_round(batches[r]))
        torch.cuda.synchronize()
        lwalls.append((time.perf_counter() - t0) * 1e3)
    check_losses(lhist[0], hist[0], TRAIN_LOSS_TOL, "looped vs batched, "
                 "round 0")
    ls_ms = float(np.mean([event_ms(p) for p in lsteps["server"][1:]]))
    lc_ms = float(np.mean([
        sum(event_ms(p) for p in lsteps["client"][i:i + TRAIN_CLIENTS])
        for i in range(TRAIN_CLIENTS, 3 * TRAIN_CLIENTS, TRAIN_CLIENTS)]))
    lw_ms = float(np.mean(lwalls[1:]))
    print(f"[train] looped engine, rounds 1-2: round {lw_ms:.1f} ms "
          f"(batched {w_ms:.1f}: batched {lw_ms / w_ms:.2f}x the looped "
          f"speed), server step {ls_ms:.1f} ms, {TRAIN_CLIENTS} client "
          f"steps {lc_ms:.1f} ms ({step_flop / lc_ms / 1e9:.1f} TFLOP/s; "
          f"vmapped {c_ms:.1f}) | peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB | round 1-2 "
          f"loss |d| server "
          f"{max(abs(a['server_loss'] - b['server_loss']) for a, b in zip(lhist[1:], hist[1:3])):.2e}",
          flush=True)
    profile_device("training round (looped)",
                   lambda: lt.train_round(batches[-1]), reps=1,
                   mode=contextlib.nullcontext)
    del lt
    torch.cuda.empty_cache()

    # (c) the card against the CPU, one round at reduced() from the same
    # weights and draws
    rcfg = UNetConfig().reduced()
    rdata, _ = make_client_datasets(ClientDataConfig(
        n_clients=TRAIN_CLIENTS, per_client=4, image_size=rcfg.image_size,
        holdout=2))
    red = []
    for d in (dev, torch.device("cpu")):
        rt = CollaFuseTrainer(
            TrainerConfig(n_clients=TRAIN_CLIENTS, T=T, cut_ratio=TRAIN_CUT),
            lambda seed: UNet(rcfg, seed=seed), device=d)
        red.append((rt, rt.train_round(rdata)))
    (gt, gm), (ct, cm) = red
    check_losses(gm, cm, dict(rtol=CPU_LOSS_RTOL, atol=0.0),
                 "card vs CPU at reduced()")
    gaps = [param_gap(gt.server_params, ct.server_params)] + [
        param_gap(a, b) for a, b in zip(gt.client_params, ct.client_params)]
    gmax, gmean = max(g[0] for g in gaps), max(g[1] for g in gaps)
    print(f"[train] card vs CPU parameters after one step: max |d| "
          f"{gmax:.3e} (bound {TRAIN_PARAM_MAX:.4g}), worst model's mean "
          f"|d| {gmean:.3e} (bound {TRAIN_PARAM_MEAN:.0e})", flush=True)
    if gmax > TRAIN_PARAM_MAX or gmean > TRAIN_PARAM_MEAN:
        raise AssertionError("card and CPU parameters disagree")

    # (d) split sampling through the trainer
    ops.reset_launch_counts()
    x = tr.sample(7, (2,) + IMG, client_idx=2)
    n_step = ops.launch_counts()["ddpm_step"]
    finite = bool(torch.isfinite(x).all())
    print(f"[train] trainer.sample (triton backend): {tuple(x.shape)} finite "
          f"{finite}, ddpm_step launches {n_step}, x0 in "
          f"[{float(x.min()):.3f}, {float(x.max()):.3f}]", flush=True)
    if not finite or n_step == 0:
        raise AssertionError("trainer.sample did not run ddpm_step to a "
                             "finite output")

    # (e) what the server can reconstruct of each client's images
    fp = feature_params()
    for k in range(TRAIN_CLIENTS):
        real = data[k][:TRAIN_BATCH]
        disc = tr.disclosed(100 + k, real, client_idx=k)
        rep = disclosure_report(fp, real, disc)
        print(f"[train] client {k} disclosure at c={TRAIN_CUT}: MSE "
              f"{rep['mse']:.5f} KID {rep['kid']:.5f} ({TRAIN_BATCH} real "
              f"images against their disclosed x at t={tr.plan.t_split})",
              flush=True)

    # (f) serve the trained weights through the engine and the kernels.
    # The trainer goes first: its surviving tensors pin fragments of the
    # training's ~62 GB of cached segments, which the main stream reuses
    # but the engine's finisher stream cannot (the caching allocator keeps
    # a block for the stream that made it), so the models move to the CPU
    # and back into memory freed for either stream
    server = tr.server_model().cpu()
    clients = [tr.client_model(k).cpu() for k in range(TRAIN_CLIENTS)]
    del tr, red, gt, ct, x, disc
    torch.cuda.empty_cache()
    server = server.to(dev)
    clients = [c.to(dev) for c in clients]
    runs, _ = serve_backends(server, clients, dev,
                             slice_requests(n_clients=TRAIN_CLIENTS),
                             "train-serve")
    check_backends_agree(runs, "train-serve")
    del server, clients, runs
    torch.cuda.empty_cache()
    print(f"[train] phase wall {time.perf_counter() - t_phase:.1f}s",
          flush=True)


def profile_device(label: str, fn, reps: int = 3,
                   mode=torch.inference_mode):
    """Device time of ``fn()`` by kernel, from ``torch.profiler``: the
    kernels' summed time against the wall time (the device's busy share)
    and the largest kernels.  ``fn`` runs under ``mode()`` (training needs
    ``contextlib.nullcontext``).  Returns {kernel name: ms per call}, empty
    when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with mode():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    if busy_ms == 0.0:
        print(f"[profile] {label}: the profiler saw no device time: busy "
              "share not measured", flush=True)
        return {}
    print(f"[profile] {label}: kernels {busy_ms:.2f} ms of {wall_ms:.2f} ms "
          f"wall (device busy {busy_ms / wall_ms:.1%}), "
          f"{sum(e.count for e in kernels) // reps} kernel launches",
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        ms = e.self_device_time_total / 1e3 / reps
        print(f"[profile]   {ms:8.3f} ms {ms / busy_ms:6.1%} "
              f"x{e.count // reps:<4d} {e.key[:90]}", flush=True)
    return {e.key: e.self_device_time_total / 1e3 / reps for e in kernels}


# ---------------------------------------------------------------------------
# phase 4c: guided and gated serving at full width
# ---------------------------------------------------------------------------
# the reference's classifier-free guidance gate (benchmarks/run.py) at T =
# 100: 4 classes, cuts {0.5, 0.75}, a KID gate on 16 synthetic images
GUIDE_CLASSES, GUIDE_CUTS, GUIDE_CALIB = 4, (0.5, 0.75), 16
GUIDE_TWINS = {"ddpm": "ddpm_g0", "ddim": "ddim_g0"}
# (c) and (e) serve with the caching allocator crowding the card: freed
# blocks of CROWD_BLOCK bytes, cached, hold all of its free memory but
# CROWD_LEAVE, the history a training phase or a mesh phase leaves behind
# (k = 4 once differed from k = 1 after the mesh phase ran in this
# process: ROADMAP Queue 3)
CROWD_BLOCK, CROWD_LEAVE = 256 << 20, 256 << 20


def crowd_allocator(dev) -> str:
    """Take blocks of CROWD_BLOCK bytes (the allocator's cached ones first)
    until the card has CROWD_LEAVE free, and free them: the allocator
    caches them.  Returns what is left, as text."""
    held = []
    while torch.cuda.mem_get_info(dev)[0] > CROWD_LEAVE + CROWD_BLOCK:
        held.append(torch.empty(CROWD_BLOCK, dtype=torch.uint8, device=dev))
    n = len(held)
    del held
    return (f"{n} blocks of {CROWD_BLOCK >> 20} MiB cached, "
            f"{torch.cuda.mem_get_info(dev)[0] / 1e9:.2f} GB of the card "
            "free")


def guide_samplers():
    """The reference gate's menu: DDPM, DDIM K = 20 (η = 0), their w = 0
    twins, and DDPM at w = 1.5 and DDIM at w = 2.0."""
    ddim = (T, "ddim", 20, 0.0)
    return {"ddpm": make_sampler(T), "ddim": make_sampler(*ddim),
            "ddpm_g0": make_sampler(T, guidance=0.0),
            "ddim_g0": make_sampler(*ddim, guidance=0.0),
            "ddpm_g": make_sampler(T, guidance=1.5),
            "ddim_g": make_sampler(*ddim, guidance=2.0)}


def guide_requests(names, n, salt, batch_of=lambda i: 1 + i % 2, cut=None):
    """The gate's traffic: samplers cycled, labels i % 4, batch 1-2, cuts
    alternating over GUIDE_CUTS, two clients, all arriving at tick 0."""
    return [Request(req_id=i, seed=salt * 1000 + i, batch=batch_of(i),
                    cut_ratio=cut if cut else GUIDE_CUTS[i % 2],
                    client_idx=i % 2, sampler=names[i % len(names)],
                    label=i % GUIDE_CLASSES)
            for i in range(n)]


def guide_engine(server, backend, k, dev, admission, graphs=True):
    """Phase 4c's engine: phase 4's (8 slots, cut-ratio scheduler) made
    conditional, with the guidance menu and an optional KID gate;
    ``graphs=False`` runs its windows eagerly."""
    samplers = guide_samplers()
    return ServeEngine(EngineConfig(
        sched=cosine_schedule(T), image_shape=IMG, slots=8,
        scheduler=make_scheduler("cut_ratio", T, samplers=samplers),
        step_backend=backend, samplers=samplers, ticks_per_dispatch=k,
        device=dev, num_classes=GUIDE_CLASSES, admission=admission,
        cuda_graphs=graphs), server)


def watch_engine(eng, shadows: list, windows: list):
    """Spy on one engine: at each retirement record whether every retiring
    shadow lane's x is bitwise its primary's; at each window record
    (``traj_masked_step`` launches in it, its ticks, how many of its ticks'
    stepping lanes mixed guided pairs and solo lanes), the launches of a
    replayed graph counted as its kernels."""
    retire, plan, dispatch = eng._retire, eng._plan_window, eng._dispatch
    mixed = []

    def spy_retire(done_seq, x, start, n_active, inflight, lanes, *rest):
        for ln in np.nonzero(done_seq.any(axis=0) & lanes.shadow)[0]:
            shadows.append(torch.equal(x[ln], x[lanes.pair[ln]]))
        return retire(done_seq, x, start, n_active, inflight, lanes, *rest)

    def spy_plan(lanes, admitted, hv):
        paired = lanes.pair != np.arange(len(lanes.pair))
        out = plan(lanes, admitted, hv)
        mixed.append(sum(bool((a & paired).any() and (a & ~paired).any())
                         for a in hv["active"]))
        return out

    def spy_dispatch(*args):
        before = ops.launch_counts()["traj_masked_step"]
        out = dispatch(*args)
        windows.append((ops.launch_counts()["traj_masked_step"] - before,
                        eng.ticks_per_dispatch, mixed.pop()))
        return out
    eng._retire, eng._plan_window, eng._dispatch = \
        spy_retire, spy_plan, spy_dispatch
    return eng


# a ~10 ms device spin (torch.cuda._sleep) ahead of a timed call holds the
# device while the host queues it, so its events read the device's time
# and not the host's (tools/step_variants.py)
SPIN_CYCLES = 20_000_000


def event_wrap(obj, name: str, pairs: list, spin: bool = False):
    """Bracket ``obj.name`` (keyword arguments too) by CUDA events appended
    to ``pairs``, behind a spin if ``spin``; returns a function that removes
    the wrapper."""
    fn = getattr(obj, name)

    def wrapped(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        out = fn(*args, **kw)
        stop.record()
        pairs.append((start, stop))
        return out
    setattr(obj, name, wrapped)
    return lambda: delattr(obj, name)


def same_decision(a, b) -> bool:
    return (a.action, a.effective_cut, a.kid) == \
        (b.action, b.effective_cut, b.kid)


def phase_guided(dev, card: str, unet_ms: float):
    t_phase = time.perf_counter()
    ucfg = dataclasses.replace(UNetConfig(), num_classes=GUIDE_CLASSES)
    server = UNet(ucfg, seed=0).to(dev).eval()
    clients = [UNet(ucfg, seed=1 + c).to(dev).eval() for c in range(2)]
    n_params = sum(p.numel() for p in server.parameters())
    sched = cosine_schedule(T)
    samplers = guide_samplers()
    calib = make_client_datasets(ClientDataConfig(
        n_clients=1, per_client=GUIDE_CALIB, image_size=IMG[0], holdout=2,
        seed=0))[0][0].to(dev)
    print(f"[guide] conditional paper U-Net ({GUIDE_CLASSES} classes + "
          f"null) {n_params} params x 3 models; menu "
          + ", ".join(f"{n}: {s.describe()}" for n, s in samplers.items())
          + f"; KID gate on {GUIDE_CALIB} synthetic {IMG[0]}x{IMG[1]} "
          "images", flush=True)

    # (a) the landscape and the floor, as the reference's gate derives it
    probe = AdmissionPolicy(sched, calib, min_kid=float("-inf"),
                            samplers=samplers)
    guide_engine(server, "cuda_masked", 4, dev, probe)     # binds the model
    combos = [(n, c) for n in samplers for c in GUIDE_CUTS]
    profiles = {}
    for n, s in samplers.items():
        hi = max(CutPlan(T, c).cut_index(s) for n2, c in combos if n2 == n)
        calls, secs = probe.model_calls, probe.score_s
        profiles[n] = probe.profile(n, hi)
        prof = profiles[n]
        per_step = 2 if s.guided and s.w else 1
        print(f"[guide] (a) {n}: positions 0..{hi} scored in "
              f"{probe.score_s - secs:.2f}s with "
              f"{probe.model_calls - calls} U-Net calls on {GUIDE_CALIB} "
              f"images (from scratch each: {hi * (hi + 1) // 2 * per_step})"
              " | KID at 0, 1/4, 1/2, 3/4, end: " + ", ".join(
                  f"{prof[p]:.5f}" for p in (0, hi // 4, hi // 2,
                                              3 * hi // 4, hi)), flush=True)
    for plain, twin in GUIDE_TWINS.items():
        if profiles[twin] != profiles[plain][:len(profiles[twin])]:
            raise AssertionError(f"w = 0 profile of {twin} differs from "
                                 f"{plain}'s")
    print("[guide] (a) w = 0 profiles bitwise equal to the unguided ones: "
          "True", flush=True)
    nominal, prefix = [], []
    for n, c in combos:
        pos = CutPlan(T, c).cut_index(samplers[n])
        nominal.append(profiles[n][pos])
        prefix.append(max(profiles[n][:pos + 1]))
    lo, hi = min(nominal), min(prefix)
    min_kid = 0.5 * (lo + hi) if lo < hi else lo
    can_bump = any(k < min_kid <= m for k, m in zip(nominal, prefix))
    print(f"[guide] (a) floor min_kid {min_kid:.6f} (lowest nominal KID "
          f"{lo:.6f}, lowest best-reachable {hi:.6f}); "
          + ("the landscape forces a bump at this floor" if can_bump else
             "the landscape cannot force a bump: no combination's nominal "
             "KID lies below a noisier position's at this floor")
          + f" | scoring {probe.score_s:.2f}s, {probe.model_calls} U-Net "
          "calls", flush=True)
    gate = probe.with_min_kid(min_kid)

    # (b) the w = 0 anchor on cuda_masked
    res_a = guide_engine(server, "cuda_masked", 4, dev, gate).serve(
        guide_requests(["ddpm", "ddim"], 4, salt=3), clients)
    res_b = guide_engine(server, "cuda_masked", 4, dev, gate).serve(
        guide_requests(list(GUIDE_TWINS.values()), 4, salt=3), clients)
    anchor = (set(res_a.completions) == set(res_b.completions)
              and bitwise(res_a, res_b)
              and all(same_decision(d, res_b.decisions[r])
                      for r, d in res_a.decisions.items()))
    print(f"[guide] (b) w = 0 anchor: {len(res_a.completions)} completions "
          f"(x_mid, x0) and {len(res_a.decisions)} decisions bitwise equal: "
          f"{anchor} | unguided {res_a.summary['ticks']} ticks, twins "
          f"{res_b.summary['ticks']}", flush=True)
    if not anchor:
        raise AssertionError("w = 0 twins differ from the unguided traffic")

    # (c) mixed traffic through each backend, gated, the allocator crowded
    print(f"[guide] (c) crowded the allocator: {crowd_allocator(dev)}",
          flush=True)
    mix = ["ddpm", "ddpm_g", "ddim", "ddim_g"]
    reqs = guide_requests(mix, 6, salt=7)
    runs, counts, shadows, windows = {}, {}, [], []
    for backend in ("cuda_masked", "triton", "torch"):
        eng = watch_engine(guide_engine(server, backend, 4, dev, gate),
                           shadows, windows if backend == "cuda_masked"
                           else [])
        ops.reset_launch_counts()
        res = eng.serve(reqs, clients)
        counts[backend] = ops.launch_counts()
        runs[backend] = res
        for comp in res.completions.values():
            if not (np.isfinite(comp.x_mid).all() and
                    np.isfinite(comp.x0).all()):
                raise AssertionError(f"{backend}: non-finite output for "
                                     f"request {comp.request.req_id}")
        s = res.summary
        print(f"[guide] (c) {backend} k=4: {s['requests']} requests "
              f"({s['served']} served, {s['images']} images), "
              f"{s['ticks']} ticks, wall {res.wall_s:.3f}s | "
              f"{s['ticks_per_s']:.2f} ticks/s "
              f"({1e3 / s['ticks_per_s']:.2f} ms/tick) | "
              f"{s['images_per_s']:.3f} images/s | decisions "
              + ", ".join(f"{d.req_id}:{d.action}@{d.effective_cut}"
                          for d in res.decisions.values())
              + f" | launches {counts[backend]}", flush=True)
    check_backends_agree(runs, "guide")
    if counts["cuda_masked"]["traj_masked_step"] == 0:
        raise AssertionError("traj_masked_step never launched on its run")
    if counts["triton"]["ddpm_step"] == 0:
        raise AssertionError("ddpm_step never launched on its run")
    mixed = sum(m for _, _, m in windows)
    per_tick = sorted(set(n / k for n, k, _ in windows))
    print(f"[guide] (c) shadow x bitwise its primary's at {len(shadows)} "
          f"retirements: {all(shadows)} | cuda_masked: {len(windows)} "
          f"windows, {sum(k for _, k, _ in windows)} lane ticks, "
          f"traj_masked_step launches a tick {per_tick} (a replayed graph's "
          f"counted), {mixed} ticks mixing guided pairs and solo lanes",
          flush=True)
    if not shadows or not all(shadows):
        raise AssertionError("a shadow lane's x differs from its primary's")
    if per_tick != [1.0] or not mixed:
        raise AssertionError("mixed guided and unguided lanes did not take "
                             "one traj_masked_step launch a tick")

    # (d) privacy: every served KID clears the floor; a fresh policy decides
    # the same; a floor above every score rejects everything
    res = runs["cuda_masked"]
    for rid, d in res.decisions.items():
        if d.served and (d.kid < min_kid or d.kid != gate.disclosure_kid(
                d.sampler, d.effective_cut)):
            raise AssertionError(f"request {rid} served at KID {d.kid} "
                                 f"against the floor {min_kid}")
    fresh = AdmissionPolicy(sched, calib, min_kid=min_kid,
                            samplers=guide_samplers())
    guide_engine(server, "cuda_masked", 4, dev, fresh)
    fresh_d = {r.req_id: fresh.decide(r) for r in reqs}
    exact = fresh_d == res.decisions
    close = all(a.action == b.action and a.effective_cut == b.effective_cut
                and abs(a.kid - b.kid) <= 1e-6 * abs(b.kid)
                for a, b in ((fresh_d[r], res.decisions[r]) for r in fresh_d))
    served = [d for d in res.decisions.values() if d.served]
    print(f"[guide] (d) {len(served)} served requests, KID "
          f"{min(d.kid for d in served):.6f}..{max(d.kid for d in served):.6f}"
          f" >= floor {min_kid:.6f}: True | the gate's decisions read "
          f"{gate.cache_hits} scores from the cache and made "
          f"{gate.model_calls} U-Net calls | fresh policy "
          f"({fresh.model_calls} U-Net calls, {fresh.score_s:.2f}s): "
          f"decisions identical {exact}"
          + ("" if exact else f", within 1e-6 relative {close}"), flush=True)
    if not close:
        raise AssertionError("a fresh policy decides otherwise")
    top = max(probe._kid_cache.values())
    res_r = guide_engine(server, "cuda_masked", 4, dev,
                         probe.with_min_kid(top + 1.0)).serve(reqs, clients)
    empty = (not res_r.completions and res_r.summary["ticks"] == 0
             and len(res_r.rejected) == len(reqs)
             and res_r.summary["server_flops"] == 0)
    print(f"[guide] (d) floor {top + 1.0:.4f} above every score: "
          f"{len(res_r.rejected)} of {len(reqs)} rejected, "
          f"{len(res_r.completions)} completions, {res_r.summary['ticks']} "
          f"ticks: {empty}", flush=True)
    if not empty:
        raise AssertionError("an all-rejecting floor served work")

    # (e) k = 4 against k = 1 on the mixed traffic, the allocator crowded
    # again (a k = 1 window is eager only for its first tick, a k = 4
    # window for its first four: the graphs must hold the eager window's
    # algorithms)
    print(f"[guide] (e) crowded the allocator: {crowd_allocator(dev)}",
          flush=True)
    res1 = guide_engine(server, "cuda_masked", 1, dev, gate).serve(reqs,
                                                                   clients)
    same_k = bitwise(res, res1) and set(res1.completions) == set(
        res.completions)
    print(f"[guide] (e) k=4 vs k=1: bitwise {same_k} | k=1 "
          f"{res1.summary['ticks']} ticks, {res1.summary['ticks_per_s']:.2f}"
          " ticks/s", flush=True)
    if not same_k:
        raise AssertionError("k=4 differs from k=1 on guided traffic")

    # (f) cost: guided against unguided at equal slots, ungated, nominal
    # cut, windows run eagerly (events bracket the steps inside the tick;
    # phase 4d (d) times the same ticks in graphs); the guided step's time
    # in the tick (events as the tick runs: the device has drained and
    # waits on the host there), then, in a run of its own, behind a spin
    # (the combine's device time)
    one = lambda i: 1                                      # noqa: E731
    be = get_backend("cuda_masked")
    cost, combine = {}, {}
    for name, spin in (("ddpm", None), ("ddpm_g", False), ("ddpm_g", True)):
        pairs = {"guided": [], "masked": []}
        undo = [] if spin is None else [
            event_wrap(be, "guided_masked_index_step", pairs["guided"],
                       spin),
            event_wrap(be, "masked_index_step", pairs["masked"])]
        eng = guide_engine(server, "cuda_masked", 4, dev, None,
                           graphs=False)
        res_f = eng.serve(guide_requests([name], 4 if spin else 8, salt=11,
                                         batch_of=one, cut=0.75))
        torch.cuda.synchronize()
        for u in undo:
            u()
        if not spin:
            cost[name] = res_f
        if spin is not None:
            g_ms = np.median([event_ms(p) for p in pairs["guided"]])
            m_ms = np.median([event_ms(p) for p in pairs["masked"]])
            combine[spin] = (float(g_ms - m_ms), float(g_ms), float(m_ms),
                             len(pairs["guided"]))
    su, sg = cost["ddpm"].summary, cost["ddpm_g"].summary
    print(f"[guide] (f) 8 requests of 1 image at c=0.75, ungated, 8 slots, "
          f"eager windows: "
          f"unguided {su['ticks']} ticks {su['ticks_per_s']:.2f} ticks/s "
          f"({1e3 / su['ticks_per_s']:.2f} ms/tick) "
          f"{su['images_per_s']:.3f} images/s | guided {sg['ticks']} ticks "
          f"{sg['ticks_per_s']:.2f} ticks/s "
          f"({1e3 / sg['ticks_per_s']:.2f} ms/tick) "
          f"{sg['images_per_s']:.3f} images/s | guided/unguided: ticks/s "
          f"{sg['ticks_per_s'] / su['ticks_per_s']:.3f}, images/s "
          f"{sg['images_per_s'] / su['images_per_s']:.3f} | phase 4's U-Net "
          f"forward {unet_ms:.2f} ms", flush=True)
    print(f"[guide] (f) server FLOPs guided {sg['server_flops']:.6g} = "
          f"{sg['server_flops'] / su['server_flops']:.6f} x unguided "
          f"{su['server_flops']:.6g}", flush=True)
    for spin, what in ((True, "device time, behind a spin"),
                       (False, "as the tick runs, the host's pace")):
        d, g_ms, m_ms, n = combine[spin]
        print(f"[guide] (f) the combine inside a guided tick ({what}): "
              f"{d * 1e3:.1f} us = the guided step {g_ms * 1e3:.1f} us less "
              f"its masked step {m_ms * 1e3:.1f} us (medians of {n} event "
              "pairs)", flush=True)
    if sg["server_flops"] != 2.0 * su["server_flops"]:
        raise AssertionError("guided server FLOPs are not 2x the unguided")

    # (g) the launcher, guided and gated at full width
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        sd_launch.main(["--config", "paper", "--num-classes", "4",
                        "--guidance", "1.5", "--min-kid", f"{min_kid:.6f}",
                        "--calib", str(GUIDE_CALIB), "--requests", "2",
                        "--clients", "1", "--slots", "8",
                        "--cut-ratios", "0.75", "--ticks-per-dispatch", "4"])
    for line in buf.getvalue().splitlines():
        print(f"[guide] (g) {line}", flush=True)
    if "serve_diffusion OK" not in buf.getvalue() or \
            "admission (min_kid=" not in buf.getvalue():
        raise AssertionError("the launcher did not print its admission "
                             "outcome and 'serve_diffusion OK'")
    print(f"[guide] (g) launcher wall {time.perf_counter() - t0:.1f}s",
          flush=True)
    del server, clients, probe, gate, fresh
    torch.cuda.empty_cache()
    print(f"[guide] phase wall {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 4d: the serving engine's host path at full width
# ---------------------------------------------------------------------------
# (async_depth, finish_mode, finish_async_depth) of (c); the first is the
# synchronous drain engine every other run is held to, bitwise
HOST_MODES = [(1, "drain", 1), (1, "stream", 1), (1, "stream", 2),
              (2, "drain", 1), (2, "stream", 1), (2, "stream", 2)]


def host_requests(n: int = 12, salt: int = 3):
    """Phase 4's traffic (batch 1-2, two clients, an arrival every 2 ticks)
    on DDIM K = 20 alone at cuts 0.5 and 0.75, so that (c)'s six runs fit
    the phase's time (5-10 server and 10-15 client steps a lane) and each
    of the two finisher classes gathers a wave (8 lanes once the queue has
    drained) while server windows still run."""
    return [Request(req_id=i, seed=salt * 1000 + i, batch=1 + i % 2,
                    cut_ratio=(0.5, 0.75)[i // 2 % 2], client_idx=i % 2,
                    arrival_tick=2 * i, sampler="ddim") for i in range(n)]


def host_engine(server, dev, k=4, depth=1, mode="drain", fdepth=1, **kw):
    """Phase 4's engine (8 slots, the cut-ratio scheduler, cuda_masked)
    with the host path's knobs."""
    samplers = kw.pop("samplers", None) or slice_samplers()
    return ServeEngine(EngineConfig(
        sched=cosine_schedule(T), image_shape=IMG, slots=8,
        scheduler=make_scheduler("cut_ratio", T, samplers=samplers),
        step_backend="cuda_masked", samplers=samplers, ticks_per_dispatch=k,
        async_depth=depth, finish_mode=mode, finish_async_depth=fdepth,
        device=dev, **kw), server)


def stage_window(eng, requests):
    """Admit ``requests`` into the engine's empty slot array by hand and
    stage the first window's plan on the device, as the serve loop does at
    a boundary.  Returns the slot array before the window."""
    eng._static_buffers(staged=False)
    eng._x.zero_()
    lanes = serve_engine._Lanes.empty(eng.slots, eng.num_classes)
    free = list(range(eng.slots))
    for r in requests:
        need = eng._lanes_of(r)
        eng._admit(r, free[:need], lanes)
        free = free[need:]
    host = torch.empty(eng._plan_bytes, dtype=torch.uint8,
                       pin_memory=eng.device.type == "cuda")
    hv = {n: v.numpy()
          for n, v in serve_engine._views(host, eng._plan_layout).items()}
    eng._plan_window(lanes, lanes.req >= 0, hv)
    eng._plan_buf.copy_(host)
    return eng._x.clone()


def events_ms(fn, reps: int) -> float:
    """Device time of ``fn()`` a call: CUDA events around ``reps`` calls
    back to back, after one."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def busy_share(fn):
    """``fn()`` under ``torch.profiler``: the union of the device's busy
    intervals (kernels and copies, any stream) over the wall time.  Returns
    (fn's result, the share or None when the profiler saw no device
    activity, device events seen)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, lo, hi = 0.0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            if hi is not None:
                busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    if hi is not None:
        busy += hi - lo
    return out, (busy / wall_us if spans else None), len(spans)


def share_text(share) -> str:
    return "not measured" if share is None else \
        f"{share:.1%} (torch.profiler)"


def phase_host(dev, card: str, unet_ms: float):
    t_phase = time.perf_counter()
    bw, f32_peak, _ = card_rates(card)
    ucfg = UNetConfig()
    server = UNet(ucfg, seed=0).to(dev).eval()
    clients = [UNet(ucfg, seed=1 + c).to(dev).eval() for c in range(2)]
    x = torch.randn((8,) + IMG, device=dev)
    t = torch.full((8,), 50, dtype=torch.int64, device=dev)
    with torch.inference_mode():
        t_fwd = cuda_time_ms(lambda: server(x, t), iters=10, warmup=2)
    print(f"[host] paper U-Net x 3 models, 8 slots, cosine T={T}, "
          f"cuda_masked, lane noise drawn on the card (lane_philox) | the "
          f"U-Net forward at 8 lanes here {t_fwd:.2f} ms (phase 4's "
          f"{unet_ms:.2f}): the convolutions cuDNN runs in this process",
          flush=True)
    profile_device("U-Net forward at 8 lanes (phase 4d)",
                   lambda: server(x, t), reps=1)

    # (a) one window staged by hand: run eagerly, then captured and
    # replayed from the same staged inputs
    eng = host_engine(server, dev)
    k = eng.ticks_per_dispatch
    with torch.inference_mode():
        x0 = stage_window(eng, slice_requests(5))
        eng._window(False, lane_philox)
        want = (eng._x.clone(), eng._xo.clone())
        eng._x.copy_(x0)
        eng._run_window(False, lane_philox)       # eager, then captured
        eng._x.copy_(x0)
        eng._run_window(False, lane_philox)       # replayed
        torch.cuda.synchronize()
        same = torch.equal(eng._x, want[0]) and torch.equal(eng._xo, want[1])
        e_ms = events_ms(lambda: eng._window(False, lane_philox), 3) / k
        g_ms = events_ms(lambda: eng._run_window(False, lane_philox), 5) / k
        t0 = time.perf_counter()
        for _ in range(5):
            eng._run_window(False, lane_philox)
        host_us = (time.perf_counter() - t0) * 1e6 / 5
        torch.cuda.synchronize()
    print(f"[host] (a) one window of k={k} on 7 lanes (DDPM and DDIM): "
          f"replayed graph bitwise the eager window (slot array and "
          f"gathered rows): {same} | ms a tick: graph {g_ms:.3f}, eager "
          f"{e_ms:.3f} (CUDA events, windows back to back) | a replay's "
          f"host time {host_us:.1f} us | phase 4's U-Net forward "
          f"{unet_ms:.2f} ms", flush=True)
    if not same:
        raise AssertionError("the replayed window differs from the eager "
                             "one")
    eng.close()
    del eng

    # (b) the lane-noise kernel against its plain version
    rows = {}
    for S in (8, 32):
        g = torch.Generator().manual_seed(S)
        args = [torch.randint(0, 2 ** 62, (S,), generator=g),
                torch.randint(0, 4, (S,), generator=g),
                torch.randint(0, T, (S,), generator=g)]
        active = torch.ones(S, dtype=torch.bool)
        active[3::4] = False
        cpu_args = args + [active]
        dargs = [a.to(dev) for a in cpu_args] + [1, IMG]
        out = ops.lane_noise(*dargs)
        ref = kref.lane_noise_ref(*dargs)
        ref_cpu = kref.lane_noise_ref(*cpu_args, 1, IMG)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        bit = torch.equal(out, ref) and torch.equal(out.cpu(), ref_cpu)
        n_act = int(active.sum())
        nbytes = kln.noise_bytes(out)
        int_ops, flt_ops = kln.noise_ops(out, n_act)
        # every operation at the float32 rate (the card's table has no
        # int32 rate)
        t_bytes, t_ops = nbytes / bw, (int_ops + flt_ops) / f32_peak
        bound = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        cold = cold_time_ms(ops.lane_noise, dargs)
        warm = warm_time_ms(ops.lane_noise, dargs)
        plain = cold_time_ms(kref.lane_noise_ref, dargs)
        floor = graph_time_ms(lambda: torch.cuda._sleep(0), [()] * 50,
                              replays=20)
        print(f"[host] (b) lane_noise S={S} ({n_act} drawing, {IMG}): "
              f"bitwise the plain version on the card and on the CPU: {bit} "
              f"(max |d| {err:.1e}) | kernel cold {cold * 1e3:.3f} us, warm "
              f"{warm * 1e3:.3f} us | plain {plain * 1e3:.1f} us | bound "
              f"{bound * 1e3:.3f} us ({by}: {nbytes} B; {int_ops:.3g} "
              f"integer and {flt_ops:.3g} float operations) | an empty "
              f"1-block kernel {floor * 1e3:.3f} us", flush=True)
        if not bit:
            raise AssertionError("lane_noise differs from its plain version")
        rows[S] = (err, cold, plain, bound, by)

    # (c) every (async_depth, finish_mode, finish_async_depth) against the
    # synchronous drain run, bitwise
    warm = [Request(req_id=i, seed=i, cut_ratio=0.75, sampler="ddim")
            for i in range(2)]
    runs = {}
    for depth, mode, fdepth in HOST_MODES:
        eng = host_engine(server, dev, 4, depth, mode, fdepth)
        eng.serve(warm)                   # captures the window graph
        ops.reset_launch_counts()
        if (depth, mode, fdepth) in (HOST_MODES[0], HOST_MODES[-1]):
            res, share, _ = busy_share(
                lambda: eng.serve(host_requests(), clients))
        else:
            res, share = eng.serve(host_requests(), clients), None
        fin_ticks = ops.launch_counts()["traj_masked_step"] - \
            res.summary["ticks"]
        runs[(depth, mode, fdepth)] = res
        s = res.summary
        base = runs[HOST_MODES[0]]
        same = bitwise(res, base) and set(res.completions) == set(
            base.completions)
        print(f"[host] (c) async_depth {depth}, {mode} "
              f"(finish_async_depth {fdepth}): {s['ticks']} server ticks in "
              f"{s['windows']} windows, {fin_ticks} finisher lane ticks of "
              f"{eng.slots} lanes, wall {res.wall_s:.3f}s | "
              f"{s['ticks_per_s']:.2f} ticks/s "
              f"({1e3 / s['ticks_per_s']:.2f} ms/tick over the loop) | "
              f"{s['images_per_s']:.3f} images/s | finish "
              f"{s['finish_s']:.3f}s in {s['finish_batches']} batch(es), "
              f"overlap_frac {s['overlap_frac']:.3f} | device busy "
              f"{share_text(share)} | bitwise the synchronous drain run: "
              f"{same}", flush=True)
        if not same:
            raise AssertionError(f"async_depth {depth} {mode}/{fdepth} "
                                 "differs from the synchronous drain run")
        if (depth, mode, fdepth) != HOST_MODES[-1]:
            eng.close()

    # (g) launches through replays and copies, server only, on the last
    # engine (async_depth 2), warm; then the device's busy share over a
    # served window at depth 2 and depth 1
    copies = eng.h2d_copies
    ops.reset_launch_counts()
    res_g, share2, n_ev = busy_share(lambda: eng.serve(host_requests()))
    counts = ops.launch_counts()
    s = res_g.summary
    w = s["windows"]
    print(f"[host] (g) server only, async_depth 2: {s['ticks']} ticks in "
          f"{w} windows of k={k} | traj_masked_step {counts['traj_masked_step']}"
          f" launches ({counts['traj_masked_step'] / s['ticks']:.3f} a "
          f"tick), lane_noise {counts['lane_noise']} "
          f"({counts['lane_noise'] / w:.3f} a window: k ticks and the "
          f"admissions' x_T) | host-to-device copies "
          f"{eng.h2d_copies - copies} ({(eng.h2d_copies - copies) / w:.3f} "
          f"a window) | {eng.captures} graph(s) captured | device busy "
          f"{share_text(share2)} over {n_ev} device events", flush=True)
    if counts["traj_masked_step"] != s["ticks"] or \
            counts["lane_noise"] != (k + 1) * w or \
            eng.h2d_copies - copies != w:
        raise AssertionError("launches or copies a window are not one "
                             "step and one draw a tick, one draw and one "
                             "copy a window")
    eng.close()
    eng = host_engine(server, dev, 4, 1)
    eng.serve(warm)
    res_1, share1, _ = busy_share(lambda: eng.serve(host_requests()))
    print(f"[host] (g) server only, async_depth 1: "
          f"{1e3 / res_1.summary['ticks_per_s']:.2f} ms/tick (depth 2: "
          f"{1e3 / s['ticks_per_s']:.2f}, both under the profiler) | "
          f"device busy {share_text(share1)}", flush=True)

    # (f) k = 4 against k = 1
    res_k1 = host_engine(server, dev, 1).serve(host_requests(), clients)
    same_k = bitwise(res_k1, runs[HOST_MODES[0]])
    print(f"[host] (f) k=1 vs k=4 (synchronous drain): bitwise {same_k} | "
          f"k=1 {res_k1.summary['ticks']} ticks, "
          f"{1e3 / res_k1.summary['ticks_per_s']:.2f} ms/tick", flush=True)
    if not same_k:
        raise AssertionError("k=1 differs from k=4")

    # (e) a sampler registered into spare columns against the same sampler
    # in the static menu, and no new capture
    dyn = make_sampler(T, "ddim", 10, 0.0)
    reqs = [Request(req_id=i, seed=70 + i, batch=1 + i, cut_ratio=0.5,
                    client_idx=i, sampler="dyn") for i in range(2)]
    static = host_engine(server, dev, samplers=dict(slice_samplers(),
                                                    dyn=dyn))
    ref = static.serve(reqs, clients)
    static.close()
    eng = host_engine(server, dev, spare_columns=32)
    eng.serve(warm, clients)
    captures = eng.captures
    tid = eng.register_sampler("dyn", dyn)
    res_e = eng.serve(reqs, clients)
    same_e = bitwise(res_e, ref)
    print(f"[host] (e) 'dyn' ({dyn.describe()}) registered into spare "
          f"columns as trajectory {tid}: bitwise the static menu's "
          f"{same_e} | graph captures {captures} before, {eng.captures} "
          f"after", flush=True)
    if not same_e or eng.captures != captures:
        raise AssertionError("the registered sampler differs from the "
                             "static one, or registration captured a graph")
    eng.close()

    # (d) guided against unguided ticks on the same engine (graphs)
    gcfg = dataclasses.replace(UNetConfig(), num_classes=GUIDE_CLASSES)
    gserver = UNet(gcfg, seed=0).to(dev).eval()
    eng = guide_engine(gserver, "cuda_masked", 4, dev, None)
    one = lambda i: 1                                      # noqa: E731
    eng.serve(guide_requests(["ddpm", "ddpm_g"], 2, salt=5, batch_of=one,
                             cut=0.9))
    tick = {}
    for name in ("ddpm", "ddpm_g", "ddpm"):
        res_d = eng.serve(guide_requests([name], 4, salt=11, batch_of=one,
                                         cut=0.75))
        tick.setdefault(name, []).append(1e3 / res_d.summary["ticks_per_s"])
    print(f"[host] (d) 4 requests of 1 image at c=0.75, graphs: ms a tick "
          f"unguided {tick['ddpm'][0]:.2f} / {tick['ddpm'][1]:.2f}, guided "
          f"{tick['ddpm_g'][0]:.2f} (in turns on one engine; "
          f"{eng.captures} graphs captured)", flush=True)
    eng.close()
    del server, clients, gserver, eng
    torch.cuda.empty_cache()
    print(f"[host] phase wall {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 4e: wave packing, its telemetry, and the observability stack
# ---------------------------------------------------------------------------
# the reference's hetero_packing gate (benchmarks/run.py) at T = 100 on 8
# slots: every 3rd request a dense DDPM head taking the whole pool at cut
# 0.2, between them batch-1 fillers rotating over these classes (the last
# one registered in spare columns)
PACK_FILLERS = [("ddim20", 0.2), ("ddim10", 0.8), ("ddim20", 0.8),
                ("ddim7", 0.5)]
PACK_REQUESTS = 12
# obs_overhead's bound: ticks/s with obs on within 5 % of obs off
OBS_TICKS_TOL = 0.05
# the names the reference's engine publishes into its registry
OBS_NAMES = ("serve_admitted_total", "serve_retired_total",
             "serve_latency_ticks", "serve_windows_total",
             "serve_ticks_total", "serve_active_lanes",
             "serve_boundary_lag_ticks", "serve_fragmentation_free_lanes",
             "serve_queue_depth", "serve_inflight_requests",
             "serve_finish_batches_total", "serve_finish_lanes_total")
SPAN_NAMES = ("admit", "dispatch", "launch", "sync_wait", "retire",
              "finish_clients", "client_finish_dispatch",
              "client_finish_sync")


def pack_requests(salt: int, n: int = PACK_REQUESTS):
    reqs, filler = [], 0
    for i in range(n):
        if i % 3 == 2:
            smp, cut, batch = "ddpm", 0.2, 8
        else:
            smp, cut = PACK_FILLERS[filler % len(PACK_FILLERS)]
            batch, filler = 1, filler + 1
        reqs.append(Request(req_id=i, seed=salt * 1000 + i, batch=batch,
                            cut_ratio=cut, sampler=smp))
    return reqs


def pack_engine(server, dev, pack: bool, image_shape=None):
    """The mix's engine: FIFO (pack on or off), 8 slots, k = 4,
    async_depth 2, cuda_masked, DDPM + DDIM K = 20 and 10 static, DDIM K = 7
    registered into 8 spare columns."""
    samplers = {"ddpm": make_sampler(T),
                "ddim20": make_sampler(T, "ddim", 20, 0.0),
                "ddim10": make_sampler(T, "ddim", 10, 0.0)}
    eng = ServeEngine(EngineConfig(
        sched=cosine_schedule(T), image_shape=image_shape or IMG, slots=8,
        scheduler=make_scheduler("fifo", T, samplers=samplers, pack=pack),
        step_backend="cuda_masked", samplers=samplers, ticks_per_dispatch=4,
        async_depth=2, spare_columns=8, device=dev), server)
    eng.register_sampler("ddim7", make_sampler(T, "ddim", 7, 0.0))
    return eng


def pack_schedule(res):
    return res.summary["ticks"], {rid: (c.admit_tick, c.retire_tick)
                                  for rid, c in res.completions.items()}


class ScaleEps(torch.nn.Module):
    """A one-parameter ε-model, ε̂ = w·x: the tiny model of the CPU serve."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(0.1))

    def forward(self, x, t):
        return self.w * x


def pack_cpu_schedule():
    """The same mix served on the CPU by a one-parameter model on 4x4
    images, pack off and on: the schedule depends on the host alone."""
    cpu = torch.device("cpu")
    out = {}
    for pack in (False, True):
        res = pack_engine(ScaleEps(), cpu, pack, (4, 4, 1)).serve(
            pack_requests(7))
        out[pack] = pack_schedule(res)
    return out


def mix_text(s) -> str:
    occ = ", ".join(f"{c}: {v}" for c, v in sorted(
        s["occupancy_by_class"].items(), key=lambda kv: -kv[1]))
    return (f"fragmentation_frac {s['fragmentation_frac']:.4f} | "
            f"occupancy by class (lane-ticks) {occ}")


def span_breakdown(events):
    """{span name: [host ms of each span]} over the "X" events."""
    out = {}
    for e in events:
        if e.get("ph") == "X":
            out.setdefault(e["name"], []).append(e["dur"] / 1e3)
    return out


def phase_obs(dev, card: str):
    t_phase = time.perf_counter()
    ucfg = UNetConfig()
    server = UNet(ucfg, seed=0).to(dev).eval()
    clients = [UNet(ucfg, seed=1 + c).to(dev).eval() for c in range(2)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    print(f"[obs] paper U-Net, 8 slots, cosine T={T}, k=4, async_depth 2, "
          f"cuda_masked, lane noise drawn on the card | {card} | files "
          f"under a temporary directory", flush=True)

    # (a) the heterogeneous mix, pack off then on, one engine each: a
    # warm-up that captures the window kind, the sampler registered again,
    # then the measured serve; the CPU serve of the same mix first
    t0 = time.perf_counter()
    cpu = pack_cpu_schedule()
    print(f"[obs] (a) the mix on the CPU (a one-parameter model, 4x4): "
          f"ticks pack "
          f"off {cpu[False][0]}, on {cpu[True][0]}: predicted ticks-to-drain "
          f"{cpu[False][0] / cpu[True][0]:.3f}x "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    runs = {}
    for pack in (False, True):
        eng = pack_engine(server, dev, pack)
        eng.serve(pack_requests(3)[:2])
        captures, copies = eng.captures, eng.h2d_copies
        eng.register_sampler("ddim7", make_sampler(T, "ddim", 7, 0.0))
        ops.reset_launch_counts()
        res = eng.serve(pack_requests(7))
        counts = ops.launch_counts()
        s = res.summary
        runs[pack] = res
        same_cpu = pack_schedule(res) == cpu[pack]
        print(f"[obs] (a) pack {'on' if pack else 'off'}: {s['ticks']} ticks "
              f"in {s['windows']} windows, wall {res.wall_s:.3f}s, "
              f"{s['ticks_per_s']:.2f} ticks/s, {s['images_per_s']:.3f} "
              f"images/s ({s['images']} images) | {mix_text(s)} | "
              f"traj_masked_step {counts['traj_masked_step']}, lane_noise "
              f"{counts['lane_noise']} launches, host-to-device copies "
              f"{eng.h2d_copies - copies}, captures {captures} before, "
              f"{eng.captures} after | ticks and every admit and retire "
              f"tick equal the CPU serve's: {same_cpu}", flush=True)
        if eng.captures != captures:
            raise AssertionError("the measured serve captured a graph")
        if counts["traj_masked_step"] != s["ticks"] or \
                counts["lane_noise"] != 5 * s["windows"]:
            raise AssertionError("launches are not one step a tick and "
                                 "k + 1 draws a window")
        if not same_cpu:
            raise AssertionError(f"pack={pack}: the schedule differs from "
                                 "the CPU serve of the same mix")
        eng.close()
    off, on = runs[False], runs[True]
    diff = [rid for rid in off.completions
            if not np.array_equal(off.completions[rid].x_mid,
                                  on.completions[rid].x_mid)]
    so, sn = off.summary, on.summary
    print(f"[obs] (a) pack on vs off: x_mid bitwise for every request "
          f"{not diff and set(off.completions) == set(on.completions)} | "
          f"ticks-to-drain {so['ticks'] / sn['ticks']:.3f}x, images/s "
          f"{sn['images_per_s'] / so['images_per_s']:.3f}x", flush=True)
    if diff or set(off.completions) != set(on.completions):
        raise AssertionError(f"pack on differs from pack off at requests "
                             f"{diff}")

    # (b) obs off against obs on, phase 4d (c)'s traffic streamed, in turns
    # off, on, on, off on two warm engines
    trace = os.path.join(tmp, "trace.json")
    jsonl = os.path.join(tmp, "metrics.jsonl")
    warm = [Request(req_id=i, seed=i, cut_ratio=0.75, sampler="ddim")
            for i in range(2)]
    engs = {False: host_engine(server, dev, 4, 2, "stream"),
            True: host_engine(server, dev, 4, 2, "stream", obs=ObsConfig(
                trace_path=trace, metrics_path=jsonl, metrics_every=4))}
    for eng in engs.values():
        eng.serve(warm, clients)
    res_b, rates, deltas = {}, {False: [], True: []}, {}
    for on_ in (False, True, True, False):
        eng = engs[on_]
        if on_:
            eng.obs.tracer.clear()
            if os.path.exists(jsonl):
                os.remove(jsonl)
        captures, copies = eng.captures, eng.h2d_copies
        ops.reset_launch_counts()
        res = eng.serve(host_requests(), clients)
        counts = ops.launch_counts()
        if counts["traj_masked_step"] == 0 or counts["lane_noise"] == 0:
            raise AssertionError("a kernel of the path never launched")
        rates[on_].append(res.summary["ticks_per_s"])
        deltas.setdefault(on_, []).append(
            (eng.captures - captures,
             (eng.h2d_copies - copies) / res.summary["windows"]))
        res_b.setdefault(on_, res)
    b_off, b_on = res_b[False], res_b[True]
    same = bitwise(b_on, b_off) and set(b_on.completions) == set(
        b_off.completions) and b_on.decisions == b_off.decisions
    for key in ("ticks", "windows", "utilization_mean"):
        same = same and b_on.summary[key] == b_off.summary[key]
    events = load_trace(trace)
    n_ev = validate_events(events)
    spans = span_breakdown(events)
    n_dispatch = len(spans.get("dispatch", []))
    stages_ok = all(
        [e["stage"] for e in tl] == sorted(
            (e["stage"] for e in tl), key=STAGES.index)
        and tl[-1]["stage"] == "client_finished"
        for tl in b_on.timelines.values())
    lines = read_jsonl(jsonl)
    names_ok = all(n in lines[-1]["metrics"] for n in OBS_NAMES)
    r_off, r_on = float(np.mean(rates[False])), float(np.mean(rates[True]))
    print(f"[obs] (b) obs off vs on ({b_on.summary['ticks']} ticks in "
          f"{b_on.summary['windows']} windows, streamed finisher): "
          f"completions, decisions, ticks and utilization bitwise {same} | "
          f"ticks/s off {rates[False][0]:.3f} / {rates[False][1]:.3f}, on "
          f"{rates[True][0]:.3f} / {rates[True][1]:.3f} (in turns: off, on, "
          f"on, off): on/off {r_on / r_off:.4f} (bound {1 - OBS_TICKS_TOL}) "
          f"| captures and copies a window, off {deltas[False]}, on "
          f"{deltas[True]}", flush=True)
    print(f"[obs] (b) trace: {n_ev} events, valid; dispatch spans "
          f"{n_dispatch} for {b_on.summary['windows']} windows | "
          f"{len(b_on.timelines)} timelines in stage order ending "
          f"client_finished: {stages_ok} | JSON-lines: {len(lines)} "
          f"snapshots, the reference's instrument names present: "
          f"{names_ok}", flush=True)
    print("[obs] (b) host time by span over the obs-on serve (the host's "
          "clock only: 'dispatch' is planning, staging the one copy and "
          "replaying the graph, not the window's device time, which with "
          "async_depth 2 shows in 'sync_wait' at a later boundary; "
          "'launch' is the replay's call inside 'dispatch'; "
          "'client_finish_*' nest inside 'finish_clients'):", flush=True)
    wall_ms = b_on.wall_s * 1e3
    for name in SPAN_NAMES:
        d = np.asarray(spans.get(name, [0.0]))
        print(f"[obs]   {name:24s} {d.sum():10.3f} ms in "
              f"{len(spans.get(name, [])):4d} spans (median "
              f"{np.median(d):8.3f} ms, max {d.max():8.3f} ms; "
              f"{d.sum() / wall_ms:6.1%} of the {wall_ms:.1f} ms serve)",
              flush=True)
    if not same:
        raise AssertionError("obs on differs from obs off")
    if n_dispatch != b_on.summary["windows"] or any(
            n not in spans for n in
            ("sync_wait", "retire", "admit", "finish_clients")):
        raise AssertionError("the trace lacks a dispatch span a window or a "
                             "host-loop span")
    if not stages_ok or not names_ok:
        raise AssertionError("timelines out of order or registry names "
                             "missing")
    if len(set(deltas[False] + deltas[True])) != 1:
        raise AssertionError("obs changed the captures or the copies a "
                             "window")
    if r_on < (1 - OBS_TICKS_TOL) * r_off:
        raise AssertionError(f"obs on costs more than {OBS_TICKS_TOL:.0%} "
                             "ticks/s")
    engs[True].close()

    # (c) torch.profiler over the first 4 windows of each serve: its
    # warm-up serve captures the window's graph under the profiler
    pdir = os.path.join(tmp, "profile")
    eng = host_engine(server, dev, 4, 2, "stream", obs=ObsConfig(
        trace=False, profile_dir=pdir, profile_windows=4))
    eng.serve(warm, clients)
    res_c = eng.serve(host_requests(), clients)
    same_c = bitwise(res_c, b_off) and set(res_c.completions) == set(
        b_off.completions)
    named = {}
    for name in sorted(os.listdir(pdir)):
        with open(os.path.join(pdir, name)) as f:
            text = f.read()
        named[name] = (len(text), "traj_masked_step" in text,
                       "lane_noise" in text)
    print(f"[obs] (c) profile_windows 4: bitwise (b)'s obs-off run "
          f"{same_c} | profiles (bytes, names traj_masked_step, names "
          f"lane_noise): {named}", flush=True)
    if not same_c or len(named) != 2 or not all(
            a and b for _, a, b in named.values()):
        raise AssertionError("the profiled run differs, or a profile does "
                             "not name both kernels")
    eng.close()
    engs[False].close()
    del server, clients, eng, engs
    torch.cuda.empty_cache()
    print(f"[obs] phase wall {time.perf_counter() - t_phase:.1f}s",
          flush=True)


# ---------------------------------------------------------------------------
# phase 4f: the paper's healthcare experiment at its own batch
# ---------------------------------------------------------------------------
# the paper's §4 batch: 150 images a client (the reference's --full), a
# pooled server batch of 450, in chunks of the healthcare example's
# default (48 images a forward and backward)
PAPER_BATCH, PAPER_MICRO = 150, hc.FULL_MICRO_BATCH
# at phase 4b's 16 images a client: (a) the chunk whose round's memory is
# broken down beside the unchunked one, (b) the chunks held against the
# unchunked round (5: ragged, its last chunk shorter; 8 too until a run on
# a slower host took 1,188 s of the script's 1,200)
MEMORY_CHUNK, CHUNKS_CHECKED = 16, (5,)
POD_SLOTS = 8
# the pod smoke's queue: 7 requests put request 5's two guided pairs across
# the two hosts' blocks (lanes 2, 3 with 4, 5)
POD_SMOKE_REQUESTS = 7
# the full-width pod: the paper U-Net with 4 classes, T = 100, the menu
# DDPM, DDIM K = 20 and ddpm_g at w 1.5, 8 slots, k = 4, async_depth 2,
# 6 requests on one client (8 before the model-axis phases paid for their
# time: 88 ticks, now 64); these cuts put guided pairs across the blocks
POD_FULL_ARGS = ["--config", "paper", "--num-classes", "4", "--guidance",
                 "1.5", "--mix", "--sampler", "ddim", "--num-steps", "20",
                 "--T", "100", "--slots", str(POD_SLOTS),
                 "--ticks-per-dispatch", "4", "--async-depth", "2",
                 "--requests", "6", "--cut-ratios", "0.5", "0.5", "0.75",
                 "--clients", "1", "--seed", "0"]
# extra flags of every child (the CPU rehearsal adds --device cpu)
POD_CHILD_ARGS: list = []
POD_CHILD_TIMEOUT_S = 300.0
# the full-width pod against the single host: a pod host calls the U-Net
# on its 4 lanes in a solo window, where the single host calls it on 8, and
# on the card a lane's ε̂ differs by a few ulps between the two widths
# (tools/pod_width.py).  The chain amplifies that as it amplifies the
# backends' 1-ulp differences, so the pod is held to the bound phase 4
# holds the backends to (check_backends_agree)
POD_FULL_TOL = 1e-2


# 130 s (150 before the model-axis phases paid for their time)
PAPER_BUDGET_S = 130.0
# (c)'s timed rounds after the warm-up (2 before the model-axis phases paid
# for their time)
PAPER_TIMED_ROUNDS = 1
# images generated a client by (e)'s evaluate (the unbiased KID needs 2)
PAPER_N_GEN = 4
# a block freed within this many allocator events of its allocation is
# counted transient (a convolution's workspace lives one call)
TRANSIENT_EVENTS = 6


def trace_peak(events):
    """Replay the allocator's trace: (bytes allocated above the trace's
    start at its peak, bytes of segments reserved above the start at that
    moment, [(size, alloc index, free index or None, frame)] of the blocks
    allocated in the trace and live at the peak, (size, frame) of the
    largest allocation)."""
    live, total, peak, peak_at, frees = {}, 0, 0, -1, {}
    largest = (0, "")
    for i, e in enumerate(events):
        act = e.get("action")
        if act == "alloc":
            live[e["addr"]] = i
            total += e["size"]
            if e["size"] > largest[0]:
                largest = (e["size"], frame_of(e))
            if total > peak:
                peak, peak_at = total, i
        elif act == "free_requested" and e["addr"] in live:
            frees[live.pop(e["addr"])] = i
            total -= e["size"]
    open_, seg = {}, 0
    for e in events[:peak_at + 1]:
        act = e.get("action")
        if act == "alloc":
            open_[e["addr"]] = e
        elif act == "free_requested":
            open_.pop(e["addr"], None)
        elif act == "segment_alloc":
            seg += e["size"]
        elif act == "segment_free":
            seg -= e["size"]
    index = {id(e): i for i, e in enumerate(events[:peak_at + 1])}
    blocks = sorted(((e["size"], index[id(e)], frees.get(index[id(e)]),
                      frame_of(e)) for e in open_.values()), reverse=True)
    return peak, seg, blocks, largest


def frame_of(event) -> str:
    """The innermost frame of the port (else the innermost of any) that
    made an allocation; "no Python frame" inside autograd's backward."""
    frames = event.get("frames") or []
    for f in frames:
        if "repro_torch" in f.get("filename", ""):
            return f"{f.get('name')}:{f.get('line')}"
    return (f"{frames[0].get('name')}:{frames[0].get('line')}" if frames
            else "no Python frame")


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def grad_probe(loss_fn, params, args, functorch: bool, vmapped: bool):
    """One chunk's gradient of ``loss_fn`` at ``params``: (bytes its
    forward holds at its end, the peak over forward and backward), both
    above the bytes allocated before.  ``functorch``: the trainer's
    ``grad_and_value`` (under ``vmap`` when ``vmapped``); else plain
    autograd over the same forward."""
    held = []

    def probed(p, *a):
        out = loss_fn(p, *a)
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
        return out
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    if functorch:
        fn = torch.func.grad_and_value(probed)
        grads, loss = (torch.func.vmap(fn) if vmapped else fn)(params, *args)
    else:
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = (torch.func.vmap(probed) if vmapped else probed)(p, *args)
        grads = torch.autograd.grad(loss.sum(), list(p.values()))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del grads, loss
    return held[0] - before, peak - before


def traced_method(obj, name: str, steps: list, dev) -> None:
    """Wrap ``obj.name`` so each call appends its memory record: the peak
    allocated over the call, the allocated and reserved bytes at its start,
    and the allocator's trace events of the call (history is on)."""
    fn = getattr(obj, name)

    def events():
        return torch.cuda.memory._snapshot()["device_traces"][dev.index or 0]

    def wrapped(*args):
        torch.cuda.synchronize()
        n0 = len(events())
        start = (torch.cuda.memory_allocated(dev),
                 torch.cuda.memory_reserved(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn(*args)
        torch.cuda.synchronize()
        steps.append((torch.cuda.max_memory_allocated(dev), start,
                      events()[n0:]))
        return out
    setattr(obj, name, wrapped)


def memory_round(tr, batches, dev, label):
    """One round of ``tr`` under the allocator's history: each step's peak
    split into the state (parameters and AdamW moments), one chunk's
    activations (a forward's graph held), the gradients and the rest, the
    rest into blocks live at the peak that die within a few allocator
    events (a convolution's workspace) and longer-lived ones (backward
    intermediates); the reserved-but-free bytes at the peak.  Returns the
    round's metrics and its peak."""
    n_img = sum(b.shape[0] for b in batches)
    per_client = batches[0].shape[0]
    state = tree_bytes(tr.state_tree())
    grads = {"server": tree_bytes(tr.server_params),
             "client": tree_bytes(tr.client_stack)}
    # one chunk of each step through the trainer's grad_and_value and
    # through plain autograd: what the forward holds, and the peak (inputs
    # drawn here: the bytes depend on the shapes alone)
    g = torch.Generator(device=dev).manual_seed(5)
    chunk = n_img if tr.micro_batch is None else min(tr.micro_batch, n_img)
    per = (per_client if tr.micro_batch is None
           else min(per_client, max(1, tr.micro_batch // len(batches))))
    x = torch.randn((chunk,) + IMG, device=dev, generator=g)
    t = torch.randint(tr.plan.t_split + 1, T + 1, (chunk,), device=dev,
                      generator=g)
    x0 = torch.randn((len(batches), per) + IMG, device=dev, generator=g)
    tc = torch.randint(1, tr.plan.t_split + 1, (len(batches), per),
                       device=dev, generator=g)
    probes = {}
    for functorch in (True, False):
        probes[("server", functorch)] = grad_probe(
            tr._server_loss, tr.server_params, (x, t, x), functorch, False)
        torch.cuda.empty_cache()
        probes[("client", functorch)] = grad_probe(
            tr._client_loss, tr.client_stack, (x0, tc, x0), functorch, True)
        torch.cuda.empty_cache()
    del x, x0, t, tc
    steps = {"server": [], "client": []}
    traced_method(tr, "_server_update", steps["server"], dev)
    traced_method(tr, "_client_round", steps["client"], dev)
    torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                             stacks="python")
    m = tr.train_round(batches)
    torch.cuda.memory._record_memory_history(enabled=None)
    for name in ("_server_update", "_client_round"):
        tr.__dict__.pop(name)
    gb = 1e9
    print(f"[paper] (a) {label}: {per_client} images a client, {n_img} "
          f"pooled; server chunks of {chunk}, client chunks of {per} a "
          f"client | state {state / gb:.2f} GB (parameters and AdamW "
          f"moments of 4 models)", flush=True)
    peaks = []
    for k in ("server", "client"):
        (peak, (alloc0, res0), events), = steps[k]
        top, seg, blocks, largest = trace_peak(events)
        transient = [b for b in blocks
                     if b[2] is not None and b[2] - b[1] <= TRANSIENT_EVENTS]
        held, chunk_peak = probes[(k, True)]
        p_held, p_peak = probes[(k, False)]
        at_peak = alloc0 + top
        peaks.append(peak)
        print(f"[paper] (a) {label}, {k} step: peak {peak / gb:.2f} GB = "
              f"state {state / gb:.2f} + one chunk's gradient "
              f"{chunk_peak / gb:.2f} (its forward holds {held / gb:.2f}; "
              f"plain autograd: {p_held / gb:.2f} held, peak "
              f"{p_peak / gb:.2f}) + the rest "
              f"{(peak - state - chunk_peak) / gb:.2f} (the summed "
              f"gradients: {grads[k] / gb:.2f}) | at the trace's peak "
              f"({at_peak / gb:.2f} GB): "
              f"{sum(b[0] for b in transient) / gb:.2f} GB in blocks freed "
              f"within {TRANSIENT_EVENTS} allocator events (a convolution's "
              f"workspace), the largest block "
              f"{(blocks[0][0] if blocks else 0) / gb:.2f} GB; reserved "
              f"{(res0 + seg) / gb:.2f} GB, of it free "
              f"{(res0 + seg - at_peak) / gb:.2f} GB | the step's largest "
              f"allocation {largest[0] / gb:.2f} GB ({largest[1]})",
              flush=True)
    return m, max(peaks)


def check_chunked(tr, m, ref, ref_m, what, peak):
    """(b): a chunked round against the unchunked one from the same models
    and draws: losses within phase 4b's tolerance, parameters after the
    step within the card-against-CPU bound."""
    check_losses(m, ref_m, TRAIN_LOSS_TOL, what, tag="paper")
    gaps = [param_gap(tr.server_params, ref.server_params)] + [
        param_gap(a, b) for a, b in zip(tr.client_params, ref.client_params)]
    gmax, gmean = max(g[0] for g in gaps), max(g[1] for g in gaps)
    print(f"[paper] (b) {what}: parameters after the step max |d| "
          f"{gmax:.3e} (bound {TRAIN_PARAM_MAX:.4g}), worst model's mean "
          f"|d| {gmean:.3e} (bound {TRAIN_PARAM_MEAN:.0e}) | peak "
          f"{peak / 1e9:.2f} GB", flush=True)
    if gmax > TRAIN_PARAM_MAX or gmean > TRAIN_PARAM_MEAN:
        raise AssertionError(f"{what}: parameters disagree")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_children(cmds, timeout_s: float = POD_CHILD_TIMEOUT_S):
    """Start every command at once from ``src/``, each in a session of its
    own, and wait for all of them; at the deadline kill each one's whole
    process group.  Raises unless every command exits 0.  Returns each
    one's standard output."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, cmd in enumerate(cmds):
            out = open(Path(tmp) / f"{i}.out", "w+")
            procs.append((subprocess.Popen(
                [str(c) for c in cmd], cwd=ROOT / "src", stdout=out,
                stderr=subprocess.STDOUT, start_new_session=True), out))
        deadline = time.monotonic() + timeout_s
        try:
            for proc, _ in procs:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for proc, _ in procs:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        texts = []
        for (proc, out), cmd in zip(procs, cmds):
            out.seek(0)
            texts.append(out.read())
            out.close()
            if proc.returncode != 0:
                raise AssertionError(
                    f"{' '.join(str(c) for c in cmd[1:4])} exited "
                    f"{proc.returncode}:\n{texts[-1][-3000:]}")
        return texts


def straddling_pairs(res, slots: int, hosts: int):
    """(req_id, primary lane, shadow lane) of every guided pair whose two
    lanes lie in different hosts' blocks, from the admission timelines."""
    block = slots // hosts
    out = []
    for rid, events in sorted(res.timelines.items()):
        r = res.completions[rid].request
        for e in events:
            if e["stage"] == "admitted" and "lanes" in e and \
                    len(e["lanes"]) == 2 * r.batch:
                ln = e["lanes"]
                out += [(rid, ln[i], ln[r.batch + i]) for i in range(r.batch)
                        if ln[i] // block != ln[r.batch + i] // block]
    return out


def full_pod_args(tmp: Path, label: str, mesh: list) -> list:
    """``serve_diffusion``'s arguments at full width with ``mesh`` flags,
    writing ``tmp/<label>.npz`` and ``.json``."""
    return [str(a) for a in (*POD_FULL_ARGS, *POD_CHILD_ARGS, *mesh, "--out",
                             tmp / f"{label}.npz", "--json",
                             tmp / f"{label}.json")]


def full_pod_result(tmp: Path, label: str):
    """A full-width run's merged summary and its joined rows."""
    rows = np.load(tmp / f"{label}.npz")
    return (json.loads((tmp / f"{label}.json").read_text()),
            {k: rows[k] for k in rows.files})


def rows_gap(a: dict, b: dict):
    """(same keys, equal ticks, bitwise, max |Δ| of x_mid, of x0) of two
    joined row sets."""
    if sorted(a) != sorted(b):
        return False, False, False, float("inf"), float("inf")
    ticks = all(np.array_equal(a[k], b[k]) for k in a if k.startswith("ticks"))
    same = all(np.array_equal(a[k], b[k]) for k in a)

    def gap(prefix):
        return max(float(np.abs(a[k] - b[k]).max()) for k in a
                   if k.startswith(prefix))
    return True, ticks, same, gap("x_mid_"), gap("x0_")


def phase_pod(dev, card: str):
    """4g: pod mode, two host processes on the one card."""
    t_phase = time.perf_counter()
    print(f"[4g] pod mode: 2 host processes on one {card}, gloo, "
          f"{POD_SLOTS} slots", flush=True)
    # (a) the pod smoke's protocol, both finisher modes' pods at once
    modes = ("stream", "drain")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        refs, straddles = {}, {}
        for mode in modes:
            res = pod_smoke.serve_pod(
                1, 0, POD_SLOTS, POD_SMOKE_REQUESTS, 4, 2, clients=3,
                finish_mode=mode, pack=True, device=dev,
                obs=ObsConfig(trace=False, timelines=True))
            refs[mode] = pod_smoke.artifact(res, 0)
            straddles[mode] = straddling_pairs(res, POD_SLOTS, 2)
            del res
        torch.cuda.empty_cache()
        cmds = []
        for mode in modes:
            port = free_port()
            cmds += [[sys.executable, "-m", "repro_torch.launch.pod_smoke",
                      "--coordinator", f"127.0.0.1:{port}",
                      "--num-processes", "2", "--process-id", h, "--out",
                      tmp / f"pod_{mode}{h}.json", "--slots", POD_SLOTS,
                      "--requests", POD_SMOKE_REQUESTS, "--clients", 3,
                      "--finish-mode", mode, "--pack", "--trace-out",
                      tmp / f"trace_{mode}.json", *POD_CHILD_ARGS]
                     for h in (0, 1)]
        run_children(cmds)
        for mode in modes:
            ref, trace = refs[mode], tmp / f"trace_{mode}.json"
            arts = [json.loads((tmp / f"pod_{mode}{h}.json").read_text())
                    for h in (0, 1)]
            union = pod_smoke.union(arts)
            same = union == ref
            ticks = all(union["completions"][r]["retire_tick"] ==
                        ref["completions"][r]["retire_tick"]
                        for r in ref["completions"])
            n_events = merge_traces([f"{trace}.host0", f"{trace}.host1"],
                                    tmp / "merged.json")
            pids = sorted({e["pid"] for e in load_trace(tmp / "merged.json")})
            print(f"[4g] (a) pod_smoke {mode} --clients 3 --pack: union of "
                  f"{sum(len(a['completions']) for a in arts)} host records "
                  f"bitwise the single host {same} (x_mid and x0), retire "
                  f"ticks equal {ticks}, straddling guided pairs "
                  f"{straddles[mode]}, merged trace {n_events} events, pids "
                  f"{pids}", flush=True)
            if not (same and ticks and straddles[mode] and pids == [0, 1]):
                raise AssertionError(f"pod smoke ({mode}) failed")
        print(f"[4g] (a) both modes, their two pods at once, "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    # (b) full width: the paper U-Net, serve_diffusion --devices 2 against
    # the single host (in this process); each pod host's measured serve
    # repeats its warm-up serve's requests, bitwise
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            sd_launch.main(full_pod_args(
                tmp, "single", ["--devices", "1", "--mesh-shape", "1x1"]))
        single_wall = time.perf_counter() - t0
        torch.cuda.empty_cache()
        single, single_rows = full_pod_result(tmp, "single")
        t0 = time.perf_counter()
        run_children([[sys.executable, "-m",
                       "repro_torch.launch.serve_diffusion",
                       *full_pod_args(tmp, "pod", ["--devices", "2",
                                                   "--mesh-shape", "2x1"])]])
        pod_wall = time.perf_counter() - t0
        pod, pod_rows = full_pod_result(tmp, "pod")
        keys, ticks, same, gap_mid, gap_x0 = rows_gap(single_rows, pod_rows)
        gap = max(gap_mid, gap_x0)
        repeat = [r["repeat_bitwise"] for r in pod["hosts"]]
        print(f"[4g] (b) {pod['mesh']} against data:1xmodel:1, paper U-Net "
              f"4 classes, {pod['requests']} requests ({pod['images']} "
              f"images), {pod['ticks']} ticks: union bitwise the single "
              f"host {same}, max |d| x_mid {gap_mid:.3g} x0 {gap_x0:.3g}, "
              f"retire ticks equal {ticks}; each pod host's measured serve "
              f"bitwise its warm-up serve (rows and ticks) {repeat}; walls "
              f"{single_wall:.1f}s (in this process) and {pod_wall:.1f}s "
              "(the launcher)", flush=True)
        for label, run in (("single", single), ("pod", pod)):
            for r in run["hosts"]:
                peak = "n/a" if r["peak_gb"] is None else \
                    f"{r['peak_gb']:.2f} GB ({r['peak_reserved_gb']:.2f} " \
                    "reserved)"
                print(f"[4g] (b) {label} host {r['host']}: "
                      f"{r['ms_per_tick']:.2f} ms a tick (the measured "
                      f"serve's wall, streamed finisher included, over "
                      f"{r['ticks']} ticks), {r['images_per_s']:.3f} "
                      f"images/s, launches "
                      f"traj_masked_step {r['launches']['traj_masked_step']} "
                      f"lane_noise {r['launches']['lane_noise']}, "
                      f"{r['halo_lanes']} halo lane-windows, peak {peak}",
                      flush=True)
        ratio = pod["pod_images_per_s"] / single["pod_images_per_s"]
        print(f"[4g] (b) images/s: pod {pod['pod_images_per_s']:.3f} "
              f"against single host {single['pod_images_per_s']:.3f} "
              f"({ratio:.3f}x; two processes time-slice one card)",
              flush=True)
        ok = keys and ticks and all(repeat) and all(
            r["launches"]["traj_masked_step"] > 0 and
            r["launches"]["lane_noise"] > 0 for r in pod["hosts"]) and \
            any(r["halo_lanes"] > 0 for r in pod["hosts"])
        if ok and not same:
            # a lane's bits follow the call's width (tools/pod_width.py):
            # hold the pod to the stated tolerance
            print(f"[4g] (b) the pod within {POD_FULL_TOL:g} of the single "
                  f"host {gap <= POD_FULL_TOL}", flush=True)
            ok = gap <= POD_FULL_TOL
        if not ok:
            raise AssertionError("full-width pod failed")
    print(f"[4g] pod phase {time.perf_counter() - t_phase:.1f}s", flush=True)


# 4h: the U-Net's model axis, serve_diffusion --devices 2 --mesh-shape 1x2
# (one pod host over two model ranks, eager windows) against the single
# host (in this process, CUDA graphs): the paper U-Net at full width, DDIM
# K = 20, 6 requests at cuts 0.5 and 0.75 on 8 slots, k = 4, one client.  A model rank convolves
# half of each convolution's output channels (cuDNN's plan for the other
# width) and gathers them: a lane's bits follow the call's shapes, as in
# 4g (b), so it is held to POD_FULL_TOL; the two model ranks compute the
# same gathered tensors, so their completions are held bitwise.
MODEL_SERVE_ARGS = ["--config", "paper", "--sampler", "ddim", "--num-steps",
                    "20", "--eta", "0", "--T", "100", "--slots",
                    str(POD_SLOTS), "--ticks-per-dispatch", "4",
                    "--requests", "6", "--cut-ratios", "0.5", "0.75",
                    "--clients", "1", "--seed", "0"]


def phase_model_serve(dev, card: str):
    """4h: the serving engine over the U-Net's model axis."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        def args(label, mesh):
            return [str(a) for a in (*MODEL_SERVE_ARGS, *POD_CHILD_ARGS,
                                     "--devices",
                                     int(mesh[0]) * int(mesh[2]),
                                     "--mesh-shape", mesh, "--out",
                                     tmp / f"{label}.npz", "--json",
                                     tmp / f"{label}.json")]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            sd_launch.main(args("single", "1x1"))
        single_wall = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        text = run_children([[sys.executable, "-m",
                              "repro_torch.launch.serve_diffusion",
                              *args("model", "1x2")]])[0]
        model_wall = time.perf_counter() - t0
        first = [ln for ln in text.splitlines()
                 if ln.startswith("serve_diffusion:")][0]
        single, single_rows = full_pod_result(tmp, "single")
        two, two_rows = full_pod_result(tmp, "model")
    keys, ticks, same, gap_mid, gap_x0 = rows_gap(single_rows, two_rows)
    gap = max(gap_mid, gap_x0)
    one, host = single["hosts"][0], two["hosts"][0]
    st = host["collectives"]
    print(f"[4h] {first[:first.index(' device=')]}", flush=True)
    print(f"[4h] paper U-Net on data:1xmodel:2 against data:1xmodel:1, "
          f"{two['requests']} requests ({two['images']} images), "
          f"{two['ticks']} ticks (single {single['ticks']}): completions "
          f"the same bits on both model ranks {host['model_bitwise']}, "
          f"measured serve bitwise its warm-up {host['repeat_bitwise']}; "
          f"against the single host: max |d| x_mid {gap_mid:.3g} x0 "
          f"{gap_x0:.3g} (held to {POD_FULL_TOL:g}), bitwise {same}, "
          f"retire ticks equal {ticks}", flush=True)
    print(f"[4h] model axis: {host['ms_per_tick']:.2f} ms a tick (eager "
          f"windows, the measured serve's wall over {host['ticks']} ticks, "
          f"streamed finisher included) against the single host's "
          f"{one['ms_per_tick']:.2f} (CUDA graphs); collectives "
          f"{st['calls']} calls {st['bytes'] / 1e6:.1f} MB {st['ms']:.1f} "
          f"ms, {st['calls'] / max(host['ticks'], 1):.1f} calls and "
          f"{st['ms'] / max(host['ticks'], 1):.2f} ms a tick; launches "
          f"traj_masked_step {host['launches']['traj_masked_step']} "
          f"lane_noise {host['launches']['lane_noise']}; peak "
          f"{host['peak_gb'] or 0:.2f} GB a rank; walls {single_wall:.1f}s (in "
          f"this process) and {model_wall:.1f}s (the launcher)", flush=True)
    ok = keys and ticks and gap <= POD_FULL_TOL and host["model_bitwise"] \
        and host["repeat_bitwise"] and st["calls"] > 0 and \
        "windows=eager" in first and all(
            host["launches"][k] > 0 for k in ("traj_masked_step",
                                              "lane_noise"))
    if not ok:
        raise AssertionError("model-axis serve failed")
    print(f"[4h] phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    return host["launches"]


def phase_paper(dev, card: str):
    t_phase = time.perf_counter()
    ucfg = UNetConfig()
    fpi = flops_per_image(ucfg)
    f32_peak = card_rates(card)[1]
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    t0 = time.perf_counter()
    data, holdout = make_client_datasets(ClientDataConfig(
        n_clients=TRAIN_CLIENTS, per_client=PAPER_BATCH,
        image_size=IMG[0], holdout=16))
    # the initial models built once; each trainer copies their parameters
    modules = {member_seed(0, m): UNet(ucfg, seed=member_seed(0, m))
               for m in range(TRAIN_CLIENTS + 1)}
    cfg = TrainerConfig(n_clients=TRAIN_CLIENTS, T=T, cut_ratio=TRAIN_CUT,
                        step_backend="triton")

    def trainer(batched, micro):
        return CollaFuseTrainer(dataclasses.replace(cfg, batched=batched),
                                modules.__getitem__, device=dev,
                                flops_per_call=fpi, micro_batch=micro)
    print(f"[paper] the paper's protocol at full width: paper U-Net "
          f"({sum(p.numel() for p in modules[member_seed(0, 0)].parameters()):,} "
          f"parameters) x {TRAIN_CLIENTS + 1}, cosine T={T}, c={TRAIN_CUT}, "
          f"lr {cfg.lr}, clip {cfg.grad_clip}, f32 without TF32 | {card}, "
          f"{total_mem / 1e9:.1f} GB | data and models built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    # (a) where phase 4b's memory goes: one batched round at 16 a client
    # in one piece and in chunks of 16; (b) every chunked round against
    # the unchunked one of its engine, round 0 from the same models
    part_s = {}
    t_part = time.perf_counter()
    b16 = [d[:TRAIN_BATCH] for d in data]
    refs, ref_ms = {True: trainer(True, None)}, {}
    ref_ms[True], _ = memory_round(refs[True], b16, dev, "one piece")
    tr = trainer(True, MEMORY_CHUNK)
    m, peak = memory_round(tr, b16, dev, f"chunk {MEMORY_CHUNK}")
    check_chunked(tr, m, refs[True], ref_ms[True],
                  f"batched, chunk {MEMORY_CHUNK}", peak)
    del tr
    refs[False] = trainer(False, None)
    ref_ms[False] = refs[False].train_round(b16)
    for batched in (True, False):
        for micro in CHUNKS_CHECKED:
            torch.cuda.empty_cache()
            tr = trainer(batched, micro)
            torch.cuda.reset_peak_memory_stats(dev)
            m = tr.train_round(b16)
            check_chunked(tr, m, refs[batched], ref_ms[batched],
                          f"{'batched' if batched else 'looped'}, chunk "
                          f"{micro}", torch.cuda.max_memory_allocated(dev))
            del tr
    del refs
    torch.cuda.empty_cache()
    part_s["(a)+(b)"] = time.perf_counter() - t_part

    # (c) the paper's batch: 150 a client, pooled 450, on the looped
    # engine (phase 4b's faster), then on the batched one if the phase's
    # budget allows
    batches = [next(image_batches(d, PAPER_BATCH, seed=k))
               for k, d in enumerate(data)]

    def paper_rounds(batched):
        tr = trainer(batched, PAPER_MICRO)
        steps = {"server": [], "client": []}
        timed_method(tr, "_server_update", steps["server"])
        timed_method(tr, "_client_round" if batched else "_client_update",
                     steps["client"])
        n_img = TRAIN_CLIENTS * PAPER_BATCH
        step_flop = 3 * fpi * n_img
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        walls, hist = [], []
        for r in range(1 + PAPER_TIMED_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_round(batches)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            hist.append(m)
            losses = [m["server_loss"]] + m["client_losses"]
            if not all(np.isfinite(v) for v in losses):
                raise AssertionError(f"round {r}: non-finite loss {losses}")
        per_round = 1 if batched else TRAIN_CLIENTS
        s_ms = float(np.mean([event_ms(p) for p in steps["server"][1:]]))
        c_ms = float(np.mean([
            sum(event_ms(p) for p in steps["client"][i:i + per_round])
            for i in range(per_round, (1 + PAPER_TIMED_ROUNDS) * per_round,
                           per_round)]))
        w_ms = float(np.mean(walls[1:]))
        alloc = torch.cuda.max_memory_allocated(dev)
        res = torch.cuda.max_memory_reserved(dev)
        engine = "batched" if batched else "looped"
        print(f"[paper] (c) {engine}: {PAPER_BATCH} images a client, pooled "
              f"{n_img}, chunks of at most {PAPER_MICRO} images | warm-up "
              f"round "
              f"{walls[0]:.1f} ms; {PAPER_TIMED_ROUNDS} timed round(s): "
              f"round {w_ms:.1f} ms "
              f"({n_img / w_ms * 1e3:.1f} images/s), server step "
              f"{s_ms:.1f} ms ({step_flop / s_ms / 1e9:.1f} TFLOP/s, "
              f"{step_flop / s_ms / 1e9 / (f32_peak / 1e12):.1%} of "
              f"{f32_peak / 1e12:.0f}), client step{'s' if not batched else ''} "
              f"{c_ms:.1f} ms ({step_flop / c_ms / 1e9:.1f} TFLOP/s) | "
              f"max_memory_allocated {alloc / 1e9:.2f} GB, "
              f"max_memory_reserved {res / 1e9:.2f} GB of "
              f"{total_mem / 1e9:.1f} | losses server "
              f"{[round(m['server_loss'], 5) for m in hist]} client mean "
              f"{[round(m['client_loss_mean'], 5) for m in hist]}",
              flush=True)
        if max(alloc, res) >= total_mem:
            raise AssertionError("the paper's round took the card's whole "
                                 "memory")
        for name in ("_server_update", "_client_round", "_client_update"):
            tr.__dict__.pop(name, None)
        return tr, w_ms

    t_part = time.perf_counter()
    tr, looped_ms = paper_rounds(False)
    part_s["(c) looped"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (d) the checkpoint: the trained trainer saved and restored into a
    # fresh one, bitwise; trainer.sample through ddpm_step, bitwise
    with tempfile.TemporaryDirectory(prefix="chip_smoke_paper_") as tmp:
        path = os.path.join(tmp, "paper")
        t0 = time.perf_counter()
        tr.save(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path + ".npz")
        rt = trainer(False, PAPER_MICRO)
        t0 = time.perf_counter()
        rt.restore(path)
        restore_s = time.perf_counter() - t0
    same_state = all(
        torch.equal(a, b) for a, b in zip(tree_leaves(rt.state_tree()),
                                          tree_leaves(tr.state_tree())))
    x_tr = tr.sample(7, (2,) + IMG, client_idx=2)
    ops.reset_launch_counts()
    x_rt = rt.sample(7, (2,) + IMG, client_idx=2)
    n_step = ops.launch_counts()["ddpm_step"]
    print(f"[paper] (d) checkpoint: {size / 1e9:.2f} GB written in "
          f"{save_s:.1f}s, restored in {restore_s:.1f}s, round "
          f"{rt.round} | parameters and AdamW states bitwise {same_state} | "
          f"trainer.sample of the restored trainer (triton) bitwise the "
          f"original's {torch.equal(x_rt, x_tr)}, finite "
          f"{bool(torch.isfinite(x_rt).all())}, ddpm_step launches "
          f"{n_step}", flush=True)
    if not same_state or rt.round != 1 + PAPER_TIMED_ROUNDS or \
            not torch.equal(x_rt, x_tr) or \
            n_step == 0:
        raise AssertionError("the restored trainer differs, or its sample "
                             "did not run ddpm_step")

    part_s["(d) checkpoint"] = time.perf_counter() - t_part

    # (e) the paper's evaluation on the trained models
    t0 = time.perf_counter()
    ev = hc.evaluate(rt, ucfg, data, holdout, n_gen=PAPER_N_GEN)
    for k, r in enumerate(ev["per_client"]):
        print(f"[paper] (e) client {k}: KID train {r['kid_train']:.5f}, "
              f"holdout {r['kid_holdout']:.5f} | disclosure at "
              f"c={TRAIN_CUT}: MSE {r['disclosure']['mse']:.5f} KID "
              f"{r['disclosure']['kid']:.5f}", flush=True)
    vals = [ev["kid_train_sum"], ev["kid_holdout_sum"]] + [
        r["disclosure"][k] for r in ev["per_client"] for k in ("mse", "kid")]
    print(f"[paper] (e) evaluate ({PAPER_N_GEN} images a client): KID sums "
          f"train "
          f"{ev['kid_train_sum']:.5f} holdout {ev['kid_holdout_sum']:.5f}, "
          f"disclosure MSE mean {ev['disclosure_mse_mean']:.5f} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    if not all(np.isfinite(v) for v in vals):
        raise AssertionError("evaluate gave a non-finite metric")
    part_s["(e)"] = time.perf_counter() - t0
    t_part = time.perf_counter()

    # (d) serving: the restored models against the originals through the
    # engine on cuda_masked (the models leave for the CPU while the
    # trainers' cached segments are freed, as in phase 4b (f))
    served = {}
    for name, t in (("original", tr), ("restored", rt)):
        served[name] = ([t.server_model().cpu()] +
                        [t.client_model(k).cpu()
                         for k in range(TRAIN_CLIENTS)])
    del tr, rt
    torch.cuda.empty_cache()
    # a warm-up serve of one request first: after training, the first
    # serve runs other cuDNN plans than later ones (its convolutions take
    # plans whose workspace the training's memory left room for, then fall
    # back), so an unwarmed pair need not agree bit for bit
    runs, counts = {}, {}
    mix = slice_requests(n_clients=TRAIN_CLIENTS)
    for name, models, requests in (("warm-up", "original", mix[1:2]),
                                   ("original", "original", mix),
                                   ("restored", "restored", mix)):
        server, *clients = [mdl.to(dev) for mdl in served[models]]
        eng = slice_engine(server, "cuda_masked", 4, dev)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        runs[name] = eng.serve(list(requests), clients)
        counts[name] = ops.launch_counts()["traj_masked_step"]
        eng.close()
        del server, clients, eng
        print(f"[paper] (d) serve of the {models} models ({name}): "
              f"{runs[name].wall_s:.2f}s, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB "
              f"allocated, {torch.cuda.max_memory_reserved(dev) / 1e9:.2f} "
              f"GB reserved", flush=True)
    s = runs["restored"].summary
    same = bitwise(runs["restored"], runs["original"])
    diffs = {k: (max_diff(runs[k], runs["original"], "x_mid"),
                 max_diff(runs[k], runs["original"], "x0"))
             for k in ("warm-up", "restored")}
    warm_same = bitwise(runs["warm-up"], runs["original"])
    print(f"[paper] (d) the restored models serve phase 4's mix on "
          f"cuda_masked: {s['requests']} requests, {s['ticks']} ticks, "
          f"{s['images_per_s']:.3f} images/s | bitwise the original "
          f"models' serve {same} | max |d x_mid|, |d x0| against the "
          f"original's: restored {diffs['restored'][0]:.3e}, "
          f"{diffs['restored'][1]:.3e}; the warm-up's request "
          f"{diffs['warm-up'][0]:.3e}, {diffs['warm-up'][1]:.3e} (bitwise "
          f"{warm_same}) | traj_masked_step launches "
          f"{counts['restored']} (original {counts['original']})",
          flush=True)
    if not same or counts["restored"] == 0:
        raise AssertionError("the restored models serve differently, or "
                             "traj_masked_step did not launch")
    del served, runs
    torch.cuda.empty_cache()
    part_s["(d) serve"] = time.perf_counter() - t_part

    # (f) a cut-down cut_ratio_sweep at the example's default size
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rows = cut_ratio_sweep.main([
                "--device", "cuda", "--rounds", "2", "--cuts", "0.0",
                "0.8", "1.0", "--per-client", "16", "--holdout", "16",
                "--batch", "8", "--n-gen", "8", "--out-dir", tmp])
    fr = {r["cut_ratio"]: r["client_flop_fraction"] for r in rows}
    _, _, mono = cut_ratio_sweep.hypotheses(rows)
    for ln in out.getvalue().splitlines():
        if ln.startswith(("c=", "H1", "H2c")):
            print(f"[paper] (f) {ln}", flush=True)
    print(f"[paper] (f) client FLOP share by cut {fr}: monotone {mono}, "
          f"c=1.0 gives {fr[1.0]} ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    if not mono or fr[1.0] != 1.0:
        raise AssertionError("the client FLOP share is not monotone in c, "
                             "or c=1.0 is not all the client's")
    torch.cuda.empty_cache()
    part_s["(f)"] = time.perf_counter() - t0

    # (c) on the batched engine, when the budget allows it
    spent = time.perf_counter() - t_phase
    need = (1 + PAPER_TIMED_ROUNDS) * looped_ms / 1e3 * 1.5
    if spent + need <= PAPER_BUDGET_S:
        t_part = time.perf_counter()
        tr, batched_ms = paper_rounds(True)
        part_s["(c) batched"] = time.perf_counter() - t_part
        print(f"[paper] (c) batched {batched_ms:.1f} ms a round against "
              f"looped {looped_ms:.1f}: batched {looped_ms / batched_ms:.2f}x "
              f"the looped speed", flush=True)
        del tr
        torch.cuda.empty_cache()
    else:
        print(f"[paper] (c) batched: not run ({spent:.1f}s spent, ~"
              f"{need:.0f}s more would pass the {PAPER_BUDGET_S:.0f}s "
              f"budget)", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"[paper] phase wall {wall:.1f}s (budget {PAPER_BUDGET_S:.0f}s): "
          + ", ".join(f"{k} {v:.1f}s" for k, v in part_s.items()),
          flush=True)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# phase 3b: flash_attention at one Yi-6B layer's prefill shape
# ---------------------------------------------------------------------------
def attention_bound_ms(q, k, v, window, card):
    """The least time the card could take: the larger of the bytes (q, k,
    v read once, out written once) at the HBM rate and the FLOP on the
    visible pairs at the kernel's peak: bf16 on the tensor cores; float32
    as three TF32 tensor-core products (the kernel's 3xTF32).  Returns (ms,
    bound by, the float32 bound on the SIMT units in ms or None)."""
    bw, f32_peak, bf16_peak = card_rates(card)
    flops = kfa.attention_flops(q, k, causal=True, window=window)
    t_bytes = kfa.attention_bytes(q, k, v) / bw
    simt = None
    if q.dtype == torch.bfloat16:
        t_ops = flops / bf16_peak
    else:
        t_ops = 3 * flops / TF32_RATES["PCIe" if "PCIe" in card else "SXM"]
        simt = max(t_bytes, flops / f32_peak) * 1e3
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), simt


def phase_attention(dev, card: str):
    """``flash_attention`` at Yi-6B's layer shape (bf16 and f32, causal and
    with a 1024 window) and at Zamba2-7B's shared block (hd 112, bf16 and
    f32, causal).  Returns {(shape, dtype, window): (err, ms, plain ms,
    bound ms, bound by, sdpa ms or None)}."""
    rows = {}
    cases = [(ATTN_SHAPE, (0, ATTN_WINDOW)), (HYBRID_ATTN_SHAPE, (0,))]
    for shape, windows in cases:
        b, s, h, kv, hd = shape
        g = torch.Generator(device=dev).manual_seed(7)
        base = [torch.randn(sh, generator=g, device=dev)
                for sh in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in base)
            for window in windows:
                rows[(shape, dtype, window)] = attention_case(
                    q, k, v, window, card)
        del base, q, k, v
        torch.cuda.empty_cache()
    return rows


def attention_case(q, k, v, window, card):
    dtype = q.dtype
    tag = (f"{str(dtype).split('.')[-1]} causal"
           + (f" window {window}" if window else ""))
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    ref = kref.attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"flash_attention {tag}: non-finite")
    err = float((out.float() - ref.float()).abs().max())
    if err > ATTN_TOL[dtype]:
        raise AssertionError(f"flash_attention {tag}: max_abs_err "
                             f"{err:.3e} > {ATTN_TOL[dtype]}")
    del ref
    def kernel():
        return ops.flash_attention(q, k, v, causal=True, window=window)

    t_p = cuda_time_ms(lambda: kref.attention_ref(
        q, k, v, causal=True, window=window), iters=3, warmup=1)
    bound, by, simt = attention_bound_ms(q, k, v, window, card)
    flops = kfa.attention_flops(q, k, causal=True, window=window)
    lib = None
    if window:
        t_ks = [cuda_time_ms(kernel, iters=10, warmup=2)]
    else:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_err = float((sdpa().transpose(1, 2).float() -
                         out.float()).abs().max())
        # in turns: kernel, library, kernel, library
        t_ks, t_ls = [], []
        for _ in range(2):
            t_ks.append(cuda_time_ms(kernel, iters=10, warmup=2))
            t_ls.append(cuda_time_ms(sdpa, iters=10, warmup=2))
        lib = sum(t_ls) / len(t_ls)
    t_k = sum(t_ks) / len(t_ks)
    torch.cuda.empty_cache()
    turns = " ".join(f"{x:.3f}" for x in t_ks)
    line = (f"[kernels] flash_attention {tag} q {tuple(q.shape)} k "
            f"{tuple(k.shape)}: max_abs_err {err:.3e} (tolerance "
            f"{ATTN_TOL[dtype]}) | kernel {t_k:.3f} ms (runs {turns}; "
            f"{flops / t_k / 1e9:.1f} TFLOP/s on the {flops:.3e} FLOP of "
            f"the visible pairs")
    executed = (kfa.attention_flops_executed if dtype == torch.bfloat16
                else kfa.attention_flops_executed_f32)
    done = executed(q, k, causal=True, window=window)
    line += (f"; executes {done:.3e} FLOP in whole tiles, "
             f"{done / t_k / 1e9:.1f} TFLOP/s, {1 - flops / done:.1%} of it "
             "masked or padding")
    hd = q.shape[-1]
    if dtype == torch.float32 and not window and hd in ATTN_F32_EARLIER_MS:
        was = ATTN_F32_EARLIER_MS[hd]
        line += f"; the SIMT design {was} ms, {was / t_k:.2f}x faster"
    line += f") plain {t_p:.3f} ms bound {bound:.3f} ms ({by}"
    if simt is not None:
        line += (f", 3xTF32 at the TF32 peak; on the SIMT units "
                 f"{simt:.3f} ms, {simt / t_k:.1%}")
    line += f", share {bound / t_k:.1%})"
    if lib is not None:
        line += (f" | library sdpa {lib:.3f} ms (runs "
                 + " ".join(f"{x:.3f}" for x in t_ls)
                 + f"; kernel/sdpa {t_k / lib:.2f}x; vs kernel max "
                 f"{lib_err:.3e})")
    print(line, flush=True)
    return err, t_k, t_p, bound, by, lib


# ---------------------------------------------------------------------------
# phase 3c: ssm_scan at one Zamba2-7B Mamba2 layer's prefill shape
# ---------------------------------------------------------------------------
def ptxas_ssm(log: str):
    """(kernel, its types, registers, spill line) of each ``ssm_scan``
    instance in ``nvcc -Xptxas -v``'s output."""
    types = {"f": "float32", "ff": "float32, dt float32",
             "13__nv_bfloat16": "bf16", "13__nv_bfloat16S1_": "bf16, dt bf16",
             "13__nv_bfloat16f": "bf16, dt float32"}
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"(ssd_(?:scan|gram)_kernel)I(\w+?)EEv", ln)
        if m and "Compiling entry function" in ln:
            cur = (m.group(1), types.get(m.group(2), m.group(2)))
        elif cur is not None and "spill" in ln:
            spills = ln.split(":", 1)[-1].strip()
        elif cur is not None and "Used" in ln:
            rows.append(cur + (int(re.search(r"Used (\d+) registers",
                                             ln).group(1)), spills))
            cur = None
    return rows


def ssm_bounds_ms(x, dt, a, bm, cm, card: str):
    """(bytes, SIMT float32, 3xTF32) lower bounds in ms of one call: the
    bytes over the memory rate; the least FLOP (``ssd_flops``) over the
    float32 SIMT peak; and the same FLOP as three TF32 tensor-core products
    each over the TF32 peak."""
    bw, f32_peak, _ = card_rates(card)
    tf32_peak = TF32_RATES["PCIe" if "PCIe" in card else "SXM"]
    flops = kssm.ssd_flops(x, bm)
    return (kssm.ssd_bytes(x, dt, a, bm, cm) / bw * 1e3,
            flops / f32_peak * 1e3, 3 * flops / tf32_peak * 1e3)


def phase_ssm(dev, card: str):
    """``ssm_scan`` against ``ssm_scan_ref``: float32 x, dt, bm and cm, as
    ``ssm_forward`` feeds the kernel (the path), and bf16 x, bm and cm with
    float32 dt.  Prints the grid, its rounds of the card's block slots, the
    shared memory and ptxas's registers and spills, and the time beside the
    earlier design's and both bounds.  Returns {dtype: (max abs err, ms,
    plain ms, bound ms, bound by)}, the bound under the kernel's 3xTF32
    contract."""
    b, s, nh, p, n = SSM_SHAPE
    for kern, types, regs, spills in ptxas_ssm(build.LOGS.get("ssm_scan",
                                                              "")):
        print(f"[kernels] ssm_scan ptxas: {kern} ({types}): {regs} "
              f"registers, {spills}", flush=True)
    grid = kssm.grid_for(b, nh)
    n_sm = kssm.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    base = (torch.randn((b, s, nh, p), generator=g, device=dev),
            torch.nn.functional.softplus(
                torch.randn((b, s, nh), generator=g, device=dev)),
            -torch.exp(0.3 * torch.randn(nh, generator=g, device=dev)),
            torch.randn((b, s, n), generator=g, device=dev),
            torch.randn((b, s, n), generator=g, device=dev))
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, a, bm, cm = (base[0].to(dtype), base[1], base[2],
                            base[3].to(dtype), base[4].to(dtype))
        tag = f"{str(dtype).split('.')[-1]} x (dt float32)"
        y = ops.ssm_scan(x, dt, a, bm, cm)
        ref = kref.ssm_scan_ref(x, dt, a, bm, cm)
        torch.cuda.synchronize()
        if not torch.isfinite(y).all():
            raise AssertionError(f"ssm_scan {tag}: non-finite")
        err = float((y.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if err > SSM_TOL[dtype] * scale:
            raise AssertionError(f"ssm_scan {tag}: max_abs_err {err:.3e} > "
                                 f"{SSM_TOL[dtype]} x max |y| {scale:.3f}")
        if not torch.equal(y, ops.ssm_scan(x, dt, a, bm, cm)):
            raise AssertionError(f"ssm_scan {tag}: two calls differ")
        del y, ref
        args = (x, dt, a, bm, cm)
        t_k = cuda_time_ms(lambda: ops.ssm_scan(*args), iters=10, warmup=2)
        t_p = cuda_time_ms(lambda: kref.ssm_scan_ref(*args), iters=2,
                           warmup=1)
        flops = kssm.ssd_flops(x, bm)          # the least the function needs
        done = kssm.ssd_flops_executed(x, bm)  # what the kernel executes
        t_bytes, t_simt, t_3x = ssm_bounds_ms(x, dt, a, bm, cm, card)
        bound = max(t_bytes, t_3x)
        by = "bytes" if t_bytes >= t_3x else "operations"
        per_sm = kssm.blocks_per_sm(dtype, dt.dtype)
        n_blocks = grid[0] * grid[1]
        was = (f"the SIMT design {SSM_EARLIER_MS} ms, "
               f"{SSM_EARLIER_MS / t_k:.2f}x faster; "
               if dtype == torch.float32 else "")
        torch.cuda.empty_cache()
        print(f"[kernels] ssm_scan {tag} x {tuple(x.shape)} N {n}: "
              f"max_abs_err {err:.3e} (max |y| {scale:.3f}, tolerance "
              f"{SSM_TOL[dtype]} of it), two calls bitwise equal | grid "
              f"{grid} = {n_blocks} blocks of {kssm.smem_bytes()} bytes of "
              f"shared memory, {per_sm} a SM, {n_blocks / (per_sm * n_sm):.2f}"
              f" rounds of {per_sm * n_sm} slots | kernel {t_k:.3f} ms "
              f"({was}{done / t_k / 1e9:.1f} TFLOP/s on the {done:.3e} FLOP "
              f"it executes) plain {t_p:.3f} ms | bounds on the least "
              f"{flops:.3e} FLOP: bytes {t_bytes:.3f} ms, SIMT float32 "
              f"{t_simt:.3f} ms, 3xTF32 {t_3x:.3f} ms; the products are "
              f"3xTF32, so bound {bound:.3f} ms ({by}, share "
              f"{bound / t_k:.1%}) | library none", flush=True)
        rows[dtype] = (err, t_k, t_p, bound, by)
    del base
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 5: the LM slice, Yi-6B at full width and depth
# ---------------------------------------------------------------------------
def logit_gap(name, got, want, tol_max=LM_TOL_MAX, tol_mean=LM_TOL_MEAN,
              tag="lm"):
    """Max and mean |Δ| of two logit tensors, held to the tolerances (a
    ``tol_max`` of None holds the mean alone); computed a batch row at a
    time, so no float32 copy of the whole logits is made."""
    mx, total, top, finite = 0.0, 0.0, 0.0, True
    for g_row, w_row in zip(got, want):
        d = (g_row.float() - w_row.float()).abs()
        mx = max(mx, float(d.max()))
        total += float(d.sum(dtype=torch.float64))
        top = max(top, float(w_row.float().abs().max()))
        finite = finite and bool(torch.isfinite(g_row).all())
        del d
    mean = total / got.numel()
    held = (f"max {tol_max} " if tol_max is not None else "") + \
        f"mean {tol_mean}"
    print(f"[{tag}] {name}: max |dlogit| {mx:.4g} mean {mean:.4g} "
          f"(tolerance {held}; logits max {top:.3f})", flush=True)
    if not finite:
        raise AssertionError(f"{name}: non-finite logits")
    if (tol_max is not None and mx > tol_max) or mean > tol_mean:
        raise AssertionError(f"{name}: logits disagree")


def phase_lm(dev, card: str):
    _, _, bf16_peak = card_rates(card)
    cfg = get_config("yi-6b")
    b, s = ATTN_SHAPE[:2]
    t0 = time.perf_counter()
    model = tf.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} params, config says "
                             f"{cfg.param_count()}")
    print(f"[lm] yi-6b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV, {cfg.dtype}; "
          f"{n_params} params ({n_params * 2 / 1e9:.1f} GB) drawn in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    g = torch.Generator(device=dev).manual_seed(11)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                     device=dev)}
    flops = cfg.flops_per_token_fwd(s) * b * s

    # (a) prefill through the kernel: one counted run, then timed runs
    prefill = make_prefill_step(cfg, kernel="flash")
    prefill(model, batch)                                    # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    logits = prefill(model, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if counts["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"flash_attention launched "
                             f"{counts['flash_attention']} times in one "
                             f"prefill, not {cfg.n_layers}")
    if logits.shape != (b, s, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        prefill(model, batch)
    torch.cuda.synchronize()
    t_pre = (time.perf_counter() - t0) / reps
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"[lm] (a) prefill {b}x{s} kernel=flash: {t_pre * 1e3:.1f} ms, "
          f"{b * s / t_pre:.0f} tokens/s, {flops / t_pre / 1e12:.1f} TFLOP/s "
          f"of {bf16_peak / 1e12:.0f} ({flops / t_pre / bf16_peak:.1%}) on "
          f"{flops:.3e} FLOP | flash_attention launches "
          f"{counts['flash_attention']} a call | peak "
          f"memory {peak_gb:.1f} GB", flush=True)
    prof = profile_device(f"yi-6b prefill {b}x{s}",
                          lambda: prefill(model, batch), reps=1)
    attn_ms = sum(ms for k, ms in prof.items() if "flash_attention" in k)
    if prof:
        print(f"[lm] flash_attention {attn_ms:.1f} ms of "
              f"{sum(prof.values()):.1f} ms device time in a prefill "
              f"({attn_ms / sum(prof.values()):.1%})", flush=True)

    # (b) the same batch through blockwise PyTorch attention
    t0 = time.perf_counter()
    logits_t = make_prefill_step(cfg, kernel="torch")(model, batch)
    torch.cuda.synchronize()
    print(f"[lm] (b) prefill kernel=torch: {(time.perf_counter() - t0) * 1e3:.1f}"
          f" ms (one call)", flush=True)
    logit_gap("(b) flash vs torch prefill", logits, logits_t)
    del logits_t

    # (c) 64 chained cached decode steps over one prompt's first positions
    n_dec = 64
    decode = make_decode_step(cfg)
    cache = tf.init_cache(cfg, 1, n_dec, device=dev)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pos in range(n_dec):
        lg, cache = decode(model, cache,
                           {"tokens": batch["tokens"][:1, pos:pos + 1]}, pos)
        outs.append(lg[:, 0])
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / n_dec
    print(f"[lm] (c) {n_dec} chained decode steps at batch 1: "
          f"{t_dec * 1e3:.2f} ms a step", flush=True)
    logit_gap("(c) decode chain vs prefill", torch.stack(outs, 1),
              logits[:1, :n_dec])
    last = {"tokens": batch["tokens"][:1, n_dec - 1:n_dec]}
    profile_device("yi-6b decode step at batch 1",      # rewrites one slot
                   lambda: decode(model, cache, last, n_dec - 1))
    del model, cache, logits, outs
    torch.cuda.empty_cache()

    # (d) the serving launcher at full width
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stats = lm_serve.main(["--arch", "yi-6b", "--no-reduced",
                               "--requests", "2", "--batch", "4",
                               "--prompt-len", "32", "--tokens", "16"])
    for line in buf.getvalue().splitlines():
        print(f"[lm] (d) {line}", flush=True)
    if "serving loop OK" not in buf.getvalue():
        raise AssertionError("the launcher did not print 'serving loop OK'")
    print(f"[lm] (d) launcher decode {stats[-1]['tok_s']:.1f} tokens/s at "
          f"batch 4 (request 1), cache fill of 4x32 in "
          f"{stats[-1]['prefill_s']:.2f}s", flush=True)
    torch.cuda.empty_cache()
    return {"counts": counts, "ms": t_pre * 1e3, "peak_gb": peak_gb}


# ---------------------------------------------------------------------------
# phase 6: the hybrid slice, Zamba2-7B at full width and depth
# ---------------------------------------------------------------------------
def block_gaps(model, cfg, tokens, n_dec):
    """Each block of the hybrid held alone, on the input the kernels' path
    gives it (teacher-forced, so no block inherits another's rounding), on
    its own output before the residual add (``mix``), which the residual
    stream would dwarf: kernel="flash" against kernel="torch" over the
    whole batch; and the cached decode chain over batch row 0's first
    ``n_dec`` positions against the flash output.  The chain runs through
    ``decode_step`` at full depth, its caches as ``init_cache`` and
    ``decode_step`` map them (one KV cache to each application of the
    shared block), with each block's input replaced by its teacher-forced
    one.  Returns the worst ratios {"prefill" | "decode": (max |Δ| / max
    |mix|, mean |Δ| / mean |mix|)}."""
    worst = {"prefill": (0.0, 0.0), "decode": (0.0, 0.0)}

    def note(key, got, want):
        d = (got.float() - want.float()).abs()
        w = want.float().abs()
        r = (float(d.max() / w.max()), float(d.mean() / w.mean()))
        worst[key] = tuple(max(a, b) for a, b in zip(worst[key], r))

    ins, mixes = [], []
    with torch.inference_mode():
        h = model.embed.embed(tokens)
        for blk in model.blocks():
            m = blk.mix(h, kernel="flash")
            note("prefill", blk.mix(h, kernel="torch"), m)
            ins.append(h[:1, :n_dec].clone())
            mixes.append(m[:1, :n_dec].clone())
            h = h + m                     # blk(h, kernel="flash")
        del h, m
        outs = [[] for _ in ins]
        calls = itertools.count()

        def forced(x, cache, pos, *, window=0, ctx=None, blk):
            j = next(calls) % len(ins)    # decode_step walks blocks() order
            x = ins[j][:, pos:pos + 1]
            a, cache = blk.mix_decode(x, cache, pos, window=window)
            outs[j].append(a)
            return x + a, cache

        shared = {id(blk): blk for blk in model.blocks()}.values()
        for blk in shared:
            blk.decode = functools.partial(forced, blk=blk)
        try:
            decode = make_decode_step(cfg)
            cache = tf.init_cache(cfg, 1, n_dec, device=tokens.device)
            for pos in range(n_dec):
                decode(model, cache, {"tokens": tokens[:1, pos:pos + 1]}, pos)
        finally:
            for blk in shared:
                del blk.decode
        if next(calls) != n_dec * len(ins):
            raise AssertionError("decode_step did not run every block once "
                                 "a step")
        for o, m in zip(outs, mixes):
            note("decode", torch.cat(o, dim=1), m)
    return worst


def phase_hybrid(dev, card: str):
    _, _, bf16_peak = card_rates(card)
    cfg = get_config("zamba2-7b")
    b, s = SSM_SHAPE[:2]
    g_groups, k, rem = tf.hybrid_layout(cfg)
    n_attn = g_groups + (1 if rem else 0)
    t0 = time.perf_counter()
    model = tf.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    # the reference's param_count counts the shared block's norm twice: its
    # tree (and so the port) holds param_count() - d_model parameters
    if n_params != cfg.param_count() - cfg.d_model:
        raise AssertionError(f"{n_params} params, the reference tree holds "
                             f"{cfg.param_count() - cfg.d_model}")
    print(f"[hybrid] zamba2-7b: {cfg.n_layers} Mamba2 layers ({g_groups} "
          f"groups of {k}, remainder {rem}), shared attention x{n_attn} "
          f"({cfg.n_heads} heads of {cfg.head_dim}), d_model {cfg.d_model}, "
          f"{cfg.dtype}; {n_params} params ({n_params * 2 / 1e9:.1f} GB) "
          f"drawn in {time.perf_counter() - t0:.1f}s", flush=True)
    g = torch.Generator(device=dev).manual_seed(11)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                     device=dev)}
    flops = cfg.flops_per_token_fwd(s) * b * s

    # (a) prefill through the kernels: one counted run, then timed runs
    prefill = make_prefill_step(cfg, kernel="flash")
    prefill(model, batch)                                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    logits = prefill(model, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {"ssm_scan": cfg.n_layers, "flash_attention": n_attn}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name} launched {counts[name]} times in "
                                 f"one prefill, not {n}")
    if logits.shape != (b, s, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        prefill(model, batch)
    torch.cuda.synchronize()
    t_pre = (time.perf_counter() - t0) / reps
    print(f"[hybrid] (a) prefill {b}x{s} kernel=flash: {t_pre * 1e3:.1f} ms, "
          f"{b * s / t_pre:.0f} tokens/s, {flops / t_pre / 1e12:.1f} TFLOP/s "
          f"of {bf16_peak / 1e12:.0f} ({flops / t_pre / bf16_peak:.1%}) on "
          f"{flops:.3e} FLOP | launches a call: ssm_scan "
          f"{counts['ssm_scan']}, flash_attention "
          f"{counts['flash_attention']} | peak memory {peak_gb:.1f} GB",
          flush=True)
    prof = profile_device(f"zamba2-7b prefill {b}x{s}",
                          lambda: prefill(model, batch), reps=1)
    if prof:
        total = sum(prof.values())
        for name, symbols in KERNEL_SYMBOLS.items():
            ms = sum(v for key, v in prof.items()
                     if any(sym in key for sym in symbols))
            print(f"[hybrid] {name} {ms:.1f} ms of {total:.1f} ms device "
                  f"time in a prefill ({ms / total:.1%})", flush=True)

    # (b) the same batch through plain PyTorch: the chunk loop, blockwise
    # attention
    t0 = time.perf_counter()
    logits_t = make_prefill_step(cfg, kernel="torch")(model, batch)
    torch.cuda.synchronize()
    print(f"[hybrid] (b) prefill kernel=torch: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (one call)", flush=True)
    logit_gap("(b) flash vs torch prefill", logits, logits_t, None,
              HYBRID_TOL_MEAN, "hybrid")
    del logits_t

    # (b') each block's own output alone on the kernels' path: flash vs
    # torch, and decode_step's chain over the first n_dec positions
    n_dec = HYBRID_DECODE_STEPS
    t0 = time.perf_counter()
    worst = block_gaps(model, cfg, batch["tokens"], n_dec)
    for key, (r_max, r_mean) in worst.items():
        print(f"[hybrid] (b') worst block, {key} vs flash: max |d| "
              f"{r_max:.5f} of max |mix|, mean {r_mean:.6f} of mean |mix| "
              f"(tolerance {BLOCK_TOL_MAX} and {BLOCK_TOL_MEAN})", flush=True)
        if r_max > BLOCK_TOL_MAX or r_mean > BLOCK_TOL_MEAN:
            raise AssertionError(f"a block's {key} disagrees with its "
                                 "kernels' output")
    print(f"[hybrid] (b') {cfg.n_layers + n_attn} blocks checked in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    # (c) chained cached decode steps over one prompt's first positions
    decode = make_decode_step(cfg)
    cache = tf.init_cache(cfg, 1, n_dec, device=dev)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pos in range(n_dec):
        lg, cache = decode(model, cache,
                           {"tokens": batch["tokens"][:1, pos:pos + 1]}, pos)
        outs.append(lg[:, 0])
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / n_dec
    print(f"[hybrid] (c) {n_dec} chained decode steps at batch 1: "
          f"{t_dec * 1e3:.2f} ms a step", flush=True)
    logit_gap("(c) decode chain vs prefill", torch.stack(outs, 1),
              logits[:1, :n_dec], None, HYBRID_TOL_MEAN, "hybrid")
    last = {"tokens": batch["tokens"][:1, n_dec - 1:n_dec]}
    profile_device("zamba2-7b decode step at batch 1",   # after the check
                   lambda: decode(model, cache, last, n_dec - 1))
    del model, cache, logits, outs
    torch.cuda.empty_cache()

    # (d) the serving launcher at full width
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stats = lm_serve.main(["--arch", "zamba2-7b", "--no-reduced",
                               "--requests", "2", "--batch", "4",
                               "--prompt-len", "16", "--tokens", "8"])
    for line in buf.getvalue().splitlines():
        print(f"[hybrid] (d) {line}", flush=True)
    if "serving loop OK" not in buf.getvalue():
        raise AssertionError("the launcher did not print 'serving loop OK'")
    print(f"[hybrid] (d) launcher decode {stats[-1]['tok_s']:.1f} tokens/s "
          f"at batch 4 (request 1), cache fill of 4x16 in "
          f"{stats[-1]['prefill_s']:.2f}s", flush=True)
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 7: the MoE family, DeepSeek-V2 (MLA) and Kimi-K2 (GQA) at full width
# ---------------------------------------------------------------------------
# (arch, n_layers): only the depth is cut.  DeepSeek-V2 at 4 layers (the
# dense layer and 3 MoE layers) holds 13.30e9 parameters, 26.6 GB in bf16;
# Kimi-K2 at 2 (the dense layer and 1 MoE layer) 19.97e9, 39.9 GB: one of
# its MoE layers alone is 34.2 GB, so 3 layers (74.1 GB) would not fit.
MOE_MODELS = (("deepseek-v2-236b", 4), ("kimi-k2-1t-a32b", 2))
MOE_SHAPE = (4, 2048)
# DeepSeek-V2's blockwise MLA holds (B, 128, 2048, 2048) float32 scores,
# 8.6 GB a live copy at B = 4: the batch drops to 2 when a 1-row probe
# says the allocator's peak would pass this
MOE_PEAK_GB = 75.0
MOE_DECODE_STEPS = 64
# Tolerances, reasoned on a CPU proxy (tools/moe_proxy.py --device cpu: the
# models' widths and phase 7's depths in bf16, the experts cut to d_ff 256
# and the vocabulary to 32000, one row of 512 tokens) and, for (b), on the
# card.  (b) The MoE layer against the per-expert loop: the same kept and
# dropped counts, exactly.  Outputs: on the CPU both paths take exact
# float32 products and differ by max |d| 0.0024 of max |out| (one bf16
# ulp) and mean 2e-6 of mean |out|; on an H100 by max 0.0082-0.0088 and
# mean 2.9e-4-3.5e-4: the tensor cores' bf16 products with a float32
# result (cuBLAS) are not the loop's exact float32 sums (a gate product
# 5.3e-5 apart at 5.47, tools/moe_proxy.py --parts), so 0.4 % of the
# rounded silu·up flip by one ulp and 6-9 % of the outputs with them.
# Held: max 2^-5 and mean 2^-9 (half a bf16 ulp on average, 5x the card's);
# a missing shared expert, an unweighted combine or 1 % of rows misrouted
# moves the mean by more than 0.01.  (b) Kimi-K2 through kernel="torch"
# against "flash": 99.07 % of the routing decisions agree (a few near-ties
# flip on bf16 differences of the hidden state), logits mean |d| 0.0113,
# max 0.48 (a flipped token moves by a whole expert's share).  Held:
# agreement >= 97 % and mean <= 0.03; the max is printed, not held.
# (c) The batch-1 decode chain (MLA's absorbed decode multiplies in another
# order than the expanded prefill) against the dropless prefill of its 64
# tokens: mean |d| 0.0265 (DeepSeek-V2) and 0.0106 (Kimi-K2), max 0.50 and
# 0.46, against a mean |logit| of ~0.8; held: mean <= 0.06, the max
# printed.  A wrong cache slot or mask reads like unrelated logits, a mean
# near 1.
MOE_TOL = dict(layer_max=2.0 ** -5, layer_mean=2.0 ** -9, route_floor=0.97,
               torch_mean=0.03, decode_max=None, decode_mean=0.06)


def moe_config(arch: str, layers: int):
    return dataclasses.replace(get_config(arch), n_layers=layers)


@contextlib.contextmanager
def moe_recorder():
    """Record every MoE call while the block runs: its input and module
    (``inputs``) and its routing (``routes``: top_i and keep), by wrapping
    ``moe_forward`` and ``dispatch_indices`` in their module."""
    rec = {"inputs": [], "routes": []}
    fwd, disp = moe_mod.moe_forward, moe_mod.dispatch_indices

    def moe_forward(x, p, cfg, ctx=None):
        rec["inputs"].append((x, p))
        return fwd(x, p, cfg, ctx)

    def dispatch_indices(top_i, n_experts, capacity):
        pos, keep = disp(top_i, n_experts, capacity)
        rec["routes"].append((top_i, keep))
        return pos, keep
    moe_mod.moe_forward, moe_mod.dispatch_indices = moe_forward, \
        dispatch_indices
    try:
        yield rec
    finally:
        moe_mod.moe_forward, moe_mod.dispatch_indices = fwd, disp


def plain_moe(x, p, cfg):
    """One MoE layer computed independently of the capacity buffer: its
    own float32 router and top-k; then, expert by expert, the (token, k)
    assignments to it in row-major order, the first ``capacity`` kept, the
    kept tokens' SwiGLU in float32 (silu·up and the output rounded to x's
    dtype, as the reference rounds them), each output times its rounded
    weight added into a float32 sum; the shared experts alike.  Returns
    (out in x's dtype, kept, dropped)."""
    d = x.shape[-1]
    f32 = torch.float32
    xf = x.reshape(-1, d)
    n, k, e = xf.shape[0], cfg.top_k, cfg.n_experts
    probs = torch.softmax(xf.to(f32) @ p.router.to(f32), dim=-1)
    top_p, top_i = probs.topk(k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = max(1, math.ceil(n * k * cfg.capacity_factor / e))
    out = torch.zeros((n, d), dtype=f32, device=x.device)
    kept = 0

    def swiglu(xs, wg, wu, wd):
        h = (F.silu(xs @ wg.to(f32)) * (xs @ wu.to(f32))).to(x.dtype)
        return (h.to(f32) @ wd.to(f32)).to(x.dtype).to(f32)

    for j in range(e):
        rows, cols = torch.nonzero(top_i == j, as_tuple=True)  # row-major
        rows, cols = rows[:cap], cols[:cap]
        kept += len(rows)
        if len(rows):
            y = swiglu(xf[rows].to(f32), p.w_gate[j], p.w_up[j], p.w_down[j])
            w = top_p[rows, cols].to(x.dtype).to(f32)
            out.index_add_(0, rows, w[:, None] * y)
    out = out.to(x.dtype)
    if p.shared is not None:
        sh = p.shared
        out = out + swiglu(xf.to(f32), sh.w_gate, sh.w_up,
                           sh.w_down).to(x.dtype)
    return out.reshape(x.shape), kept, n * k - kept


def route_agreement(a, b) -> float:
    """The share of (token, k) decisions of routing ``a`` (N, k) whose
    expert routing ``b`` also picks for that token."""
    return float((a[:, :, None] == b[:, None, :]).any(-1).float().mean())


def moe_layer_split(x, p, cfg):
    """Device ms of one MoE layer's parts on input ``x`` (CUDA events, 3
    calls each after one): router and dispatch (router, slots, scatter),
    the expert products, the combine, the shared experts, the whole."""
    xf = x.reshape(-1, x.shape[-1])
    e = cfg.n_experts
    cap = moe_mod.capacity(xf.shape[0], cfg.top_k, e, cfg.capacity_factor)
    top_p, top_i, _ = moe_mod.router_topk(xf, p.router, cfg.top_k)
    pos, keep = moe_mod.dispatch_indices(top_i, e, cap)
    buf = moe_mod.scatter_dispatch(xf, top_i, pos, keep, e, cap)
    ys = moe_mod.expert_ffn(buf, p.w_gate, p.w_up, p.w_down)

    def route():
        tp, ti, _ = moe_mod.router_topk(xf, p.router, cfg.top_k)
        ps, kp = moe_mod.dispatch_indices(ti, e, cap)
        return moe_mod.scatter_dispatch(xf, ti, ps, kp, e, cap)
    parts = {
        "router+dispatch": route,
        "experts": lambda: moe_mod.expert_ffn(buf, p.w_gate, p.w_up,
                                              p.w_down),
        "combine": lambda: moe_mod.gather_combine(ys, top_i, top_p, pos,
                                                  keep),
    }
    if p.shared is not None:
        parts["shared"] = lambda: moe_mod.shared_expert(xf, p.shared)
    parts["whole"] = lambda: moe_mod.moe_forward(x, p, cfg)
    with torch.inference_mode():
        return {name: events_ms(fn, 3) for name, fn in parts.items()}


def moe_model(dev, card: str, arch: str, layers: int):
    """Phase 7's (a)-(c) for one model; returns its prefill's launches."""
    _, _, bf16_peak = card_rates(card)
    full = get_config(arch)
    cfg = moe_config(arch, layers)
    tag = "moe"
    t0 = time.perf_counter()
    model = tf.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(q.numel() for q in model.parameters())
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} params, config says "
                             f"{cfg.param_count()}")
    n_moe = cfg.n_layers - cfg.first_dense
    print(f"[{tag}] {arch}: reduced depth {layers} of {full.n_layers} "
          f"layers ({cfg.first_dense} dense, {n_moe} MoE), nothing else "
          f"cut: d_model {cfg.d_model}, {cfg.attn_type} {cfg.n_heads} heads"
          + (f" / {cfg.n_kv_heads} KV of {cfg.head_dim}"
             if cfg.attn_type == "gqa" else
             f" (r {cfg.kv_lora_rank}, qr {cfg.q_lora_rank}, nope "
             f"{cfg.qk_nope_dim}, rope {cfg.qk_rope_dim}, v "
             f"{cfg.v_head_dim})")
          + f", {cfg.n_experts} experts top-{cfg.top_k} + "
          f"{cfg.n_shared_experts} shared of {cfg.d_ff_expert}, "
          f"capacity_factor {cfg.capacity_factor}, {cfg.dtype}; {n_params} "
          f"params ({n_params * 2 / 1e9:.1f} GB) drawn in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    b, s = MOE_SHAPE
    g = torch.Generator(device=dev).manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
    prefill = make_prefill_step(cfg, kernel="flash")

    # (a) the batch: a 1-row probe's peak above the resident weights,
    # scaled to B rows, against MOE_PEAK_GB
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    prefill(model, {"tokens": tokens[:1]})
    torch.cuda.synchronize()
    per_row = torch.cuda.max_memory_allocated(dev) - base
    est = (base + b * per_row) / 1e9
    if est > MOE_PEAK_GB:
        b = 2
    print(f"[{tag}] (a) batch probe: 1x{s} peaks {per_row / 1e9:.2f} GB "
          f"above {base / 1e9:.2f} GB resident; {MOE_SHAPE[0]}x{s} would "
          f"peak ~{est:.1f} GB (limit {MOE_PEAK_GB}): batch {b}x{s} runs",
          flush=True)
    batch = {"tokens": tokens[:b]}
    flops = cfg.flops_per_token_fwd(s) * b * s
    prefill(model, batch)                                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    with moe_recorder() as rec:
        logits = prefill(model, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    want = cfg.n_layers if cfg.attn_type == "gqa" else 0
    if counts["flash_attention"] != want:
        raise AssertionError(f"flash_attention launched "
                             f"{counts['flash_attention']} times in one "
                             f"prefill, not {want}")
    if logits.shape != (b, s, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    if len(rec["routes"]) != n_moe:
        raise AssertionError(f"{len(rec['routes'])} MoE calls, not {n_moe}")
    cap = moe_mod.capacity(b * s, cfg.top_k, cfg.n_experts,
                           cfg.capacity_factor)
    dropped = [float((~keep).float().mean()) for _, keep in rec["routes"]]
    reps = 2
    t0 = time.perf_counter()
    for _ in range(reps):
        prefill(model, batch)
    torch.cuda.synchronize()
    t_pre = (time.perf_counter() - t0) / reps
    print(f"[{tag}] (a) prefill {b}x{s} kernel=flash: {t_pre * 1e3:.1f} ms, "
          f"{b * s / t_pre:.0f} tokens/s, {flops / t_pre / 1e12:.1f} TFLOP/s "
          f"of {bf16_peak / 1e12:.0f} ({flops / t_pre / bf16_peak:.1%}) on "
          f"{flops:.3e} FLOP | flash_attention launches "
          f"{counts['flash_attention']} a call | peak memory {peak_gb:.1f} "
          f"GB | capacity {cap} slots an expert, assignments dropped at cf "
          f"{cfg.capacity_factor}: "
          + ", ".join(f"{d:.3%}" for d in dropped) + " by MoE layer",
          flush=True)
    prof = profile_device(f"{arch} prefill {b}x{s}",
                          lambda: prefill(model, batch), reps=1)
    x, p = rec["inputs"][0]
    split = moe_layer_split(x, p, cfg)
    whole = split.pop("whole")
    print(f"[{tag}] (a) MoE layer 1 on the prefill's {b * s} tokens "
          f"(CUDA events): {whole:.2f} ms = "
          + ", ".join(f"{k} {v:.2f} ({v / whole:.1%})"
                      for k, v in split.items())
          + f"; {n_moe} MoE layers {n_moe * whole:.1f} ms of the prefill's "
          f"{t_pre * 1e3:.1f}"
          + (f" (device busy {sum(prof.values()):.1f} ms)" if prof else ""),
          flush=True)

    # (b) the first MoE layer on (a)'s hidden states against a per-expert
    # loop that shares no code with the capacity buffer
    with torch.inference_mode():
        got, _ = moe_mod.moe_forward(x, p, cfg)
        want_out, kept, drop = plain_moe(x, p, cfg)
    keep0 = rec["routes"][0][1]
    k_kept = int(keep0.sum())
    print(f"[{tag}] (b) MoE layer 1 vs the per-expert loop: kept {k_kept} / "
          f"{kept}, dropped {keep0.numel() - k_kept} / {drop}", flush=True)
    if (k_kept, keep0.numel() - k_kept) != (kept, drop):
        raise AssertionError("the capacity buffer kept other assignments "
                             "than the per-expert loop")
    dlt = (got.float() - want_out.float()).abs()
    w = want_out.float().abs()
    r_max, r_mean = float(dlt.max() / w.max()), float(dlt.mean() / w.mean())
    print(f"[{tag}] (b) outputs: max |d| {r_max:.5f} of max |out| "
          f"{float(w.max()):.4f}, mean {r_mean:.6f} of mean |out| "
          f"(tolerance {MOE_TOL['layer_max']} and {MOE_TOL['layer_mean']})",
          flush=True)
    if r_max > MOE_TOL["layer_max"] or r_mean > MOE_TOL["layer_mean"]:
        raise AssertionError("the MoE layer disagrees with the per-expert "
                             "loop")
    del got, want_out, dlt, w, x, p, rec
    if cfg.attn_type == "gqa":
        # the same batch through blockwise PyTorch attention: routing and
        # logits (MLA runs blockwise attention either way)
        with moe_recorder() as rec_t:
            logits_t = make_prefill_step(cfg, kernel="torch")(model, batch)
        with moe_recorder() as rec_f:
            prefill(model, batch)
        shares = [route_agreement(a[0], c[0])
                  for a, c in zip(rec_f["routes"], rec_t["routes"])]
        print(f"[{tag}] (b) kernel=torch prefill: routing decisions that "
              "agree with kernel=flash: "
              + ", ".join(f"{v:.4%}" for v in shares)
              + f" by MoE layer (floor {MOE_TOL['route_floor']})", flush=True)
        if min(shares) < MOE_TOL["route_floor"]:
            raise AssertionError("routing disagrees between the kernels")
        logit_gap("(b) flash vs torch prefill", logits, logits_t, None,
                  MOE_TOL["torch_mean"], tag)
        del logits_t, rec_t, rec_f
    del logits
    torch.cuda.empty_cache()

    # (c) batch-1 decode chain against the dropless prefill of its tokens
    n_dec = MOE_DECODE_STEPS
    dropless = dataclasses.replace(cfg,
                                   capacity_factor=float(cfg.n_experts))
    first = {"tokens": tokens[:1, :n_dec]}
    ref = make_prefill_step(dropless)(model, first)
    decode = make_decode_step(cfg)
    cache = tf.init_cache(cfg, 1, n_dec, device=dev)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with moe_recorder() as rec_d:
        for pos in range(n_dec):
            lg, cache = decode(model, cache,
                               {"tokens": first["tokens"][:, pos:pos + 1]},
                               pos)
            outs.append(lg[:, 0])
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / n_dec
    if not all(bool(keep.all()) for _, keep in rec_d["routes"]):
        raise AssertionError("a batch-1 decode step dropped an assignment")
    print(f"[{tag}] (c) {n_dec} chained decode steps at batch 1 (capacity "
          f"{moe_mod.capacity(1, cfg.top_k, cfg.n_experts, cfg.capacity_factor)}"
          f", nothing dropped): {t_dec * 1e3:.2f} ms a step (wall); the "
          f"prefill of the same tokens at capacity_factor "
          f"{dropless.capacity_factor}", flush=True)
    logit_gap("(c) decode chain vs dropless prefill", torch.stack(outs, 1),
              ref, MOE_TOL["decode_max"], MOE_TOL["decode_mean"], tag)
    last = {"tokens": first["tokens"][:, n_dec - 1:]}
    profile_device(f"{arch} decode step at batch 1",  # rewrites one slot
                   lambda: decode(model, cache, last, n_dec - 1))
    del model, cache, ref, outs
    torch.cuda.empty_cache()
    return counts


def phase_moe(dev, card: str):
    """Phase 7: each MoE model's (a)-(c), then (d) the launcher on each
    reduced member and ``serve_decode`` on DeepSeek-V2's."""
    t_phase = time.perf_counter()
    counts = {}
    for arch, layers in MOE_MODELS:
        counts[arch] = moe_model(dev, card, arch, layers)
        torch.cuda.empty_cache()
    for arch, _ in MOE_MODELS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stats = lm_serve.main(["--arch", arch, "--requests", "2",
                                   "--batch", "4", "--prompt-len", "16",
                                   "--tokens", "8"])
        for line in buf.getvalue().splitlines():
            print(f"[moe] (d) {line}", flush=True)
        if "serving loop OK" not in buf.getvalue():
            raise AssertionError("the launcher did not print 'serving loop "
                                 "OK'")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_decode.main(["--arch", "deepseek-v2-236b"])
    for line in buf.getvalue().splitlines():
        print(f"[moe] (d) serve_decode: {line}", flush=True)
    if buf.getvalue().splitlines()[-1] != "OK":
        raise AssertionError("serve_decode did not print 'OK'")
    print(f"[moe] phase wall {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 8: the last LM families at full width and depth
# ---------------------------------------------------------------------------
FAMILY_SHAPE = (4, 2048)
# 16 (64 before the model-axis phases and 32 until a run on a slower host
# took 1,188 s of the script's 1,200)
FAMILY_DECODE_STEPS = 16
# flash_attention at a Qwen2-VL-2B layer's prefill (12 heads, 2 KV, hd 128)
# and a MusicGen-large layer's (MHA 32/32, hd 64): (B, S, H, KV, hd)
VLM_ATTN_SHAPE = (4, 2048, 12, 2, 128)
AUDIO_ATTN_SHAPE = (4, 2048, 32, 32, 64)
# xLSTM-125M's float32 twin (the same weights): the mLSTM's recurrence
# against its chunked form over 2 chunks of 256, at batch 1
XLSTM_F32_STEPS = 512
# the sequence length xLSTM-125M's prefill is profiled at
XLSTM_PROFILE_S = 256
# Qwen2-VL-2B and MusicGen-large: the flash prefill against
# kernel="torch" and the cached decode chain against the forward are held
# to Yi's bounds (LM_TOL_MAX, LM_TOL_MEAN): the same dense layers, 28 and
# 48 deep.  xLSTM-125M in bf16 has no kernel on its path; its decode (q, k
# and v unrounded float32, the recurrence) against the prefill (q, k, v
# rounded to bf16, the chunked form) differs by more than a rounding: a
# CPU proxy (the full config, bf16, 1 x 64 tokens) read max 0.716 and mean
# 0.082 against a mean |logit| of 0.79 (bf16 against float32 prefill:
# 0.917 and 0.095), unrelated logits ~1.1 apart.  Held: mean <= 0.2, the
# max printed.  The float32 twin reads the chunked form against the
# recurrence without bf16 rounding: the proxy at 512 tokens (2 chunks)
# max 9.6e-4, mean 5.5e-5; held: max 5e-3 and mean 5e-4.
XLSTM_TOL = dict(bf16_mean=0.2, f32_max=5e-3, f32_mean=5e-4)


def positions(cfg, batch):
    """(B, S) of a prefill's positions: a vlm's vision tokens and text."""
    b, s = batch["tokens"].shape
    return b, s + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)


def family_prefill(tag, model, cfg, batch, card, n_flash, prof_batch=None,
                   reps=3):
    """(a): a warm-up, one counted prefill (``n_flash`` launches of
    ``flash_attention``), ``reps`` timed ones, a profiled one (on
    ``prof_batch`` when given).  Returns (the counted run's logits, launch
    counts, ms, the profile)."""
    _, _, bf16_peak = card_rates(card)
    b, s = positions(cfg, batch)
    flops = cfg.flops_per_token_fwd(s) * b * s
    prefill = make_prefill_step(cfg, kernel="flash")
    prefill(model, batch)                                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    logits = prefill(model, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if counts["flash_attention"] != n_flash:
        raise AssertionError(f"{cfg.arch_id}: flash_attention launched "
                             f"{counts['flash_attention']} times in one "
                             f"prefill, not {n_flash}")
    if logits.shape != (b, s, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.arch_id}: prefill logits "
                             f"{tuple(logits.shape)} not finite or of the "
                             "wrong shape")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    for _ in range(reps):
        prefill(model, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"[{tag}] (a) prefill {b}x{s} kernel=flash: {ms:.1f} ms, "
          f"{b * s / ms * 1e3:.0f} tokens/s, {flops / ms / 1e9:.1f} TFLOP/s "
          f"of {bf16_peak / 1e12:.0f} ({flops / ms * 1e3 / bf16_peak:.1%}) "
          f"on {flops:.3e} FLOP | flash_attention launches "
          f"{counts['flash_attention']} a call | peak memory {peak_gb:.1f} GB",
          flush=True)
    pb = batch if prof_batch is None else prof_batch
    prof = profile_device(f"{cfg.arch_id} prefill "
                          f"{'x'.join(map(str, positions(cfg, pb)))}",
                          lambda: prefill(model, pb), reps=1)
    return logits, counts, ms, prof


def family_decode(tag, model, cfg, tokens, cache, want, tol_max, tol_mean):
    """(c): ``len(tokens[0])`` chained decode steps at batch 1 into
    ``cache``, held against ``want`` (1, n, V); ms a step (wall) and the
    device's launches a step (profiled, rewriting the last slot)."""
    n = tokens.shape[1]
    decode = make_decode_step(cfg)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pos in range(n):
        lg, cache = decode(model, cache, {"tokens": tokens[:, pos:pos + 1]},
                           pos)
        outs.append(lg[:, 0])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    print(f"[{tag}] (c) {n} chained decode steps at batch 1: {ms:.2f} ms a "
          "step (wall)", flush=True)
    logit_gap("(c) decode chain vs forward", torch.stack(outs, 1), want,
              tol_max, tol_mean, tag)
    last = {"tokens": tokens[:, n - 1:]}
    profile_device(f"{cfg.arch_id} decode step at batch 1",  # after the check
                   lambda: decode(model, cache, last, n - 1))
    return ms


def family_model(arch, dev):
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = tf.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(q.numel() for q in model.parameters())
    want = cfg.param_count()
    if cfg.family == "ssm":
        # the reference's param_count leaves out each mLSTM's f_bias (nh)
        # and counts the sLSTM's up and down maps as 2·d² (they hold 4·d²)
        g, _, _ = tf.xlstm_layout(cfg)
        want += (cfg.n_layers - g) * cfg.n_heads + g * 2 * cfg.d_model ** 2
    if n_params != want:
        raise AssertionError(f"{arch}: {n_params} params, not {want}")
    return cfg, model, n_params, time.perf_counter() - t0


def family_vlm(dev, card):
    """(a)-(c) for Qwen2-VL-2B.  Returns the prefill's launch counts."""
    tag = "vlm"
    cfg, model, n_params, t_draw = family_model("qwen2-vl-2b", dev)
    print(f"[{tag}] qwen2-vl-2b: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV of "
          f"{cfg.head_dim}, M-RoPE sections {cfg.mrope_sections}, "
          f"{cfg.n_vision_tokens} vision tokens, vocabulary "
          f"{cfg.vocab_size}, {cfg.dtype}; {n_params} params "
          f"({n_params * 2 / 1e9:.1f} GB) drawn in {t_draw:.1f}s", flush=True)
    b, s = FAMILY_SHAPE
    p_vis = cfg.n_vision_tokens
    g = torch.Generator(device=dev).manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (b, s - p_vis), generator=g,
                           device=dev)
    # patch embeddings at the embedding table's scale (fan-in d)
    vis = (torch.randn((b, p_vis, cfg.d_model), generator=g, device=dev)
           * cfg.d_model ** -0.5).to(model.embed.embedding.dtype)
    batch = {"tokens": tokens, "vision_embeds": vis}
    logits, counts, ms, _ = family_prefill(tag, model, cfg, batch, card,
                                           cfg.n_layers)
    # (b) the same batch through blockwise PyTorch attention
    t0 = time.perf_counter()
    logits_t = make_prefill_step(cfg, kernel="torch")(model, batch)
    torch.cuda.synchronize()
    print(f"[{tag}] (b) prefill kernel=torch: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (one call)", flush=True)
    logit_gap("(b) flash vs torch prefill", logits, logits_t, tag=tag)
    del logits, logits_t
    torch.cuda.empty_cache()
    # (c) text decode (pos on all three streams) against the same weights'
    # forward under family "dense" with the same sections: plain ids
    # broadcast to three streams, the reference's decode positions
    n = FAMILY_DECODE_STEPS
    dense_cfg = dataclasses.replace(cfg, family="dense")
    twin = tf.Transformer(dense_cfg, device="meta")
    twin.load_state_dict(model.state_dict(), assign=True)
    text = {"tokens": tokens[:1, :n]}
    want = make_prefill_step(dense_cfg)(twin.eval(), text)
    cache = tf.init_cache(cfg, 1, n, device=dev)
    dec_ms = family_decode(tag, model, cfg, text["tokens"], cache, want,
                           LM_TOL_MAX, LM_TOL_MEAN)
    del model, twin, cache, want
    torch.cuda.empty_cache()
    return counts, ms, dec_ms


def family_audio(dev, card):
    """(a)-(c) for MusicGen-large.  Returns the prefill's launch counts."""
    tag = "audio"
    cfg, model, n_params, t_draw = family_model("musicgen-large", dev)
    print(f"[{tag}] musicgen-large: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, MHA {cfg.n_heads}/{cfg.n_kv_heads} of "
          f"{cfg.head_dim}, cross-attention to {cfg.n_cond_tokens} "
          f"conditioning tokens, vocabulary {cfg.vocab_size}, {cfg.dtype}; "
          f"{n_params} params ({n_params * 2 / 1e9:.1f} GB) drawn in "
          f"{t_draw:.1f}s", flush=True)
    b, s = FAMILY_SHAPE
    g = torch.Generator(device=dev).manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device=dev)
    cond = (torch.randn((b, cfg.n_cond_tokens, cfg.d_model), generator=g,
                        device=dev) * cfg.d_model ** -0.5).bfloat16()
    batch = {"tokens": tokens, "cond_embeds": cond}
    logits, counts, ms, _ = family_prefill(tag, model, cfg, batch, card,
                                           cfg.n_layers)
    t0 = time.perf_counter()
    logits_t = make_prefill_step(cfg, kernel="torch")(model, batch)
    torch.cuda.synchronize()
    print(f"[{tag}] (b) prefill kernel=torch: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (one call)", flush=True)
    logit_gap("(b) flash vs torch prefill", logits, logits_t, tag=tag)
    del logits_t
    # (c) each layer's cross_kv filled from row 0's conditioning through
    # the layer's wk and wv (the reference's tests/test_decode.py), then
    # teacher-forced decode against the prefill's row 0
    n = FAMILY_DECODE_STEPS
    cache = tf.init_cache(cfg, 1, n, device=dev)
    with torch.inference_mode():
        for layer, c in zip(model.layers, cache["layers"]):
            for key, w in (("k", layer.cross.wk), ("v", layer.cross.wv)):
                c["cross_kv"][key].copy_(layer.cross.project(cond[:1], w))
    want = logits[:1, :n].clone()
    del logits
    torch.cuda.empty_cache()
    dec_ms = family_decode(tag, model, cfg, tokens[:1, :n], cache, want,
                           LM_TOL_MAX, LM_TOL_MEAN)
    del model, cache, want
    torch.cuda.empty_cache()
    return counts, ms, dec_ms


@contextlib.contextmanager
def slstm_timer(pairs: list):
    """Record CUDA events around every ``slstm_forward`` call while the
    block runs (appended to ``pairs``)."""
    fwd = xlstm_mod.slstm_forward

    def timed(x, p, cfg, ctx=None):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fwd(x, p, cfg, ctx)
        stop.record()
        pairs.append((start, stop))
        return out
    xlstm_mod.slstm_forward = timed
    try:
        yield pairs
    finally:
        xlstm_mod.slstm_forward = fwd


def family_xlstm(dev, card):
    """(a)-(c) for xLSTM-125M, and the float32 twin's recurrence against
    its chunked form."""
    tag = "xlstm"
    cfg, model, n_params, t_draw = family_model("xlstm-125m", dev)
    g_, k, rem = tf.xlstm_layout(cfg)
    print(f"[{tag}] xlstm-125m: {cfg.n_layers} blocks ({g_} groups of "
          f"{k - 1} mLSTM + 1 sLSTM, remainder {rem}), d_model {cfg.d_model}"
          f", {cfg.n_heads} heads, mLSTM chunk "
          f"{xlstm_mod.mlstm_chunk_len(FAMILY_SHAPE[1])}, {cfg.dtype}; "
          f"{n_params} params ({n_params * 2 / 1e9:.2f} GB; the reference's "
          f"param_count {cfg.param_count()}) drawn in {t_draw:.1f}s",
          flush=True)
    b, s = FAMILY_SHAPE
    gen = torch.Generator(device=dev).manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    # profiled at 4 x 256 (one mLSTM chunk, 256 sLSTM steps): at 2048 the
    # loop makes ~160k launches, whose profile takes minutes to read; one
    # timed run (a prefill takes seconds)
    logits, counts, ms, _ = family_prefill(
        tag, model, cfg, {"tokens": tokens}, card, 0,
        prof_batch={"tokens": tokens[:, :XLSTM_PROFILE_S]}, reps=1)
    pairs = []
    prefill = make_prefill_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with slstm_timer(pairs):
        prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    s_ms = [a.elapsed_time(z) for a, z in pairs]
    if len(s_ms) != g_:
        raise AssertionError(f"{len(s_ms)} sLSTM calls, not {g_}")
    print(f"[{tag}] (a) the sLSTM loops (CUDA events around each of the "
          f"{g_} blocks, {s} steps each): " + ", ".join(f"{v:.1f}"
                                                        for v in s_ms)
          + f" ms, {sum(s_ms):.1f} of the prefill's {wall:.1f} ms wall "
          f"({sum(s_ms) / wall:.1%}); {sum(s_ms) / g_ / s * 1e3:.1f} us a "
          "step", flush=True)
    # (c) bf16 decode chain against the prefill's row 0
    n = FAMILY_DECODE_STEPS
    want = logits[:1, :n].clone()
    del logits
    cache = tf.init_cache(cfg, 1, n, device=dev)
    dec_ms = family_decode(tag, model, cfg, tokens[:1, :n], cache, want,
                           None, XLSTM_TOL["bf16_mean"])
    # the float32 twin of the same weights: recurrence against chunks
    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    f32 = tf.Transformer(f32_cfg, device=dev).eval()
    f32.load_state_dict({key: v.float()
                         for key, v in model.state_dict().items()})
    n32 = XLSTM_F32_STEPS
    row = {"tokens": tokens[:1, :n32]}
    want32 = make_prefill_step(f32_cfg)(f32, row)
    decode = make_decode_step(f32_cfg)
    cache = tf.init_cache(f32_cfg, 1, n32, device=dev)
    outs = []
    for pos in range(n32):
        step = {"tokens": row["tokens"][:, pos:pos + 1]}
        outs.append(decode(f32, cache, step, pos)[0][:, 0])
    print(f"[{tag}] (c) float32 twin, {n32} decode steps (the recurrence) "
          f"against its prefill ({n32 // xlstm_mod.mlstm_chunk_len(n32)} "
          "mLSTM chunks):", flush=True)
    logit_gap("(c) float32 decode vs chunked prefill", torch.stack(outs, 1),
              want32, XLSTM_TOL["f32_max"], XLSTM_TOL["f32_mean"], tag)
    del model, f32, cache, want, want32, outs
    torch.cuda.empty_cache()
    return counts, ms, dec_ms, sum(s_ms) / wall


def phase_families(dev, card: str):
    """Phase 8: Qwen2-VL-2B, MusicGen-large and xLSTM-125M at full width
    and depth, (a)-(c) each; (d) ``flash_attention`` at the two new
    shapes; (e) the serving launcher on each at full size.  Returns
    {arch: prefill launch counts} and (d)'s rows."""
    t_phase = time.perf_counter()
    counts = {"qwen2-vl-2b": family_vlm(dev, card)[0],
              "musicgen-large": family_audio(dev, card)[0],
              "xlstm-125m": family_xlstm(dev, card)[0]}
    rows = {}
    for shape in (VLM_ATTN_SHAPE, AUDIO_ATTN_SHAPE):
        b, s, h, kv, hd = shape
        g = torch.Generator(device=dev).manual_seed(7)
        q, k, v = (torch.randn(sh, generator=g, device=dev).bfloat16()
                   for sh in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
        print(f"[families] (d) flash_attention at q {tuple(q.shape)}, KV "
              f"{kv} (H/KV = {h // kv}):", flush=True)
        rows[shape] = attention_case(q, k, v, 0, card)
        del q, k, v
        torch.cuda.empty_cache()
    for arch in ("qwen2-vl-2b", "musicgen-large", "xlstm-125m"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            lm_serve.main(["--arch", arch, "--no-reduced", "--requests", "2",
                           "--batch", "4", "--prompt-len", "16",
                           "--tokens", "8"])
        for line in buf.getvalue().splitlines():
            print(f"[families] (e) {line}", flush=True)
        if "serving loop OK" not in buf.getvalue():
            raise AssertionError(f"{arch}: the launcher did not print "
                                 "'serving loop OK'")
        torch.cuda.empty_cache()
    print(f"[families] phase wall {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return counts, rows


# ---------------------------------------------------------------------------
# phase 9: LM training
# ---------------------------------------------------------------------------
# (a) MiniCPM-2B at full width and depth: 10 steps (20 before the
# model-axis phases paid for their time) of token_batches at 4 x 512, lr
# 3e-4, through kernel="torch" (the kernels have no backward)
LM_TRAIN_ARCH = "minicpm-2b"
LM_TRAIN_SHAPE = (4, 512)
LM_TRAIN_STEPS = 10
LM_TRAIN_LR = 3e-4
LM_TRAIN_PEAK_GB = 75.0
# (b) Qwen2-VL-2B: (B, stubbed vision embeddings, text tokens), 8 steps
VLM_TRAIN_SHAPE = (4, 256, 256)
VLM_TRAIN_STEPS = 8
# (c) every arch at reduced(), float32: (B, S) and the CPU parity
# tolerances (tests/test_torch_lm_train.py): the loss within 1e-5
# relative, each gradient leaf within 1e-4 of its own max |g|; remat is
# held to the same bound (its recomputed forward runs the same kernels,
# so it is expected bitwise; the line says whether it was)
LM_TRAIN_SMALL = (2, 32)
LM_TRAIN_TOL = dict(loss_rtol=1e-5, grad=1e-4)
# (d) the launcher: MiniCPM-2B at full size, 8 steps of 4 x 256; then at
# reduced() 6 steps saved and 6 resumed (lr 3e-3: the reduced model's
# loss falls within 6 steps, tests/test_torch_lm_launch.py)
LM_LAUNCH_ARGS = ["--arch", LM_TRAIN_ARCH, "--steps", "8", "--batch", "4",
                  "--seq", "256"]
LM_RESUME_ARGS = ["--arch", "yi-6b", "--reduced", "--batch", "8", "--seq",
                  "32", "--lr", "3e-3"]
LM_TRAIN_BUDGET_S = 150.0


def lm_train_batch(cfg, b, s, dev, seed=0, n_vis=None):
    """A ``token_batches`` batch of (b, s) text, plus stubbed embeddings at
    the embedding table's scale for a vlm (``n_vis`` of them) or an audio
    model, drawn from ``seed`` on the CPU and moved to ``dev``."""
    batch = next(token_batches(cfg.vocab_size, b, s, seed=seed,
                               device="cpu"))
    g = torch.Generator().manual_seed(seed + 1)
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        n = cfg.n_vision_tokens if n_vis is None else n_vis
        batch["vision_embeds"] = (torch.randn((b, n, cfg.d_model),
                                              generator=g)
                                  * cfg.d_model ** -0.5).to(dt)
    if cfg.family == "audio":
        batch["cond_embeds"] = (torch.randn((b, cfg.n_cond_tokens,
                                             cfg.d_model), generator=g)
                                * cfg.d_model ** -0.5).to(dt)
    return {k: v.to(dev) for k, v in batch.items()}


def state_bytes(model, opt):
    """(parameters + both moments, gradients) in bytes."""
    p = sum(q.numel() * q.element_size() for q in model.parameters())
    m = sum(t.numel() * t.element_size() for key in ("mu", "nu")
            for t in opt[key].values())
    return p + m, p


def train_steps(step, model, opt, batches, pairs=None):
    """Run ``step`` over ``batches``; returns the metrics of each (scalar
    tensors, read by the caller after a synchronize).  With ``pairs`` each
    step is bracketed by CUDA events appended to it."""
    out = []
    for batch in batches:
        if pairs is not None:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        model, opt, m = step(model, opt, batch)
        if pairs is not None:
            stop.record()
            pairs.append((start, stop))
        out.append(m)
    return out


def check_falls(tag, what, losses):
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: a loss is not finite: {losses}")
    print(f"[{tag}] {what}: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{len(losses)} steps (" + ", ".join(f"{v:.3f}" for v in losses)
          + ")", flush=True)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall")


def lm_train_full(dev, card: str):
    """(a): MiniCPM-2B, 20 steps through ``make_train_step``."""
    tag = "lm_train"
    _, _, bf16_peak = card_rates(card)
    cfg = get_config(LM_TRAIN_ARCH)
    t0 = time.perf_counter()
    model = tf.init_params(cfg, seed=0, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=LM_TRAIN_LR)
    opt = adamw.init_state(dict(model.named_parameters()), opt_cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} params, config says "
                             f"{cfg.param_count()}")
    st_bytes, g_bytes = state_bytes(model, opt)
    print(f"[{tag}] (a) {LM_TRAIN_ARCH}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV of "
          f"{cfg.head_dim}, vocabulary {cfg.vocab_size}, tied embedding "
          f"{cfg.tie_embeddings}, {cfg.dtype}; {n_params} params; "
          f"parameters and AdamW moments {st_bytes / 1e9:.2f} GB, drawn in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    step = make_train_step(cfg, opt_cfg)
    b, s = LM_TRAIN_SHAPE
    # the batch: a 1-row probe (forward and backward, no update) peaks
    # above the resident state; its gradients do not grow with the rows
    probe = lm_train_batch(cfg, 1, s, dev, seed=99)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    loss, _ = tf.lm_loss(model, probe, cfg)
    loss.backward()
    torch.cuda.synchronize()
    peak1 = torch.cuda.max_memory_allocated(dev)
    for p in model.parameters():
        p.grad = None
    del loss
    act_row = max(peak1 - base - g_bytes, 0)
    est = (peak1 + (b - 1) * act_row) / 1e9
    if est > LM_TRAIN_PEAK_GB:
        b //= 2
    print(f"[{tag}] (a) batch probe: 1x{s} forward and backward peaks "
          f"{(peak1 - base) / 1e9:.2f} GB above {base / 1e9:.2f} GB resident "
          f"(gradients {g_bytes / 1e9:.2f} GB); {LM_TRAIN_SHAPE[0]}x{s} "
          f"would peak ~{est:.1f} GB (limit {LM_TRAIN_PEAK_GB}): batch "
          f"{b}x{s} runs", flush=True)
    data = token_batches(cfg.vocab_size, b, s, seed=0, device=dev)
    batches = [next(data) for _ in range(LM_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    pairs, upd = [], []
    plain_update = adamw.apply_updates_
    timed_method(adamw, "apply_updates_", upd)
    try:
        t0 = time.perf_counter()
        metrics = train_steps(step, model, opt, batches, pairs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        adamw.apply_updates_ = plain_update
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(m["loss"]) for m in metrics]
    check_falls(tag, f"(a) {LM_TRAIN_ARCH} {b}x{s}, lr {LM_TRAIN_LR}",
                losses)
    ms = [event_ms(p) for p in pairs]
    upd_ms = sorted(event_ms(p) for p in upd)[len(upd) // 2]
    steady = sorted(ms[2:])
    step_ms = steady[len(steady) // 2]
    mean_ms = sum(steady) / len(steady)
    flops_6n = 6 * n_params * b * s
    flops = 3 * cfg.flops_per_token_fwd(s) * b * s
    print(f"[{tag}] (a) {LM_TRAIN_STEPS} steps in {wall:.2f}s wall; step "
          f"{step_ms:.1f} ms (CUDA events, median of steps 3-"
          f"{LM_TRAIN_STEPS}; first {ms[0]:.1f}, second {ms[1]:.1f}, "
          f"mean {mean_ms:.1f}), {b * s / step_ms * 1e3:.0f} tokens/s, "
          f"{flops / step_ms / 1e9:.1f} TFLOP/s of {bf16_peak / 1e12:.0f} "
          f"({flops / step_ms * 1e3 / bf16_peak:.1%}) "
          f"on {flops / 1e12:.2f} TFLOP a step (6·N·tokens "
          f"{flops_6n / 1e12:.2f} + the causal attention, 3x the forward's "
          "matmul FLOP)", flush=True)
    print(f"[{tag}] (a) apply_updates_ alone: {upd_ms:.2f} ms a step (CUDA "
          f"events, median of {len(upd)}), {upd_ms / step_ms:.1%} of the "
          "step", flush=True)
    print(f"[{tag}] (a) peak memory {peak / 1e9:.2f} GB of the card's "
          f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.1f}: "
          f"parameters and moments {st_bytes / 1e9:.2f}, gradients "
          f"{g_bytes / 1e9:.2f}, the rest (activations, logits, "
          f"temporaries) {(peak - st_bytes - g_bytes) / 1e9:.2f}", flush=True)
    if peak / 1e9 > LM_TRAIN_PEAK_GB + 5:
        raise AssertionError(f"peak {peak / 1e9:.1f} GB")
    prof_batch = batches[-1]
    profile_device(f"{LM_TRAIN_ARCH} train step {b}x{s}",
                   lambda: step(model, opt, prof_batch), reps=3,
                   mode=contextlib.nullcontext)
    del model, opt, batches, metrics, step
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "tokens": b * s}


def lm_train_vlm(dev, card: str):
    """(b): Qwen2-VL-2B with stubbed vision embeddings; the loss over the
    text region.  Every step takes one batch, as the CPU tests' repeated
    batch does, so the first and last losses are of the same tokens
    before any update and after the seventh: a fall there is not the
    spread between batches."""
    tag = "lm_train"
    cfg = get_config("qwen2-vl-2b")
    b, n_vis, s = VLM_TRAIN_SHAPE
    if n_vis != cfg.n_vision_tokens:
        raise AssertionError(f"{n_vis} vision embeddings, the config takes "
                             f"{cfg.n_vision_tokens}")
    model = tf.init_params(cfg, seed=0, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=LM_TRAIN_LR)
    opt = adamw.init_state(dict(model.named_parameters()), opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    batches = [lm_train_batch(cfg, b, s, dev, seed=0)] * VLM_TRAIN_STEPS
    if batches[0]["labels"].shape != (b, s):
        raise AssertionError("labels are not the text's")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    pairs = []
    t0 = time.perf_counter()
    metrics = train_steps(step, model, opt, batches, pairs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(m["loss"]) for m in metrics]
    check_falls(tag, f"(b) qwen2-vl-2b {b}x({n_vis} vision + {s} text), "
                "one batch, the text region's loss", losses)
    ms = sorted(event_ms(p) for p in pairs[2:])
    print(f"[{tag}] (b) {VLM_TRAIN_STEPS} steps in {wall:.2f}s wall, step "
          f"{ms[len(ms) // 2]:.1f} ms (median of steps 3-{VLM_TRAIN_STEPS}), "
          f"{b * s / ms[len(ms) // 2] * 1e3:.0f} text tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB", flush=True)
    del model, opt, batches, metrics, step
    torch.cuda.empty_cache()


def loss_and_grads(model, batch, **kw):
    for p in model.parameters():
        p.grad = None
    loss, _ = tf.lm_loss(model, batch, model.cfg, **kw)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), grads


def grad_gap(got, want):
    """(the worst leaf's max |Δ| over its own max |g|, that leaf)."""
    worst, name = 0.0, None
    for k in want:
        d = float((got[k].cpu() - want[k].cpu()).abs().max()) / max(
            float(want[k].abs().max()), 1e-30)
        if d >= worst:
            worst, name = d, k
    return worst, name


def lm_train_reduced(dev):
    """(c): every arch at reduced() in float32, card against CPU."""
    tag = "lm_train"
    b, s = LM_TRAIN_SMALL
    tol = LM_TRAIN_TOL
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        cpu = tf.init_params(cfg, seed=3, device="cpu")
        card = tf.Transformer(cfg, device=dev).eval()
        card.load_state_dict(cpu.state_dict())
        batch = lm_train_batch(cfg, b, s, "cpu", seed=5)
        on_card = {k: v.to(dev) for k, v in batch.items()}
        l_cpu, g_cpu = loss_and_grads(cpu, batch)
        l_card, g_card = loss_and_grads(card, on_card)
        rel = abs(l_card - l_cpu) / abs(l_cpu)
        worst, leaf = grad_gap(g_card, g_cpu)
        l_rm, g_rm = loss_and_grads(card, on_card, remat=True)
        rm_worst, _ = grad_gap(g_rm, g_card)
        rm_bitwise = l_rm == l_card and all(torch.equal(g_rm[k], g_card[k])
                                            for k in g_card)
        # apply_updates_ in place against the functional apply_updates
        opt_cfg = adamw.AdamWConfig(lr=1e-3, weight_decay=0.1)
        params = {k: p.detach().clone() for k, p in card.named_parameters()}
        params_ = {k: v.clone() for k, v in params.items()}
        st = adamw.init_state(params, opt_cfg)
        st_ = adamw.init_state(params_, opt_cfg)
        for _ in range(2):
            params, st, m = adamw.apply_updates(params, g_card, st, opt_cfg)
            m_ = adamw.apply_updates_(params_, g_card, st_, opt_cfg)
        upd_bitwise = torch.equal(m["grad_norm"], m_["grad_norm"]) and all(
            torch.equal(params[k], params_[k])
            and torch.equal(st["mu"][k], st_["mu"][k])
            and torch.equal(st["nu"][k], st_["nu"][k]) for k in params)
        # the kernels under autograd on the card: the forward's default
        # path raises at its first kernel (xLSTM and MLA reach none)
        reaches = cfg.family != "ssm" and cfg.attn_type == "gqa"
        try:
            tf.lm_loss(card, on_card, cfg, kernel="flash")
            raised = False
        except RuntimeError as e:
            raised = "no backward" in str(e)
        flash_ok = raised == reaches
        print(f"[{tag}] (c) {arch} reduced ({cfg.family}): loss card "
              f"{l_card:.6f} CPU {l_cpu:.6f} (rel {rel:.2e}); gradients "
              f"worst leaf {worst:.2e} of its max ({leaf}); remat worst "
              f"{rm_worst:.2e}, bitwise {rm_bitwise}; apply_updates_ bitwise "
              f"apply_updates {upd_bitwise}; kernel='flash' under grad "
              f"raises {raised} (reaches a kernel {reaches})", flush=True)
        if rel > tol["loss_rtol"] or worst > tol["grad"] or \
                rm_worst > tol["grad"] or not upd_bitwise or not flash_ok:
            raise AssertionError(f"{arch}: the reduced train step disagrees")
        del cpu, card, g_cpu, g_card, g_rm, params, params_, st, st_
    torch.cuda.empty_cache()


def lm_train_launcher(dev):
    """(d): the launcher at full size, and the reduced save/resume."""
    tag = "lm_train"

    def run(args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = lm_train.main(args)
        for line in buf.getvalue().splitlines():
            print(f"[{tag}] (d) {line}", flush=True)
        if "done: loss" not in buf.getvalue():
            raise AssertionError("the launcher did not print 'done: loss'")
        return out
    t0 = time.perf_counter()
    run(LM_LAUNCH_ARGS)
    torch.cuda.empty_cache()
    print(f"[{tag}] (d) {' '.join(LM_LAUNCH_ARGS)}: "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    def snapshot(model, opt):
        return {**{k: v.detach().clone()
                   for k, v in model.named_parameters()},
                **{f"{m}/{k}": v.clone() for m in ("mu", "nu")
                   for k, v in opt[m].items()}}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm.npz")
        first = run([*LM_RESUME_ARGS, "--steps", "6", "--ckpt", path])
        saved = snapshot(first["model"], first["opt"])
        restored = []
        orig = lm_train.restore_state

        def spy(p, model, opt):
            tree = orig(p, model, opt)
            restored.append(snapshot(model, opt))
            return tree
        lm_train.restore_state = spy
        try:
            resumed = run([*LM_RESUME_ARGS, "--steps", "6", "--resume", path])
        finally:
            lm_train.restore_state = orig
    same = [torch.equal(restored[0][k], saved[k]) for k in saved]
    print(f"[{tag}] (d) --ckpt then --resume: {sum(same)} of {len(same)} "
          "restored leaves (parameters and moments) bitwise the saved ones",
          flush=True)
    if not all(same):
        raise AssertionError("the restored state differs from the saved")
    straight = run([*LM_RESUME_ARGS, "--steps", "12"])
    a = snapshot(resumed["model"], resumed["opt"])
    b_ = snapshot(straight["model"], straight["opt"])
    gap = max(float((a[k] - b_[k]).abs().max()) for k in a)
    print(f"[{tag}] (d) 6 saved + 6 resumed against 12 straight steps: "
          f"bitwise {all(torch.equal(a[k], b_[k]) for k in a)}, max |Δ| "
          f"{gap:.3e} (printed, not held)", flush=True)


def phase_lm_train(dev, card: str):
    """Phase 9: (a) MiniCPM-2B at full width, (b) Qwen2-VL-2B's text-region
    loss, (c) every arch at reduced() card against CPU, (d) the launcher."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"[lm_train] start: {torch.cuda.memory_allocated(dev) / 1e9:.2f} "
          "GB still allocated", flush=True)
    lm_train_full(dev, card)
    lm_train_vlm(dev, card)
    lm_train_reduced(dev)
    lm_train_launcher(dev)
    wall = time.perf_counter() - t_phase
    print(f"[lm_train] phase wall {wall:.1f}s (budget "
          f"{LM_TRAIN_BUDGET_S:.0f}s)", flush=True)

# ---------------------------------------------------------------------------
# phase 10: the (data, model) mesh
# ---------------------------------------------------------------------------
MESH_RANKS = 2
MESH_TIMEOUT_S = 900.0
# (a) Yi-6B at full width and depth, its heads over model (H 16, KV 2 a
# rank); the logits held to phase 6's bf16 bounds: both sides bf16 with
# float32 accumulation, the mesh's wo and w_down partial sums rounded to
# bf16 before their all-reduce (as the reference's), one bf16 rounding a
# layer more than one rank's, far less than phase 6's bf16 against f32
MESH_YI_SHAPE = (4, 2048)
# (b) DeepSeek-V2 at phase 7's depth, 80 of its 160 experts a rank
MESH_MOE = ("deepseek-v2-236b", 4)
MESH_MOE_DECODE_STEPS = 4
# (c) MiniCPM-2B at full width, FSDP over data (2x1), 2 x 256 tokens a
# rank of one global 4 x 256 batch, the same batch each step; step 1
# against one rank's step on that batch: the forward is the same bits but
# for the data split of the mean, the bf16 gradients are summed in another
# order (two ranks' halves reduce-scattered): rtol 1e-3
MESH_TRAIN_ARCH = "minicpm-2b"
MESH_TRAIN_SHAPE = (4, 256)
# 2 steps (6 before the model-axis phases paid for their time)
MESH_TRAIN_STEPS = 2
MESH_TRAIN_RTOL = 1e-3
# (d) the launchers, both at once
MESH_LAUNCHES = [
    ["-m", "repro_torch.launch.serve", "--arch", "yi-6b", "--no-reduced",
     "--devices", "2", "--mesh-shape", "1x2", "--requests", "1", "--batch",
     "2", "--prompt-len", "16", "--tokens", "4"],
    ["-m", "repro_torch.launch.train", "--arch", "yi-6b", "--reduced",
     "--devices", "2", "--mesh-shape", "2x1", "--fsdp", "--steps", "4",
     "--batch", "4", "--seq", "32", "--lr", "3e-3"]]


# (e) Zamba2-7B at full width and depth on 1x2: 56 of its 112 Mamba2 heads
# and 16 of its shared block's 32 attention heads a rank.  The logits
# against one rank's prefill of the same weights are held to phase 6's
# mean (HYBRID_TOL_MEAN), the decode chain against the mesh's prefill too:
# 81 layers of random weights amplify a rounding (the w_out partial sums,
# the norm's summed statistic, narrower GEMMs) as they amplify phase 6's.
# One Mamba2 layer in float32, sharded against whole on the same input,
# differs only by such roundings: held to 1e-4 of the layer's max |out|
# (a float32 dot of 7168 terms rounds at ~5e-6 relative).
MESH_HYBRID_SHAPE = (4, 2048)
MESH_HYBRID_DECODE = 2
MESH_LAYER_TOL = 1e-4
# (f) xLSTM-125M at full width on 1x2 (2 mLSTM heads a rank; the sLSTM's
# recurrence on both ranks): 4 x 256 (one mLSTM chunk, 256 sLSTM steps),
# held to phase 8's xLSTM bound (XLSTM_TOL["bf16_mean"]), the max printed
MESH_XLSTM_SHAPE = (4, 256)
# (g) one train step of each recurrent family at reduced() (float32, TF32
# off) on 1x2 against one rank's step on the same batch: the loss to 1e-5
# relative and each leaf's gradient to 1e-4 of its max, the CPU tests'
# bounds (tests/test_torch_mesh.py)
MESH_RECURRENT_ARCHS = ("zamba2-7b", "xlstm-125m")
MESH_RECURRENT_SHAPE = (4, 32)
MESH_RECURRENT_TOL = dict(loss=1e-5, grad=1e-4)
# 4i: the CollaFuse trainer on 2x1 (CollaFuseTrainer(mesh=)): the paper
# U-Net, 4 clients of 8 synthetic images (2 clients' stacks a rank, 16 of
# the 32 pooled server rows), 2 rounds; against the one-process trainer
# from the same models and draws: the losses to phase 4b (b)'s tolerance
# (TRAIN_LOSS_TOL), the parameters to phase 4b (c)'s bounds scaled by the
# rounds (AdamW moves an entry by ±lr by its gradient's sign: a gradient
# near 0 can put an entry 2·lr apart each round); the server parameters
# the same bits on both ranks.  trainer.sample through ddpm_step against
# the plain step (phase 4's backend bound, 1e-2).
MESH_TRAINER = dict(clients=4, images=8, rounds=2)


def mesh_view(mesh: Mesh, dims) -> Mesh:
    """The two ranks of ``mesh`` laid out as ``dims`` (2x1 or 1x2) over the
    same world group: an axis of size 1 runs no collective."""
    shape = dict(zip(("data", "model"), dims))
    rank = mesh.index(mesh.axis_names)
    coords = {a: (rank if n > 1 else 0) for a, n in shape.items()}
    world = mesh.group(mesh.axis_names)
    return Mesh(shape=shape, coords=coords,
                groups={("data",): world, ("model",): world,
                        ("data", "model"): world},
                device=mesh.device, transport=mesh.transport)


def gb(n) -> float:
    return n / 1e9


def held_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def logits_gap(a, b):
    """(max |d|, mean |d|) of two logit tensors, a row at a time."""
    mx, tot, n = 0.0, 0.0, 0
    for i in range(a.shape[0]):
        d = (a[i].float() - b[i].float()).abs()
        mx = max(mx, d.max().item())
        tot += d.sum().item()
        n += d.numel()
    return mx, tot / n


def timed_sync(fn):
    """(fn(), host ms with the card synchronised at both ends)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def mesh_tp(mesh: Mesh, rank: int):
    """(a) Yi-6B prefill with its heads over ``model``."""
    cfg, ctx, dev = get_config("yi-6b"), make_ctx(mesh), mesh.device
    model = tf.init_params(cfg, seed=0, ctx=ctx)
    b, s = MESH_YI_SHAPE
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(0)).to(dev)
    with torch.inference_mode():
        tf.prefill(model, {"tokens": toks[:, :128]}, cfg, ctx=ctx)
        comm.reset_stats()
        before = ops.flash_attention.launches
        logits, ms = timed_sync(lambda: tf.prefill(
            model, {"tokens": toks}, cfg, ctx=ctx))
    out = {"held_gb": gb(held_bytes(model)),
           "whole_gb": gb(cfg.param_count() * 2), "ms": ms,
           "launches": ops.flash_attention.launches - before,
           "local_heads": model.layers[0].attn.wq.shape[1],
           "local_kv": model.layers[0].attn.wk.shape[1],
           "stats": dict(comm.STATS), "shape": list(logits.shape)}
    comm.barrier(mesh)
    if rank == 0:
        whole = tf.init_params(cfg, seed=0, device=dev)
        with torch.inference_mode():
            ref, out["one_rank_ms"] = timed_sync(lambda: tf.prefill(
                whole, {"tokens": toks}, cfg))
        out["max"], out["mean"] = logits_gap(logits, ref)
        del whole, ref
    del model, logits
    torch.cuda.empty_cache()
    comm.barrier(mesh)
    return out


def local_counts(x_flat, p, cfg):
    """``moe_local`` on one block of tokens at the block's own capacity:
    (its output, its kept and dropped assignment counts)."""
    cap = moe_mod.capacity(x_flat.shape[0], cfg.top_k, cfg.n_experts,
                           cfg.capacity_factor)
    with moe_recorder() as rec:
        out, _ = moe_mod.moe_local(x_flat, p, cfg, cap)
    keep = rec["routes"][0][1]
    return out, [int(keep.sum()), int((~keep).sum())]


def ep_parts(x, p, cfg, ctx):
    """The all-to-all path of one MoE layer, part by part, each part's
    host ms with the card synchronised (the exchanges are gloo's)."""
    mesh, axis, ep = ctx.mesh, ctx.model_axis, ctx.model_size
    e, d = cfg.n_experts, x.shape[-1]
    el = e // ep
    xs = x.reshape(-1, d).chunk(ep)[ctx.model_rank].contiguous()
    cap = moe_mod.capacity(xs.shape[0], cfg.top_k, e, cfg.capacity_factor)
    ms = {}
    (top_p, top_i, _), ms["router"] = timed_sync(
        lambda: moe_mod.router_topk(xs, p.router, cfg.top_k))

    def dispatch():
        pos, keep = moe_mod.dispatch_indices(top_i, e, cap)
        return pos, keep, moe_mod.scatter_dispatch(xs, top_i, pos, keep, e,
                                                   cap)
    (pos, keep, buf), ms["dispatch"] = timed_sync(dispatch)
    buf, ms["exchange"] = timed_sync(lambda: comm.all_to_all(buf, mesh, axis))
    xe = buf.reshape(ep, el, cap, d).transpose(0, 1).reshape(el, ep * cap, d)
    ye, ms["experts"] = timed_sync(
        lambda: moe_mod.expert_ffn(xe, p.w_gate, p.w_up, p.w_down))
    ye = ye.reshape(el, ep, cap, d).transpose(0, 1).reshape(e, cap, d)
    ye, ms["exchange_back"] = timed_sync(
        lambda: comm.all_to_all(ye, mesh, axis))
    out, ms["combine"] = timed_sync(
        lambda: moe_mod.gather_combine(ye, top_i, top_p, pos, keep))
    _, ms["gather"] = timed_sync(lambda: comm.all_gather(out, mesh, axis, 0))
    return ms


def mesh_ep(mesh: Mesh, rank: int):
    """(b) DeepSeek-V2 at phase 7's depth with its experts over ``model``,
    held on rank 0 against ``moe_local`` with the whole model's weights of
    the same seed, a block of tokens at a time at the block's capacity."""
    arch, layers = MESH_MOE
    cfg, ctx, dev = moe_config(arch, layers), make_ctx(mesh), mesh.device
    ep = ctx.model_size
    model = tf.init_params(cfg, seed=0, ctx=ctx)
    b, s = MOE_SHAPE
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    out = {"held_gb": gb(held_bytes(model)),
           "whole_gb": gb(cfg.param_count() * 2),
           "experts": cfg.n_experts // ep}
    moe_mod.RECORD = []
    with torch.inference_mode(), moe_recorder() as seen:
        got = seen["inputs"]
        comm.reset_stats()
        _, out["prefill_ms"] = timed_sync(lambda: tf.prefill(
            model, {"tokens": toks}, cfg, ctx=ctx))
        out["prefill_stats"] = dict(comm.STATS)
        rec = [(path, int(k), int(dr)) for path, k, dr in moe_mod.RECORD]
        out["prefill_paths"] = sorted({r[0] for r in rec})
        out["prefill_counts"] = [list(r[1:]) for r in rec]
        pre_x = [x.reshape(-1, x.shape[-1]) for x, _ in got]
        # the first MoE layer's all-to-all path: its output on every token
        ep_out = moe_mod._moe_all_to_all(pre_x[0], got[0][1], cfg, ctx,
                                         ("model",))[0]
        out["parts_ms"] = ep_parts(got[0][0], got[0][1], cfg, ctx)
        got.clear()
        seen["routes"].clear()
        cache = tf.init_cache(cfg, 1, MESH_MOE_DECODE_STEPS, ctx=ctx)
        moe_mod.RECORD = []
        step_ms = []
        for pos in range(MESH_MOE_DECODE_STEPS):
            _, ms = timed_sync(lambda: tf.decode_step(
                model, cache, {"tokens": toks[:1, pos:pos + 1]}, pos, cfg,
                ctx=ctx))
            step_ms.append(ms)
        rec = [(path, int(k), int(dr)) for path, k, dr in moe_mod.RECORD]
        out["decode_paths"] = sorted({r[0] for r in rec})
        out["decode_counts"] = [list(r[1:]) for r in rec]
        out["decode_ms"] = sorted(step_ms)[len(step_ms) // 2]
        dec_x = [x.reshape(-1, x.shape[-1]) for x, _ in got]
        # the last decode step's first MoE layer on the replicated path
        n_moe = len(pre_x)
        rep_x = dec_x[-n_moe]
        rep_out = moe_mod._moe_replicated(rep_x, got[-n_moe][1], cfg, ctx,
                                          ())[0]
        got.clear()
    moe_mod.RECORD = None
    del model, cache
    torch.cuda.empty_cache()
    comm.barrier(mesh)
    if rank == 0:
        whole = tf.init_params(cfg, seed=0, device=dev)
        moes = [m for m in whole.modules() if isinstance(m, moe_mod.MoE)]
        with torch.inference_mode():
            # each shard's block of each MoE layer's tokens at its capacity
            out["prefill_emulated"] = [
                [local_counts(x.chunk(ep)[blk], p, cfg)[1]
                 for x, p in zip(pre_x, moes)] for blk in range(ep)]
            # a decode step's tokens are one block: the ranks' counts of
            # their experts sum to its counts
            out["decode_emulated"] = [
                local_counts(x, moes[i % n_moe], cfg)[1]
                for i, x in enumerate(dec_x)]
            emul = torch.cat([local_counts(blk, moes[0], cfg)[0]
                              for blk in pre_x[0].chunk(ep)])
            d = (ep_out.float() - emul.float()).abs()
            out["layer_max"], out["layer_mean"] = d.max().item(), \
                d.mean().item()
            d = (rep_out.float() -
                 local_counts(rep_x, moes[0], cfg)[0].float()).abs()
            out["decode_layer_max"], out["decode_layer_mean"] = \
                d.max().item(), d.mean().item()
        del whole, moes, emul, d
    del pre_x, dec_x, ep_out, rep_out
    torch.cuda.empty_cache()
    comm.barrier(mesh)
    return out


def mesh_train_batch(cfg, dev):
    b, s = MESH_TRAIN_SHAPE
    return lm_train_batch(cfg, b, s, dev, seed=3)


def mesh_train_reference(dev):
    """One rank's first MiniCPM-2B step on (c)'s global batch: (loss,
    grad_norm, state bytes)."""
    cfg = get_config(MESH_TRAIN_ARCH)
    model = tf.init_params(cfg, seed=0, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=LM_TRAIN_LR)
    opt = adamw.init_state(dict(model.named_parameters()), opt_cfg)
    state, _ = state_bytes(model, opt)
    _, _, m = make_train_step(cfg, opt_cfg)(model, opt,
                                            mesh_train_batch(cfg, dev))
    out = (float(m["loss"]), float(m["grad_norm"]), state)
    del model, opt
    torch.cuda.empty_cache()
    return out


def mesh_fsdp(mesh: Mesh, rank: int):
    """(c) MiniCPM-2B trained with FSDP over ``data``."""
    cfg, ctx, dev = get_config(MESH_TRAIN_ARCH), make_ctx(mesh), mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    model = tf.init_params(cfg, seed=0, ctx=ctx, fsdp=True)
    opt_cfg = adamw.AdamWConfig(lr=LM_TRAIN_LR)
    opt = adamw.init_state(dict(model.named_parameters()), opt_cfg)
    state, grads = state_bytes(model, opt)
    step = make_train_step(cfg, opt_cfg, ctx=ctx)
    batch = mesh_train_batch(cfg, dev)
    losses, norms, ms = [], [], []
    comm.reset_stats()
    for _ in range(MESH_TRAIN_STEPS):
        (_, _, m), t = timed_sync(lambda: step(model, opt, batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append(t)
    peak = torch.cuda.max_memory_allocated(dev)
    out = {"losses": losses, "norms": norms, "ms": ms,
           "state_gb": gb(state), "grads_gb": gb(grads),
           "peak_gb": gb(peak), "rest_gb": gb(peak - state - grads),
           "stats": dict(comm.STATS)}
    del model, opt
    torch.cuda.empty_cache()
    comm.barrier(mesh)
    return out


def launches_since(before) -> dict:
    return {n: c - before[n] for n, c in ops.launch_counts().items()}


def f32_layer(module):
    """A module's parameters in float32, as attributes."""
    return types.SimpleNamespace(**{n: p.detach().float()
                                    for n, p in module.named_parameters()})


def mesh_hybrid(mesh: Mesh, rank: int):
    """(e) Zamba2-7B on 1x2."""
    cfg, ctx, dev = get_config("zamba2-7b"), make_ctx(mesh), mesh.device
    model = tf.init_params(cfg, seed=0, ctx=ctx)
    b, s = MESH_HYBRID_SHAPE
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(2)).to(dev)
    n = MESH_HYBRID_DECODE
    layer = model.groups[0][0].ssm
    x = torch.randn((b, s, cfg.d_model),
                    generator=torch.Generator().manual_seed(4)).to(dev)
    with torch.inference_mode():
        tf.prefill(model, {"tokens": toks[:, :256]}, cfg, ctx=ctx)
        comm.reset_stats()
        before = ops.launch_counts()
        logits, ms = timed_sync(lambda: tf.prefill(
            model, {"tokens": toks}, cfg, ctx=ctx))
        out = {"ms": ms, "launches": launches_since(before),
               "stats": dict(comm.STATS), "held_gb": gb(held_bytes(model)),
               "whole_gb": gb(cfg.param_count() * 2),
               "heads": layer.dt_bias.shape[0],
               "attn_heads": model.shared_attn.attn.wq.shape[1]}
        cache = tf.init_cache(cfg, 1, n, ctx=ctx)
        out["conv_cache"] = list(cache["groups"][0]["ssm"][0]["conv"].shape)
        comm.reset_stats()
        dec, step_ms = [], []
        for pos in range(n):
            (lg, _), t = timed_sync(lambda: tf.decode_step(
                model, cache, {"tokens": toks[:1, pos:pos + 1]}, pos, cfg,
                ctx=ctx))
            dec.append(lg[:, 0])
            step_ms.append(t)
        out["decode_ms"] = step_ms
        out["decode_stats"] = dict(comm.STATS)
        dec = torch.stack(dec, 1)
        before = ops.launch_counts()
        y_mesh = ssm_mod.ssm_forward(x, f32_layer(layer), cfg, ctx=ctx)
        out["layer_launches"] = launches_since(before)
    del model, cache
    torch.cuda.empty_cache()
    comm.barrier(mesh)
    if rank == 0:
        logit_gap("(e) decode chain vs the mesh's prefill", dec,
                  logits[:1, :n], None, HYBRID_TOL_MEAN, "10")
        whole = tf.init_params(cfg, seed=0, device=dev)
        with torch.inference_mode():
            ref, out["one_rank_ms"] = timed_sync(lambda: tf.prefill(
                whole, {"tokens": toks}, cfg))
            out["max"], out["mean"] = logits_gap(logits, ref)
            y = ssm_mod.ssm_forward(x, f32_layer(whole.groups[0][0].ssm),
                                    cfg)
            out["layer_max"] = float((y_mesh - y).abs().max())
            out["layer_scale"] = float(y.abs().max())
        del whole, ref, y
    del logits, dec, y_mesh, x
    torch.cuda.empty_cache()
    comm.barrier(mesh)
    return out


def mesh_xlstm(mesh: Mesh, rank: int):
    """(f) xLSTM-125M on 1x2."""
    cfg, ctx, dev = get_config("xlstm-125m"), make_ctx(mesh), mesh.device
    model = tf.init_params(cfg, seed=0, ctx=ctx)
    b, s = MESH_XLSTM_SHAPE
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(3)).to(dev)
    n = MESH_HYBRID_DECODE
    with torch.inference_mode():
        tf.prefill(model, {"tokens": toks}, cfg, ctx=ctx)     # warm-up
        comm.reset_stats()
        logits, ms = timed_sync(lambda: tf.prefill(
            model, {"tokens": toks}, cfg, ctx=ctx))
        out = {"ms": ms, "stats": dict(comm.STATS),
               "heads": model.groups[0][0].mlstm.norm_scale.shape[0] // (
                   2 * cfg.d_model // cfg.n_heads)}
        cache = tf.init_cache(cfg, 1, n, ctx=ctx)
        dec = torch.stack([tf.decode_step(
            model, cache, {"tokens": toks[:1, pos:pos + 1]}, pos, cfg,
            ctx=ctx)[0][:, 0] for pos in range(n)], 1)
    del model, cache
    comm.barrier(mesh)
    if rank == 0:
        logit_gap("(f) decode chain vs the mesh's prefill", dec,
                  logits[:1, :n], None, XLSTM_TOL["bf16_mean"], "10")
        whole = tf.init_params(cfg, seed=0, device=dev)
        with torch.inference_mode():
            tf.prefill(whole, {"tokens": toks}, cfg)             # warm-up
            ref, out["one_rank_ms"] = timed_sync(lambda: tf.prefill(
                whole, {"tokens": toks}, cfg))
            out["max"], out["mean"] = logits_gap(logits, ref)
        del whole, ref
    del logits, dec
    torch.cuda.empty_cache()
    comm.barrier(mesh)
    return out


def mesh_recurrent_train(mesh: Mesh, rank: int):
    """(g) one train step of each recurrent family at reduced() on 1x2
    against one rank's."""
    ctx, dev, out = make_ctx(mesh), mesh.device, {}
    for arch in MESH_RECURRENT_ARCHS:
        cfg = get_config(arch).reduced()
        batch = lm_train_batch(cfg, *MESH_RECURRENT_SHAPE, dev, seed=4)
        model = tf.init_params(cfg, seed=0, ctx=ctx)
        loss, _ = tf.lm_loss(model, batch, cfg, ctx=ctx)
        loss.backward()
        grads = {n: tf.gather_full(p.grad, model.param_specs[n], mesh)
                 for n, p in model.named_parameters()}
        whole = tf.init_params(cfg, seed=0, device=dev)
        ref, _ = tf.lm_loss(whole, batch, cfg)
        ref.backward()
        worst, leaf = 0.0, ""
        for n, p in whole.named_parameters():
            r = float((grads[n] - p.grad).abs().max() /
                      p.grad.abs().max().clamp_min(1e-30))
            if r > worst:
                worst, leaf = r, n
        out[arch] = {"loss": float(loss), "ref": float(ref), "worst": worst,
                     "leaf": leaf, "leaves": len(grads),
                     "sharded": sum(any(v) for v in
                                    model.param_specs.values())}
        del model, whole, grads
    return out


def mesh_trainer_batches(dev):
    c = MESH_TRAINER
    data, _ = make_client_datasets(ClientDataConfig(
        n_clients=c["clients"], per_client=2 * c["images"],
        image_size=IMG[0], holdout=2))
    streams = [image_batches(d, c["images"], seed=k)
               for k, d in enumerate(data)]
    return [[next(st).to(dev) for st in streams]
            for _ in range(c["rounds"])]


def mesh_trainer(mesh, dev):
    """4i's trainer: the paper U-Net, ddpm_step in its sample."""
    c = MESH_TRAINER
    cfg = TrainerConfig(n_clients=c["clients"], T=T, cut_ratio=TRAIN_CUT,
                        step_backend="triton")
    return CollaFuseTrainer(cfg, lambda seed: UNet(UNetConfig(), seed=seed),
                            device=dev, mesh=mesh)


def trainer_state(tr, metrics) -> dict:
    """Round losses and the whole state on the host (collective on a
    mesh)."""
    return {"losses": [[m["server_loss"]] + m["client_losses"]
                       for m in metrics],
            "server": {k: v.cpu() for k, v in tr.server_params.items()},
            "clients": {k: v.cpu() for k, v in tr.client_stack.items()}}


def mesh_collafuse(mesh: Mesh, rank: int, tmp: str):
    """4i on the ranks: 2 rounds, then trainer.sample through ddpm_step
    and through the plain step; rank 0 writes the state to ``tmp``."""
    dev = mesh.device
    tr = mesh_trainer(mesh, dev)
    batches = mesh_trainer_batches(dev)
    metrics, ms = [], []
    comm.reset_stats()
    for r in range(MESH_TRAINER["rounds"]):
        m, t = timed_sync(lambda: tr.train_round(batches[r]))
        metrics.append(m)
        ms.append(t)
    stats = dict(comm.STATS)
    state = trainer_state(tr, metrics)
    digest = hashlib.sha256(b"".join(
        v.numpy().tobytes() for v in state["server"].values())).hexdigest()
    before = ops.launch_counts()
    gen = tr.sample(5, (2, *IMG))
    launches = launches_since(before)
    tr.step_backend = get_backend("torch")
    plain = tr.sample(5, (2, *IMG))
    out = {"ms": ms, "stats": stats, "digest": digest,
           "clients": list(tr._clients), "launches": launches,
           "sample_gap": float((gen - plain).abs().max()),
           "sample_finite": bool(torch.isfinite(gen).all())}
    if rank == 0:
        torch.save(state, Path(tmp) / "trainer.pt")
    del tr, state, gen, plain
    gc.collect()
    torch.cuda.empty_cache()
    comm.barrier(mesh)
    return out


def mesh_rank(rank: int, port: int, tmp: str) -> None:
    """One of phase 10's ranks: the mesh's sub-phases in turn, their
    results written to ``tmp/rank<r>.json``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = init_mesh((1, MESH_RANKS), rank, f"127.0.0.1:{port}")
    out = {"transport": mesh.transport, "device": str(mesh.device),
           "walls": {}}
    data = mesh_view(mesh, (MESH_RANKS, 1))
    run = {"a": lambda: mesh_tp(mesh, rank),
           "b": lambda: mesh_ep(mesh, rank),
           "c": lambda: mesh_fsdp(data, rank),
           "e": lambda: mesh_hybrid(mesh, rank),
           "f": lambda: mesh_xlstm(mesh, rank),
           "g": lambda: mesh_recurrent_train(mesh, rank),
           "i": lambda: mesh_collafuse(data, rank, tmp)}
    try:
        for part, fn in run.items():
            # each part starts from this rank's live tensors alone: the two
            # ranks share one card, and a part's cached blocks (or a
            # cycle's) would starve the other rank's next part
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            out[part] = fn()
            out["walls"][part] = time.perf_counter() - t0
    finally:
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(out))
        close_mesh(mesh)


def mesh_run():
    """Phase 10's ranks on the mesh the machine gives: their results."""
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run_ranks(mesh_rank, MESH_RANKS, (tmp,), timeout_s=MESH_TIMEOUT_S)
        res = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
               for r in range(MESH_RANKS)]
        if (Path(tmp) / "trainer.pt").exists():
            res[0]["i"]["state"] = torch.load(Path(tmp) / "trainer.pt")
    print(f"[10] the mesh: {MESH_RANKS} ranks on {res[0]['device']} and "
          f"{res[1]['device']} over {res[0]['transport']}, "
          f"{time.perf_counter() - t0:.1f}s; rank 0's parts "
          + ", ".join(f"({k}) {v:.1f}s" for k, v in res[0]["walls"].items()),
          flush=True)
    return res


def stats_text(st) -> str:
    return (f"collectives {st['calls']} calls {st['bytes'] / 1e9:.3f} GB "
            f"{st['ms']:.1f} ms (none staged through the host)")


def rank_shape_kernels(dev, card: str):
    """(e)'s kernels at a rank's shapes against their plain versions:
    ``ssm_scan`` on 56 of Zamba2-7B's 112 heads (float32, as
    ``ssm_forward`` feeds it) and bf16 ``flash_attention`` on 16 of the
    shared block's 32 heads (hd 112)."""
    b, s, nh, p, n = SSM_SHAPE
    nh //= MESH_RANKS
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((b, s, nh, p), generator=g, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((b, s, nh), generator=g,
                                                  device=dev))
    a = -torch.exp(0.3 * torch.randn(nh, generator=g, device=dev))
    bm, cm = (torch.randn((b, s, n), generator=g, device=dev)
              for _ in range(2))
    y = ops.ssm_scan(x, dt, a, bm, cm)
    ref = kref.ssm_scan_ref(x, dt, a, bm, cm)
    err = float((y - ref).abs().max())
    scale = float(ref.abs().max())
    t_k = cuda_time_ms(lambda: ops.ssm_scan(x, dt, a, bm, cm), iters=10,
                       warmup=2)
    t_p = cuda_time_ms(lambda: kref.ssm_scan_ref(x, dt, a, bm, cm), iters=2,
                       warmup=1)
    t_bytes, _, t_3x = ssm_bounds_ms(x, dt, a, bm, cm, card)
    print(f"[10] (e) ssm_scan at a rank's shape x {tuple(x.shape)} N {n}: "
          f"max_abs_err {err:.3e} (max |y| {scale:.3f}, tolerance "
          f"{SSM_TOL[torch.float32]} of it) | kernel {t_k:.3f} ms, plain "
          f"{t_p:.3f} ms, bound {max(t_bytes, t_3x):.3f} ms", flush=True)
    if not torch.isfinite(y).all() or err > SSM_TOL[torch.float32] * scale:
        raise AssertionError("ssm_scan disagrees at a rank's shape")
    del x, dt, a, bm, cm, y, ref
    torch.cuda.empty_cache()
    hb, hs, hh, _, hd = HYBRID_ATTN_SHAPE
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((hb, hs, hh // MESH_RANKS, hd), generator=g,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    print("[10] (e) flash_attention at a rank's 16 heads of the shared "
          "block:", flush=True)
    attention_case(q, k, v, 0, card)
    del q, k, v
    torch.cuda.empty_cache()


def mesh_collafuse_reference(dev):
    """4i's one-process trainer: its round losses and state."""
    tr = mesh_trainer(None, dev)
    batches = mesh_trainer_batches(dev)
    metrics = [tr.train_round(batches[r])
               for r in range(MESH_TRAINER["rounds"])]
    out = trainer_state(tr, metrics)
    del tr, batches
    gc.collect()             # the trainer's loss closures hold it in a cycle
    torch.cuda.empty_cache()
    return out


def tree_gap(a: dict, b: dict):
    """(max |Δ|, mean |Δ|) over every entry of two trees of tensors."""
    mx, tot, n = 0.0, 0.0, 0
    for k in a:
        d = (a[k].float() - b[k].float()).abs()
        mx = max(mx, float(d.max()))
        tot += float(d.sum(dtype=torch.float64))
        n += d.numel()
    return mx, tot / n


def check_mesh_recurrent(res) -> bool:
    """Print and hold (e), (f) and (g)."""
    ok = True
    e = [r["e"] for r in res]
    for r, x in enumerate(e):
        print(f"[10] (e) zamba2-7b prefill {MESH_HYBRID_SHAPE[0]}x"
              f"{MESH_HYBRID_SHAPE[1]} mesh 1x2 rank {r}: holds "
              f"{x['held_gb']:.2f} of {x['whole_gb']:.2f} GB, Mamba2 heads "
              f"{x['heads']} and attention heads {x['attn_heads']} a rank, "
              f"conv cache {x['conv_cache']} ([x_r, B, C]); launches "
              f"ssm_scan {x['launches']['ssm_scan']} flash_attention "
              f"{x['launches']['flash_attention']}; {x['ms']:.1f} ms, "
              f"{stats_text(x['stats'])}; decode ms a step "
              f"{[round(t, 1) for t in x['decode_ms']]}, "
              f"{stats_text(x['decode_stats'])} over "
              f"{MESH_HYBRID_DECODE} steps", flush=True)
    e0 = e[0]
    print(f"[10] (e) logits against one rank's prefill of the same weights "
          f"({e0['one_rank_ms']:.1f} ms): max |d| {e0['max']:.4g} mean "
          f"{e0['mean']:.4g} (held: mean {HYBRID_TOL_MEAN}); one Mamba2 "
          f"layer in float32, sharded against whole: max |d| "
          f"{e0['layer_max']:.3e} of max |out| {e0['layer_scale']:.3f} "
          f"(held: {MESH_LAYER_TOL} of it), its ssm_scan launches "
          f"{e0['layer_launches']['ssm_scan']}", flush=True)
    ok &= all(x["launches"]["ssm_scan"] == 81 and
              x["launches"]["flash_attention"] == 14 and x["heads"] == 56
              and x["attn_heads"] == 16 for x in e)
    ok &= e0["mean"] <= HYBRID_TOL_MEAN and \
        e0["layer_max"] <= MESH_LAYER_TOL * e0["layer_scale"]
    f = [r["f"] for r in res]
    for r, x in enumerate(f):
        print(f"[10] (f) xlstm-125m prefill {MESH_XLSTM_SHAPE[0]}x"
              f"{MESH_XLSTM_SHAPE[1]} mesh 1x2 rank {r}: mLSTM heads "
              f"{x['heads']} a rank, {x['ms']:.1f} ms (after a warm-up "
              f"call), {stats_text(x['stats'])}", flush=True)
    print(f"[10] (f) logits against one rank's prefill "
          f"({f[0]['one_rank_ms']:.1f} ms): max |d| {f[0]['max']:.4g} mean "
          f"{f[0]['mean']:.4g} (held: mean {XLSTM_TOL['bf16_mean']})",
          flush=True)
    ok &= f[0]["mean"] <= XLSTM_TOL["bf16_mean"] and \
        all(x["heads"] == 2 for x in f)
    for arch, x in res[0]["g"].items():
        rel = abs(x["loss"] - x["ref"]) / abs(x["ref"])
        print(f"[10] (g) {arch} reduced() train step on 1x2 "
              f"({x['sharded']} of {x['leaves']} leaves sharded): loss "
              f"{x['loss']:.7f} against one rank's {x['ref']:.7f} (rel "
              f"{rel:.2e}, held {MESH_RECURRENT_TOL['loss']}); worst leaf "
              f"gradient {x['leaf']} {x['worst']:.2e} of its max (held "
              f"{MESH_RECURRENT_TOL['grad']})", flush=True)
        ok &= rel <= MESH_RECURRENT_TOL["loss"] and \
            x["worst"] <= MESH_RECURRENT_TOL["grad"] and x["sharded"] > 0
    return ok


def check_mesh_collafuse(res, ref) -> bool:
    """Print and hold 4i."""
    c = MESH_TRAINER
    x = [r["i"] for r in res]
    got = x[0]["state"]
    bitwise = x[0]["digest"] == x[1]["digest"]
    loss0 = np.allclose(got["losses"][0], ref["losses"][0],
                        **TRAIN_LOSS_TOL)
    s_max, s_mean = tree_gap(got["server"], ref["server"])
    c_max, c_mean = tree_gap(got["clients"], ref["clients"])
    p_max, p_mean = c["rounds"] * TRAIN_PARAM_MAX, TRAIN_PARAM_MEAN
    for r, y in enumerate(x):
        print(f"[4i] CollaFuseTrainer(mesh=) on 2x1 rank {r}: clients "
              f"{y['clients']}, round ms {[round(t, 1) for t in y['ms']]}, "
              f"{stats_text(y['stats'])}; trainer.sample through ddpm_step "
              f"(launches {y['launches']['ddpm_step']}) against the plain "
              f"step max |d| {y['sample_gap']:.3e} (held 1e-2), finite "
              f"{y['sample_finite']}", flush=True)
    print(f"[4i] paper U-Net, {c['clients']} clients x {c['images']} "
          f"images, {c['rounds']} rounds, against the one-process trainer: "
          f"round 0 losses {[round(v, 6) for v in got['losses'][0]]} vs "
          f"{[round(v, 6) for v in ref['losses'][0]]} within "
          f"{TRAIN_LOSS_TOL} {loss0}; server parameters max |d| "
          f"{s_max:.3e} mean {s_mean:.3e}, clients max {c_max:.3e} mean "
          f"{c_mean:.3e} (held: max {p_max:.4g}, mean {p_mean:g}); server "
          f"parameters the same bits on both ranks {bitwise}", flush=True)
    return bitwise and loss0 and max(s_max, c_max) <= p_max and \
        max(s_mean, c_mean) <= p_mean and all(
            y["launches"]["ddpm_step"] > 0 and y["sample_gap"] <= 1e-2 and
            y["sample_finite"] for y in x)


def check_mesh_lm(res, ref_loss, ref_norm, ref_state, cards) -> bool:
    """Print and hold (a)-(c), then run and hold (d)."""
    ok = True
    # (a)
    a = [r["a"] for r in res]
    for r, x in enumerate(a):
        print(f"[10] (a) yi-6b prefill {MESH_YI_SHAPE[0]}x{MESH_YI_SHAPE[1]}"
              f" mesh 1x2 rank {r}: holds {x['held_gb']:.2f} of "
              f"{x['whole_gb']:.2f} GB, heads {x['local_heads']} kv "
              f"{x['local_kv']} a rank, flash_attention launches "
              f"{x['launches']}, {x['ms']:.1f} ms, "
              f"{stats_text(x['stats'])}", flush=True)
    print(f"[10] (a) logits {a[0]['shape']} against one rank's prefill of "
          f"the same weights ({a[0]['one_rank_ms']:.1f} ms): max |d| "
          f"{a[0]['max']:.4g} mean {a[0]['mean']:.4g} (held: "
          f"{LM_TOL_MAX} and {LM_TOL_MEAN})", flush=True)
    ok &= all(x["launches"] == 32 and x["local_heads"] == 16 and
              x["local_kv"] == 2 for x in a)
    ok &= a[0]["max"] <= LM_TOL_MAX and a[0]["mean"] <= LM_TOL_MEAN
    # (b)
    bb = [r["b"] for r in res]
    emu = bb[0]
    dec_sum = [[x + y for x, y in zip(c0, c1)]
               for c0, c1 in zip(bb[0]["decode_counts"],
                                 bb[1]["decode_counts"])]
    same_d = dec_sum == emu["decode_emulated"]
    for r, x in enumerate(bb):
        same_p = x["prefill_counts"] == emu["prefill_emulated"][r]
        parts = ", ".join(f"{k} {v:.2f}" for k, v in x["parts_ms"].items())
        print(f"[10] (b) deepseek-v2 {MESH_MOE[1]} layers mesh 1x2 rank {r}:"
              f" holds {x['held_gb']:.2f} of {x['whole_gb']:.2f} GB, "
              f"{x['experts']} experts; prefill {MOE_SHAPE[0]}x{MOE_SHAPE[1]}"
              f" paths {x['prefill_paths']} {x['prefill_ms']:.1f} ms, "
              f"{stats_text(x['prefill_stats'])}; kept/dropped a layer "
              f"{x['prefill_counts']} equal moe_local's on block {r} "
              f"{same_p}; decode batch 1 paths {x['decode_paths']} "
              f"{x['decode_ms']:.1f} ms a step, its experts' kept/dropped "
              f"{x['decode_counts']}", flush=True)
        print(f"[10] (b) rank {r} one MoE layer's all-to-all path by part "
              f"(ms): {parts}", flush=True)
        ok &= same_p and x["prefill_paths"] == ["all_to_all"] \
            and x["decode_paths"] == ["replicated"]
    print(f"[10] (b) decode: the ranks' kept/dropped summed {dec_sum} equal "
          f"moe_local's on the step's tokens {same_d}", flush=True)
    print(f"[10] (b) against moe_local with the whole model's weights on "
          f"rank 0, a block at a time: the all-to-all layer max |d| "
          f"{emu['layer_max']:.4g} mean {emu['layer_mean']:.4g}, the "
          f"replicated layer max |d| {emu['decode_layer_max']:.4g} mean "
          f"{emu['decode_layer_mean']:.4g} (held: "
          f"{MOE_TOL['layer_max']:g}, {MOE_TOL['layer_mean']:g})",
          flush=True)
    ok &= same_d and all(
        emu[k + "_max"] <= MOE_TOL["layer_max"] and
        emu[k + "_mean"] <= MOE_TOL["layer_mean"]
        for k in ("layer", "decode_layer"))
    # (c)
    cc = [r["c"] for r in res]
    for r, x in enumerate(cc):
        med = sorted(x["ms"][1:])[len(x["ms"][1:]) // 2]
        print(f"[10] (c) {MESH_TRAIN_ARCH} fsdp mesh 2x1 rank {r}: state "
              f"{x['state_gb']:.2f} GB (one rank {gb(ref_state):.2f}), "
              f"gradients {x['grads_gb']:.2f} GB, the rest "
              f"{x['rest_gb']:.2f} GB, peak {x['peak_gb']:.2f} GB; step "
              f"ms {[round(t, 1) for t in x['ms']]} (median after the "
              f"first {med:.1f}), {stats_text(x['stats'])} over "
              f"{MESH_TRAIN_STEPS} steps", flush=True)
    c0 = cc[0]
    l_ok = abs(c0["losses"][0] - ref_loss) <= MESH_TRAIN_RTOL * abs(ref_loss)
    n_ok = abs(c0["norms"][0] - ref_norm) <= MESH_TRAIN_RTOL * abs(ref_norm)
    falls = c0["losses"][-1] < c0["losses"][0]
    half = all(abs(x["state_gb"] - gb(ref_state) / 2) <=
               0.01 * gb(ref_state) for x in cc)
    print(f"[10] (c) losses {[round(v, 4) for v in c0['losses']]}, grad "
          f"norms {[round(v, 4) for v in c0['norms']]}; step 1 against one "
          f"rank's step on the global {MESH_TRAIN_SHAPE[0]}x"
          f"{MESH_TRAIN_SHAPE[1]} batch: loss {c0['losses'][0]:.6f} vs "
          f"{ref_loss:.6f} {l_ok}, grad norm {c0['norms'][0]:.6f} vs "
          f"{ref_norm:.6f} {n_ok} (rtol {MESH_TRAIN_RTOL}); the loss falls "
          f"{falls}; a rank's state half the one-rank state {half}",
          flush=True)
    ok &= l_ok and n_ok and falls and half
    if cards < MESH_RANKS:
        print(f"[10] NCCL, a card a rank: not run ({cards} card)", flush=True)
    # (d)
    texts = run_children([[sys.executable, *c] for c in MESH_LAUNCHES],
                         timeout_s=MESH_TIMEOUT_S)
    serve_ok = "serving loop OK" in texts[0] and \
        "mesh=data:1xmodel:2 transport=" in texts[0]
    train_ok = "done: loss" in texts[1] and \
        "mesh=data:2xmodel:1 transport=" in texts[1]
    for text, what in zip(texts, ("serve yi-6b full 1x2",
                                  "train yi-6b reduced 2x1 --fsdp")):
        last = [ln for ln in text.splitlines()
                if "mesh=" in ln or "serving loop" in ln or "done:" in ln
                or "request" in ln or "peak" in ln]
        print(f"[10] (d) {what}: " + " | ".join(last), flush=True)
    ok &= serve_ok and train_ok
    return ok


def phase_mesh(dev, card: str):
    """10: the (data, model) mesh, two ranks."""
    t_phase = time.perf_counter()
    backend, cards = transport_for("cuda", MESH_RANKS)
    how = "a card a rank" if backend == "nccl" else \
        "the ranks share card 0: NCCL refuses two ranks on one GPU"
    print(f"[10] mesh: {MESH_RANKS} ranks, {cards} card(s) of {card}: "
          f"transport {backend} ({how})", flush=True)
    ref_loss, ref_norm, ref_state = mesh_train_reference(dev)
    res = mesh_run()
    # after the ranks: its trainer would hold the card's memory
    trainer_ref = mesh_collafuse_reference(dev)
    ok = check_mesh_lm(res, ref_loss, ref_norm, ref_state, cards)
    rank_shape_kernels(dev, card)
    ok &= check_mesh_recurrent(res)
    ok &= check_mesh_collafuse(res, trainer_ref)
    if not ok:
        raise AssertionError("mesh phase failed")
    print(f"[10] mesh phase {time.perf_counter() - t_phase:.1f}s", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 11: the dry run and the roofline against the card
# ---------------------------------------------------------------------------
# (a) phase 5 (a)'s Yi-6B prefill, 4 x 2048 through the kernel
ROOFLINE_SHAPE = InputShape("yi_prefill_4x2048", ATTN_SHAPE[1],
                            ATTN_SHAPE[0], "prefill")
# (b) the dry run's argument_bytes + temp_bytes against the card's peak
# above what was allocated before the model was built.  Both count the
# same tensors: the weights and the batch, then every tensor the prefill
# creates, freed when it dies (the counter tracks each storage; the
# kernel's meta branch allocates the output the kernel's wrapper
# allocates).  The card adds what the dry run cannot see: the caching
# allocator rounds each block up to 512 bytes (a few thousand blocks, ~1
# MB) and a library may take a workspace on a first call, which the
# warm-up call makes before the peak is reset.  Yi-6B's 12.1 GB of weights
# and ~2 GB at the peak: 5 % (~0.7 GB) holds those, and catches a missing
# or doubled activation (the logits alone are 1.05 GB).
ROOFLINE_MEM_RTOL = 0.05
# (d) the production combos: every arch x prefill_32k on 32 nodes of 8
# cards, with probes, in worker processes on the host (the dry run needs no
# card).  xLSTM's alone took 178.8 s of the host in a pool of 7 (its sLSTM
# loop over 32k steps, each step's ops on meta), so the workers start
# right after phase 10 ("dry_combos") and run beside phases 4-4c, whose
# host-side times they share the host with; 4 workers leave the other
# cores to those phases; the two longest (xLSTM, DeepSeek-V2's MLA
# blockwise prefill) are submitted first
ROOFLINE_COMBOS = [(a, "prefill_32k") for a in list_archs()]
ROOFLINE_FIRST = ("xlstm-125m", "deepseek-v2-236b")
ROOFLINE_WORKERS = 4
CARD_GB = 80.0


def dry_combo(arch: str, shape: str):
    """(the record of ``arch`` x ``shape`` on ``single``, its wall s)."""
    t0 = time.perf_counter()
    rec = dryrun.run_combo(arch, shape, "single")
    return rec, time.perf_counter() - t0


def start_dry_combos():
    """(d)'s combinations submitted to worker processes: (the pool, {combo:
    its future})."""
    pool = ProcessPoolExecutor(ROOFLINE_WORKERS,
                               mp_context=mp.get_context("spawn"))
    return pool, {c: pool.submit(dry_combo, *c) for c in sorted(
        ROOFLINE_COMBOS, key=lambda c: c[0] not in ROOFLINE_FIRST)}


def terms_text(r) -> str:
    return (f"compute {r['compute_s'] * 1e3:.3f} ms (counted "
            f"{r['compute_hlo_s'] * 1e3:.3f}), memory {r['memory_s'] * 1e3:.3f}"
            f" ms, collective {r['collective_s'] * 1e3:.3f} ms, dominant "
            f"{r['dominant']} ({r['bound_fraction']:.1%}), useful "
            f"{r['useful_ratio']:.3f}")


def phase_roofline(dev, card: str, lm: dict, mesh_res, dry_combos):
    """11: the dry run held against the card on work the script does;
    ``dry_combos`` is :func:`start_dry_combos`' (pool, futures)."""
    t_phase = time.perf_counter()
    ok = True
    pool, futures = dry_combos
    try:
        cfg = get_config("yi-6b")
        shape = ROOFLINE_SHAPE
        # (a) the dry 1x1 prefill against the counter over a real one
        rec = dryrun.run_combo("yi-6b", shape, "1x1", cfg=cfg)
        dry = rec["full"]
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        model = tf.init_params(cfg, seed=0, device=dev)
        g = torch.Generator(device=dev).manual_seed(11)
        batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (shape.global_batch, shape.seq_len),
            generator=g, device=dev)}
        prefill = make_prefill_step(cfg, kernel="flash")
        prefill(model, batch)                           # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with WorkCounter() as real:
            logits = prefill(model, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        same = (real.flops == dry["flops"] and real.bytes ==
                dry["bytes_accessed"] and real.ops == dry["ops"] and
                real.units == dry["kernels"])
        print(f"[11] (a) yi-6b prefill {shape.global_batch}x{shape.seq_len}"
              f": dry (meta, 1x1) {dry['flops']:.6e} FLOP, "
              f"{dry['bytes_accessed']:.6e} bytes, {dry['ops']} ops, kernels"
              f" {dry['kernels']}; counted on the card {real.flops:.6e} FLOP,"
              f" {real.bytes:.6e} bytes, {real.ops} ops: equal {same}",
              flush=True)
        ok &= same and logits.shape == (shape.global_batch, shape.seq_len,
                                         cfg.vocab_size)
        r = rec["roofline"]
        bound_s = max(r["compute_s"], r["memory_s"])
        # the whole step's yardstick: the analytic terms, which no change
        # to the port's op sequence moves (the counted memory term is what
        # the port moves today, a diagnostic)
        yard_s = max(r["compute_s"], r["memory_analytic_s"])
        print(f"[11] (a) roofline on one card: {terms_text(r)}; phase 5 "
              f"(a)'s prefill {lm['ms']:.1f} ms = "
              f"{lm['ms'] / 1e3 / yard_s:.2f}x max(compute, analytic "
              f"memory {r['memory_analytic_s'] * 1e3:.1f} ms) "
              f"({yard_s * 1e3:.1f} ms), "
              f"{lm['ms'] / 1e3 / bound_s:.2f}x max(compute, memory) "
              f"({bound_s * 1e3:.1f} ms); counted bytes "
              f"{dry['bytes_accessed'] / lm['ms'] / 1e6:.0f} GB/s at that "
              f"time (of {HBM_BW / 1e9:.0f}), counted FLOP "
              f"{dry['flops'] / lm['ms'] / 1e9:.1f} TFLOP/s", flush=True)
        # (b) memory
        mem = dry["memory"]
        want = mem["argument_bytes"] + mem["temp_bytes"]
        gap = abs(peak - want) / peak
        print(f"[11] (b) memory: dry argument {gb(mem['argument_bytes']):.3f}"
              f" + temp {gb(mem['temp_bytes']):.3f} = {gb(want):.3f} GB; the "
              f"card's peak above the baseline {gb(peak):.3f} GB "
              f"(max_memory_allocated); gap {gap:.2%} (held "
              f"{ROOFLINE_MEM_RTOL:.0%})", flush=True)
        ok &= gap <= ROOFLINE_MEM_RTOL
        del model, logits, batch
        torch.cuda.empty_cache()
        # (c) the dry 1x2 prefill against phase 10 (a)'s ranks
        b, s = MESH_YI_SHAPE
        for rank in range(MESH_RANKS):
            st = dryrun.count_step(
                cfg, InputShape("yi_prefill", s, b, "prefill"),
                dryrun.dry_mesh("1x2", rank=rank))
            real_st = mesh_res[rank]["a"]["stats"]
            same = st["stats"] == {"calls": real_st["calls"],
                                   "bytes": real_st["bytes"]}
            print(f"[11] (c) yi-6b prefill {b}x{s} mesh 1x2 rank {rank}: dry"
                  f" {st['stats']['calls']} calls {st['stats']['bytes']} "
                  f"bytes ({st['collectives']['counts']}, link bytes "
                  f"{st['collectives']['link_bytes_by_class']}); phase 10 "
                  f"(a) {real_st['calls']} calls {real_st['bytes']} bytes: "
                  f"equal {same}", flush=True)
            ok &= same
        # (d) the production combos
        for arch, shp in ROOFLINE_COMBOS:
            rec, wall = futures[(arch, shp)].result()
            r, mem = rec["roofline"], rec["full"]["memory"]
            args_gb = gb(mem["argument_bytes"])
            print(f"[11] (d) {arch} x {shp} x single "
                  f"({rec['mesh_shape']}): {terms_text(r)}; argument "
                  f"{args_gb:.2f} GB a card "
                  f"{'> ' if args_gb > CARD_GB else '<= '}{CARD_GB:.0f} GB, "
                  f"temp {gb(mem['temp_bytes']):.2f} GB; {wall:.1f} s",
                  flush=True)
            ok &= r["dominant"] in ("compute_s", "memory_s", "collective_s")
    finally:
        pool.shutdown(cancel_futures=True)
    if not ok:
        raise AssertionError("roofline phase failed")
    print(f"[11] roofline phase {time.perf_counter() - t_phase:.1f}s",
          flush=True)


def _phase_child(fn, args, path: str) -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.save(fn(*args), path)


def phase_in_child(fn, *args, timeout_s: float = MESH_TIMEOUT_S + 300):
    """``fn(*args)`` in a process of its own (``spawn``; TF32 off, as in
    ``main``), its result returned through a file: what it allocates on
    the card never enters this process's caching allocator.  Raises if the
    process fails or outlives ``timeout_s``."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "result.pt"
        proc = ctx.Process(target=_phase_child, args=(fn, args, str(path)))
        proc.start()
        proc.join(timeout_s)
        if proc.is_alive():
            proc.kill()
            proc.join()
            raise RuntimeError(f"{fn.__name__} outlived {timeout_s:.0f} s")
        if proc.exitcode:
            raise RuntimeError(f"{fn.__name__} failed in its process (exit "
                               f"{proc.exitcode})")
        return torch.load(path, weights_only=False)


# the phases in order: (name, whether the CUDA cache is emptied first, the
# call on (device, card, the results of the phases before it by name)).
# The mesh runs in a process of its own, right after the kernels, while
# this process holds almost nothing on the card: its two ranks and its
# parent share the one card, and from phase 4d on this process keeps ~1.2
# GB live in ~11 GB of segments it cannot release, which ran phase 10 (i)
# out of memory when it ran last.  (Phase 4c crowds the allocator itself
# before it holds k = 4 bitwise k = 1.)  Phase 11 (d)'s workers
# ("dry_combos") start right after it, so none runs beside its ranks.
PHASES = [
    ("kernels", False, lambda dev, card, res: phase_kernels(dev, card)),
    ("attention", False, lambda dev, card, res: phase_attention(dev, card)),
    ("ssm", False, lambda dev, card, res: phase_ssm(dev, card)),
    ("mesh", False,
     lambda dev, card, res: phase_in_child(phase_mesh, dev, card)),
    ("dry_combos", False, lambda dev, card, res: start_dry_combos()),
    ("slice", False, lambda dev, card, res: phase_slice(dev)),
    ("train", False, lambda dev, card, res: phase_train(dev, card)),
    ("guided", False,
     lambda dev, card, res: phase_guided(dev, card, res["slice"][1])),
    ("host", False,
     lambda dev, card, res: phase_host(dev, card, res["slice"][1])),
    ("obs", False, lambda dev, card, res: phase_obs(dev, card)),
    ("pod", False, lambda dev, card, res: phase_pod(dev, card)),
    ("model_serve", False,
     lambda dev, card, res: phase_model_serve(dev, card)),
    ("paper", False, lambda dev, card, res: phase_paper(dev, card)),
    ("lm", False, lambda dev, card, res: phase_lm(dev, card)),
    ("hybrid", False, lambda dev, card, res: phase_hybrid(dev, card)),
    ("moe", True, lambda dev, card, res: phase_moe(dev, card)),
    ("families", True, lambda dev, card, res: phase_families(dev, card)),
    ("lm_train", True, lambda dev, card, res: phase_lm_train(dev, card)),
    ("roofline", True, lambda dev, card, res: phase_roofline(
        dev, card, res["lm"], res["mesh"], res["dry_combos"])),
]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    # the reference computes in f32: no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(name):
        """Print the phase's wall time and the total: the script has 1200 s,
        the kernels' build included."""
        now = time.perf_counter()
        print(f"[time] {name} {now - t_lap[0]:.1f}s, total "
              f"{now - t_start:.1f}s", flush=True)
        t_lap[0] = now

    card = phase_device()
    phase_build(dev)
    lap("device and build")
    res = {}
    for name, fresh, fn in PHASES:
        if fresh:
            torch.cuda.empty_cache()
        res[name] = fn(dev, card, res)
        lap(name)
    rows, attn_rows, ssm_rows = res["kernels"], res["attention"], res["ssm"]
    g, noise_rows = res["guided"], res["host"]
    lm_counts, hybrid_counts = res["lm"]["counts"], res["hybrid"]
    # the step kernels' launches on this slice's path, guided and gated
    # serving (phase 4's are printed in its own lines)
    counts = {"traj_masked_step": g["cuda_masked"]["traj_masked_step"],
              "lane_noise": g["cuda_masked"]["lane_noise"],
              "ddpm_step": g["triton"]["ddpm_step"],
              "flash_attention": lm_counts["flash_attention"],
              "ssm_scan": hybrid_counts["ssm_scan"]}
    main_row = rows[(8, torch.float32)]
    src = {"traj_masked_step": ("cuda", "src/repro_torch/kernels/csrc/"
                                "traj_masked_step.cu",
                                "src/repro/kernels/ddpm_step.py:206"),
           "ddpm_step": ("triton", "src/repro_torch/kernels/ddpm_step.py",
                         "src/repro/kernels/ddpm_step.py:78")}
    kernels = []
    for name, (route, source, replaces) in src.items():
        err, t_k, t_p, b, by = main_row[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                        "bound_ms": b, "bound_by": by,
                        "library_ms": None})
    if counts["lane_noise"] == 0:
        raise AssertionError("lane_noise never launched on phase 4c's run")
    err, t_k, t_p, b, by = noise_rows[8]
    kernels.append({"name": "lane_noise", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/lane_noise.cu",
                    "replaces": "src/repro/diffusion/backend.py:214 "
                                "(jax.random.normal, not a TPU kernel)",
                    "launches": counts["lane_noise"], "max_abs_err": err,
                    "ms": t_k, "plain_ms": t_p, "bound_ms": b,
                    "bound_by": by, "library_ms": None})
    err, t_k, t_p, b, by, lib = attn_rows[(ATTN_SHAPE, torch.bfloat16, 0)]
    kernels.append({"name": "flash_attention", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:124",
                    "launches": counts["flash_attention"],
                    "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                    "bound_ms": b, "bound_by": by, "library_ms": lib})
    err, t_k, t_p, b, by = ssm_rows[torch.float32]
    kernels.append({"name": "ssm_scan", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
                    "replaces": "src/repro/kernels/ssm_scan.py:84",
                    "launches": counts["ssm_scan"],
                    "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                    "bound_ms": b, "bound_by": by, "library_ms": None})
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
