#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and drive its serving and training
paths on one card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own line and each fatal on failure:

0. environment: the card's name and power limit, torch / CUDA / nvcc
   versions, and the f32 matmul settings (TF32 off);
1. build: every ``mat_dcml_tpu_torch/csrc/*.cu`` with nvcc into
   ``mat_dcml_tpu_torch/_build/`` (keyed by a hash of the source), one nvcc
   per source, all started together;
2. kernels: each kernel against its plain PyTorch version, with a
   planted-fault reading far outside the tolerance, and the kernel, plain,
   library and bound times: attention_fwd (f32 and bf16, serving shapes),
   attention_bwd (the PPO update's shapes, against autograd through the plain
   forward; fed the forward's row statistics as the main path feeds it,
   which must equal what it gives finding them itself), both timed in both
   dtypes at DCML's and SMAC's shapes with kernel / SDPA and kernel / bound
   beside each, ar_decode, the whole decode, at full DCML width (B = 1, 3, 8,
   9, 17, 128; deterministic and with noise; avail masked and None), on
   short decodes (A = 1, 2, 10), with weights in device memory (n_embd 256)
   and off the recipe's widths (4 heads, n_embd 32: the generic kernel),
   timed at B = 1, 8, 128 beside the earlier design's recorded time and the
   cached decode's, and decode_step, one decode position, for both
   continuous families (B = 1, 3, 8, 9, 17, 128; A = 10, 101; positions 0,
   mid, last; logits and every cache), on position-major caches, short
   decodes, n_embd 256 and the generic kernel's widths, timed beside the
   earlier design's recorded time and the cached decode step's; each check
   and timing prints the launch plan (path, rows a cluster, which kernel)
   and each timing the cluster barriers a position (ar_decode) or a launch
   (decode_step); both attention kernels at N = B * H = 70,000 rows (35,000
   x 2 heads, L 8), past the 65,535 blocks a grid's y axis allows, f32 and
   bf16;
3. serving: the DCML MAT policy at full width (101 agents, obs 7, state 102,
   n_embd 64, 2 blocks, 2 heads, seeded random weights) served through
   ContinuousBatcher -> DecodeEngine -> serve_decode on the card, first with
   decode_mode="cached" (every attention through the kernel: 406 launches per
   dispatch), then with decode_mode="scan" (2 attention launches and 1
   ar_decode launch per dispatch); a bucket-8 decode must match the port on
   the CPU, and the scan decode the card's cached decode; then both modes
   again with serve_dtype="bf16", which must match the port's bf16 engine on
   the CPU and stay within the JAX canary contract of the f32 engine;
4. close: each batcher's thread joined, no thread left behind;
5. training: DCMLRunner at the recipe's full width (101 agents, n_embd 64,
   2 blocks, 2 heads, E = 8, T = 50, 15 PPO epochs x 4 minibatches) runs one
   iteration (collect, GAE, PPO update) on the card with the cached decode;
   every attention forward and backward must go through the kernels (counted
   exactly), the metrics must be finite, and one more update on the card must
   match the same update by the port on the CPU (same trajectory, weights,
   Adam state and permutations); then one iteration with
   decode_mode="scan", whose 50 rollout decodes are 50 ar_decode launches;
   then a bf16 trunk (model_dtype="bfloat16"): one cached and one scan
   iteration, and one more bf16 update matched against the CPU port;
6. continuous serving: MAT on multi-agent MuJoCo lite at full width
   (manyagent_ant 10x2: 10 agents, action 8, obs 36, state 240, n_embd 64,
   2 blocks, 2 heads; seeded random weights at O(1) scale) served through
   the batcher and engine, cached then scan (10 decode_step launches per
   dispatch); bucket 8 must match the port on the CPU, and scan the cached;
   then both modes with serve_dtype="bf16", matched against the CPU port;
7. continuous training: two MujocoRunner iterations at that configuration
   (E = 8, T = 50, the recipe's PPO), cached then scan (500 decode_step
   launches), launches counted exactly, and one update on the card matched
   against the CPU port; then one bf16 scan iteration;
8. the cache-layout probe (probes/cache_layout.py): K/V store and attention
   in position-major against batch-major caches, and two row softmaxes,
   each checked against plain PyTorch and timed;
9. checkpoint, resume, export, evaluate: DCMLRunner at the recipe's full
   width and iteration (E = 8, T = 50, 15 x 4 minibatches; scan decode,
   f32, a checkpoint every episode): (a) two uninterrupted 3-episode runs
   from one seed, compared bit for bit (is the card deterministic?); (b) 2
   episodes, SIGTERM, the emergency checkpoint and exit 75, then
   resume="auto" for the last episode, which must equal the uninterrupted
   run (bit for bit where (a) found the card deterministic, else within
   (a)'s own spread), launches counted exactly; (c) step
   1 restored into a fresh runner, bit for bit, and a planted corrupt step
   quarantined; (d) the export served by DecodeEngine.from_export, equal to
   an engine on the in-memory weights and within 1e-4 of the CPU port; (e)
   DCMLRunner.evaluate, 100 steps, scan (one ar_decode launch a step and
   the warm-up) and stride 10, and act_stride card vs CPU; (f) the sweep
   (sweep_dcml) from the export on Sample_1, 2 settings x 100 steps at
   stride 10.  Its times print beside the card's name and power limit;
10. the rest of the DCML MAT family at that width and recipe, scan decode,
   f32: one iteration each of ``momat`` (MO-MAT, a two-objective critic),
   ``dmomat`` (preference weights appended to obs and share_obs) and
   ``mat_dec`` (MAT-Dec: an MLP actor, no decoder trunk, so no ar_decode
   launch), and one ``momat`` iteration with lr decay, weight decay 1e-4
   and ``mo_combined_norm`` false, each with launches counted exactly,
   finite per-objective records and one more update matched against the
   CPU port; a ``dmomat`` run stopped by SIGTERM after its first episode
   and resumed, equal to the uninterrupted 2-episode run (held as phase 9
   (b)); the ``dmomat`` export served at bucket 8, equal to the in-memory
   weights' engine bit for bit;
11. SMAC-lite (MAT's discrete family, availability masks from a live env):
   (a) the 8m recipe (scripts/train_smac.sh: 8 agents, obs 80, state 168,
   14 actions, n_embd 64, 2 blocks, 2 heads; E = 32, T = 100, 15 epochs x
   1 minibatch, lr 5e-4, clip 0.05), one cached and one scan iteration, each
   with its launches counted exactly and one more update matched against the
   CPU port, then one bf16 scan iteration (ar_decode's bf16 leg on live
   masks); (b) the three kernels against their plain versions at SMAC's
   shapes (attention at 3,200 / 3,600 rows x 2 heads and L 8 / 27, the
   rollout's 32 / 36 rows, ar_decode at B 32, A 8, adim 14 and B 36, A 27,
   adim 36 on the env's masks), timed beside plain, SDPA and their bounds;
   (c) SMACRunner.evaluate until 32 battles end; (d) 2 episodes against 1 +
   SIGTERM + resume 1, bit for bit where phase 9 (a) found the card
   deterministic; (e) the export served by DecodeEngine.from_export at
   bucket 8 on live masks, cached and scan, every action available, equal
   to the in-memory weights' engine; (f) SMACMultiRunner (the universal
   layout: 27 agents, 36 actions, obs 869, state 1754; E = 36, T = 100, 10
   epochs) one iteration on 3m and one on 8m with random agent order, then
   the held-out 2m evaluated; (g) the learning check of
   tests/test_smac.py::test_mat_improves_win_rate_on_2m (2m, E 32, T 40,
   n_embd 32, 1 block, 5 epochs, lr 5e-4, entropy 0.01, 30 iterations): the
   evaluated win rate after at least before and above 0.3;
12. the actor-critic family on DCML (feed-forward MLPs, no hand-written
   kernel) at the recipe (DCMLRunner defaults: E = 8, T = 50, 15 x 4
   minibatches, hidden 64, f32; 101 agents): (a) one iteration each of
   ``ppo`` (the joint view, one policy), ``mappo`` (one shared policy),
   ``ippo``, ``happo`` and ``hatrpo`` (one policy an agent; each HAPPO /
   HATRPO agent turn one CUDA graph replay), with finite records and the
   four kernels' launch counters reading 0 (``happo`` trains two episodes,
   the uninterrupted run of (b)), and one more update of ``ppo``, ``happo``
   and ``hatrpo`` at the recipe matched against the CPU port: ``ppo``'s
   whole update, weights within 0.01 lr x Adam steps and metrics rtol 1e-5
   or within 4x the update's own spread under a 1e-7 perturbation;
   ``happo``'s and ``hatrpo``'s turn by turn from the card's state, the
   median turn held so against the median turn's spread (HATRPO: the line
   search's acceptance equal in every turn), the first three turns also
   run eagerly on the card and equal to the captured graph's replay bit
   for bit (the constants' comment says why); (b) a ``happo`` run stopped by SIGTERM
   after its first episode and resumed, equal to (a)'s uninterrupted run
   (held as phase 9 (b)); (c) DCMLRunner.evaluate for 100 steps for ``ppo``
   and ``happo``.  Its times print beside the card's name and power limit.

The bf16 legs' readings are a JSON line ``{"bf16_legs": {...}}``, phase 9's
``{"checkpoint_phase": {...}}``, phase 10's ``{"mat_family_phase": {...}}``,
phase 11's ``{"smac_phase": {...}}``, phase 12's
``{"actor_critic_phase": {...}}``;
the last
two lines of standard output are a JSON object describing each kernel and
the result line ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import copy
import faulthandler
import json
import os
import subprocess
import sys
import threading
import time

BUDGET_S = 1100          # faulthandler ends a hung run with a traceback
SEED = 0
N_CLIENTS = 8
REQUESTS_PER_CLIENT = 12
BUCKETS = (1, 8, 32, 128)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
# the fastest unit that computes each function to its dtype's accuracy: f32
# through 3xTF32 on the tensor cores (three TF32 products for one f32
# product: 495 / 3 TFLOP/s), bf16 on the tensor cores, dense
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
# f32 outside the tensor cores: the peak of the decode kernels' bounds, whose
# f32 arithmetic runs there
F32_SIMT_FLOPS = 67e12
# bf16: both sides round P and the output to bf16, so a sound kernel may
# differ from plain by an ulp of the output (3.9e-3 below 1); a kernel that
# loses one of the 101 keys differs by far more (phase 2 prints that reading).
TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# backward, relative to the largest plain gradient: f32 summation order; bf16
# rounds dq, dk, dv (and P, dP where plain does) on both sides, and a sum of
# 101 terms in another order can move a bf16 result by an ulp, at most 2**-7
# of its size; a dropped key moves gradients by 24-92x that (phase 2 prints it)
BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
# the forward's row statistics (softmax max and sum) against the plain
# version's, relative to max(1, |plain|): f32 summation order only
STATS_TOL = 1e-5
LOGP_ATOL_VS_CPU = 1e-4
NEAR_TIE = 1e-5
# whole decode, kernel vs plain: log-probs (and the tail's action) within
# 1e-4, worker actions equal except past a near-tie (summation order)
AR_LOGP_TOL = 1e-4
AR_BATCHES = (1, 8, 128)               # timed
CHECK_BATCHES = (1, 3, 8, 9, 17, 128)  # checked: odd B leaves a cluster's rows part-filled
BF16_CHECK_BATCHES = (1, 8, 9, 128)    # the bf16 legs' (the main path's buckets, a part-filled one)
SHORT_AGENTS = (1, 2, 10)              # short decodes checked beside the 101 agents
WIDE_EMBD = 256                        # no cluster holds these weights: the device-memory path
# off the recipe's widths (n_embd 64, 2 heads): the generic on-chip kernel, at
# 2 rows a cluster (B 3) and 8 (B 40)
GENERIC_WIDTHS = ({"n_head": 4}, {"n_embd": 32})
GENERIC_BATCHES = (3, 40)
# recorded constants, printed beside this run's times and nowhere else: the
# times of the kernels' first design (one block a row, weights read through
# L2; device per call, graph replay, L2-warm, NVIDIA H100 80GB HBM3 at
# 700 W): ar_decode in ms; decode_step at MuJoCo 10x2, last position, in us
AR_EARLIER_MS = {1: 6.984, 8: 7.158, 128: 7.176}
STEP_EARLIER_US = {1: 56.44, 8: 58.23, 128: 57.58}
# decode step, kernel vs plain: logits (up to ~5 with O(1) weights) and
# caches; f32 summation order moves them by a few 1e-6
STEP_TOL = 2e-5
STEP_AGENTS = (10, 101)
# continuous served and trained: manyagent_ant 10x2 of multi-agent MuJoCo lite
MJ_SCENARIO, MJ_CONF = "manyagent_ant", "10x2"
CONT_ATOL_VS_CPU = 1e-4
# the bf16 legs (a bf16 trunk).  Kernel vs plain: both round to bf16 at the
# same points and sum in f32 in different orders, so a value near a bf16
# boundary may round the other way on one side and move what follows by a
# bf16 ulp (measured on an H100, B 1-128: log-probs and the tail's action <=
# 0.03, near-tie margins <= 0.013, logits <= 0.02, caches <= 0.031); a
# planted fault must read at least BF16_FAULT_FACTOR times the tolerance
BF16_AR_TOL = 0.05
BF16_FAULT_FACTOR = 5
BF16_NEAR_TIE = 5e-2
BF16_STEP_TOL = 5e-2
BF16_CACHE_TOL = 2.0**-4
# a decode step's row whose logits moved by more than BF16_MOVED counts as
# moved: a flip moves the row it happens in, so a sound kernel moves at most
# one row or BF16_MOVED_SHARE of them (measured: none at B <= 9 but one at
# n_embd 256, 2-3 of 128), a replaced key every row
BF16_MOVED = 1e-3
BF16_MOVED_SHARE = 0.1
# the card's bf16 engine vs the port's bf16 engine on the CPU (cuBLAS and
# the kernels against the CPU's sums: the flips above) and, within the JAX
# canary contract for a bf16 trunk (serving/rollout_ctl.py), vs its f32 one
BF16_LOGP_VS_CPU = 0.1
CANARY_RTOL, CANARY_ATOL, CANARY_GREEDY = 2e-2, 1e-3, 0.75
# one bf16 update card vs CPU: the JAX package's bound between two bf16
# attention paths (tests/test_update_attn_parity.py); the key projections'
# biases, whose exact gradient is 0, to 2 lr a step (Adam scales their
# rounding noise up to steps of lr)
BF16_UPDATE_RTOL, BF16_UPDATE_ATOL, BF16_VALUE_LOSS_RTOL = 5e-3, 5e-4, 1e-2

# training phase: the recipe (RunConfig / PPOConfig defaults); one cached
# f32 iteration (two before the bf16 phases joined, to keep the run's time)
TRAIN_ITERS = 1
# the attention kernels past a grid's y limit of 65,535 blocks: 35,000 rows
# x 2 heads (phase 2).  At SMAC's short rows (L 8, 27: phases 2 and 11) an
# output is an average of few values and reaches 2-4, where a bf16 ulp is
# 2^-7 of it: the forward is held to TOL x max(1, the largest |plain|), as
# the backward is to the largest gradient
LARGE_N_ROWS = 35_000
# card vs CPU after one full update: Adam moves an entry by at most lr per
# step, and a gradient near 0 can move it by a different amount on each
# side, so the bound is a hundredth of the most an entry can move; metrics
# to rtol 1e-4 with atol 1e-6 (the policy loss is a mean of unit-scale
# advantages that cancels to near 0)
UPDATE_TOL_FRACTION = 0.01
METRIC_RTOL = 1e-4
# SMAC (phase 11): the 8m recipe (scripts/train_smac.sh: E 32, T 100, 15
# epochs x 1 minibatch, lr 5e-4, clip 0.05) and the multi-map one
# (scripts/train_smac_multi.sh: E 36, 10 epochs); the 2m learning check of
# tests/test_smac.py (30 iterations)
SMAC_E, MULTI_E, SMAC_T = 32, 36, 100
LEARN_ITERS = 30
# checkpoint, resume, export, evaluate (phase 9): the recipe's iterations,
# 3 episodes a run; where the card is not bit-deterministic, the resumed run
# may differ from the uninterrupted one by no more than two uninterrupted
# runs differ from each other
RESUME_EPISODES = 3
EVAL_STEPS = 100
# the actor-critic family (phase 12): the recipe's width, iteration and
# update (15 epochs x 4 minibatches).  The card's update is matched against
# the CPU port's from copies of its state: weights within 0.01 lr x Adam
# steps (as phase 5); metrics rtol 1e-5 (update_ratio 1e-2, a quotient of
# steps each side rounds to its weights' ulp, as phase 5), or, where the
# update amplifies rounding past that (Adam's normalised steps and the
# clipped losses' kinks over 60 steps), within AC_SPREAD_FACTOR times how
# far the same update on the card moves from a AC_PERTURBATION relative
# perturbation of its weights: the update's own spread.  HAPPO's and
# HATRPO's factor compounds over the 101 agents (HATRPO's reaches 1e13, as
# in JAX: tests/hatrpo_factor_probe.py), so they are matched turn by turn,
# each turn from the card's state and with the card's factor and targets,
# and the 101 turns are held by their median: the median turn's deviation
# within those bounds (HATRPO's actor, which takes no Adam step, rtol 1e-4
# of its step), against the median turn's spread (the larger of
# AC_SPREAD_SAMPLES perturbations).  A port fault moves every turn; one
# turn alone can part further, as this check measured on an H100 (a
# HAPPO turn's actor by 2.5 lr, its factor by 3.6e-5 relative): an Adam
# entry whose near-0 gradient changes sign with the rounding moves by up to
# 2 lr a step, and a perturbation of the starting weights need not flip the
# same entries.  Each turn's largest deviation is printed; HATRPO's
# line-search acceptance is equal in every turn, its critic (4 Adam steps)
# within the bound in every turn.  The first AC_EAGER_TURNS turns also run
# eagerly on the card and equal the captured graph's replay bit for bit.
AC_ALGOS = ("ppo", "mappo", "ippo", "happo", "hatrpo")
AC_MATCHED = ("ppo", "happo", "hatrpo")
AC_EVALUATED = ("ppo", "happo")
AC_METRIC_RTOL = 1e-5
AC_PERTURBATION = 1e-7
AC_SPREAD_FACTOR = 4.0
AC_SPREAD_SAMPLES = 2
AC_EAGER_TURNS = 3
EVAL_STRIDE = 10
SWEEP_SETTINGS = 2
SWEEP_STEPS = 100


def say(msg: str) -> None:
    print(msg, flush=True)


def _sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def phase0_environment(torch):
    card = _sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
    say(f"[phase 0] card: {card}")
    header = [line for line in _sh(["nvidia-smi"]).splitlines() if "CUDA Version" in line]
    say(f"[phase 0] nvidia-smi: {header[0].strip(' |') if header else 'no version line'}")
    from mat_dcml_tpu_torch.ops import kernel_lib

    nvcc = _sh([kernel_lib.nvcc_path(), "--version"]).splitlines()[-1]
    say(f"[phase 0] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, nvcc: {nvcc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[phase 0] allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}; devices {torch.cuda.device_count()}")
    return card


def phase1_build():
    from mat_dcml_tpu_torch.ops import kernel_lib

    t0 = time.perf_counter()
    for name, log in kernel_lib.build_all().items():
        state = "cached" if log is None else "built"
        say(f"[phase 1] {name}: {state} -> {kernel_lib.library_path(name).name}")
        for line in (log or "").splitlines():
            if "registers" in line or "spill" in line or line.endswith("s"):
                say(f"[phase 1]   {line.strip()}")
    say(f"[phase 1] build {time.perf_counter() - t0:.2f}s (one nvcc per source, in parallel)")


def _time_ms(torch, fn, iters=200):
    """Per-call time of ``fn`` on the card, after warm-up: ``(device, eager)``.
    ``device`` replays ``iters`` calls captured in one CUDA graph, so the
    host's launch cost (Python, ctypes, the autograd engine) is left out;
    ``eager`` launches them from Python, so it is in.  Inputs stay in L2
    (warm) in both."""
    for _ in range(min(10, iters)):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / iters
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, eager


def _roof(nbytes, flops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bound(q, k, mask, dtype_name, causal=False, peak=None):
    """Least time for the function on this card: bytes each input is read
    and each output written once (keys a row's mask excludes need not be
    read), against flops for q.k and p.v over those keys (under causal, the
    (query, key) pairs on and below the diagonal), at ``peak`` (default
    PEAK_FLOPS of the dtype)."""
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    item = q.element_size()
    if mask is None:
        keys = B * H * Lk
    elif mask.dim() == 1:
        keys = B * H * int(mask.sum())
    else:
        keys = H * int(mask.sum())
    nbytes = 2 * B * H * Lq * Dh * item + 2 * keys * Dh * item
    nbytes += 0 if mask is None else mask.numel()
    pairs = Lq * keys if not causal else B * H * Lq * (Lq + 1) // 2
    flops = 2 * 2 * pairs * Dh
    return _roof(nbytes, flops, peak or PEAK_FLOPS[dtype_name])


def phase2_kernels(torch):
    """attention_fwd against the plain version in both dtypes at the
    serving and training shapes, with a planted fault the tolerance must
    catch; returns ``{(case, dtype): max error}``."""
    from mat_dcml_tpu_torch.ops import cuda_attention as ca

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    N_B, H, A, Dh = 128, 2, 101, 32

    def qkv(B, lq, lk, dtype):
        return [torch.randn(B, H, n, Dh, generator=g, device=dev).to(dtype) for n in (lq, lk, lk)]

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        cases = [("encoder", N_B, A, False, None)]
        cases += [(f"decode_i{i}", N_B, 1, False, torch.arange(A, device=dev) <= i) for i in (0, 50, 100)]
        cases += [("causal", 8, A, True, None),
                  ("per_batch_mask", 8, 1, False, torch.rand(8, A, generator=g, device=dev) > 0.4),
                  ("per_batch_mask_causal", 8, A, True, torch.rand(8, A, generator=g, device=dev) > 0.4)]
        # the decode at buckets 32 and 1 (one block a row from 64 rows up,
        # clusters of 4 below), with the cached decode's mask and a per-batch one
        for b in (32, 1):
            cases += [(f"decode_b{b}_i50", b, 1, False, torch.arange(A, device=dev) <= 50),
                      (f"decode_b{b}_per_batch_mask", b, 1, False,
                       torch.rand(b, A, generator=g, device=dev) > 0.4)]
        for label, B, lq, causal, mask in cases:
            q, k, v = qkv(B, lq, A, dtype)
            out = ca.fused_masked_attention(q, k, v, causal=causal, kv_mask=mask)
            torch.cuda.synchronize()
            ref = ca.attention_plain(q, k, v, causal=causal, kv_mask=mask)
            err = (out.float() - ref.float()).abs().max().item()
            errs[(label, name)] = err
            say(f"[phase 2] {label} {name} max|kernel - plain| = {err:.3g} (tol {TOL[name]})")
            if not err <= TOL[name]:
                raise AssertionError(f"attention_fwd {label} {name}: error {err} > {TOL[name]}")
        # what the check must catch: plain attention that drops the last key
        q, k, v = qkv(N_B, A, A, dtype)
        fault = (ca.attention_plain(q, k, v, kv_mask=torch.arange(A, device=dev) < A - 1).float()
                 - ca.attention_plain(q, k, v).float()).abs().max().item()
        say(f"[phase 2] planted fault (one key dropped, encoder) {name}: max|diff| = {fault:.3g}")
        if not fault > TOL[name]:
            raise AssertionError(f"tolerance {TOL[name]} would pass a dropped key ({fault})")

    torch.cuda.synchronize()
    return errs


def _bwd_bound(q, causal, dtype_name, peak=None):
    """Least time for the backward on this card: q, k, v, dO read and dq,
    dk, dv written once, against 10 flops per (query, key, dim) triple the
    causal mask leaves live (five products of Lq x Lk x Dh multiply-adds),
    at ``peak`` (default PEAK_FLOPS of the dtype)."""
    B, H, L, Dh = q.shape
    nbytes = 7 * B * H * L * Dh * q.element_size()
    pairs = L * (L + 1) // 2 if causal else L * L
    flops = 10 * B * H * pairs * Dh
    return _roof(nbytes, flops, peak or PEAK_FLOPS[dtype_name])


def phase2_backward(torch):
    """attention_bwd against autograd through the plain forward at the PPO
    update's shapes (minibatch 100 rows x 2 heads, L = 101, Dh = 32), alone
    and fed the forward's row statistics as the main path feeds it."""
    from mat_dcml_tpu_torch.ops import cuda_attention as ca

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    B, H, L, Dh = 100, 2, 101, 32
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for label, causal in (("encoder", False), ("decoder_causal", True)):
            q, k, v, do = (torch.randn(B, H, L, Dh, generator=g, device=dev).to(dtype)
                           for _ in range(4))
            grads = ca.attention_bwd(q, k, v, do, causal=causal)
            torch.cuda.synchronize()
            refs = ca.attention_bwd_plain(q, k, v, do, causal=causal)
            scale = max(1.0, max(r.float().abs().max().item() for r in refs))
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(grads, refs))
            errs[(label, name)] = err
            say(f"[phase 2] bwd {label} {name} {tuple(q.shape)} max|kernel - plain| = {err:.3g} "
                f"(tol {BWD_TOL[name]} x {scale:.3g})")
            if not err <= BWD_TOL[name] * scale:
                raise AssertionError(f"attention_bwd {label} {name}: error {err} > "
                                     f"{BWD_TOL[name]} x {scale}")
            # what the check must catch: the plain gradient with the middle key
            # dropped (the last key would touch only the last causal row)
            drop = torch.arange(L, device=dev) != L // 2
            faulty = ca.attention_bwd_plain(q, k, v, do, causal=causal, kv_mask=drop)
            fault = max((a.float() - b.float()).abs().max().item() for a, b in zip(faulty, refs))
            say(f"[phase 2] bwd planted fault (key {L // 2} dropped, {label}) {name}: "
                f"max|diff| = {fault:.3g}")
            if not fault > BWD_TOL[name] * scale:
                raise AssertionError(f"backward tolerance would pass a dropped key ({fault})")
            # the main path's call: the forward's row statistics fed to the
            # backward, which must give what it gives finding them itself
            stats = torch.empty(2, B * H, L, device=dev)
            ca.attention_fwd(q, k, v, causal=causal, stats=stats)
            ref_stats = ca.attention_stats_plain(q, k, causal=causal)
            serr = ((stats - ref_stats).abs() / ref_stats.abs().clamp(min=1.0)).max().item()
            fed = ca.attention_bwd(q, k, v, do, causal=causal, stats=stats)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(fed, grads))
            errs[(label + "_stats", name)] = serr
            say(f"[phase 2] bwd {label} {name}: forward's row statistics vs plain, relative "
                f"{serr:.3g} (tol {STATS_TOL}); backward fed them equal to the backward finding "
                f"them itself: {same}")
            if not (serr <= STATS_TOL and same):
                raise AssertionError(f"row statistics {label} {name}: error {serr}, equal {same}")
    torch.cuda.synchronize()
    return errs


def phase2_large_n(torch):
    """Both attention kernels past the 65,535 blocks a grid's y axis allows
    (the forward once put N there): N = B * H = 70,000 rows (35,000 x 2
    heads, L 8, Dh 32), f32 and bf16, all keys and causal, against plain
    with phase 2's tolerances.  Returns ``{(label, dtype): (fwd err, bwd
    err)}``."""
    from mat_dcml_tpu_torch.ops import cuda_attention as ca

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    B, H, L, Dh = LARGE_N_ROWS, 2, 8, 32
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for causal in (False, True):
            label = f"N {B * H} ({B} x {H} heads, L {L}), {'causal' if causal else 'all keys'}"
            q, k, v, do = (torch.randn(B, H, L, Dh, generator=g, device=dev).to(dtype)
                           for _ in range(4))
            out = ca.fused_masked_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            ref = ca.attention_plain(q, k, v, causal=causal).float()
            err = (out.float() - ref).abs().max().item()
            fscale = max(1.0, ref.abs().max().item())
            grads = ca.attention_bwd(q, k, v, do, causal=causal)
            torch.cuda.synchronize()
            refs = ca.attention_bwd_plain(q, k, v, do, causal=causal)
            scale = max(1.0, max(r.float().abs().max().item() for r in refs))
            berr = max((a.float() - b.float()).abs().max().item() for a, b in zip(grads, refs))
            errs[(label, name)] = (err, berr)
            say(f"[phase 2] grid: {label} {name}: forward max|kernel - plain| {err:.3g} (tol "
                f"{TOL[name]} x {fscale:.3g}), backward {berr:.3g} (tol {BWD_TOL[name]} x "
                f"{scale:.3g})")
            if not (err <= TOL[name] * fscale and berr <= BWD_TOL[name] * scale):
                raise AssertionError(f"attention at {label} {name}: forward {err}, backward "
                                     f"{berr}")
            del q, k, v, do, out, ref, grads, refs
    torch.cuda.synchronize()
    return errs


def _agree(act, logp, ref_act, ref_logp, scores, nd, tol, what, near_tie=NEAR_TIE):
    """One decode against a reference, numpy ``(B, A)`` each and ``scores (B,
    A, adim)`` the reference's masked logits (plus noise) per position.  Row
    by row: worker actions equal up to the first difference, which is allowed
    only where the top-2 score margin is below ``near_tie`` (a near-tie that
    summation order may break); log-probs within ``tol`` before it, and the
    tail's action too where the row never diverged.  Returns ``(worst
    log-prob error, rows diverging at a near-tie)``; raises otherwise."""
    import numpy as np

    worst, flips = 0.0, 0
    for b in range(act.shape[0]):
        diff = np.flatnonzero(act[b, :nd] != ref_act[b, :nd])
        end = act.shape[1] if diff.size == 0 else int(diff[0])
        if diff.size:
            top2 = np.sort(scores[b, end])[-2:]
            if not top2[1] - top2[0] < near_tie:
                raise AssertionError(f"{what}, row {b}: actions differ at agent {end}, "
                                     f"margin {top2[1] - top2[0]:.3g}")
            flips += 1
        elif not np.allclose(act[b, nd:], ref_act[b, nd:], rtol=0.0, atol=tol):
            raise AssertionError(f"{what}, row {b}: the tail's action differs")
        err = float(np.abs(logp[b, :end] - ref_logp[b, :end]).max()) if end else 0.0
        worst = max(worst, err)
    if not worst <= tol:
        raise AssertionError(f"{what}: log-prob differs by {worst} > {tol}")
    return worst, flips


def _scaled_model(torch, cfg, seed):
    """The DCML MAT on the card with every weight redrawn at O(1) scale: the
    reference init's 0.01-gain heads give logits near 0, where near-ties
    would hide most of the decode from a kernel check."""
    from mat_dcml_tpu_torch.models.mat import MultiAgentTransformer

    model = MultiAgentTransformer(cfg, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=g)
            if p.dim() == 2:
                p.copy_(z / p.shape[1] ** 0.5)
            elif name.endswith("weight"):          # LayerNorm scale
                p.copy_(1.0 + 0.1 * z)
            else:
                p.copy_(0.1 * z)
    return model.to("cuda").eval()


def _weight_bytes(weights):
    return sum(t.numel() * t.element_size() for t in weights)


def _ar_bound(cfg, weights, B, has_avail):
    """Least time for the whole decode on this card: per row, ten D x D
    products a block and position, the head, and the attentions over the
    keys seen so far (no early exit: every run does all of it), against the
    weights read once plus obs_rep (of the trunk's dtype), noise, avail and
    the two outputs; f32 operations outside the tensor cores, bf16 ones on
    them.  It ignores that the 101 positions run one after another."""
    A, D, nb, adim = cfg.n_agent, cfg.n_embd, cfg.n_block, cfg.action_dim
    es = 2 if cfg.dtype == "bfloat16" else 4
    flops = B * (2 * A * (nb * 10 * D * D + D * D + D * adim) + 8 * nb * D * A * (A + 1) // 2)
    n_rows = max(1, A - cfg.n_discrete_agents)
    nbytes = (_weight_bytes(weights) + B * es * A * D
              + 4 * B * (A * adim + n_rows * adim + (A * adim if has_avail else 0) + 2 * A))
    return _roof(nbytes, flops, PEAK_FLOPS["bfloat16"] if es == 2 else F32_SIMT_FLOPS)


def _plan_words(plan):
    """A decode launch's plan in words: path, rows a cluster, kernel."""
    path = "on chip" if plan.on_chip else "device memory"
    kernel = "recipe's kernel" if plan.recipe else "generic kernel"
    return f"{path}, {plan.rows} rows a cluster, {kernel}"


def phase2_ar_decode(torch):
    """ar_decode against its plain twin at full DCML width (B 1-128, noise on
    and off, avail masked and None), on short decodes and on the
    device-memory path (n_embd 256), a planted fault, and the kernel's, the
    plain twin's and the cached decode's times beside the earlier kernel's."""
    import dataclasses

    from mat_dcml_tpu_torch.models.decode import cached_decode
    from mat_dcml_tpu_torch.ops import ar_decode as ard
    from mat_dcml_tpu_torch.ops.distributions import gumbel_noise

    dev = torch.device("cuda")
    base = _dcml_config()
    g = torch.Generator(device=dev).manual_seed(SEED + 4)

    def inputs(cfg, B, noise, masked):
        A, adim = cfg.n_agent, cfg.action_dim
        rep = torch.randn(B, A, cfg.n_embd, generator=g, device=dev)
        zeros = torch.zeros(B, A, adim, device=dev)
        gumbel = gumbel_noise((B, A, adim), g, dev) if noise else zeros
        normal = torch.randn(B, 1, adim, generator=g, device=dev) * float(noise)
        avail = None
        if masked:
            avail = (torch.rand(B, A, adim, generator=g, device=dev) > 0.2).float()
            avail[..., 0] = 1.0
        return rep, gumbel, normal, avail

    def to_np(*ts):
        return [t.cpu().numpy() for t in ts]

    def plan_of(cfg, B):
        return ard.kernel_plan(B, cfg.n_agent, n_embd=cfg.n_embd, n_head=cfg.n_head,
                               n_block=cfg.n_block, adim=cfg.action_dim)

    worst, shapes = 0.0, {}
    cases = [(base, B, noise, masked) for B in CHECK_BATCHES for noise in (False, True)
             for masked in (True, False)]
    cases += [(dataclasses.replace(base, n_agent=A), B, True, masked) for A in SHORT_AGENTS
              for B in (3, 9) for masked in (True, False)]
    cases += [(dataclasses.replace(base, n_embd=WIDE_EMBD), B, noise, True) for B in (1, 9, 17)
              for noise in (False, True)]
    cases += [(dataclasses.replace(base, **width), B, True, True) for width in GENERIC_WIDTHS
              for B in GENERIC_BATCHES]
    models = {}
    with torch.no_grad():
        for cfg, B, noise, masked in cases:
            key = (cfg.n_embd, cfg.n_head)
            if key not in models:
                models[key] = ard.pack_ar_decode_weights(_scaled_model(torch, cfg, SEED + 3))
            weights = models[key]
            kw = dict(n_head=cfg.n_head, adim=cfg.action_dim, nd=cfg.n_discrete_agents)
            x = inputs(cfg, B, noise, masked)
            act, logp = ard.fused_ar_decode(weights, *x, **kw)
            torch.cuda.synchronize()
            ref = ard.ar_decode_plain(weights, *x, return_scores=True, **kw)
            plan = plan_of(cfg, B)
            label = (f"A {cfg.n_agent} n_embd {cfg.n_embd} heads {cfg.n_head} B {B} "
                     f"{'noise' if noise else 'deterministic'} "
                     f"avail {'masked' if masked else 'None'} ({_plan_words(plan)})")
            err, flips = _agree(*to_np(act, logp, *ref), cfg.n_discrete_agents, AR_LOGP_TOL,
                                f"ar_decode {label}")
            worst = max(worst, err)
            say(f"[phase 2] ar_decode {label}: max|logp kernel - plain| {err:.3g} "
                f"(tol {AR_LOGP_TOL}), rows diverging at a near-tie {flips}")
        cfg = base
        A, D, adim, nd = cfg.n_agent, cfg.n_embd, cfg.action_dim, cfg.n_discrete_agents
        kw = dict(n_head=cfg.n_head, adim=adim, nd=nd)
        model = _scaled_model(torch, cfg, SEED + 3)
        weights = models[(D, cfg.n_head)]
        # what the check must catch: the plain twin fed agent 50's rep replaced
        # by agent 49's
        x = inputs(cfg, 8, True, True)
        ref_act, ref_logp = ard.ar_decode_plain(weights, *x, **kw)
        rep_f = x[0].clone()
        rep_f[:, 50] = x[0][:, 49]
        f_act, f_logp = ard.ar_decode_plain(weights, rep_f, *x[1:], **kw)
        fault = (f_logp - ref_logp).abs().max().item()
        moved = int((f_act[:, :nd] != ref_act[:, :nd]).sum())
        say(f"[phase 2] ar_decode planted fault (agent 50's rep replaced, B 8): max|logp diff| "
            f"{fault:.3g} (tol {AR_LOGP_TOL}), worker actions changed {moved}")
        if not fault >= 10 * AR_LOGP_TOL:
            raise AssertionError(f"ar_decode tolerance would pass a replaced rep row ({fault})")

        for B in AR_BATCHES:
            rep, gumbel, normal, avail = inputs(cfg, B, True, True)
            tail = torch.zeros(A, B, adim, device=dev)
            tail[nd:] = normal.transpose(0, 1)
            ms, eager_ms = _time_ms(
                torch, lambda: ard.fused_ar_decode(weights, rep, gumbel, normal, avail, **kw),
                iters=20)
            plain_ms, plain_eager_ms = _time_ms(
                torch, lambda: ard.ar_decode_plain(weights, rep, gumbel, normal, avail, **kw),
                iters=2)
            cached_ms, cached_eager_ms = _time_ms(
                torch, lambda: cached_decode(model, rep, avail, False, gumbel=gumbel,
                                             tail_noise=tail), iters=2)
            bound_ms, bound_by = _ar_bound(cfg, weights, B, True)
            plan = plan_of(cfg, B)
            shapes[B] = {"shape": f"obs_rep ({B}, {A}, {D}) f32, noise, avail masked",
                         "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                         "plain_eager_ms": plain_eager_ms, "cached_decode_ms": cached_ms,
                         "cached_decode_eager_ms": cached_eager_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by}
            say(f"[phase 2] time ar_decode B {B}, device (eager) per call: kernel {ms:.3f} "
                f"({eager_ms:.3f}) ms, earlier design {AR_EARLIER_MS[B]:.3f} ms (a recorded "
                f"constant; {AR_EARLIER_MS[B] / ms:.2f}x), plain {plain_ms:.2f} ({plain_eager_ms:.2f}) ms, "
                f"cached decode {cached_ms:.2f} ({cached_eager_ms:.2f}) ms, bound "
                f"{bound_ms * 1e3:.2f} us ({bound_by}); {plan.clusters} clusters of "
                f"{plan.cluster} CTAs, {_plan_words(plan)}, {plan.smem_bytes} B shared "
                f"memory a CTA, {plan.barriers} cluster barriers a position; L2-warm")
    torch.cuda.synchronize()
    return worst, shapes


def _mj_config(action_type="continuous", n_agent=None):
    """MAT at the width of multi-agent MuJoCo lite's manyagent_ant 10x2, or
    ``n_agent`` agents of it."""
    from mat_dcml_tpu_torch.envs.mamujoco.lite import MJLiteConfig, MJLiteEnv
    from mat_dcml_tpu_torch.models.mat import MATConfig

    env = MJLiteEnv(MJLiteConfig(scenario=MJ_SCENARIO, agent_conf=MJ_CONF), device="cpu")
    return MATConfig(n_agent=n_agent or env.n_agents, obs_dim=env.obs_dim,
                     state_dim=env.share_obs_dim, action_dim=env.action_dim, n_block=2,
                     n_embd=64, n_head=2, action_type=action_type)


def _step_bound(cfg, weights, B, i):
    """Least time for one decode position on this card: the weights read
    once, per row x_in, rep, the cached K/V of positions 0 .. i - 1 read and
    position i's written (of the trunk's dtype), and the logits; against per
    row 2 (in_dim D + 10 n_block D^2 + D^2 + D adim) flops of products and 8
    n_block D (i + 1) of attention (f32 outside the tensor cores, bf16 on
    them)."""
    D, nb, adim, in_dim = cfg.n_embd, cfg.n_block, cfg.action_dim, cfg.action_input_dim
    es = 2 if cfg.dtype == "bfloat16" else 4
    nbytes = _weight_bytes(weights) + B * (es * (in_dim + D + 4 * nb * D * (i + 1)) + 4 * adim)
    flops = B * (2 * (in_dim * D + 10 * nb * D * D + D * D + D * adim) + 8 * nb * D * (i + 1))
    return _roof(nbytes, flops, PEAK_FLOPS["bfloat16"] if es == 2 else F32_SIMT_FLOPS)


def phase2_decode_step(torch):
    """decode_step against its plain twin for both continuous families at the
    MuJoCo width (A = 10) and at 101 agents (B 1-128), on position-major
    caches, on short decodes and on the device-memory path (n_embd 256), a
    planted fault, and the kernel's, the plain twin's and the cached decode
    step's times beside the earlier kernel's; beside them a whole continuous
    decode's time, scan (A launches) and cached."""
    import dataclasses

    from mat_dcml_tpu_torch.models.decode import ar_decode, cached_decode
    from mat_dcml_tpu_torch.ops import decode_step as dst

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    worst, shapes = 0.0, {}

    def plan_of(cfg, B):
        return dst.kernel_plan(B, cfg.n_agent, cfg.action_input_dim, n_embd=cfg.n_embd,
                               n_head=cfg.n_head, n_block=cfg.n_block, adim=cfg.action_dim)

    cases = [(_mj_config(family, A), B, i, False) for family in
             ("continuous", "available_continuous") for A in STEP_AGENTS for B in CHECK_BATCHES
             for i in (0, A // 2, A - 1)]
    cases += [(dataclasses.replace(_mj_config("continuous", A), n_embd=embd), B, A - 1, pm)
              for embd in (64, WIDE_EMBD) for pm in (False, True) for A in SHORT_AGENTS
              for B in (3, 9)]
    cases += [(dataclasses.replace(_mj_config(), **width), B, 9, False)
              for width in GENERIC_WIDTHS for B in GENERIC_BATCHES]
    models = {}
    with torch.no_grad():
        for cfg, B, i, position_major in cases:
            A, D, nb, adim = cfg.n_agent, cfg.n_embd, cfg.n_block, cfg.action_dim
            key = (cfg.action_type, A, D, cfg.n_head)
            if key not in models:
                models[key] = dst.pack_decode_weights(_scaled_model(torch, cfg, SEED + 6))
            weights = models[key]
            if position_major:
                caches = torch.empty(4 * nb, A, B, D, device=dev)
            else:
                caches = dst.decode_caches(nb, A, B, D, dev)
            caches.copy_(torch.randn(caches.shape, generator=g, device=dev))
            x_in = torch.randn(B, cfg.action_input_dim, generator=g, device=dev)
            rep = torch.randn(B, A, D, generator=g, device=dev)
            mine, ref = caches.clone(), caches.clone()
            out = dst.fused_decode_step(weights, x_in, rep[:, i], mine, i, n_head=cfg.n_head,
                                        adim=adim)
            torch.cuda.synchronize()
            want = dst.decode_step_plain(weights, x_in, rep[:, i], ref, i, n_head=cfg.n_head,
                                         adim=adim)
            err = max((out - want).abs().max().item(), (mine - ref).abs().max().item())
            worst = max(worst, err)
            plan = plan_of(cfg, B)
            label = (f"{cfg.action_type} A {A} n_embd {D} heads {cfg.n_head} B {B} i {i} "
                     f"{'position' if position_major else 'batch'}-major caches "
                     f"({_plan_words(plan)})")
            say(f"[phase 2] decode_step {label}: max|kernel - plain| over logits and {4 * nb} "
                f"caches {err:.3g} (tol {STEP_TOL})")
            if not err <= STEP_TOL:
                raise AssertionError(f"decode_step {label}: error {err} > {STEP_TOL}")
        # what the check must catch: the plain twin with the self-attention
        # key of agent mid replaced by the one before it (A = 10, B = 8, last)
        cfg = _mj_config()
        D, nb, A, adim = cfg.n_embd, cfg.n_block, cfg.n_agent, cfg.action_dim
        model = _scaled_model(torch, cfg, SEED + 6)
        weights = dst.pack_decode_weights(model)
        kw = dict(n_head=cfg.n_head, adim=adim)
        caches = dst.decode_caches(nb, A, 8, D, dev)
        caches.copy_(torch.randn(caches.shape, generator=g, device=dev))
        x_in = torch.randn(8, cfg.action_input_dim, generator=g, device=dev)
        rep = torch.randn(8, A, D, generator=g, device=dev)
        faulty = caches.clone()
        faulty[0, A // 2] = caches[0, A // 2 - 1]
        ref = dst.decode_step_plain(weights, x_in, rep[:, A - 1], caches.clone(), A - 1, **kw)
        bad = dst.decode_step_plain(weights, x_in, rep[:, A - 1], faulty, A - 1, **kw)
        fault = (bad - ref).abs().max().item()
        say(f"[phase 2] decode_step planted fault (agent {A // 2}'s cached key replaced, B 8): "
            f"max|logits diff| {fault:.3g} (tol {STEP_TOL})")
        if not fault >= 10 * STEP_TOL:
            raise AssertionError(f"decode_step tolerance would pass a replaced key ({fault})")

        # times at the served and trained shape: A = 10, the last position
        i = A - 1
        valid = torch.arange(A, device=dev) <= i
        for B in AR_BATCHES:
            caches = dst.decode_caches(nb, A, B, D, dev)
            caches.copy_(torch.randn(caches.shape, generator=g, device=dev))
            x_in = torch.randn(B, cfg.action_input_dim, generator=g, device=dev)
            rep = torch.randn(B, A, D, generator=g, device=dev)
            ms, eager_ms = _time_ms(torch, lambda: dst.fused_decode_step(
                weights, x_in, rep[:, i], caches, i, **kw))
            plain_ms, plain_eager_ms = _time_ms(torch, lambda: dst.decode_step_plain(
                weights, x_in, rep[:, i], caches, i, **kw), iters=20)
            kv = model.fresh_packed_cache(B)
            q2 = model.decode_queries(rep)
            ms_cached, cached_eager_ms = _time_ms(torch, lambda: model.decode_step_cached(
                x_in[:, None], rep[:, i:i + 1], q2[:, :, :, i:i + 1], kv, i, valid), iters=20)
            bound_ms, bound_by = _step_bound(cfg, weights, B, i)
            plan = plan_of(cfg, B)
            # a whole stochastic decode of the A positions: A launches and the
            # sampling between them (scan), against the cached decode
            tail = torch.randn(A, B, adim, generator=g, device=dev)
            dec_ms, dec_eager_ms = _time_ms(torch, lambda: ar_decode(
                model, rep, None, False, tail_noise=tail), iters=20)
            cdec_ms, cdec_eager_ms = _time_ms(torch, lambda: cached_decode(
                model, rep, None, False, tail_noise=tail), iters=5)
            shapes[B] = {"shape": f"B {B}, A {A}, D {D}, in_dim {cfg.action_input_dim}, adim "
                                  f"{adim}, position {i}, f32",
                         "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                         "plain_eager_ms": plain_eager_ms, "cached_step_ms": ms_cached,
                         "cached_step_eager_ms": cached_eager_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "scan_decode_ms": dec_ms,
                         "scan_decode_eager_ms": dec_eager_ms, "cached_decode_ms": cdec_ms,
                         "cached_decode_eager_ms": cdec_eager_ms}
            say(f"[phase 2] time decode_step B {B} A {A} i {i}, device (eager) per call: kernel "
                f"{ms * 1e3:.2f} ({eager_ms * 1e3:.2f}) us, earlier design "
                f"{STEP_EARLIER_US[B]:.2f} us (a recorded constant; "
                f"{STEP_EARLIER_US[B] / (ms * 1e3):.2f}x), plain {plain_ms * 1e3:.2f} "
                f"({plain_eager_ms * 1e3:.2f}) us, cached decode step {ms_cached * 1e3:.2f} "
                f"({cached_eager_ms * 1e3:.2f}) us, bound {bound_ms * 1e3:.3f} us ({bound_by}); "
                f"{plan.clusters} clusters of {plan.cluster} CTAs, {_plan_words(plan)}, "
                f"{plan.smem_bytes} B shared memory a CTA, {plan.barriers} cluster barriers a "
                f"launch; L2-warm")
            say(f"[phase 2] time whole continuous decode B {B} A {A}, device (eager) per call: "
                f"scan {dec_ms:.3f} ({dec_eager_ms:.3f}) ms, cached {cdec_ms:.3f} "
                f"({cdec_eager_ms:.3f}) ms")
    torch.cuda.synchronize()
    return worst, shapes


def _ratios(ms, lib_ms, bound_ms):
    return {"vs_library": ms / lib_ms if lib_ms > 0 else None, "vs_bound": ms / bound_ms}


def phase2_attention_times(torch):
    """Both attention kernels timed in both dtypes at the main path's shapes:
    DCML's (the encoder at bucket 128 and at the rollout's batch, the
    update's causal decoder, the cached decode step at buckets 128, 32 and
    8) and SMAC's (phase 11's: the update's 3,200 and 3,600 rows x 2 heads
    at L 8 and 27, the rollout's, the cached decode), each beside its plain
    version, SDPA in the same dtype and its bound, with kernel / SDPA and
    kernel / bound.  The bf16 backward is timed as the main path calls it,
    fed the forward's row statistics.  Returns ``{dtype: (forward rows,
    backward rows)}``, rows by label."""
    import torch.nn.functional as F

    from mat_dcml_tpu_torch.ops import cuda_attention as ca

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    H, A, Dh = 2, 101, 32
    keys = lambda n, i: torch.arange(n, device=dev) <= i   # noqa: E731
    fwd_cases = (("encoder", 128, A, A, False, None), ("encoder_b8", 8, A, A, False, None),
                 ("update_causal", 100, A, A, True, None),
                 ("decode", 128, 1, A, False, keys(A, A - 1)),
                 ("decode_b32", 32, 1, A, False, keys(A, 50)),
                 ("decode_b8", 8, 1, A, False, keys(A, 50)),
                 ("8m_update", SMAC_E * SMAC_T, 8, 8, False, None),
                 ("8m_update_causal", SMAC_E * SMAC_T, 8, 8, True, None),
                 ("8m_rollout", SMAC_E, 8, 8, False, None),
                 ("8m_decode_i3", SMAC_E, 1, 8, False, keys(8, 3)),
                 ("multi_update", MULTI_E * SMAC_T, 27, 27, False, None),
                 ("multi_update_causal", MULTI_E * SMAC_T, 27, 27, True, None),
                 ("multi_rollout", MULTI_E, 27, 27, False, None),
                 ("multi_decode_i13", MULTI_E, 1, 27, False, keys(27, 13)))
    bwd_cases = (("encoder", 100, A, False), ("decoder_causal", 100, A, True),
                 ("8m_update", SMAC_E * SMAC_T, 8, False),
                 ("8m_update_causal", SMAC_E * SMAC_T, 8, True), ("8m_rollout", SMAC_E, 8, False),
                 ("multi_update", MULTI_E * SMAC_T, 27, False),
                 ("multi_update_causal", MULTI_E * SMAC_T, 27, True),
                 ("multi_rollout", MULTI_E, 27, False))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        fwd, bwd = {}, {}
        for label, B, lq, lk, causal, mask in fwd_cases:
            q, k, v = (torch.randn(B, H, n, Dh, generator=g, device=dev).to(dtype)
                       for n in (lq, lk, lk))
            sdpa_mask = None if mask is None else mask[None, None, None, :]
            ms, eager_ms = _time_ms(
                torch, lambda: ca.fused_masked_attention(q, k, v, causal=causal, kv_mask=mask))
            plain_ms, _ = _time_ms(
                torch, lambda: ca.attention_plain(q, k, v, causal=causal, kv_mask=mask))
            lib_ms, _ = _time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask, is_causal=causal))
            bound_ms, bound_by = _bound(q, k, mask, name, causal)
            fwd[label] = {"shape": f"q {tuple(q.shape)} k {tuple(k.shape)} {name}, causal "
                                   f"{causal}, keys valid {lk if mask is None else int(mask.sum())}",
                          "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                          **_ratios(ms, lib_ms, bound_ms)}
            say(f"[phase 2] time {label} {name} {tuple(q.shape)}, device (eager) per call: "
                f"kernel {ms * 1e3:.2f} ({eager_ms * 1e3:.2f}) us, plain {plain_ms * 1e3:.2f} us, "
                f"sdpa {lib_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us ({bound_by}); "
                f"kernel / sdpa {ms / lib_ms:.2f}, kernel / bound {ms / bound_ms:.1f}; L2-warm")
        for label, B, L, causal in bwd_cases:
            q, k, v, do = (torch.randn(B, H, L, Dh, generator=g, device=dev).to(dtype)
                           for _ in range(4))
            stats = None
            if dtype == torch.bfloat16:
                stats = torch.empty(2, B * H, L, device=dev)
                ca.attention_fwd(q, k, v, causal=causal, stats=stats)
            ms, eager_ms = _time_ms(
                torch, lambda: ca.attention_bwd(q, k, v, do, causal=causal, stats=stats))
            plain_ms, _ = _time_ms(
                torch, lambda: ca.attention_bwd_plain(q, k, v, do, causal=causal))
            # SDPA's backward alone, on the device as the kernel is timed: its
            # forward and backward captured together, less its forward alone
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

            def sdpa():
                return F.scaled_dot_product_attention(*leaves, is_causal=causal)

            lib_fb_ms, _ = _time_ms(torch, lambda: torch.autograd.grad(sdpa(), leaves, do))
            lib_f_ms, _ = _time_ms(torch, sdpa)
            lib_ms = lib_fb_ms - lib_f_ms
            bound_ms, bound_by = _bwd_bound(q, causal, name)
            bwd[label] = {"shape": f"q/k/v/dO {tuple(q.shape)} {name}, causal {causal}",
                          "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "library_fwd_bwd_ms": lib_fb_ms,
                          "library_fwd_ms": lib_f_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                          "stats_fed": stats is not None, **_ratios(ms, lib_ms, bound_ms)}
            say(f"[phase 2] time bwd {label} {name} {tuple(q.shape)}, device (eager) per call: "
                f"kernel {ms * 1e3:.2f} ({eager_ms * 1e3:.2f}) us"
                f"{' (fed the row statistics)' if stats is not None else ''}, plain fwd+bwd "
                f"{plain_ms * 1e3:.2f} us, sdpa bwd {lib_ms * 1e3:.2f} us (fwd+bwd "
                f"{lib_fb_ms * 1e3:.2f} less fwd {lib_f_ms * 1e3:.2f}), bound "
                f"{bound_ms * 1e3:.3f} us ({bound_by}); kernel / sdpa "
                f"{ms / lib_ms if lib_ms > 0 else float('nan'):.2f}, kernel / bound "
                f"{ms / bound_ms:.1f}; L2-warm")
        out[name] = (fwd, bwd)
    torch.cuda.synchronize()
    return out


def phase2_ar_decode_bf16(torch):
    """ar_decode's bf16 leg against its plain twin at full DCML width (B 1-128,
    noise on and off), on the device-memory path (n_embd 256), a planted
    fault, and its, the plain twin's and the bf16 cached decode's times."""
    import dataclasses

    from mat_dcml_tpu_torch.models.decode import cached_decode
    from mat_dcml_tpu_torch.ops import ar_decode as ard
    from mat_dcml_tpu_torch.ops.distributions import gumbel_noise

    dev = torch.device("cuda")
    base = dataclasses.replace(_dcml_config(), dtype="bfloat16")
    g = torch.Generator(device=dev).manual_seed(SEED + 9)

    def inputs(cfg, B, noise):
        A, adim = cfg.n_agent, cfg.action_dim
        rep = torch.randn(B, A, cfg.n_embd, generator=g, device=dev).bfloat16()
        gumbel = (gumbel_noise((B, A, adim), g, dev) if noise
                  else torch.zeros(B, A, adim, device=dev))
        normal = torch.randn(B, 1, adim, generator=g, device=dev) * float(noise)
        avail = (torch.rand(B, A, adim, generator=g, device=dev) > 0.2).float()
        avail[..., 0] = 1.0
        return rep, gumbel, normal, avail

    def plan_of(cfg, B):
        return ard.kernel_plan(B, cfg.n_agent, n_embd=cfg.n_embd, n_head=cfg.n_head,
                               n_block=cfg.n_block, adim=cfg.action_dim, dtype=torch.bfloat16)

    worst, flips_total, shapes = 0.0, 0, {}
    cases = [(base, B, noise) for B in BF16_CHECK_BATCHES for noise in (False, True)]
    cases += [(dataclasses.replace(base, n_embd=WIDE_EMBD), B, True) for B in (1, 9)]
    models = {}
    with torch.no_grad():
        for cfg, B, noise in cases:
            if cfg.n_embd not in models:
                models[cfg.n_embd] = ard.pack_ar_decode_weights(_scaled_model(torch, cfg, SEED + 3))
            weights = models[cfg.n_embd]
            kw = dict(n_head=cfg.n_head, adim=cfg.action_dim, nd=cfg.n_discrete_agents)
            x = inputs(cfg, B, noise)
            act, logp = ard.fused_ar_decode(weights, *x, **kw)
            torch.cuda.synchronize()
            ref = ard.ar_decode_plain(weights, *x, return_scores=True, **kw)
            plan = plan_of(cfg, B)
            label = (f"bf16 n_embd {cfg.n_embd} B {B} {'noise' if noise else 'deterministic'} "
                     f"({_plan_words(plan)})")
            err, flips = _agree(*(t.cpu().numpy() for t in (act, logp, *ref)),
                                cfg.n_discrete_agents, BF16_AR_TOL, f"ar_decode {label}",
                                near_tie=BF16_NEAR_TIE)
            worst, flips_total = max(worst, err), flips_total + flips
            say(f"[phase 2] ar_decode {label}: max|logp kernel - plain| {err:.3g} (tol "
                f"{BF16_AR_TOL}), rows diverging at a near-tie ({BF16_NEAR_TIE}) {flips}")
        cfg = base
        weights = models[cfg.n_embd]
        A, D, adim, nd = cfg.n_agent, cfg.n_embd, cfg.action_dim, cfg.n_discrete_agents
        kw = dict(n_head=cfg.n_head, adim=adim, nd=nd)
        x = inputs(cfg, 8, True)
        ref_act, ref_logp = ard.ar_decode_plain(weights, *x, **kw)
        rep_f = x[0].clone()
        rep_f[:, 50] = x[0][:, 49]
        f_act, f_logp = ard.ar_decode_plain(weights, rep_f, *x[1:], **kw)
        fault = (f_logp - ref_logp).abs().max().item()
        say(f"[phase 2] ar_decode bf16 planted fault (agent 50's rep replaced, B 8): max|logp "
            f"diff| {fault:.3g} (tol {BF16_AR_TOL})")
        if not fault >= BF16_FAULT_FACTOR * BF16_AR_TOL:
            raise AssertionError(f"bf16 ar_decode tolerance would pass a replaced rep ({fault})")
        model = _scaled_model(torch, cfg, SEED + 3)
        for B in AR_BATCHES:
            rep, gumbel, normal, avail = inputs(cfg, B, True)
            tail = torch.zeros(A, B, adim, device=dev)
            tail[nd:] = normal.transpose(0, 1)
            ms, eager_ms = _time_ms(
                torch, lambda: ard.fused_ar_decode(weights, rep, gumbel, normal, avail, **kw),
                iters=20)
            plain_ms, _ = _time_ms(
                torch, lambda: ard.ar_decode_plain(weights, rep, gumbel, normal, avail, **kw),
                iters=2)
            cached_ms, _ = _time_ms(torch, lambda: cached_decode(
                model, rep, avail, False, gumbel=gumbel, tail_noise=tail), iters=2)
            bound_ms, bound_by = _ar_bound(cfg, weights, B, True)
            plan = plan_of(cfg, B)
            shapes[B] = {"shape": f"obs_rep ({B}, {A}, {D}) bf16, noise, avail masked",
                         "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                         "cached_decode_ms": cached_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "barriers": plan.barriers}
            say(f"[phase 2] time ar_decode bf16 B {B}, device (eager) per call: kernel {ms:.3f} "
                f"({eager_ms:.3f}) ms, plain {plain_ms:.2f} ms, bf16 cached decode "
                f"{cached_ms:.2f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}); "
                f"{plan.clusters} clusters, {_plan_words(plan)}, {plan.smem_bytes} B shared "
                f"memory a CTA, {plan.barriers} cluster barriers a position; L2-warm")
    torch.cuda.synchronize()
    return worst, flips_total, fault, shapes


def phase2_decode_step_bf16(torch):
    """decode_step's bf16 leg against its plain twin for both continuous
    families at MuJoCo 10x2 (B 1-128, the first and last positions; logits
    and every cache), on the device-memory path (n_embd 256), a planted
    fault, and its, the plain twin's and the bf16 cached step's times."""
    import dataclasses

    from mat_dcml_tpu_torch.ops import decode_step as dst

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    bf = torch.bfloat16

    def plan_of(cfg, B):
        return dst.kernel_plan(B, cfg.n_agent, cfg.action_input_dim, n_embd=cfg.n_embd,
                               n_head=cfg.n_head, n_block=cfg.n_block, adim=cfg.action_dim,
                               dtype=bf)

    def step_inputs(cfg, B):
        A, D, nb = cfg.n_agent, cfg.n_embd, cfg.n_block
        caches = dst.decode_caches(nb, A, B, D, dev, dtype=bf)
        caches.copy_(torch.randn(caches.shape, generator=g, device=dev))
        x_in = torch.randn(B, cfg.action_input_dim, generator=g, device=dev).to(bf)
        rep = torch.randn(B, A, D, generator=g, device=dev).to(bf)
        return x_in, rep, caches

    def moved(a, b):
        """The rows whose logits moved by more than BF16_MOVED."""
        return int(((a - b).abs() > BF16_MOVED).any(dim=-1).sum())

    worst, worst_share, shapes = 0.0, 0.0, {}
    cases = [(dataclasses.replace(_mj_config(family), dtype="bfloat16"), B, i)
             for family in ("continuous", "available_continuous") for B in BF16_CHECK_BATCHES
             for i in (0, 9)]
    cases += [(dataclasses.replace(_mj_config(), n_embd=WIDE_EMBD, dtype="bfloat16"), B, 9)
              for B in (3, 9)]
    models = {}
    with torch.no_grad():
        for cfg, B, i in cases:
            key = (cfg.action_type, cfg.n_embd)
            if key not in models:
                models[key] = dst.pack_decode_weights(_scaled_model(torch, cfg, SEED + 6))
            weights = models[key]
            x_in, rep, caches = step_inputs(cfg, B)
            mine, ref = caches.clone(), caches.clone()
            kw = dict(n_head=cfg.n_head, adim=cfg.action_dim)
            out = dst.fused_decode_step(weights, x_in, rep[:, i], mine, i, **kw)
            torch.cuda.synchronize()
            want = dst.decode_step_plain(weights, x_in, rep[:, i], ref, i, **kw)
            err = (out - want).abs().max().item()
            cerr = (mine.float() - ref.float()).abs().max().item()
            rows = moved(out, want)
            share = rows / B
            worst, worst_share = max(worst, err, cerr), max(worst_share, share)
            plan = plan_of(cfg, B)
            label = (f"bf16 {cfg.action_type} n_embd {cfg.n_embd} B {B} i {i} "
                     f"({_plan_words(plan)})")
            most = max(1, int(BF16_MOVED_SHARE * B))
            say(f"[phase 2] decode_step {label}: max|kernel - plain| logits {err:.3g} (tol "
                f"{BF16_STEP_TOL}), caches {cerr:.3g} (tol {BF16_CACHE_TOL}); rows moved by "
                f"> {BF16_MOVED}: {rows} of {B} (at most {most})")
            if not (err <= BF16_STEP_TOL and cerr <= BF16_CACHE_TOL and rows <= most):
                raise AssertionError(f"decode_step {label}: {err}, {cerr}, {share}")
        # what the check must catch: the plain twin with agent mid's cached
        # self-attention key replaced by the one before it (B 8, last position)
        cfg = dataclasses.replace(_mj_config(), dtype="bfloat16")
        A, D, nb, adim = cfg.n_agent, cfg.n_embd, cfg.n_block, cfg.action_dim
        weights = models[(cfg.action_type, D)]
        kw = dict(n_head=cfg.n_head, adim=adim)
        x_in, rep, caches = step_inputs(cfg, 8)
        faulty = caches.clone()
        faulty[0, A // 2] = caches[0, A // 2 - 1]
        ref = dst.decode_step_plain(weights, x_in, rep[:, A - 1], caches.clone(), A - 1, **kw)
        bad = dst.decode_step_plain(weights, x_in, rep[:, A - 1], faulty, A - 1, **kw)
        fault_share = moved(bad, ref) / 8
        say(f"[phase 2] decode_step bf16 planted fault (agent {A // 2}'s cached key replaced, "
            f"B 8): rows moved by > {BF16_MOVED}: {fault_share:.3f}, max|logits diff| "
            f"{(bad - ref).abs().max().item():.3g}")
        if not fault_share >= BF16_FAULT_FACTOR * BF16_MOVED_SHARE:
            raise AssertionError(f"the bf16 decode_step check would pass a replaced key "
                                 f"({fault_share})")
        model = _scaled_model(torch, cfg, SEED + 6)
        i = A - 1
        valid = torch.arange(A, device=dev) <= i
        for B in AR_BATCHES:
            x_in, rep, caches = step_inputs(cfg, B)
            ms, eager_ms = _time_ms(torch, lambda: dst.fused_decode_step(
                weights, x_in, rep[:, i], caches, i, **kw))
            plain_ms, _ = _time_ms(torch, lambda: dst.decode_step_plain(
                weights, x_in, rep[:, i], caches, i, **kw), iters=20)
            kv = model.fresh_packed_cache(B)
            q2 = model.decode_queries(rep)
            cached_ms, _ = _time_ms(torch, lambda: model.decode_step_cached(
                x_in[:, None], rep[:, i:i + 1], q2[:, :, :, i:i + 1], kv, i, valid), iters=20)
            bound_ms, bound_by = _step_bound(cfg, weights, B, i)
            plan = plan_of(cfg, B)
            shapes[B] = {"shape": f"B {B}, A {A}, D {D}, in_dim {cfg.action_input_dim}, adim "
                                  f"{adim}, position {i}, bf16",
                         "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                         "cached_step_ms": cached_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "barriers": plan.barriers}
            say(f"[phase 2] time decode_step bf16 B {B} A {A} i {i}, device (eager) per call: "
                f"kernel {ms * 1e3:.2f} ({eager_ms * 1e3:.2f}) us, plain {plain_ms * 1e3:.2f} us, "
                f"bf16 cached decode step {cached_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us "
                f"({bound_by}); {plan.clusters} clusters, {_plan_words(plan)}, "
                f"{plan.smem_bytes} B shared memory a CTA, {plan.barriers} cluster barriers a "
                f"launch; L2-warm")
    torch.cuda.synchronize()
    return worst, worst_share, fault_share, shapes


def _dcml_config():
    from mat_dcml_tpu_torch.envs.dcml.constants import DCMLConsts
    from mat_dcml_tpu_torch.models.mat import SEMI_DISCRETE, MATConfig

    c = DCMLConsts()
    return MATConfig(n_agent=c.n_agents, obs_dim=c.local_obs_dim, state_dim=c.sob_dim,
                     action_dim=c.action_dim, n_block=2, n_embd=64, n_head=2,
                     action_type=SEMI_DISCRETE, semi_index=-c.extra_agent)


def _requests(cfg, n, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    state = rng.normal(size=(n, cfg.n_agent, cfg.state_dim)).astype(np.float32)
    obs = rng.normal(size=(n, cfg.n_agent, cfg.obs_dim)).astype(np.float32)
    avail = (rng.uniform(size=(n, cfg.n_agent, cfg.action_dim)) > 0.2).astype(np.float32)
    avail[..., 0] = 1.0
    return state, obs, avail


def _check_actions(cfg, act, logp):
    import numpy as np

    from mat_dcml_tpu_torch.models.decode import CONTINUOUS_FAMILIES

    if cfg.action_type in CONTINUOUS_FAMILIES:
        want = (cfg.n_agent, cfg.act_out_dim), (cfg.n_agent, cfg.act_prob_dim)
        if act.shape[-2:] != want[0] or logp.shape[-2:] != want[1]:
            raise AssertionError(f"action {act.shape} / log-prob {logp.shape}, want {want}")
        if not (np.isfinite(act).all() and np.isfinite(logp).all()):
            raise AssertionError("non-finite continuous action or log-prob")
        return
    nd = cfg.n_discrete_agents
    if act.shape[-2:] != (cfg.n_agent, 1) or logp.shape != act.shape:
        raise AssertionError(f"action {act.shape} / log-prob {logp.shape}")
    if not set(np.unique(act[..., :nd, 0])) <= {0.0, 1.0}:
        raise AssertionError("a worker agent chose outside {0, 1}")
    if not (np.isfinite(act[..., nd:, 0]).all() and np.isfinite(logp).all()):
        raise AssertionError("non-finite coding ratio or log-prob")


def _match_bucket8(torch, cfg, params, engines):
    """A bucket-8 decode by each engine on the card (``{mode: engine}``)
    against the port on the CPU in the same mode, and the scan decode
    against the card's cached decode, with the same weights: ``_agree`` at
    LOGP_ATOL_VS_CPU, near-ties judged by the CPU's teacher-forced logits
    under the CPU's cached actions."""
    import numpy as np

    from mat_dcml_tpu_torch.models.mat import MultiAgentTransformer
    from mat_dcml_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    state, obs, avail = _requests(cfg, 8, seed=SEED + 1)
    card = {mode: eng.decode(state, obs, avail) for mode, eng in engines.items()}
    cpu = {mode: DecodeEngine(params, cfg, EngineConfig(buckets=(8,), decode_mode=mode),
                              device="cpu", log_fn=lambda *_: None).decode(state, obs, avail)
           for mode in engines}
    model = MultiAgentTransformer(cfg, device="cpu")
    model.load_state_dict(params)
    ref_act = cpu["cached"][0] if "cached" in cpu else next(iter(cpu.values()))[0]
    sh = np.zeros((8, cfg.n_agent, cfg.action_input_dim), np.float32)
    sh[:, 0, 0] = 1.0
    idx = ref_act[:, :-1, 0].astype(int).clip(0, cfg.action_dim - 1)
    for i in range(1, cfg.n_agent):
        sh[np.arange(8), i, 1 + idx[:, i - 1]] = 1.0
    with torch.inference_mode():
        _, _, logits = model(*(torch.from_numpy(x) for x in (state, obs, sh)))
    logits = np.where(avail == 0, -1e10, logits.numpy())
    pairs = [(f"{mode} card vs CPU", card[mode], cpu[mode]) for mode in engines]
    if "scan" in card and "cached" in card:
        pairs.append(("scan vs cached, card", card["scan"], card["cached"]))
    for what, (act, logp), (r_act, r_logp) in pairs:
        worst, flips = _agree(act[..., 0], logp[..., 0], r_act[..., 0], r_logp[..., 0], logits,
                              cfg.n_discrete_agents, LOGP_ATOL_VS_CPU, f"bucket 8 {what}")
        say(f"[phase 3] bucket 8 {what}: max|logp diff| {worst:.3g} (tol {LOGP_ATOL_VS_CPU}), "
            f"rows diverging at a near-tie: {flips}")


def phase3_serve(torch, params, mode, cfg=None, tag="phase 3", serve_dtype="f32"):
    """Serve the 96 requests through batcher -> engine(decode_mode=mode,
    serve_dtype), with the DCML policy or the one of ``cfg``; returns
    ``(engine, batcher, (attention_fwd, ar_decode, decode_step launches))``."""
    import numpy as np

    from mat_dcml_tpu_torch.models.decode import CONTINUOUS_FAMILIES
    from mat_dcml_tpu_torch.ops import ar_decode as ard
    from mat_dcml_tpu_torch.ops import cuda_attention as ca
    from mat_dcml_tpu_torch.ops import decode_step as dst
    from mat_dcml_tpu_torch.serving.batcher import BatcherConfig, ContinuousBatcher
    from mat_dcml_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    cfg = cfg or _dcml_config()
    continuous = cfg.action_type in CONTINUOUS_FAMILIES
    if serve_dtype != "f32":
        mode_tag = f"{mode} {serve_dtype}"
    else:
        mode_tag = mode
    engine = DecodeEngine(params, cfg, EngineConfig(buckets=BUCKETS, decode_mode=mode,
                                                    serve_dtype=serve_dtype),
                          log_fn=lambda m: say(f"[{tag}] {mode_tag}: {m}"))
    if engine.device.type != "cuda":
        raise AssertionError(f"engine defaulted to {engine.device}")
    engine.warmup()
    batcher = ContinuousBatcher(engine, BatcherConfig(max_batch_wait_ms=5.0),
                                log_fn=lambda m: say(f"[{tag}] {mode_tag}: {m}"))

    n_req = N_CLIENTS * REQUESTS_PER_CLIENT
    state, obs, avail = _requests(cfg, n_req, seed=SEED)
    results = [None] * n_req
    lat_ms = [0.0] * n_req
    errors = []

    def client(c):
        """Even clients wait for each answer before the next request; odd
        clients send all theirs at once, so larger buckets fill too."""
        rows = range(c * REQUESTS_PER_CLIENT, (c + 1) * REQUESTS_PER_CLIENT)
        try:
            if c % 2 == 0:
                for r in rows:
                    t0 = time.perf_counter()
                    results[r] = batcher.submit(state[r], obs[r], avail[r]).result(timeout=300)
                    lat_ms[r] = (time.perf_counter() - t0) * 1e3
            else:
                t0 = time.perf_counter()
                futs = [(r, batcher.submit(state[r], obs[r], avail[r])) for r in rows]
                for r, fut in futs:
                    results[r] = fut.result(timeout=300)
                    lat_ms[r] = (time.perf_counter() - t0) * 1e3
        except Exception as e:   # reported below: a client's failure fails the phase
            errors.append(repr(e))

    dispatch_before = dict(engine.dispatch_counts)
    ca.launches = ard.launches = dst.launches = 0
    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(c,), name=f"client-{c}") for c in range(N_CLIENTS)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = (ca.launches, ard.launches, dst.launches)
    torch.cuda.synchronize()
    if errors or any(t.is_alive() for t in clients):
        raise AssertionError(f"clients failed: {errors[:3]}")
    dispatches = {b: engine.dispatch_counts[b] - dispatch_before[b] for b in BUCKETS}
    n_dispatch = sum(dispatches.values())
    # per dispatch: the encoder's attentions, then either 2 per block and
    # position (cached), or the one whole-decode launch (scan, discrete) or
    # one decode-step launch a position (scan, continuous)
    nb, A = cfg.n_block, cfg.n_agent
    if mode == "cached":
        per = (nb + A * 2 * nb, 0, 0)
    else:
        per = (nb, 0, A) if continuous else (nb, 1, 0)
    say(f"[{tag}] {mode_tag}: served {n_req} requests from {N_CLIENTS} clients in {n_dispatch} "
        f"dispatches { {b: n for b, n in dispatches.items() if n} }; attention_fwd / ar_decode "
        f"/ decode_step launches {launches} (expected {per} per dispatch)")
    if launches != tuple(p * n_dispatch for p in per) or n_dispatch == 0:
        raise AssertionError(f"expected {per} launches per dispatch, got {launches} for "
                             f"{n_dispatch}")
    # the batcher stayed on its normal path: no failed bucket dispatch
    # retried as bucket-1 singles, nothing shed or expired, and every engine
    # dispatch was one whole batch
    counters = batcher.telemetry.counters
    fallbacks = {k: counters.get(k, 0.0) for k in (
        "serving_degraded_batches", "serving_degraded_ok", "serving_engine_failures",
        "serving_shed", "serving_deadline_misses")}
    batches = sum(counters.get(f"serving_bucket_{b}", 0.0) for b in BUCKETS)
    if any(fallbacks.values()) or batches != n_dispatch:
        raise AssertionError(f"batcher left its normal path: {fallbacks}; "
                             f"{batches} batches for {n_dispatch} engine dispatches")
    act = np.stack([r[0] for r in results])
    logp = np.stack([r[1] for r in results])
    _check_actions(cfg, act, logp)
    lat = np.asarray(lat_ms)
    what = (f"actions mean {act.mean():.4f}, std {act.std():.4f}" if continuous else
            f"worker actions mean {act[:, :-1].mean():.3f}, coding ratio mean "
            f"{act[:, -1].mean():.4f}")
    say(f"[{tag}] {mode_tag}: {n_req / wall:.2f} requests/s; latency p50 "
        f"{np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f} ms; engine decode "
        f"p50 {engine.telemetry.hists['serving_decode_ms'].quantile(0.5):.2f} ms; {what}")
    torch.cuda.synchronize()
    return engine, batcher, launches


def canary_mismatches(act, logp, ref_act, ref_logp, nd):
    """The JAX canary's verdict per request (``serving/rollout_ctl.py``
    ``compare``) for a bf16 trunk against f32, rows of ``(B, A, 1)``
    arrays: a request mismatches where its greedy (worker) actions differ,
    or else where its log-probs are not within CANARY_RTOL / CANARY_ATOL.
    Returns the count."""
    import numpy as np

    bad = 0
    for b in range(act.shape[0]):
        if not np.array_equal(act[b, :nd], ref_act[b, :nd]):
            bad += 1
        elif not np.allclose(logp[b], ref_logp[b], rtol=CANARY_RTOL, atol=CANARY_ATOL):
            bad += 1
    return bad


def _match_bucket8_bf16(torch, cfg, params, engines16, engines32, tag):
    """A bucket-8 decode by each bf16 engine on the card against the port's
    bf16 engine on the CPU in the same mode (the kernels' and cuBLAS's sums
    against the CPU's: BF16_LOGP_VS_CPU, near-ties at BF16_NEAR_TIE), and
    against the card's f32 engine within the JAX canary contract (the
    discrete families; a continuous family's distance is printed)."""
    import numpy as np

    from mat_dcml_tpu_torch.models.decode import CONTINUOUS_FAMILIES
    from mat_dcml_tpu_torch.models.mat import MultiAgentTransformer
    from mat_dcml_tpu_torch.serving.engine import DecodeEngine, EngineConfig, serve_cast

    continuous = cfg.action_type in CONTINUOUS_FAMILIES
    state, obs, avail = _requests(cfg, 8, seed=SEED + 1)
    card16 = {m: e.decode(state, obs, avail) for m, e in engines16.items()}
    card32 = {m: e.decode(state, obs, avail) for m, e in engines32.items()}
    cpu16 = {m: DecodeEngine(params, cfg, EngineConfig(buckets=(8,), decode_mode=m,
                                                        serve_dtype="bf16"),
                             device="cpu", log_fn=lambda *_: None).decode(state, obs, avail)
             for m in engines16}
    if not continuous:
        import dataclasses

        model = MultiAgentTransformer(dataclasses.replace(cfg, dtype="bfloat16"), device="cpu")
        model.load_state_dict(params)
        serve_cast(model)
        ref_act = cpu16["cached"][0]
        sh = np.zeros((8, cfg.n_agent, cfg.action_input_dim), np.float32)
        sh[:, 0, 0] = 1.0
        idx = ref_act[:, :-1, 0].astype(int).clip(0, cfg.action_dim - 1)
        for i in range(1, cfg.n_agent):
            sh[np.arange(8), i, 1 + idx[:, i - 1]] = 1.0
        with torch.inference_mode():
            _, _, logits = model(*(torch.from_numpy(x) for x in (state, obs, sh)))
        scores = np.where(avail == 0, -1e10, logits.float().numpy())
    worst = 0.0
    for m in engines16:
        (act, logp), (r_act, r_logp) = card16[m], cpu16[m]
        if continuous:
            err = max(float(np.abs(act - r_act).max()), float(np.abs(logp - r_logp).max()))
            flips = 0
            if not err <= BF16_LOGP_VS_CPU:
                raise AssertionError(f"bf16 {m} card vs CPU: {err}")
        else:
            err, flips = _agree(act[..., 0], logp[..., 0], r_act[..., 0], r_logp[..., 0], scores,
                                cfg.n_discrete_agents, BF16_LOGP_VS_CPU, f"bf16 {m} card vs CPU",
                                near_tie=BF16_NEAR_TIE)
        worst = max(worst, err)
        say(f"[{tag}] bucket 8 bf16 {m} card vs CPU: max|diff| {err:.3g} (tol "
            f"{BF16_LOGP_VS_CPU}), rows diverging at a near-tie ({BF16_NEAR_TIE}) {flips}")
        (a32, l32) = card32[m]
        dist = float(np.abs(logp - l32).max())
        if continuous:
            say(f"[{tag}] bucket 8 {m} bf16 vs f32 engine on the card: max|logp diff| "
                f"{dist:.3g}, max|action diff| {float(np.abs(act - a32).max()):.3g}")
            continue
        bad = canary_mismatches(act, logp, a32, l32, cfg.n_discrete_agents)
        say(f"[{tag}] bucket 8 {m} bf16 vs f32 engine on the card, the JAX canary contract "
            f"(rtol {CANARY_RTOL}, atol {CANARY_ATOL}; at most {1 - CANARY_GREEDY:.0%} of "
            f"requests mismatched): {bad} of 8 mismatched; max|logp diff| {dist:.3g}")
        if bad > (1 - CANARY_GREEDY) * 8:
            raise AssertionError(f"bf16 {m} engine fails the canary contract: {bad} of 8")
    return worst


def phase4_close(torch, batcher):
    batcher.close(timeout_s=30.0)
    torch.cuda.synchronize()
    left = [t.name for t in threading.enumerate()
            if t is not threading.main_thread() and t.is_alive() and not t.daemon]
    if left or batcher._thread.is_alive():
        raise AssertionError(f"threads left running: {left}")
    say("[phase 4] batcher closed; no thread left running")


def _expected_launches(cfg, run, ppo, iters):
    """Attention kernel launches of ``iters`` training iterations: per
    collect step the encoder (n_block) and 2 * n_block per decode position;
    per update, each epoch's target recompute (the encoder, n_block) and per
    minibatch 3 * n_block forward (encoder + two decoder attentions a block)
    and as many backward launches."""
    nb, A = cfg.n_block, cfg.n_agent
    collect = run.episode_length * (nb + A * 2 * nb)
    update_fwd = ppo.ppo_epoch * (nb + ppo.num_mini_batch * 3 * nb)
    update_bwd = ppo.ppo_epoch * ppo.num_mini_batch * 3 * nb
    return iters * (collect + update_fwd), iters * update_bwd, update_fwd, update_bwd


def _to_cpu(x):
    """A NamedTuple of tensors (nested; None leaves kept) copied to the CPU."""
    return type(x)(*(_to_cpu(v) if isinstance(v, tuple) else None if v is None else v.cpu()
                     for v in x))


def _match_cpu_update(torch, runner, ppo, train_state, rollout_state, tag="phase 5"):
    """One more collect on the card, then the same PPO update on the card
    and by the port on the CPU from copies of the trajectory, weights, Adam
    state, ValueNorm and permutations.  Returns the card update's launches.
    A bf16 trunk is held to the bf16 bounds (BF16_UPDATE_*)."""
    import numpy as np

    from mat_dcml_tpu_torch.models.policy import TransformerPolicy
    from mat_dcml_tpu_torch.ops import cuda_attention as ca
    from mat_dcml_tpu_torch.ops.normalize import ValueNormState
    from mat_dcml_tpu_torch.training.ppo import MATTrainer

    rollout_state, traj = runner.collector.collect(rollout_state, generator=runner.generator)
    perms = runner.trainer.draw_permutations(traj.rewards.shape[0] * traj.rewards.shape[1],
                                             runner.generator)
    cpu_policy = TransformerPolicy(runner.policy.cfg, device="cpu")
    cpu_policy.model.load_state_dict(runner.policy.model.state_dict())
    cpu_trainer = MATTrainer(cpu_policy, ppo, total_updates=runner.trainer.total_updates)
    cpu_state = cpu_trainer.init_state()
    cpu_state.optimizer.load_state_dict(copy.deepcopy(train_state.optimizer.state_dict()))
    cpu_state.value_norm = ValueNormState(*(x.cpu() for x in train_state.value_norm))
    before = [p.detach().cpu().clone() for p in runner.policy.model.parameters()]

    ca.launches = ca.bwd_launches = 0
    t0 = time.perf_counter()
    train_state, met = runner.trainer.train(train_state, traj, rollout_state, perms=perms)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = (ca.launches, ca.bwd_launches)
    t0 = time.perf_counter()
    cpu_traj = traj._replace(chunk_stats={}, **{k: v.cpu() for k, v in traj._asdict().items()
                                                 if isinstance(v, torch.Tensor)})
    cpu_state, cmet = cpu_trainer.train(cpu_state, cpu_traj, _to_cpu(rollout_state),
                                        perms=perms.cpu())
    cpu_s = time.perf_counter() - t0

    steps = ppo.ppo_epoch * ppo.num_mini_batch
    if runner.policy.cfg.dtype == "bfloat16":
        return _match_cpu_update_bf16(runner, cpu_policy, before, met, cmet, steps, ppo.lr,
                                      launches, card_s, cpu_s, tag)
    tol = UPDATE_TOL_FRACTION * ppo.lr * steps
    diff = key_bias_diff = moved = 0.0
    for (name, p), q, b in zip(runner.policy.model.named_parameters(),
                               cpu_policy.model.parameters(), before):
        d = (p.detach().cpu() - q).abs().max().item()
        moved = max(moved, (p.detach().cpu() - b).abs().max().item())
        diff = max(diff, d)
        if name.endswith("key_p.bias"):
            key_bias_diff = max(key_bias_diff, d)
    # a key projection's bias gets a gradient that is 0 but for rounding
    # noise, far below Adam's eps at the recipe's scale, so it barely moves;
    # it is held to the same bound as every other weight, and a backward
    # whose dk error is constant along a row (which only these biases see)
    # fails it
    say(f"[{tag}] one update ({steps} Adam steps) card vs CPU port: max|weight diff| "
        f"{diff:.3g} (tol {UPDATE_TOL_FRACTION} x lr x steps = {tol:.3g}), of which key_p "
        f"biases {key_bias_diff:.3g}; the update moved weights by up to {moved:.3g}; "
        f"card {card_s:.2f}s, CPU {cpu_s:.2f}s")
    if not diff <= tol < moved:
        raise AssertionError(f"card update differs from the CPU port by {diff} (tol {tol}, "
                             f"moved {moved}); key_p biases {key_bias_diff}")
    for name in met._fields:
        a, b = float(getattr(met, name)), float(getattr(cmet, name))
        # update_ratio divides the step p_new - p_old, which each side rounds
        # to its own weights' ulp (~1e-3 of a 5e-5 step)
        rtol = 1e-2 if name == "update_ratio" else METRIC_RTOL
        if not (np.isfinite(a) and abs(a - b) <= 1e-6 + rtol * abs(b)):
            raise AssertionError(f"metric {name}: card {a} vs CPU {b}")
    say(f"[{tag}] metrics card vs CPU within rtol {METRIC_RTOL}: "
        + ", ".join(f"{n} {float(getattr(met, n)):.6g}/{float(getattr(cmet, n)):.6g}"
                    for n in ("value_loss", "policy_loss", "dist_entropy", "grad_norm")))
    return launches


def _match_cpu_update_bf16(runner, cpu_policy, before, met, cmet, steps, lr, launches, card_s,
                           cpu_s, tag):
    """The bf16 update's card-vs-CPU check: every weight within
    BF16_UPDATE_RTOL / BF16_UPDATE_ATOL of the CPU's but the key
    projections' biases (2 lr a step), the update moved the weights, and
    the value loss within BF16_VALUE_LOSS_RTOL."""
    import numpy as np

    worst = key_bias_diff = moved = 0.0
    for (name, p), q, b in zip(runner.policy.model.named_parameters(),
                               cpu_policy.model.parameters(), before):
        a = p.detach().cpu()
        d = (a - q).abs()
        moved = max(moved, (a - b).abs().max().item())
        if name.endswith("key_p.bias"):
            key_bias_diff = max(key_bias_diff, d.max().item())
            continue
        worst = max(worst, (d - BF16_UPDATE_RTOL * q.abs()).max().item())
    say(f"[{tag}] one bf16 update ({steps} Adam steps) card vs CPU port: every weight within "
        f"rtol {BF16_UPDATE_RTOL} + atol {BF16_UPDATE_ATOL} (worst excess over the rtol part "
        f"{worst:.3g}), key_p biases {key_bias_diff:.3g} (tol 2 x lr x steps = "
        f"{2 * lr * steps:.3g}); the update moved weights by up to {moved:.3g}; card "
        f"{card_s:.2f}s, CPU {cpu_s:.2f}s")
    if not (worst <= BF16_UPDATE_ATOL and key_bias_diff <= 2 * lr * steps and moved > 0):
        raise AssertionError(f"bf16 card update differs from the CPU port: {worst}, key_p "
                             f"biases {key_bias_diff}, moved {moved}")
    a, b = float(met.value_loss), float(cmet.value_loss)
    if not (np.isfinite(a) and abs(a - b) <= BF16_VALUE_LOSS_RTOL * abs(b)):
        raise AssertionError(f"bf16 value_loss card {a} vs CPU {b}")
    say(f"[{tag}] bf16 metrics card vs CPU (value_loss within rtol {BF16_VALUE_LOSS_RTOL}): "
        + ", ".join(f"{n} {float(getattr(met, n)):.6g}/{float(getattr(cmet, n)):.6g}"
                    for n in ("value_loss", "policy_loss", "dist_entropy", "grad_norm")))
    return launches


def phase5_bf16_training(torch):
    """One DCML iteration of the recipe with a bf16 trunk in cached and one
    in scan mode, launches counted, then the card-vs-CPU check after one
    more bf16 update; returns ``{mode: (attention_fwd, attention_bwd,
    ar_decode)}`` and the records."""
    import math
    import tempfile

    from mat_dcml_tpu_torch.config import RunConfig
    from mat_dcml_tpu_torch.ops import ar_decode as ard
    from mat_dcml_tpu_torch.ops import cuda_attention as ca
    from mat_dcml_tpu_torch.training.ppo import PPOConfig
    from mat_dcml_tpu_torch.training.runner import DCMLRunner

    ppo = PPOConfig()
    launches, records = {}, {}
    for mode in ("cached", "scan"):
        with tempfile.TemporaryDirectory() as run_dir:
            run = RunConfig(seed=SEED, log_interval=1, run_dir=run_dir, decode_mode=mode,
                            model_dtype="bfloat16")
            runner = DCMLRunner(run, ppo, log_fn=lambda m: say(f"[phase 5] bf16 {mode}: {m}"))
            cfg = runner.policy.cfg
            if cfg.dtype != "bfloat16" or runner.device.type != "cuda":
                raise AssertionError(f"bf16 runner built {cfg.dtype} on {runner.device}")
            train_state, rollout_state = runner.setup()
            torch.cuda.synchronize()
            ca.launches = ca.bwd_launches = ard.launches = 0
            train_state, rollout_state = runner.train_loop(1, train_state, rollout_state)
            torch.cuda.synchronize()
            launches[mode] = (ca.launches, ca.bwd_launches, ard.launches)
            record = records[mode] = runner.records[0]
            _, _, upd_fwd, upd_bwd = _expected_launches(cfg, run, ppo, 1)
            nb, A, T = cfg.n_block, cfg.n_agent, run.episode_length
            collect = (T * (nb + A * 2 * nb), 0) if mode == "cached" else (T * nb, T)
            want = (collect[0] + upd_fwd, upd_bwd, collect[1])
            it = record["step_time_collect"] + record["step_time_train"]
            say(f"[phase 5] bf16 {mode} iteration: collect {record['step_time_collect']:.3f}s, "
                f"update {record['step_time_train']:.3f}s ({record['step_time_train'] / it:.1%} "
                f"of {it:.3f}s), fps {record['fps']:.1f}; avg_r "
                f"{record['average_step_rewards']:.2f}, value_loss {record['value_loss']:.4f}, "
                f"entropy {record['dist_entropy']:.4f}; attention_fwd / attention_bwd / "
                f"ar_decode launches {launches[mode]} (expected {want})")
            if launches[mode] != want:
                raise AssertionError(f"bf16 {mode} iteration launched {launches[mode]}, "
                                     f"expected {want}")
            if not all(math.isfinite(v) for v in record.values()):
                raise AssertionError(f"bf16 {mode} iteration metrics not finite: {record}")
            if mode == "scan":
                card = _match_cpu_update(torch, runner, ppo, train_state, rollout_state)
                if card != (upd_fwd, upd_bwd):
                    raise AssertionError(f"one bf16 update launched {card}, expected "
                                         f"{(upd_fwd, upd_bwd)}")
    torch.cuda.synchronize()
    return launches, records


def phase7_mujoco_bf16(torch):
    """One MujocoRunner scan iteration at manyagent_ant 10x2 with a bf16
    trunk (500 launches of decode_step's bf16 leg); returns
    ``(attention_fwd, attention_bwd, decode_step)`` launches and the record."""
    import math
    import tempfile

    from mat_dcml_tpu_torch.config import RunConfig
    from mat_dcml_tpu_torch.envs.mamujoco.lite import MJLiteConfig
    from mat_dcml_tpu_torch.ops import cuda_attention as ca
    from mat_dcml_tpu_torch.ops import decode_step as dst
    from mat_dcml_tpu_torch.training.mujoco_runner import MujocoRunner
    from mat_dcml_tpu_torch.training.ppo import PPOConfig

    ppo = PPOConfig()
    with tempfile.TemporaryDirectory() as run_dir:
        run = RunConfig(env_name="mujoco", scenario=f"{MJ_SCENARIO}_{MJ_CONF}", seed=SEED,
                        log_interval=1, run_dir=run_dir, decode_mode="scan",
                        model_dtype="bfloat16")
        runner = MujocoRunner(run, ppo, MJLiteConfig(scenario=MJ_SCENARIO, agent_conf=MJ_CONF,
                                                     episode_length=run.episode_length),
                              log_fn=lambda m: say(f"[phase 7] bf16 scan: {m}"))
        cfg = runner.policy.cfg
        train_state, rollout_state = runner.setup()
        torch.cuda.synchronize()
        ca.launches = ca.bwd_launches = dst.launches = 0
        runner.train_loop(1, train_state, rollout_state)
        torch.cuda.synchronize()
        launches = (ca.launches, ca.bwd_launches, dst.launches)
        record = runner.records[0]
    _, _, upd_fwd, upd_bwd = _expected_launches(cfg, run, ppo, 1)
    T = run.episode_length
    want = (T * cfg.n_block + upd_fwd, upd_bwd, T * cfg.n_agent)
    it = record["step_time_collect"] + record["step_time_train"]
    say(f"[phase 7] bf16 scan iteration: collect {record['step_time_collect']:.3f}s, update "
        f"{record['step_time_train']:.3f}s ({record['step_time_train'] / it:.1%} of {it:.3f}s), "
        f"fps {record['fps']:.1f}; value_loss {record['value_loss']:.4f}; attention_fwd / "
        f"attention_bwd / decode_step launches {launches} (expected {want})")
    if launches != want or cfg.dtype != "bfloat16":
        raise AssertionError(f"bf16 MuJoCo scan iteration launched {launches}, expected {want}")
    if not all(math.isfinite(v) for v in record.values()):
        raise AssertionError(f"bf16 MuJoCo scan iteration metrics not finite: {record}")
    return launches, record


def phase5_training(torch):
    import math
    import tempfile

    from mat_dcml_tpu_torch.config import RunConfig
    from mat_dcml_tpu_torch.ops import cuda_attention as ca
    from mat_dcml_tpu_torch.training.ppo import PPOConfig
    from mat_dcml_tpu_torch.training.runner import DCMLRunner

    ppo = PPOConfig()
    with tempfile.TemporaryDirectory() as run_dir:
        run = RunConfig(seed=SEED, log_interval=1, run_dir=run_dir)
        runner = DCMLRunner(run, ppo, log_fn=lambda m: say(f"[phase 5] {m}"))
        if runner.device.type != "cuda":
            raise AssertionError(f"runner defaulted to {runner.device}")
        cfg = runner.policy.cfg
        say(f"[phase 5] recipe: {cfg.n_agent} agents, n_embd {cfg.n_embd}, {cfg.n_block} blocks, "
            f"{cfg.n_head} heads, E {run.n_rollout_threads}, T {run.episode_length}, "
            f"{ppo.ppo_epoch} epochs x {ppo.num_mini_batch} minibatches")
        train_state, rollout_state = runner.setup()
        torch.cuda.synchronize()
        ca.launches = ca.bwd_launches = 0
        t0 = time.perf_counter()
        train_state, rollout_state = runner.train_loop(TRAIN_ITERS, train_state, rollout_state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = ca.launches, ca.bwd_launches
        records = list(runner.records)
    want_fwd, want_bwd, upd_fwd, upd_bwd = _expected_launches(cfg, run, ppo, TRAIN_ITERS)
    say(f"[phase 5] {TRAIN_ITERS} iterations in {wall:.2f}s; attention_fwd launches {fwd} "
        f"(expected {want_fwd}), attention_bwd launches {bwd} (expected {want_bwd})")
    if (fwd, bwd) != (want_fwd, want_bwd):
        raise AssertionError(f"launches fwd {fwd} / bwd {bwd}, expected {want_fwd} / {want_bwd}")
    if len(records) != TRAIN_ITERS or not all(
            math.isfinite(v) for r in records for v in r.values()):
        raise AssertionError(f"training metrics not finite or missing: {records}")
    for r in records:
        it = r["step_time_collect"] + r["step_time_train"]
        say(f"[phase 5] iteration {r['episode']}: collect {r['step_time_collect']:.3f}s, update "
            f"{r['step_time_train']:.3f}s ({r['step_time_train'] / it:.1%} of {it:.3f}s); "
            f"avg_r {r['average_step_rewards']:.2f}, value_loss {r['value_loss']:.4f}, "
            f"policy_loss {r['policy_loss']:.3g}, entropy {r['dist_entropy']:.4f}, "
            f"grad_norm {r['grad_norm']:.4f}")
    card_launches = _match_cpu_update(torch, runner, ppo, train_state, rollout_state)
    if card_launches != (upd_fwd, upd_bwd):
        raise AssertionError(f"one update launched {card_launches}, expected {(upd_fwd, upd_bwd)}")
    torch.cuda.synchronize()
    return fwd, bwd, records


def phase5_scan_iteration(torch, cached_records):
    """One iteration of the recipe with decode_mode="scan": the rollout's
    50 decodes are 50 ar_decode launches and the encoder's attentions; the
    update is the same as with the cached decode.  Returns ``(attention_fwd,
    attention_bwd, ar_decode)`` launches and the record."""
    import math
    import tempfile

    from mat_dcml_tpu_torch.config import RunConfig
    from mat_dcml_tpu_torch.ops import ar_decode as ard
    from mat_dcml_tpu_torch.ops import cuda_attention as ca
    from mat_dcml_tpu_torch.training.ppo import PPOConfig
    from mat_dcml_tpu_torch.training.runner import DCMLRunner

    ppo = PPOConfig()
    with tempfile.TemporaryDirectory() as run_dir:
        run = RunConfig(seed=SEED, log_interval=1, run_dir=run_dir, decode_mode="scan")
        runner = DCMLRunner(run, ppo, log_fn=lambda m: say(f"[phase 5] scan: {m}"))
        cfg = runner.policy.cfg
        train_state, rollout_state = runner.setup()
        torch.cuda.synchronize()
        ca.launches = ca.bwd_launches = ard.launches = 0
        runner.train_loop(1, train_state, rollout_state)
        torch.cuda.synchronize()
        launches = (ca.launches, ca.bwd_launches, ard.launches)
        record = runner.records[0]
    _, _, upd_fwd, upd_bwd = _expected_launches(cfg, run, ppo, 1)
    want = (run.episode_length * cfg.n_block + upd_fwd, upd_bwd, run.episode_length)
    it = record["step_time_collect"] + record["step_time_train"]
    say(f"[phase 5] scan iteration: collect {record['step_time_collect']:.3f}s, update "
        f"{record['step_time_train']:.3f}s ({record['step_time_train'] / it:.1%} of {it:.3f}s); "
        f"attention_fwd / attention_bwd / ar_decode launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"scan iteration launched {launches}, expected {want}")
    if not all(math.isfinite(v) for v in record.values()):
        raise AssertionError(f"scan iteration metrics not finite: {record}")
    ref = cached_records[0]
    say("[phase 5] scan vs cached first iteration (same seed; a near-tie may part them): "
        + ", ".join(f"{k} {record[k]:.6g}/{ref[k]:.6g}" for k in (
            "average_step_rewards", "value_loss", "policy_loss", "dist_entropy")))
    torch.cuda.synchronize()
    return launches, record


def _match_continuous_bucket8(torch, cfg, params, engines, tag):
    """A bucket-8 decode by each continuous engine on the card against the
    port on the CPU in the same mode, and scan against cached on the card:
    actions and log-probs within CONT_ATOL_VS_CPU (a deterministic
    continuous decode takes means: no draw can flip)."""
    import numpy as np

    from mat_dcml_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    state, obs, avail = _requests(cfg, 8, seed=SEED + 1)
    card = {mode: eng.decode(state, obs, avail) for mode, eng in engines.items()}
    cpu = {mode: DecodeEngine(params, cfg, EngineConfig(buckets=(8,), decode_mode=mode),
                              device="cpu", log_fn=lambda *_: None).decode(state, obs, avail)
           for mode in engines}
    pairs = [(f"{mode} card vs CPU", card[mode], cpu[mode]) for mode in engines]
    pairs.append(("scan vs cached, card", card["scan"], card["cached"]))
    for what, (act, logp), (r_act, r_logp) in pairs:
        err = max(float(np.abs(act - r_act).max()), float(np.abs(logp - r_logp).max()))
        say(f"[{tag}] bucket 8 {what}: max|action, logp diff| {err:.3g} "
            f"(tol {CONT_ATOL_VS_CPU})")
        if not err <= CONT_ATOL_VS_CPU:
            raise AssertionError(f"continuous bucket 8 {what}: {err} > {CONT_ATOL_VS_CPU}")


def phase6_continuous_serving(torch):
    """The continuous MuJoCo policy served in cached then scan mode, in f32
    then with a bf16 trunk; returns ``{mode: (attention_fwd, ar_decode,
    decode_step) launches}`` for each."""
    cfg = _mj_config()
    params = _scaled_model(torch, cfg, SEED + 7).cpu().state_dict()
    say(f"[phase 6] {MJ_SCENARIO} {MJ_CONF}: {cfg.n_agent} agents, action {cfg.action_dim}, obs "
        f"{cfg.obs_dim}, state {cfg.state_dim}, n_embd {cfg.n_embd}, {cfg.n_block} blocks, "
        f"{cfg.n_head} heads, {cfg.action_type}")
    engines, launches = {}, {}
    for mode in ("cached", "scan"):
        engines[mode], batcher, launches[mode] = phase3_serve(torch, params, mode, cfg,
                                                              tag="phase 6")
        phase4_close(torch, batcher)
    _match_continuous_bucket8(torch, cfg, params, engines, "phase 6")
    engines16, launches16 = {}, {}
    for mode in ("cached", "scan"):
        engines16[mode], batcher, launches16[mode] = phase3_serve(
            torch, params, mode, cfg, tag="phase 6", serve_dtype="bf16")
        phase4_close(torch, batcher)
    _match_bucket8_bf16(torch, cfg, params, engines16, engines, "phase 6")
    return launches, launches16


def phase7_mujoco_training(torch):
    """Two MujocoRunner iterations at manyagent_ant 10x2 (E = 8, T = 50, the
    recipe's PPO), cached with a card-vs-CPU update check, then scan;
    returns ``{mode: (attention_fwd, attention_bwd, decode_step)}``."""
    import math
    import tempfile

    from mat_dcml_tpu_torch.config import RunConfig
    from mat_dcml_tpu_torch.envs.mamujoco.lite import MJLiteConfig
    from mat_dcml_tpu_torch.ops import cuda_attention as ca
    from mat_dcml_tpu_torch.ops import decode_step as dst
    from mat_dcml_tpu_torch.training.mujoco_runner import MujocoRunner
    from mat_dcml_tpu_torch.training.ppo import PPOConfig

    ppo = PPOConfig()
    launches = {}
    for mode in ("cached", "scan"):
        with tempfile.TemporaryDirectory() as run_dir:
            run = RunConfig(env_name="mujoco", scenario=f"{MJ_SCENARIO}_{MJ_CONF}", seed=SEED,
                            log_interval=1, run_dir=run_dir, decode_mode=mode)
            runner = MujocoRunner(run, ppo, MJLiteConfig(scenario=MJ_SCENARIO, agent_conf=MJ_CONF,
                                                         episode_length=run.episode_length),
                                  log_fn=lambda m: say(f"[phase 7] {mode}: {m}"))
            if runner.device.type != "cuda":
                raise AssertionError(f"runner defaulted to {runner.device}")
            cfg = runner.policy.cfg
            train_state, rollout_state = runner.setup()
            torch.cuda.synchronize()
            ca.launches = ca.bwd_launches = dst.launches = 0
            train_state, rollout_state = runner.train_loop(1, train_state, rollout_state)
            torch.cuda.synchronize()
            launches[mode] = (ca.launches, ca.bwd_launches, dst.launches)
            record = runner.records[0]
            _, _, upd_fwd, upd_bwd = _expected_launches(cfg, run, ppo, 1)
            nb, A, T = cfg.n_block, cfg.n_agent, run.episode_length
            collect = (T * (nb + A * 2 * nb), 0) if mode == "cached" else (T * nb, T * A)
            want = (collect[0] + upd_fwd, upd_bwd, collect[1])
            it = record["step_time_collect"] + record["step_time_train"]
            say(f"[phase 7] {mode} iteration ({cfg.n_agent} agents, action {cfg.action_dim}, E "
                f"{run.n_rollout_threads}, T {T}): collect {record['step_time_collect']:.3f}s, "
                f"update {record['step_time_train']:.3f}s ({record['step_time_train'] / it:.1%} of "
                f"{it:.3f}s), fps {record['fps']:.1f}; avg_r {record['average_step_rewards']:.4f}, "
                f"value_loss {record['value_loss']:.4f}, policy_loss {record['policy_loss']:.3g}, "
                f"entropy {record['dist_entropy']:.4f}; attention_fwd / attention_bwd / "
                f"decode_step launches {launches[mode]} (expected {want})")
            if launches[mode] != want:
                raise AssertionError(f"{mode} iteration launched {launches[mode]}, expected {want}")
            if not all(math.isfinite(v) for v in record.values()):
                raise AssertionError(f"{mode} iteration metrics not finite: {record}")
            if mode == "cached":
                card = _match_cpu_update(torch, runner, ppo, train_state, rollout_state,
                                         tag="phase 7")
                if card != (upd_fwd, upd_bwd):
                    raise AssertionError(f"one update launched {card}, expected "
                                         f"{(upd_fwd, upd_bwd)}")
    torch.cuda.synchronize()
    return launches


def phase8_probe(torch):
    """The cache-layout probe; returns ``(rows, verdicts, launches)``."""
    from mat_dcml_tpu_torch.probes import cache_layout

    cache_layout.launches = 0
    rows, verdicts = cache_layout.run(log=lambda m: say(f"[phase 8] {m}"))
    torch.cuda.synchronize()
    return rows, verdicts, cache_layout.launches


def _state_diff(torch, a, b, what):
    """``(bit-for-bit equal, max |a - b| over the floating tensors)`` of two
    training states (nested dicts of tensors and plain values)."""
    equal, worst = True, 0.0

    def walk(x, y, path):
        nonlocal equal, worst
        if isinstance(x, dict):
            if x.keys() != y.keys():
                raise AssertionError(f"{what}: keys differ at {path}")
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, (u, v) in enumerate(zip(x, y, strict=True)):
                walk(u, v, f"{path}/{i}")
        elif isinstance(x, torch.Tensor):
            u, v = x.detach().cpu(), y.detach().cpu()
            if u.shape != v.shape or u.dtype != v.dtype:
                raise AssertionError(f"{what}: {path} {u.shape}/{u.dtype} vs {v.shape}/{v.dtype}")
            if not torch.equal(u, v):
                equal = False
                if u.is_floating_point():
                    worst = max(worst, float((u - v).abs().max()))
        elif x != y:
            raise AssertionError(f"{what}: {path} {x!r} != {y!r}")

    walk(a, b, "")
    return equal, worst


def _stride_passes(cfg, stride):
    """Teacher-forced decoder passes of one stride decode: agent 0, the
    blocks of ``stride`` discrete agents, then the tail one by one."""
    nd = cfg.n_discrete_agents
    return 1 + -(-(nd - 1) // stride) + (cfg.n_agent - nd)


def phase9_checkpoint(torch, card):
    """Checkpoint, resume, export, evaluate at full DCML width with the
    recipe (E 8, T 50, 15 x 4 minibatches), scan decode, f32, a checkpoint
    every episode.  Returns ``{path: (attention_fwd, attention_bwd,
    ar_decode, decode_step) launches}`` for the new paths and the phase's
    readings."""
    import math
    import os
    import shutil
    import signal
    import statistics
    import tempfile
    from pathlib import Path

    import numpy as np

    from mat_dcml_tpu_torch import export_policy as export_cli
    from mat_dcml_tpu_torch import sweep_dcml
    from mat_dcml_tpu_torch.config import RunConfig
    from mat_dcml_tpu_torch.models.policy import TransformerPolicy
    from mat_dcml_tpu_torch.ops import ar_decode as ard
    from mat_dcml_tpu_torch.ops import cuda_attention as ca
    from mat_dcml_tpu_torch.ops import decode_step as dst
    from mat_dcml_tpu_torch.serving.engine import DecodeEngine, EngineConfig
    from mat_dcml_tpu_torch.training import checkpoint as ckpt
    from mat_dcml_tpu_torch.training.ppo import PPOConfig
    from mat_dcml_tpu_torch.training.resilience import EXIT_PREEMPTED, to_host
    from mat_dcml_tpu_torch.training.runner import DCMLRunner

    tag = "[phase 9]"
    ppo = PPOConfig()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    blocking_s, write_s, kept = [], [], {}

    def runner(name, log=None, **kw):
        run = RunConfig(seed=SEED, decode_mode="scan", log_interval=1, save_interval=1,
                        num_env_steps=RESUME_EPISODES * 50 * 8, run_dir=str(root / name), **kw)
        return DCMLRunner(run, ppo, log_fn=log or (lambda m: say(f"{tag} {name}: {m}")))

    def timed_saves(r):
        """Record each save's blocking time, each write's time, and a host
        copy of the state saved at episode 1."""
        mgr, save, write = r.ckpt, r.ckpt.save, r.ckpt._write_step

        def timed_save(step, state, blocking=False):
            save(step, state, blocking)
            blocking_s.append(mgr.last_blocking_s)
            if step == 1:
                kept[1] = to_host(state)

        def timed_write(step, snapshot):
            t0 = time.perf_counter()
            write(step, snapshot)
            write_s.append(time.perf_counter() - t0)

        mgr.save, mgr._write_step = timed_save, timed_write

    def final(r, state):
        torch.cuda.synchronize()
        return {**r.trainer.state_dict(state), "generator": r.generator.get_state()}

    def launches():
        return ca.launches, ca.bwd_launches, ard.launches, dst.launches

    def zero():
        ca.launches = ca.bwd_launches = ard.launches = dst.launches = 0

    try:
        # (a) two uninterrupted runs from one seed
        ref = runner("a1")
        cfg = ref.policy.cfg
        say(f"{tag} recipe: {cfg.n_agent} agents, n_embd {cfg.n_embd}, {cfg.n_block} blocks, "
            f"{cfg.n_head} heads, E {ref.run_cfg.n_rollout_threads}, T "
            f"{ref.run_cfg.episode_length}, {ppo.ppo_epoch} epochs x {ppo.num_mini_batch} "
            f"minibatches (uncut), scan decode, f32, {RESUME_EPISODES} episodes, a checkpoint "
            "every episode")
        timed_saves(ref)
        t0 = time.perf_counter()
        ref_state, _ = ref.train_loop()
        ref_final = final(ref, ref_state)
        say(f"{tag} (a) run 1: {RESUME_EPISODES} episodes in {time.perf_counter() - t0:.2f}s")
        twin = runner("a2")
        twin_state, _ = twin.train_loop()
        deterministic, spread = _state_diff(torch, final(twin, twin_state), ref_final, "(a)")
        say(f"{tag} (a) two runs from seed {SEED}: every weight, Adam moment and step, the "
            f"ValueNorm and the generator bit for bit equal: {deterministic} (max |diff| "
            f"{spread:.3g})")

        # (b) 2 episodes, SIGTERM after episode 1, emergency checkpoint, exit
        # 75, then resume="auto" for the last episode
        def sigterm_after_1(m):
            say(f"{tag} b: {m}")
            if m.startswith("ep 1 "):
                os.kill(os.getpid(), signal.SIGTERM)

        torch.cuda.synchronize()
        zero()
        stopped = runner("b", log=sigterm_after_1)
        try:
            stopped.train_loop()
            raise AssertionError("(b) the run did not stop on SIGTERM")
        except SystemExit as e:
            if e.code != EXIT_PREEMPTED:
                raise AssertionError(f"(b) exit code {e.code}, expected {EXIT_PREEMPTED}")
        if not stopped.stop.stop_requested or stopped.ckpt.all_steps() != [0, 1]:
            raise AssertionError(f"(b) stop flag {stopped.stop.stop_requested}, steps "
                                 f"{stopped.ckpt.all_steps()}")
        t0 = time.perf_counter()
        resumed = runner("b", resume="auto")
        res_state, res_rollout = resumed.setup()
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        if resumed.start_episode != RESUME_EPISODES - 1:
            raise AssertionError(f"(b) resumed at episode {resumed.start_episode}")
        resumed.train_loop(train_state=res_state, rollout_state=res_rollout)
        torch.cuda.synchronize()
        paths = {"resume": launches()}
        equal, diff = _state_diff(torch, final(resumed, res_state), ref_final, "(b)")
        if deterministic and not equal:
            raise AssertionError(f"(b) the resumed run differs from the uninterrupted one by "
                                 f"{diff:.3g} on a deterministic card")
        if not deterministic and not diff <= spread:
            raise AssertionError(f"(b) resumed run differs by {diff:.3g} > (a)'s spread "
                                 f"{spread:.3g}")
        clock = ("fps", "step_time_collect", "step_time_train")
        recs_equal = [{k: v for k, v in r.items() if k not in clock}
                      for r in stopped.records + resumed.records] == [
            {k: v for k, v in r.items() if k not in clock} for r in ref.records]
        if deterministic and not recs_equal:
            raise AssertionError("(b) the resumed run's metrics records differ")
        it = RESUME_EPISODES
        nb, T = cfg.n_block, ref.run_cfg.episode_length
        _, _, upd_fwd, upd_bwd = _expected_launches(cfg, ref.run_cfg, ppo, 1)
        want = (it * (T * nb + upd_fwd), it * upd_bwd, it * T, 0)
        if paths["resume"] != want:
            raise AssertionError(f"(b) launches {paths['resume']}, expected {want}")
        say(f"{tag} (b) 2 episodes, SIGTERM, emergency checkpoint, exit {EXIT_PREEMPTED}, "
            f"resume='auto' at episode {resumed.start_episode} (runner built and restored in "
            f"{resume_s:.3f}s): "
            f"equal to the uninterrupted run bit for bit: {equal} (max |diff| {diff:.3g}); "
            f"metrics records (but their clock fields) equal: {recs_equal}; launches "
            f"fwd/bwd/ar_decode/decode_step {paths['resume']}")

        # (c) restore step 1 into a fresh runner; a planted corrupt step
        fresh = runner("c")
        t0 = time.perf_counter()
        state = fresh.trainer.load_state_dict(fresh.trainer.init_state(),
                                              ckpt.CheckpointManager(ref.ckpt.directory,
                                                                     device="cuda").restore(1))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        equal, diff = _state_diff(torch, fresh.trainer.state_dict(state), kept[1], "(c)")
        if not equal:
            raise AssertionError(f"(c) restored step 1 differs from what was saved by {diff:.3g}")
        models = twin.ckpt.directory
        payload = models / str(RESUME_EPISODES - 1) / "state.pt"
        data = bytearray(payload.read_bytes())
        data[len(data) // 2] ^= 0xFF
        payload.write_bytes(bytes(data))
        step, _ = ckpt.CheckpointManager(models, device="cuda",
                                         log=lambda m: say(f"{tag} c: {m}")).restore_latest_valid()
        quarantined = [p.name for p in (models / "quarantine").iterdir()]
        if step != RESUME_EPISODES - 2 or len(quarantined) != 1:
            raise AssertionError(f"(c) planted fault: restored step {step}, quarantined "
                                 f"{quarantined}")
        say(f"{tag} (c) step 1 restored into a fresh runner in {restore_s:.3f}s: every tensor "
            f"of the training state equal to what was saved, bit for bit; planted fault (a "
            f"byte of step {RESUME_EPISODES - 1}'s payload flipped): quarantined "
            f"{quarantined[0]}, restored step {step}")

        # (d) export, serve the export on the card
        out = root / "exports" / "gen1"
        if export_cli.main(["--model_dir", str(ref.ckpt.directory), "--out", str(out)]) != 0:
            raise AssertionError("(d) export failed")
        ecfg = EngineConfig(buckets=(1, 8), decode_mode="scan")
        quiet = lambda *_: None   # noqa: E731
        eng = DecodeEngine.from_export(out, ecfg, log_fn=quiet)
        live = DecodeEngine(ref.policy.model.state_dict(), cfg, ecfg, log_fn=quiet)
        cpu_eng = DecodeEngine.from_export(out, ecfg, log_fn=quiet, device="cpu")
        state_, obs_, avail_ = _requests(cfg, 8, seed=SEED + 9)
        a, lp = eng.decode(state_, obs_, avail_)
        b, lq = live.decode(state_, obs_, avail_)
        if not (np.array_equal(a, b) and np.array_equal(lp, lq)):
            raise AssertionError("(d) the export's engine differs from the in-memory weights'")
        c_act, c_logp = cpu_eng.decode(state_, obs_, avail_)
        scores = _teacher_scores(torch, cfg, ref.policy.model.state_dict(), state_, obs_,
                                 avail_, c_act)
        worst, flips = _agree(a[..., 0], lp[..., 0], c_act[..., 0], c_logp[..., 0], scores,
                              cfg.n_discrete_agents, LOGP_ATOL_VS_CPU, "(d) export card vs CPU")
        say(f"{tag} (d) export (generation {ckpt.read_manifest(out)['generation']}, space_meta "
            f"{sorted(eng.space_meta)}) served by DecodeEngine.from_export on the card: bucket 8 "
            f"scan equal bit for bit to the in-memory weights' engine; vs the port on the CPU "
            f"max|logp diff| {worst:.3g} (tol {LOGP_ATOL_VS_CPU}), near-tie rows {flips}")

        # (e) evaluate, scan and stride
        torch.cuda.synchronize()
        zero()
        info_scan = ref.evaluate(n_steps=EVAL_STEPS)
        torch.cuda.synchronize()
        paths["eval_scan"] = launches()
        want = ((EVAL_STEPS + 1) * nb, 0, EVAL_STEPS + 1, 0)
        if paths["eval_scan"] != want:
            raise AssertionError(f"(e) scan eval launches {paths['eval_scan']}, expected {want}")
        zero()
        info_stride = ref.evaluate(n_steps=EVAL_STEPS, stride=EVAL_STRIDE)
        torch.cuda.synchronize()
        paths["eval_stride"] = launches()
        per_call = nb + _stride_passes(cfg, EVAL_STRIDE) * 2 * nb
        want = ((EVAL_STEPS + 1) * per_call, 0, 0, 0)
        if paths["eval_stride"] != want:
            raise AssertionError(f"(e) stride eval launches {paths['eval_stride']}, "
                                 f"expected {want}")
        for name, info in (("scan", info_scan), ("stride", info_stride)):
            if not all(math.isfinite(v) for v in info.values()):
                raise AssertionError(f"(e) {name} eval metrics not finite: {info}")
            say(f"{tag} (e) evaluate {name}, {EVAL_STEPS} steps: " + ", ".join(
                f"{k} {v:.6g}" for k, v in info.items()))
        env = ref.env
        _, ts = env.reset(env.draw_reset(8, torch.Generator(device="cuda").manual_seed(SEED)))
        with torch.no_grad():
            card_out = ref.policy.act_stride(ts.share_obs, ts.obs, ts.available_actions,
                                             stride=EVAL_STRIDE)
        cpu_policy = TransformerPolicy(cfg, device="cpu")
        cpu_policy.model.load_state_dict({k: v.cpu() for k, v in
                                          ref.policy.model.state_dict().items()})
        host = [x.cpu() for x in (ts.share_obs, ts.obs, ts.available_actions)]
        with torch.no_grad():
            cpu_out = cpu_policy.act_stride(*host, stride=EVAL_STRIDE)
        c_act = cpu_out.action.numpy()
        scores = _teacher_scores(torch, cfg, cpu_policy.model.state_dict(),
                                 *(x.numpy() for x in host), c_act)
        worst, flips = _agree(card_out.action.cpu().numpy()[..., 0],
                              card_out.log_prob.cpu().numpy()[..., 0], c_act[..., 0],
                              cpu_out.log_prob.numpy()[..., 0], scores, cfg.n_discrete_agents,
                              LOGP_ATOL_VS_CPU, "(e) act_stride card vs CPU")
        say(f"{tag} (e) act_stride (stride {EVAL_STRIDE}) on 8 env states, card vs the port on "
            f"the CPU: max|logp diff| {worst:.3g} (tol {LOGP_ATOL_VS_CPU}), near-tie rows {flips}")

        # (f) the sweep from the export
        torch.cuda.synchronize()
        zero()
        records = sweep_dcml.main([
            "--model_dir", str(out), "--n_iter", str(SWEEP_SETTINGS), "--n_steps",
            str(SWEEP_STEPS), "--stride", str(EVAL_STRIDE), "--sample", "1",
            "--out", str(root / "sweep")])
        torch.cuda.synchronize()
        paths["sweep"] = launches()
        want = (SWEEP_SETTINGS * SWEEP_STEPS * per_call, 0, 0, 0)
        if paths["sweep"] != want:
            raise AssertionError(f"(f) sweep launches {paths['sweep']}, expected {want}")
        with open(root / "sweep.npy", "rb") as f:
            cts, pays = np.load(f), np.load(f)
        if (cts.shape, pays.shape) != ((SWEEP_SETTINGS, 1),) * 2 or not (
                np.isfinite(cts).all() and np.isfinite(pays).all()):
            raise AssertionError(f"(f) sweep output {cts}, {pays}")
        walls = [r["wall_s"] for r in records]
        say(f"{tag} (f) sweep from the export on Sample_1: {SWEEP_SETTINGS} settings x "
            f"{SWEEP_STEPS} steps at stride {EVAL_STRIDE}: ct {cts[:, 0].tolist()}, payment "
            f"{pays[:, 0].tolist()}")

        readings = {
            "save_blocking_ms": [round(s * 1e3, 3) for s in blocking_s],
            "save_write_ms": [round(s * 1e3, 3) for s in write_s],
            "resume_setup_s": resume_s,
            "restore_s": restore_s,
            "eval_inference_sec_per_call_scan": info_scan["eval_inference_sec_per_call"],
            "eval_inference_sec_per_call_stride": info_stride["eval_inference_sec_per_call"],
            "sweep_wall_s_per_setting": walls,
            "deterministic": deterministic,
            "spread": spread,
            "card": card,
        }
        say(f"{tag} times on {card}: save blocking (what the loop pays) median "
            f"{statistics.median(blocking_s) * 1e3:.3f} ms, max {max(blocking_s) * 1e3:.3f} ms "
            f"over {len(blocking_s)} saves; write median {statistics.median(write_s) * 1e3:.3f} "
            f"ms, max {max(write_s) * 1e3:.3f} ms; restore {restore_s * 1e3:.3f} ms; "
            f"eval_inference_sec_per_call scan {info_scan['eval_inference_sec_per_call']:.6f}, "
            f"stride {info_stride['eval_inference_sec_per_call']:.6f}; sweep wall per setting "
            + ", ".join(f"{w:.3f}s" for w in walls))
        return paths, readings
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _expect_device(device, what):
    if device.type != "cuda":
        raise AssertionError(f"{what}: runner defaulted to {device}")


def _expect_launches(got, want, what):
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def _mo_expected(cfg, run, ppo, iters=1):
    """``(attention_fwd, attention_bwd, ar_decode, decode_step)`` launches of
    ``iters`` scan-mode iterations and ``(fwd, bwd)`` of one update.  MO-MAT
    and DMO-MAT launch as MAT does (phase 5's scan iteration).  MAT-Dec has
    no decoder trunk: a collect step is the encoder's n_block forward
    launches and no ``ar_decode``; an update, per epoch the target
    recompute's n_block, per minibatch n_block forward and n_block backward
    (the encoder's blocks; the MLP actor has no attention)."""
    nb, T = cfg.n_block, run.episode_length
    if cfg.dec_actor:
        upd = (ppo.ppo_epoch * (nb + ppo.num_mini_batch * nb),
               ppo.ppo_epoch * ppo.num_mini_batch * nb)
        return (iters * (T * nb + upd[0]), iters * upd[1], 0, 0), upd
    _, _, upd_fwd, upd_bwd = _expected_launches(cfg, run, ppo, 1)
    return (iters * (T * nb + upd_fwd), iters * upd_bwd, iters * T, 0), (upd_fwd, upd_bwd)


def phase10_mat_family(torch, card, deterministic, spread):
    """The rest of the DCML MAT family at full width (101 agents, n_embd 64,
    2 blocks, 2 heads, f32) with the recipe uncut (E 8, T 50, 15 x 4
    minibatches), scan decode: one iteration each of ``momat``, ``dmomat``
    and ``mat_dec``, and one ``momat`` iteration with lr decay, weight decay
    1e-4 and ``mo_combined_norm`` false, each with its launches counted
    exactly and one more update matched against the CPU port; a ``dmomat``
    run stopped by SIGTERM after its first episode and resumed, against the
    uninterrupted 2-episode run (bit for bit where phase 9 (a) found the
    card deterministic, else within its spread); the ``dmomat`` export
    served at bucket 8, equal to the in-memory weights' engine bit for bit.
    Returns ``{path: (attention_fwd, attention_bwd, ar_decode, decode_step)
    launches}`` and the phase's readings."""
    import math
    import os
    import shutil
    import signal
    import tempfile
    from pathlib import Path

    import numpy as np

    from mat_dcml_tpu_torch import export_policy as export_cli
    from mat_dcml_tpu_torch.config import RunConfig
    from mat_dcml_tpu_torch.ops import ar_decode as ard
    from mat_dcml_tpu_torch.ops import cuda_attention as ca
    from mat_dcml_tpu_torch.ops import decode_step as dst
    from mat_dcml_tpu_torch.serving.engine import DecodeEngine, EngineConfig
    from mat_dcml_tpu_torch.training.ppo import PPOConfig
    from mat_dcml_tpu_torch.training.resilience import EXIT_PREEMPTED
    from mat_dcml_tpu_torch.training.runner import DCMLRunner

    tag = "[phase 10]"
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_mo_"))
    paths, readings = {}, {"card": card}

    def launches():
        return ca.launches, ca.bwd_launches, ard.launches, dst.launches

    def zero():
        ca.launches = ca.bwd_launches = ard.launches = dst.launches = 0

    def runner(name, algo, ppo, log=None, episodes=1, **kw):
        kw.setdefault("num_env_steps", episodes * 50 * 8)
        run = RunConfig(seed=SEED, algorithm_name=algo, decode_mode="scan", log_interval=1,
                        run_dir=str(root / name), **kw)
        return DCMLRunner(run, ppo, log_fn=log or (lambda m: say(f"{tag} {name}: {m}")))

    def final(r, state):
        torch.cuda.synchronize()
        return {**r.trainer.state_dict(state), "generator": r.generator.get_state()}

    try:
        # the lr-decay run keeps the recipe's 1M steps, so its schedule
        # (episodes = 2,500 Adam steps, ``training/ppo.py::MATTrainer.lr_at``)
        # is still falling in the checked update
        iterations = (("momat", "momat", PPOConfig(), {}),
                      ("dmomat", "dmomat", PPOConfig(), {}),
                      ("mat_dec", "mat_dec", PPOConfig(), {}),
                      ("momat_lr_decay", "momat",
                       PPOConfig(use_linear_lr_decay=True, weight_decay=1e-4,
                                 mo_combined_norm=False),
                       {"num_env_steps": RunConfig().num_env_steps}))
        for name, algo, ppo, kw in iterations:
            r = runner(name, algo, ppo, **kw)
            cfg = r.policy.cfg
            _expect_device(r.device, name)
            train_state, rollout_state = r.setup()
            torch.cuda.synchronize()
            zero()
            train_state, rollout_state = r.train_loop(1, train_state, rollout_state)
            torch.cuda.synchronize()
            paths[f"training_{name}"] = launches()
            want, upd = _mo_expected(cfg, r.run_cfg, ppo)
            rec = r.records[0]
            it = rec["step_time_collect"] + rec["step_time_train"]
            say(f"{tag} {name} ({algo}: obs {cfg.obs_dim}, state {cfg.state_dim}, n_objective "
                f"{cfg.n_objective}, dec_actor {cfg.dec_actor}, share_actor {cfg.share_actor}; "
                f"lr decay {ppo.use_linear_lr_decay}, weight decay {ppo.weight_decay}, "
                f"mo_combined_norm {ppo.mo_combined_norm}) scan iteration on {card}: collect "
                f"{rec['step_time_collect']:.3f}s, update {rec['step_time_train']:.3f}s "
                f"({rec['step_time_train'] / it:.1%} of {it:.3f}s); launches fwd/bwd/ar_decode/"
                f"decode_step {paths[f'training_{name}']} (expected {want})")
            _expect_launches(paths[f"training_{name}"], want, name)
            if not all(math.isfinite(v) for v in rec.values()):
                raise AssertionError(f"{name}: metrics not finite: {rec}")
            objectives = [f"average_step_objective_{i}" for i in range(cfg.n_objective)]
            if cfg.n_objective > 1 and not all(k in rec for k in objectives):
                raise AssertionError(f"{name}: no per-objective records in {sorted(rec)}")
            say(f"{tag} {name} record: " + ", ".join(f"{k} {rec[k]:.6g}" for k in (
                "average_step_rewards", *(objectives if cfg.n_objective > 1 else ()),
                "value_loss", "policy_loss", "dist_entropy", "grad_norm")))
            readings[name] = {"collect_s": rec["step_time_collect"],
                              "update_s": rec["step_time_train"],
                              "lr_after": train_state.optimizer.param_groups[0]["lr"]}
            card_launches = _match_cpu_update(torch, r, ppo, train_state, rollout_state,
                                              tag=f"phase 10 {name}")
            _expect_launches(card_launches, upd, f"{name}'s update")
            torch.cuda.synchronize()

        # dmomat: 2 uninterrupted episodes; 1, SIGTERM, the emergency carry
        # (the preference weights with it), exit 75, resume="auto" for the 2nd
        ppo = PPOConfig()
        ref = runner("dmomat_ref", "dmomat", ppo, episodes=2, save_interval=1)
        ref_state, ref_rollout = ref.train_loop()
        ref_final = final(ref, ref_state)

        def sigterm_after_0(m):
            say(f"{tag} dmomat_stop: {m}")
            if m.startswith("ep 0 "):
                os.kill(os.getpid(), signal.SIGTERM)

        torch.cuda.synchronize()
        zero()
        stopped = runner("dmomat_stop", "dmomat", ppo, log=sigterm_after_0, episodes=2,
                         save_interval=1)
        try:
            stopped.train_loop()
            raise AssertionError("dmomat: the run did not stop on SIGTERM")
        except SystemExit as e:
            if e.code != EXIT_PREEMPTED:
                raise AssertionError(f"dmomat: exit code {e.code}, expected {EXIT_PREEMPTED}")
        resumed = runner("dmomat_stop", "dmomat", ppo, episodes=2, save_interval=1,
                         resume="auto")
        res_state, res_rollout = resumed.setup()
        if resumed.start_episode != 1:
            raise AssertionError(f"dmomat: resumed at episode {resumed.start_episode}")
        res_state, res_rollout = resumed.train_loop(train_state=res_state,
                                                    rollout_state=res_rollout)
        torch.cuda.synchronize()
        paths["resume_dmomat"] = launches()
        want, _ = _mo_expected(ref.policy.cfg, ref.run_cfg, ppo, iters=2)
        _expect_launches(paths["resume_dmomat"], want, "dmomat resume")
        equal, diff = _state_diff(torch, final(resumed, res_state), ref_final, "dmomat resume")
        coefs_equal = torch.equal(res_rollout.objective_coefficients,
                                  ref_rollout.objective_coefficients)
        if deterministic and not (equal and coefs_equal):
            raise AssertionError(f"dmomat: the resumed run differs from the uninterrupted one "
                                 f"by {diff:.3g} (weights {equal}, preference weights "
                                 f"{coefs_equal}) on a deterministic card")
        if not deterministic and not diff <= spread:
            raise AssertionError(f"dmomat: resumed run differs by {diff:.3g} > phase 9 (a)'s "
                                 f"spread {spread:.3g}")
        say(f"{tag} dmomat: 1 episode, SIGTERM, emergency checkpoint, exit {EXIT_PREEMPTED}, "
            f"resume='auto' at episode {resumed.start_episode}: equal to the uninterrupted "
            f"2-episode run bit for bit: {equal} (max |diff| {diff:.3g}), preference weights "
            f"equal: {coefs_equal}; launches fwd/bwd/ar_decode/decode_step "
            f"{paths['resume_dmomat']} (expected {want})")
        readings["dmomat_resume_equal"] = bool(equal and coefs_equal)

        # the dmomat export, served at the widened width
        out = root / "exports" / "dmomat"
        if export_cli.main(["--algorithm_name", "dmomat", "--model_dir",
                            str(ref.ckpt.directory), "--out", str(out)]) != 0:
            raise AssertionError("dmomat: export failed")
        ecfg = EngineConfig(buckets=(1, 8), decode_mode="scan")
        quiet = lambda *_: None   # noqa: E731
        torch.cuda.synchronize()
        zero()
        eng = DecodeEngine.from_export(out, ecfg, log_fn=quiet)
        live = DecodeEngine(ref.policy.model.state_dict(), ref.policy.cfg, ecfg, log_fn=quiet)
        eng.warmup()
        live.warmup()
        state_, obs_, avail_ = _requests(eng.cfg, 8, seed=SEED + 10)
        a, lp = eng.decode(state_, obs_, avail_)
        b, lq = live.decode(state_, obs_, avail_)
        torch.cuda.synchronize()
        paths["serving_dmomat_export"] = launches()
        nb = eng.cfg.n_block
        want = (6 * nb, 0, 6, 0)   # two engines: a decode a bucket to warm up, then bucket 8
        _expect_launches(paths["serving_dmomat_export"], want, "dmomat serving")
        _check_actions(eng.cfg, a, lp)
        if (eng.cfg.obs_dim, eng.cfg.state_dim) != (9, 104):
            raise AssertionError(f"dmomat export widths {eng.cfg.obs_dim}, {eng.cfg.state_dim}")
        if not (np.array_equal(a, b) and np.array_equal(lp, lq)):
            raise AssertionError("dmomat: the export's engine differs from the in-memory one")
        say(f"{tag} dmomat export (obs {eng.cfg.obs_dim}, state {eng.cfg.state_dim} from the "
            f"manifest) served by DecodeEngine.from_export on the card: bucket 8 scan equal "
            f"bit for bit to the in-memory weights' engine; launches "
            f"{paths['serving_dmomat_export']} (expected {want})")
        return paths, readings
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _smac_masks(torch, env, E, seed, steps=3, dead_share=0.2):
    """``(state, obs, avail)`` of ``env`` (SMAC-lite, or its multi-map
    translation) on the card: E fresh battles, ``steps`` steps of every
    ally moving east (so attacks come into range), then a share of the
    allies killed, observed again (a dead ally's row: the no-op alone)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = getattr(env, "env", env)
    st, _ = env.reset(env.draw_reset(E, g))
    east = torch.full((E, env.n_agents, 1), 4.0, device="cuda")
    for _ in range(steps):
        st, _ = env.step(st, east, env.draw_step(E, g))
    kill = torch.rand(st.ally_hp.shape, generator=g, device="cuda") < dead_share
    st = st._replace(ally_hp=torch.where(kill, 0.0, st.ally_hp))
    obs, share, avail = base._observe(st)
    if base is not env:
        obs, share, avail = (env._translate_obs(obs), env._translate_state(share),
                             env._translate_avail(avail))
    return share, obs, avail


def _smac_configs():
    """MAT at SMAC's widths (n_embd 64, 2 blocks, 2 heads, discrete): 8m and
    the multi-map layout."""
    from mat_dcml_tpu_torch.envs.smac.smaclite import SMACLiteConfig, SMACLiteEnv
    from mat_dcml_tpu_torch.envs.smac.translation import TranslatedSMACEnv
    from mat_dcml_tpu_torch.models.mat import MATConfig

    out = {}
    for name, env in (("8m", SMACLiteEnv(SMACLiteConfig("8m"), device="cpu")),
                      ("multi", TranslatedSMACEnv(SMACLiteConfig("8m"), device="cpu"))):
        out[name] = MATConfig(n_agent=env.n_agents, obs_dim=env.obs_dim,
                              state_dim=env.share_obs_dim, action_dim=env.action_dim,
                              n_block=2, n_embd=64, n_head=2, action_type="discrete")
    return out


def phase11_kernels(torch):
    """(b) The three kernels of the SMAC paths against their plain versions
    at SMAC's shapes, f32 and bf16: attention forward and backward at the
    update's (3,200 and 3,600 rows x 2 heads, L 8 and 27) and the rollout's
    (32 and 36 rows; the cached decode's Lq = 1), timed in phase 2;
    ar_decode at the rollout's batch (B 32, A 8, adim 14; B 36, A 27, adim
    36) with the env's own masks, every action it draws available, its f32
    leg timed beside its plain version and its bound."""
    import dataclasses

    from mat_dcml_tpu_torch.envs.smac.smaclite import SMACLiteConfig, SMACLiteEnv
    from mat_dcml_tpu_torch.envs.smac.translation import TranslatedSMACEnv
    from mat_dcml_tpu_torch.ops import ar_decode as ard
    from mat_dcml_tpu_torch.ops import cuda_attention as ca
    from mat_dcml_tpu_torch.ops.distributions import gumbel_noise

    tag = "[phase 11 (b)]"
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    H, Dh = 2, 32
    ar_shapes, errs = {}, {}
    cases = (("8m_update", SMAC_E * SMAC_T, 8, 8, False, None),
             ("8m_update_causal", SMAC_E * SMAC_T, 8, 8, True, None),
             ("8m_rollout", SMAC_E, 8, 8, False, None),
             ("8m_decode_i3", SMAC_E, 1, 8, False, torch.arange(8, device=dev) <= 3),
             ("multi_update", MULTI_E * SMAC_T, 27, 27, False, None),
             ("multi_update_causal", MULTI_E * SMAC_T, 27, 27, True, None),
             ("multi_rollout", MULTI_E, 27, 27, False, None),
             ("multi_decode_i13", MULTI_E, 1, 27, False, torch.arange(27, device=dev) <= 13))
    for label, B, lq, lk, causal, mask in cases:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            q, k, v = (torch.randn(B, H, n, Dh, generator=g, device=dev).to(dtype)
                       for n in (lq, lk, lk))
            out = ca.fused_masked_attention(q, k, v, causal=causal, kv_mask=mask)
            torch.cuda.synchronize()
            ref = ca.attention_plain(q, k, v, causal=causal, kv_mask=mask).float()
            err = (out.float() - ref).abs().max().item()
            fscale = max(1.0, ref.abs().max().item())
            errs[("fwd", label, name)] = err
            if not err <= TOL[name] * fscale:
                raise AssertionError(f"attention_fwd {label} {name}: error {err} > {TOL[name]} "
                                     f"x {fscale}")
            if lq > 1:
                do = torch.randn_like(q)
                grads = ca.attention_bwd(q, k, v, do, causal=causal)
                torch.cuda.synchronize()
                refs = ca.attention_bwd_plain(q, k, v, do, causal=causal)
                scale = max(1.0, max(r.float().abs().max().item() for r in refs))
                berr = max((a.float() - b.float()).abs().max().item()
                           for a, b in zip(grads, refs))
                errs[("bwd", label, name)] = berr
                if not berr <= BWD_TOL[name] * scale:
                    raise AssertionError(f"attention_bwd {label} {name}: error {berr} > "
                                         f"{BWD_TOL[name]} x {scale}")
            say(f"{tag} attention {label} {tuple(q.shape)} k {tuple(k.shape)} {name}: forward "
                f"max|kernel - plain| {err:.3g} (tol {TOL[name]} x {fscale:.3g})"
                + (f", backward {errs[('bwd', label, name)]:.3g} (tol {BWD_TOL[name]} x the "
                   "largest gradient)" if lq > 1 else ""))

    cfgs = _smac_configs()
    envs = {"8m": (SMACLiteEnv(SMACLiteConfig("8m")), SMAC_E),
            "multi": (TranslatedSMACEnv(SMACLiteConfig("8m")), MULTI_E)}
    with torch.no_grad():
        for label, (env, B) in envs.items():
            for dtype in ("float32", "bfloat16"):
                cfg = dataclasses.replace(cfgs[label], dtype=dtype)
                weights = ard.pack_ar_decode_weights(_scaled_model(torch, cfg, SEED + 22))
                _, _, avail = _smac_masks(torch, env, B, seed=SEED + 23)
                A, adim = cfg.n_agent, cfg.action_dim
                rep = torch.randn(B, A, cfg.n_embd, generator=g, device=dev).to(cfg.trunk_dtype)
                gumbel = gumbel_noise((B, A, adim), g, dev)
                normal = torch.zeros(B, 1, adim, device=dev)
                kw = dict(n_head=cfg.n_head, adim=adim, nd=A)
                act, logp = ard.fused_ar_decode(weights, rep, gumbel, normal, avail, **kw)
                torch.cuda.synchronize()
                picked = avail.gather(-1, act.long()[..., None])
                if not (picked == 1).all():
                    raise AssertionError(f"ar_decode {label} {dtype}: an unavailable action")
                ref = ard.ar_decode_plain(weights, rep, gumbel, normal, avail,
                                          return_scores=True, **kw)
                bf16 = dtype == "bfloat16"
                err, flips = _agree(*(t.cpu().numpy() for t in (act, logp, *ref)), A,
                                    BF16_AR_TOL if bf16 else AR_LOGP_TOL,
                                    f"ar_decode {label} {dtype}",
                                    near_tie=BF16_NEAR_TIE if bf16 else NEAR_TIE)
                errs[("ar_decode", label, dtype)] = err
                plan = ard.kernel_plan(B, A, n_embd=cfg.n_embd, n_head=cfg.n_head,
                                       n_block=cfg.n_block, adim=adim, dtype=cfg.trunk_dtype)
                dead = int((avail[..., 1] == 0).sum())
                say(f"{tag} ar_decode {label} B {B} A {A} adim {adim} {dtype} on the env's masks "
                    f"({dead} dead agents, {int(avail.sum())} actions available): max|logp "
                    f"kernel - plain| {err:.3g} (tol {BF16_AR_TOL if bf16 else AR_LOGP_TOL}), "
                    f"rows diverging at a near-tie {flips}, every action available "
                    f"({_plan_words(plan)}, {plan.smem_bytes} B shared memory a CTA, "
                    f"{plan.barriers} cluster barriers a position)")
                if bf16:
                    continue
                ms, eager_ms = _time_ms(torch, lambda: ard.fused_ar_decode(
                    weights, rep, gumbel, normal, avail, **kw), iters=20)
                plain_ms, _ = _time_ms(torch, lambda: ard.ar_decode_plain(
                    weights, rep, gumbel, normal, avail, **kw), iters=2)
                bound_ms, bound_by = _ar_bound(cfg, weights, B, True)
                ar_shapes[label] = {"shape": f"obs_rep ({B}, {A}, {cfg.n_embd}) f32, adim "
                                             f"{adim}, noise, the env's masks",
                                    "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                                    "bound_ms": bound_ms, "bound_by": bound_by,
                                    "plan": _plan_words(plan)}
                say(f"{tag} time ar_decode {label} B {B}, device (eager) per call: kernel "
                    f"{ms:.3f} ({eager_ms:.3f}) ms, plain {plain_ms:.2f} ms, bound "
                    f"{bound_ms * 1e3:.2f} us ({bound_by}); L2-warm")
    torch.cuda.synchronize()
    return ar_shapes, errs


def _smac_expected(cfg, run, ppo, mode, iters=1):
    """``(attention_fwd, attention_bwd, ar_decode, decode_step)`` launches of
    ``iters`` SMAC iterations and ``(fwd, bwd)`` of one update: a collect
    step is the encoder's n_block forward launches and the decode's (cached:
    2 n_block a position; scan: one ar_decode); the update as DCML's."""
    nb, A, T = cfg.n_block, cfg.n_agent, run.episode_length
    _, _, upd_fwd, upd_bwd = _expected_launches(cfg, run, ppo, 1)
    collect = (T * (nb + A * 2 * nb), 0) if mode == "cached" else (T * nb, T)
    return ((iters * (collect[0] + upd_fwd), iters * upd_bwd, iters * collect[1], 0),
            (upd_fwd, upd_bwd))


def phase11_smac(torch, card, deterministic, spread):
    """MAT on SMAC-lite on the card (the module docstring's phase 11).
    Returns ``{path: (attention_fwd, attention_bwd, ar_decode,
    decode_step) launches}``, the phase's readings and the kernels'
    readings at SMAC's shapes."""
    import math
    import os
    import shutil
    import signal
    import tempfile
    from pathlib import Path

    import numpy as np

    from mat_dcml_tpu_torch import export_policy as export_cli
    from mat_dcml_tpu_torch.config import RunConfig
    from mat_dcml_tpu_torch.envs.smac.smaclite import SMACLiteConfig, SMACLiteEnv
    from mat_dcml_tpu_torch.ops import ar_decode as ard
    from mat_dcml_tpu_torch.ops import cuda_attention as ca
    from mat_dcml_tpu_torch.ops import decode_step as dst
    from mat_dcml_tpu_torch.serving.engine import DecodeEngine, EngineConfig
    from mat_dcml_tpu_torch.training.ppo import PPOConfig
    from mat_dcml_tpu_torch.training.resilience import EXIT_PREEMPTED
    from mat_dcml_tpu_torch.training.smac_runner import SMACMultiRunner, SMACRunner

    tag = "[phase 11]"
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_smac_"))
    paths, readings = {}, {"card": card}
    ppo_8m = PPOConfig(ppo_epoch=15, num_mini_batch=1, lr=5e-4, clip_param=0.05)

    def launches():
        return ca.launches, ca.bwd_launches, ard.launches, dst.launches

    def zero():
        torch.cuda.synchronize()
        ca.launches = ca.bwd_launches = ard.launches = dst.launches = 0

    def runner(name, mode, ppo=ppo_8m, map_name="8m", episodes=1, log=None, E=SMAC_E,
               T=SMAC_T, **kw):
        kw.setdefault("save_interval", 0)
        run = RunConfig(seed=SEED, env_name="StarCraft2", scenario=map_name, decode_mode=mode,
                        log_interval=1, run_dir=str(root / name), n_rollout_threads=E,
                        episode_length=T, num_env_steps=episodes * E * T, **kw)
        return SMACRunner(run, ppo, SMACLiteConfig(map_name),
                          log_fn=log or (lambda m: say(f"{tag} {name}: {m}")))

    def final(r, state):
        torch.cuda.synchronize()
        return {**r.trainer.state_dict(state), "generator": r.generator.get_state()}

    try:
        # (a) the 8m recipe: cached, scan, bf16 scan
        for name, mode, dtype in (("8m_cached", "cached", "float32"),
                                  ("8m_scan", "scan", "float32"),
                                  ("8m_bf16_scan", "scan", "bfloat16")):
            r = runner(name, mode, model_dtype=dtype)
            cfg = r.policy.cfg
            _expect_device(r.device, name)
            train_state, rollout_state = r.setup()
            zero()
            train_state, rollout_state = r.train_loop(1, train_state, rollout_state)
            torch.cuda.synchronize()
            paths[f"smac_{name}"] = launches()
            want, upd = _smac_expected(cfg, r.run_cfg, ppo_8m, mode)
            rec = r.records[0]
            it = rec["step_time_collect"] + rec["step_time_train"]
            say(f"{tag} {name} (8m: {cfg.n_agent} agents, obs {cfg.obs_dim}, state "
                f"{cfg.state_dim}, {cfg.action_dim} actions; E {SMAC_E}, T {SMAC_T}, "
                f"{ppo_8m.ppo_epoch} x {ppo_8m.num_mini_batch} minibatch, {cfg.dtype}) iteration "
                f"on {card}: collect {rec['step_time_collect']:.3f}s, update "
                f"{rec['step_time_train']:.3f}s ({rec['step_time_train'] / it:.1%} of "
                f"{it:.3f}s), fps {rec['fps']:.1f}; launches fwd/bwd/ar_decode/decode_step "
                f"{paths[f'smac_{name}']} (expected {want})")
            _expect_launches(paths[f"smac_{name}"], want, name)
            if not all(math.isfinite(v) for v in rec.values()):
                raise AssertionError(f"{name}: metrics not finite: {rec}")
            say(f"{tag} {name} record: " + ", ".join(
                f"{k} {rec[k]:.6g}" for k in ("average_step_rewards", "win_rate", "dead_ratio",
                                              "value_loss", "policy_loss", "dist_entropy",
                                              "grad_norm") if k in rec))
            readings[name] = {"collect_s": rec["step_time_collect"],
                              "update_s": rec["step_time_train"], "fps": rec["fps"]}
            if dtype == "float32":
                card_launches = _match_cpu_update(torch, r, ppo_8m, train_state, rollout_state,
                                                  tag=f"phase 11 {name}")
                _expect_launches(card_launches, upd, f"{name}'s update")
            if mode == "scan" and dtype == "float32":
                # (c) evaluation: deterministic battles until 32 have ended
                zero()
                t0 = time.perf_counter()
                info = r.evaluate(n_episodes=32)
                torch.cuda.synchronize()
                eval_s = time.perf_counter() - t0
                paths["smac_eval_8m_scan"] = got = launches()
                if not (got[2] > 0 and got[0] == cfg.n_block * got[2] and got[1] == 0
                        and info["eval_episodes"] >= 32):
                    raise AssertionError(f"8m evaluation: {info}, launches {got}")
                say(f"{tag} (c) 8m evaluation (scan, E {SMAC_E}): {info} in {eval_s:.2f}s, "
                    f"{got[2]} steps (one ar_decode launch and {cfg.n_block} attention "
                    f"launches a step)")
                readings["eval_8m"] = {**info, "seconds": eval_s, "steps": got[2]}
        readings["a_c_seconds"] = time.perf_counter() - t_phase
        say(f"{tag} [time] (a), (c) done at {readings['a_c_seconds']:.1f}s of the phase")

        # (d) stop and resume: 2 episodes against 1, SIGTERM, resume 1
        ref = runner("resume_ref", "scan", episodes=2, save_interval=1)
        ref_state, ref_rollout = ref.train_loop()
        ref_final = final(ref, ref_state)

        def sigterm_after_0(m):
            say(f"{tag} resume_stop: {m}")
            if m.startswith("ep 0 "):
                os.kill(os.getpid(), signal.SIGTERM)

        zero()
        stopped = runner("resume_stop", "scan", episodes=2, save_interval=1, log=sigterm_after_0)
        try:
            stopped.train_loop()
            raise AssertionError("smac: the run did not stop on SIGTERM")
        except SystemExit as e:
            if e.code != EXIT_PREEMPTED:
                raise AssertionError(f"smac: exit code {e.code}, expected {EXIT_PREEMPTED}")
        resumed = runner("resume_stop", "scan", episodes=2, save_interval=1, resume="auto")
        res_state, res_rollout = resumed.setup()
        if resumed.start_episode != 1:
            raise AssertionError(f"smac: resumed at episode {resumed.start_episode}")
        res_state, res_rollout = resumed.train_loop(train_state=res_state,
                                                    rollout_state=res_rollout)
        torch.cuda.synchronize()
        paths["smac_resume_8m"] = launches()
        want, _ = _smac_expected(ref.policy.cfg, ref.run_cfg, ppo_8m, "scan", iters=2)
        _expect_launches(paths["smac_resume_8m"], want, "smac resume")
        equal, diff = _state_diff(torch, final(resumed, res_state), ref_final, "smac resume")
        env_equal = all(torch.equal(a, b) for a, b in zip(res_rollout.env_states,
                                                          ref_rollout.env_states))
        if deterministic and not (equal and env_equal):
            raise AssertionError(f"smac: the resumed run differs from the uninterrupted one by "
                                 f"{diff:.3g} (battles equal: {env_equal}) on a deterministic "
                                 "card")
        if not deterministic and not diff <= spread:
            raise AssertionError(f"smac: resumed run differs by {diff:.3g} > phase 9 (a)'s "
                                 f"spread {spread:.3g}")
        say(f"{tag} (d) 8m: 1 episode, SIGTERM, emergency checkpoint, exit {EXIT_PREEMPTED}, "
            f"resume='auto' at episode {resumed.start_episode}: equal to the uninterrupted "
            f"2-episode run bit for bit: {equal} (max |diff| {diff:.3g}), battles equal: "
            f"{env_equal}; launches {paths['smac_resume_8m']} (expected {want})")
        readings["resume_equal"] = bool(equal and env_equal)
        say(f"{tag} [time] (d) done at {time.perf_counter() - t_phase:.1f}s of the phase")

        # (e) the export served at bucket 8 with live masks, cached and scan
        out = root / "exports" / "8m"
        if export_cli.main(["--map_name", "8m", "--model_dir", str(ref.ckpt.directory),
                            "--out", str(out)]) != 0:
            raise AssertionError("smac: export failed")
        state_, obs_, avail_ = (x.cpu().numpy() for x in _smac_masks(
            torch, SMACLiteEnv(SMACLiteConfig("8m")), 8, seed=SEED + 24))
        quiet = lambda *_: None   # noqa: E731
        served = {}
        for mode in ("cached", "scan"):
            ecfg = EngineConfig(buckets=(1, 8), decode_mode=mode)
            zero()
            eng = DecodeEngine.from_export(out, ecfg, log_fn=quiet)
            live = DecodeEngine(ref.policy.model.state_dict(), ref.policy.cfg, ecfg,
                                log_fn=quiet)
            eng.warmup()
            live.warmup()
            a, lp = eng.decode(state_, obs_, avail_)
            b, lq = live.decode(state_, obs_, avail_)
            torch.cuda.synchronize()
            paths[f"smac_serving_export_{mode}"] = launches()
            cfg = eng.cfg
            per = (cfg.n_block + cfg.n_agent * 2 * cfg.n_block, 0) if mode == "cached" else (
                cfg.n_block, 1)
            want = (6 * per[0], 0, 6 * per[1], 0)   # two engines, 3 decodes each
            _expect_launches(paths[f"smac_serving_export_{mode}"], want, f"smac serving {mode}")
            available = np.take_along_axis(avail_, a.astype(int), -1)
            if not (available == 1).all():
                raise AssertionError(f"smac serving {mode}: an unavailable action was served")
            if not (np.array_equal(a, b) and np.array_equal(lp, lq)):
                raise AssertionError(f"smac serving {mode}: the export's engine differs from "
                                     "the in-memory one")
            served[mode] = a
            say(f"{tag} (e) 8m export served by DecodeEngine.from_export, {mode}, bucket 8 on "
                f"live masks ({int((avail_[..., 1] == 0).sum())} dead agents): every action "
                f"available, equal bit for bit to the in-memory weights' engine; launches "
                f"{paths[f'smac_serving_export_{mode}']} (expected {want})")
        readings["served_scan_equals_cached"] = bool(np.array_equal(served["cached"],
                                                                    served["scan"]))

        # (f) multi-map: one iteration on each of 3m and 8m, random order on,
        # then a held-out map
        ppo_multi = PPOConfig(ppo_epoch=10, num_mini_batch=1, lr=5e-4, clip_param=0.05)
        run = RunConfig(seed=SEED, env_name="StarCraft2Multi", scenario="multi",
                        decode_mode="scan", log_interval=1, save_interval=0,
                        run_dir=str(root / "multi"), n_rollout_threads=MULTI_E,
                        episode_length=SMAC_T, num_env_steps=2 * MULTI_E * SMAC_T)
        multi = SMACMultiRunner(run, ppo_multi, ("3m", "8m"), random_order=True,
                                log_fn=lambda m: say(f"{tag} multi: {m}"))
        cfg = multi.policy.cfg
        train_state, rollout_states = multi.setup()
        zero()
        multi.train_loop(2, train_state, rollout_states)
        torch.cuda.synchronize()
        paths["smac_multi_map"] = launches()
        want, _ = _smac_expected(cfg, run, ppo_multi, "scan", iters=2)
        _expect_launches(paths["smac_multi_map"], want, "multi-map")
        for rec in multi.records:
            if not all(math.isfinite(v) for v in rec.values() if not isinstance(v, str)):
                raise AssertionError(f"multi-map: metrics not finite: {rec}")
            say(f"{tag} (f) multi-map {rec['map']} iteration (27 agents, obs {cfg.obs_dim}, "
                f"state {cfg.state_dim}, 36 actions; E {MULTI_E}, T {SMAC_T}, "
                f"{ppo_multi.ppo_epoch} x 1): collect {rec['step_time_collect']:.3f}s, update "
                f"{rec['step_time_train']:.3f}s; " + ", ".join(
                    f"{k} {v:.6g}" for k, v in rec.items() if k.startswith(("win_rate",
                                                                            "value_loss"))))
        readings["multi_map"] = [{k: rec[k] for k in ("map", "step_time_collect",
                                                      "step_time_train")}
                                 for rec in multi.records]
        zero()
        t0 = time.perf_counter()
        held_out = multi.evaluate(maps=("2m",), n_episodes=MULTI_E)
        torch.cuda.synchronize()
        paths["smac_multi_eval_2m"] = got = launches()
        if not (got[2] > 0 and got[0] == cfg.n_block * got[2] and "eval_win_rate_2m" in held_out):
            raise AssertionError(f"held-out evaluation: {held_out}, launches {got}")
        say(f"{tag} (f) held-out 2m evaluation: {held_out} in {time.perf_counter() - t0:.2f}s; "
            f"launches {got}; multi-map launches {paths['smac_multi_map']} (expected {want})")
        readings["multi_eval_2m"] = held_out
        say(f"{tag} [time] (e), (f) done at {time.perf_counter() - t_phase:.1f}s of the phase")

        # (g) the learning check of tests/test_smac.py::test_mat_improves_win_rate_on_2m
        ppo_2m = PPOConfig(ppo_epoch=5, num_mini_batch=1, lr=5e-4, entropy_coef=0.01)
        learner = runner("learn_2m", "scan", ppo=ppo_2m, map_name="2m", episodes=LEARN_ITERS,
                         E=32, T=40, n_embd=32, n_block=1,
                         log=lambda m: m.startswith("ep ") or say(f"{tag} learn_2m: {m}"))
        train_state, rollout_state = learner.setup()
        before = learner.evaluate(n_episodes=24, seed=1)
        t0 = time.perf_counter()
        zero()
        learner.train_loop(LEARN_ITERS, train_state, rollout_state)
        torch.cuda.synchronize()
        learn_s = time.perf_counter() - t0
        paths["smac_learn_2m"] = launches()
        after = learner.evaluate(n_episodes=24, seed=1)
        curve = [round(rec.get("win_rate", float("nan")), 4) for rec in learner.records]
        say(f"{tag} (g) 2m learning check, {LEARN_ITERS} iterations in {learn_s:.2f}s: "
            f"evaluated win rate {before['eval_win_rate']:.4f} before, "
            f"{after['eval_win_rate']:.4f} after (dead ratio {before['eval_dead_ratio']:.4f} -> "
            f"{after['eval_dead_ratio']:.4f}); training win rate by iteration {curve}")
        if not (after["eval_win_rate"] >= before["eval_win_rate"]
                and after["eval_win_rate"] > 0.3):
            raise AssertionError(f"2m: no learning: before {before}, after {after}")
        readings["learn_2m"] = {"before": before, "after": after, "seconds": learn_s,
                                "train_win_rate": curve}
        readings["seconds"] = time.perf_counter() - t_phase
        return paths, readings
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _teacher_scores(torch, cfg, params, state, obs, avail, act):
    """The teacher-forced logits on the CPU under the actions ``act (B, A,
    1)``, availability applied: the scores the near-tie check reads."""
    import numpy as np

    from mat_dcml_tpu_torch.models.mat import MultiAgentTransformer

    B = act.shape[0]
    model = MultiAgentTransformer(cfg, device="cpu")
    model.load_state_dict({k: v.cpu() for k, v in params.items()})
    sh = np.zeros((B, cfg.n_agent, cfg.action_input_dim), np.float32)
    sh[:, 0, 0] = 1.0
    idx = act[:, :-1, 0].astype(int).clip(0, cfg.action_dim - 1)
    for i in range(1, cfg.n_agent):
        sh[np.arange(B), i, 1 + idx[:, i - 1]] = 1.0
    with torch.inference_mode():
        _, _, logits = model(*(torch.as_tensor(np.asarray(x)) for x in (state, obs, sh)))
    return np.where(np.asarray(avail) == 0, -1e10, logits.numpy())


def _trainer_like(trainer, policy):
    """A fresh trainer of ``trainer``'s kind and config on ``policy``."""
    if hasattr(trainer, "n_agents"):
        return type(trainer)(policy, trainer.cfg, trainer.n_agents)
    return type(trainer)(policy, trainer.cfg)


def _cpu_twin(torch, runner, train_state):
    """The runner's policy and training state copied to the CPU."""
    from mat_dcml_tpu_torch.models.actor_critic import ActorCriticPolicy
    from mat_dcml_tpu_torch.training.mappo import MAPPOTrainState

    pol = runner.policy
    cpu_pol = ActorCriticPolicy(pol.cfg, pol.obs_dim, pol.cent_obs_dim, pol.space,
                                n_objective=pol.critic.n_objective, n_stack=pol.n_stack,
                                device="cpu")
    cpu_pol.actor_flat.copy_(pol.actor_flat.cpu())
    cpu_pol.critic_flat.copy_(pol.critic_flat.cpu())

    def host(tree):     # copies, also of CPU tensors
        return type(tree)(*(x.cpu().clone() for x in tree))

    return cpu_pol, MAPPOTrainState(host(train_state.actor_opt), host(train_state.critic_opt),
                                    host(train_state.value_norm), train_state.update_step)


def _cpu_traj(torch, traj):
    return traj._replace(chunk_stats={}, **{k: v.cpu() for k, v in traj._asdict().items()
                                             if isinstance(v, torch.Tensor)})


def _perturb(torch, flat, noise):
    """``flat`` times ``1 + AC_PERTURBATION x`` standard normal draws."""
    eps = torch.randn(flat.shape, generator=noise).to(flat.device)
    return flat * (1 + AC_PERTURBATION * eps)


def _spread_bound(dev, spread, floor):
    """Whether ``dev`` is within ``floor`` or AC_SPREAD_FACTOR x ``spread``."""
    return dev <= max(floor, AC_SPREAD_FACTOR * spread)


def _match_cpu_ac_update(torch, runner, train_state, rollout_state, tag):
    """One more collect on the card, then the recipe's update on the card,
    on the card again from weights perturbed by AC_PERTURBATION (the
    update's own spread), and by the port on the CPU from copies of the
    trajectory, weights, both Adam states, the ValueNorm and the drawn
    orders.  Returns the readings."""
    import math

    from mat_dcml_tpu_torch.training.mappo import bootstrap_input

    pol, gen, trainer = runner.policy, runner.generator, runner.trainer
    rollout_state, traj = runner.collector.collect(rollout_state, generator=gen)
    boot = bootstrap_input(runner.collector, rollout_state)
    perms = trainer.draw_permutations(trainer.to_rows(traj.rewards).shape[1], gen)
    cpu_pol, cpu_state = _cpu_twin(torch, runner, train_state)
    cpu_trainer = _trainer_like(trainer, cpu_pol)
    noise = torch.Generator().manual_seed(SEED)
    pert_pol, pert_state = copy.deepcopy(pol), copy.deepcopy(train_state)
    with torch.no_grad():
        for flat in (pert_pol.actor_flat, pert_pol.critic_flat):
            flat.copy_(_perturb(torch, flat, noise))
    _, pmet = _trainer_like(trainer, pert_pol).train(pert_state, traj, boot, perms=perms)
    before = (pol.actor_flat.cpu().clone(), pol.critic_flat.cpu().clone())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_state, met = trainer.train(train_state, traj, boot, perms=perms)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_state, cmet = cpu_trainer.train(cpu_state, _cpu_traj(torch, traj), _to_cpu(boot),
                                        perms=perms.cpu())
    cpu_s = time.perf_counter() - t0

    cfg = trainer.cfg
    steps = cfg.ppo_epoch * cfg.num_mini_batch
    tol = UPDATE_TOL_FRACTION * cfg.lr * steps
    faults, diffs, moved = [], {}, 0.0
    for name, mine, ref, old in (("actor", pol.actor_flat, cpu_pol.actor_flat, before[0]),
                                 ("critic", pol.critic_flat, cpu_pol.critic_flat, before[1])):
        mine = mine.cpu()
        moved = max(moved, float((mine - old).abs().max()))
        diffs[name] = float((mine - ref).abs().max())
        if not diffs[name] <= tol:
            faults.append(f"{name} weights differ by {diffs[name]:.3g} > {tol:.3g}")
    if not moved > tol:
        faults.append(f"the update moved the weights by only {moved:.3g}")
    dev, spread = {}, {}
    for name in met._fields:
        a = float(getattr(met, name))
        b, p = float(getattr(cmet, name)), float(getattr(pmet, name))
        rtol = 1e-2 if name == "update_ratio" else AC_METRIC_RTOL
        dev[name], spread[name] = abs(a - b), abs(p - a)
        if not (math.isfinite(a) and _spread_bound(dev[name], spread[name],
                                                   1e-6 + rtol * abs(b))):
            faults.append(f"metric {name}: card {a:.9g} vs CPU {b:.9g}, beyond rtol {rtol} and "
                          f"{AC_SPREAD_FACTOR} x the card's spread {spread[name]:.3g}")
    say(f"{tag} one more update ({cfg.ppo_epoch} epochs x {cfg.num_mini_batch} minibatches) "
        f"card vs CPU port: max|weight diff| actor {diffs['actor']:.3g}, critic "
        f"{diffs['critic']:.3g} (tol {UPDATE_TOL_FRACTION} x lr x {steps} steps = {tol:.3g}); "
        f"moved up to {moved:.3g}; metrics |card - CPU| (the card's spread from a "
        f"{AC_PERTURBATION:g} perturbation): "
        + ", ".join(f"{k} {dev[k]:.3g} ({spread[k]:.3g})" for k in dev)
        + f"; card {card_s:.2f}s, CPU {cpu_s:.2f}s")
    if faults:
        raise AssertionError(f"{tag}: the card's update differs from the CPU port's: "
                             + "; ".join(faults))
    return {"update": [cfg.ppo_epoch, cfg.num_mini_batch], "weight_diff": diffs, "moved": moved,
            "metric_diff": dev, "metric_spread": spread, "card_update_s": card_s,
            "cpu_update_s": cpu_s}


class _EagerTurns:
    """Within it, a HAPPO / HATRPO turn on the card runs eagerly, not as its
    captured graph's replay."""

    def __enter__(self):
        from mat_dcml_tpu_torch.training import graphs

        self.cls, self.replay = graphs.CapturedCall, graphs.CapturedCall.__call__
        self.cls.__call__ = lambda call, *args: call.fn(*args)

    def __exit__(self, *exc):
        self.cls.__call__ = self.replay


def _match_cpu_turns(torch, runner, train_state, rollout_state, tag):
    """One more update of HAPPO or HATRPO at the recipe, turn by turn.
    Before each agent's turn its state on the card (weights, both Adam
    states, ValueNorm) is kept; the turn runs on the card AC_SPREAD_SAMPLES
    times from that state perturbed by AC_PERTURBATION (the turn's own
    spread), then from the state itself, and by the CPU port from a copy of
    it, with the card's factor and targets.  The first AC_EAGER_TURNS turns
    also run eagerly on the card from the same state, which must equal the
    captured graph's replay bit for bit.  Returns the readings."""
    import math

    import numpy as np

    from mat_dcml_tpu_torch.training.happo import HATRPOTrainer
    from mat_dcml_tpu_torch.training.mappo import bootstrap_input

    pol, gen, trainer = runner.policy, runner.generator, runner.trainer
    trpo = isinstance(trainer, HATRPOTrainer)
    rollout_state, traj = runner.collector.collect(rollout_state, generator=gen)
    boot = bootstrap_input(runner.collector, rollout_state)
    T, E = traj.rewards.shape[:2]
    order = trainer.draw_order(gen)
    perms = trainer.draw_permutations(T * E, gen)
    cpu_pol, cpu_state = _cpu_twin(torch, runner, train_state)
    cpu_trainer = _trainer_like(trainer, cpu_pol)
    data = trainer.prepare(train_state, traj, boot)
    cpu_data = cpu_trainer.prepare(cpu_state, _cpu_traj(torch, traj), _to_cpu(boot))
    target_diff = max(float((data[k].cpu() - cpu_data[k]).abs().max()) for k in ("adv",
                                                                                 "returns"))
    cpu_data = {k: v.cpu() for k, v in data.items()}     # the card's targets from here on
    noise = torch.Generator().manual_seed(SEED)
    cfg = trainer.cfg
    steps = cfg.num_mini_batch * (1 if trpo else cfg.ppo_epoch)     # Adam steps a turn
    tol = UPDATE_TOL_FRACTION * cfg.lr * steps

    def card_rows():
        return [pol.actor_flat, pol.critic_flat, *train_state.actor_opt,
                *train_state.critic_opt, *train_state.value_norm]

    def cpu_rows():
        return [cpu_pol.actor_flat, cpu_pol.critic_flat, *cpu_state.actor_opt,
                *cpu_state.critic_opt, *cpu_state.value_norm]

    def put(rows, i, vals):
        with torch.no_grad():
            for x, v in zip(rows, vals):
                x[i] = v.to(x.device)

    factor = torch.ones(1, T * E, 1, device=pol.device)
    turns, faults, eager_equal = [], [], []
    t_card = t_cpu = 0.0
    for j, i in enumerate(order.tolist()):
        perm = perms[j:j + 1]
        kept = [x[i].clone() for x in card_rows()]
        if j < AC_EAGER_TURNS:
            with _EagerTurns():
                f_eager, m_eager = trainer.turn(train_state, data, i, factor, perm)
            eager = [x[i].clone() for x in card_rows()]
            put(card_rows(), i, kept)
        spread = []
        for _ in range(AC_SPREAD_SAMPLES):
            put(card_rows(), i, [_perturb(torch, kept[0], noise), _perturb(torch, kept[1], noise),
                                 *kept[2:]])
            f_p, m_p = trainer.turn(train_state, data, i, factor, perm)
            spread.append((pol.actor_flat[i].to("cpu", copy=True),
                           pol.critic_flat[i].to("cpu", copy=True), f_p.cpu(),
                           {k: float(v) for k, v in m_p.items()}))
        put(card_rows(), i, kept)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f_in = factor
        factor, m = trainer.turn(train_state, data, i, factor, perm)
        torch.cuda.synchronize()
        t_card += time.perf_counter() - t0
        if j < AC_EAGER_TURNS:
            eager_equal.append(torch.equal(factor, f_eager)
                               and all(torch.equal(m[k], m_eager[k]) for k in m)
                               and all(torch.equal(x[i], y) for x, y in zip(card_rows(), eager)))
        put(cpu_rows(), i, kept)
        t0 = time.perf_counter()
        f_cpu, m_cpu = cpu_trainer.turn(cpu_state, cpu_data, i, f_in.cpu(), perm.cpu())
        t_cpu += time.perf_counter() - t0

        a0 = kept[0].cpu()
        a_card, c_card, f_card = pol.actor_flat[i].cpu(), pol.critic_flat[i].cpu(), factor.cpu()
        step = max(float((cpu_pol.actor_flat[i] - a0).abs().max()), 1e-12)
        rel_f = lambda f: float(((f - f_cpu).abs() / f_cpu.abs()).max())     # noqa: E731
        row = {"agent": i,
               "actor": float((a_card - cpu_pol.actor_flat[i]).abs().max()),
               "critic": float((c_card - cpu_pol.critic_flat[i]).abs().max()),
               "factor": rel_f(f_card),
               "step": step,
               "actor_spread": max(float((a - a_card).abs().max()) for a, _, _, _ in spread),
               "critic_spread": max(float((c - c_card).abs().max()) for _, c, _, _ in spread),
               "factor_spread": max(float(((f - f_card).abs() / f_card.abs()).max())
                                    for _, _, f, _ in spread),
               "accepted_equal": float(m["accepted"]) == float(m_cpu["accepted"])}
        for k in m:
            a, b = float(m[k]), float(m_cpu[k])
            row[f"m_{k}_card"], row[f"m_{k}_cpu"] = a, b
            row[f"m_{k}"] = abs(a - b)
            row[f"m_{k}_spread"] = max(abs(p[3][k] - a) for p in spread)
            rtol = {"kl": 1e-4, "update_ratio": 1e-2}.get(k, AC_METRIC_RTOL)
            row[f"m_{k}_floor"] = 1e-6 + rtol * abs(b)
        turns.append(row)

    def worst(k):
        r = max(turns, key=lambda r: r[k])
        return f"{r[k]:.3g} (its spread {r.get(k + '_spread', 0.0):.3g})"

    ratio = lambda k: [r[k] / max(r[k + "_spread"], 1e-30) for r in turns]   # noqa: E731
    keys = ["actor", "critic", "factor"] + [f"m_{k}" for k in m]
    summary = {k: {"largest": max(r[k] for r in turns),
                   "median": float(np.median([r[k] for r in turns])),
                   "spread_median": float(np.median([r[k + "_spread"] for r in turns])),
                   "beyond_spread": sum(x > 1 for x in ratio(k))} for k in keys}
    # the turns held by their median (a port fault moves every turn; one
    # turn alone can part further: constants' comment)
    def med(k):
        return float(np.median([r[k] for r in turns]))

    def beyond(k, floor):
        return not _spread_bound(med(k), med(k + "_spread"), floor)

    if not all(r["accepted_equal"] for r in turns):
        faults.append(f"the line search's acceptance differs in "
                      f"{sum(not r['accepted_equal'] for r in turns)} turns")
    if trpo:
        if not all(r["critic"] <= tol for r in turns):
            faults.append(f"critic weights differ by {max(r['critic'] for r in turns):.3g} > "
                          f"{tol:.3g}")
        if beyond("actor", 1e-4 * med("step")):
            faults.append(f"actor: median turn {med('actor'):.3g} (median step "
                          f"{med('step'):.3g}, spread {med('actor_spread'):.3g})")
    else:
        for k in ("actor", "critic"):
            if not med(k) <= tol:
                faults.append(f"{k} weights: median turn {med(k):.3g} > {tol:.3g}")
    if beyond("factor", AC_METRIC_RTOL):
        faults.append(f"factor: median turn {med('factor'):.3g} relative (spread "
                      f"{med('factor_spread'):.3g})")
    for k in m:
        if not all(math.isfinite(r[f"m_{k}_card"]) for r in turns):
            faults.append(f"metric {k} not finite")
        if beyond(f"m_{k}", med(f"m_{k}_floor")):
            faults.append(f"metric {k}: median turn {med(f'm_{k}'):.3g} (spread "
                          f"{med(f'm_{k}_spread'):.3g}, floor {med(f'm_{k}_floor'):.3g})")
    if not all(eager_equal):
        faults.append(f"the captured turns differ from the eager ones: {eager_equal}")
    say(f"{tag} one more update ({'1 pass' if trpo else f'{cfg.ppo_epoch} epochs'} x "
        f"{cfg.num_mini_batch} minibatches), {len(turns)} turns each from the card's state, card "
        f"vs CPU port: targets max|diff| {target_diff:.3g}; the first {len(eager_equal)} turns "
        f"graphed equal to eager bit for bit: {all(eager_equal)}; acceptance equal in "
        f"{sum(r['accepted_equal'] for r in turns)} turns; max|diff| actor {worst('actor')}, "
        f"critic {worst('critic')} (weights' tol {tol:.3g}), factor relative {worst('factor')}; "
        f"each quantity's largest, median, the median of the card's spread from "
        f"{AC_SPREAD_SAMPLES} {AC_PERTURBATION:g} perturbations, turns beyond their spread: "
        + ", ".join(f"{k} {v['largest']:.3g} / {v['median']:.3g} / {v['spread_median']:.3g} / "
                    f"{v['beyond_spread']}" for k, v in summary.items())
        + f"; final factor mean {float(factor.mean()):.4g}; card {t_card:.2f}s, CPU "
        f"{t_cpu:.2f}s")
    if faults:
        raise AssertionError(f"{tag}: the card's turns differ from the CPU port's: "
                             + "; ".join(faults[:12]) + f" ({len(faults)} in all)")
    return {"update": [1 if trpo else cfg.ppo_epoch, cfg.num_mini_batch],
            "target_diff": target_diff, "graphed_equals_eager": eager_equal,
            "summary": summary, "final_factor_mean": float(factor.mean()),
            "card_update_s": t_card, "cpu_update_s": t_cpu}


def phase12_actor_critic(torch, card, deterministic, spread):
    """The actor-critic family on DCML at the recipe (the module docstring's
    phase 12).  Returns ``{path: (attention_fwd, attention_bwd, ar_decode,
    decode_step) launches}`` and the phase's readings."""
    import math
    import os
    import shutil
    import signal
    import tempfile
    from pathlib import Path

    from mat_dcml_tpu_torch.config import RunConfig
    from mat_dcml_tpu_torch.ops import ar_decode as ard
    from mat_dcml_tpu_torch.ops import cuda_attention as ca
    from mat_dcml_tpu_torch.ops import decode_step as dst
    from mat_dcml_tpu_torch.training.ppo import PPOConfig
    from mat_dcml_tpu_torch.training.resilience import EXIT_PREEMPTED
    from mat_dcml_tpu_torch.training.runner import DCMLRunner

    tag = "[phase 12]"
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ac_"))
    paths, readings = {}, {"card": card}
    none = (0, 0, 0, 0)

    def launches():
        return ca.launches, ca.bwd_launches, ard.launches, dst.launches

    def zero():
        ca.launches = ca.bwd_launches = ard.launches = dst.launches = 0

    recipe = RunConfig()

    def runner(name, algo, log=None, episodes=1, **kw):
        run = RunConfig(seed=SEED, algorithm_name=algo, log_interval=1, run_dir=str(root / name),
                        num_env_steps=episodes * recipe.episode_length * recipe.n_rollout_threads,
                        **kw)
        return DCMLRunner(run, PPOConfig(), log_fn=log or (lambda m: say(f"{tag} {name}: {m}")))

    def final(r, state):
        torch.cuda.synchronize()
        return {**r.trainer.state_dict(state), "generator": r.generator.get_state()}

    try:
        # (a) one iteration each (happo: two, the uninterrupted run of (b)),
        # no hand-written kernel on these paths
        kept, happo_final = {}, None
        for algo in AC_ALGOS:
            episodes = 2 if algo == "happo" else 1
            r = runner(algo, algo, episodes=episodes, save_interval=1)
            _expect_device(r.device, algo)
            pol = r.policy
            train_state, rollout_state = r.setup()
            torch.cuda.synchronize()
            zero()
            train_state, rollout_state = r.train_loop(episodes, train_state, rollout_state)
            torch.cuda.synchronize()
            paths[f"training_{algo}"] = launches()
            _expect_launches(paths[f"training_{algo}"], none, algo)
            if algo == "happo":     # a copy: the matched update below moves the live state
                happo_final = copy.deepcopy(final(r, train_state))
            if not all(math.isfinite(v) for rec in r.records for v in rec.values()):
                raise AssertionError(f"{algo}: metrics not finite: {r.records}")
            for rec in r.records:
                it = rec["step_time_collect"] + rec["step_time_train"]
                say(f"{tag} {algo} ({pol.n_stack} policies, obs {pol.obs_dim}, critic obs "
                    f"{pol.cent_obs_dim}, {type(pol.space).__name__}, hidden "
                    f"{pol.cfg.hidden_size}; E {r.run_cfg.n_rollout_threads}, T "
                    f"{r.run_cfg.episode_length}, {r.trainer.cfg.ppo_epoch} x "
                    f"{r.trainer.cfg.num_mini_batch}) iteration {rec['episode']} on {card}: "
                    f"collect {rec['step_time_collect']:.3f}s, update "
                    f"{rec['step_time_train']:.3f}s ({rec['step_time_train'] / it:.1%} of "
                    f"{it:.3f}s); launches fwd/bwd/ar_decode/decode_step "
                    f"{paths[f'training_{algo}']}")
                say(f"{tag} {algo} record: " + ", ".join(
                    f"{k} {rec[k]:.6g}" for k in ("average_step_rewards", "value_loss",
                                                  "policy_loss", "dist_entropy", "grad_norm",
                                                  "factor_mean", "kl", "accepted") if k in rec))
            readings[algo] = [{"collect_s": rec["step_time_collect"],
                               "update_s": rec["step_time_train"],
                               "iteration_s": rec["step_time_collect"] + rec["step_time_train"]}
                              for rec in r.records]
            if algo in AC_MATCHED:
                zero()
                match = _match_cpu_ac_update if algo == "ppo" else _match_cpu_turns
                readings[f"{algo}_vs_cpu"] = match(torch, r, train_state, rollout_state,
                                                   f"{tag} {algo}")
                torch.cuda.synchronize()
                _expect_launches(launches(), none, f"{algo}'s matched update")
            if algo in AC_EVALUATED:
                kept[algo] = r
            say(f"{tag} [time] {algo} done at {time.perf_counter() - t_phase:.1f}s of the phase")

        # (b) happo: (a)'s 2 uninterrupted episodes against 1, SIGTERM, exit
        # 75 and resume="auto" for the 2nd
        def sigterm_after_0(m):
            say(f"{tag} happo_stop: {m}")
            if m.startswith("ep 0 "):
                os.kill(os.getpid(), signal.SIGTERM)

        torch.cuda.synchronize()
        zero()
        stopped = runner("happo_stop", "happo", log=sigterm_after_0, episodes=2,
                         save_interval=1)
        try:
            stopped.train_loop()
            raise AssertionError("happo: the run did not stop on SIGTERM")
        except SystemExit as e:
            if e.code != EXIT_PREEMPTED:
                raise AssertionError(f"happo: exit code {e.code}, expected {EXIT_PREEMPTED}")
        resumed = runner("happo_stop", "happo", episodes=2, save_interval=1, resume="auto")
        res_state, res_rollout = resumed.setup()
        if resumed.start_episode != 1:
            raise AssertionError(f"happo: resumed at episode {resumed.start_episode}")
        res_state, _ = resumed.train_loop(train_state=res_state, rollout_state=res_rollout)
        torch.cuda.synchronize()
        paths["resume_happo"] = launches()
        _expect_launches(paths["resume_happo"], none, "happo resume")
        equal, diff = _state_diff(torch, final(resumed, res_state), happo_final, "happo resume")
        if deterministic and not equal:
            raise AssertionError(f"happo: the resumed run differs from the uninterrupted one by "
                                 f"{diff:.3g} on a deterministic card")
        if not deterministic and not diff <= spread:
            raise AssertionError(f"happo: resumed run differs by {diff:.3g} > phase 9 (a)'s "
                                 f"spread {spread:.3g}")
        say(f"{tag} happo: 1 episode, SIGTERM, emergency checkpoint, exit {EXIT_PREEMPTED}, "
            f"resume='auto' at episode {resumed.start_episode}: equal to the uninterrupted "
            f"2-episode run bit for bit: {equal} (max |diff| {diff:.3g}; weights, both Adam "
            f"states of all {resumed.policy.n_stack} agents, ValueNorms, generator)")
        readings["happo_resume_equal"] = bool(equal)
        say(f"{tag} [time] (b) done at {time.perf_counter() - t_phase:.1f}s of the phase")

        # (c) evaluation, 100 deterministic steps
        for algo, r in kept.items():
            zero()
            t0 = time.perf_counter()
            info = r.evaluate(n_steps=EVAL_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            paths[f"eval_{algo}"] = launches()
            _expect_launches(paths[f"eval_{algo}"], none, f"{algo} evaluation")
            if not all(math.isfinite(v) for v in info.values()):
                raise AssertionError(f"{algo} evaluation not finite: {info}")
            say(f"{tag} {algo} DCMLRunner.evaluate, {EVAL_STEPS} steps on {card}: {wall:.2f}s, "
                f"{info['eval_inference_sec_per_call'] * 1e3:.3f} ms a policy call; "
                + ", ".join(f"{k} {v:.6g}" for k, v in info.items()))
            readings[f"eval_{algo}"] = {"wall_s": wall, **info}
        readings["seconds"] = time.perf_counter() - t_phase
        return paths, readings
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr, flush=True)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    card = phase0_environment(torch)
    torch.cuda.synchronize()
    phase1_build()
    say(f"[time] build done at {time.perf_counter() - t_start:.1f}s")
    torch.cuda.synchronize()
    errs = phase2_kernels(torch)
    bwd_errs = phase2_backward(torch)
    large_n = phase2_large_n(torch)
    ar_err, ar_shapes = phase2_ar_decode(torch)
    step_err, step_shapes = phase2_decode_step(torch)
    say(f"[time] f32 kernel checks done at {time.perf_counter() - t_start:.1f}s")
    attn_times = phase2_attention_times(torch)
    say(f"[time] attention timings done at {time.perf_counter() - t_start:.1f}s")
    ar16_err, ar16_flips, ar16_fault, ar16_shapes = phase2_ar_decode_bf16(torch)
    st16_err, st16_share, st16_fault, st16_shapes = phase2_decode_step_bf16(torch)
    say(f"[time] bf16 kernel checks done at {time.perf_counter() - t_start:.1f}s")
    from mat_dcml_tpu_torch.models.mat import MultiAgentTransformer

    params = MultiAgentTransformer(
        _dcml_config(), device="cpu", generator=torch.Generator().manual_seed(SEED)).state_dict()
    engines, serve = {}, {}
    for mode in ("cached", "scan"):
        engines[mode], batcher, serve[mode] = phase3_serve(torch, params, mode)
        phase4_close(torch, batcher)
    _match_bucket8(torch, _dcml_config(), params, engines)
    engines16, serve16 = {}, {}
    for mode in ("cached", "scan"):
        engines16[mode], batcher, serve16[mode] = phase3_serve(torch, params, mode,
                                                               serve_dtype="bf16")
        phase4_close(torch, batcher)
    _match_bucket8_bf16(torch, _dcml_config(), params, engines16, engines, "phase 3")
    say(f"[time] serving done at {time.perf_counter() - t_start:.1f}s")
    train_fwd, train_bwd, records = phase5_training(torch)
    (scan_fwd, scan_bwd, scan_ar), _ = phase5_scan_iteration(torch, records)
    say(f"[time] f32 DCML training done at {time.perf_counter() - t_start:.1f}s")
    train16, _ = phase5_bf16_training(torch)
    say(f"[time] bf16 DCML training done at {time.perf_counter() - t_start:.1f}s")
    cont_serve, cont_serve16 = phase6_continuous_serving(torch)
    mj_train = phase7_mujoco_training(torch)
    mj16, _ = phase7_mujoco_bf16(torch)
    say(f"[time] MuJoCo done at {time.perf_counter() - t_start:.1f}s")
    probe_rows, probe_verdicts, probe_launches = phase8_probe(torch)
    ckpt_paths, ckpt_readings = phase9_checkpoint(torch, card)
    say(f"[time] checkpoint phase done at {time.perf_counter() - t_start:.1f}s")
    mo_paths, mo_readings = phase10_mat_family(torch, card, ckpt_readings["deterministic"],
                                               ckpt_readings["spread"])
    say(f"[time] MAT family phase done at {time.perf_counter() - t_start:.1f}s")
    smac_ar, smac_errs = phase11_kernels(torch)
    smac_paths, smac_readings = phase11_smac(torch, card, ckpt_readings["deterministic"],
                                             ckpt_readings["spread"])
    smac_readings["kernel_errors"] = {" ".join(k): v for k, v in smac_errs.items()}
    say(f"[time] SMAC phase done at {time.perf_counter() - t_start:.1f}s")
    ac_paths, ac_readings = phase12_actor_critic(torch, card, ckpt_readings["deterministic"],
                                                 ckpt_readings["spread"])
    say(f"[time] actor-critic phase done at {time.perf_counter() - t_start:.1f}s")

    smac_labels = ("8m_", "multi_")

    def split(rows):
        """``(DCML's rows, SMAC's rows)``."""
        return ({k: v for k, v in rows.items() if not k.startswith(smac_labels)},
                {k: v for k, v in rows.items() if k.startswith(smac_labels)})

    (shapes, smac_fwd), (bwd_shapes, smac_bwd) = (split(r) for r in attn_times["float32"])
    attn16, attn16_bwd = attn_times["bfloat16"]
    dec = shapes["decode"]
    f32_err = max(e for (_, dt), e in errs.items() if dt == "float32")
    bf16_err = max(e for (_, dt), e in errs.items() if dt == "bfloat16")
    # (attention_fwd, attention_bwd, ar_decode, decode_step) launches of each
    # bf16 path
    paths16 = {"serving_bf16_cached": serve16["cached"][:1] + (0,) + serve16["cached"][1:],
               "serving_bf16_scan": serve16["scan"][:1] + (0,) + serve16["scan"][1:],
               "training_bf16_cached": train16["cached"] + (0,),
               "training_bf16_scan": train16["scan"] + (0,),
               "serving_continuous_bf16_cached": (cont_serve16["cached"][0], 0)
               + cont_serve16["cached"][1:],
               "serving_continuous_bf16_scan": (cont_serve16["scan"][0], 0)
               + cont_serve16["scan"][1:],
               "training_mujoco_bf16_scan": mj16[:2] + (0, mj16[2])}

    def with16(paths, k):
        """``paths`` with the bf16 paths' and phases 9-10's launches of kernel ``k``."""
        return {**paths, **{name: n[k] for name, n in paths16.items()},
                **{name: n[k] for name, n in ckpt_paths.items()},
                **{name: n[k] for name, n in mo_paths.items()},
                **{name: n[k] for name, n in smac_paths.items()},
                **{name: n[k] for name, n in ac_paths.items()}}

    fwd_paths = with16({"serving_cached": serve["cached"][0], "serving_scan": serve["scan"][0],
                        "training_cached": train_fwd, "training_scan": scan_fwd,
                        "serving_continuous_cached": cont_serve["cached"][0],
                        "serving_continuous_scan": cont_serve["scan"][0],
                        "training_mujoco_cached": mj_train["cached"][0],
                        "training_mujoco_scan": mj_train["scan"][0]}, 0)
    bwd_paths = with16({"serving_cached": 0, "serving_scan": 0, "training_cached": train_bwd,
                        "training_scan": scan_bwd, "serving_continuous_cached": 0,
                        "serving_continuous_scan": 0,
                        "training_mujoco_cached": mj_train["cached"][1],
                        "training_mujoco_scan": mj_train["scan"][1]}, 1)
    ar_paths = with16({"serving_cached": serve["cached"][1], "serving_scan": serve["scan"][1],
                       "training_cached": 0, "training_scan": scan_ar,
                       "serving_continuous_cached": cont_serve["cached"][1],
                       "serving_continuous_scan": cont_serve["scan"][1],
                       "training_mujoco_cached": 0, "training_mujoco_scan": 0}, 2)
    fwd_kernel = {
        "name": "attention_fwd",
        "route": "cuda",
        "source": "mat_dcml_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "mat_dcml_tpu/ops/pallas_attention.py:133",
        "launches": sum(fwd_paths.values()),
        "launches_by_path": fwd_paths,
        "max_abs_err": f32_err,
        "ms": dec["ms"], "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
        "timed_at": "decode",
        "max_abs_err_bf16": bf16_err,
        "shapes": shapes,
        "smac_shapes": smac_fwd,
        "past_grid_y_limit": {" ".join(k): v[0] for k, v in large_n.items()},
    }
    enc = bwd_shapes["encoder"]
    bwd_kernel = {
        "name": "attention_bwd",
        "route": "cuda",
        "source": "mat_dcml_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "mat_dcml_tpu/ops/pallas_attention.py:153",
        "launches": sum(bwd_paths.values()),
        "launches_by_path": bwd_paths,
        "max_abs_err": max(e for (lb, dt), e in bwd_errs.items()
                           if dt == "float32" and not lb.endswith("_stats")),
        "ms": enc["ms"], "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"], "library_ms": enc["library_ms"],
        "timed_at": "encoder",
        "max_abs_err_bf16": max(e for (lb, dt), e in bwd_errs.items()
                                if dt == "bfloat16" and not lb.endswith("_stats")),
        "row_statistics_rel_err": max(e for (lb, _), e in bwd_errs.items()
                                      if lb.endswith("_stats")),
        "shapes": bwd_shapes,
        "smac_shapes": smac_bwd,
        "past_grid_y_limit": {" ".join(k): v[1] for k, v in large_n.items()},
    }
    at8 = ar_shapes[8]
    ar_kernel = {
        "name": "ar_decode",
        "route": "cuda",
        "source": "mat_dcml_tpu_torch/csrc/ar_decode.cu",
        "replaces": "mat_dcml_tpu/ops/pallas_decode.py:595",
        "launches": sum(ar_paths.values()),
        "launches_by_path": ar_paths,
        "max_abs_err": ar_err,
        "ms": at8["ms"], "plain_ms": at8["plain_ms"], "bound_ms": at8["bound_ms"],
        "bound_by": at8["bound_by"], "library_ms": None,
        "timed_at": "B=8 (the rollout's batch)",
        "max_abs_err_of": "log-prob",
        "cached_decode_ms": at8["cached_decode_ms"],
        "shapes": {f"B={b}": v for b, v in ar_shapes.items()},
        "smac_shapes": smac_ar,
    }
    step_paths = with16({"serving_cached": 0, "serving_scan": 0, "training_cached": 0,
                         "training_scan": 0,
                         "serving_continuous_cached": cont_serve["cached"][2],
                         "serving_continuous_scan": cont_serve["scan"][2],
                         "training_mujoco_cached": mj_train["cached"][2],
                         "training_mujoco_scan": mj_train["scan"][2]}, 3)
    st8 = step_shapes[8]
    step_kernel = {
        "name": "decode_step",
        "route": "cuda",
        "source": "mat_dcml_tpu_torch/csrc/decode_step.cu",
        "replaces": "mat_dcml_tpu/ops/pallas_decode.py:678",
        "launches": sum(step_paths.values()),
        "launches_by_path": step_paths,
        "max_abs_err": step_err,
        "ms": st8["ms"], "plain_ms": st8["plain_ms"], "bound_ms": st8["bound_ms"],
        "bound_by": st8["bound_by"], "library_ms": None,
        "timed_at": "B=8 (the rollout's batch), A=10, the last position",
        "max_abs_err_of": "logits and caches",
        "cached_step_ms": st8["cached_step_ms"],
        "shapes": {f"B={b}": v for b, v in step_shapes.items()},
    }
    attend8 = {r["variant"]: r for r in probe_rows if r["question"] == "attend" and r["B"] == 8}
    probe_at = attend8["batch_major"]
    probe_kernel = {
        "name": "cache_layout_probe",
        "route": "cuda",
        "source": "mat_dcml_tpu_torch/csrc/cache_layout_probe.cu",
        "replaces": "scripts/mosaic_probe.py:105",
        # a measurement tool: no path of the system launches it
        "launches": probe_launches,
        "launches_by_path": {**dict.fromkeys(step_paths, 0), "probe": probe_launches},
        "max_abs_err": max(r["max_abs_err"] for r in probe_rows),
        "ms": probe_at["ms"], "plain_ms": probe_at["plain_ms"],
        "bound_ms": probe_at["bound_ms"], "bound_by": probe_at["bound_by"],
        "library_ms": probe_at["library_ms"],
        "timed_at": "attend, batch-major caches, B=8 (library: causal SDPA)",
        "verdicts": probe_verdicts,
        "rows": probe_rows,
    }
    bf16_legs = {
        "attention_fwd": {"max_abs_err": bf16_err, "shapes": attn16},
        "attention_bwd": {"max_abs_err": max(e for (lb, dt), e in bwd_errs.items()
                                             if dt == "bfloat16" and not lb.endswith("_stats")),
                          "shapes": attn16_bwd},
        "ar_decode": {"max_abs_err": ar16_err, "max_abs_err_of": "log-prob",
                      "tol": BF16_AR_TOL, "near_tie_rows": ar16_flips,
                      "planted_fault": ar16_fault, "launches": sum(ar_paths[k] for k in paths16),
                      "shapes": {f"B={b}": v for b, v in ar16_shapes.items()}},
        "decode_step": {"max_abs_err": st16_err, "max_abs_err_of": "logits and caches",
                        "tol": BF16_STEP_TOL, "moved_share": st16_share,
                        "planted_fault_moved_share": st16_fault,
                        "launches": sum(step_paths[k] for k in paths16),
                        "shapes": {f"B={b}": v for b, v in st16_shapes.items()}},
        "launches_by_path": paths16,
    }
    say(json.dumps({"bf16_legs": bf16_legs}))
    say(json.dumps({"checkpoint_phase": ckpt_readings}))
    say(json.dumps({"mat_family_phase": mo_readings}))
    say(json.dumps({"smac_phase": smac_readings}))
    say(json.dumps({"actor_critic_phase": ac_readings}))
    say(f"[done] {time.perf_counter() - t_start:.1f}s wall")
    say(card)   # as nvidia-smi gives it: name, power limit
    say(json.dumps({"kernels": [fwd_kernel, bwd_kernel, ar_kernel, step_kernel, probe_kernel]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
