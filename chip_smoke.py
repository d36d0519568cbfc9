#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and drive its serving and training
paths on one card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own line and each fatal on failure:

0. environment: the card's name and power limit, torch / CUDA / nvcc
   versions, and the f32 matmul settings (TF32 off);
1. build: every ``mat_dcml_tpu_torch/csrc/*.cu`` with nvcc into
   ``mat_dcml_tpu_torch/_build/`` (keyed by a hash of the source);
2. kernels: each kernel against its plain PyTorch version, f32 and bf16, at
   the serving shapes (attention_fwd) and the PPO update's (attention_bwd,
   against autograd through the plain forward), each with a planted-fault
   reading far outside the tolerance, and the kernel, plain, library and
   bound times;
3. the slice: the DCML MAT policy at full width (101 agents, obs 7, state
   102, n_embd 64, 2 blocks, 2 heads, seeded random weights) served through
   ContinuousBatcher -> DecodeEngine -> serve_decode(mode="cached") on the
   card; every attention must go through the kernel (406 launches per
   dispatch), and a bucket-8 decode must match the port on the CPU;
4. close: the batcher's thread joined, no thread left behind;
5. training: DCMLRunner at the recipe's full width (101 agents, n_embd 64,
   2 blocks, 2 heads, E = 8, T = 50, 15 PPO epochs x 4 minibatches) runs two
   iterations (collect, GAE, PPO update) on the card; every attention
   forward and backward must go through the kernels (counted exactly), the
   metrics must be finite, and one more update on the card must match the
   same update by the port on the CPU (same trajectory, weights, Adam state
   and permutations).

The last two lines of standard output are a JSON object describing each
kernel and the result line ``{"ok": true, "device": {...}}``.  Without a
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
PEAK_FLOPS = {"float32": 67e12,    # f32 outside the tensor cores
              "bfloat16": 989e12}  # bf16 tensor cores, dense
# bf16: both sides round P and the output to bf16, so a sound kernel may
# differ from plain by an ulp of the output (3.9e-3 below 1); a kernel that
# loses one of the 101 keys differs by far more (phase 2 prints that reading).
TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# backward, relative to the largest plain gradient: f32 summation order; bf16
# rounds dq, dk, dv (and P, dP where plain does) on both sides, and a sum of
# 101 terms in another order can move a bf16 result by an ulp, at most 2**-7
# of its size; a dropped key moves gradients by 24-92x that (phase 2 prints it)
BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
LOGP_ATOL_VS_CPU = 1e-4
NEAR_TIE = 1e-5
# training phase: the recipe (RunConfig / PPOConfig defaults)
TRAIN_ITERS = 2
# card vs CPU after one full update: Adam moves an entry by at most lr per
# step, and a gradient near 0 can move it by a different amount on each
# side, so the bound is a hundredth of the most an entry can move; metrics
# to rtol 1e-4 with atol 1e-6 (the policy loss is a mean of unit-scale
# advantages that cancels to near 0)
UPDATE_TOL_FRACTION = 0.01
METRIC_RTOL = 1e-4


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
    for name in kernel_lib.sources():
        log = kernel_lib.build(name)
        state = "cached" if log is None else "built"
        say(f"[phase 1] {name}: {state} -> {kernel_lib.library_path(name).name}")
        for line in (log or "").splitlines():
            if "registers" in line or "spill" in line or line.endswith("s"):
                say(f"[phase 1]   {line.strip()}")
    say(f"[phase 1] build {time.perf_counter() - t0:.2f}s")


def _time_ms(torch, fn, iters=200):
    """Per-call time of ``fn`` on the card, after warm-up: ``(device, eager)``.
    ``device`` replays ``iters`` calls captured in one CUDA graph, so the
    host's launch cost (Python, ctypes, the autograd engine) is left out;
    ``eager`` launches them from Python, so it is in.  Inputs stay in L2
    (warm) in both."""
    for _ in range(10):
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


def _bound(q, k, mask, dtype_name):
    """Least time for the function on this card: bytes each input is read
    and each output written once (keys a row's mask excludes need not be
    read), against flops for q.k and p.v over those keys."""
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
    flops = 2 * 2 * Lq * keys * Dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase2_kernels(torch):
    import torch.nn.functional as F

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

    shapes = {}
    for label, lq, mask in (("encoder", A, None),
                            ("decode", 1, torch.arange(A, device=dev) <= A - 1)):
        q, k, v = qkv(N_B, lq, A, torch.float32)
        sdpa_mask = None if mask is None else mask[None, None, None, :]
        ms, eager_ms = _time_ms(torch, lambda: ca.fused_masked_attention(q, k, v, kv_mask=mask))
        plain_ms, plain_eager_ms = _time_ms(torch, lambda: ca.attention_plain(q, k, v, kv_mask=mask))
        lib_ms, lib_eager_ms = _time_ms(
            torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask))
        bound_ms, bound_by = _bound(q, k, mask, "float32")
        shapes[label] = {"shape": f"q {tuple(q.shape)} k {tuple(k.shape)} f32",
                         "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "eager_ms": eager_ms, "plain_eager_ms": plain_eager_ms,
                         "library_eager_ms": lib_eager_ms}
        say(f"[phase 2] time {label} f32 {tuple(q.shape)}, device (eager) per call: "
            f"kernel {ms * 1e3:.2f} ({eager_ms * 1e3:.2f}) us, "
            f"plain {plain_ms * 1e3:.2f} ({plain_eager_ms * 1e3:.2f}) us, "
            f"sdpa {lib_ms * 1e3:.2f} ({lib_eager_ms * 1e3:.2f}) us, "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}); L2-warm")
    torch.cuda.synchronize()
    return errs, shapes


def _bwd_bound(q, causal, dtype_name):
    """Least time for the backward on this card: q, k, v, dO read and dq,
    dk, dv written once, against 10 flops per (query, key, dim) triple the
    causal mask leaves live (five products of Lq x Lk x Dh multiply-adds)."""
    B, H, L, Dh = q.shape
    nbytes = 7 * B * H * L * Dh * q.element_size()
    pairs = L * (L + 1) // 2 if causal else L * L
    flops = 10 * B * H * pairs * Dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase2_backward(torch):
    """attention_bwd against autograd through the plain forward at the PPO
    update's shapes (minibatch 100 rows x 2 heads, L = 101, Dh = 32)."""
    import torch.nn.functional as F

    from mat_dcml_tpu_torch.ops import cuda_attention as ca

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    B, H, L, Dh = 100, 2, 101, 32
    errs, shapes = {}, {}
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
            if dtype != torch.float32:
                continue
            ms, eager_ms = _time_ms(torch, lambda: ca.attention_bwd(q, k, v, do, causal=causal))
            plain_ms, plain_eager_ms = _time_ms(
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
            shapes[label] = {"shape": f"q/k/v/dO {tuple(q.shape)} f32, causal {causal}",
                             "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by, "eager_ms": eager_ms,
                             "plain_eager_ms": plain_eager_ms,
                             "library_fwd_bwd_ms": lib_fb_ms, "library_fwd_ms": lib_f_ms}
            say(f"[phase 2] time bwd {label} f32 {tuple(q.shape)}, device (eager) per call: "
                f"kernel {ms * 1e3:.2f} ({eager_ms * 1e3:.2f}) us, "
                f"plain fwd+bwd {plain_ms * 1e3:.2f} ({plain_eager_ms * 1e3:.2f}) us, "
                f"sdpa bwd {lib_ms * 1e3:.2f} us (fwd+bwd {lib_fb_ms * 1e3:.2f} less fwd "
                f"{lib_f_ms * 1e3:.2f}), bound {bound_ms * 1e3:.2f} us ({bound_by}); L2-warm")
    torch.cuda.synchronize()
    return errs, shapes


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

    nd = cfg.n_discrete_agents
    if act.shape[-2:] != (cfg.n_agent, 1) or logp.shape != act.shape:
        raise AssertionError(f"action {act.shape} / log-prob {logp.shape}")
    if not set(np.unique(act[..., :nd, 0])) <= {0.0, 1.0}:
        raise AssertionError("a worker agent chose outside {0, 1}")
    if not (np.isfinite(act[..., nd:, 0]).all() and np.isfinite(logp).all()):
        raise AssertionError("non-finite coding ratio or log-prob")


def _match_cpu(torch, cfg, params, gpu_engine):
    """A bucket-8 decode on the card against the port on the CPU with the
    same weights (plain attention there).  Actions equal, log-probs within
    LOGP_ATOL_VS_CPU, except past a position whose top-2 logit margin on the
    CPU is below NEAR_TIE (a near-tie summation order may break)."""
    import numpy as np

    from mat_dcml_tpu_torch.models.mat import MultiAgentTransformer
    from mat_dcml_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    state, obs, avail = _requests(cfg, 8, seed=SEED + 1)
    act, logp = gpu_engine.decode(state, obs, avail)
    cpu = DecodeEngine(params, cfg, EngineConfig(buckets=(8,)), device="cpu", log_fn=lambda *_: None)
    ref_act, ref_logp = cpu.decode(state, obs, avail)
    model = MultiAgentTransformer(cfg, device="cpu")
    model.load_state_dict(params)
    sh = np.zeros((8, cfg.n_agent, cfg.action_input_dim), np.float32)
    sh[:, 0, 0] = 1.0
    idx = ref_act[:, :-1, 0].astype(int).clip(0, cfg.action_dim - 1)
    for i in range(1, cfg.n_agent):
        sh[np.arange(8), i, 1 + idx[:, i - 1]] = 1.0
    with torch.inference_mode():
        _, _, logits = model(*(torch.from_numpy(x) for x in (state, obs, sh)))
    logits = np.where(avail == 0, -1e10, logits.numpy())
    nd, worst, flips = cfg.n_discrete_agents, 0.0, 0
    for b in range(8):
        diff = np.flatnonzero(act[b, :nd, 0] != ref_act[b, :nd, 0])
        end = cfg.n_agent if diff.size == 0 else int(diff[0])
        if diff.size:
            top2 = np.sort(logits[b, end])[-2:]
            if not top2[1] - top2[0] < NEAR_TIE:
                raise AssertionError(f"row {b}: card and CPU actions differ at agent {end}, "
                                     f"margin {top2[1] - top2[0]:.3g}")
            flips += 1
        elif not np.allclose(act[b, nd:], ref_act[b, nd:], atol=LOGP_ATOL_VS_CPU):
            raise AssertionError(f"row {b}: coding ratio differs from the CPU")
        err = float(np.abs(logp[b, :end] - ref_logp[b, :end]).max()) if end else 0.0
        worst = max(worst, err)
    if not worst <= LOGP_ATOL_VS_CPU:
        raise AssertionError(f"log-prob differs from the CPU by {worst} > {LOGP_ATOL_VS_CPU}")
    say(f"[phase 3] bucket 8 vs CPU port: max|logp diff| {worst:.3g} (tol {LOGP_ATOL_VS_CPU}), "
        f"rows diverging at a near-tie: {flips}")


def phase3_slice(torch):
    import numpy as np

    from mat_dcml_tpu_torch.models.mat import MultiAgentTransformer
    from mat_dcml_tpu_torch.ops import cuda_attention as ca
    from mat_dcml_tpu_torch.serving.batcher import BatcherConfig, ContinuousBatcher
    from mat_dcml_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    cfg = _dcml_config()
    params = MultiAgentTransformer(
        cfg, device="cpu", generator=torch.Generator().manual_seed(SEED)).state_dict()
    engine = DecodeEngine(params, cfg, EngineConfig(buckets=BUCKETS),
                          log_fn=lambda m: say(f"[phase 3] {m}"))
    if engine.device.type != "cuda":
        raise AssertionError(f"engine defaulted to {engine.device}")
    engine.warmup()
    batcher = ContinuousBatcher(engine, BatcherConfig(max_batch_wait_ms=5.0),
                                log_fn=lambda m: say(f"[phase 3] {m}"))

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
    ca.launches = 0
    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(c,), name=f"client-{c}") for c in range(N_CLIENTS)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = ca.launches
    torch.cuda.synchronize()
    if errors or any(t.is_alive() for t in clients):
        raise AssertionError(f"clients failed: {errors[:3]}")
    dispatches = {b: engine.dispatch_counts[b] - dispatch_before[b] for b in BUCKETS}
    n_dispatch = sum(dispatches.values())
    say(f"[phase 3] served {n_req} requests from {N_CLIENTS} clients in {n_dispatch} dispatches "
        f"{ {b: n for b, n in dispatches.items() if n} }; attention_fwd launches {launches}")
    if launches != 406 * n_dispatch or n_dispatch == 0:
        raise AssertionError(f"expected 406 launches per dispatch, got {launches} for {n_dispatch}")
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
    say(f"[phase 3] {n_req / wall:.2f} requests/s; latency p50 {np.percentile(lat, 50):.2f} ms, "
        f"p99 {np.percentile(lat, 99):.2f} ms; engine decode p50 "
        f"{engine.telemetry.hists['serving_decode_ms'].quantile(0.5):.2f} ms; "
        f"worker actions mean {act[:, :-1].mean():.3f}, coding ratio mean {act[:, -1].mean():.4f}")
    _match_cpu(torch, cfg, params, engine)
    torch.cuda.synchronize()
    return batcher, launches


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
    """A NamedTuple of tensors (nested) copied to the CPU."""
    return type(x)(*(_to_cpu(v) if isinstance(v, tuple) else v.cpu() for v in x))


def _match_cpu_update(torch, runner, ppo, train_state, rollout_state):
    """One more collect on the card, then the same PPO update on the card
    and by the port on the CPU from copies of the trajectory, weights, Adam
    state, ValueNorm and permutations.  Returns the card update's launches."""
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
    cpu_trainer = MATTrainer(cpu_policy, ppo)
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
    cpu_state, cmet = cpu_trainer.train(
        cpu_state, type(traj)(*(x.cpu() for x in traj[:-1]), chunk_stats={}), _to_cpu(rollout_state),
        perms=perms.cpu())
    cpu_s = time.perf_counter() - t0

    steps = ppo.ppo_epoch * ppo.num_mini_batch
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
    say(f"[phase 5] one update ({steps} Adam steps) card vs CPU port: max|weight diff| "
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
    say(f"[phase 5] metrics card vs CPU within rtol {METRIC_RTOL}: "
        + ", ".join(f"{n} {float(getattr(met, n)):.6g}/{float(getattr(cmet, n)):.6g}"
                    for n in ("value_loss", "policy_loss", "dist_entropy", "grad_norm")))
    return launches


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
    torch.cuda.synchronize()
    errs, shapes = phase2_kernels(torch)
    bwd_errs, bwd_shapes = phase2_backward(torch)
    batcher, launches = phase3_slice(torch)
    phase4_close(torch, batcher)
    train_fwd, train_bwd, _ = phase5_training(torch)

    dec = shapes["decode"]
    f32_err = max(e for (_, dt), e in errs.items() if dt == "float32")
    bf16_err = max(e for (_, dt), e in errs.items() if dt == "bfloat16")
    fwd_kernel = {
        "name": "attention_fwd",
        "route": "cuda",
        "source": "mat_dcml_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "mat_dcml_tpu/ops/pallas_attention.py:133",
        "launches": launches + train_fwd,
        "launches_by_path": {"serving": launches, "training": train_fwd},
        "max_abs_err": f32_err,
        "ms": dec["ms"], "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
        "timed_at": "decode",
        "max_abs_err_bf16": bf16_err,
        "shapes": shapes,
    }
    enc = bwd_shapes["encoder"]
    bwd_kernel = {
        "name": "attention_bwd",
        "route": "cuda",
        "source": "mat_dcml_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "mat_dcml_tpu/ops/pallas_attention.py:153",
        "launches": train_bwd,
        "launches_by_path": {"serving": 0, "training": train_bwd},
        "max_abs_err": max(e for (_, dt), e in bwd_errs.items() if dt == "float32"),
        "ms": enc["ms"], "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"], "library_ms": enc["library_ms"],
        "timed_at": "encoder",
        "max_abs_err_bf16": max(e for (_, dt), e in bwd_errs.items() if dt == "bfloat16"),
        "shapes": bwd_shapes,
    }
    say(f"[done] {time.perf_counter() - t_start:.1f}s wall")
    say(card)   # as nvidia-smi gives it: name, power limit
    say(json.dumps({"kernels": [fwd_kernel, bwd_kernel]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
