"""The attention kernels' device time per call, of one tree of this repository.

A measurement, on no path.  It times ``ops/cuda_attention.attention_fwd``
and ``attention_bwd`` in f32 and bf16 at the main path's shapes: DCML's
encoder at bucket 128 and at the rollout's batch, the update's causal
decoder and its encoder backward (minibatch 100), the cached decode step at
bucket 128; SMAC's update (3,200 x 2 heads at L 8, 3,600 x 2 at L 27)
and, forward only, its rollout (32 and 36 x 2).
Calls are replayed from one CUDA graph, inputs L2-warm, as ``chip_smoke.py``
times them; the bf16 backward is fed the forward's row statistics where the
tree saves them (as its autograd does).  ``--tree`` imports the port from
another checkout (one without this file too), so that two versions can be
timed in one call on one card, in turns:

    python mat_dcml_tpu_torch/probes/attention_times.py --tree OLD --build
    python mat_dcml_tpu_torch/probes/attention_times.py --build
    for t in OLD . . OLD; do python mat_dcml_tpu_torch/probes/attention_times.py --tree $t; done

It prints one JSON object: the tree, the card, and each time in us.
``--sweep`` times instead the bf16 forward and backward of this tree beside
SDPA in bf16 at L = 101, Dh = 32 over N = B x 2 rows from 16 to 8,192: the
fixed cost of a launch and the cost a row.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

# (label, B, Lq, Lk, causal, valid keys or None); H = 2, Dh = 32
FWD = (("encoder", 128, 101, 101, False, None), ("encoder_b8", 8, 101, 101, False, None),
       ("update_causal", 100, 101, 101, True, None), ("decode", 128, 1, 101, False, 101),
       ("8m_update", 3200, 8, 8, False, None), ("multi_update", 3600, 27, 27, False, None),
       ("8m_rollout", 32, 8, 8, False, None), ("multi_rollout", 36, 27, 27, False, None))
BWD = (("encoder", 100, 101, False), ("decoder_causal", 100, 101, True),
       ("8m_update", 3200, 8, False), ("multi_update", 3600, 27, False))


def _time_ms(torch, fn, iters=200):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
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
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout to import the port from (default: this one)")
    ap.add_argument("--build", action="store_true",
                    help="only build the attention kernels (printing ptxas's report)")
    ap.add_argument("--sweep", action="store_true",
                    help="time the bf16 legs and SDPA over N at L = 101 instead")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    from mat_dcml_tpu_torch.ops import cuda_attention as ca
    from mat_dcml_tpu_torch.ops import kernel_lib

    if args.build:
        for name in ("attention_fwd", "attention_bwd"):
            for line in (kernel_lib.build(name) or "").splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    print(f"{name}: {line.strip()}")
        return 0
    if not torch.cuda.is_available():
        print("attention_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    fed = "stats" in inspect.signature(ca.attention_bwd).parameters
    out = {"tree": os.path.abspath(args.tree), "stats_fed": fed,
           "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip()}
    g = torch.Generator(device=dev).manual_seed(9)
    if args.sweep:
        import torch.nn.functional as F

        for B in (8, 32, 128, 512, 2048, 4096):
            q, k, v, do = (torch.randn(B, 2, 101, 32, generator=g, device=dev).bfloat16()
                           for _ in range(4))
            stats = torch.empty(2, B * 2, 101, device=dev)
            ca.attention_fwd(q, k, v, stats=stats)
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

            def sdpa():
                return F.scaled_dot_product_attention(*leaves)

            sdpa_f = _time_ms(torch, sdpa)
            out[f"N{2 * B}"] = {
                "fwd_us": 1e3 * _time_ms(torch, lambda: ca.attention_fwd(q, k, v)),
                "sdpa_fwd_us": 1e3 * sdpa_f,
                "bwd_us": 1e3 * _time_ms(torch, lambda: ca.attention_bwd(q, k, v, do,
                                                                         stats=stats)),
                "sdpa_bwd_us": 1e3 * (_time_ms(
                    torch, lambda: torch.autograd.grad(sdpa(), leaves, do)) - sdpa_f)}
        print(json.dumps(out))
        return 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for label, B, lq, lk, causal, valid in FWD:
            q, k, v = (torch.randn(B, 2, n, 32, generator=g, device=dev).to(dtype)
                       for n in (lq, lk, lk))
            mask = None if valid is None else torch.arange(lk, device=dev) < valid
            out[f"fwd_{label}_{name}_us"] = 1e3 * _time_ms(
                torch, lambda: ca.attention_fwd(q, k, v, causal=causal, kv_mask=mask))
        for label, B, L, causal in BWD:
            q, k, v, do = (torch.randn(B, 2, L, 32, generator=g, device=dev).to(dtype)
                           for _ in range(4))
            kw = {}
            if fed and dtype == torch.bfloat16:
                kw["stats"] = torch.empty(2, B * 2, L, device=dev)
                ca.attention_fwd(q, k, v, causal=causal, stats=kw["stats"])
            out[f"bwd_{label}_{name}_us"] = 1e3 * _time_ms(
                torch, lambda: ca.attention_bwd(q, k, v, do, causal=causal, **kw))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
