"""The decode kernels' device time per call, of one tree of this repository.

A measurement, on no path.  It times ``ops/decode_step.fused_decode_step``
at multi-agent MuJoCo lite's served and trained shape (manyagent_ant 10x2:
10 agents, action 8, n_embd 64, 2 blocks, 2 heads; the last position) and
``ops/ar_decode.fused_ar_decode`` at DCML's (101 agents, action 2), at B =
1, 8 and 128, with random O(1) weights from a seed: calls replayed from one
CUDA graph, inputs L2-warm, as ``chip_smoke.py`` times them; f32, and bf16
where the tree has a bf16 trunk.  ``--tree`` imports the port from another
checkout (one without this file too), so that two versions can be timed in
one call on one card, in turns:

    python mat_dcml_tpu_torch/probes/decode_times.py --tree OLD --build
    python mat_dcml_tpu_torch/probes/decode_times.py --build
    for t in OLD . . OLD; do python mat_dcml_tpu_torch/probes/decode_times.py --tree $t; done

It prints one JSON object: the tree, the card, and each time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

BATCHES = (1, 8, 128)


def _time_ms(torch, fn, iters):
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


def _model(torch, MultiAgentTransformer, cfg, dev):
    model = MultiAgentTransformer(cfg, device="cpu")
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=g)
            if p.dim() == 2:
                p.copy_(z / p.shape[1] ** 0.5)
            elif name.endswith("weight"):          # LayerNorm scale
                p.copy_(1.0 + 0.1 * z)
            else:
                p.copy_(0.1 * z)
    return model.to(dev).eval()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout to import the port from (default: this one)")
    ap.add_argument("--build", action="store_true", help="only build the decode kernels")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import dataclasses

    import torch

    from mat_dcml_tpu_torch.models.mat import MATConfig, MultiAgentTransformer
    from mat_dcml_tpu_torch.ops import ar_decode as ard
    from mat_dcml_tpu_torch.ops import decode_step as dst
    from mat_dcml_tpu_torch.ops import kernel_lib
    from mat_dcml_tpu_torch.ops.distributions import gumbel_noise

    if args.build:
        for name in ("ar_decode", "decode_step"):
            kernel_lib.build(name)
        return 0
    if not torch.cuda.is_available():
        print("decode_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    dtypes = ["float32"] + (["bfloat16"] if "dtype" in MATConfig.__dataclass_fields__ else [])
    out = {"tree": os.path.abspath(args.tree),
           "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip()}
    g = torch.Generator(device=dev).manual_seed(5)
    step = MATConfig(n_agent=10, obs_dim=36, state_dim=240, action_dim=8, n_block=2, n_embd=64,
                     n_head=2, action_type="continuous")
    whole = MATConfig(n_agent=101, obs_dim=7, state_dim=102, action_dim=2, n_block=2, n_embd=64,
                      n_head=2, action_type="semi_discrete", semi_index=-1)
    with torch.no_grad():
        for name in dtypes:
            kw = {} if name == "float32" else {"dtype": name}
            dt = getattr(torch, name)
            weights = dst.pack_decode_weights(
                _model(torch, MultiAgentTransformer, dataclasses.replace(step, **kw), dev))
            for B in BATCHES:
                caches = dst.decode_caches(2, 10, B, 64, dev, **({} if not kw else {"dtype": dt}))
                caches.copy_(torch.randn(caches.shape, generator=g, device=dev))
                x = torch.randn(B, 8, generator=g, device=dev).to(dt)
                rep = torch.randn(B, 10, 64, generator=g, device=dev).to(dt)
                out[f"decode_step_{name}_B{B}_us"] = 1e3 * _time_ms(
                    torch, lambda: dst.fused_decode_step(weights, x, rep[:, 9], caches, 9,
                                                         n_head=2, adim=8), 200)
            weights = ard.pack_ar_decode_weights(
                _model(torch, MultiAgentTransformer, dataclasses.replace(whole, **kw), dev))
            for B in BATCHES:
                rep = torch.randn(B, 101, 64, generator=g, device=dev).to(dt)
                gumbel = gumbel_noise((B, 101, 2), g, dev)
                normal = torch.randn(B, 1, 2, generator=g, device=dev)
                avail = (torch.rand(B, 101, 2, generator=g, device=dev) > 0.2).float()
                avail[..., 0] = 1.0
                out[f"ar_decode_{name}_B{B}_ms"] = _time_ms(
                    torch, lambda: ard.fused_ar_decode(weights, rep, gumbel, normal, avail,
                                                       n_head=2, adim=2, nd=100), 20)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
