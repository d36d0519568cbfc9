"""Where the time of one position of the whole decode goes, on the card.

``csrc/decode_probe.cu`` is ``csrc/ar_decode.cu`` compiled with stage
clocks: thread 0 of the first CTA of the first cluster stamps ``clock64``
as each step of the per-position body ends (products, attentions,
LayerNorms, block barriers, cluster barriers on entry and on exit, the
sampling).  This probe runs it once at DCML's full width (101 agents,
n_embd 64, 2 blocks, 2 heads, random O(1) weights), checks its actions and
log-probs against the unprobed kernel's, and splits the average position
into those steps.  Beside it, a lone cluster of 4 CTAs times cluster
barriers with nothing to wait for and after a store into every CTA's shared
memory, reading the SM clock and the global timer together to turn cycles
into time.  Run on the card:

    python -m mat_dcml_tpu_torch.probes.decode_stages [--batch 8]

It prints one line per reading, then one JSON object, and exits 1 if the
probed kernel disagrees with the unprobed one.  The stamps are thread 0's
view: a barrier's wait holds both the barrier's own cost and the time
other threads of the cluster still work.  Nothing here runs at import.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

TAGS = ("loop top", "products", "attention", "layernorm", "to barrier", "cluster barrier wait",
        "block barrier wait", "sampling")     # decode_common.cuh dec::Mark, in order
BARRIER_ITERS = 10_000
TOL = 1e-4                                     # log-probs; the same code, so 0 is expected


def _library() -> ctypes.CDLL:
    from mat_dcml_tpu_torch.ops import kernel_lib
    from mat_dcml_tpu_torch.ops.ar_decode import bind_library

    lib = kernel_lib.load("decode_probe")
    if getattr(lib, "_mat_probe_typed", False):
        return lib
    bind_library(lib)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mat_decode_probe_reset.restype = i32
    lib.mat_decode_probe_read.argtypes = [ctypes.POINTER(ctypes.c_longlong),
                                          ctypes.POINTER(i32), i32]
    lib.mat_decode_probe_read.restype = i32
    lib.mat_decode_probe_barriers.argtypes = [i32, i32, ptr, ptr]
    lib.mat_decode_probe_barriers.restype = i32
    lib._mat_probe_typed = True
    return lib


def _model(cfg, seed: int):
    """The DCML MAT on the card with every weight drawn at O(1) scale."""
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


def _dcml_config():
    from mat_dcml_tpu_torch.envs.dcml.constants import DCMLConsts
    from mat_dcml_tpu_torch.models.mat import SEMI_DISCRETE, MATConfig

    c = DCMLConsts()
    return MATConfig(n_agent=c.n_agents, obs_dim=c.local_obs_dim, state_dim=c.sob_dim,
                     action_dim=c.action_dim, n_block=2, n_embd=64, n_head=2,
                     action_type=SEMI_DISCRETE, semi_index=-c.extra_agent)


def _device_ms(fn, iters: int = 20) -> float:
    """Device time per call, ``iters`` calls replayed from one CUDA graph."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
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


def barriers(lib) -> dict:
    """Cycles and nanoseconds of one cluster barrier, alone and after stores."""
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for stores in (0, 1, 0, 1):              # the second pair is the reading kept
        rc = lib.mat_decode_probe_barriers(BARRIER_ITERS, stores, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"barrier probe launch failed: cudaError {rc}")
        cycles, ns = (int(v) for v in out.cpu())
        res["with_stores" if stores else "empty"] = {
            "cycles": cycles / BARRIER_ITERS, "ns": ns / BARRIER_ITERS,
            "cycles_per_ns": cycles / ns}
    return res


def stages(lib, B: int, seed: int = 0) -> dict:
    """One probed decode of B rows: the average position's cycles by step,
    checked against the unprobed kernel, and both kernels' times."""
    from mat_dcml_tpu_torch.ops import ar_decode as ard
    from mat_dcml_tpu_torch.ops.decode_plan import launch_plan
    from mat_dcml_tpu_torch.ops.distributions import gumbel_noise

    cfg = _dcml_config()
    A, D, adim, nd, nb = (cfg.n_agent, cfg.n_embd, cfg.action_dim, cfg.n_discrete_agents,
                          cfg.n_block)
    dev = torch.device("cuda")
    weights = ard.pack_ar_decode_weights(_model(cfg, seed))
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    rep = torch.randn(B, A, D, generator=g, device=dev)
    gumbel = gumbel_noise((B, A, adim), g, dev)
    normal = torch.randn(B, A - nd, adim, generator=g, device=dev)
    avail = (torch.rand(B, A, adim, generator=g, device=dev) > 0.2).float()
    avail[..., 0] = 1.0
    kw = dict(n_head=cfg.n_head, adim=adim, nd=nd)

    plan = launch_plan(lib, "ar_decode", B, n_embd=D, n_head=cfg.n_head, n_block=nb, adim=adim,
                       n_pos=A)
    out = {}

    def probed():
        out["act"], out["logp"] = ard.launch(lib, weights, rep, gumbel, normal, avail,
                                             normal.shape[1], **kw)

    if lib.mat_decode_probe_reset() != 0:
        raise RuntimeError("could not reset the stage clocks")
    probed()
    torch.cuda.synchronize()
    most = 1 << 15
    clocks, tags = (ctypes.c_longlong * most)(), (ctypes.c_int * most)()
    n = lib.mat_decode_probe_read(clocks, tags, most)
    if n <= 0:
        raise RuntimeError(f"no stage clocks read ({n})")
    ref_act, ref_logp = ard.fused_ar_decode(weights, rep, gumbel, normal, avail, **kw)
    act, logp = out["act"], out["logp"]
    err = max((logp - ref_logp).abs().max().item(), (act - ref_act).abs().max().item())

    # positions run from one stamp of the loop's top to the next; the split
    # averages those after position 0 (whose caches are still empty) that
    # have a next stamp, each step's cycles ending at its own stamp
    starts = [k for k in range(n) if tags[k] == 0]
    spans = list(zip(starts[1:-1], starts[2:]))
    per_tag = [0] * len(TAGS)
    waits, bars = [], []
    for k0, k1 in spans:
        for k in range(k0 + 1, k1 + 1):
            per_tag[tags[k]] += clocks[k] - clocks[k - 1]
            if tags[k] == 5:
                waits.append(clocks[k] - clocks[k - 1])
        bars.append(sum(1 for k in range(k0, k1) if tags[k] == 5))
    positions = len(spans)
    split = {TAGS[t]: per_tag[t] / positions for t in range(len(TAGS))}
    ms = _device_ms(probed)
    plain_ms = _device_ms(lambda: ard.fused_ar_decode(weights, rep, gumbel, normal, avail, **kw))
    return {"B": B, "A": A, "positions_split": positions, "max_abs_err": err,
            "cycles_per_position": sum(split.values()), "split_cycles": split,
            "cluster_barriers_per_position": max(bars),
            "cluster_barrier_wait_cycles_median": sorted(waits)[len(waits) // 2],
            "probed_ms": ms, "unprobed_ms": plain_ms,
            "plan": {"rows": plan.rows, "clusters": plan.clusters, "recipe": plan.recipe}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_stages: no CUDA device", file=sys.stderr)
        return 2
    lib = _library()
    bar = barriers(lib)
    for what, r in bar.items():
        print(f"cluster barrier, {what}: {r['cycles']:.1f} cycles, {r['ns']:.1f} ns "
              f"({r['cycles_per_ns']:.3f} cycles a ns)")
    st = stages(lib, args.batch)
    ghz = bar["empty"]["cycles_per_ns"]
    print(f"ar_decode B {st['B']}: probed {st['probed_ms']:.3f} ms, unprobed "
          f"{st['unprobed_ms']:.3f} ms a call; probed vs unprobed max|diff| {st['max_abs_err']:.3g}")
    print(f"one position (average of {st['positions_split']}): {st['cycles_per_position']:.0f} "
          f"cycles = {st['cycles_per_position'] / ghz / 1e3:.2f} us at {ghz:.3f} cycles a ns; "
          f"{st['cluster_barriers_per_position']} cluster barriers, median wait "
          f"{st['cluster_barrier_wait_cycles_median']} cycles")
    for name, cyc in st["split_cycles"].items():
        print(f"  {name:22s} {cyc:9.0f} cycles {cyc / ghz / 1e3:7.2f} us "
              f"{100 * cyc / st['cycles_per_position']:5.1f}%")
    print(json.dumps({"barriers": bar, "stages": st}))
    return 0 if st["max_abs_err"] <= TOL else 1


if __name__ == "__main__":
    sys.exit(main())
