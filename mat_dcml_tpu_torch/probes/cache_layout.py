"""What each K/V cache layout and row-softmax pattern of the per-position
decode costs on the card: the Hopper counterpart of ``scripts/mosaic_probe.py``.

That script asks which Mosaic store, query and broadcast layouts compile for
the TPU decode kernels.  On Hopper every layout compiles, so this probe
times them instead, at f32, D = 64, L = 101 (DCML's agents), two heads and B
in {8, 128}, with the kernels of ``csrc/cache_layout_probe.cu``:

- ``store``: a decode's per-position K/V writes into a position-major
  ``(L, B, D)`` cache (the TPU kernel's layout) against a batch-major
  ``(B, L, D)`` one;
- ``attend``: one query per position over keys ``0 .. i`` read from each
  layout (the decode's attention; causal attention as a whole);
- ``softmax``: a row softmax reduced by warp shuffles against a shared-memory
  reduction, over the ``B * 2`` score rows of L keys.

Each kernel is checked against a plain PyTorch computation of the same
function before it is timed (device time per call, replayed from a CUDA
graph).  Run on the card:

    python -m mat_dcml_tpu_torch.probes.cache_layout

It prints one line per case and a verdict per question, and exits 1 if a
kernel disagrees with its plain version.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

from mat_dcml_tpu_torch.ops.cuda_attention import attention_plain

launches = 0
D, L, H = 64, 101, 2
BATCHES = (8, 128)
TOL = 1e-5          # f32, summation order only
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
LAYOUTS = ("position_major", "batch_major")


def _library() -> ctypes.CDLL:
    from mat_dcml_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load("cache_layout_probe")
    if getattr(lib, "_mat_typed", False):
        return lib
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.probe_store.argtypes = [ptr, ptr] + [i32] * 3 + [i64, i64, ptr]
    lib.probe_attend.argtypes = [ptr] * 4 + [i32] * 4 + [i64, i64, ptr]
    lib.probe_softmax.argtypes = [ptr, ptr] + [i32] * 3 + [ptr]
    for fn in (lib.probe_store, lib.probe_attend, lib.probe_softmax):
        fn.restype = i32   # cudaError_t
    lib._mat_typed = True
    return lib


def _launched(rc: int, what: str) -> None:
    global launches
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")
    launches += 1


def empty_cache(layout: str, B: int, device) -> torch.Tensor:
    """A ``(L, B, D)``-indexed cache stored in ``layout``."""
    if layout == "position_major":
        return torch.empty(L, B, D, device=device)
    return torch.empty(B, L, D, device=device).transpose(0, 1)


def store(src: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
    """Write ``src (L, B, D)`` into ``cache`` position by position."""
    Lc, B, Dc = src.shape
    _launched(_library().probe_store(src.data_ptr(), cache.data_ptr(), B, Lc, Dc,
                                     cache.stride(0), cache.stride(1),
                                     torch.cuda.current_stream().cuda_stream), "probe_store")
    return cache


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``q (B, L, D)`` over caches ``k``, ``v`` indexed ``(L, B, D)``:
    ``(B, L, D)`` causal attention, H heads."""
    B, Lq, Dq = q.shape
    out = torch.empty_like(q)
    _launched(_library().probe_attend(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      B, Lq, Dq, H, k.stride(0), k.stride(1),
                                      torch.cuda.current_stream().cuda_stream), "probe_attend")
    return out


def softmax(x: torch.Tensor, shuffle: bool) -> torch.Tensor:
    y = torch.empty_like(x)
    _launched(_library().probe_softmax(x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                                       int(shuffle), torch.cuda.current_stream().cuda_stream),
              "probe_softmax")
    return y


def attend_plain(q, k, v):
    """The same attention in plain PyTorch (``cuda_attention.attention_plain``)."""
    def heads(t):                      # (B, L, D) -> (B, H, L, Dh)
        return t.unflatten(-1, (H, D // H)).transpose(1, 2)
    out = attention_plain(heads(q), heads(k.transpose(0, 1)), heads(v.transpose(0, 1)),
                          causal=True)
    return out.transpose(1, 2).flatten(2)


def softmax_plain(x):
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _device_ms(fn, iters: int = 50) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, after a warm-up; inputs stay in L2."""
    for _ in range(3):
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


def _bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run(batches=BATCHES, seed: int = 0, log=print):
    """Check and time every case; returns ``(rows, verdicts)``.  Each row:
    ``question``, ``variant``, ``B``, ``max_abs_err``, ``ms``, ``plain_ms``,
    ``bound_ms``, ``bound_by``, ``library_ms`` (SDPA for ``attend``,
    ``torch.softmax`` for ``softmax``, else None).  Raises if a kernel
    disagrees with its plain version by more than ``TOL``."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = []

    def record(question, variant, B, err, fn, plain, bound, library=None):
        if not err <= TOL:
            raise AssertionError(f"probe {question} {variant} B {B}: error {err} > {TOL}")
        row = dict(question=question, variant=variant, B=B, max_abs_err=err,
                   ms=_device_ms(fn), plain_ms=_device_ms(plain),
                   bound_ms=bound[0], bound_by=bound[1],
                   library_ms=None if library is None else _device_ms(library))
        rows.append(row)
        lib_txt = "" if library is None else f", library {row['library_ms'] * 1e3:.2f} us"
        log(f"[probe] {question} {variant} B {B}: max|kernel - plain| {err:.3g} (tol {TOL}); "
            f"kernel {row['ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f} us{lib_txt}, "
            f"bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")

    for B in batches:
        src = torch.randn(L, B, D, generator=g, device=dev)
        q = torch.randn(B, L, D, generator=g, device=dev)
        for layout in LAYOUTS:
            cache = empty_cache(layout, B, dev)
            err = (store(src, cache) - src).abs().max().item()
            record("store", layout, B, err, lambda: store(src, cache),
                   lambda: cache.copy_(src), _bound_ms(2 * src.numel() * 4, 0))
            k, v = empty_cache(layout, B, dev), empty_cache(layout, B, dev)
            k.copy_(torch.randn(L, B, D, generator=g, device=dev))
            v.copy_(torch.randn(L, B, D, generator=g, device=dev))
            ref = attend_plain(q, k, v)
            err = (attend(q, k, v) - ref).abs().max().item()
            qh, kh, vh = (t.unflatten(-1, (H, D // H)).transpose(1, 2).contiguous()
                          for t in (q, k.transpose(0, 1), v.transpose(0, 1)))
            record("attend", layout, B, err, lambda: attend(q, k, v),
                   lambda: attend_plain(q, k, v),
                   _bound_ms(4 * B * L * D * 4, 4 * B * D * L * (L + 1) / 2),
                   library=lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True))
        x = torch.randn(B * H, L, generator=g, device=dev) * 3.0
        ref = softmax_plain(x)
        for variant, shuffle in (("shared_memory", False), ("warp_shuffle", True)):
            err = (softmax(x, shuffle) - ref).abs().max().item()
            record("softmax", variant, B, err, lambda: softmax(x, shuffle),
                   lambda: softmax_plain(x), _bound_ms(2 * x.numel() * 4, 0),
                   library=lambda: torch.softmax(x, dim=-1))

    verdicts = {}
    for question in ("store", "attend", "softmax"):
        for B in batches:
            cands = [r for r in rows if r["question"] == question and r["B"] == B]
            best = min(cands, key=lambda r: r["ms"])
            other = max(cands, key=lambda r: r["ms"])
            verdicts[f"{question} B={B}"] = (f"{best['variant']} ({best['ms'] * 1e3:.2f} us) over "
                                             f"{other['variant']} ({other['ms'] * 1e3:.2f} us)")
    for k, v in verdicts.items():
        log(f"[probe] verdict {k}: {v}")
    return rows, verdicts


def main() -> int:
    if not torch.cuda.is_available():
        print("cache_layout probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rows, verdicts = run()
    except AssertionError as err:
        print(f"cache_layout probe: {err}", file=sys.stderr)
        return 1
    print(json.dumps({"rows": rows, "verdicts": verdicts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
