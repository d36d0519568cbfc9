"""Fused masked attention, forward and backward: the CUDA kernels' wrappers and
their plain twin.

Port of ``mat_dcml_tpu/ops/pallas_attention.py::fused_masked_attention`` and
its custom VJP.  The kernels are ``csrc/attention_fwd.cu`` and
``csrc/attention_bwd.cu``, built by ``ops/kernel_lib.py`` and called through
``ctypes``; their launch plan is ``csrc/attention_plan.cuh``.
:class:`FusedAttention` joins them as one ``torch.autograd.Function``: in
bf16 its forward also writes each query row's softmax max and sum (the
*row statistics*, ``(2, B * H, Lq)`` f32), which the backward reads to form
P from the scores it recomputes; the f32 backward finds them itself.  No
probability is saved.

``fused_masked_attention`` takes the plain version for a tensor on the CPU
(autograd runs through it) and the kernels for a tensor on a CUDA device; it
never falls back from a kernel.  Where no gradient will be taken (the
rollout, serving) it launches the forward alone, with no statistics.  The
kernels read and write every operand by its strides, so the model's
head-split views go in without a copy; only the last dimension must have
unit stride.  ``launches`` and ``bwd_launches`` count kernel launches of the
forward and the backward, and nothing else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mat_dcml_tpu_torch.ops.attention import NEG_INF

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0
_limits: dict = {}       # kernel name -> (max Lk, max Dh)
_smem_limit: dict = {}   # device index -> opt-in shared memory of a block


def _scale(dh: int) -> float:
    # 1 / sqrt(dh) rounded as the XLA path rounds it: in f32, step by step
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def _masked_scores(q, k, causal, kv_mask):
    """f32 scores ``q k^T / sqrt(Dh)``, masked entries set to -1e9."""
    att = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(q.shape[-1])
    if causal:
        lq, lk = q.shape[-2], k.shape[-2]
        tri = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
        att = att.masked_fill(~tri, NEG_INF)
    if kv_mask is not None:
        m = kv_mask[None, None, None, :] if kv_mask.ndim == 1 else kv_mask[:, None, None, :]
        att = att.masked_fill(~m.bool(), NEG_INF)
    return att


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """The XLA path of ``mat_dcml_tpu/ops/attention.py::multi_head_attention``:
    f32 scores, masked entries set to -1e9, f32 softmax, probabilities cast
    to ``v.dtype`` before P.V.  ``q (B, H, Lq, Dh)``, ``k/v (B, H, Lk, Dh)``."""
    att = torch.softmax(_masked_scores(q, k, causal, kv_mask), dim=-1).to(v.dtype)
    return torch.matmul(att, v)


def attention_stats_plain(q, k, *, causal=False, kv_mask=None) -> torch.Tensor:
    """The row statistics the forward kernel writes: ``(2, B * H, Lq)`` f32,
    the max of each query row's masked f32 scores (as
    :func:`attention_plain` masks them) and the sum of ``exp(score - max)``
    over its Lk keys.  A row with no visible valid key has every score at
    -1e9, so max -1e9 and sum Lk."""
    att = _masked_scores(q, k, causal, kv_mask)
    mx = att.amax(-1, keepdim=True)
    total = torch.exp(att - mx).sum(-1)
    B, H, Lq = q.shape[:3]
    return torch.stack([mx[..., 0], total]).reshape(2, B * H, Lq)


def attention_bwd_plain(q, k, v, dout, *, causal=False, kv_mask=None):
    """``(dq, dk, dv)`` by autograd through :func:`attention_plain`: the
    backward kernel's plain version (the CPU path, and the yardstick on the
    card)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = attention_plain(*leaves, causal=causal, kv_mask=kv_mask)
        return torch.autograd.grad(out, leaves, dout)


def bind_plan(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launch-plan entry points of a library holding
    ``csrc/attention_plan.cuh`` (either attention library exports them; the
    CPU tests build the header alone); returns ``lib``."""
    i32, i64 = ctypes.c_int, ctypes.c_longlong
    out = ctypes.POINTER(i64)
    lib.mat_attention_fwd_plan.argtypes = [i64] + [i32] * 5 + [out]
    lib.mat_attention_fwd_plan.restype = None
    lib.mat_attention_bwd_plan.argtypes = [i32] * 4 + [i64, out]
    lib.mat_attention_bwd_plan.restype = None
    lib.mat_attention_static_smem.restype = i32
    return lib


FWD_PLAN_FIELDS = ("warps", "rows", "tiles", "ctas", "smem")
BWD_PLAN_FIELDS = ("warps", "planes", "ld", "ldp", "smem")


def fwd_plan(lib, N, Lq, Lk, Dh, esize, sms) -> dict:
    """The forward kernel's launch plan (``attention_plan.cuh::fwd_plan``)."""
    out = (ctypes.c_longlong * 5)()
    lib.mat_attention_fwd_plan(N, Lq, Lk, Dh, esize, sms, out)
    return dict(zip(FWD_PLAN_FIELDS, out))


def bwd_plan(lib, Lq, Lk, Dh, esize, limit) -> dict:
    """The backward kernel's launch plan (``attention_plan.cuh::bwd_plan``)
    for a dynamic shared-memory ``limit``."""
    out = (ctypes.c_longlong * 5)()
    lib.mat_attention_bwd_plan(Lq, Lk, Dh, esize, limit, out)
    return dict(zip(BWD_PLAN_FIELDS, out))


def _library(name: str) -> ctypes.CDLL:
    from mat_dcml_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load(name)
    if getattr(lib, "_mat_typed", False):
        return lib
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "attention_fwd":
        lib.mat_attention_fwd.argtypes = [ptr] * 7 + [i32] * 8 + [ptr]
        lib.mat_attention_fwd.restype = i32   # cudaError_t, an int-sized enum
        lib.mat_attention_fwd_max_lk.restype = i32
        lib.mat_attention_fwd_max_dh.restype = i32
    else:
        lib.mat_attention_bwd.argtypes = [ptr] * 10 + [i32] * 8 + [ptr]
        lib.mat_attention_bwd.restype = i32
        lib.mat_attention_bwd_max_lk.restype = i32
        lib.mat_attention_bwd_max_dh.restype = i32
        lib.mat_attention_bwd_smem_bytes.argtypes = [i32] * 4
        lib.mat_attention_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.mat_attention_bwd_smem_limit.restype = ctypes.c_longlong
    lib._mat_typed = True
    return lib


def kernel_limits(name: str = "attention_fwd") -> tuple[int, int]:
    """``(max Lk, max Dh)`` that the compiled kernel ``name`` holds (its
    ``kMaxLk``, ``kMaxDh``), read from the library; building it if need be."""
    if name not in _limits:
        lib = _library(name)
        _limits[name] = (getattr(lib, f"mat_{name}_max_lk")(), getattr(lib, f"mat_{name}_max_dh")())
    return _limits[name]


def _unit_last(t: torch.Tensor) -> bool:
    return t.stride(-1) == 1 or t.shape[-1] == 1


def _strides(*ts) -> ctypes.Array:
    """Each ``(B, H, L, Dh)`` operand's element strides along b, h and l, in
    one array for the kernel (0 for a dimension of size 1)."""
    vals = [st if n > 1 else 0 for t in ts for n, st in zip(t.shape[:3], t.stride()[:3])]
    return (ctypes.c_longlong * len(vals))(*vals)


def _check(q, k, v, causal, kv_mask, name):
    """Validate a CUDA call; returns ``(mask_mode, mask_ptr)``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, L, Dh)")
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, Dh) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of f32 / bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k, v must be on one device")
    if not all(_unit_last(t) for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous along Dh (unit last stride)")
    if B * H < 1 or Lq < 1 or Lk < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    max_lk, max_dh = kernel_limits(name)
    if Lk > max_lk:
        raise ValueError(f"{name} holds at most Lk = {max_lk} keys, got {Lk}")
    if Dh > max_dh:
        raise ValueError(f"{name} holds at most Dh = {max_dh}, got {Dh}")
    if causal and Lq != Lk:
        raise ValueError("causal attention requires Lq == Lk")
    if kv_mask is None:
        return 0, None
    if kv_mask.dtype != torch.bool or kv_mask.device != q.device or not kv_mask.is_contiguous():
        raise ValueError("kv_mask must be a contiguous bool tensor on q's device")
    if kv_mask.shape == (Lk,):
        return 1, kv_mask.data_ptr()
    if kv_mask.shape == (B, Lk):
        return 2, kv_mask.data_ptr()
    raise ValueError(f"kv_mask must be ({Lk},) or ({B}, {Lk}), got {tuple(kv_mask.shape)}")


def _check_stats(stats, q):
    """``stats`` is None or a contiguous f32 ``(2, B * H, Lq)`` on q's device;
    returns its pointer (or None)."""
    if stats is None:
        return None
    B, H, Lq = q.shape[:3]
    if stats.dtype != torch.float32 or stats.shape != (2, B * H, Lq) \
            or stats.device != q.device or not stats.is_contiguous():
        raise ValueError(f"stats must be a contiguous float32 (2, {B * H}, {Lq}) tensor on "
                         f"q's device, got {stats.dtype} {tuple(stats.shape)} on {stats.device}")
    return stats.data_ptr()


def attention_fwd(q, k, v, *, causal=False, kv_mask=None, stats=None) -> torch.Tensor:
    """Launch ``csrc/attention_fwd.cu`` on CUDA tensors (no autograd).  With
    ``stats`` (see :func:`attention_stats_plain`) the kernel also writes
    each query row's softmax max and sum there."""
    global launches
    mask_mode, mask_ptr = _check(q, k, v, causal, kv_mask, "attention_fwd")
    stats_ptr = _check_stats(stats, q)
    B, H, Lq, Dh = q.shape
    lib = _library("attention_fwd")
    out = torch.empty_like(q)   # q's layout where q is dense: a head-split q merges for free
    with torch.cuda.device(q.device):
        rc = lib.mat_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(), stats_ptr,
            _strides(q, k, v, out), B * H, Lq, k.shape[2], Dh, H, int(causal), mask_mode,
            _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"attention_fwd launch failed: cudaError {rc}")
    launches += 1
    return out


def attention_bwd(q, k, v, dout, *, causal=False, kv_mask=None, stats=None):
    """Launch ``csrc/attention_bwd.cu`` on CUDA tensors: ``(dq, dk, dv)`` of
    ``sum(out * dout)`` for ``out = fused_masked_attention(q, k, v)``.  The
    bf16 leg reads the forward's row statistics from ``stats`` where given,
    and otherwise takes them from the scores it computes; the f32 leg always
    finds them itself."""
    global bwd_launches
    mask_mode, mask_ptr = _check(q, k, v, causal, kv_mask, "attention_bwd")
    stats_ptr = _check_stats(stats, q)
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device \
            or not _unit_last(dout):
        raise ValueError(f"dout must be a {q.dtype} tensor of q's shape {tuple(q.shape)}, "
                         "contiguous along Dh")
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    lib = _library("attention_bwd")
    with torch.cuda.device(q.device):
        if q.device.index not in _smem_limit:
            _smem_limit[q.device.index] = lib.mat_attention_bwd_smem_limit()
        need = lib.mat_attention_bwd_smem_bytes(Lq, Lk, Dh, _DTYPE_CODE[q.dtype])
        limit = _smem_limit[q.device.index]
        if need > limit:
            raise ValueError(f"attention_bwd needs {need} bytes of shared memory at Lq {Lq}, "
                             f"Lk {Lk}, Dh {Dh}; the card lets a block have {limit}")
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        rc = lib.mat_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), mask_ptr, stats_ptr,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, dout, dq, dk, dv),
            B * H, Lq, Lk, Dh, H, int(causal), mask_mode, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"attention_bwd launch failed: cudaError {rc}")
    bwd_launches += 1
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient.  Saves
    ``q, k, v``, the mask and, in bf16, the row statistics the forward
    writes; the backward recomputes the scores.  No gradient for the mask or
    the causal flag."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal):
        ctx.causal = causal
        stats = None
        if q.dtype == torch.bfloat16:
            B, H, Lq = q.shape[:3]
            stats = torch.empty(2, B * H, Lq, dtype=torch.float32, device=q.device)
        out = attention_fwd(q, k, v, causal=causal, kv_mask=kv_mask, stats=stats)
        ctx.save_for_backward(q, k, v, kv_mask, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, stats = ctx.saved_tensors
        if not _unit_last(dout):   # an expanded gradient, as from out.sum(): strides of 0
            dout = dout.contiguous()
        dq, dk, dv = attention_bwd(q, k, v, dout, causal=ctx.causal, kv_mask=kv_mask,
                                   stats=stats)
        return dq, dk, dv, None, None


def fused_masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """``softmax(mask(q k^T / sqrt(Dh))) v`` over ``q (B, H, Lq, Dh)`` and
    ``k/v (B, H, Lk, Dh)``, with an optional causal tril (Lq == Lk) and an
    optional boolean ``(Lk,)`` or ``(B, Lk)`` kv mask.  The kernels see the
    rows flattened to ``N = B * H`` and read row n's per-batch mask at
    ``n // H``, so nothing is repeated per head.  Differentiable in ``q, k,
    v``: on CUDA through :class:`FusedAttention`, on the CPU through the
    plain version."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, kv_mask=kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"fused_masked_attention runs on cpu or cuda, got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FusedAttention.apply(q, k, v, kv_mask, causal)
    return attention_fwd(q, k, v, causal=causal, kv_mask=kv_mask)
