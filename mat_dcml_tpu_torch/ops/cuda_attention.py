"""Fused masked attention forward: the CUDA kernel's wrapper and its plain twin.

Port of ``mat_dcml_tpu/ops/pallas_attention.py::fused_masked_attention``
(forward only; the backward is ROADMAP.md queue 2).  The kernel is
``csrc/attention_fwd.cu``, built by ``ops/kernel_lib.py`` and called through
``ctypes``.

``fused_masked_attention`` takes the plain version for a tensor on the CPU
and the kernel for a tensor on a CUDA device; it never falls back from the
kernel.  ``launches`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mat_dcml_tpu_torch.ops.attention import NEG_INF

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_limits: tuple[int, int] | None = None


def _scale(dh: int) -> float:
    # 1 / sqrt(dh) rounded as the XLA path rounds it: in f32, step by step
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


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
    att = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(q.shape[-1])
    if causal:
        lq, lk = q.shape[-2], k.shape[-2]
        tri = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
        att = att.masked_fill(~tri, NEG_INF)
    if kv_mask is not None:
        m = kv_mask[None, None, None, :] if kv_mask.ndim == 1 else kv_mask[:, None, None, :]
        att = att.masked_fill(~m.bool(), NEG_INF)
    att = torch.softmax(att, dim=-1).to(v.dtype)
    return torch.matmul(att, v)


def _library() -> ctypes.CDLL:
    from mat_dcml_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load("attention_fwd")
    if not getattr(lib, "_mat_typed", False):
        lib.mat_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.mat_attention_fwd.restype = ctypes.c_int   # cudaError_t, an int-sized enum
        lib.mat_attention_fwd_max_lk.restype = ctypes.c_int
        lib.mat_attention_fwd_max_dh.restype = ctypes.c_int
        lib._mat_typed = True
    return lib


def kernel_limits() -> tuple[int, int]:
    """``(max Lk, max Dh)`` that the compiled kernel holds (its ``kMaxLk``,
    ``kMaxDh``), read from the library; building it if need be."""
    global _limits
    if _limits is None:
        lib = _library()
        _limits = (lib.mat_attention_fwd_max_lk(), lib.mat_attention_fwd_max_dh())
    return _limits


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
    optional boolean ``(Lk,)`` or ``(B, Lk)`` kv mask.  The kernel sees the
    rows flattened to ``N = B * H`` and reads row n's per-batch mask at
    ``n // H``, so nothing is repeated per head."""
    global launches
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, kv_mask=kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"fused_masked_attention runs on cpu or cuda, got {q.device}")
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
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if B * H < 1 or Lq < 1 or Lk < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    max_lk, max_dh = kernel_limits()
    if Lk > max_lk:
        raise ValueError(f"attention_fwd holds at most Lk = {max_lk} keys, got {Lk}")
    if Dh > max_dh:
        raise ValueError(f"attention_fwd holds at most Dh = {max_dh}, got {Dh}")
    if causal and Lq != Lk:
        raise ValueError("causal attention requires Lq == Lk")
    mask_mode, mask_ptr = 0, None
    if kv_mask is not None:
        if kv_mask.dtype != torch.bool or kv_mask.device != q.device or not kv_mask.is_contiguous():
            raise ValueError("kv_mask must be a contiguous bool tensor on q's device")
        if kv_mask.shape == (Lk,):
            mask_mode = 1
        elif kv_mask.shape == (B, Lk):
            mask_mode = 2
        else:
            raise ValueError(f"kv_mask must be ({Lk},) or ({B}, {Lk}), got {tuple(kv_mask.shape)}")
        mask_ptr = kv_mask.data_ptr()

    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.mat_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
            B * H, Lq, Lk, Dh, H, int(causal), mask_mode, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"attention_fwd launch failed: cudaError {rc}")
    launches += 1
    return out
