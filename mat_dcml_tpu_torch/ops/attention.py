"""Multi-head attention over the agent axis.

Port of ``mat_dcml_tpu/ops/attention.py``.  Shapes keep the JAX package's
``(batch, heads, length, head_dim)`` layout.  There is one dispatch rule and
no option: a CPU tensor takes the plain PyTorch version, a CUDA tensor the
hand-written kernel (``ops/cuda_attention.py``), which launches or raises.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,
    qk_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scaled dot-product attention.

    Args:
      q: ``(B, H, Lq, Dh)`` queries.
      k: ``(B, H, Lk, Dh)`` keys.
      v: ``(B, H, Lk, Dh)`` values.
      causal: query position i attends only to key positions <= i
        (requires Lq == Lk).
      kv_mask: optional ``(Lk,)`` or ``(B, Lk)`` boolean mask of valid keys.
      qk_mask: the per-query mask of ``spec_decode``; not ported yet.

    Returns:
      ``(B, H, Lq, Dh)`` attention output (before the output projection).
    """
    if qk_mask is not None:
        raise NotImplementedError(
            "qk_mask serves spec_decode only, which the port has not reached "
            "(ROADMAP.md queue 1, item 11)"
        )
    from mat_dcml_tpu_torch.ops.cuda_attention import fused_masked_attention

    # the head-split views go in as they are: the kernels take strides
    return fused_masked_attention(q, k, v, causal=causal, kv_mask=kv_mask)


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """``(B, L, D) -> (B, H, L, D//H)`` (a view)."""
    b, l, d = x.shape
    return x.reshape(b, l, n_head, d // n_head).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``(B, H, L, Dh) -> (B, L, H*Dh)``."""
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)
