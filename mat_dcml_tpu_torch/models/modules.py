"""Shared building blocks for the MAT family, as ``nn.Module``s.

Port of ``mat_dcml_tpu/models/modules.py``.  Attribute names follow the flax
modules' parameter names (``key_p``, ``Dense_0``, ``ln1`` ...), so
``bridge.py`` maps a flax tree onto ``state_dict`` keys one to one.
Initialisation mirrors the reference: orthogonal weights with gain 0.01, or
the ReLU gain sqrt(2) for "activated" layers, and zero biases.

A compute dtype (``dtype``; None is f32) runs the trunk as flax's
``dtype=bfloat16`` does, by explicit casts (not autocast, whose per-op rules
round elsewhere): a :class:`Dense` casts its input, weight and bias to it at
use and adds the bias after the product's rounding (flax's
``dot_general(...) + bias``); a :class:`LayerNorm` takes its statistics and
applies its scale and bias in f32 and returns the compute dtype.  The
parameters stay what they are (f32 in training), so gradients flow back
through the casts into them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mat_dcml_tpu_torch.ops.attention import merge_heads, multi_head_attention, split_heads

GAIN_ACT = math.sqrt(2.0)
GAIN_OUT = 0.01
LN_EPS = 1e-6   # flax LayerNorm's epsilon; torch's default is 1e-5


SQRT_HALF_BF16 = 0.70703125   # sqrt(0.5) rounded to bf16, as jax.nn.gelu rounds it


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU.  On a bf16 tensor it runs ``jax.nn.gelu``'s ops one
    by one, each rounded to bf16 (``0.5 * x * erfc(-x * sqrt(0.5))``, the
    constant in bf16), as flax's bf16 trunk computes it; one rounding of the
    f32 result differs from that in about a third of the elements."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x)
    return (0.5 * x) * torch.special.erfc(-x * SQRT_HALF_BF16)


class Dense(nn.Linear):
    """``nn.Linear`` with the reference's orthogonal init.  ``weight`` is
    ``(out, in)``: the transpose of a flax ``kernel``.  ``dtype``: the
    compute dtype (None: the parameters' own, f32)."""

    def __init__(self, in_features: int, out_features: int, gain: float = GAIN_OUT,
                 bias: bool = True, dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias=bias)
        self.gain = gain
        self.compute_dtype = dtype
        self.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        gain = getattr(self, "gain", None)
        if gain is None:   # called from nn.Linear.__init__, before gain is set
            return
        nn.init.orthogonal_(self.weight, gain, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm`` (eps 1e-6).  With a compute ``dtype`` the
    statistics, scale and bias are f32 and the output is rounded to it."""

    def __init__(self, n: int, dtype: torch.dtype | None = None):
        super().__init__(n, eps=LN_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


def layer_norm(n: int, dtype: torch.dtype | None = None) -> LayerNorm:
    return LayerNorm(n, dtype)


class SelfAttention(nn.Module):
    """QKV attention over the agent axis, with the split projections the
    cached decode uses."""

    def __init__(self, n_embd: int, n_head: int, masked: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if n_embd % n_head:
            raise ValueError(f"n_embd {n_embd} is not a multiple of n_head {n_head}")
        self.n_head = n_head
        self.masked = masked
        self.key_p = Dense(n_embd, n_embd, dtype=dtype)
        self.query_p = Dense(n_embd, n_embd, dtype=dtype)
        self.value_p = Dense(n_embd, n_embd, dtype=dtype)
        self.proj = Dense(n_embd, n_embd, dtype=dtype)

    def forward(self, key: torch.Tensor, value: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
        k = split_heads(self.key_p(key), self.n_head)
        q = split_heads(self.query_p(query), self.n_head)
        v = split_heads(self.value_p(value), self.n_head)
        y = multi_head_attention(q, k, v, causal=self.masked)
        return self.proj(merge_heads(y))

    def project_q_heads(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, L, D) -> (B, H, L, Dh)`` query projection."""
        return split_heads(self.query_p(x), self.n_head)

    def project_kv_heads(self, x: torch.Tensor):
        """Head-split key and value projections for packed-cache writes."""
        return split_heads(self.key_p(x), self.n_head), split_heads(self.value_p(x), self.n_head)

    def attend_heads(self, q_heads: torch.Tensor, k_heads: torch.Tensor,
                     v_heads: torch.Tensor, kv_mask: torch.Tensor) -> torch.Tensor:
        """Attention of head-split queries over head-split cache planes
        ``(B, H, L, Dh)``, keys valid where ``kv_mask`` ``(L,)`` is True."""
        y = multi_head_attention(q_heads, k_heads, v_heads, kv_mask=kv_mask)
        return self.proj(merge_heads(y))


class MlpBlock(nn.Module):
    """Linear-GELU-Linear."""

    def __init__(self, n_embd: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.Dense_0 = Dense(n_embd, n_embd, gain=GAIN_ACT, dtype=dtype)
        self.Dense_1 = Dense(n_embd, n_embd, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(gelu(self.Dense_0(x)))


class EncodeBlock(nn.Module):
    """Post-LN residual encoder block with unmasked attention."""

    def __init__(self, n_embd: int, n_head: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.ln1 = layer_norm(n_embd, dtype)
        self.ln2 = layer_norm(n_embd, dtype)
        self.attn = SelfAttention(n_embd, n_head, masked=False, dtype=dtype)
        self.mlp = MlpBlock(n_embd, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ln1(x + self.attn(x, x, x))
        return self.ln2(x + self.mlp(x))


class DecodeBlock(nn.Module):
    """Causal self-attention over shifted actions, then causal cross-attention
    with the encoder representation as query."""

    def __init__(self, n_embd: int, n_head: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.ln1 = layer_norm(n_embd, dtype)
        self.ln2 = layer_norm(n_embd, dtype)
        self.ln3 = layer_norm(n_embd, dtype)
        self.attn1 = SelfAttention(n_embd, n_head, masked=True, dtype=dtype)
        self.attn2 = SelfAttention(n_embd, n_head, masked=True, dtype=dtype)
        self.mlp = MlpBlock(n_embd, dtype)

    def forward(self, x: torch.Tensor, rep_enc: torch.Tensor) -> torch.Tensor:
        x = self.ln1(x + self.attn1(x, x, x))
        x = self.ln2(rep_enc + self.attn2(key=x, value=x, query=rep_enc))
        return self.ln3(x + self.mlp(x))

    def decode_step_packed(self, x: torch.Tensor, rep_i: torch.Tensor, q2_i: torch.Tensor,
                           kv, layer: int, i: int, valid: torch.Tensor) -> torch.Tensor:
        """One decode position against the packed head-split cache.

        ``kv`` is the ``(k_buf, v_buf)`` pair, each ``(n_layers, B, H, A, Dh)``;
        this block owns plane ``layer`` (attn1) and ``layer + 1`` (attn2).
        Unlike the JAX version, which returns updated buffers, this writes
        position ``i``'s column into the buffers in place.

        Args:
          x: ``(B, 1, D)`` this position's input embedding.
          rep_i: ``(B, 1, D)`` encoder representation at position i.
          q2_i: ``(B, H, 1, Dh)`` pre-projected cross-attention query at i.
          valid: ``(A,)`` bool, True at positions ``<= i``.

        Returns:
          ``(B, 1, D)`` block output.
        """
        k_buf, v_buf = kv
        k1h, v1h = self.attn1.project_kv_heads(x)
        k_buf[layer, :, :, i:i + 1] = k1h
        v_buf[layer, :, :, i:i + 1] = v1h
        q1 = self.attn1.project_q_heads(x)
        y = self.attn1.attend_heads(q1, k_buf[layer], v_buf[layer], valid)
        h = self.ln1(x + y)

        k2h, v2h = self.attn2.project_kv_heads(h)
        k_buf[layer + 1, :, :, i:i + 1] = k2h
        v_buf[layer + 1, :, :, i:i + 1] = v2h
        y2 = self.attn2.attend_heads(q2_i, k_buf[layer + 1], v_buf[layer + 1], valid)
        h2 = self.ln2(rep_i + y2)
        return self.ln3(h2 + self.mlp(h2))


def init_packed_cache(n_block: int, batch: int, length: int, n_embd: int, n_head: int,
                      dtype=torch.float32, device=None):
    """Zeroed ``(2 * n_block, B, H, A, Dh)`` K and V buffers: two attention
    planes per decoder block (attn1, attn2)."""
    shape = (2 * n_block, batch, n_head, length, n_embd // n_head)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def packed_cache_bytes(n_block: int, batch: int, length: int, n_embd: int,
                       dtype=torch.float32) -> int:
    """Size of one :func:`init_packed_cache` allocation (K + V)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * (2 * n_block) * batch * length * n_embd * itemsize
