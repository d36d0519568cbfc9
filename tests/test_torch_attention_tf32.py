"""Why the attention kernels' f32 legs take three TF32 products: emulated on
the CPU at the PPO update's shape.

``csrc/attention_common.cuh`` splits each f32 operand as ``x = hi + lo``,
``hi`` rounded to TF32 (to nearest, ties away from zero: add half an ulp of
the 10-bit mantissa, clear the 13 low bits) and ``lo = x - hi`` truncated to
TF32, and keeps ``lo*hi' + hi*lo' + hi*hi'`` of every product, accumulated
in f32.  Here the same split is applied by bit arithmetic in torch (the
products of TF32 values are exact in f32, as in the tensor cores) to the
forward and all five backward products, at (100, 2, 101, 32), encoder and
causal.  The 3xTF32 results hold the plain f32 version to today's card
tolerances (forward atol 1e-5, backward 1e-5 x the largest gradient); one
TF32 pass misses them by two orders of magnitude, so it is never used.
"""

import numpy as np
import pytest
import torch

from mat_dcml_tpu_torch.ops.attention import NEG_INF
from mat_dcml_tpu_torch.ops.cuda_attention import _scale, attention_bwd_plain, attention_plain

SHAPE = (100, 2, 101, 32)
FWD_TOL, BWD_TOL = 1e-5, 1e-5
LOW13 = 0x1FFF


def _tf32_round(x):
    return ((x.view(torch.int32) + 0x1000) & ~LOW13).view(torch.float32)


def _tf32_trunc(x):
    return (x.view(torch.int32) & ~LOW13).view(torch.float32)


def _mm3(a, b):
    ah, bh = _tf32_round(a), _tf32_round(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm1(a, b):
    return _tf32_round(a) @ _tf32_round(b)


def _probs(q, k, causal, mm):
    s = mm(q, k.transpose(-1, -2)) * _scale(q.shape[-1])
    if causal:
        tri = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~tri, NEG_INF)
    return torch.softmax(s, dim=-1)


def _emulated(q, k, v, do, causal, mm):
    """Forward output and (dq, dk, dv) with every product through ``mm``."""
    p = _probs(q, k, causal, mm)
    out = mm(p, v)
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * _scale(q.shape[-1])
    return out, (mm(ds, k), mm(ds.transpose(-1, -2), q), mm(p.transpose(-1, -2), do))


@pytest.mark.parametrize("causal", [False, True], ids=["encoder", "causal"])
def test_three_tf32_products_hold_f32_tolerances_and_one_does_not(causal):
    rng = np.random.default_rng(8 + causal)
    q, k, v, do = (torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32)) for _ in range(4))
    ref = attention_plain(q, k, v, causal=causal)
    refs = attention_bwd_plain(q, k, v, do, causal=causal)
    scale = max(1.0, max(r.abs().max().item() for r in refs))
    errs = {}
    for name, mm in (("3xTF32", _mm3), ("TF32", _mm1)):
        out, grads = _emulated(q, k, v, do, causal, mm)
        errs[name] = ((out - ref).abs().max().item(),
                      max((a - b).abs().max().item() for a, b in zip(grads, refs)))
    fwd3, bwd3 = errs["3xTF32"]
    fwd1, bwd1 = errs["TF32"]
    assert fwd3 <= FWD_TOL and bwd3 <= BWD_TOL * scale, errs
    assert fwd1 > 10 * FWD_TOL and bwd1 > 10 * BWD_TOL * scale, errs
