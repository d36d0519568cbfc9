"""The arithmetic of the attention kernels' bf16 legs, emulated on the CPU at
the PPO update's shape, decides their design before the card runs them.

``csrc/attention_fwd.cu`` computes S = Q K^T once a row in f32 (products of
bf16 values are exact), takes the row max m and sum l from it, and forms
P = exp(S - m) / l, rounded to bf16 before P.V; it saves (m, l), the row
statistics.  The division is IEEE's, taken as Markstein's three
instructions: q = x (1 / l) from the rounded reciprocal, then one
correction by the exact residual x - q l.
``csrc/attention_bwd.cu`` recomputes S, forms P from the saved
statistics with the same arithmetic (so the forward's P bit for bit), rounds
dP = dO V^T to bf16, takes D = rowsum(dP o P), dS = P o (dP - D) * scale
(0 where a score is masked), and multiplies dS in two bf16 halves (hi =
bf16(dS), lo = bf16(dS - hi)) into dq = dS K and dk = dS^T Q, and P rounded
into dv = P^T dO.  Here each step is applied in torch at (100, 2, 101, 32),
encoder and causal, and held against the plain version in bf16 to the
card's tolerances (forward 8e-3, backward 2^-7 x the largest gradient) and
against autograd through JAX's XLA path to
``tests/test_torch_attention_grad.py``'s 2^-8 (one bf16 ulp).

The alternatives the design weighed:
- a product by 1 / l instead of the division rounds some P to another bf16
  value, so the forward keeps the division (the test counts them);
- FA2's D = rowsum(dO o O) holds the card's tolerance here but moves a
  fifth of dq's and dk's entries off the plain version's bf16 values (the
  kernel's rowsum(dP o P) moves ~0.2%), and would read O besides; rowsum(dP
  o P) costs the kernel nothing (dP and P are in its registers), so it
  stays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.ops.attention import multi_head_attention as jax_mha
from mat_dcml_tpu_torch.ops.attention import NEG_INF
from mat_dcml_tpu_torch.ops.cuda_attention import (
    _scale,
    attention_bwd_plain,
    attention_plain,
    attention_stats_plain,
)

SHAPE = (100, 2, 101, 32)
FWD_TOL, BWD_TOL, JAX_TOL = 8e-3, 2.0**-7, 2.0**-8


def _inputs(causal):
    rng = np.random.default_rng(14 + causal)
    return [torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32)).bfloat16()
            for _ in range(4)]


def _scores(q, k, causal):
    """Masked f32 scores and the live entries, as the kernels form them."""
    s = (q.float() @ k.float().transpose(-1, -2)) * _scale(q.shape[-1])
    live = torch.ones(s.shape[-2:], dtype=torch.bool)
    if causal:
        live = live.tril()
    return s.masked_fill(~live, NEG_INF), live


def _probs(q, k, causal, stats, reciprocal=False):
    """P from the saved row statistics: exp(S - m) / l (or exp(S - m) * (1 / l))."""
    s, _ = _scores(q, k, causal)
    B, H, L = q.shape[:3]
    m, l = (x.reshape(B, H, L, 1) for x in stats)
    e = torch.exp(s - m)
    return e * (1.0 / l) if reciprocal else e / l


def _forward(q, k, v, causal, stats):
    p = _probs(q, k, causal, stats)
    return (p.bfloat16().float() @ v.float()).bfloat16()


def _split(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _backward(q, k, v, do, causal, stats, fa2_out=None):
    """(dq, dk, dv) as the bf16 backward kernel computes them; with
    ``fa2_out``, D = rowsum(dO o O) instead (FA2)."""
    p = _probs(q, k, causal, stats)
    _, live = _scores(q, k, causal)
    dp = (do.float() @ v.float().transpose(-1, -2)).bfloat16().float()
    if fa2_out is None:
        d = (dp * p).sum(-1, keepdim=True)
    else:
        d = (do.float() * fa2_out.float()).sum(-1, keepdim=True)
    ds = torch.where(live, p * (dp - d) * _scale(q.shape[-1]), torch.zeros(()))
    hi, lo = _split(ds)
    dq = (hi @ k.float() + lo @ k.float()).bfloat16()
    dk = (hi.transpose(-1, -2) @ q.float() + lo.transpose(-1, -2) @ q.float()).bfloat16()
    dv = (p.bfloat16().float().transpose(-1, -2) @ do.float()).bfloat16()
    return dq, dk, dv


def _jax_xla(q, k, v, do, causal):
    """Output and (dq, dk, dv) by jax.vjp through the XLA path, in bf16."""
    args = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)]
    out, vjp = jax.vjp(lambda q, k, v: jax_mha(q, k, v, causal=causal, impl="xla"), *args)
    grads = vjp(jnp.asarray(do.float().numpy(), jnp.bfloat16))
    return (np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads])


def _max_err(a, b):
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


@pytest.mark.parametrize("causal", [False, True], ids=["encoder", "causal"])
def test_redesigned_bf16_arithmetic_holds_the_tolerances(causal):
    q, k, v, do = _inputs(causal)
    stats = attention_stats_plain(q, k, causal=causal).reshape(2, *SHAPE[:3])
    out = _forward(q, k, v, causal, stats)
    grads = _backward(q, k, v, do, causal, stats)

    ref = attention_plain(q, k, v, causal=causal)
    refs = attention_bwd_plain(q, k, v, do, causal=causal)
    scale = max(1.0, max(float(r.float().abs().max()) for r in refs))
    assert float((out.float() - ref.float()).abs().max()) <= FWD_TOL
    assert _max_err(grads, refs) <= BWD_TOL * scale

    jout, jgrads = _jax_xla(q, k, v, do, causal)
    jscale = max(1.0, max(float(np.abs(g).max()) for g in jgrads))
    assert float(np.abs(out.float().numpy() - jout).max()) <= FWD_TOL
    for name, a, b in zip("qkv", grads, jgrads):
        err = float(np.abs(a.float().numpy() - b).max())
        assert err <= JAX_TOL * jscale, f"d{name} vs XLA: {err} > {JAX_TOL} x {jscale}"


@pytest.mark.parametrize("causal", [False, True], ids=["encoder", "causal"])
def test_saved_statistics_give_the_recomputed_probabilities(causal):
    """P from the forward's statistics equals P from statistics recomputed
    in the backward (the old design's first pass), bit for bit: the same
    scores, max and sum."""
    q, k, _, _ = _inputs(causal)
    saved = attention_stats_plain(q, k, causal=causal).reshape(2, *SHAPE[:3])
    s, _ = _scores(q, k, causal)
    m = s.amax(-1)
    recomputed = torch.stack([m, torch.exp(s - m[..., None]).sum(-1)])
    assert torch.equal(_probs(q, k, causal, saved), _probs(q, k, causal, recomputed))


@pytest.mark.parametrize("causal", [False, True], ids=["encoder", "causal"])
def test_kernels_division_is_ieee_division(causal):
    """csrc/attention_common.cuh::div_rn (q = x r with r = 1 / l rounded,
    then q + (x - q l) r, each rounded once) gives x / l bit for bit on
    every probability at the update's shape, where q alone differs on many.
    The exact residual and the last fused step are emulated in f64 (a fused
    step's exact sum rounded to f64 first could only differ from one
    rounding at an f32 midpoint)."""
    q, k, _, _ = _inputs(causal)
    stats = attention_stats_plain(q, k, causal=causal).reshape(2, *SHAPE[:3])
    s, _ = _scores(q, k, causal)
    m, l = (x.reshape(*SHAPE[:3], 1) for x in stats)
    x = torch.exp(s - m)
    r = 1.0 / l
    first = x * r
    residual = (x.double() - first.double() * l.double()).float()   # exact in f32
    corrected = (first.double() + residual.double() * r.double()).float()
    assert torch.equal(corrected, x / l)
    assert int((first != x / l).sum()) > 0


@pytest.mark.parametrize("causal", [False, True], ids=["encoder", "causal"])
def test_rejected_alternatives(causal):
    q, k, v, do = _inputs(causal)
    stats = attention_stats_plain(q, k, causal=causal).reshape(2, *SHAPE[:3])
    # a product by 1 / l rounds some probabilities to another bf16 value:
    # the forward keeps the division
    by_div = _probs(q, k, causal, stats).bfloat16()
    by_mul = _probs(q, k, causal, stats, reciprocal=True).bfloat16()
    assert int((by_div != by_mul).sum()) > 0
    # FA2's D = rowsum(dO o O), O the forward's bf16 output: within the
    # card's tolerance, but it moves a fifth of dq's and dk's entries off
    # the plain version's bf16 values, where rowsum(dP o P) moves ~0.2%
    refs = attention_bwd_plain(q, k, v, do, causal=causal)
    scale = max(1.0, max(float(r.float().abs().max()) for r in refs))
    kept = _backward(q, k, v, do, causal, stats)
    fa2 = _backward(q, k, v, do, causal, stats, fa2_out=_forward(q, k, v, causal, stats))
    assert _max_err(fa2, refs) <= BWD_TOL * scale

    def moved(grads):
        return max(float((a != b).float().mean()) for a, b in zip(grads[:2], refs[:2]))

    assert moved(kept) < 0.01 and moved(fa2) > 10 * moved(kept), (moved(kept), moved(fa2))
