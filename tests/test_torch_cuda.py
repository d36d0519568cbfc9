"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device (decided inside the
fixture, never at import).  This file imports no JAX, so on the card it runs
without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Forward tolerance: f32 atol 1e-5 (summation order only), bf16 atol 8e-3 (both
sides round the probabilities and the output to bf16: about an ulp of the
output); at SMAC's short rows (L 8, 27), whose outputs average few values
and reach 2-4, both times max(1, the largest plain output).  Backward
(against autograd through the plain version): f32 atol 1e-5 relative to the largest reference gradient (summation order only); bf16
2**-7 relative (dq, dk, dv are rounded to bf16 on both sides, dP and P where
plain rounds them, and a sum of 101 terms in a different order can move a
bf16 result by an ulp, at most 2**-7 of its size).

Whole decode (``ar_decode``) against its plain twin at the DCML width (and
at n_embd 256, whose weights the kernel reads from device memory), f32:
log-probs and the tail's actions atol 1e-4, worker actions equal except past
a position whose top-2 plain score margin is below 1e-5 (a near-tie that
summation order may break).

Decode step (``decode_step``) against its plain twin for both continuous
families at the multi-agent MuJoCo width (manyagent_ant 10x2: A = 10, action
8) and at 101 agents (and at n_embd 256, on batch- and position-major
caches), f32, O(1) weights: logits and every cache atol 2e-5 (summation
order only).  The cache-layout probe's kernels against their
plain versions, atol 1e-5.

The decode kernels' bf16 legs (a bf16 trunk: ``MATConfig(dtype="bfloat16")``)
against the plain twins, which round at the same points: on chip at the
recipe's widths and others, in device memory (n_embd 256), and at n_embd 128,
which fits on chip in bf16 only.  Both sides sum in f32 in different orders,
so a value near a bf16 rounding boundary may round the other way on one
side and move what follows by a bf16 ulp: the whole decode's log-probs (and
the tail's action) within ``BF16_DECODE_TOL``, worker actions equal except
past a top-2 margin below ``BF16_NEAR_TIE``; the decode step's logits within
``BF16_STEP_TOL`` and its caches within ``BF16_CACHE_TOL`` (a few bf16 ulps
of values of O(1)).
A bf16 call launches the bf16 leg: it never reaches the plain twin, and a
mixed-dtype or f16 call raises.

The attention kernels' launch plan (query tiles of 16-128 rows, chosen by N)
and the row statistics the bf16 forward saves for the backward: forward and
backward through autograd at every query-tile edge and at N = 1, 2 and 16,
the saved statistics against the plain softmax's max and sum (relative
``STATS_TOL``), and the backward fed them equal bit for bit to the backward
finding them itself.
"""

import dataclasses

import pytest
import torch

from mat_dcml_tpu_torch.models.decode import serve_decode
from mat_dcml_tpu_torch.models.mat import (
    DISCRETE,
    SEMI_DISCRETE,
    MATConfig,
    MultiAgentTransformer,
)
from mat_dcml_tpu_torch.ops import ar_decode as ard
from mat_dcml_tpu_torch.ops import cuda_attention
from mat_dcml_tpu_torch.ops import decode_step as dst
from mat_dcml_tpu_torch.ops.distributions import gumbel_noise

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Lq,Lk,Dh,causal,mask", [
    (128, 101, 101, 32, False, None),          # encoder, bucket 128
    (128, 1, 101, 32, False, "shared"),        # cached decode step
    (4, 101, 101, 32, True, None),             # teacher-forced decoder
    (8, 1, 101, 32, False, "per_batch"),
    (32, 1, 101, 32, False, "shared"),         # bucket 32: 64 rows, clusters of 4 blocks
    (32, 1, 101, 32, False, "per_batch"),
    (1, 1, 101, 32, False, "shared"),          # bucket 1: 2 rows
    (1, 1, 101, 32, False, "per_batch"),
    (3, 7, 128, 128, False, "per_batch"),      # the kernel's limits
    (2, 5, 5, 8, True, "none_valid"),
])
def test_kernel_matches_plain(cuda, dtype, B, Lq, Lk, Dh, causal, mask):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(B, 2, n, Dh, generator=g, device=cuda).to(dtype) for n in (Lq, Lk, Lk))
    m = None
    if mask == "shared":
        m = torch.arange(Lk, device=cuda) <= Lk // 2
    elif mask == "per_batch":
        m = torch.rand(B, Lk, generator=g, device=cuda) > 0.4
    elif mask == "none_valid":
        m = torch.zeros(B, Lk, dtype=torch.bool, device=cuda)
    before = cuda_attention.launches
    out = cuda_attention.fused_masked_attention(q, k, v, causal=causal, kv_mask=m)
    torch.cuda.synchronize()
    assert cuda_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = cuda_attention.attention_plain(q, k, v, causal=causal, kv_mask=m)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_kernel_rejects_what_it_cannot_hold(cuda):
    q = torch.zeros(1, 1, 1, 32, device=cuda)
    k = torch.zeros(1, 1, cuda_attention.kernel_limits()[0] + 1, 32, device=cuda)
    with pytest.raises(ValueError, match="at most Lk"):
        cuda_attention.fused_masked_attention(q, k, k)
    with pytest.raises(ValueError, match="contiguous"):
        kk = torch.zeros(1, 1, 32, 8, device=cuda).transpose(-1, -2)
        cuda_attention.fused_masked_attention(q, kk, kk)


BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Lq,Lk,Dh,causal,mask", [
    (100, 101, 101, 32, False, None),          # encoder in the PPO update
    (100, 101, 101, 32, True, None),           # both decoder attentions
    (4, 101, 101, 32, False, "shared"),
    (8, 1, 101, 32, False, "per_batch"),
    (3, 7, 128, 64, False, "per_batch"),       # Lk at the kernel's limit
    (3, 113, 128, 128, False, "per_batch"),    # f32: two planes in shared memory
    (2, 128, 105, 128, False, "shared"),
    (2, 5, 5, 8, True, "none_valid"),          # fully masked rows: no dq, dk
])
def test_backward_kernel_matches_plain(cuda, dtype, B, Lq, Lk, Dh, causal, mask):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, do = (torch.randn(B, 2, Lq, Dh, generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, 2, Lk, Dh, generator=g, device=cuda).to(dtype) for _ in range(2))
    m = None
    if mask == "shared":
        m = torch.arange(Lk, device=cuda) <= Lk // 2
    elif mask == "per_batch":
        m = torch.rand(B, Lk, generator=g, device=cuda) > 0.4
    elif mask == "none_valid":
        m = torch.zeros(B, Lk, dtype=torch.bool, device=cuda)
    before = cuda_attention.bwd_launches
    grads = cuda_attention.attention_bwd(q, k, v, do, causal=causal, kv_mask=m)
    torch.cuda.synchronize()
    assert cuda_attention.bwd_launches == before + 1
    refs = cuda_attention.attention_bwd_plain(q, k, v, do, causal=causal, kv_mask=m)
    for name, out, ref in zip("qkv", grads, refs):
        assert out.dtype == dtype and out.shape == ref.shape, name
        scale = max(1.0, ref.float().abs().max().item())
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * scale, f"d{name}: {err} > {BWD_TOL[dtype]} * {scale}"


def test_autograd_goes_through_both_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(6, 2, 101, 32, generator=g, device=cuda, requires_grad=True)
               for _ in range(3))
    fwd, bwd = cuda_attention.launches, cuda_attention.bwd_launches
    out = cuda_attention.fused_masked_attention(q, k, v, causal=True)
    (out * out).sum().backward()
    torch.cuda.synchronize()
    assert (cuda_attention.launches, cuda_attention.bwd_launches) == (fwd + 1, bwd + 1)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    ref = cuda_attention.attention_plain(*leaves, causal=True)
    (ref * ref).sum().backward()
    for x, y in zip((q, k, v), leaves):
        assert (x.grad - y.grad).abs().max().item() <= 1e-5 * max(1.0, y.grad.abs().max().item())


def test_backward_kernel_rejects_what_it_cannot_hold(cuda):
    q = torch.zeros(1, 1, 1, 32, device=cuda)
    k = torch.zeros(1, 1, 129, 32, device=cuda)
    with pytest.raises(ValueError, match="at most Lk"):
        cuda_attention.attention_bwd(q, k, k, q)
    # every shape within those limits fits an H100's shared memory (f32 at
    # L = Dh = 128 keeps two planes); a card that lets a block have less
    # gets the error
    q = torch.zeros(1, 1, 128, 128, device=cuda)
    cuda_attention.attention_bwd(q, q, q, q)
    limits = cuda_attention._smem_limit
    saved = limits[q.device.index]
    limits[q.device.index] = 48 * 1024
    try:
        with pytest.raises(ValueError, match="shared memory"):
            cuda_attention.attention_bwd(q, q, q, q)
    finally:
        limits[q.device.index] = saved
    with pytest.raises(ValueError, match="dout"):
        cuda_attention.attention_bwd(q, q, q, q[..., :64].contiguous())


# ------------------------------------------------- tile edges and layouts

EDGES = [1, 15, 16, 17, 100, 101, 113, 128]   # around the 16-row tiles and the 128 limit


def _edge_inputs(device, B, Lq, Lk, Dh, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn(B, 2, Lq, Dh, generator=g, device=device).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, 2, Lk, Dh, generator=g, device=device).to(dtype) for _ in range(2))
    m = torch.rand(B, Lk, generator=g, device=device) > 0.3
    return q, k, v, do, m


def _no_visible_key_mask(device, B, L):
    """Per-batch mask whose first keys are masked: under causal, batch 0's
    rows 0-4 see no valid key, batch 1's row 0 neither, and batch 2 has no
    valid key at all; each such row is the uniform average over all L keys."""
    m = torch.ones(B, L, dtype=torch.bool, device=device)
    m[0, :5] = False
    m[1, 0] = False
    m[2 % B] = False
    return m


def _fwd_agrees(q, k, v, causal, m):
    before = cuda_attention.launches
    out = cuda_attention.fused_masked_attention(q, k, v, causal=causal, kv_mask=m)
    torch.cuda.synchronize()
    assert cuda_attention.launches == before + 1
    ref = cuda_attention.attention_plain(q, k, v, causal=causal, kv_mask=m)
    assert out.dtype == q.dtype and out.shape == q.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[q.dtype], err


def _bwd_agrees(q, k, v, do, causal, m):
    before = cuda_attention.bwd_launches
    grads = cuda_attention.attention_bwd(q, k, v, do, causal=causal, kv_mask=m)
    torch.cuda.synchronize()
    assert cuda_attention.bwd_launches == before + 1
    refs = cuda_attention.attention_bwd_plain(q, k, v, do, causal=causal, kv_mask=m)
    for name, out, ref in zip("qkv", grads, refs):
        assert out.dtype == q.dtype and out.shape == ref.shape, name
        scale = max(1.0, ref.float().abs().max().item())
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= BWD_TOL[q.dtype] * scale, f"d{name}: {err} > {BWD_TOL[q.dtype]} * {scale}"


def _fwd_agrees_scaled(q, k, v, causal, m):
    """:func:`_fwd_agrees` for short rows (L 8-27): an output averages few
    values and reaches 2-4, where a bf16 ulp is 2^-7 of it, so the tolerance
    is TOL x max(1, the largest |plain|), as the backward's is."""
    before = cuda_attention.launches
    out = cuda_attention.fused_masked_attention(q, k, v, causal=causal, kv_mask=m)
    torch.cuda.synchronize()
    assert cuda_attention.launches == before + 1
    ref = cuda_attention.attention_plain(q, k, v, causal=causal, kv_mask=m).float()
    assert out.dtype == q.dtype and out.shape == q.shape
    scale = max(1.0, ref.abs().max().item())
    err = (out.float() - ref).abs().max().item()
    assert err <= TOL[q.dtype] * scale, f"{err} > {TOL[q.dtype]} * {scale}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["keys", "causal"])
def test_kernels_past_the_grid_y_limit(cuda, dtype, causal):
    """N = B * H = 70,000 rows (35,000 x 2 heads, L 8, Dh 32): more than the
    65,535 blocks CUDA allows on a grid's y axis, where the forward once put
    N; a teacher-forced pass over a large minibatch reaches such N."""
    q, k, v, do, m = _edge_inputs(cuda, 35_000, 8, 8, 32, dtype, seed=5)
    m = None if causal else m
    _fwd_agrees_scaled(q, k, v, causal, m)
    _bwd_agrees(q, k, v, do, causal, m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Lk", EDGES)
@pytest.mark.parametrize("Lq", EDGES)
def test_kernels_at_tile_edges(cuda, dtype, Lq, Lk):
    # B = 3: N = 6 rows, not a multiple of a cluster's or a block's rows
    q, k, v, do, m = _edge_inputs(cuda, 3, Lq, Lk, 32, dtype, seed=Lq * 131 + Lk)
    _fwd_agrees(q, k, v, False, m)
    _bwd_agrees(q, k, v, do, False, m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Dh", [8, 32, 64, 128])
@pytest.mark.parametrize("L", EDGES)
def test_kernels_causal_at_tile_edges(cuda, dtype, L, Dh):
    q, k, v, do, m = _edge_inputs(cuda, 3, L, L, Dh, dtype, seed=L * 7 + Dh)
    _fwd_agrees(q, k, v, True, m)
    _bwd_agrees(q, k, v, do, True, m)
    _fwd_agrees(q, k, v, True, None)
    _bwd_agrees(q, k, v, do, True, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("L", [17, 101, 128])
def test_kernels_rows_with_no_visible_valid_key(cuda, dtype, L):
    q, k, v, do, _ = _edge_inputs(cuda, 5, L, L, 32, dtype, seed=L)
    m = _no_visible_key_mask(cuda, 5, L)
    _fwd_agrees(q, k, v, True, m)
    _bwd_agrees(q, k, v, do, True, m)
    _fwd_agrees(q[:, :, :1], k, v, False, m)     # the decode path, batch 2 fully masked


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Lq,causal", [(101, False), (101, True), (1, False)])
def test_kernels_take_head_split_views(cuda, dtype, Lq, causal):
    """q, k, v, dout as the model hands them: (B, L, H * Dh) projections
    viewed as (B, H, L, Dh), unit stride along Dh only; the results equal
    those of contiguous copies, and the output keeps the view's layout."""
    B, H, L, Dh = 8, 2, 101, 32
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(4, B, L, H * Dh, generator=g, device=cuda).to(dtype)

    def heads(t, n):
        return t[:, :n].reshape(B, n, H, Dh).transpose(1, 2)

    q, do = heads(x[0], Lq), heads(x[3], Lq)
    k, v = heads(x[1], L), heads(x[2], L)
    assert not q.is_contiguous() and q.stride(-1) == 1
    m = torch.arange(L, device=cuda) <= 50
    out = cuda_attention.attention_fwd(q, k, v, causal=causal, kv_mask=m)
    ref = cuda_attention.attention_fwd(*(t.contiguous() for t in (q, k, v)), causal=causal,
                                       kv_mask=m)
    torch.cuda.synchronize()
    if Lq == L:   # a dense view: the output takes its layout, so merging heads copies nothing
        assert out.stride() == q.stride()
    assert torch.equal(out, ref)
    grads = cuda_attention.attention_bwd(q, k, v, do, causal=causal, kv_mask=m)
    refs = cuda_attention.attention_bwd(*(t.contiguous() for t in (q, k, v, do)), causal=causal,
                                        kv_mask=m)
    torch.cuda.synchronize()
    for a, b in zip(grads, refs):
        assert torch.equal(a, b)


def test_backward_takes_an_expanded_gradient(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(4, 2, 101, 32, generator=g, device=cuda, requires_grad=True)
               for _ in range(3))
    cuda_attention.fused_masked_attention(q, k, v, causal=True).sum().backward()
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    cuda_attention.attention_plain(*leaves, causal=True).sum().backward()
    for x, y in zip((q, k, v), leaves):
        assert (x.grad - y.grad).abs().max().item() <= 1e-5 * max(1.0, y.grad.abs().max().item())


# ------------------------------------------------------------- whole decode

# ---------------------------------- query tiles, small N, row statistics

# around the forward's query tiles (16 rows a warp, CTAs of 1-8 warps) and the
# 128 limit
TILE_EDGES = [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 101, 128]
STATS_TOL = 1e-5   # the row statistics vs plain, relative to max(1, |plain|)


def _through_autograd(q, k, v, do, causal, m):
    """Forward and gradients through FusedAttention (in bf16 the forward
    writes the row statistics and the backward reads them), one launch of
    each kernel, against the plain version through autograd."""
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    fwd, bwd = cuda_attention.launches, cuda_attention.bwd_launches
    out = cuda_attention.fused_masked_attention(*leaves, causal=causal, kv_mask=m)
    out.backward(do)
    torch.cuda.synchronize()
    assert (cuda_attention.launches, cuda_attention.bwd_launches) == (fwd + 1, bwd + 1)
    refs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    ref = cuda_attention.attention_plain(*refs, causal=causal, kv_mask=m)
    ref.backward(do)
    scale = max(1.0, ref.float().abs().max().item())
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[q.dtype] * scale, f"forward: {err} > {TOL[q.dtype]} * {scale}"
    for name, a, b in zip("qkv", leaves, refs):
        scale = max(1.0, b.grad.float().abs().max().item())
        err = (a.grad.float() - b.grad.float()).abs().max().item()
        assert err <= BWD_TOL[q.dtype] * scale, f"d{name}: {err} > {BWD_TOL[q.dtype]} * {scale}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["keys", "causal"])
@pytest.mark.parametrize("B", [1, 20, 128])   # N 2, 40, 256: CTAs of 1, 2, up to 8 warps
@pytest.mark.parametrize("L", TILE_EDGES)
def test_kernels_at_query_tile_edges(cuda, dtype, L, B, causal):
    q, k, v, do, m = _edge_inputs(cuda, B, L, L, 32, dtype, seed=L * 17 + B)
    _through_autograd(q, k, v, do, causal, m)
    _fwd_agrees_scaled(q, k, v, causal, m)   # no gradient: no statistics


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["keys", "causal"])
@pytest.mark.parametrize("B,H", [(1, 1), (1, 2), (8, 2)], ids=["N1", "N2", "N16"])
def test_kernels_at_small_n(cuda, dtype, B, H, causal):
    """N = B * H of 1, 2 and 16 rows at L = 101: every query tile a CTA of
    its own (the rollout's N = 16 gives 112)."""
    g = torch.Generator(device=cuda).manual_seed(B * 10 + H)
    q, k, v, do = (torch.randn(B, H, 101, 32, generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    m = torch.rand(B, 101, generator=g, device=cuda) > 0.3
    _fwd_agrees(q, k, v, causal, m)
    _through_autograd(q, k, v, do, causal, m)
    _bwd_agrees(q, k, v, do, causal, None)


@pytest.mark.parametrize("mask", [None, "per_batch", "no_visible_key"])
@pytest.mark.parametrize("causal", [False, True], ids=["keys", "causal"])
def test_backward_reads_the_forward_statistics(cuda, monkeypatch, causal, mask):
    """After a real FusedAttention forward in bf16, the backward gets the
    forward's row statistics (the plain softmax's max and sum), and gives
    bit for bit what it gives finding them itself: the same scores and the
    same arithmetic on both sides."""
    q, k, v, do, m = _edge_inputs(cuda, 5, 101, 101, 32, torch.bfloat16, seed=21 + causal)
    m = {None: None, "per_batch": m, "no_visible_key": _no_visible_key_mask(cuda, 5, 101)}[mask]
    seen = {}
    real = cuda_attention.attention_bwd

    def spy(*args, **kwargs):
        seen["stats"] = kwargs["stats"]
        return real(*args, **kwargs)

    monkeypatch.setattr(cuda_attention, "attention_bwd", spy)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    cuda_attention.fused_masked_attention(*leaves, causal=causal, kv_mask=m).backward(do)
    torch.cuda.synchronize()
    stats = seen["stats"]
    assert stats is not None and stats.shape == (2, 10, 101) and stats.dtype == torch.float32
    ref = cuda_attention.attention_stats_plain(q, k, causal=causal, kv_mask=m)
    assert ((stats - ref).abs() / ref.abs().clamp(min=1.0)).max().item() <= STATS_TOL
    alone = real(q, k, v, do, causal=causal, kv_mask=m)
    torch.cuda.synchronize()
    for name, x, y in zip("qkv", leaves, alone):
        assert torch.equal(x.grad, y), f"d{name}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_writes_statistics_only_for_a_gradient(cuda, monkeypatch, dtype):
    """Under no_grad (the rollout, serving, the Lq = 1 decode) or without an
    input that needs a gradient, no statistics are allocated or written;
    with a gradient to take, the bf16 forward writes them (the f32 backward
    finds its own)."""
    seen = []
    real = cuda_attention.attention_fwd

    def spy(*args, **kwargs):
        seen.append(kwargs.get("stats"))
        return real(*args, **kwargs)

    monkeypatch.setattr(cuda_attention, "attention_fwd", spy)
    q, k, v, _, m = _edge_inputs(cuda, 4, 101, 101, 32, dtype, seed=7)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    with torch.no_grad():
        cuda_attention.fused_masked_attention(*leaves, causal=True, kv_mask=m)
        cuda_attention.fused_masked_attention(leaves[0][:, :, :1], *leaves[1:], kv_mask=m)
    cuda_attention.fused_masked_attention(q, k, v, kv_mask=m)
    assert seen == [None, None, None]
    cuda_attention.fused_masked_attention(*leaves, causal=True, kv_mask=m)
    assert (seen[-1] is not None) == (dtype == torch.bfloat16)


DCML = MATConfig(n_agent=101, obs_dim=7, state_dim=102, action_dim=2, n_block=2, n_embd=64,
                 n_head=2, action_type=SEMI_DISCRETE, semi_index=-1)
DECODE_TOL = 1e-4
NEAR_TIE = 1e-5


def _dcml_model(device, seed=0, cfg=DCML):
    """The DCML-width MAT (or ``cfg``'s) with every weight redrawn at O(1)
    scale: the reference init's 0.01-gain heads give logits near 0 and
    near-ties everywhere."""
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
    return model.to(device)


def _decode_inputs(device, B, noise, masked, seed, cfg=DCML):
    A, adim = cfg.n_agent, cfg.action_dim
    g = torch.Generator(device=device).manual_seed(seed)
    rep = torch.randn(B, A, cfg.n_embd, generator=g, device=device).to(cfg.trunk_dtype)
    gumbel = gumbel_noise((B, A, adim), g, device) if noise else torch.zeros(B, A, adim,
                                                                            device=device)
    normal = torch.randn(B, 1, adim, generator=g, device=device) * float(noise)
    avail = None
    if masked:
        avail = (torch.rand(B, A, adim, generator=g, device=device) > 0.2).float()
        avail[..., 0] = 1.0
    return rep, gumbel, normal, avail


def _check_decodes_agree(act, logp, ref_act, ref_logp, scores, nd, tol=DECODE_TOL,
                         near_tie=NEAR_TIE):
    """Row by row: worker actions equal up to the first difference, which is
    allowed only at a near-tie of the reference's scores; log-probs (and the
    tail's action where the row never diverged) within ``tol`` before it."""
    act, logp, ref_act, ref_logp, scores = (x.cpu() for x in (act, logp, ref_act, ref_logp,
                                                               scores))
    for b in range(act.shape[0]):
        diff = (act[b, :nd] != ref_act[b, :nd]).nonzero()
        end = act.shape[1] if diff.numel() == 0 else int(diff[0])
        if diff.numel():
            top2 = scores[b, end].sort().values[-2:]
            assert top2[1] - top2[0] < near_tie, f"row {b}: action differs at agent {end}"
        elif nd < act.shape[1]:   # the discrete family has no tail
            assert (act[b, nd:] - ref_act[b, nd:]).abs().max() <= tol, f"row {b}: tail"
        if end:
            assert (logp[b, :end] - ref_logp[b, :end]).abs().max() <= tol, f"row {b}"


def _ar_decode_against_plain(device, cfg, B, noise, masked, seed, on_chip, recipe=None):
    """One kernel decode against the plain twin: one launch, the plan's path
    (weights in shared memory, or in device memory) and, where given, its
    kernel (the recipe's or the generic one), agreement."""
    weights = ard.pack_ar_decode_weights(_dcml_model(device, cfg=cfg))
    rep, gumbel, normal, avail = _decode_inputs(device, B, noise, masked, seed=seed, cfg=cfg)
    kw = dict(n_head=cfg.n_head, adim=cfg.action_dim, nd=cfg.n_discrete_agents)
    plan = ard.kernel_plan(B, cfg.n_agent, n_embd=cfg.n_embd, n_head=cfg.n_head,
                           n_block=cfg.n_block, adim=cfg.action_dim, dtype=cfg.trunk_dtype)
    assert plan.on_chip == on_chip
    assert recipe is None or plan.recipe == recipe
    before = ard.launches
    act, logp = ard.fused_ar_decode(weights, rep, gumbel, normal, avail, **kw)
    torch.cuda.synchronize()
    assert ard.launches == before + 1
    assert act.shape == logp.shape == (B, cfg.n_agent)
    assert torch.isfinite(act).all() and torch.isfinite(logp).all()
    ref = ard.ar_decode_plain(weights, rep, gumbel, normal, avail, return_scores=True, **kw)
    assert ard.launches == before + 1
    bf16 = cfg.dtype == "bfloat16"
    _check_decodes_agree(act, logp, *ref, cfg.n_discrete_agents,
                         tol=BF16_DECODE_TOL if bf16 else DECODE_TOL,
                         near_tie=BF16_NEAR_TIE if bf16 else NEAR_TIE)


@pytest.mark.parametrize("masked", [True, False], ids=["avail", "avail_none"])
@pytest.mark.parametrize("noise", [False, True], ids=["deterministic", "noise"])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 17, 128])
def test_ar_decode_kernel_matches_plain(cuda, B, noise, masked):
    # DCML width: weights in shared memory, the kernel compiled for the
    # recipe's widths, 2 rows a cluster up to B = 32 (odd B leaves the last
    # cluster half full), 8 at B = 128
    _ar_decode_against_plain(cuda, DCML, B, noise, masked, seed=B, on_chip=True, recipe=True)


@pytest.mark.parametrize("B", [3, 40])
@pytest.mark.parametrize("width", [dict(n_head=4), dict(n_embd=32)], ids=["4_heads", "n_embd_32"])
def test_ar_decode_generic_kernel_on_chip(cuda, width, B):
    # off the recipe's widths the weights still fit on chip, and the generic
    # kernel (widths and local matrices read at run time) runs, at 2 rows a
    # cluster (B 3) and at 8 (B 40)
    cfg = dataclasses.replace(DCML, **width)
    _ar_decode_against_plain(cuda, cfg, B, True, True, seed=B + 11, on_chip=True, recipe=False)


@pytest.mark.parametrize("masked", [True, False], ids=["avail", "avail_none"])
@pytest.mark.parametrize("B", [3, 9])
@pytest.mark.parametrize("A", [1, 2, 10])
def test_ar_decode_kernel_short_decodes(cuda, A, B, masked):
    # A - 1 workers and the Gaussian tail agent (A = 1: the tail alone)
    cfg = dataclasses.replace(DCML, n_agent=A)
    _ar_decode_against_plain(cuda, cfg, B, True, masked, seed=A * 31 + B, on_chip=True)


# SMAC's discrete whole decodes: 8m (8 agents, 14 actions) and the multi-map
# layout (27 agents, 36 actions), no Gaussian tail
SMAC_8M = MATConfig(n_agent=8, obs_dim=80, state_dim=168, action_dim=14, n_block=2, n_embd=64,
                    n_head=2, action_type=DISCRETE)
SMAC_MULTI = dataclasses.replace(SMAC_8M, n_agent=27, obs_dim=869, state_dim=1754,
                                 action_dim=36)


def smac_masks(device, B, A, adim, seed):
    """SMAC-like availability ``(B, A, adim)``: a fifth of the agents dead
    (the no-op alone), the rest stop, some moves and some attacks."""
    g = torch.Generator(device=device).manual_seed(seed)
    avail = (torch.rand(B, A, adim, generator=g, device=device) > 0.5).float()
    avail[..., 0], avail[..., 1] = 0.0, 1.0
    dead = torch.rand(B, A, generator=g, device=device) < 0.2
    avail[dead] = 0.0
    avail[..., 0][dead] = 1.0
    return avail


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("noise", [False, True], ids=["deterministic", "noise"])
@pytest.mark.parametrize("cfg,B,recipe", [(SMAC_8M, 32, True), (SMAC_8M, 1, True),
                                          (SMAC_MULTI, 36, False), (SMAC_MULTI, 8, False)],
                         ids=["8m_b32", "8m_b1", "multi_b36", "multi_b8"])
def test_ar_decode_kernel_at_smac_widths(cuda, cfg, B, recipe, noise, dtype):
    """The discrete family (``nd = A``) on SMAC masks: the plan of
    ``tests/test_torch_decode_plan.py`` (the multi-map widths take the
    generic kernel in f32), agreement with the plain twin, and every action
    available: a masked action (-1e10) is never drawn."""
    cfg = dataclasses.replace(cfg, dtype=dtype)
    weights = ard.pack_ar_decode_weights(_dcml_model(cuda, cfg=cfg, seed=B))
    rep, gumbel, normal, _ = _decode_inputs(cuda, B, noise, False, seed=B, cfg=cfg)
    avail = smac_masks(cuda, B, cfg.n_agent, cfg.action_dim, seed=B + 1)
    plan = ard.kernel_plan(B, cfg.n_agent, n_embd=cfg.n_embd, n_head=cfg.n_head,
                           n_block=cfg.n_block, adim=cfg.action_dim, dtype=cfg.trunk_dtype)
    assert plan.on_chip and plan.recipe == (recipe or dtype == "bfloat16")
    kw = dict(n_head=cfg.n_head, adim=cfg.action_dim, nd=cfg.n_agent)
    before = ard.launches
    act, logp = ard.fused_ar_decode(weights, rep, gumbel, normal, avail, **kw)
    torch.cuda.synchronize()
    assert ard.launches == before + 1
    picked = avail.gather(-1, act.long()[..., None])
    assert (picked == 1).all()
    dead = avail[..., 1] == 0
    assert (logp[dead] == 0).all()
    ref = ard.ar_decode_plain(weights, rep, gumbel, normal, avail, return_scores=True, **kw)
    bf16 = dtype == "bfloat16"
    _check_decodes_agree(act, logp, *ref, cfg.n_agent,
                         tol=BF16_DECODE_TOL if bf16 else DECODE_TOL,
                         near_tie=BF16_NEAR_TIE if bf16 else NEAR_TIE)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N,L,causal", [(6400, 8, False), (6400, 8, True), (64, 8, False),
                                        (7200, 27, True), (72, 27, False)],
                         ids=["8m_update", "8m_update_causal", "8m_rollout", "multi_update",
                              "multi_rollout"])
def test_attention_kernels_at_smac_shapes(cuda, dtype, N, L, causal):
    """SMAC's attentions: L = 8 and 27 agents, far below one 16-row tile, at
    the update's N = B * H (3,200 and 3,600 rows x 2 heads) and the
    rollout's (32 and 36 x 2)."""
    q, k, v, do, m = _edge_inputs(cuda, N // 2, L, L, 32, dtype, seed=N + L)
    _fwd_agrees_scaled(q, k, v, causal, None)
    _bwd_agrees(q, k, v, do, causal, None)


@pytest.mark.parametrize("noise", [False, True], ids=["deterministic", "noise"])
@pytest.mark.parametrize("B", [1, 9, 17])
def test_ar_decode_kernel_weights_in_device_memory(cuda, B, noise):
    # n_embd 256: no cluster holds the weight slices, so the same body reads
    # them (and keeps the caches) in device memory, 8 rows a cluster
    cfg = dataclasses.replace(DCML, n_embd=256)
    _ar_decode_against_plain(cuda, cfg, B, noise, True, seed=B + 7, on_chip=False)


def test_ar_decode_rejects_what_it_cannot_run(cuda):
    weights = ard.pack_ar_decode_weights(_dcml_model(cuda))
    rep, gumbel, normal, avail = _decode_inputs(cuda, 2, True, True, seed=0)
    kw = dict(n_head=DCML.n_head, adim=DCML.action_dim, nd=DCML.n_discrete_agents)
    # one trunk dtype: a bf16 obs_rep with f32 weights, or the other way
    # round, or a bf16 head, is a mixed call
    with pytest.raises(ValueError, match="trunk's matrices"):
        ard.fused_ar_decode(weights, rep.bfloat16(), gumbel, normal, avail, **kw)
    with pytest.raises(ValueError, match="trunk's matrices"):
        bf16 = ard.ARDecodeWeights(*(t.bfloat16() for t in weights))
        ard.fused_ar_decode(bf16, rep, gumbel, normal, avail, **kw)
    with pytest.raises(ValueError, match="f32 or a bf16 trunk"):
        ard.fused_ar_decode(weights, rep.half(), gumbel, normal, avail, **kw)
    with pytest.raises(ValueError, match="one device"):
        ard.fused_ar_decode(weights, rep, gumbel.cpu(), normal, avail, **kw)
    with pytest.raises(ValueError, match="one device"):
        ard.fused_ar_decode(ard.ARDecodeWeights(*(t.cpu() for t in weights)), rep, gumbel,
                            normal, avail, **kw)
    most = ard.kernel_limits()
    with pytest.raises(ValueError, match="at most .* heads"):
        ard.fused_ar_decode(weights, rep, gumbel, normal, avail,
                            **dict(kw, n_head=2 * most["heads"]))
    long_a = most["a"] + 1
    big = torch.zeros(1, long_a, DCML.n_embd, device=cuda)
    with pytest.raises(ValueError, match="at most .* agents"):
        ard.fused_ar_decode(weights, big, torch.zeros(1, long_a, 2, device=cuda),
                            torch.zeros(1, 1, 2, device=cuda), None,
                            **dict(kw, nd=long_a - 1))
    with pytest.raises(ValueError, match="contiguous"):
        ard.fused_ar_decode(weights, rep.transpose(0, 1).contiguous().transpose(0, 1), gumbel,
                            normal, avail, **kw)


def test_scan_serve_decode_launches_the_kernel_once(cuda):
    model = _dcml_model(cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    state = torch.randn(4, DCML.n_agent, DCML.state_dim, generator=g, device=cuda)
    obs = torch.randn(4, DCML.n_agent, DCML.obs_dim, generator=g, device=cuda)
    for deterministic in (True, False):
        before, attn = ard.launches, cuda_attention.launches
        _, res = serve_decode(model, state, obs, None, deterministic=deterministic, mode="scan",
                              device=cuda, generator=g)
        torch.cuda.synchronize()
        assert ard.launches == before + 1
        assert cuda_attention.launches == attn + DCML.n_block   # the encoder's attentions
        assert res.action.shape == (4, DCML.n_agent, 1)


STEP_TOL = 2e-5
# bf16 kernel vs plain (measured on an H100, B 1-128, n_embd 64-256: log-probs
# and the tail's action <= 0.03, near-tie margins <= 0.013, logits <= 0.02,
# caches <= 0.031, a bf16 ulp or two of values in [2, 4))
BF16_DECODE_TOL = 0.1
BF16_NEAR_TIE = 5e-2
BF16_STEP_TOL = 5e-2
BF16_CACHE_TOL = 2.0**-4


def _mujoco_cfg(family, n_agent):
    """MAT at manyagent_ant 10x2's widths (obs 36, state 240, action 8)."""
    return MATConfig(n_agent=n_agent, obs_dim=36, state_dim=240, action_dim=8, n_block=2,
                     n_embd=64, n_head=2, action_type=family)


def _decode_step_against_plain(device, cfg, B, i, position_major, on_chip, seed, recipe=None):
    """One kernel position against the plain twin on batch-major caches
    (``decode_caches``) or position-major ones: logits and every cache; the
    plan's path and, where given, its kernel (the recipe's or the generic)."""
    A, dt = cfg.n_agent, cfg.trunk_dtype
    weights = dst.pack_decode_weights(_dcml_model(device, seed=seed, cfg=cfg))
    plan = dst.kernel_plan(B, A, cfg.action_input_dim, n_embd=cfg.n_embd, n_head=cfg.n_head,
                           n_block=cfg.n_block, adim=cfg.action_dim, dtype=dt)
    assert plan.on_chip == on_chip
    assert recipe is None or plan.recipe == recipe
    g = torch.Generator(device=device).manual_seed(B)
    if position_major:
        caches = torch.empty(4 * cfg.n_block, A, B, cfg.n_embd, device=device, dtype=dt)
    else:
        caches = dst.decode_caches(cfg.n_block, A, B, cfg.n_embd, device, dtype=dt)
    caches.copy_(torch.randn(caches.shape, generator=g, device=device))
    x_in = torch.randn(B, cfg.action_input_dim, generator=g, device=device).to(dt)
    rep = torch.randn(B, A, cfg.n_embd, generator=g, device=device).to(dt)
    mine, ref = caches.clone(), caches.clone()
    assert mine.stride() == caches.stride()
    before = dst.launches
    out = dst.fused_decode_step(weights, x_in, rep[:, i], mine, i, n_head=cfg.n_head,
                                adim=cfg.action_dim)
    torch.cuda.synchronize()
    assert dst.launches == before + 1
    want = dst.decode_step_plain(weights, x_in, rep[:, i], ref, i, n_head=cfg.n_head,
                                 adim=cfg.action_dim)
    assert dst.launches == before + 1
    assert out.shape == (B, cfg.action_dim) and out.dtype == torch.float32
    if dt == torch.bfloat16:
        err = (out - want).abs().max().item()
        cerr = (mine.float() - ref.float()).abs().max().item()
        assert err <= BF16_STEP_TOL, f"logits {err}"
        assert cerr <= BF16_CACHE_TOL, f"caches {cerr}"
    else:
        assert (out - want).abs().max() <= STEP_TOL
        assert (mine - ref).abs().max() <= STEP_TOL
    assert torch.equal(mine[:, :i], caches[:, :i])
    assert torch.equal(mine[:, i + 1:], caches[:, i + 1:])


@pytest.mark.parametrize("B", [3, 9])
@pytest.mark.parametrize("A", [1, 2, 10])
@pytest.mark.parametrize("layout", ["batch_major", "position_major"])
@pytest.mark.parametrize("n_embd", [64, 256], ids=["on_chip", "device_memory"])
def test_decode_step_kernel_layouts_and_paths(cuda, n_embd, layout, A, B):
    # n_embd 256: the weight slices do not fit, the same body reads them
    # from device memory
    cfg = dataclasses.replace(_mujoco_cfg("continuous", A), n_embd=n_embd)
    _decode_step_against_plain(cuda, cfg, B, A - 1, layout == "position_major", n_embd == 64,
                               seed=A)


@pytest.mark.parametrize("i_at", ["first", "mid", "last"])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 17, 128])
@pytest.mark.parametrize("A", [10, 101])
@pytest.mark.parametrize("family", ["continuous", "available_continuous"])
def test_decode_step_kernel_matches_plain(cuda, family, A, B, i_at):
    i = {"first": 0, "mid": A // 2, "last": A - 1}[i_at]
    # the recipe's kernel, except at 8 rows a cluster over 101 positions,
    # whose scores take the room of the second MLP layer: another set of
    # local matrices, so the generic kernel
    _decode_step_against_plain(cuda, _mujoco_cfg(family, A), B, i, False, True, seed=A,
                               recipe=not (B == 128 and A == 101))


@pytest.mark.parametrize("B", [3, 40])
@pytest.mark.parametrize("width", [dict(n_head=4), dict(n_embd=32)], ids=["4_heads", "n_embd_32"])
def test_decode_step_generic_kernel_on_chip(cuda, width, B):
    # off the recipe's widths: the generic on-chip kernel, at 2 rows a
    # cluster (B 3) and at 8 (B 40)
    cfg = dataclasses.replace(_mujoco_cfg("continuous", 10), **width)
    _decode_step_against_plain(cuda, cfg, B, 9, False, True, seed=B, recipe=False)


def test_decode_step_rejects_what_it_cannot_run(cuda):
    cfg = _mujoco_cfg("continuous", 10)
    weights = dst.pack_decode_weights(_dcml_model(cuda, cfg=cfg))
    caches = dst.decode_caches(cfg.n_block, 10, 2, cfg.n_embd, cuda)
    x_in = torch.zeros(2, cfg.action_input_dim, device=cuda)
    rep = torch.zeros(2, cfg.n_embd, device=cuda)
    kw = dict(n_head=cfg.n_head, adim=cfg.action_dim)
    # one trunk dtype for x_in, rep, the caches and the trunk's matrices
    with pytest.raises(ValueError, match="the caches and the trunk's matrices"):
        dst.fused_decode_step(weights, x_in.bfloat16(), rep, caches, 0, **kw)
    with pytest.raises(ValueError, match="the caches and the trunk's matrices"):
        dst.fused_decode_step(weights, x_in.bfloat16(), rep.bfloat16(), caches.bfloat16(), 0,
                              **kw)
    with pytest.raises(ValueError, match="f32 or a bf16 trunk"):
        dst.fused_decode_step(weights, x_in.half(), rep.half(), caches.half(), 0, **kw)
    with pytest.raises(ValueError, match="one device"):
        dst.fused_decode_step(weights, x_in.cpu(), rep, caches, 0, **kw)
    with pytest.raises(ValueError, match="at most .* heads"):
        dst.fused_decode_step(weights, x_in, rep, caches, 0,
                              **dict(kw, n_head=2 * dst.kernel_limits()["heads"]))
    long_l = dst.kernel_limits()["l"] + 1
    with pytest.raises(ValueError, match="at most .* positions"):
        dst.fused_decode_step(weights, x_in, rep,
                              dst.decode_caches(cfg.n_block, long_l, 2, cfg.n_embd, cuda), 0, **kw)
    with pytest.raises(ValueError, match="contiguous last dim"):
        dst.fused_decode_step(weights, x_in, torch.zeros(cfg.n_embd, 2, device=cuda).t(),
                              caches, 0, **kw)


@pytest.mark.parametrize("mode", ["cached", "scan"])
def test_continuous_scan_decode_launches_once_a_position(cuda, mode):
    cfg = _mujoco_cfg("continuous", 10)
    model = _dcml_model(cuda, cfg=cfg)
    g = torch.Generator(device=cuda).manual_seed(4)
    state = torch.randn(8, 10, cfg.state_dim, generator=g, device=cuda)
    obs = torch.randn(8, 10, cfg.obs_dim, generator=g, device=cuda)
    before = dst.launches
    _, res = serve_decode(model, state, obs, None, deterministic=False, mode=mode, device=cuda,
                          generator=g)
    torch.cuda.synchronize()
    assert dst.launches == before + (10 if mode == "scan" else 0)
    assert res.action.shape == res.log_prob.shape == (8, 10, cfg.action_dim)
    assert torch.isfinite(res.action).all() and torch.isfinite(res.log_prob).all()


def test_cache_layout_probe_kernels_match_plain(cuda):
    from mat_dcml_tpu_torch.probes import cache_layout

    rows, verdicts = cache_layout.run(batches=(8,), log=lambda *_: None)
    assert {(r["question"], r["variant"]) for r in rows} == {
        ("store", "position_major"), ("store", "batch_major"), ("attend", "position_major"),
        ("attend", "batch_major"), ("softmax", "shared_memory"), ("softmax", "warp_shuffle")}
    assert all(r["max_abs_err"] <= cache_layout.TOL and r["ms"] > 0 for r in rows)
    assert set(verdicts) == {"store B=8", "attend B=8", "softmax B=8"}


def test_decode_stage_probe_matches_the_kernel(cuda):
    # the probe build of ar_decode.cu (stage clocks on) decodes as the kernel
    # does, and splits a position into steps whose cycles add up
    from mat_dcml_tpu_torch.probes import decode_stages

    lib = decode_stages._library()
    bar = decode_stages.barriers(lib)
    assert bar["empty"]["cycles"] > 0 and bar["with_stores"]["cycles"] > 0
    st = decode_stages.stages(lib, 8)
    assert st["max_abs_err"] <= decode_stages.TOL
    assert st["cluster_barriers_per_position"] == ard.kernel_plan(
        8, DCML.n_agent, n_embd=64, n_head=2, n_block=2, adim=DCML.action_dim).barriers
    assert st["cycles_per_position"] == pytest.approx(sum(st["split_cycles"].values()))


# ------------------------------------------------------- the bf16 legs

BF16 = dataclasses.replace(DCML, dtype="bfloat16")


@pytest.mark.parametrize("noise", [False, True], ids=["deterministic", "noise"])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 17, 128])
def test_ar_decode_bf16_kernel_matches_plain(cuda, B, noise):
    # the recipe's widths, bf16: every optional matrix local at 2 and at 8
    # rows a cluster
    _ar_decode_against_plain(cuda, BF16, B, noise, True, seed=B + 100, on_chip=True, recipe=True)


@pytest.mark.parametrize("B", [3, 40])
@pytest.mark.parametrize("width", [dict(n_head=4), dict(n_embd=32), dict(n_embd=128)],
                         ids=["4_heads", "n_embd_32", "n_embd_128"])
def test_ar_decode_bf16_generic_kernel_on_chip(cuda, width, B):
    # off the recipe's widths: the generic kernel; n_embd 128 fits on chip in
    # bf16 at 2 rows a cluster (its f32 weights do not), and takes device
    # memory at 8
    cfg = dataclasses.replace(BF16, **width)
    on_chip = cfg.n_embd < 128 or B <= 32
    _ar_decode_against_plain(cuda, cfg, B, True, True, seed=B + 111, on_chip=on_chip,
                             recipe=False)


@pytest.mark.parametrize("B", [1, 9, 17])
def test_ar_decode_bf16_weights_in_device_memory(cuda, B):
    cfg = dataclasses.replace(BF16, n_embd=256)
    _ar_decode_against_plain(cuda, cfg, B, True, True, seed=B + 107, on_chip=False)


@pytest.mark.parametrize("B", [3, 9])
@pytest.mark.parametrize("A", [1, 2, 10])
def test_ar_decode_bf16_short_decodes(cuda, A, B):
    cfg = dataclasses.replace(BF16, n_agent=A)
    _ar_decode_against_plain(cuda, cfg, B, True, True, seed=A * 37 + B, on_chip=True)


@pytest.mark.parametrize("i_at", ["first", "last"])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 17, 128])
@pytest.mark.parametrize("family", ["continuous", "available_continuous"])
def test_decode_step_bf16_kernel_matches_plain(cuda, family, B, i_at):
    cfg = dataclasses.replace(_mujoco_cfg(family, 10), dtype="bfloat16")
    i = 0 if i_at == "first" else 9
    _decode_step_against_plain(cuda, cfg, B, i, False, True, seed=B + 200, recipe=True)


@pytest.mark.parametrize("B", [3, 9])
@pytest.mark.parametrize("layout", ["batch_major", "position_major"])
@pytest.mark.parametrize("n_embd", [64, 128, 256], ids=["on_chip", "on_chip_128", "device_memory"])
def test_decode_step_bf16_layouts_and_paths(cuda, n_embd, layout, B):
    cfg = dataclasses.replace(_mujoco_cfg("continuous", 10), n_embd=n_embd, dtype="bfloat16")
    _decode_step_against_plain(cuda, cfg, B, 9, layout == "position_major", n_embd < 256,
                               seed=B + n_embd)


@pytest.mark.parametrize("B", [3, 40])
@pytest.mark.parametrize("width", [dict(n_head=4), dict(n_embd=32)], ids=["4_heads", "n_embd_32"])
def test_decode_step_bf16_generic_kernel_on_chip(cuda, width, B):
    cfg = dataclasses.replace(_mujoco_cfg("continuous", 101), dtype="bfloat16", **width)
    _decode_step_against_plain(cuda, cfg, B, 50, False, True, seed=B + 300, recipe=False)


def test_bf16_calls_never_reach_the_plain_twins(cuda, monkeypatch):
    # a bf16 CUDA call launches the bf16 leg: no cast to f32, no plain twin
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA call reached the plain twin")

    monkeypatch.setattr(ard, "ar_decode_plain", refuse)
    monkeypatch.setattr(dst, "decode_step_plain", refuse)
    for name in ("attention_plain", "attention_bwd_plain", "attention_stats_plain"):
        monkeypatch.setattr(cuda_attention, name, refuse)
    # both attention kernels: the forward (with statistics, then without),
    # the backward fed them, and the cached decode's Lq = 1 forward
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(8, 2, 101, 32, generator=g, device=cuda, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    counts = (cuda_attention.launches, cuda_attention.bwd_launches)
    out = cuda_attention.fused_masked_attention(q, k, v, causal=True)
    out.float().square().sum().backward()
    with torch.no_grad():
        step = cuda_attention.fused_masked_attention(q[:, :, :1], k, v,
                                                     kv_mask=torch.arange(101, device=cuda) < 50)
    torch.cuda.synchronize()
    assert (cuda_attention.launches - counts[0], cuda_attention.bwd_launches - counts[1]) == (2, 1)
    assert out.dtype == step.dtype == q.grad.dtype == torch.bfloat16
    assert all(torch.isfinite(x.grad.float()).all() for x in (q, k, v))
    weights = ard.pack_ar_decode_weights(_dcml_model(cuda, cfg=BF16))
    assert weights.block_qkvp1_w.dtype == torch.bfloat16
    assert weights.head_w1.dtype == torch.float32
    rep, gumbel, normal, avail = _decode_inputs(cuda, 8, True, True, seed=5, cfg=BF16)
    before = ard.launches
    act, logp = ard.fused_ar_decode(weights, rep, gumbel, normal, avail, n_head=2, adim=2,
                                    nd=BF16.n_discrete_agents)
    torch.cuda.synchronize()
    assert ard.launches == before + 1 and act.dtype == logp.dtype == torch.float32
    assert torch.isfinite(logp).all()
    cfg = dataclasses.replace(_mujoco_cfg("continuous", 10), dtype="bfloat16")
    sw = dst.pack_decode_weights(_dcml_model(cuda, cfg=cfg))
    caches = dst.decode_caches(2, 10, 8, 64, cuda, dtype=torch.bfloat16)
    before = dst.launches
    out = dst.fused_decode_step(sw, torch.zeros(8, 8, device=cuda, dtype=torch.bfloat16),
                                torch.ones(8, 64, device=cuda, dtype=torch.bfloat16), caches, 0,
                                n_head=2, adim=8)
    torch.cuda.synchronize()
    assert dst.launches == before + 1 and out.dtype == torch.float32
    assert caches[:, 0].abs().sum() > 0 and (caches[:, 1:] == 0).all()


@pytest.mark.parametrize("mode", ["cached", "scan"])
@pytest.mark.parametrize("family", ["semi_discrete", "continuous"])
def test_bf16_serve_decode_runs_the_bf16_legs(cuda, family, mode):
    # the served decode of a bf16 model: the encoder and the cached decode's
    # attentions in bf16, or the scan decode's kernel, bf16 caches
    cfg = BF16 if family == "semi_discrete" else dataclasses.replace(
        _mujoco_cfg("continuous", 10), dtype="bfloat16")
    model = _dcml_model(cuda, cfg=cfg)
    g = torch.Generator(device=cuda).manual_seed(6)
    state = torch.randn(4, cfg.n_agent, cfg.state_dim, generator=g, device=cuda)
    obs = torch.randn(4, cfg.n_agent, cfg.obs_dim, generator=g, device=cuda)
    counts = (cuda_attention.launches, ard.launches, dst.launches)
    v, res = serve_decode(model, state, obs, None, deterministic=False, mode=mode, device=cuda,
                          generator=g)
    torch.cuda.synchronize()
    got = (cuda_attention.launches - counts[0], ard.launches - counts[1],
           dst.launches - counts[2])
    nb, A = cfg.n_block, cfg.n_agent
    if mode == "cached":
        want = (nb + 2 * nb * A, 0, 0)
    else:
        want = (nb, 1, 0) if family == "semi_discrete" else (nb, 0, A)
    assert got == want
    assert v.dtype == res.log_prob.dtype == torch.float32
    assert torch.isfinite(res.log_prob).all() and torch.isfinite(v).all()
