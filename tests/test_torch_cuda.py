"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device (decided inside the
fixture, never at import).  This file imports no JAX, so on the card it runs
without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Forward tolerance: f32 atol 1e-5 (summation order only), bf16 atol 8e-3 (both
sides round the probabilities and the output to bf16: about an ulp of the
output).  Backward (against autograd through the plain version): f32 atol
1e-5 relative to the largest reference gradient (summation order only); bf16
2**-7 relative (dq, dk, dv are rounded to bf16 on both sides, dP and P where
plain rounds them, and a sum of 101 terms in a different order can move a
bf16 result by an ulp, at most 2**-7 of its size).

Whole decode (``ar_decode``) against its plain twin at the DCML width, f32:
log-probs and the tail's actions atol 1e-4, worker actions equal except past
a position whose top-2 plain score margin is below 1e-5 (a near-tie that
summation order may break).
"""

import pytest
import torch

from mat_dcml_tpu_torch.models.decode import serve_decode
from mat_dcml_tpu_torch.models.mat import SEMI_DISCRETE, MATConfig, MultiAgentTransformer
from mat_dcml_tpu_torch.ops import ar_decode as ard
from mat_dcml_tpu_torch.ops import cuda_attention
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
    q = torch.zeros(1, 1, 128, 128, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_attention.attention_bwd(q, q, q, q)
    with pytest.raises(ValueError, match="dout"):
        cuda_attention.attention_bwd(q, q, q, q[..., :64].contiguous())


# ------------------------------------------------------------- whole decode

DCML = MATConfig(n_agent=101, obs_dim=7, state_dim=102, action_dim=2, n_block=2, n_embd=64,
                 n_head=2, action_type=SEMI_DISCRETE, semi_index=-1)
DECODE_TOL = 1e-4
NEAR_TIE = 1e-5


def _dcml_model(device, seed=0):
    """The DCML-width MAT with every weight redrawn at O(1) scale: the
    reference init's 0.01-gain heads give logits near 0 and near-ties
    everywhere."""
    model = MultiAgentTransformer(DCML, device="cpu")
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


def _decode_inputs(device, B, noise, masked, seed):
    A, adim = DCML.n_agent, DCML.action_dim
    g = torch.Generator(device=device).manual_seed(seed)
    rep = torch.randn(B, A, DCML.n_embd, generator=g, device=device)
    gumbel = gumbel_noise((B, A, adim), g, device) if noise else torch.zeros(B, A, adim,
                                                                            device=device)
    normal = torch.randn(B, 1, adim, generator=g, device=device) * float(noise)
    avail = None
    if masked:
        avail = (torch.rand(B, A, adim, generator=g, device=device) > 0.2).float()
        avail[..., 0] = 1.0
    return rep, gumbel, normal, avail


def _check_decodes_agree(act, logp, ref_act, ref_logp, scores, nd):
    """Row by row: worker actions equal up to the first difference, which is
    allowed only at a near-tie of the reference's scores; log-probs (and the
    tail's action where the row never diverged) within DECODE_TOL before it."""
    act, logp, ref_act, ref_logp, scores = (x.cpu() for x in (act, logp, ref_act, ref_logp,
                                                               scores))
    for b in range(act.shape[0]):
        diff = (act[b, :nd] != ref_act[b, :nd]).nonzero()
        end = act.shape[1] if diff.numel() == 0 else int(diff[0])
        if diff.numel():
            top2 = scores[b, end].sort().values[-2:]
            assert top2[1] - top2[0] < NEAR_TIE, f"row {b}: action differs at agent {end}"
        else:
            assert (act[b, nd:] - ref_act[b, nd:]).abs().max() <= DECODE_TOL, f"row {b}: tail"
        if end:
            assert (logp[b, :end] - ref_logp[b, :end]).abs().max() <= DECODE_TOL, f"row {b}"


@pytest.mark.parametrize("masked", [True, False], ids=["avail", "avail_none"])
@pytest.mark.parametrize("noise", [False, True], ids=["deterministic", "noise"])
@pytest.mark.parametrize("B", [1, 3, 8, 128])
def test_ar_decode_kernel_matches_plain(cuda, B, noise, masked):
    weights = ard.pack_ar_decode_weights(_dcml_model(cuda))
    rep, gumbel, normal, avail = _decode_inputs(cuda, B, noise, masked, seed=B)
    kw = dict(n_head=DCML.n_head, adim=DCML.action_dim, nd=DCML.n_discrete_agents)
    before = ard.launches
    act, logp = ard.fused_ar_decode(weights, rep, gumbel, normal, avail, **kw)
    torch.cuda.synchronize()
    assert ard.launches == before + 1
    assert act.shape == logp.shape == (B, DCML.n_agent)
    assert torch.isfinite(act).all() and torch.isfinite(logp).all()
    ref = ard.ar_decode_plain(weights, rep, gumbel, normal, avail, return_scores=True, **kw)
    assert ard.launches == before + 1
    _check_decodes_agree(act, logp, *ref, DCML.n_discrete_agents)


def test_ar_decode_rejects_what_it_cannot_run(cuda):
    weights = ard.pack_ar_decode_weights(_dcml_model(cuda))
    rep, gumbel, normal, avail = _decode_inputs(cuda, 2, True, True, seed=0)
    kw = dict(n_head=DCML.n_head, adim=DCML.action_dim, nd=DCML.n_discrete_agents)
    with pytest.raises(ValueError, match="f32 only"):
        ard.fused_ar_decode(weights, rep.bfloat16(), gumbel, normal, avail, **kw)
    with pytest.raises(ValueError, match="f32 only"):
        bf16 = ard.ARDecodeWeights(*(t.bfloat16() for t in weights))
        ard.fused_ar_decode(bf16, rep, gumbel, normal, avail, **kw)
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
