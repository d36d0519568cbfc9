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
"""

import pytest
import torch

from mat_dcml_tpu_torch.ops import cuda_attention

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
