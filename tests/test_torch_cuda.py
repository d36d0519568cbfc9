"""The port's CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``; each test skips without a CUDA device (decided inside the
fixture, never at import).  This file imports no JAX, so on the card it runs
without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: f32 atol 1e-5 (summation order only), bf16 atol 8e-3 (both sides
round the probabilities and the output to bf16: about an ulp of the output).
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
