"""The port's attention against the JAX package's, on the CPU.

The port's plain version (``attention_plain``, which the wrapper takes for
CPU tensors) against ``multi_head_attention`` on the XLA path and against
the Pallas kernel ``fused_masked_attention`` in interpret mode.  f32 holds
to atol 1e-5 (summation order only); bf16 against the XLA path to atol 2e-2
(inputs, probabilities and output rounded to bf16 at the same points on both
sides, the sums in different orders).  Shapes are small: interpret mode is
slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.ops.attention import multi_head_attention as jax_mha
from mat_dcml_tpu.ops.pallas_attention import fused_masked_attention as jax_fused
from mat_dcml_tpu_torch.ops import cuda_attention
from mat_dcml_tpu_torch.ops.attention import merge_heads, multi_head_attention, split_heads

B, H, L, DH = 2, 2, 12, 8


def _qkv(lq, lk, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, n, DH)).astype(dtype) for n in (lq, lk, lk)]


def _mask(kind, lk, seed):
    rng = np.random.default_rng(seed)
    if kind is None:
        return None
    if kind == "shared":
        return np.arange(lk) < 7
    if kind == "per_batch":
        m = rng.uniform(size=(B, lk)) > 0.4
        m[:, 0] = True
        return m
    if kind == "none_valid":   # a fully masked row: uniform weights, as XLA gives
        m = np.ones((B, lk), bool)
        m[1] = False
        return m
    if kind == "first_masked":   # under causal, batch 0's rows 0-2 see no valid key
        m = rng.uniform(size=(B, lk)) > 0.3
        m[0, :3] = False
        m[1, 0] = True
        return m
    raise ValueError(kind)


CASES = [
    # (lq, causal, mask kind)
    (L, False, None),
    (L, True, None),
    (L, False, "shared"),
    (L, False, "per_batch"),
    (L, True, "per_batch"),
    (1, False, "none_valid"),
    (L, True, "first_masked"),   # rows with no visible valid key average V over all keys
]


def _port(q, k, v, causal, mask):
    t = [torch.from_numpy(x) for x in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    return multi_head_attention(*t, causal=causal, kv_mask=m).numpy()


@pytest.mark.parametrize("lq,causal,kind", CASES)
def test_plain_matches_jax_xla_and_pallas(lq, causal, kind):
    q, k, v = _qkv(lq, L, seed=lq + 3 * causal)
    mask = _mask(kind, L, seed=7)
    out = _port(q, k, v, causal, mask)
    jm = None if mask is None else jnp.asarray(mask)
    ref = jax_mha(q, k, v, causal=causal, kv_mask=jm, impl="xla")
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)
    pal = jax_fused(q, k, v, causal=causal, kv_mask=jm, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pal), atol=1e-5)


@pytest.mark.parametrize("i", [0, 5, L - 1])
def test_decode_step_mask_matches_jax(i):
    """The cached decode's call: Lq = 1 against the whole cache, keys
    ``<= i`` valid, one mask row shared by the batch."""
    q, k, v = _qkv(1, L, seed=20 + i)
    mask = np.arange(L) <= i
    out = _port(q, k, v, False, mask)
    ref = jax_mha(q, k, v, kv_mask=jnp.asarray(mask), impl="xla")
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)
    pal = jax_fused(q, k, v, kv_mask=jnp.asarray(mask), interpret=True)
    np.testing.assert_allclose(out, np.asarray(pal), atol=1e-5)


def test_bf16_matches_jax_xla():
    q, k, v = _qkv(L, L, seed=30)
    mask = _mask("per_batch", L, seed=31)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = jax_mha(jq, jk, jv, causal=True, kv_mask=jnp.asarray(mask), impl="xla")
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = multi_head_attention(tq, tk, tv, causal=True, kv_mask=torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=2e-2)


def test_cpu_dispatch_takes_plain_version():
    before = cuda_attention.launches
    q, k, v = (torch.from_numpy(x) for x in _qkv(L, L, seed=40))
    out = cuda_attention.fused_masked_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, cuda_attention.attention_plain(q, k, v, causal=True),
                               rtol=0, atol=0)
    assert cuda_attention.launches == before == 0


def test_split_merge_heads_match_jax():
    from mat_dcml_tpu.ops.attention import merge_heads as jmerge, split_heads as jsplit

    x = np.random.default_rng(50).normal(size=(B, L, H * DH)).astype(np.float32)
    s = split_heads(torch.from_numpy(x), H)
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsplit(jnp.asarray(x), H)))
    np.testing.assert_array_equal(merge_heads(s).numpy(), x)
    np.testing.assert_array_equal(np.asarray(jmerge(jsplit(jnp.asarray(x), H))), x)


def test_qk_mask_not_ported():
    q, k, v = (torch.from_numpy(x) for x in _qkv(L, L, seed=60))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        multi_head_attention(q, k, v, qk_mask=torch.ones(L, L, dtype=torch.bool))
