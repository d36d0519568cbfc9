"""The port's attention gradients against the JAX package's, on the CPU.

The port's dq, dk, dv (autograd through the plain version, which the wrapper
takes for CPU tensors) against ``jax.grad`` through the Pallas kernel's
custom VJP in interpret mode and through the XLA ``multi_head_attention``,
as ``tests/test_pallas_attention.py::test_fused_gradients_match_*`` holds
the two JAX paths together.  Loss ``sum(out ** 2)`` in f32.

Tolerances, times the largest reference gradient (up to ~10 here): f32
1e-6 (summation order only; measured <= 2e-7 relative).  bf16 against XLA:
2**-8, one bf16 ulp (P, dP and the gradients are rounded to bf16 at the same
points on both sides; measured 0); against the Pallas kernel, whose backward
keeps P and dP in f32: 2**-6, four ulps (measured two).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.ops.attention import multi_head_attention as jax_mha
from mat_dcml_tpu.ops.pallas_attention import fused_masked_attention as jax_fused
from mat_dcml_tpu_torch.ops.attention import multi_head_attention

B, H, L, DH = 2, 2, 12, 8
TOL = {"f32": (1e-6, 1e-6), "bf16": (2.0**-8, 2.0**-6)}   # (vs XLA, vs Pallas), relative


def _inputs(seed, kind):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, L, DH)).astype(np.float32) for _ in range(3))
    if kind == "shared":
        mask = np.arange(L) < 7
    elif kind == "per_batch":
        mask = rng.uniform(size=(B, L)) > 0.4
        mask[:, 0] = True
    else:
        mask = None
    return q, k, v, mask


def _port_grads(q, k, v, causal, mask, dtype):
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    out = multi_head_attention(*leaves, causal=causal, kv_mask=m)
    (out.float() ** 2).sum().backward()
    return [x.grad.float().numpy() for x in leaves]


def _jax_grads(fn, q, k, v, dtype):
    def loss(q, k, v):
        return (fn(q, k, v).astype(jnp.float32) ** 2).sum()

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    return [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal,kind", [(True, None), (False, "shared"), (False, "per_batch"),
                                         (True, "per_batch"), (False, None)])
def test_gradients_match_jax_xla_and_pallas(causal, kind, dtype):
    q, k, v, mask = _inputs(seed=3 + causal, kind=kind)
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    mine = _port_grads(q, k, v, causal, mask, tdt)
    jm = None if mask is None else jnp.asarray(mask)
    xla = _jax_grads(lambda q, k, v: jax_mha(q, k, v, causal=causal, kv_mask=jm, impl="xla"),
                     q, k, v, jdt)
    pallas = _jax_grads(lambda q, k, v: jax_fused(q, k, v, causal=causal, kv_mask=jm,
                                                  interpret=True), q, k, v, jdt)
    tol_xla, tol_pallas = TOL[dtype]
    for name, a, b, c in zip("qkv", mine, xla, pallas):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, atol=tol_xla * scale, err_msg=f"d{name} vs XLA")
        np.testing.assert_allclose(a, c, atol=tol_pallas * scale, err_msg=f"d{name} vs Pallas")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gradients_with_no_visible_valid_key_match_jax_xla(dtype):
    """Causal with a per-batch mask whose first keys are masked: batch 0's
    rows 0-2 see no valid key, so their P is uniform over all L keys (keys
    after the row included) and their dS is 0, as autograd through the XLA
    path gives.  Against XLA only: the Pallas backward gives those rows a
    nonzero dS by design (ROADMAP queue 3)."""
    q, k, v, _ = _inputs(seed=11, kind=None)
    mask = np.random.default_rng(12).uniform(size=(B, L)) > 0.3
    mask[0, :3] = False
    mask[1, 0] = True
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    mine = _port_grads(q, k, v, True, mask, tdt)
    jm = jnp.asarray(mask)
    xla = _jax_grads(lambda q, k, v: jax_mha(q, k, v, causal=True, kv_mask=jm, impl="xla"),
                     q, k, v, jdt)
    for name, a, b in zip("qkv", mine, xla):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, atol=TOL[dtype][0] * scale, err_msg=f"d{name} vs XLA")
    assert np.abs(mine[2][0]).max() > 0   # the rows with no valid key still reach dv
