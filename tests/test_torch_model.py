"""The port's MAT modules against the JAX package's, on bridged weights.

Small semi-discrete DCML shape (11 agents, n_embd 16, 2 blocks, 2 heads, obs
7, state 102).  Tolerance: f32 atol 1e-5 — both sides compute in f32 and
differ only in summation order (matmul, LayerNorm variance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.models.mat import MultiAgentTransformer as JaxMAT
from tests.torch_port_helpers import configs, inputs, jax_params, torch_in, torch_model

ATOL = 1e-5
B = 3


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs()
    params = jax_params(jcfg)
    return jcfg, JaxMAT(jcfg), params, torch_model(tcfg, params)


def _shifted(cfg, rng):
    idx = rng.integers(0, cfg.action_dim, size=(B, cfg.n_agent))
    sh = np.zeros((B, cfg.n_agent, cfg.action_input_dim), np.float32)
    sh[:, 0, 0] = 1.0
    for i in range(1, cfg.n_agent):
        sh[np.arange(B), i, 1 + idx[:, i - 1]] = 1.0
    return sh


def test_encode_matches_jax(pair):
    jcfg, jm, params, tm = pair
    state, obs, _ = inputs(jcfg, B)
    v_ref, rep_ref = jm.apply(params, state, obs, method="encode")
    with torch.no_grad():
        v, rep = tm.encode(*torch_in(state, obs))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=ATOL)
    np.testing.assert_allclose(rep.numpy(), np.asarray(rep_ref), atol=ATOL)


def test_teacher_forced_decoder_matches_jax(pair):
    # the causal path of the attention (decoder self- and cross-attention)
    jcfg, jm, params, tm = pair
    state, obs, _ = inputs(jcfg, B)
    sh = _shifted(jcfg, np.random.default_rng(2))
    v_ref, rep_ref, logits_ref = jm.apply(params, state, obs, sh)
    with torch.no_grad():
        v, rep, logits = tm(*torch_in(state, obs, sh))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref), atol=ATOL)


def test_decode_queries_match_jax(pair):
    jcfg, jm, params, tm = pair
    rep = np.random.default_rng(3).normal(size=(B, jcfg.n_agent, jcfg.n_embd)).astype(np.float32)
    ref = jm.apply(params, rep, method="decode_queries")
    with torch.no_grad():
        q2 = tm.decode_queries(*torch_in(rep))
    assert q2.shape == ref.shape
    np.testing.assert_allclose(q2.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("i", [0, 4, 10])
def test_decode_step_cached_matches_jax(pair, i):
    """One step against a cache whose first i columns are filled: logits and
    the packed K/V buffers after the in-place write."""
    jcfg, jm, params, tm = pair
    rng = np.random.default_rng(10 + i)
    A, D = jcfg.n_agent, jcfg.n_embd
    rep = rng.normal(size=(B, A, D)).astype(np.float32)
    shape = (2 * jcfg.n_block, B, jcfg.n_head, A, D // jcfg.n_head)
    k_buf = np.zeros(shape, np.float32)
    v_buf = np.zeros(shape, np.float32)
    k_buf[..., :i, :] = rng.normal(size=shape[:3] + (i, shape[4]))
    v_buf[..., :i, :] = rng.normal(size=shape[:3] + (i, shape[4]))
    sh = np.zeros((B, 1, jcfg.action_input_dim), np.float32)
    sh[:, 0, 1 + (i % 2)] = 1.0
    q2 = np.array(jm.apply(params, rep, method="decode_queries"))[:, :, :, i:i + 1]
    logits_ref, (k_ref, v_ref) = jm.apply(
        params, sh, rep[:, i:i + 1], q2, (jnp.asarray(k_buf), jnp.asarray(v_buf)), i,
        method="decode_step_cached",
    )
    kt, vt = torch_in(k_buf, v_buf)
    valid = torch.arange(A) <= i
    with torch.no_grad():
        logits = tm.decode_step_cached(
            *torch_in(sh), torch.from_numpy(rep[:, i:i + 1]), torch.from_numpy(q2),
            (kt, vt), i, valid,
        )
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref), atol=ATOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(k_ref), atol=ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(v_ref), atol=ATOL)


def test_action_std_matches_jax(pair):
    jcfg, jm, params, tm = pair
    ref = jm.apply(params, method="action_std")
    np.testing.assert_allclose(tm.action_std().detach().numpy(), np.asarray(ref), atol=1e-7)
