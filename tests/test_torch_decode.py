"""The port's cached ``serve_decode`` against JAX ``serve_decode(mode="cached")``.

Small semi-discrete DCML shape with bridged weights and numpy inputs.  Both
sides compute in f32; log-probs hold to atol 1e-5 (summation order only).
Actions must be equal, except past a position where the JAX top-2 logit
margin is below 1e-5 (``assert_decodes_agree``).  The stochastic case feeds
the port the Gumbel and tail noise replayed from JAX's key chain.  The
kernel configuration runs the JAX side through its Pallas attention kernel
in interpret mode (``MAT_DCML_TPU_ATTN_IMPL=pallas_interpret``).
"""

import jax
import numpy as np
import pytest
import torch

from mat_dcml_tpu.models.decode import serve_decode as jax_serve_decode
from mat_dcml_tpu.models.mat import MultiAgentTransformer as JaxMAT
from mat_dcml_tpu_torch.models.decode import serve_decode
from tests.torch_port_helpers import (
    SMALL,
    TINY,
    assert_decodes_agree,
    configs,
    inputs,
    jax_params,
    replay_noise,
    torch_model,
)

ATOL = 1e-5
KEY = 42


def _reference_logits(jcfg, params, state, obs, avail, act, gumbel):
    """JAX teacher-forced logits under JAX's own actions: the logits each
    decode position saw, for the near-tie check."""
    B, A = act.shape[:2]
    jm = JaxMAT(jcfg)
    _, rep = jm.apply(params, state, obs, method="encode")
    sh = np.zeros((B, A, jcfg.action_input_dim), np.float32)
    sh[:, 0, 0] = 1.0
    idx = np.asarray(act)[:, :-1, 0].astype(int).clip(0, jcfg.action_dim - 1)
    for i in range(1, A):
        sh[np.arange(B), i, 1 + idx[:, i - 1]] = 1.0
    logits = np.asarray(jm.apply(params, sh, rep, obs, method="decode_full"))
    logits = np.where(avail == 0, -1e10, logits)
    return logits if gumbel is None else logits + gumbel


def _run(shape, deterministic, batch):
    jcfg, tcfg = configs(shape)
    params = jax_params(jcfg)
    state, obs, avail = inputs(jcfg, batch)
    v_ref, ref = jax_serve_decode(
        jcfg, params, jax.random.key(KEY), state, obs, avail,
        deterministic=deterministic, mode="cached",
    )
    gumbel = tail = None
    if not deterministic:
        gumbel, tail = replay_noise(jax.random.key(KEY), batch, jcfg)
    model = torch_model(tcfg, params)
    v, res = serve_decode(
        model, state, obs, avail, deterministic=deterministic, device="cpu",
        gumbel=None if gumbel is None else torch.from_numpy(gumbel),
        tail_noise=None if tail is None else torch.from_numpy(tail),
    )
    assert res.action.shape == ref.action.shape and res.log_prob.shape == ref.log_prob.shape
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=ATOL)
    logits = _reference_logits(jcfg, params, state, obs, avail, ref.action, gumbel)
    assert_decodes_agree(res.action.numpy(), res.log_prob.numpy(), ref.action,
                         ref.log_prob, logits, jcfg.n_discrete_agents, ATOL)
    return res


@pytest.mark.parametrize("deterministic", [True, False], ids=["deterministic", "replayed_noise"])
def test_cached_serve_decode_matches_jax(deterministic):
    res = _run(SMALL, deterministic, batch=4)
    act = res.action.numpy()[..., 0]
    assert set(np.unique(act[:, :-1])) <= {0.0, 1.0}
    assert np.isfinite(res.log_prob.numpy()).all()


@pytest.mark.parametrize("deterministic", [True, False], ids=["deterministic", "replayed_noise"])
def test_cached_serve_decode_matches_jax_pallas_kernel(monkeypatch, deterministic):
    """JAX's own kernel configuration of this slice: every attention through
    ``fused_masked_attention`` (Pallas, interpret mode on the CPU)."""
    monkeypatch.setenv("MAT_DCML_TPU_ATTN_IMPL", "pallas_interpret")
    _run(TINY, deterministic, batch=2)


def test_stochastic_decode_draws_from_generator():
    """Without explicit noise a stochastic decode reads the caller's
    generator: the same seed gives the same draw."""
    jcfg, tcfg = configs(TINY)
    model = torch_model(tcfg, jax_params(jcfg))
    state, obs, avail = inputs(jcfg, 3)
    runs = [
        serve_decode(model, state, obs, avail, deterministic=False, device="cpu",
                     generator=torch.Generator().manual_seed(7))[1]
        for _ in range(2)
    ]
    assert torch.equal(runs[0].action, runs[1].action)
    assert torch.equal(runs[0].log_prob, runs[1].log_prob)


@pytest.mark.parametrize("mode", ["scan", "stride", "spec"])
def test_unported_modes_raise(mode):
    jcfg, tcfg = configs(TINY)
    model = torch_model(tcfg, jax_params(jcfg))
    state, obs, avail = inputs(jcfg, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve_decode(model, state, obs, avail, mode=mode, device="cpu")
