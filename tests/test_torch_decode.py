"""The port's cached ``serve_decode`` against JAX ``serve_decode(mode="cached")``.

Small semi-discrete DCML shape with bridged weights and numpy inputs.  Both
sides compute in f32; log-probs hold to atol 1e-5 (summation order only).
Actions must be equal, except past a position where the JAX top-2 logit
margin is below 1e-5 (``assert_decodes_agree``).  The stochastic case feeds
the port the Gumbel and tail noise replayed from JAX's key chain.  The
kernel configuration runs the JAX side through its Pallas attention kernel
in interpret mode (``MAT_DCML_TPU_ATTN_IMPL=pallas_interpret``).
"""

import numpy as np
import pytest
import torch

from mat_dcml_tpu_torch.models.decode import ar_decode, serve_decode
from mat_dcml_tpu_torch.models.mat import MATConfig, MultiAgentTransformer
from tests.torch_port_helpers import (
    SMALL,
    TINY,
    configs,
    inputs,
    jax_params,
    serve_decode_vs_jax,
    torch_model,
)

ATOL = 1e-5


def _run(shape, deterministic, batch):
    return serve_decode_vs_jax(shape, deterministic, batch, "cached", atol=ATOL)


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


@pytest.mark.parametrize("mode", ["spec"])
def test_unported_modes_raise(mode):
    jcfg, tcfg = configs(TINY)
    model = torch_model(tcfg, jax_params(jcfg))
    state, obs, avail = inputs(jcfg, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve_decode(model, state, obs, avail, mode=mode, device="cpu")


@pytest.mark.parametrize("action_type", ["continuous", "available_continuous"])
def test_ar_decode_raises_for_continuous_families(action_type):
    cfg = MATConfig(n_agent=3, obs_dim=4, state_dim=4, action_dim=2, n_block=1, n_embd=8,
                    action_type=action_type)
    model = MultiAgentTransformer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 2, item 2"):
        ar_decode(model, torch.zeros(1, 3, 8), None, deterministic=True)


def test_stochastic_stride_raises():
    """The stride decode has no sampling path, as in JAX."""
    jcfg, tcfg = configs(TINY)
    model = torch_model(tcfg, jax_params(jcfg))
    state, obs, avail = inputs(jcfg, 1)
    with pytest.raises(ValueError, match="deterministic-only"):
        serve_decode(model, state, obs, avail, deterministic=False, mode="stride", device="cpu")
