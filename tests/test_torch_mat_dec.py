"""MAT-Dec (``MATConfig(dec_actor=True)``) in the PyTorch port against the
JAX package, on the CPU: the MLP actor shared by all agents
(``share_actor``, the ``mat_dec`` algorithm) and one MLP an agent (JAX
``nn.vmap`` over stacked weights, a batched product in the port).

- the bridge carries the stacked per-agent weights across bit for bit;
- the forward pass, the decodes (``cached`` and ``scan``, deterministic and
  on the noise replayed from JAX's key chain) and ``evaluate_actions``
  against JAX at atol 1e-5 (log-probs also rtol 1e-6: the Gaussian tail's
  reaches ~30 under the O(1) test weights);
- the decode launches no decode kernel: JAX routes MAT-Dec away from the
  fused decode (``mat_dcml_tpu/models/decode.py:77``), and so does the port;
- one PPO update against JAX (weights 0.01 lr x steps, metrics rtol 1e-5),
  on a chunk the port collects from the bridged weights;
- the ``mat_dec`` runner trains and evaluates.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.models.mat import MATConfig as JaxMATConfig
from mat_dcml_tpu.models.mat import MultiAgentTransformer as JaxMAT
from mat_dcml_tpu.models.policy import TransformerPolicy as JaxPolicy
from mat_dcml_tpu_torch.bridge import params_from_jax, params_to_jax
from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.envs.dcml import env as tenv
from mat_dcml_tpu_torch.models import decode as tdecode
from mat_dcml_tpu_torch.models.mat import MATConfig, MultiAgentTransformer
from mat_dcml_tpu_torch.models.policy import TransformerPolicy
from mat_dcml_tpu_torch.training import rollout as trollout
from mat_dcml_tpu_torch.training.ppo import PPOConfig
from mat_dcml_tpu_torch.training.runner import DCMLRunner
from tests.torch_port_helpers import (
    SMALL,
    compare_update_metrics,
    configs,
    inputs,
    jax_params,
    one_torch_thread,  # noqa: F401
    param_diff,
    serve_decode_vs_jax,
    torch_in,
    torch_model,
    updates_vs_jax,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-5
LR = 1e-3
SHARED = dict(SMALL, dec_actor=True, share_actor=True)
PER_AGENT = dict(SMALL, dec_actor=True)
VARIANTS = {"shared": SHARED, "per_agent": PER_AGENT}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bridge_round_trip_is_bit_exact(variant):
    """Every JAX leaf lands on a parameter of the port's model (the stacked
    ones keep their leading agent axis), and back, bit for bit."""
    shape = VARIANTS[variant]
    jcfg = JaxMATConfig(**shape)
    A = jcfg.n_agent
    tree = jax.tree.map(np.asarray, jax.device_get(JaxMAT(jcfg).init(
        jax.random.key(1), jnp.zeros((1, A, jcfg.state_dim)), jnp.zeros((1, A, jcfg.obs_dim)),
        jnp.zeros((1, A, jcfg.action_input_dim)))))
    sd = params_from_jax(tree)
    model = MultiAgentTransformer(MATConfig(**shape), device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    mlp = tree["params"]["decoder"]["mlp"]
    if variant == "per_agent":
        assert mlp["Dense_0"]["kernel"].shape == (A, jcfg.obs_dim, jcfg.n_embd)
        np.testing.assert_array_equal(model.decoder.mlp.Dense_0.kernel.detach().numpy(),
                                      mlp["Dense_0"]["kernel"])
        np.testing.assert_array_equal(model.decoder.mlp.LayerNorm_1.scale.detach().numpy(),
                                      mlp["LayerNorm_1"]["scale"])
    back = params_to_jax(model.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        assert flat[path].dtype == leaf.dtype and flat[path].shape == leaf.shape, path
        np.testing.assert_array_equal(flat[path], leaf)
    # the port's own init round-trips too
    own = MultiAgentTransformer(MATConfig(**shape), device="cpu",
                                generator=torch.Generator().manual_seed(0)).state_dict()
    again = params_from_jax(params_to_jax(own))
    assert all(torch.equal(again[k], v) for k, v in own.items())


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_and_evaluate_match_jax(variant):
    shape = VARIANTS[variant]
    jcfg, tcfg = configs(shape)
    params = jax_params(jcfg, seed=2)
    state, obs, avail = inputs(jcfg, 3)
    sh = np.zeros((3, jcfg.n_agent, jcfg.action_input_dim), np.float32)
    jv, jrep, jlogits = JaxMAT(jcfg).apply(params, state, obs, sh)
    model = torch_model(tcfg, params)
    with torch.no_grad():
        v, rep, logits = model(*torch_in(state, obs, sh))
    for a, b in ((v, jv), (rep, jrep), (logits, jlogits)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    assert float(np.abs(np.asarray(jlogits)).max()) > 0.1      # not near 0
    act = np.zeros((3, jcfg.n_agent, 1), np.float32)
    idx = np.random.default_rng(3).integers(0, 2, size=(3, jcfg.n_agent - 1))
    act[:, :-1, 0] = np.where(avail[:, :-1, 1] > 0, idx, 0)     # available actions only
    act[:, -1, 0] = 0.3
    policy = TransformerPolicy(tcfg, device="cpu")
    policy.model.load_state_dict(params_from_jax(params))
    jres = JaxPolicy(jcfg).evaluate_actions(params, state, obs, act, avail)
    with torch.no_grad():
        res = policy.evaluate_actions(*torch_in(state, obs, act, avail))
    for a, b in zip(res, jres):     # the tail's log-prob reaches ~30: 1e-6 relative
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("mode", ["cached", "scan"])
@pytest.mark.parametrize("deterministic", [True, False], ids=["mode", "sampled"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_matches_jax(variant, deterministic, mode, monkeypatch):
    """The decode against JAX's ``serve_decode`` (values, actions,
    log-probs), with no decode kernel reached: the fused decode's entries
    raise here."""
    def no_kernel(*_a, **_k):
        raise AssertionError("MAT-Dec reached a decode kernel")

    monkeypatch.setattr(tdecode, "fused_ar_decode", no_kernel)
    monkeypatch.setattr(tdecode, "fused_decode_step", no_kernel)
    serve_decode_vs_jax(VARIANTS[variant], deterministic, 4, mode, ATOL)


def test_stride_decode_matches_jax():
    """``act_stride`` of a MAT-Dec policy (the sweep's decode) reads the MLP
    actor on obs, as JAX's ``stride_decode`` does."""
    serve_decode_vs_jax(SHARED, True, 3, "stride", ATOL, stride=2)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_update_matches_jax(variant):
    """One PPO update (2 epochs x 2 minibatches) of one chunk, at DCML's
    101 agents, on both sides."""
    shape = dict(VARIANTS[variant], n_agent=101)
    jcfg, tcfg = configs(shape)
    params = jax_params(jcfg, seed=4)
    policy = TransformerPolicy(tcfg, device="cpu")
    policy.model.load_state_dict(params_from_jax(params))
    gen = torch.Generator().manual_seed(4)
    col = trollout.RolloutCollector(tenv.DCMLEnv(device="cpu"), policy, 4)
    st1, traj = col.collect(col.init_state(4, generator=gen), generator=gen)
    ppo_kw = dict(lr=LR, ppo_epoch=2, num_mini_batch=2)
    jstate, jmet, state, met = updates_vs_jax(jcfg, params, policy, traj, st1, ppo_kw)
    assert param_diff(jstate, policy, LR, 4) <= 0.01 * LR * 4
    compare_update_metrics(jmet, met)


def test_mat_dec_runner_trains_and_evaluates(tmp_path):
    """``algorithm_name="mat_dec"``: one MLP actor for all agents, as the
    JAX runner builds it; scan collect, finite records and evaluation."""
    run = RunConfig(device="cpu", algorithm_name="mat_dec", n_rollout_threads=2,
                    episode_length=3, n_embd=16, n_block=1, num_env_steps=12, log_interval=1,
                    decode_mode="scan", run_dir=str(tmp_path))
    runner = DCMLRunner(run, PPOConfig(ppo_epoch=1, num_mini_batch=2, lr=1e-3),
                        log_fn=lambda *_: None)
    cfg = runner.policy.cfg
    assert cfg.dec_actor and cfg.share_actor and cfg.n_objective == 1
    assert not hasattr(runner.policy.model.decoder, "blocks")
    runner.train_loop()
    assert len(runner.records) == 2
    assert all(math.isfinite(v) for r in runner.records for v in r.values())
    info = runner.evaluate(n_steps=3)
    assert all(math.isfinite(v) for v in info.values())
    assert runner.run_dir.parts[-2:] == ("mat_dec", "check")
