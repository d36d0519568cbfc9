"""The port's collector and PPO update against the JAX package's, on the CPU.

A small MAT at DCML's real shape (101 agents, obs 7, state 102, action 2,
semi-discrete) but narrow (n_embd 16, 2 blocks), E = 4 envs, T = 4 steps,
2 PPO epochs x 2 minibatches, the JAX weights bridged into the port.

- ``collect``: the JAX collector's policy noise and env draws are replayed
  from its key chains into the port.  Actions must be equal (a flipped
  selection bit would change every later step; none occurs at these
  inputs), log-probs to atol 1e-5 (f32, summation order only), env outputs
  as in ``test_torch_env.py`` (rtol 1e-6).  Values to atol 1e-4: a disabled
  worker's obs row is nearly constant (six of seven features within 0.1 of
  1), so the encoder's first LayerNorm divides by a standard deviation near
  0.03 and magnifies summation-order differences about 30 times.
- ``train``: both sides update from the SAME trajectory (the JAX one,
  converted), the same weights and the same per-epoch permutations (JAX's
  ``permutation`` replayed).  Adam divides each gradient by its own running
  size, so a parameter whose gradient is near 0 can move by up to ``lr`` per
  step on one side and less on the other, so the bound scales with
  ``lr * steps``: the weights after one Adam step are held to ``0.005 *
  lr``, after the whole update (4 steps) to ``0.01 * lr * steps`` (measured:
  1.6e-6 and 1.9e-6 at lr 1e-3).  A wrong gradient sign or a skipped
  minibatch moves an entry by ``~2 lr`` per step and fails either bound.
  The key projections' biases, whose exact gradient is 0, are the exception
  (``tests/torch_port_helpers.py::param_diff``).
  Metrics to rtol 1e-5 with atol 1e-6: the policy loss is a mean of
  normalised (unit-scale) advantages that cancels to near 0 on the first
  step, so only an absolute bound means anything there.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mat_dcml_tpu.envs.dcml.env import DCMLEnv as JaxEnv
from mat_dcml_tpu.envs.dcml.env import DCMLEnvConfig as JaxEnvConfig
from mat_dcml_tpu.models.policy import TransformerPolicy as JaxPolicy
from mat_dcml_tpu.training.ppo import MATTrainer as JaxTrainer
from mat_dcml_tpu.training.ppo import PPOConfig as JaxPPOConfig
from mat_dcml_tpu.training.rollout import RolloutCollector as JaxCollector
from mat_dcml_tpu_torch.bridge import params_from_jax
from mat_dcml_tpu_torch.config import parse_cli
from mat_dcml_tpu_torch.envs.dcml import env as tenv
from mat_dcml_tpu_torch.envs.dcml.constants import DCMLConsts
from mat_dcml_tpu_torch.models.policy import TransformerPolicy
from mat_dcml_tpu_torch.training import rollout as trollout
from mat_dcml_tpu_torch.training.ppo import RECIPE_SWITCHES, MATTrainer, PPOConfig
from tests.torch_port_helpers import (
    compare_update_metrics,
    configs,
    jax_params,
    jax_reset_draws,
    jax_step_draws,
    param_diff,
    replay_noise,
)

ROOT = Path(__file__).resolve().parent.parent
DCML = dict(n_agent=101, obs_dim=7, state_dim=102, action_dim=2, n_block=2, n_embd=16,
            n_head=2, action_type="semi_discrete", semi_index=-1)
E, T = 4, 4
ATOL = 1e-5
VALUE_ATOL = 1e-4
LR = 1e-3
ONE_STEP_ATOL = 0.005 * LR


def _policy(tcfg, params):
    policy = TransformerPolicy(tcfg, device="cpu")
    policy.model.load_state_dict(params_from_jax(params))
    return policy


@pytest.fixture(scope="module")
def collected():
    """One JAX collect and the port's replay of it."""
    jcfg, tcfg = configs(DCML)
    params = jax_params(jcfg, seed=3)
    consts = DCMLConsts()
    jenv = JaxEnv(JaxEnvConfig(), data_dir=ROOT / "data")
    jcol = JaxCollector(jenv, JaxPolicy(jcfg, decode_mode="cached"), T)
    key = jax.random.key(11)
    rs0 = jcol.init_state(key, E)
    rs1, traj = jax.jit(jcol.collect)(params, rs0)

    # the replayed draws: init (env.reset keys), then per step the action
    # key split off the collector's key and each env state's key chain
    _, k_reset, _ = jax.random.split(key, 3)
    reset_draws = jax_reset_draws(jax.random.split(k_reset, E), consts)
    gumbel, tail, steps = [], [], []
    rng, env_rng = rs0.rng, rs0.env_states.rng
    for _ in range(T):
        rng, k_act = jax.random.split(rng)
        g, tl = replay_noise(k_act, E, jcfg)
        gumbel.append(torch.from_numpy(g))
        tail.append(torch.from_numpy(tl))
        env_rng, d = jax_step_draws(env_rng, consts)
        steps.append(d)
    env_draws = tenv.StepDraws(
        *(torch.stack(xs) for xs in zip(*(s[:4] for s in steps))),
        reset=tenv.ResetDraws(*(torch.stack(xs) for xs in zip(*(s.reset for s in steps)))),
    )
    draws = trollout.CollectDraws(torch.stack(gumbel), torch.stack(tail), env_draws)

    policy = _policy(tcfg, params)
    col = trollout.RolloutCollector(tenv.DCMLEnv(device="cpu"), policy, T)
    st0 = col.init_state(E, draws=reset_draws)
    st1, ttraj = col.collect(st0, draws=draws)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, jcol=jcol, rs1=rs1, traj=traj,
                st0=st0, rs0=rs0, st1=st1, ttraj=ttraj)


def test_init_state_matches_jax(collected):
    st0, rs0 = collected["st0"], collected["rs0"]
    np.testing.assert_allclose(st0.obs.numpy(), np.asarray(rs0.obs), atol=1e-6)
    np.testing.assert_array_equal(st0.available_actions.numpy(), np.asarray(rs0.available_actions))
    np.testing.assert_array_equal(st0.mask.numpy(), np.asarray(rs0.mask))


def test_collect_matches_jax(collected):
    traj, ttraj = collected["traj"], collected["ttraj"]
    np.testing.assert_array_equal(ttraj.actions[..., :-1, :].numpy(),
                                  np.asarray(traj.actions)[..., :-1, :])
    np.testing.assert_allclose(ttraj.actions.numpy(), np.asarray(traj.actions), atol=ATOL)
    for name in ("log_probs", "obs", "share_obs"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(), np.asarray(getattr(traj, name)),
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(ttraj.values.numpy(), np.asarray(traj.values), atol=VALUE_ATOL)
    for name in ("available_actions", "masks", "active_masks", "dones"):
        np.testing.assert_array_equal(getattr(ttraj, name).numpy(), np.asarray(getattr(traj, name)),
                                      err_msg=name)
    for name in ("rewards", "delays", "payments"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(), np.asarray(getattr(traj, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for k, v in ttraj.chunk_stats.items():
        np.testing.assert_allclose(float(v), float(traj.chunk_stats[k]), rtol=1e-5, err_msg=k)
    assert float(traj.chunk_stats["n_done"]) > 0       # the accounting was exercised
    st1, rs1 = collected["st1"], collected["rs1"]
    np.testing.assert_allclose(st1.episode_acc.numpy(), np.asarray(rs1.episode_acc), rtol=1e-5)
    np.testing.assert_array_equal(st1.mask.numpy(), np.asarray(rs1.mask))


def _torch_traj(traj):
    f = {k: torch.from_numpy(np.array(getattr(traj, k))) for k in (
        "share_obs", "obs", "available_actions", "actions", "log_probs", "values", "rewards",
        "masks", "active_masks", "delays", "payments", "dones")}
    return trollout.Trajectory(**f, chunk_stats={})


def _torch_rollout_state(rs, st_like):
    return st_like._replace(obs=torch.from_numpy(np.array(rs.obs)),
                            share_obs=torch.from_numpy(np.array(rs.share_obs)))


def _update(collected, ppo_epoch, num_mini_batch, key=7, **switches):
    """The same update on both sides (``switches``: PPOConfig fields set on
    both); returns the new weights and metrics."""
    jcfg, tcfg, params = collected["jcfg"], collected["tcfg"], collected["params"]
    common = dict(lr=LR, ppo_epoch=ppo_epoch, num_mini_batch=num_mini_batch, **switches)
    jtrainer = JaxTrainer(JaxPolicy(jcfg, decode_mode="cached"),
                          JaxPPOConfig(update_stream_chunks=0, target_stream_chunk=0, **common))
    k = jax.random.key(key)
    jstate, jmet = jax.jit(jtrainer.train)(jtrainer.init_state(params), collected["traj"],
                                           collected["rs1"], k)
    n_rows = T * E
    perms = torch.from_numpy(np.stack([np.asarray(jax.random.permutation(ke, n_rows))
                                       for ke in jax.random.split(k, ppo_epoch)])).long()
    policy = _policy(tcfg, params)
    trainer = MATTrainer(policy, PPOConfig(**common))
    state = trainer.init_state()
    state, met = trainer.train(state, _torch_traj(collected["traj"]),
                               _torch_rollout_state(collected["rs1"], collected["st1"]), perms=perms)
    return jstate, jmet, policy, state, met


def _moved(jstate, params):
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(
        jax.tree_util.tree_leaves(jstate.params), jax.tree_util.tree_leaves(params)))


def test_one_minibatch_step_matches_jax(collected):
    jstate, jmet, policy, state, met = _update(collected, ppo_epoch=1, num_mini_batch=1)
    assert _moved(jstate, collected["params"]) > 0.5 * LR      # the step did move the weights
    assert param_diff(jstate, policy, LR, 1) <= ONE_STEP_ATOL
    compare_update_metrics(jmet, met)


def test_full_update_matches_jax(collected):
    jstate, jmet, policy, state, met = _update(collected, ppo_epoch=2, num_mini_batch=2)
    steps = 2 * 2
    assert param_diff(jstate, policy, LR, steps) <= 0.01 * LR * steps
    compare_update_metrics(jmet, met)
    vn = jstate.value_norm
    for a, b in zip(state.value_norm, (vn.running_mean, vn.running_mean_sq, vn.debiasing_term)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    assert state.update_step == int(jstate.update_step) == 1


@pytest.mark.parametrize("switch", RECIPE_SWITCHES)
def test_switch_off_the_recipe_raises(collected, switch):
    """Each loss or target switch of the JAX config set off the recipe no
    longer raises (its name is kept from when it did): from the config and
    from the command line it sets the field, and the update with it off
    matches JAX's to the bounds of ``test_full_update_matches_jax``."""
    assert not getattr(PPOConfig(**{switch: False}), switch)
    _, ppo = parse_cli(["--device", "cpu", f"--{switch}", "false"])
    assert not getattr(ppo, switch)
    jstate, jmet, policy, state, met = _update(collected, ppo_epoch=2, num_mini_batch=2,
                                               **{switch: False})
    steps = 2 * 2
    assert _moved(jstate, collected["params"]) > 0.5 * LR
    assert param_diff(jstate, policy, LR, steps) <= 0.01 * LR * steps
    compare_update_metrics(jmet, met)
    vn = jstate.value_norm
    for a, b in zip(state.value_norm, (vn.running_mean, vn.running_mean_sq, vn.debiasing_term)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
