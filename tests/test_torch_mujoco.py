"""Multi-agent MuJoCo lite in the port against the JAX package, on the CPU.

- The env (``envs/mamujoco/lite.py``) against ``jax.vmap`` of the JAX env,
  its ``uniform`` draws replayed from the JAX key chains, across an episode
  end (auto-reset): obs, state and the all-ones availability exact or to
  atol 1e-6, reward rtol 1e-6 (means over joints summed in another order),
  dones equal.
- One collect of the continuous MAT (HalfCheetah 2x3: 2 agents, 3 torques
  each; n_embd 16) against the JAX collector with the policy noise and env
  draws replayed: actions, log-probs and values to atol 1e-5 (f32,
  summation order only); then PPO updates from the same trajectory, weights
  and permutations.  One minibatch step's metrics are computed on the same
  weights on both sides and are held as ``tests/test_torch_training.py``
  holds DCML's (``compare_update_metrics``: rounding only).  After the whole
  update (2 epochs x 2 minibatches) the weights are held as DCML's
  (``param_diff``, 0.01 lr a step) and the metrics to rtol 1e-4: they are
  averaged over minibatches that run on weights the earlier Adam steps moved,
  and an entry whose gradient sits near Adam's eps (1e-5) takes a step that
  rounding moves by about 1% of lr (measured 1.2e-5 at lr 1e-3, on the
  encoder's first value projection); the Gaussian log-prob divides by a
  variance near 0.07, so those moves show in the surrogate at about 2e-5 of
  its size.
- ``python -m mat_dcml_tpu_torch.train_mujoco --device cpu`` for one tiny
  iteration in each decode mode, and the strict command line.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

from mat_dcml_tpu.envs.mamujoco.lite import MJLiteConfig as JaxMJConfig
from mat_dcml_tpu.envs.mamujoco.lite import MJLiteEnv as JaxMJEnv
from mat_dcml_tpu.models.mat import MATConfig as JaxMATConfig
from mat_dcml_tpu.models.policy import TransformerPolicy as JaxPolicy
from mat_dcml_tpu.training.rollout import RolloutCollector as JaxCollector
from mat_dcml_tpu_torch import train_mujoco
from mat_dcml_tpu_torch.envs.mamujoco import lite
from mat_dcml_tpu_torch.models.mat import MATConfig
from mat_dcml_tpu_torch.training import rollout as trollout
from tests.test_torch_training import LR, _policy, _update
from tests.torch_port_helpers import (
    compare_update_metrics,
    jax_params,
    param_diff,
    replay_family_noise,
)

ATOL = 1e-5
E, T = 4, 4   # the sizes _update (tests/test_torch_training.py) permutes over


def _reset_draws_one(key, n_joints):
    """``MJLiteEnv.reset``'s draws from ``key`` (``lite.py:118-124``) and the
    key its state keeps."""
    key, k_th, k_tg = jax.random.split(key, 3)
    return key, (jax.random.uniform(k_th, (n_joints,), minval=-0.1, maxval=0.1),
                 jax.random.uniform(k_tg, (n_joints,), minval=-1.0, maxval=1.0))


def jax_reset_draws(keys, n_joints):
    _, (theta, target) = jax.vmap(lambda k: _reset_draws_one(k, n_joints))(keys)
    return lite.ResetDraws(torch.from_numpy(np.array(theta)), torch.from_numpy(np.array(target)))


def jax_step_draws(rngs, n_joints):
    """``(next keys, port StepDraws)`` from the env states' keys: ``step``
    splits ``key_next, k_spawn`` and draws a reset from ``k_spawn``
    (``lite.py:160-161``)."""
    pairs = jax.vmap(jax.random.split)(rngs)
    return pairs[:, 0], lite.StepDraws(jax_reset_draws(pairs[:, 1], n_joints))


@pytest.mark.parametrize("scenario,conf,obsk", [("HalfCheetah-v2", "2x3", 1),
                                                ("manyagent_ant", "2x2", 1),
                                                ("Ant-v2", "2x4d", 2)])
def test_env_matches_jax(scenario, conf, obsk):
    kw = dict(scenario=scenario, agent_conf=conf, agent_obsk=obsk, episode_length=3)
    jenv = JaxMJEnv(JaxMJConfig(**kw))
    env = lite.MJLiteEnv(lite.MJLiteConfig(**kw), device="cpu")
    J = env.n_joints
    assert (env.n_agents, env.obs_dim, env.share_obs_dim, env.action_dim) == (
        jenv.n_agents, jenv.obs_dim, jenv.share_obs_dim, jenv.action_dim)
    keys = jax.random.split(jax.random.key(4), E)
    jst, jts = jax.vmap(jenv.reset)(keys)
    st, ts = env.reset(jax_reset_draws(keys, J))
    rng = np.random.default_rng(0)
    rngs, ended = jst.rng, False
    for t in range(5):                     # the episode ends at step 3
        for name in ("obs", "share_obs", "available_actions"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(jts, name)),
                                       atol=1e-6, err_msg=f"{name} at step {t}")
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(jts.reward), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(jts.done))
        ended = ended or bool(ts.done.any())
        action = rng.normal(scale=1.5, size=(E, env.n_agents, env.action_dim)).astype(np.float32)
        rngs, draws = jax_step_draws(rngs, J)
        jst, jts = jax.vmap(jenv.step)(jst, action)
        st, ts = env.step(st, torch.from_numpy(action), draws)
        # the replayed key chain is the env's own
        np.testing.assert_array_equal(jax.random.key_data(jst.rng), jax.random.key_data(rngs))
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(jst.t))
    assert ended


@pytest.fixture(scope="module")
def collected():
    """One JAX collect on HalfCheetah 2x3 (episodes of 3 steps, so one ends
    inside the chunk) and the port's replay of it."""
    kw = dict(scenario="HalfCheetah-v2", agent_conf="2x3", agent_obsk=1, episode_length=3)
    jenv = JaxMJEnv(JaxMJConfig(**kw))
    shape = dict(n_agent=jenv.n_agents, obs_dim=jenv.obs_dim, state_dim=jenv.share_obs_dim,
                 action_dim=jenv.action_dim, n_block=2, n_embd=16, n_head=2,
                 action_type="continuous")
    jcfg, tcfg = JaxMATConfig(**shape), MATConfig(**shape)
    params = jax_params(jcfg, seed=5)
    jcol = JaxCollector(jenv, JaxPolicy(jcfg, decode_mode="cached"), T)
    key = jax.random.key(11)
    rs0 = jcol.init_state(key, E)
    rs1, traj = jax.jit(jcol.collect)(params, rs0)

    env = lite.MJLiteEnv(lite.MJLiteConfig(**kw), device="cpu")
    _, k_reset, _ = jax.random.split(key, 3)
    reset_draws = jax_reset_draws(jax.random.split(k_reset, E), env.n_joints)
    tails, steps = [], []
    rng, env_rng = rs0.rng, rs0.env_states.rng
    for _ in range(T):
        rng, k_act = jax.random.split(rng)
        gumbel, tail = replay_family_noise(k_act, E, jcfg)
        assert gumbel is None
        tails.append(torch.from_numpy(tail))
        env_rng, d = jax_step_draws(env_rng, env.n_joints)
        steps.append(d)
    draws = trollout.CollectDraws(None, torch.stack(tails), trollout._stack(steps))
    col = trollout.RolloutCollector(env, _policy(tcfg, params), T)
    st0 = col.init_state(E, draws=reset_draws)
    st1, ttraj = col.collect(st0, draws=draws)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, rs1=rs1, traj=traj, st1=st1, ttraj=ttraj)


def test_collect_matches_jax(collected):
    traj, ttraj = collected["traj"], collected["ttraj"]
    assert ttraj.actions.shape == (T, E, 2, 3) and ttraj.log_probs.shape == (T, E, 2, 3)
    for name in ("actions", "log_probs", "values", "obs", "share_obs"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(), np.asarray(getattr(traj, name)),
                                   atol=ATOL, err_msg=name)
    for name in ("available_actions", "masks", "active_masks", "dones"):
        np.testing.assert_array_equal(getattr(ttraj, name).numpy(),
                                      np.asarray(getattr(traj, name)), err_msg=name)
    np.testing.assert_allclose(ttraj.rewards.numpy(), np.asarray(traj.rewards), rtol=1e-6,
                               atol=1e-6)
    for k, v in ttraj.chunk_stats.items():
        np.testing.assert_allclose(float(v), float(traj.chunk_stats[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(traj.chunk_stats["n_done"]) > 0       # an episode ended inside the chunk
    np.testing.assert_allclose(collected["st1"].episode_acc.numpy(),
                               np.asarray(collected["rs1"].episode_acc), rtol=1e-5, atol=1e-6)


def test_one_minibatch_step_matches_jax(collected):
    jstate, jmet, policy, state, met = _update(collected, ppo_epoch=1, num_mini_batch=1)
    compare_update_metrics(jmet, met)


def test_update_matches_jax(collected):
    jstate, jmet, policy, state, met = _update(collected, ppo_epoch=2, num_mini_batch=2)
    steps = 2 * 2
    assert param_diff(jstate, policy, LR, steps) <= 0.01 * LR * steps
    for name in ("value_loss", "policy_loss", "dist_entropy", "grad_norm", "ratio",
                 "param_norm", "update_ratio", "nonfinite_grads"):
        np.testing.assert_allclose(float(getattr(met, name)), float(getattr(jmet, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("mode", ["cached", "scan"])
def test_train_mujoco_runs_on_the_cpu(tmp_path, mode):
    train_mujoco.main(["--device", "cpu", "--num_env_steps", "16", "--n_rollout_threads", "2",
                       "--episode_length", "4", "--n_embd", "16", "--n_block", "1",
                       "--ppo_epoch", "1", "--num_mini_batch", "2", "--log_interval", "1",
                       "--decode_mode", mode, "--run_dir", str(tmp_path)])
    path = tmp_path / "mujoco" / "HalfCheetah-v2_2x3" / "mat" / "check" / "metrics.jsonl"
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(records) == 2
    assert all(math.isfinite(v) for r in records for v in r.values())
    assert records[0]["aver_episode_rewards"] < 0      # one 4-step episode a chunk ended


def test_train_mujoco_random_order_runs_on_the_cpu(tmp_path):
    """``--random_order`` (``envs/permute.py``; held against JAX in
    ``tests/test_torch_smac_env.py``) trains through the permutation wrapper."""
    train_mujoco.main(["--device", "cpu", "--num_env_steps", "16", "--n_rollout_threads", "2",
                       "--episode_length", "4", "--n_embd", "16", "--n_block", "1",
                       "--ppo_epoch", "1", "--num_mini_batch", "2", "--log_interval", "1",
                       "--random_order", "--run_dir", str(tmp_path)])
    path = tmp_path / "mujoco" / "HalfCheetah-v2_2x3" / "mat" / "check" / "metrics.jsonl"
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(records) == 2 and all(math.isfinite(v) for r in records for v in r.values())


def test_train_mujoco_defaults():
    run, ppo, env_cfg, random_order = train_mujoco.parse([])
    assert not random_order
    assert (run.env_name, run.scenario, run.episode_length) == ("mujoco", "HalfCheetah-v2_2x3", 50)
    assert (env_cfg.scenario, env_cfg.agent_conf, env_cfg.agent_obsk) == ("HalfCheetah-v2", "2x3", 1)
    assert (run.n_rollout_threads, run.device, ppo.ppo_epoch, ppo.lr) == (8, "cuda", 15, 5e-5)


@pytest.mark.parametrize("flags", [["--faulty_node", "1"], ["--eval_faulty_node", "0,1"],
                                   ["--backend", "gym"], ["--minibatch_layout", "contiguous"]],
                         ids=["faulty_node", "eval_faulty_node", "gym", "switch"])
def test_train_mujoco_rejects_what_is_not_ported(flags):
    with pytest.raises((SystemExit, NotImplementedError)):
        train_mujoco.parse(["--device", "cpu", *flags])


@pytest.mark.parametrize("flags", [["--dec_actor", "true"], ["--encode_state", "true"],
                                   ["--n_objective", "2"]],
                         ids=["dec_actor", "encode_state", "n_objective"])
def test_train_mujoco_rejects_dcml_model_fields(tmp_path, flags):
    """MAT-Dec, ``encode_state`` and MO critics are read on DCML only: the
    MuJoCo runner rejects them before it trains."""
    with pytest.raises(NotImplementedError, match="DCML only"):
        train_mujoco.main(["--device", "cpu", "--run_dir", str(tmp_path), *flags])
    assert not (tmp_path / "mujoco").exists()
