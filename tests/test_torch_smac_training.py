"""SMAC training in the port against the JAX package, f32, on the CPU.

- One collect on 3m (E 2, T 5; MAT with n_embd 32 and one block) against
  the JAX collector, the policy's Gumbel noise and the env's spawn draws
  replayed from JAX's key chains: actions equal, log-probs and values atol
  1e-5, obs atol 1e-6, the ``(A, n_actions)`` availability, masks and dones
  equal, rewards rtol 1e-6 (``tests/test_torch_training.py``'s
  tolerances); then one PPO update of that chunk on both sides from the same
  weights and permutations: the weights within 0.01 lr x steps
  (``param_diff``), the metrics as ``compare_update_metrics`` holds DCML's.
  The same for ``mat_dec`` (MAT-Dec: one shared MLP actor).
- The records: a 2m collect whose battles end inside the chunk (E 2, T 41),
  its episode accounting (``chunk_stats``: battles ended, won, dead ratio)
  against JAX's, and the port's ``SMACRunner`` records ``win_rate`` and
  ``dead_ratio`` in place of the delay and payment channels.
- ``SMACRunner.evaluate`` (deterministic battles until 6 have ended, E 4,
  on 2m) on the reset and step draws replayed from JAX's evaluation key
  chain, against JAX's ``SMACRunner.evaluate``: battles, win rate and dead
  ratio equal, the mean step reward rtol 1e-5.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from mat_dcml_tpu.config import RunConfig as JaxRunConfig
from mat_dcml_tpu.envs.smac import SMACLiteConfig as JaxSMACConfig
from mat_dcml_tpu.envs.smac import SMACLiteEnv as JaxSMACEnv
from mat_dcml_tpu.models.mat import MATConfig as JaxMATConfig
from mat_dcml_tpu.models.policy import TransformerPolicy as JaxPolicy
from mat_dcml_tpu.training.rollout import RolloutCollector as JaxCollector
from mat_dcml_tpu.training.smac_runner import SMACRunner as JaxSMACRunner
from mat_dcml_tpu_torch.bridge import params_from_jax
from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.envs.smac import smaclite
from mat_dcml_tpu_torch.models.mat import MATConfig
from mat_dcml_tpu_torch.models.policy import TransformerPolicy
from mat_dcml_tpu_torch.training import rollout as trollout
from mat_dcml_tpu_torch.training.ppo import PPOConfig
from mat_dcml_tpu_torch.training.smac_runner import SMACRunner, evaluate_battles
from tests.torch_port_helpers import (
    compare_update_metrics,
    jax_params,
    one_torch_thread,  # noqa: F401
    param_diff,
    replay_family_noise,
    smac_next_rngs,
    smac_reset_draws,
    smac_step_draws,
    updates_vs_jax,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-5
LR = 1e-3
VARIANTS = {"mat": {}, "mat_dec": dict(dec_actor=True, share_actor=True)}


def _shape(jenv, n_embd=32, n_block=1, **kw):
    return dict(n_agent=jenv.n_agents, obs_dim=jenv.obs_dim, state_dim=jenv.share_obs_dim,
                action_dim=jenv.n_actions, n_block=n_block, n_embd=n_embd, n_head=2,
                action_type="discrete", **kw)


def _policy(tcfg, params):
    policy = TransformerPolicy(tcfg, device="cpu")
    policy.model.load_state_dict(params_from_jax(params))
    return policy


def collect_both(map_name, E, T, variant="mat", seed=5):
    """One JAX collect on ``map_name`` and the port's replay of it: the
    reset draws from ``init_state``'s keys, per step the Gumbel noise from
    the action key split off the collector's key and the spawn draws from
    each env state's key (which moves on where a battle ends)."""
    jenv = JaxSMACEnv(JaxSMACConfig(map_name=map_name))
    shape = _shape(jenv, **VARIANTS[variant])
    jcfg, tcfg = JaxMATConfig(**shape), MATConfig(**shape)
    params = jax_params(jcfg, seed=seed)
    jcol = JaxCollector(jenv, JaxPolicy(jcfg, decode_mode="cached"), T)
    key = jax.random.key(11)
    rs0 = jcol.init_state(key, E)
    rs1, traj = jax.jit(jcol.collect)(params, rs0)

    env = smaclite.SMACLiteEnv(smaclite.SMACLiteConfig(map_name=map_name), device="cpu")
    A, Ne = env.n_agents, env.n_enemies
    _, k_reset, _ = jax.random.split(key, 3)
    rngs, reset_draws = smac_reset_draws(jax.random.split(k_reset, E), A, Ne)
    dones = np.asarray(traj.dones)
    gumbels, steps, rng = [], [], rs0.rng
    for t in range(T):
        rng, k_act = jax.random.split(rng)
        gumbel, tail = replay_family_noise(k_act, E, jcfg)
        assert tail is None
        gumbels.append(torch.from_numpy(gumbel))
        key_next, d = smac_step_draws(rngs, A, Ne)
        steps.append(d)
        rngs = smac_next_rngs(rngs, key_next, dones[t])
    draws = trollout.CollectDraws(torch.stack(gumbels), None, trollout._stack(steps))
    policy = _policy(tcfg, params)
    col = trollout.RolloutCollector(env, policy, T)
    st1, ttraj = col.collect(col.init_state(E, draws=reset_draws), draws=draws)
    return dict(jcfg=jcfg, params=params, policy=policy, rs1=rs1, traj=traj, st1=st1,
                ttraj=ttraj)


def _compare_collect(c):
    traj, ttraj = c["traj"], c["ttraj"]
    for name in ("log_probs", "values"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(), np.asarray(getattr(traj, name)),
                                   atol=ATOL, err_msg=name)
    for name in ("obs", "share_obs"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(), np.asarray(getattr(traj, name)),
                                   atol=1e-6, err_msg=name)
    for name in ("actions", "available_actions", "masks", "active_masks", "dones", "delays",
                 "payments"):
        np.testing.assert_array_equal(getattr(ttraj, name).numpy(),
                                      np.asarray(getattr(traj, name)), err_msg=name)
    np.testing.assert_allclose(ttraj.rewards.numpy(), np.asarray(traj.rewards), rtol=1e-6,
                               atol=1e-7)
    for k, v in ttraj.chunk_stats.items():
        np.testing.assert_allclose(float(v), float(traj.chunk_stats[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def collected(request):
    return collect_both("3m", E=2, T=5, variant=request.param)


def test_collect_matches_jax(collected):
    _compare_collect(collected)
    acts = collected["ttraj"].actions.long()
    assert (collected["ttraj"].available_actions.gather(-1, acts) == 1).all()


def test_update_matches_jax(collected):
    c = collected
    jstate, jmet, state, met = updates_vs_jax(c["jcfg"], c["params"], c["policy"], c["ttraj"],
                                              c["st1"], dict(lr=LR, ppo_epoch=2,
                                                             num_mini_batch=1))
    steps = 2
    assert param_diff(jstate, c["policy"], LR, steps) <= 0.01 * LR * steps
    compare_update_metrics(jmet, met)


def test_episode_accounting_matches_jax(tmp_path):
    """2m battles end inside a 41-step chunk; the win and dead-ratio sums
    ride the delay and payment channels of the terminal steps."""
    c = collect_both("2m", E=2, T=41, seed=6)
    _compare_collect(c)
    stats = c["ttraj"].chunk_stats
    assert float(stats["n_done"]) >= 2
    # the port's runner renames the channels' episode means
    run = RunConfig(device="cpu", n_rollout_threads=2, episode_length=41, n_embd=16, n_block=1,
                    num_env_steps=82, log_interval=1, save_interval=0, run_dir=str(tmp_path),
                    env_name="StarCraft2", scenario="2m")
    runner = SMACRunner(run, PPOConfig(ppo_epoch=1, num_mini_batch=1),
                        smaclite.SMACLiteConfig(map_name="2m"), log_fn=lambda *_: None)
    runner.train_loop()
    rec = runner.records[0]
    assert {"win_rate", "dead_ratio", "aver_episode_rewards"} <= rec.keys()
    assert not {"aver_episode_delays", "aver_episode_payments"} & rec.keys()
    assert 0.0 <= rec["win_rate"] <= 1.0 and 0.0 <= rec["dead_ratio"] <= 1.0


def test_evaluate_matches_jax(tmp_path):
    E, n_episodes, seed = 4, 6, 2
    jenv = JaxSMACEnv(JaxSMACConfig(map_name="2m"))
    shape = _shape(jenv, n_embd=16)
    jcfg = JaxMATConfig(**shape)
    params = jax_params(jcfg, seed=7)
    jpolicy = JaxPolicy(jcfg, decode_mode="cached")
    fake = SimpleNamespace(run_cfg=JaxRunConfig(n_rollout_threads=E), policy=jpolicy,
                           collector=JaxCollector(jenv, jpolicy, 10), is_mat=True)
    ref = JaxSMACRunner.evaluate(fake, SimpleNamespace(params=params), n_episodes=n_episodes,
                                 seed=seed)

    run = RunConfig(device="cpu", n_rollout_threads=E, n_embd=16, n_block=1, run_dir=str(tmp_path))
    runner = SMACRunner(run, PPOConfig(), smaclite.SMACLiteConfig(map_name="2m"),
                        log_fn=lambda *_: None)
    runner.policy.model.load_state_dict(params_from_jax(params))
    env = runner.env
    # JAX's evaluation chain: init_state(key(seed + 17)), then each env's key
    _, k_reset, _ = jax.random.split(jax.random.key(seed + 17), 3)
    rngs, reset_draws = smac_reset_draws(jax.random.split(k_reset, E), env.n_agents,
                                         env.n_enemies)
    chain = {"rngs": rngs, "next": None}

    def draw_step(done):
        if chain["next"] is not None:
            chain["rngs"] = smac_next_rngs(chain["rngs"], chain["next"], done.numpy())
        chain["next"], draws = smac_step_draws(chain["rngs"], env.n_agents, env.n_enemies)
        return draws

    info = evaluate_battles(runner.policy, env, runner.collector, E, n_episodes, seed,
                            reset_draws=reset_draws, draw_step=draw_step)
    assert info.keys() == ref.keys()
    for k in ("eval_episodes", "eval_win_rate", "eval_dead_ratio"):
        assert info[k] == pytest.approx(ref[k], abs=1e-7), k
    np.testing.assert_allclose(info["eval_average_step_rewards"],
                               ref["eval_average_step_rewards"], rtol=1e-5)
    assert info["eval_episodes"] >= n_episodes
