"""MO-MAT and DMO-MAT in the PyTorch port against the JAX package, on the CPU.

The slice: the env's objective channels, the per-objective GAE and the
width-2 ValueNorm, the two-objective critic (and ``encode_state``), the
``momat`` and ``dmomat`` collects, their PPO updates, the trainer's lr
decay, weight decay and PopArt, the manifests, a ``dmomat`` stop and
resume, the entry point and the sweep's preference widening.

Sizes: DCML's 101 agents at n_embd 16 (2 blocks), E 4, T 4.  Weights come
from JAX and are carried across with ``bridge.py``; env draws, policy noise
and DMO-MAT's exponentials are replayed from the JAX key chains
(``tests/torch_port_helpers.py``).  The updates run on a trajectory the
port collects from the bridged weights, the same one on both sides (where
a trajectory comes from does not change the update's arithmetic), so only
the collect tests compile a JAX collect.

Tolerances, as ``PERF.md`` section 6 (f32): env outputs rtol 1e-6; GAE and
ValueNorm rtol 1e-6; forward passes atol 1e-5; collect actions equal,
log-probs 1e-5, values 1e-4 (a disabled worker's near-constant obs row);
an update's weights 0.01 lr x steps, its metrics rtol 1e-5.
"""

import json
import math
import os
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import benchmark_dcml
from mat_dcml_tpu.envs.dcml.env import DCMLEnv as JaxEnv
from mat_dcml_tpu.envs.dcml.env import DCMLEnvConfig as JaxEnvConfig
from mat_dcml_tpu.envs.dcml.preset import load_sample as jax_load_sample
from mat_dcml_tpu.models.mat import MultiAgentTransformer as JaxMAT
from mat_dcml_tpu.models.policy import TransformerPolicy as JaxPolicy
from mat_dcml_tpu.ops.gae import compute_gae as jax_gae
from mat_dcml_tpu.ops import normalize as jnorm
from mat_dcml_tpu.training import checkpoint as jckpt
from mat_dcml_tpu.training.rollout import RolloutCollector as JaxCollector
from mat_dcml_tpu_torch import train_dcml
from mat_dcml_tpu_torch.bridge import params_from_jax
from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.envs.dcml import env as tenv
from mat_dcml_tpu_torch.envs.dcml import preset as tpreset
from mat_dcml_tpu_torch.envs.dcml.constants import DCMLConsts
from mat_dcml_tpu_torch.models.policy import TransformerPolicy
from mat_dcml_tpu_torch.ops import normalize as tnorm
from mat_dcml_tpu_torch.ops.gae import compute_gae
from mat_dcml_tpu_torch.sweep_dcml import make_sweep_run
from mat_dcml_tpu_torch.training import checkpoint as ckpt
from mat_dcml_tpu_torch.training import rollout as trollout
from mat_dcml_tpu_torch.training.ppo import MATTrainer, PPOConfig
from mat_dcml_tpu_torch.training.resilience import EXIT_PREEMPTED
from mat_dcml_tpu_torch.training.runner import DCMLRunner, build_mat_policy
from tests.torch_port_helpers import (
    assert_states_equal,
    compare_update_metrics,
    configs,
    inputs,
    jax_params,
    jax_reset_draws,
    jax_step_draws,
    one_torch_thread,  # noqa: F401
    param_diff,
    replay_noise,
    torch_in,
    torch_model,
    updates_vs_jax,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
DCML = dict(n_agent=101, obs_dim=7, state_dim=102, action_dim=2, n_block=2, n_embd=16,
            n_head=2, action_type="semi_discrete", semi_index=-1)
MO = dict(DCML, n_objective=2)
DMO = dict(MO, obs_dim=9, state_dim=104)     # obs and state widened by the preference
E, T = 4, 4
RTOL = 1e-6
ATOL = 1e-5
VALUE_ATOL = 1e-4
LR = 1e-3
EPOCHS, MINIBATCHES = 2, 2
STEPS = EPOCHS * MINIBATCHES
UPDATE_TOL = 0.01 * LR * STEPS


# ------------------------------------------------------------------ the env

@pytest.mark.parametrize("seed", [1, 2])
def test_env_objectives_match_jax(seed):
    """The objective channels of the recipe env against JAX on replayed
    draws, one env selecting no worker (the standalone path, 1.5x); the
    channels sum to the reward."""
    consts = DCMLConsts()
    n = 6
    jenv = JaxEnv(JaxEnvConfig(), data_dir=ROOT / "data")
    env = tenv.DCMLEnv(tenv.DCMLEnvConfig(), device="cpu")
    keys = jax.random.split(jax.random.key(seed), n)
    jstate, jts = jax.vmap(jenv.reset)(keys, jnp.zeros(n, jnp.int32))
    state, ts = env.reset(jax_reset_draws(keys, consts))
    np.testing.assert_array_equal(ts.objectives.numpy(), np.asarray(jts.objectives))
    rng = np.random.default_rng(seed)
    jstep = jax.jit(jax.vmap(jenv.step))
    standalone = 0
    for _ in range(3):
        sel = (rng.uniform(size=(n, 100)) < rng.uniform(0.1, 0.9, size=(n, 1))).astype(np.float32)
        sel[0] = 0.0
        act = np.concatenate([sel, rng.uniform(size=(n, 1)).astype(np.float32)], 1)[..., None]
        _, draws = jax_step_draws(jstate.rng, consts)
        jstate, jts = jstep(jstate, jnp.asarray(act))
        state, ts = env.step(state, torch.from_numpy(act), draws)
        assert ts.objectives.shape == (n, 101, 2)
        np.testing.assert_allclose(ts.objectives.numpy(), np.asarray(jts.objectives),
                                   rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(ts.objectives.sum(-1, keepdim=True).numpy(),
                                   ts.reward.numpy(), rtol=1e-5)
        alone = ts.objectives[0, 0, 0] / (-ts.delay[0] * consts.reward_alpha)
        standalone += int(abs(float(alone) - 1.5) < 1e-5)
    assert standalone == 3          # env 0's rows took the 1.5x path


@pytest.mark.parametrize("mode", ["fixed", "preset"])
def test_env_modes_carry_objectives(mode):
    """The preset and ``fixed`` modes (held against JAX in
    ``test_torch_eval.py``) carry the same channels: (-delay alpha, -payment
    beta), summing to the reward."""
    consts = DCMLConsts()
    env = tenv.DCMLEnv(tenv.DCMLEnvConfig(**{mode: True}), device="cpu")
    gen = torch.Generator().manual_seed(4)
    state, _ = env.reset(env.draw_reset(E, gen))
    act = torch.ones(E, 101, 1)
    act[:, -1] = 0.6
    for _ in range(2):
        state, ts = env.step(state, act, env.draw_step(E, gen))
        want = torch.stack([-ts.delay * consts.reward_alpha, -ts.payment * consts.reward_beta], -1)
        torch.testing.assert_close(ts.objectives, want[:, None].expand(E, 101, 2), rtol=RTOL,
                                   atol=0)
        torch.testing.assert_close(ts.objectives.sum(-1, keepdim=True), ts.reward, rtol=1e-5,
                                   atol=0)


# ---------------------------------------------------------- GAE, ValueNorm

def test_mo_gae_matches_jax_and_per_channel():
    rng = np.random.default_rng(0)
    rewards = rng.normal(size=(6, 3, 5, 2)).astype(np.float32)
    values = rng.normal(size=(7, 3, 5, 2)).astype(np.float32)
    masks = (rng.uniform(size=(7, 3, 5, 1)) > 0.3).astype(np.float32)
    adv, ret = compute_gae(*torch_in(rewards, values, masks), 0.99, 0.95)
    jadv, jret = jax_gae(rewards, values, masks, 0.99, 0.95)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=RTOL, atol=1e-6)
    for i in range(2):
        adv_i, ret_i = compute_gae(*torch_in(rewards[..., i:i + 1], values[..., i:i + 1], masks),
                                   0.99, 0.95)
        np.testing.assert_array_equal(adv[..., i:i + 1].numpy(), adv_i.numpy())
        np.testing.assert_array_equal(ret[..., i:i + 1].numpy(), ret_i.numpy())


def test_width_2_value_norm_matches_jax():
    rng = np.random.default_rng(1)
    st, jst = tnorm.value_norm_init(2), jnorm.value_norm_init(2)
    assert st.running_mean.shape == (2,)
    for _ in range(3):
        batch = (rng.normal(size=(16, 2)) * [3.0, 1.0] + [-2.0, 0.5]).astype(np.float32)
        st = tnorm.value_norm_update(st, torch.from_numpy(batch))
        jst = jnorm.value_norm_update(jst, batch)
    for a, b in zip(st, (jst.running_mean, jst.running_mean_sq, jst.debiasing_term)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    x = rng.normal(size=(4, 101, 2)).astype(np.float32)
    np.testing.assert_allclose(tnorm.value_norm_normalize(st, torch.from_numpy(x)).numpy(),
                               np.asarray(jnorm.value_norm_normalize(jst, x)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tnorm.value_norm_denormalize(st, torch.from_numpy(x)).numpy(),
                               np.asarray(jnorm.value_norm_denormalize(jst, x)), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------------ models

@pytest.mark.parametrize("shape", [MO, dict(MO, encode_state=True), DMO],
                         ids=["momat", "encode_state", "dmomat"])
def test_forward_matches_jax(shape):
    """Values ``(B, A, 2)`` and the teacher-forced logits against JAX, and
    ``evaluate_actions`` against JAX's at atol 1e-5."""
    jcfg, tcfg = configs(shape)
    params = jax_params(jcfg, seed=5)
    state, obs, avail = inputs(jcfg, 3)
    sh = np.zeros((3, 101, jcfg.action_input_dim), np.float32)
    sh[:, 0, 0] = 1.0
    jv, jrep, jlogits = JaxMAT(jcfg).apply(params, state, obs, sh)
    model = torch_model(tcfg, params)
    with torch.no_grad():
        v, rep, logits = model(*torch_in(state, obs, sh))
    assert v.shape == (3, 101, 2)
    for a, b in ((v, jv), (rep, jrep), (logits, jlogits)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    act = np.zeros((3, 101, 1), np.float32)
    idx = np.random.default_rng(2).integers(0, 2, size=(3, 100))
    act[:, :-1, 0] = np.where(avail[:, :-1, 1] > 0, idx, 0)     # available actions only
    act[:, -1, 0] = 0.4
    policy = TransformerPolicy(tcfg, device="cpu")
    policy.model.load_state_dict(params_from_jax(params))
    jres = JaxPolicy(jcfg).evaluate_actions(params, state, obs, act, avail)
    with torch.no_grad():
        res = policy.evaluate_actions(*torch_in(state, obs, act, avail))
    for a, b in zip(res, jres):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


# ----------------------------------------------------------------- collect

def _collect(shape, dynamic, key=11, seed=3):
    """One JAX collect and the port's replay of it: env, policy noise and,
    under DMO-MAT, the ``k_coef`` chain (``init_state``'s three-way split,
    then ``key, k_coef = split(key)`` after each step's action key)."""
    jcfg, tcfg = configs(shape)
    params = jax_params(jcfg, seed=seed)
    consts = DCMLConsts()
    jenv = JaxEnv(JaxEnvConfig(), data_dir=ROOT / "data")
    jcol = JaxCollector(jenv, JaxPolicy(jcfg, decode_mode="cached"), T,
                        dynamic_coefficients=dynamic)
    k = jax.random.key(key)
    rs0 = jcol.init_state(k, E)
    rs1, traj = jax.jit(jcol.collect)(params, rs0)

    _, k_reset, k_coef = jax.random.split(k, 3)
    reset_draws = jax_reset_draws(jax.random.split(k_reset, E), consts)
    def exp(kk):
        return torch.from_numpy(np.array(jax.random.exponential(kk, (E, 2))))

    coef0 = exp(k_coef) if dynamic else None
    gumbel, tail, steps, coef_exp = [], [], [], []
    rng, env_rng = rs0.rng, rs0.env_states.rng
    for _ in range(T):
        rng, k_act = jax.random.split(rng)
        g, tl = replay_noise(k_act, E, jcfg)
        gumbel.append(torch.from_numpy(g))
        tail.append(torch.from_numpy(tl))
        env_rng, d = jax_step_draws(env_rng, consts)
        steps.append(d)
        if dynamic:
            rng, kc = jax.random.split(rng)
            coef_exp.append(exp(kc))
    env_draws = tenv.StepDraws(
        *(torch.stack(xs) for xs in zip(*(s[:4] for s in steps))),
        reset=tenv.ResetDraws(*(torch.stack(xs) for xs in zip(*(s.reset for s in steps)))),
    )
    draws = trollout.CollectDraws(torch.stack(gumbel), torch.stack(tail), env_draws,
                                  torch.stack(coef_exp) if dynamic else None)
    policy = TransformerPolicy(tcfg, device="cpu")
    policy.model.load_state_dict(params_from_jax(params))
    col = trollout.RolloutCollector(tenv.DCMLEnv(device="cpu"), policy, T,
                                    dynamic_coefficients=dynamic)
    st0 = col.init_state(E, draws=reset_draws, coef_exp=coef0)
    st1, ttraj = col.collect(st0, draws=draws)
    return dict(rs0=rs0, rs1=rs1, traj=traj, st0=st0, st1=st1, ttraj=ttraj)


def _compare_collect(c):
    traj, ttraj = c["traj"], c["ttraj"]
    np.testing.assert_array_equal(ttraj.actions[..., :-1, :].numpy(),
                                  np.asarray(traj.actions)[..., :-1, :])
    np.testing.assert_allclose(ttraj.actions.numpy(), np.asarray(traj.actions), atol=ATOL)
    for name in ("log_probs", "obs", "share_obs"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(), np.asarray(getattr(traj, name)),
                                   atol=ATOL, err_msg=name)
    assert ttraj.values.shape == ttraj.rewards.shape == (T, E, 101, 2)
    np.testing.assert_allclose(ttraj.values.numpy(), np.asarray(traj.values), atol=VALUE_ATOL)
    np.testing.assert_allclose(ttraj.rewards.numpy(), np.asarray(traj.rewards), rtol=RTOL,
                               atol=1e-6)
    for name in ("masks", "dones"):
        np.testing.assert_array_equal(getattr(ttraj, name).numpy(), np.asarray(getattr(traj, name)))
    assert set(ttraj.chunk_stats) == set(traj.chunk_stats)
    assert {"step_objective_0_mean", "step_objective_1_mean"} <= set(ttraj.chunk_stats)
    for k, v in ttraj.chunk_stats.items():
        np.testing.assert_allclose(float(v), float(traj.chunk_stats[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(c["st1"].episode_acc.numpy(), np.asarray(c["rs1"].episode_acc),
                               rtol=1e-5)


def test_momat_collect_matches_jax():
    c = _collect(MO, dynamic=False)
    _compare_collect(c)
    assert c["ttraj"].objective_coefficients is None
    assert float(c["traj"].chunk_stats["n_done"]) > 0


def test_dmomat_collect_matches_jax():
    """The preference weights equal JAX's at init and at every step, are
    redrawn only where an episode ended, and widen obs and share_obs."""
    c = _collect(DMO, dynamic=True)
    _compare_collect(c)
    st0, rs0, ttraj, traj = c["st0"], c["rs0"], c["ttraj"], c["traj"]
    np.testing.assert_allclose(st0.objective_coefficients.numpy(),
                               np.asarray(rs0.objective_coefficients), rtol=RTOL)
    np.testing.assert_allclose(st0.obs.numpy(), np.asarray(rs0.obs), atol=1e-6)
    np.testing.assert_allclose(st0.share_obs.numpy(), np.asarray(rs0.share_obs), atol=1e-6)
    coefs = ttraj.objective_coefficients.numpy()
    assert coefs.shape == (T, E, 2)
    np.testing.assert_allclose(coefs, np.asarray(traj.objective_coefficients), rtol=RTOL)
    np.testing.assert_allclose(c["st1"].objective_coefficients.numpy(),
                               np.asarray(c["rs1"].objective_coefficients), rtol=RTOL)
    np.testing.assert_allclose(coefs.sum(-1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(ttraj.obs[..., -2:].numpy(),
                                  np.broadcast_to(coefs[:, :, None], (T, E, 101, 2)))
    np.testing.assert_array_equal(ttraj.share_obs[..., -2:].numpy(), ttraj.obs[..., -2:].numpy())
    dones = ttraj.dones.numpy()
    nxt = np.concatenate([coefs[1:], c["st1"].objective_coefficients.numpy()[None]])
    for t in range(T):
        for e in range(E):
            assert np.array_equal(nxt[t, e], coefs[t, e]) != bool(dones[t, e]), (t, e)
    assert dones.any()


# ------------------------------------------------------------------ update

def _port_chunk(shape, dynamic, seed=3):
    """The JAX weights, the port's policy on them, and one chunk the port
    collects from them (its own draws)."""
    jcfg, tcfg = configs(shape)
    params = jax_params(jcfg, seed=seed)
    policy = TransformerPolicy(tcfg, device="cpu")
    policy.model.load_state_dict(params_from_jax(params))
    gen = torch.Generator().manual_seed(seed)
    col = trollout.RolloutCollector(tenv.DCMLEnv(device="cpu"), policy, T,
                                    dynamic_coefficients=dynamic)
    st1, traj = col.collect(col.init_state(E, generator=gen), generator=gen)
    return jcfg, params, policy, traj, st1


UPDATES = {
    "momat_combined_3_1": (MO, False, dict(objective_weights="3,1")),
    "momat_per_channel_3_1": (MO, False, dict(mo_combined_norm=False, objective_weights="3,1")),
    "dmomat": (DMO, True, dict()),
    "weight_decay": (MO, False, dict(weight_decay=1e-2)),
    "popart": (DCML, False, dict(use_valuenorm=False, use_popart=True)),
}


@pytest.mark.parametrize("case", sorted(UPDATES))
def test_update_matches_jax(case):
    """One PPO update (2 epochs x 2 minibatches) of the same chunk on both
    sides: weights within 0.01 lr x steps, metrics rtol 1e-5, the ValueNorm
    rtol 1e-5.  DMO-MAT's update reads the chunk's per-step weights."""
    shape, dynamic, kw = UPDATES[case]
    jcfg, params, policy, traj, st1 = _port_chunk(shape, dynamic)
    assert (traj.objective_coefficients is not None) == dynamic
    ppo_kw = dict(lr=LR, ppo_epoch=EPOCHS, num_mini_batch=MINIBATCHES, **kw)
    jstate, jmet, state, met = updates_vs_jax(jcfg, params, policy, traj, st1, ppo_kw)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree_util.tree_leaves(jstate.params),
                                jax.tree_util.tree_leaves(params)))
    assert moved > 0.5 * LR
    assert param_diff(jstate, policy, LR, STEPS) <= UPDATE_TOL
    compare_update_metrics(jmet, met)
    vn = jstate.value_norm
    for a, b in zip(state.value_norm, (vn.running_mean, vn.running_mean_sq, vn.debiasing_term)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    assert state.value_norm.running_mean.shape == (shape.get("n_objective", 1),)


def test_lr_decay_matches_optax_across_updates():
    """``use_linear_lr_decay`` over 3 updates of 4 Adam steps with a
    schedule of 6: the lr of every Adam step equals optax's
    ``linear_schedule``, reaching 0 inside the second update (optax counts
    Adam steps, not updates), and the weights after the third update equal
    JAX's."""
    total = 6
    sched = optax.linear_schedule(LR, 0.0, total)
    jcfg, params, policy, traj, st1 = _port_chunk(MO, False)
    trainer = MATTrainer(policy, PPOConfig(lr=LR, use_linear_lr_decay=True),
                         total_updates=total)
    for count in range(3 * STEPS):
        assert trainer.lr_at(count) == float(sched(count)), count
    assert trainer.lr_at(total) == 0.0 and trainer.lr_at(STEPS) > 0.0
    assert MATTrainer(policy, PPOConfig(lr=LR), total_updates=total).lr_at(total) == LR

    ppo_kw = dict(lr=LR, ppo_epoch=EPOCHS, num_mini_batch=MINIBATCHES, use_linear_lr_decay=True)
    jstate, jmet, state, met = updates_vs_jax(jcfg, params, policy, traj, st1, ppo_kw,
                                              n_updates=3, total_updates=total)
    assert param_diff(jstate, policy, LR, 3 * STEPS) <= 0.01 * LR * 3 * STEPS
    # the third update runs at lr 0: the port's steps are 0; jitted, XLA
    # turns optax's ``count / 6`` into a product by the reciprocal, so JAX's
    # "0" is ~3e-11 and its weights still move by that much of an Adam step
    compare_update_metrics(jmet, met, ratio_atol=1e-9)
    assert float(met.update_ratio) == 0.0 and float(jmet.update_ratio) < 1e-9
    assert state.optimizer.param_groups[0]["lr"] == 0.0


def test_objective_weights_parsing():
    from mat_dcml_tpu_torch.training.ppo import parse_objective_weights

    np.testing.assert_allclose(parse_objective_weights("3,1", 2), [0.75, 0.25])
    np.testing.assert_allclose(parse_objective_weights("", 2), [0.5, 0.5])
    with pytest.raises(ValueError, match="3 entries for 2 objectives"):
        parse_objective_weights("1,2,3", 2)
    policy = TransformerPolicy(configs(MO)[1], device="cpu")
    with pytest.raises(ValueError):
        MATTrainer(policy, PPOConfig(objective_weights="1"))


# ------------------------------------------------------ checkpoints, resume

def _runner(run_dir, algo="dmomat", episodes=3, log_fn=lambda *_: None, **kw):
    run = RunConfig(device="cpu", algorithm_name=algo, n_rollout_threads=2, episode_length=T,
                    n_embd=16, n_block=1, num_env_steps=episodes * T * 2, log_interval=1,
                    save_interval=1, run_dir=str(run_dir), **kw)
    return DCMLRunner(run, PPOConfig(ppo_epoch=1, num_mini_batch=2, lr=1e-3), log_fn=log_fn)


@pytest.mark.parametrize("algo", ["momat", "dmomat"])
def test_manifest_matches_jax(tmp_path, algo):
    """The export manifest of a ``momat`` / ``dmomat`` policy equals JAX's
    field by field (the widened widths, ``n_objective``, the MAT-Dec and
    ``encode_state`` fields)."""
    from mat_dcml_tpu.config import RunConfig as JaxRunConfig
    from mat_dcml_tpu.training.runner import build_mat_policy as jax_build

    jpolicy = jax_build(JaxRunConfig(algorithm_name=algo, n_embd=16, n_block=1),
                        JaxEnv(JaxEnvConfig(), data_dir=ROOT / "data"))
    policy = build_mat_policy(RunConfig(algorithm_name=algo, n_embd=16, n_block=1, device="cpu"),
                              tenv.DCMLEnv(device="cpu"), device="cpu")
    meta = {"algorithm_name": algo}
    jckpt.export_policy(tmp_path / "jax", jpolicy.init_params(jax.random.key(0)), jpolicy.cfg,
                        meta, generation=1)
    ckpt.export_policy(tmp_path / "port", policy.model.state_dict(), policy.cfg, meta,
                       generation=1)
    jm, pm = jckpt.read_manifest(tmp_path / "jax"), ckpt.read_manifest(tmp_path / "port")
    assert pm["mat_config"].keys() <= jm["mat_config"].keys()
    for k, v in pm["mat_config"].items():
        assert v == jm["mat_config"][k], k
    assert pm["mat_config"]["n_objective"] == 2
    assert pm["mat_config"]["obs_dim"] == (9 if algo == "dmomat" else 7)


def test_dmomat_stop_and_resume_equals_uninterrupted_run(tmp_path):
    """3 uninterrupted ``dmomat`` episodes against 2, a SIGTERM, the
    emergency carry (with the preference weights) and a ``resume="auto"``
    run of the last: bit for bit, metrics records included."""
    def sigterm_after_1(msg):
        if msg.startswith("ep 1 "):
            os.kill(os.getpid(), signal.SIGTERM)

    clock = ("fps", "step_time_collect", "step_time_train")
    records = lambda r: [{k: v for k, v in x.items() if k not in clock} for x in r.records]  # noqa

    ref = _runner(tmp_path / "a")
    ref_state, ref_rollout = ref.train_loop()
    first = _runner(tmp_path / "b", log_fn=sigterm_after_1)
    with pytest.raises(SystemExit) as exc:
        first.train_loop()
    assert exc.value.code == EXIT_PREEMPTED
    carry = first.emergency.restore(2)
    assert carry["rollout_state"]["objective_coefficients"].shape == (2, 2)
    resumed = _runner(tmp_path / "b", resume="auto")
    state, rollout = resumed.train_loop()
    assert resumed.start_episode == 2
    final = lambda r, s: {**r.trainer.state_dict(s), "generator": r.generator.get_state()}  # noqa
    assert_states_equal(final(resumed, state), final(ref, ref_state))
    assert torch.equal(rollout.objective_coefficients, ref_rollout.objective_coefficients)
    assert records(first) + records(resumed) == records(ref)
    assert all("average_step_objective_1" in r for r in ref.records)


def test_train_dcml_momat_writes_objective_records(tmp_path):
    train_dcml.main(["--device", "cpu", "--run_dir", str(tmp_path), "--algorithm_name", "momat",
                     "--num_env_steps", "32", "--n_rollout_threads", "4", "--episode_length",
                     "4", "--n_embd", "16", "--n_block", "1", "--ppo_epoch", "2",
                     "--num_mini_batch", "2", "--log_interval", "1", "--objective_weights",
                     "3,1", "--mo_combined_norm", "false", "--use_linear_lr_decay", "true",
                     "--weight_decay", "1e-4"])
    lines = (tmp_path / "DCML/AS/momat/check/metrics.jsonl").read_text().splitlines()
    records = [json.loads(x) for x in lines]
    assert [r["episode"] for r in records] == [0, 1]
    for r in records:
        assert {"average_step_objective_0", "average_step_objective_1"} <= set(r)
        assert all(math.isfinite(v) for v in r.values())
        np.testing.assert_allclose(r["average_step_objective_0"] + r["average_step_objective_1"],
                                   r["average_step_rewards"], rtol=1e-4)


def test_dmomat_evaluate_and_export_serve(tmp_path):
    """``evaluate`` reads the widened obs; the export of a ``dmomat``
    checkpoint serves through ``DecodeEngine.from_export`` at the widened
    width, equal to the engine on the in-memory weights."""
    from mat_dcml_tpu_torch import export_policy as export_cli
    from mat_dcml_tpu_torch.serving.engine import DecodeEngine, EngineConfig

    runner = _runner(tmp_path / "run", episodes=1)
    runner.train_loop()
    info = runner.evaluate(n_steps=3)
    assert all(math.isfinite(v) for v in info.values())
    out = tmp_path / "export"
    assert export_cli.main(["--device", "cpu", "--algorithm_name", "dmomat", "--n_embd", "16",
                            "--n_block", "1", "--model_dir", str(runner.ckpt.directory),
                            "--out", str(out)]) == 0
    ecfg = EngineConfig(buckets=(1, 4), decode_mode="scan")
    eng = DecodeEngine.from_export(out, ecfg, log_fn=lambda *_: None, device="cpu")
    live = DecodeEngine(runner.policy.model.state_dict(), runner.policy.cfg, ecfg,
                        log_fn=lambda *_: None, device="cpu")
    assert eng.cfg.obs_dim == 9 and eng.cfg.state_dim == 104
    state, obs, avail = inputs(eng.cfg, 4)
    for a, b in zip(eng.decode(state, obs, avail), live.decode(state, obs, avail)):
        np.testing.assert_array_equal(a, b)


def test_sweep_widening_matches_jax():
    """The sweep of a ``dmomat`` policy (uniform preference weights
    appended) against ``benchmark_dcml.make_sweep_run(n_coef=2)``, a few
    stride-10 steps on Sample_1, env draws replayed."""
    n_steps = 2
    consts = DCMLConsts()
    shape = dict(DMO, n_block=1)
    jcfg, tcfg = configs(shape)
    params = jax_params(jcfg, seed=6)
    policy = TransformerPolicy(tcfg, device="cpu")
    policy.model.load_state_dict(params_from_jax(params))
    bench = ROOT / "data" / "dcml_benchmark"
    data = jax_load_sample(bench, 1)
    jenv = JaxEnv(JaxEnvConfig(preset=True), data_dir=ROOT / "data")
    key = jax.random.key(1)
    ref = benchmark_dcml.make_sweep_run(jenv, JaxPolicy(jcfg), n_steps, 10, n_coef=2)(
        params, key, jnp.asarray(data.master, jnp.float32),
        jnp.asarray(data.worker_prs, jnp.float32), jnp.asarray(data.disable_rates, jnp.int32))
    reset_draws = jax_reset_draws(key[None], consts)
    rngs = jenv.reset(key, 0)[0].rng[None]
    step_draws = []
    for _ in range(n_steps):
        rngs, d = jax_step_draws(rngs, consts)
        step_draws.append(d)
    env = tenv.DCMLEnv(tenv.DCMLEnvConfig(preset=True), device="cpu")
    mine = make_sweep_run(env, policy, n_steps, 10, n_coef=2)(
        tpreset.load_sample(bench, 1), draws=(reset_draws, step_draws))
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5)


@pytest.mark.parametrize("algo", ["momat", "dmomat", "mat_dec"])
def test_mat_family_defaults_to_the_card(tmp_path, algo):
    """Without ``--device`` the entry point trains on ``cuda``, and raises
    where there is none."""
    argv = ["--run_dir", str(tmp_path), "--algorithm_name", algo, "--num_env_steps", "8",
            "--n_rollout_threads", "2", "--episode_length", "4", "--n_embd", "16",
            "--n_block", "1", "--ppo_epoch", "1", "--num_mini_batch", "2"]
    if torch.cuda.is_available():
        train_dcml.main(argv)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_dcml.main(argv)
