"""The actor-critic family's collectors and updates in the PyTorch port
against the JAX package, on the CPU.

The small DCML env (8 workers and the master: 9 agents, obs 7, state 10),
E = 2 envs, T = 4 steps, hidden 16, 2 epochs x 2 minibatches, the JAX
weights (redrawn at O(1) scale) bridged into the port.

- ``collect`` (the shared collector of ``ppo`` and ``mappo``, IPPO's and
  HAPPO's stacked one): the JAX collector's policy noise (``split(key)`` a
  step; ``split(key, A)`` an agent when stacked; ``k_disc, k_cont`` for the
  categorical and Gaussian parts) and env draws are replayed into the port.
  Actions equal (the master's ratio atol 1e-5), log-probs atol 1e-5, env
  outputs as in ``tests/test_torch_env.py``; values atol 1e-5, 1e-4 on a
  disabled worker's rows (its near-constant obs row makes the first
  LayerNorm divide by a standard deviation near 0.03: ROADMAP.md queue 3).
- ``train`` (``ppo``, ``mappo`` (also with PopArt, which rescales the
  critic's head each minibatch, and with every loss and optimiser switch
  off its default), ``ippo``, ``happo``, ``hatrpo``): both
  sides update from the same trajectory (JAX's, converted), the same
  weights and the same replayed permutations and agent order.  Weights
  within 0.01 lr x Adam steps (Adam divides each gradient by its own
  running size, so a near-0 gradient can move an entry by up to lr a step
  on one side and less on the other); metrics rtol 1e-5 with atol 1e-6,
  HAPPO's ``factor_mean`` included; the policy loss, a mean of normalised
  advantages over a minibatch that cancels to ~0, with atol its rows times
  f32's epsilon (the most its summation order can move it).  HATRPO
  has no Adam on the actor: its step is the conjugate-gradient solve of
  ten Fisher-vector products, which amplifies summation-order rounding, so
  the weights and ``kl`` are held to rtol 1e-4 (atol 1e-6) and the
  line search's accepted fraction must be the same.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.config import RunConfig as JaxRunConfig
from mat_dcml_tpu.envs.dcml.constants import DCMLConsts as JaxConsts
from mat_dcml_tpu.envs.dcml.env import DCMLEnv as JaxEnv
from mat_dcml_tpu.envs.dcml.env import DCMLEnvConfig as JaxEnvConfig
from mat_dcml_tpu.training.mappo import Bootstrap as JaxBootstrap
from mat_dcml_tpu.training.mappo import MAPPOTrainer as JaxMAPPOTrainer
from mat_dcml_tpu.training.ppo import PPOConfig as JaxPPOConfig
from mat_dcml_tpu.training.runner import build_dcml_components
from mat_dcml_tpu_torch.bridge import ac_params_from_jax, ac_params_to_jax
from mat_dcml_tpu_torch.config import RunConfig
from mat_dcml_tpu_torch.envs.dcml import env as tenv
from mat_dcml_tpu_torch.envs.dcml.constants import DCMLConsts
from mat_dcml_tpu_torch.models.act_layer import ACNoise
from mat_dcml_tpu_torch.training.ac_rollout import ACCollectDraws, ACTrajectory
from mat_dcml_tpu_torch.training.mappo import Bootstrap, MAPPOTrainer
from mat_dcml_tpu_torch.training.ppo import PPOConfig
from mat_dcml_tpu_torch.training.runner import build_ac_components
from tests.torch_port_helpers import (
    jax_reset_draws,
    jax_step_draws,
    one_torch_thread,  # noqa: F401
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
W, E, T, HIDDEN = 8, 2, 4, 16
A = W + 1
LR = 1e-3
ATOL = 1e-5
VALUE_ATOL = 1e-4
PPO_KW = dict(lr=LR, ppo_epoch=2, num_mini_batch=2, clip_param=0.2, entropy_coef=0.01,
              value_loss_coef=1.0, max_grad_norm=10.0, gamma=0.99, gae_lambda=0.95)
# the collector each algorithm's collect stands for
COLLECTS = {"ppo": "ppo", "mappo": "mappo", "mappo_popart": "mappo",
            "mappo_switches": "mappo", "ippo": "ippo", "happo": "happo", "hatrpo": "happo"}
# MAPPOConfig settings no runner sets, on both sides: PopArt, and every loss
# and optimiser switch off its default
VARIANTS = {"mappo_popart": dict(use_popart=True),
            "mappo_switches": dict(use_clipped_value_loss=False, use_huber_loss=False,
                                   use_valuenorm=False, use_value_active_masks=False,
                                   use_policy_active_masks=False, use_max_grad_norm=False,
                                   weight_decay=1e-4)}


def consts():
    return JaxConsts(worker_number_max=W, sob_dim=W + 2), DCMLConsts(worker_number_max=W,
                                                                      sob_dim=W + 2)


def jax_env():
    return JaxEnv(JaxEnvConfig(consts=consts()[0]), data_dir=ROOT / "data")


def torch_env():
    return tenv.DCMLEnv(tenv.DCMLEnvConfig(consts=consts()[1]), device="cpu")


def redraw(params, seed):
    """Every leaf redrawn from numpy at O(1) scale: the reference init's
    0.01-gain heads give logits near 0, which would let a wrong port pass."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "kernel":
            arr = rng.normal(size=shape) / np.sqrt(shape[-2])
        elif name == "scale":
            arr = 1.0 + 0.1 * rng.normal(size=shape)
        else:   # bias, log_std
            arr = 0.1 * rng.normal(size=shape)
        return np.asarray(arr, np.float32)

    return jax.tree_util.tree_map_with_path(one, params)


def build(algo, seed=0):
    """The JAX ``(policy, trainer, collector, params)`` and the port's
    ``(policy, trainer, collector)`` on the same weights; a ``VARIANTS``
    name is ``mappo`` with those ``MAPPOConfig`` settings on both sides."""
    variant = VARIANTS.get(algo)
    algo = "mappo" if variant else algo
    jrun = JaxRunConfig(algorithm_name=algo, n_rollout_threads=E, episode_length=T,
                        n_embd=HIDDEN)
    jpol, jtr, jcol, _ = build_dcml_components(jrun, JaxPPOConfig(**PPO_KW), jax_env())
    init = jtr.init_params if hasattr(jtr, "init_params") else jpol.init_params
    params = redraw(jax.eval_shape(init, jax.random.key(0)), seed)
    run = RunConfig(algorithm_name=algo, n_rollout_threads=E, episode_length=T, n_embd=HIDDEN,
                    device="cpu")
    pol, tr, col = build_ac_components(run, PPOConfig(**PPO_KW), torch_env(), device="cpu")
    pol.load_tree(ac_params_from_jax(params))
    if variant:
        jtr = JaxMAPPOTrainer(jpol, dataclasses.replace(jtr.cfg, **variant))
        tr = MAPPOTrainer(pol, dataclasses.replace(tr.cfg, **variant))
    return (jpol, jtr, jcol, params), (pol, tr, col)


def replay_noise(k_act, algo, jcol):
    """The port's noise of one step from the step's action key."""
    space = jcol.policy.space
    if algo == "ppo":                         # the joint head: (E, n_sub, n), (E, 1)
        k_d, k_c = jax.random.split(k_act)
        g = jax.random.gumbel(k_d, (E, space.n_sub, space.n), jnp.float32)
        return ACNoise(torch.from_numpy(np.array(g))[None],
                       torch.from_numpy(np.array(jax.random.normal(k_c, (E, 1))))[None])
    if algo == "mappo":                       # MixedRole over the E * A rows
        k_d, k_c = jax.random.split(k_act)
        g = jax.random.gumbel(k_d, (E * A, space.n), jnp.float32)
        return ACNoise(torch.from_numpy(np.array(g))[None],
                       torch.from_numpy(np.array(jax.random.normal(k_c, (E * A, 1))))[None])
    gs, ns = [], []                           # one key an agent
    for k in jax.random.split(k_act, A):
        k_d, k_c = jax.random.split(k)
        gs.append(np.array(jax.random.gumbel(k_d, (E, space.n), jnp.float32)))
        ns.append(np.array(jax.random.normal(k_c, (E, 1))))
    return ACNoise(torch.from_numpy(np.stack(gs)), torch.from_numpy(np.stack(ns)))


@pytest.fixture(scope="module")
def collected():
    """For each collector: the JAX collect and the port's replay of it."""
    _, tc = consts()
    out = {}
    for seed, algo in enumerate(("ppo", "mappo", "ippo", "happo")):
        (jpol, jtr, jcol, params), (pol, tr, col) = build(algo, seed=seed)
        key = jax.random.key(11)
        rs0 = jcol.init_state(key, E)
        rs1, traj = jax.jit(jcol.collect)(params, rs0)
        _, k_reset = jax.random.split(key)
        reset = jax_reset_draws(jax.random.split(k_reset, E), tc)
        noise, steps = [], []
        rng, env_rng = rs0.rng, rs0.env_states.rng
        for _ in range(T):
            rng, k_act = jax.random.split(rng)
            noise.append(replay_noise(k_act, algo, jcol))
            env_rng, d = jax_step_draws(env_rng, tc)
            steps.append(d)
        env_draws = tenv.StepDraws(
            *(torch.stack(xs) for xs in zip(*(s[:4] for s in steps))),
            reset=tenv.ResetDraws(*(torch.stack(xs) for xs in zip(*(s.reset for s in steps)))))
        draws = ACCollectDraws(env_draws, ACNoise(*(torch.stack(xs) for xs in zip(*noise))))
        st0 = col.init_state(E, draws=reset)
        st1, ttraj = col.collect(st0, draws=draws)
        out[algo] = dict(seed=seed, rs1=rs1, traj=traj, st1=st1, ttraj=ttraj)
    return out


@pytest.mark.parametrize("algo", ["ppo", "mappo", "ippo", "happo"])
def test_collect_matches_jax(collected, algo):
    c = collected[algo]
    traj, ttraj = c["traj"], c["ttraj"]
    act, ref = ttraj.actions.numpy(), np.asarray(traj.actions)
    if algo == "ppo":           # the joint action: w bits, then the ratio
        np.testing.assert_array_equal(act[..., :W], ref[..., :W])
    else:                       # worker rows' indices, the master's ratio
        np.testing.assert_array_equal(act[:, :, :W], ref[:, :, :W])
    np.testing.assert_allclose(act, ref, atol=ATOL)
    for name in ("log_probs", "obs", "share_obs"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(), np.asarray(getattr(traj, name)),
                                   atol=ATOL, err_msg=name)
    values, ref_v = ttraj.values.numpy(), np.asarray(traj.values)
    if algo == "ppo":
        np.testing.assert_allclose(values, ref_v, atol=ATOL)
    else:   # a disabled worker's row (availability [1, 0]) may differ by 1e-4
        disabled = np.asarray(traj.available_actions)[..., 1] == 0
        np.testing.assert_allclose(values[~disabled], ref_v[~disabled], atol=ATOL)
        np.testing.assert_allclose(values[disabled], ref_v[disabled], atol=VALUE_ATOL)
    for name in ("available_actions", "masks", "active_masks", "dones", "actor_h", "critic_h"):
        np.testing.assert_array_equal(getattr(ttraj, name).numpy(),
                                      np.asarray(getattr(traj, name)), err_msg=name)
    for name in ("rewards", "delays", "payments"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(), np.asarray(getattr(traj, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for k, v in ttraj.chunk_stats.items():
        np.testing.assert_allclose(float(v), float(traj.chunk_stats[k]), rtol=1e-5, err_msg=k)
    st1, rs1 = c["st1"], c["rs1"]
    np.testing.assert_allclose(st1.episode_acc.numpy(), np.asarray(rs1.episode_acc), rtol=1e-5)
    np.testing.assert_array_equal(st1.mask.numpy(), np.asarray(rs1.mask))


def _jax_perms(algo, key, n_rows, trainer):
    """The row permutations (and HAPPO's agent order) the JAX update draws
    from ``key``, in the port's layout."""
    n_ep = PPO_KW["ppo_epoch"]
    perm = lambda k: np.asarray(jax.random.permutation(k, n_rows))   # noqa: E731
    if algo == "ppo" or algo.startswith("mappo"):
        return None, np.stack([perm(k) for k in jax.random.split(key, n_ep)])[None]
    if algo == "ippo":
        return None, np.stack([[perm(k) for k in jax.random.split(ka, n_ep)]
                               for ka in jax.random.split(key, A)])
    k_perm, k_train = jax.random.split(key)
    order = np.asarray(jax.random.permutation(k_perm, A))
    keys = jax.random.split(k_train, A)
    if algo == "happo":
        return order, np.stack([[perm(k) for k in jax.random.split(ka, n_ep)] for ka in keys])
    return order, np.stack([[perm(ka)] for ka in keys])


def _to_torch_traj(traj):
    f = {k: torch.from_numpy(np.array(getattr(traj, k))) for k in ACTrajectory._fields
         if k not in ("chunk_stats",)}
    return ACTrajectory(**f, chunk_stats={})


@pytest.mark.parametrize("algo", ["ppo", "mappo", "mappo_popart", "mappo_switches", "ippo",
                                  "happo", "hatrpo"])
def test_update_matches_jax(collected, algo):
    c = collected[COLLECTS[algo]]
    # the weights that collected the chunk, so the ratios start at 1
    (jpol, jtr, jcol, params), (pol, tr, col) = build(algo, seed=c["seed"])
    traj, rs1 = c["traj"], c["rs1"]
    use_local = getattr(jcol, "use_local_value", False)
    cent = rs1.obs if use_local else rs1.share_obs
    key = jax.random.key(5)
    jstate = jtr.init_state(params)
    jstate, jmet = jax.jit(jtr.train)(jstate, traj,
                                      JaxBootstrap(cent, rs1.critic_h, rs1.mask), key)
    n_rows = T * E * (A if algo.startswith("mappo") else 1)
    order, perms = _jax_perms(algo, key, n_rows, tr)
    kw = dict(perms=torch.from_numpy(perms).long())
    if order is not None:
        kw["order"] = torch.tensor(order).long()
    boot = Bootstrap(*(torch.from_numpy(np.array(x)) for x in (cent, rs1.critic_h, rs1.mask)))
    state, met = tr.train(tr.init_state(), _to_torch_traj(traj), boot, **kw)

    stacked = algo in ("ippo", "happo", "hatrpo")
    mine = jax.tree_util.tree_leaves_with_path(ac_params_to_jax(pol.tree(), stacked=stacked))
    ref = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(jstate.params)))
    moved = max(float(np.abs(np.asarray(ref[p]) - b).max())
                for p, b in jax.tree_util.tree_leaves_with_path(params))
    assert moved > 0.5 * LR                               # the update did move the weights
    # Adam steps an agent: HATRPO's critic takes one pass, no epochs
    steps = PPO_KW["num_mini_batch"] * (1 if algo == "hatrpo" else PPO_KW["ppo_epoch"])
    for path, a in mine:
        b = np.asarray(ref[path])
        if algo == "hatrpo" and "actor" in jax.tree_util.keystr(path):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6,
                                       err_msg=jax.tree_util.keystr(path))
        else:
            assert float(np.abs(a - b).max()) <= 0.01 * LR * steps, jax.tree_util.keystr(path)
    # metrics: (A,) for IPPO, scalars otherwise
    for name in met._fields:
        got, want = getattr(met, name).numpy(), np.asarray(getattr(jmet, name))
        if name == "update_ratio":    # a quotient of small steps
            np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=name)
        elif name == "kl":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7, err_msg=name)
        elif name == "policy_loss":   # a mean of normalised advantages that cancels to ~0
            atol = n_rows // PPO_KW["num_mini_batch"] * float(np.finfo(np.float32).eps)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
    if algo == "hatrpo":
        assert 0 < float(met.accepted) and float(met.accepted) == float(jmet.accepted)
    vn = jstate.value_norm
    for a, b in zip(state.value_norm, (vn.running_mean, vn.running_mean_sq, vn.debiasing_term)):
        np.testing.assert_allclose(a.numpy().reshape(np.shape(b)), np.asarray(b), rtol=1e-5)
    assert state.update_step == 1
