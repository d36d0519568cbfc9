"""Shared set-up for the tests that hold the PyTorch port against the JAX
package on the CPU: one small semi-discrete DCML-shaped MAT, its weights on
both sides, numpy inputs from a seed, and the JAX key chain's sampling noise.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.models.decode import serve_decode as jax_serve_decode
from mat_dcml_tpu.models.mat import MATConfig as JaxMATConfig
from mat_dcml_tpu.models.mat import MultiAgentTransformer as JaxMAT
from mat_dcml_tpu_torch.bridge import params_from_jax
from mat_dcml_tpu_torch.models.decode import serve_decode
from mat_dcml_tpu_torch.models.mat import MATConfig, MultiAgentTransformer

# DCML's obs / state / action widths, cut to 11 agents and n_embd 16
SMALL = dict(n_agent=11, obs_dim=7, state_dim=102, action_dim=2, n_block=2,
             n_embd=16, n_head=2, action_type="semi_discrete", semi_index=-1)
TINY = dict(SMALL, n_agent=5, n_embd=8)


def configs(shape=SMALL):
    return JaxMATConfig(**shape), MATConfig(**shape)


def jax_params(jcfg, seed=0):
    """JAX-initialised tree with every leaf redrawn from numpy at O(1)
    scale: the reference init's 0.01-gain heads give logits near 0, which
    would let a wrong port pass a tolerance check."""
    A = jcfg.n_agent
    # only the tree's structure and shapes are read (every leaf is redrawn),
    # so trace the init instead of running it op by op (8 s -> 0.5 s at 8m)
    init = jax.eval_shape(lambda: JaxMAT(jcfg).init(
        jax.random.key(seed),
        jnp.zeros((1, A, jcfg.state_dim)), jnp.zeros((1, A, jcfg.obs_dim)),
        jnp.zeros((1, A, jcfg.action_input_dim)),
    ))
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "kernel":   # (in, out), or (n_agent, in, out) stacked
            arr = rng.normal(size=shape) / np.sqrt(shape[-2])
        elif name == "scale":
            arr = 1.0 + 0.1 * rng.normal(size=shape)
        else:   # bias, log_std
            arr = 0.1 * rng.normal(size=shape)
        return np.asarray(arr, np.float32)

    return jax.tree_util.tree_map_with_path(redraw, init)


def torch_model(tcfg, params):
    model = MultiAgentTransformer(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model.eval()


def inputs(cfg, batch, seed=1):
    rng = np.random.default_rng(seed)
    state = rng.normal(size=(batch, cfg.n_agent, cfg.state_dim)).astype(np.float32)
    obs = rng.normal(size=(batch, cfg.n_agent, cfg.obs_dim)).astype(np.float32)
    avail = (rng.uniform(size=(batch, cfg.n_agent, cfg.action_dim)) > 0.3).astype(np.float32)
    avail[..., 0] = 1.0   # keep one action available
    return state, obs, avail


def replay_noise(key, batch, cfg):
    """The noise JAX's cached decode draws from ``key``: per position
    ``key, k_d, k_c = split(key, 3)``; the categorical draw is
    ``argmax(logits + gumbel(k_d))`` and the Gaussian tail reads
    ``normal(k_c)`` for agents ``>= n_discrete_agents``."""
    A, adim, nd = cfg.n_agent, cfg.action_dim, cfg.n_discrete_agents
    gumbel = np.zeros((batch, A, adim), np.float32)
    tail = np.zeros((A, batch, adim), np.float32)
    for i in range(A):
        key, k_d, k_c = jax.random.split(key, 3)
        gumbel[:, i] = np.asarray(jax.random.gumbel(k_d, (batch, adim), jnp.float32))
        if i >= nd:
            tail[i] = np.asarray(jax.random.normal(k_c, (batch, adim), jnp.float32))
    return gumbel, tail


def replay_family_noise(key, batch, cfg):
    """The noise JAX's decode draws from ``key`` for any action family, in
    the port's shapes (``models/decode.py::noise_shapes``; None where the
    family reads none): per position ``key, k_d, k_c = split(key, 3)``, then
    at JAX's own shapes ``gumbel(k_d, (B, adim))`` for the categorical draws
    (``(B, discrete_dim)`` for ``available_continuous``'s one-hot) and
    ``normal(k_c, (B, adim))`` for the Gaussian parts (``(B, adim -
    discrete_dim)`` for ``available_continuous``)."""
    if cfg.action_type in ("discrete", "semi_discrete"):
        gumbel, tail = replay_noise(key, batch, cfg)
        return gumbel, tail if cfg.action_type == "semi_discrete" else None
    A, adim, dd = cfg.n_agent, cfg.action_dim, cfg.discrete_dim
    avail_cont = cfg.action_type == "available_continuous"
    n_dim = adim - dd if avail_cont else adim
    gumbel = np.zeros((batch, A, dd), np.float32) if avail_cont else None
    tail = np.zeros((A, batch, n_dim), np.float32)
    for i in range(A):
        key, k_d, k_c = jax.random.split(key, 3)
        if avail_cont:
            gumbel[:, i] = np.asarray(jax.random.gumbel(k_d, (batch, dd), jnp.float32))
        tail[i] = np.asarray(jax.random.normal(k_c, (batch, n_dim), jnp.float32))
    return gumbel, tail


def assert_decodes_agree(act, logp, ref_act, ref_logp, ref_logits, nd, atol,
                         margin=1e-5):
    """The port's decode against the reference's, row by row.

    Actions must be equal and log-probs within ``atol``, except that a row
    may diverge from the first position where its actions differ, and only
    if the reference's top-2 logit margin there (``ref_logits (B, A, adim)``,
    noise included, availability applied) is below ``margin``: a near-tie
    that float summation order may break either way.
    """
    act, logp = np.asarray(act)[..., 0], np.asarray(logp)[..., 0]
    ref_act, ref_logp = np.asarray(ref_act)[..., 0], np.asarray(ref_logp)[..., 0]
    for b in range(act.shape[0]):
        diff = np.flatnonzero(act[b, :nd] != ref_act[b, :nd])
        end = act.shape[1] if diff.size == 0 else int(diff[0])
        if diff.size:
            top2 = np.sort(np.asarray(ref_logits)[b, end])[-2:]
            assert top2[1] - top2[0] < margin, (
                f"row {b}: action differs at position {end} with top-2 margin "
                f"{top2[1] - top2[0]:.3g} >= {margin}")
        else:
            np.testing.assert_allclose(act[b, nd:], ref_act[b, nd:], atol=atol)
        np.testing.assert_allclose(logp[b, :end], ref_logp[b, :end], atol=atol)


def reference_logits(jcfg, params, state, obs, avail, act, gumbel):
    """JAX teacher-forced logits under the actions ``act`` (B, A, 1): the
    logits each decode position saw, availability and noise applied, for the
    near-tie check."""
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


DECODE_KEY = 42


def serve_decode_vs_jax(shape, deterministic, batch, mode, atol, margin=1e-5, data=None,
                        params=None, **kw):
    """The port's ``serve_decode(mode=...)`` against JAX's on one seeded
    batch (or ``data = (state, obs, avail)``), the stochastic case fed the
    noise replayed from JAX's key chain: values within ``atol``, actions and
    log-probs by :func:`assert_decodes_agree`.  ``params``: the weights
    (default :func:`jax_params`).  Returns the port's result."""
    jcfg, tcfg = configs(shape)
    params = jax_params(jcfg) if params is None else params
    state, obs, avail = inputs(jcfg, batch) if data is None else data
    v_ref, ref = jax_serve_decode(
        jcfg, params, jax.random.key(DECODE_KEY), state, obs, avail,
        deterministic=deterministic, mode=mode, **kw,
    )
    gumbel = tail = None
    if not deterministic:
        gumbel, tail = replay_noise(jax.random.key(DECODE_KEY), batch, jcfg)
    model = torch_model(tcfg, params)
    v, res = serve_decode(
        model, state, obs, avail, deterministic=deterministic, mode=mode, device="cpu",
        gumbel=None if gumbel is None else torch.from_numpy(gumbel),
        tail_noise=None if tail is None else torch.from_numpy(tail), **kw,
    )
    assert res.action.shape == ref.action.shape and res.log_prob.shape == ref.log_prob.shape
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=atol)
    logits = reference_logits(jcfg, params, state, obs, avail, ref.action, gumbel)
    assert_decodes_agree(res.action.numpy(), res.log_prob.numpy(), ref.action,
                         ref.log_prob, logits, jcfg.n_discrete_agents, atol, margin=margin)
    return res


def torch_in(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ------------------------------------------------------------ DCML env draws

def _jax_reset_draws_one(key, consts):
    """The draws of ``mat_dcml_tpu`` ``DCMLEnv.reset`` from ``key``
    (``env.py:147-179``), and the key the reset leaves in its state."""
    W, P = consts.worker_number_max, consts.local_workload_period
    key, k_dr, k_at, k_master, k_prs, k_trace, k_ava, _, _ = jax.random.split(key, 9)
    k_r, k_c, k_pr = jax.random.split(k_master, 3)
    draws = dict(
        disable_rate=jax.random.randint(k_dr, (), 1, 81, jnp.int32),
        arrive_time=jax.random.randint(k_at, (), 0, P, jnp.int32),
        r_rows=jax.random.randint(k_r, (), consts.r_min, round(consts.r_max * 1.1) + 1),
        c_cols=jax.random.randint(k_c, (), consts.c_min, round(consts.c_max * 1.1) + 1),
        master_pr=jax.random.uniform(k_pr, (), minval=consts.pr_min, maxval=consts.pr_max),
        worker_prs=jax.random.uniform(k_prs, (W,), minval=consts.pr_min, maxval=consts.pr_max),
        trace_noise=jax.random.uniform(k_trace, (W, P), minval=0.8, maxval=1.2),
        avail_u=jax.random.uniform(k_ava, (W,)),
    )
    return key, draws


def _jax_step_draws_one(rng, consts, fixed_upload_retry=False):
    """The draws of ``DCMLEnv.step`` from the state's key (``env.py:258``,
    ``:352``, ``:568``), then its auto-reset's; returns the next state's key.
    Under ``fixed_upload_retry`` the one upload-retry uniform (``k_ul``) goes
    where the port reads it, ``nb_u[..., 0]``."""
    from mat_dcml_tpu.envs.dcml.env import _NB_DRAW_CAP, _uniform_open

    W = consts.worker_number_max
    _, k_proc, k_done, k_reset = jax.random.split(rng, 4)
    k_dl, k_ul = jax.random.split(k_proc)
    k_g, k_t = jax.random.split(k_ul)
    nxt, reset = _jax_reset_draws_one(k_reset, consts)
    nb_u = _uniform_open(k_g, (W, _NB_DRAW_CAP))
    if fixed_upload_retry:
        nb_u = nb_u.at[:, 0].set(_uniform_open(k_ul, (W,)))
    draws = dict(
        geom_u=_uniform_open(k_dl, (W,)),
        nb_u=nb_u,
        nb_normal=jax.random.normal(k_t, (W,)),
        done_u=jax.random.uniform(k_done, ()),
        reset=reset,
    )
    return nxt, draws


def _to_reset_draws(d):
    from mat_dcml_tpu_torch.envs.dcml.env import ResetDraws

    t = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    for k in ("disable_rate", "arrive_time", "r_rows", "c_cols"):
        t[k] = t[k].long()
    return ResetDraws(**t)


def jax_reset_draws(keys, consts):
    """Port ``ResetDraws`` replayed from the per-env JAX keys ``(E,)``."""
    _, d = jax.vmap(lambda k: _jax_reset_draws_one(k, consts))(keys)
    return _to_reset_draws(d)


def jax_step_draws(rngs, consts, fixed_upload_retry=False):
    """``(next keys, port StepDraws)`` replayed from the env states' keys."""
    from mat_dcml_tpu_torch.envs.dcml.env import StepDraws

    nxt, d = jax.vmap(lambda k: _jax_step_draws_one(k, consts, fixed_upload_retry))(rngs)
    reset = _to_reset_draws(d.pop("reset"))
    return nxt, StepDraws(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()},
                          reset=reset)


# ------------------------------------------------------------- saved states

def state_leaves(tree, prefix=""):
    """``{path: leaf}`` of a nested training state (dicts, lists, tuples,
    NamedTuples as dicts)."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(state_leaves(v, f"{prefix}/{k}"))
    return out


def assert_states_equal(a, b):
    """Two training states equal bit for bit: the same paths, every tensor
    of the same dtype, shape and values, every other leaf equal."""
    la, lb = state_leaves(a), state_leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        x, y = la[k], lb[k]
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype and x.shape == y.shape, k
            assert torch.equal(x.cpu(), y.cpu()), k
        else:
            assert x == y, k


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch intra-op thread for a module's tests, restored after: the
    suite runs on several workers at once, and torch's OpenMP threads
    spin-wait when the cores are oversubscribed (six small trainings at
    once take ~90 times as long as one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ PPO updates

def jax_trajectory(traj):
    """The JAX ``Trajectory`` of a port trajectory (numpy leaves)."""
    from mat_dcml_tpu.training.rollout import Trajectory as JaxTrajectory

    f = {k: np.asarray(getattr(traj, k).numpy()) for k in (
        "share_obs", "obs", "available_actions", "actions", "log_probs", "values", "rewards",
        "masks", "active_masks", "delays", "payments", "dones")}
    coefs = traj.objective_coefficients
    return JaxTrajectory(**f, objective_coefficients=None if coefs is None else coefs.numpy())


def jax_rollout_state(st):
    """What the JAX update reads of a port rollout state (its bootstrap
    inputs), as a JAX ``RolloutState``."""
    from mat_dcml_tpu.training.rollout import RolloutState as JaxRolloutState

    return JaxRolloutState(env_states=None, obs=st.obs.numpy(), share_obs=st.share_obs.numpy(),
                           available_actions=st.available_actions.numpy(),
                           mask=st.mask.numpy(), rng=None)


def updates_vs_jax(jcfg, params, policy, traj, rollout_state, ppo_kw, n_updates=1,
                   total_updates=1, key=7):
    """``n_updates`` PPO updates of the same trajectory on both sides from
    the same weights (``policy`` holds them, bridged), the JAX epochs'
    permutations replayed.  ``traj`` and ``rollout_state`` are the port's
    (``traj.objective_coefficients`` carried to JAX).  Returns ``(jax state,
    jax metrics, port state, port metrics)`` after the last update."""
    from mat_dcml_tpu.models.policy import TransformerPolicy as JaxPolicy
    from mat_dcml_tpu.training.ppo import MATTrainer as JaxTrainer
    from mat_dcml_tpu.training.ppo import PPOConfig as JaxPPOConfig
    from mat_dcml_tpu_torch.training.ppo import MATTrainer, PPOConfig

    jtrainer = JaxTrainer(JaxPolicy(jcfg, decode_mode="cached"),
                          JaxPPOConfig(update_stream_chunks=0, target_stream_chunk=0, **ppo_kw),
                          total_updates=total_updates)
    trainer = MATTrainer(policy, PPOConfig(**ppo_kw), total_updates=total_updates)
    train = jax.jit(jtrainer.train)
    jtraj, jrs = jax_trajectory(traj), jax_rollout_state(rollout_state)
    jstate, state = jtrainer.init_state(params), trainer.init_state()
    n_rows = traj.rewards.shape[0] * traj.rewards.shape[1]
    for u in range(n_updates):
        k = jax.random.key(key + u)
        jstate, jmet = train(jstate, jtraj, jrs, k)
        perms = torch.from_numpy(np.stack([
            np.asarray(jax.random.permutation(ke, n_rows))
            for ke in jax.random.split(k, trainer.cfg.ppo_epoch)])).long()
        state, met = trainer.train(state, traj, rollout_state, perms=perms)
    return jstate, jmet, state, met


def param_diff(jstate, policy, lr, steps):
    """Max |weight difference| of the port's weights against the JAX
    state's, over the weights whose exact gradient is not 0; the key
    projections' biases (gradient 0 but for rounding noise, which Adam
    scales up to steps of lr; two JAX runs that only sum in another order
    differ there by 1.7 lr) are held to 2 lr a step."""
    from mat_dcml_tpu_torch.bridge import params_to_jax

    mine = jax.tree_util.tree_leaves_with_path(params_to_jax(policy.model.state_dict())["params"])
    ref = jax.tree_util.tree_leaves(jax.device_get(jstate.params)["params"])
    assert len(mine) == len(ref)
    worst = 0.0
    for (path, a), b in zip(mine, ref):
        assert a.shape == np.shape(b), jax.tree_util.keystr(path)
        d = float(np.abs(a - np.asarray(b)).max())
        if "key_p" in jax.tree_util.keystr(path) and path[-1].key == "bias":
            assert d <= 2 * lr * steps, jax.tree_util.keystr(path)
        else:
            worst = max(worst, d)
    return worst


def compare_update_metrics(jmet, met, rtol=1e-5, ratio_atol=0.0):
    """The update's metrics against JAX's: rtol with atol 1e-6 (the policy
    loss cancels to near 0), ``update_ratio`` to rtol 1e-4 (a quotient of
    small steps) and ``ratio_atol``."""
    for name in ("value_loss", "policy_loss", "dist_entropy", "grad_norm", "ratio",
                 "param_norm", "nonfinite_grads"):
        np.testing.assert_allclose(float(getattr(met, name)), float(getattr(jmet, name)),
                                   rtol=rtol, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(met.update_ratio), float(jmet.update_ratio), rtol=1e-4,
                               atol=ratio_atol)


# ----------------------------------------------------------- SMAC-lite draws

def _smac_spawn_one(key, n_agents, n_enemies):
    """``SMACLiteEnv._spawn``'s draws from ``key`` (``smaclite.py:173-179``):
    ``k_a, k_e, key = split(key, 3)``, the jitters exactly as JAX's
    ``uniform`` makes them, and the key the episode keeps."""
    k_a, k_e, key = jax.random.split(key, 3)
    return key, (jax.random.uniform(k_a, (n_agents, 2), minval=-0.5, maxval=0.5),
                 jax.random.uniform(k_e, (n_enemies, 2), minval=-0.5, maxval=0.5))


@functools.lru_cache(maxsize=None)
def _smac_spawn(n_agents, n_enemies):
    return jax.jit(jax.vmap(lambda k: _smac_spawn_one(k, n_agents, n_enemies)))


@functools.lru_cache(maxsize=None)
def _smac_step_keys(n_agents, n_enemies):
    def one(rng):
        key_next, k_spawn = jax.random.split(rng)
        return key_next, _smac_spawn_one(k_spawn, n_agents, n_enemies)[1]
    return jax.jit(jax.vmap(one))


def _to_smac_reset(ja, je):
    from mat_dcml_tpu_torch.envs.smac.smaclite import ResetDraws

    return ResetDraws(torch.from_numpy(np.array(ja)), torch.from_numpy(np.array(je)))


def smac_reset_draws(keys, n_agents, n_enemies):
    """``(episode keys, port ResetDraws)`` of ``reset`` from the per-env JAX
    keys ``(E,)``."""
    nxt, (ja, je) = _smac_spawn(n_agents, n_enemies)(keys)
    return nxt, _to_smac_reset(ja, je)


def smac_step_draws(rngs, n_agents, n_enemies):
    """``(next episode keys, port StepDraws)`` of one ``step`` from the env
    states' keys: every step splits ``key_next, k_spawn`` and spawns from
    ``k_spawn`` (``smaclite.py:414-415``); where the episode ends the state's
    key becomes ``key_next``, else it stays (the caller selects)."""
    from mat_dcml_tpu_torch.envs.smac.smaclite import StepDraws

    key_next, (ja, je) = _smac_step_keys(n_agents, n_enemies)(rngs)
    return key_next, StepDraws(_to_smac_reset(ja, je))


def smac_next_rngs(rngs, key_next, done):
    """The env states' keys after a step: ``key_next`` where ``done (E,)``."""
    d = jnp.asarray(np.asarray(done))
    return jax.random.wrap_key_data(jnp.where(d[:, None], jax.random.key_data(key_next),
                                              jax.random.key_data(rngs)))


@functools.lru_cache(maxsize=None)
def _permutations(n):
    return jax.jit(jax.vmap(lambda k: jax.random.permutation(k, n)))


def jax_permutations(keys, n):
    """``jax.random.permutation(k, n)`` for each key ``(E,)``, as an int64
    tensor ``(E, n)``: the permutation wrapper's draw."""
    return torch.from_numpy(np.array(_permutations(n)(keys))).long()
