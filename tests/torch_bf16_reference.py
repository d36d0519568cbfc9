"""The JAX references of ``tests/test_torch_bf16.py``, computed in a process of
their own.

XLA on the CPU keeps f32 between the ops of a fused bf16 computation
(``--xla_allow_excess_precision``, on by default), so under ``jax.jit`` it
skips roundings that the JAX package's code asks for: the ``astype(bf16)``
in ``pallas_decode.py::_mm``, each op of ``jax.nn.gelu`` on a bf16 array.
About a quarter of the outputs of such a fusion then move by a bf16 ulp (the
Pallas kernels' interpret mode is compiled by XLA too).  The TPU kernel and
the port round where the code says, so the references are computed here in a
process started with that flag off: JAX's XLA and Pallas paths then compute
what their code says.

    XLA_FLAGS=--xla_allow_excess_precision=false python -m tests.torch_bf16_reference \
        OUT.npz [SECTION ...]

The sections (``SECTIONS``; all by default) can run in processes of their own
at once.

Shapes, seeds and inputs are this module's, and the test rebuilds the inputs
from them; everything the port needs to replay (noise, the trajectory, the
permutations) is saved beside the results.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np

from tests.torch_port_helpers import configs, inputs, jax_params, replay_noise

EXCESS_PRECISION_OFF = "--xla_allow_excess_precision=false"
B = 4
DECODE_KEY = 42
# DCML's obs / state / action widths, 6 agents, n_embd 32, 2 blocks, 2 heads
SEMI = dict(n_agent=6, obs_dim=7, state_dim=102, action_dim=2, n_block=2, n_embd=32, n_head=2,
            action_type="semi_discrete", semi_index=-1, dtype="bfloat16")
DISC = dict(SEMI, action_dim=3, action_type="discrete")
FAMILIES = {"semi_discrete": SEMI, "discrete": DISC}
AR = dict(SEMI, n_agent=5, n_embd=16)               # interpret mode is slow: smaller
STEP = dict(SEMI, n_agent=4, n_embd=16, action_dim=8, action_type="continuous")
STEP_POSITION = 2
UPDATE = dict(T=4, E=4, ppo_epoch=2, num_mini_batch=2, key=7)


def shifted(cfg, seed):
    """Teacher-forcing feeds: the start token, then random actions' one-hots."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, cfg.action_dim, size=(B, cfg.n_agent))
    sh = np.zeros((B, cfg.n_agent, cfg.action_input_dim), np.float32)
    sh[:, 0, 0] = 1.0
    for i in range(1, cfg.n_agent):
        sh[np.arange(B), i, 1 + idx[:, i - 1]] = 1.0
    return sh


def actions(cfg, rng, batch):
    """Random actions of the family: bits / indices, the tail a Gaussian."""
    act = rng.integers(0, cfg.action_dim, size=(batch, cfg.n_agent, 1)).astype(np.float32)
    if cfg.action_type == "semi_discrete":
        act[:, -1, 0] = rng.normal(size=batch)
    return act


def bf16_values(x):
    """``x`` rounded to bf16, as f32."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def step_inputs(cfg):
    """The decode step's input, rep and position-major caches, bf16 values."""
    rng = np.random.default_rng(6)
    return (bf16_values(rng.normal(size=(B, cfg.action_input_dim))),
            bf16_values(rng.normal(size=(B, cfg.n_embd))),
            bf16_values(rng.normal(size=(4 * cfg.n_block, cfg.n_agent, B, cfg.n_embd))))


def scores(jcfg, params, state, obs, avail, act, gumbel):
    """The logits each decode position saw (teacher-forced under the decode's
    actions), availability and noise applied, for the near-tie check."""
    from mat_dcml_tpu.models.mat import MultiAgentTransformer as JaxMAT

    jm = JaxMAT(jcfg)
    _, rep = jm.apply(params, state, obs, method="encode")
    n, A = act.shape[:2]
    sh = np.zeros((n, A, jcfg.action_input_dim), np.float32)
    sh[:, 0, 0] = 1.0
    idx = act[:, :-1, 0].astype(int).clip(0, jcfg.action_dim - 1)
    for i in range(1, A):
        sh[np.arange(n), i, 1 + idx[:, i - 1]] = 1.0
    logits = np.asarray(jm.apply(params, sh, rep, obs, method="decode_full"))
    logits = np.where(avail == 0, -1e10, logits)
    return logits if gumbel is None else logits + gumbel


def _families(out):
    from mat_dcml_tpu.models.decode import serve_decode
    from mat_dcml_tpu.models.mat import MultiAgentTransformer as JaxMAT
    from mat_dcml_tpu.models.policy import TransformerPolicy as JaxPolicy

    for fam, shape in FAMILIES.items():
        jcfg, _ = configs(shape)
        params = jax_params(jcfg)
        state, obs, _ = inputs(jcfg, B)
        v, rep, logits = JaxMAT(jcfg).apply(params, state, obs, shifted(jcfg, 2))
        out[f"{fam}/values"] = np.asarray(v)
        out[f"{fam}/rep"] = np.asarray(rep, np.float32)
        out[f"{fam}/logits"] = np.asarray(logits)
        state, obs, avail = inputs(jcfg, B, seed=3)
        act = actions(jcfg, np.random.default_rng(4), B)
        for name, x in zip(("values", "log_probs", "entropy"),
                           JaxPolicy(jcfg).evaluate_actions(params, state, obs, act, avail)):
            out[f"{fam}/evaluate/{name}"] = np.asarray(x)
        state, obs, avail = inputs(jcfg, B, seed=5)
        key = jax.random.key(DECODE_KEY)
        v, res = serve_decode(jcfg, params, key, state, obs, avail, deterministic=False,
                              mode="cached")
        gumbel, tail = replay_noise(key, B, jcfg)
        tag = f"{fam}/decode"
        out[f"{tag}/gumbel"], out[f"{tag}/tail"] = gumbel, tail
        out[f"{tag}/values"] = np.asarray(v)
        out[f"{tag}/action"] = np.asarray(res.action)
        out[f"{tag}/log_prob"] = np.asarray(res.log_prob)
        out[f"{tag}/scores"] = scores(jcfg, params, state, obs, avail, np.asarray(res.action),
                                      gumbel)


def _kernels(out):
    from mat_dcml_tpu.models.mat import MultiAgentTransformer as JaxMAT
    from mat_dcml_tpu.ops.pallas_decode import fused_ar_decode, fused_decode_step
    from mat_dcml_tpu.ops.pallas_decode import pack_ar_decode_weights, pack_decode_weights

    jcfg, _ = configs(AR)
    params = jax_params(jcfg)
    A, adim, nd = jcfg.n_agent, jcfg.action_dim, jcfg.n_discrete_agents
    state, obs, avail = inputs(jcfg, B)
    _, rep = JaxMAT(jcfg).apply(params, state, obs, method="encode")
    rng = np.random.default_rng(3)
    gumbel = rng.gumbel(size=(B, A, adim)).astype(np.float32)
    normal = rng.normal(size=(B, A - nd, adim)).astype(np.float32)
    jw, _ = pack_ar_decode_weights(params, jcfg, JaxMAT(jcfg).apply(params, method="action_std"))
    lanes = jw.embed_act.shape[0]

    def pad(x):
        return jnp.pad(x, ((0, 0), (0, 0), (0, lanes - adim)))

    act, logp = fused_ar_decode(jw, rep, pad(gumbel), pad(normal), pad(avail),
                                n_head=jcfg.n_head, adim=adim, nd=nd, interpret=True)
    out.update({"ar/rep": np.asarray(rep, np.float32), "ar/gumbel": gumbel, "ar/normal": normal,
                "ar/avail": avail, "ar/action": np.asarray(act), "ar/log_prob": np.asarray(logp)})
    jcfg, _ = configs(STEP)
    params = jax_params(jcfg)
    x_in, rep, caches = step_inputs(jcfg)
    jw, adim = pack_decode_weights(params, jcfg)
    logits, new = fused_decode_step(
        jw, jnp.asarray(x_in, jnp.bfloat16), jnp.asarray(rep, jnp.bfloat16),
        [jnp.asarray(c, jnp.bfloat16) for c in caches], jnp.int32(STEP_POSITION),
        n_head=jcfg.n_head, adim=adim, interpret=True)
    out["step/logits"] = np.asarray(logits)
    out["step/caches"] = np.stack([np.asarray(c, np.float32) for c in new])


def _engine(out):
    from mat_dcml_tpu.models.decode import serve_decode
    from mat_dcml_tpu.serving.engine import DecodeEngine, EngineConfig

    jcfg, _ = configs(dict(SEMI, dtype="float32"))
    params = jax_params(jcfg, seed=7)
    eng = DecodeEngine(params, jcfg, EngineConfig(buckets=(B,), serve_dtype="bf16",
                                                  decode_mode="cached"), log_fn=lambda *_: None)
    cast = jax.device_get(eng._params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(cast):
        out["engine/bf16/" + "/".join(str(p.key) for p in path)] = np.asarray(
            leaf.dtype == jnp.bfloat16)
    state, obs, avail = inputs(jcfg, B, seed=8)
    _, res = serve_decode(eng._serve_cfg, eng._params, jax.random.key(0), state, obs, avail,
                          deterministic=True, mode="cached")
    out["engine/action"] = np.asarray(res.action)
    out["engine/log_prob"] = np.asarray(res.log_prob)
    out["engine/scores"] = scores(eng._serve_cfg, eng._params, state, obs, avail,
                                  np.asarray(res.action), None)


def trajectory(jcfg, params, T, E, seed):
    """A trajectory at the policy's own log-probs and values (so the PPO
    ratios start at 1), with random observations, actions, rewards and one
    episode end; JAX's Trajectory and RolloutState."""
    from mat_dcml_tpu.models.policy import TransformerPolicy as JaxPolicy
    from mat_dcml_tpu.training.rollout import RolloutState, Trajectory

    rng = np.random.default_rng(seed)
    A = jcfg.n_agent
    share = rng.normal(size=(T, E, A, jcfg.state_dim)).astype(np.float32)
    obs = rng.normal(size=(T, E, A, jcfg.obs_dim)).astype(np.float32)
    avail = np.ones((T, E, A, jcfg.action_dim), np.float32)
    act = actions(jcfg, rng, T * E).reshape(T, E, A, 1)
    v, logp, _ = JaxPolicy(jcfg).evaluate_actions(
        params, share.reshape(T * E, A, -1), obs.reshape(T * E, A, -1),
        act.reshape(T * E, A, 1), avail.reshape(T * E, A, -1))
    masks = np.ones((T + 1, E, A, 1), np.float32)
    masks[2, 1] = 0.0
    traj = Trajectory(
        share_obs=jnp.asarray(share), obs=jnp.asarray(obs), available_actions=jnp.asarray(avail),
        actions=jnp.asarray(act), log_probs=jnp.asarray(logp).reshape(T, E, A, 1),
        values=jnp.asarray(v).reshape(T, E, A, 1),
        rewards=jnp.asarray(rng.normal(size=(T, E, A, 1)).astype(np.float32)),
        masks=jnp.asarray(masks), active_masks=jnp.ones((T + 1, E, A, 1)),
        delays=jnp.zeros((T, E)), payments=jnp.zeros((T, E)), dones=jnp.zeros((T, E), bool))
    rs = RolloutState(env_states=None, obs=jnp.asarray(rng.normal(size=obs.shape[1:]), jnp.float32),
                      share_obs=jnp.asarray(rng.normal(size=share.shape[1:]), jnp.float32),
                      available_actions=jnp.asarray(avail[-1]), mask=jnp.asarray(masks[-1]),
                      rng=jax.random.key(0))
    return traj, rs


def _update(out):
    """The whole update (``UPDATE``) and its first minibatch step alone, from
    the same weights, trajectory and key."""
    from mat_dcml_tpu.models.policy import TransformerPolicy as JaxPolicy
    from mat_dcml_tpu.training.ppo import MATTrainer, PPOConfig

    jcfg, _ = configs(SEMI)
    params = jax_params(jcfg, seed=9)
    u = UPDATE
    traj, rs = trajectory(jcfg, params, u["T"], u["E"], seed=10)
    k = jax.random.key(u["key"])
    n_rows = u["T"] * u["E"]
    out["update/perms"] = np.stack([np.asarray(jax.random.permutation(ke, n_rows))
                                    for ke in jax.random.split(k, u["ppo_epoch"])])
    for name in traj._fields:
        x = getattr(traj, name)
        if isinstance(x, jax.Array):
            out[f"update/traj/{name}"] = np.asarray(x)
    out["update/rs/obs"], out["update/rs/share_obs"] = np.asarray(rs.obs), np.asarray(rs.share_obs)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        out["update/before/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
    for tag, epochs, mbs in (("whole", u["ppo_epoch"], u["num_mini_batch"]), ("step", 1, 1)):
        trainer = MATTrainer(JaxPolicy(jcfg, decode_mode="cached"),
                             PPOConfig(update_stream_chunks=0, target_stream_chunk=0,
                                       ppo_epoch=epochs, num_mini_batch=mbs))
        state, met = jax.jit(trainer.train)(trainer.init_state(params), traj, rs, k)
        for path, leaf in jax.tree_util.tree_leaves_with_path(jax.device_get(state.params)):
            out[f"update/{tag}/after/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
        for name in met._fields:
            out[f"update/{tag}/metrics/{name}"] = np.asarray(getattr(met, name))


SECTIONS = {"families": _families, "kernels": _kernels, "engine": _engine, "update": _update}


def main(path: str, *sections: str) -> None:
    out: dict = {}
    for name in sections or SECTIONS:
        SECTIONS[name](out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
