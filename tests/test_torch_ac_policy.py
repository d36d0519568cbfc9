"""The actor-critic family's pieces in the PyTorch port against the JAX
package, on the CPU: the two DCML views, the action heads, the MLP
actor-critic's weights, and PopArt.

- ``JointDCMLEnv`` and ``PerAgentDCMLEnv`` reset and step on draws replayed
  from JAX's key chains (the small env: 8 workers and the master, E = 2):
  integers (availability, role, done) equal, obs atol 1e-6, reward, delay
  and payment rtol 1e-6, as ``tests/test_torch_env.py``.
- ``ACTLayer.sample`` and ``evaluate`` for the four spaces DCML uses (the
  categorical worker, the ``extra`` Gaussian, ``MixedRole``, the joint mixed
  head) against flax's on transplanted weights at O(1) scale and noise
  replayed from the sampling key: actions equal (categorical parts; a row
  may differ only past a top-2 margin below 1e-5), Gaussian parts,
  log-probs and the active-masked entropies atol 1e-5.
- The actor-critic's weights: the bridge's round trip is bit for bit, for a
  shared and a stacked tree.
- PopArt's update (moments and the rescaled head), normalise and
  denormalise against ``mat_dcml_tpu/ops/popart.py``, rtol 1e-6 (f32, the
  same order of operations).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.envs.dcml.constants import DCMLConsts as JaxConsts
from mat_dcml_tpu.envs.dcml.env import DCMLEnv as JaxEnv
from mat_dcml_tpu.envs.dcml.env import DCMLEnvConfig as JaxEnvConfig
from mat_dcml_tpu.envs.dcml.joint import JointDCMLEnv as JaxJoint
from mat_dcml_tpu.envs.dcml.per_agent import PerAgentDCMLEnv as JaxPerAgent
from mat_dcml_tpu.envs.spaces import DCMLActionSpace as JaxDCMLSpace
from mat_dcml_tpu.envs.spaces import MixedRole as JaxMixedRole
from mat_dcml_tpu.models.act_layer import ACTLayer as JaxACTLayer
from mat_dcml_tpu.models.actor_critic import ACConfig as JaxACConfig
from mat_dcml_tpu.models.actor_critic import ActorCriticPolicy as JaxACPolicy
from mat_dcml_tpu.ops import normalize as jnorm
from mat_dcml_tpu.ops import popart as jpopart
from mat_dcml_tpu_torch.bridge import ac_params_from_jax, ac_params_to_jax
from mat_dcml_tpu_torch.envs.dcml import env as tenv
from mat_dcml_tpu_torch.envs.dcml.constants import DCMLConsts
from mat_dcml_tpu_torch.envs.dcml.joint import JointDCMLEnv
from mat_dcml_tpu_torch.envs.dcml.per_agent import PerAgentDCMLEnv
from mat_dcml_tpu_torch.envs.spaces import DCMLActionSpace, Discrete, MixedRole
from mat_dcml_tpu_torch.models.act_layer import ACNoise, ACTLayer
from mat_dcml_tpu_torch.models.actor_critic import ACConfig, ActorCriticPolicy
from mat_dcml_tpu_torch.models.bases import ParamGroup
from mat_dcml_tpu_torch.ops import popart as tpopart
from mat_dcml_tpu_torch.ops.normalize import ValueNormState
from tests.torch_port_helpers import jax_reset_draws, jax_step_draws

ROOT = Path(__file__).resolve().parent.parent
W, E = 8, 2
ATOL = 1e-5


# ------------------------------------------------------------------ views

@pytest.mark.parametrize("view", ["joint", "per_agent"])
def test_dcml_views_step_like_jax(view):
    jc, tc = JaxConsts(worker_number_max=W, sob_dim=W + 2), DCMLConsts(worker_number_max=W,
                                                                         sob_dim=W + 2)
    jbase = JaxEnv(JaxEnvConfig(consts=jc), data_dir=ROOT / "data")
    tbase = tenv.DCMLEnv(tenv.DCMLEnvConfig(consts=tc), device="cpu")
    jenv, tenv_ = (JaxJoint(jbase), JointDCMLEnv(tbase)) if view == "joint" else (
        JaxPerAgent(jbase), PerAgentDCMLEnv(tbase))
    assert (tenv_.n_agents, tenv_.obs_dim, tenv_.share_obs_dim, tenv_.action_dim) == (
        jenv.n_agents, jenv.obs_dim, jenv.share_obs_dim, jenv.action_dim)
    keys = jax.random.split(jax.random.key(3), E)
    reset, step_fn = jax.jit(jax.vmap(jenv.reset)), jax.jit(jax.vmap(jenv.step))
    jstate, jts = reset(keys, jnp.zeros(E, jnp.int32))
    tstate, tts = tenv_.reset(jax_reset_draws(keys, tc))
    rng = np.random.default_rng(0)
    for step in range(3):
        for name in ("obs", "share_obs"):
            np.testing.assert_allclose(getattr(tts, name).numpy(), np.asarray(getattr(jts, name)),
                                       atol=1e-6, err_msg=f"{name} at step {step}")
        for name in ("available_actions", "done"):
            np.testing.assert_array_equal(getattr(tts, name).numpy(),
                                          np.asarray(getattr(jts, name)), err_msg=name)
        for name in ("reward", "delay", "payment", "objectives"):
            np.testing.assert_allclose(getattr(tts, name).numpy(), np.asarray(getattr(jts, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
        bits = rng.integers(0, 2, size=(E, W)).astype(np.float32)
        ratio = rng.uniform(0.1, 0.9, size=(E, 1)).astype(np.float32)
        act = np.concatenate([bits, ratio], -1)
        act = act[:, None, :] if view == "joint" else act[:, :, None]
        _, d = jax_step_draws(jstate.rng, tc)
        jstate, jts = step_fn(jstate, jnp.asarray(act))
        tstate, tts = tenv_.step(tstate, torch.from_numpy(act), d)
    if view == "per_agent":   # the role column: the master last
        np.testing.assert_array_equal(tts.available_actions[..., -1].numpy(),
                                      np.tile(np.r_[np.zeros(W), 1.0], (E, 1)))


# ------------------------------------------------------------ action heads

B, D_IN = 12, 6
SPACES = {
    "categorical": (Discrete(2), JaxDCMLSpace(n=2)),
    "gaussian": (DCMLActionSpace(extra=True, continuous=True),
                 JaxDCMLSpace(extra=True, continuous=True)),
    "role": (MixedRole(n=2, cont_dim=1), JaxMixedRole(n=2, cont_dim=1)),
    "mixed": (DCMLActionSpace(n=2, n_sub=5, mixed=True, multi_discrete=True, continuous=True),
              JaxDCMLSpace(n=2, n_sub=5, mixed=True, multi_discrete=True, continuous=True)),
}


def _head_inputs(kind, space, rng):
    d_in = space.mixed_feature_dim if kind == "mixed" else D_IN
    x = rng.normal(size=(B, d_in)).astype(np.float32)
    if kind == "mixed":
        avail = (rng.uniform(size=(B, space.n_sub, 2)) > 0.3).astype(np.float32)
        avail[..., 0] = 1.0
    elif kind == "role":
        avail = np.concatenate([(rng.uniform(size=(B, 2)) > 0.3).astype(np.float32),
                                (np.arange(B) % 4 == 3).astype(np.float32)[:, None]], -1)
        avail[:, 0] = 1.0
    elif kind == "categorical":
        avail = (rng.uniform(size=(B, 2)) > 0.3).astype(np.float32)
        avail[:, 0] = 1.0
    else:
        avail = None
    return x, avail


def _replayed_noise(kind, space, key):
    if kind == "categorical":
        return ACNoise(np.asarray(jax.random.gumbel(key, (B, space.n), jnp.float32)), None)
    if kind == "gaussian":
        return ACNoise(None, np.asarray(jax.random.normal(key, (B, 1))))
    k_d, k_c = jax.random.split(key)
    g_shape = (B, space.n_sub, space.n) if kind == "mixed" else (B, space.n)
    return ACNoise(np.asarray(jax.random.gumbel(k_d, g_shape, jnp.float32)),
                   np.asarray(jax.random.normal(k_c, (B, 1))))


@pytest.mark.parametrize("deterministic", [True, False], ids=["mode", "sampled"])
@pytest.mark.parametrize("kind", sorted(SPACES))
def test_act_layer_matches_flax(kind, deterministic):
    tspace, jspace = SPACES[kind]
    rng = np.random.default_rng(5)
    x, avail = _head_inputs(kind, jspace, rng)
    jlayer = JaxACTLayer(jspace)
    params = jlayer.init(jax.random.key(0), x, jax.random.key(1), avail, False, method="sample")
    params = jax.tree.map(lambda a: np.asarray(rng.normal(size=a.shape) / np.sqrt(
        a.shape[0] if a.ndim == 2 else 10.0), np.float32), params)
    layer = ACTLayer("act", tspace, x.shape[-1])
    group = ParamGroup(layer.spec())
    tree = {"act/" + "/".join(str(k.key) for k in path): torch.from_numpy(np.array(leaf))
            for path, leaf in jax.tree_util.tree_leaves_with_path(params["params"])}
    p = group.views(group.from_tree(tree, 1))
    key = jax.random.key(9)
    ref_a, ref_lp = jlayer.apply(params, x, key, avail, deterministic, method="sample")
    noise = None if deterministic else ACNoise(*(None if n is None else torch.from_numpy(n)[None]
                                                 for n in _replayed_noise(kind, jspace, key)))
    tx = torch.from_numpy(x)[None]
    tav = None if avail is None else torch.from_numpy(avail)[None]
    with torch.no_grad():
        a, lp = layer.sample(p, tx, tav, deterministic, noise)
    a, lp, ref_a, ref_lp = a[0].numpy(), lp[0].numpy(), np.asarray(ref_a), np.asarray(ref_lp)
    assert a.shape == ref_a.shape and lp.shape == ref_lp.shape
    n_disc = jspace.n_sub if kind == "mixed" else int(kind != "gaussian")
    if n_disc:      # categorical parts equal but past a near-tie of the noisy logits
        ref_logits = np.asarray(jlayer.apply(params, x, method=lambda m, x: m.action_head(x))
                                if kind != "mixed" else x[:, :jspace.n_sub * 2].reshape(B, -1, 2))
        cat = ref_logits if kind == "mixed" else ref_logits[:, None]
        if avail is not None:
            cat = np.where((avail[:, :jspace.n_sub] if kind == "mixed" else avail[:, None, :2])
                           == 0, -1e10, cat)
        if noise is not None:
            g = noise.gumbel[0].numpy()
            cat = cat + (g if kind == "mixed" else g[:, None])
        top2 = np.sort(cat, -1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) >= 1e-5              # (B, n_disc)
        disc, ref_disc = a[:, :n_disc], ref_a[:, :n_disc]
        if kind == "role":     # the master rows hold the Gaussian draw
            workers = avail[:, -1] < 0.5
            np.testing.assert_array_equal(disc[workers][clear[workers]],
                                          ref_disc[workers][clear[workers]])
            np.testing.assert_allclose(a[~workers], ref_a[~workers], atol=ATOL)
        else:
            np.testing.assert_array_equal(disc[clear], ref_disc[clear])
        assert clear.all()     # no near-tie at these inputs
    np.testing.assert_allclose(a, ref_a, atol=ATOL)
    np.testing.assert_allclose(lp, ref_lp, atol=ATOL)
    assert float(np.abs(ref_lp).max()) > 0.1                         # not a degenerate head

    active = (rng.uniform(size=(B, 1)) > 0.25).astype(np.float32)
    ref_lp, ref_ent = jlayer.apply(params, x, ref_a, avail, active, method="evaluate")
    with torch.no_grad():
        lp, ent = layer.evaluate(p, tx, torch.from_numpy(np.array(ref_a))[None], tav,
                                 torch.from_numpy(active)[None])
    np.testing.assert_allclose(lp[0].numpy(), np.asarray(ref_lp), atol=ATOL)
    np.testing.assert_allclose(float(ent[0]), float(ref_ent), atol=ATOL)


# --------------------------------------------------------------- weights

@pytest.mark.parametrize("stacked", [False, True], ids=["shared", "stacked"])
def test_actor_critic_weights_round_trip(stacked):
    """The JAX tree lands on the policy's flat tensors and back bit for
    bit; the port's own init has JAX's names and shapes."""
    jspace, tspace = JaxMixedRole(), MixedRole()
    jpol = JaxACPolicy(JaxACConfig(hidden_size=16), 7, 10, jspace)
    n = 3 if stacked else 1
    shapes = (jax.eval_shape(jax.vmap(jpol.init_params), jax.random.split(jax.random.key(0), n))
              if stacked else jax.eval_shape(jpol.init_params, jax.random.key(0)))
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), shapes)
    pol = ActorCriticPolicy(ACConfig(hidden_size=16), 7, 10, tspace, n_stack=n, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    assert set(pol.tree()) == set(ac_params_from_jax(tree))
    pol.load_tree(ac_params_from_jax(tree))
    back = jax.tree_util.tree_leaves_with_path(ac_params_to_jax(pol.tree(), stacked=stacked))
    ref = jax.tree_util.tree_leaves_with_path(tree)
    assert len(back) == len(ref)
    for (p, a), (q, b) in zip(back, ref):
        assert p == q
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- PopArt

def test_popart_matches_jax():
    rng = np.random.default_rng(2)
    state = jnorm.ValueNormState(
        running_mean=np.asarray(rng.normal(size=(1,)), np.float32),
        running_mean_sq=np.asarray(2.0 + rng.uniform(size=(1,)), np.float32),
        debiasing_term=np.asarray(0.3, np.float32))
    batch = np.asarray(3.0 * rng.normal(size=(40, 1)) + 1.0, np.float32)
    head = {"kernel": np.asarray(rng.normal(size=(16, 1)), np.float32),
            "bias": np.asarray(rng.normal(size=(1,)), np.float32)}
    jvn, jhead = jpopart.popart_update(state, batch, head)
    tstate = ValueNormState(*(torch.from_numpy(np.array(x)) for x in state))
    tvn, thead = tpopart.popart_update(tstate, torch.from_numpy(batch),
                                       {k: torch.from_numpy(v) for k, v in head.items()})
    for a, b in zip(tvn, jvn):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for k in head:
        np.testing.assert_allclose(thead[k].numpy(), np.asarray(jhead[k]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tpopart.popart_normalize(tvn, torch.from_numpy(batch)).numpy(),
                               np.asarray(jpopart.popart_normalize(jvn, batch)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tpopart.popart_denormalize(tvn, torch.from_numpy(batch)).numpy(),
                               np.asarray(jpopart.popart_denormalize(jvn, batch)), rtol=1e-6)
    # the denormalised head's output is preserved, as PopArt promises
    feat = rng.normal(size=(5, 16)).astype(np.float32)
    before = tpopart.popart_denormalize(tstate, torch.from_numpy(feat @ head["kernel"]
                                                                 + head["bias"]))
    after = tpopart.popart_denormalize(tvn, torch.from_numpy(feat) @ thead["kernel"]
                                       + thead["bias"])
    np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=1e-5, atol=1e-5)
