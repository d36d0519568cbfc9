"""flax parameter tree <-> the port's ``state_dict``, for the semi-discrete
DCML shape, the continuous families and the discrete family at SMAC's
widths: every leaf lands on a parameter of the port's model, and the round
trip gives back the JAX tree bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.models.mat import MATConfig as JaxMATConfig
from mat_dcml_tpu.models.mat import MultiAgentTransformer as JaxMAT
from mat_dcml_tpu_torch.bridge import params_from_jax, params_to_jax
from mat_dcml_tpu_torch.models.mat import MATConfig, MultiAgentTransformer

# DCML at full width (101 agents, obs 7, state 102, action 2, n_embd 64)
SHAPE = dict(n_agent=101, obs_dim=7, state_dim=102, action_dim=2, n_block=2,
             n_embd=64, n_head=2, action_type="semi_discrete", semi_index=-1)


@pytest.fixture(scope="module")
def jax_tree():
    cfg = JaxMATConfig(**SHAPE)
    A = cfg.n_agent
    params = JaxMAT(cfg).init(
        jax.random.key(3), jnp.zeros((1, A, cfg.state_dim)),
        jnp.zeros((1, A, cfg.obs_dim)), jnp.zeros((1, A, cfg.action_input_dim)),
    )
    return jax.tree.map(np.asarray, jax.device_get(params))


def test_state_dict_covers_the_model(jax_tree):
    sd = params_from_jax(jax_tree)
    model = MultiAgentTransformer(MATConfig(**SHAPE), device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    w = model.encoder.blocks[1].attn.key_p.weight
    k = jax_tree["params"]["encoder"]["blocks_1"]["attn"]["key_p"]["kernel"]
    np.testing.assert_array_equal(w.detach().numpy(), k.T)


def test_round_trip_is_bit_exact(jax_tree):
    back = params_to_jax(params_from_jax(jax_tree))
    flat_a = jax.tree_util.tree_leaves_with_path(jax_tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        other = flat_b[path]
        assert other.dtype == leaf.dtype and other.shape == leaf.shape, path
        np.testing.assert_array_equal(other, leaf)


def test_port_model_round_trips_through_jax():
    model = MultiAgentTransformer(MATConfig(**SHAPE), device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    back = params_from_jax(params_to_jax(sd))
    assert set(back) == set(sd)
    for key, val in sd.items():
        assert torch.equal(back[key], val), key


def test_unknown_leaf_raises():
    with pytest.raises(ValueError, match="unknown flax parameter"):
        params_from_jax({"params": {"decoder": {"mystery": np.zeros(3)}}})


@pytest.mark.parametrize("action_type", ["continuous", "available_continuous"])
def test_continuous_families_carry_their_own_leaves(action_type):
    """The continuous families' decoder embeds with a biased dense
    (``action_encoder_bias``) and keeps ``log_std``; both cross exactly."""
    shape = dict(SHAPE, n_agent=5, action_dim=8, action_type=action_type)
    cfg = JaxMATConfig(**shape)
    tree = jax.tree.map(np.asarray, jax.device_get(JaxMAT(cfg).init(
        jax.random.key(4), jnp.zeros((1, 5, cfg.state_dim)), jnp.zeros((1, 5, cfg.obs_dim)),
        jnp.zeros((1, 5, cfg.action_input_dim)))))
    sd = params_from_jax(tree)
    model = MultiAgentTransformer(MATConfig(**shape), device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    dec = tree["params"]["decoder"]
    np.testing.assert_array_equal(model.decoder.action_encoder_bias.weight.detach().numpy(),
                                  dec["action_encoder_bias"]["kernel"].T)
    np.testing.assert_array_equal(model.decoder.action_encoder_bias.bias.detach().numpy(),
                                  dec["action_encoder_bias"]["bias"])
    np.testing.assert_array_equal(model.decoder.log_std.detach().numpy(), dec["log_std"])
    back = params_to_jax(sd)["params"]["decoder"]
    np.testing.assert_array_equal(back["log_std"], dec["log_std"])
    np.testing.assert_array_equal(back["action_encoder_bias"]["kernel"],
                                  dec["action_encoder_bias"]["kernel"])


@pytest.mark.parametrize("widths", [
    dict(n_agent=8, obs_dim=80, state_dim=168, action_dim=14),          # SMAC 8m
    dict(n_agent=27, obs_dim=869, state_dim=1754, action_dim=36),       # the multi-map layout
    dict(n_agent=8, obs_dim=80, state_dim=168, action_dim=14, dec_actor=True,
         share_actor=True),                                             # MAT-Dec on 8m
], ids=["smac_8m", "smac_multi_map", "smac_8m_mat_dec"])
def test_discrete_family_round_trips_at_smac_widths(widths):
    """The ``discrete`` family at SMAC's widths (n_embd 64): every flax leaf
    lands on a parameter and the round trip is bit for bit."""
    shape = dict(SHAPE, action_type="discrete", semi_index=-1, **widths)
    cfg = JaxMATConfig(**shape)
    A = cfg.n_agent
    tree = jax.tree.map(np.asarray, jax.device_get(JaxMAT(cfg).init(
        jax.random.key(5), jnp.zeros((1, A, cfg.state_dim)), jnp.zeros((1, A, cfg.obs_dim)),
        jnp.zeros((1, A, cfg.action_input_dim)))))
    sd = params_from_jax(tree)
    model = MultiAgentTransformer(MATConfig(**shape), device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    back = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(model.state_dict())))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(back)
    for path, leaf in flat:
        np.testing.assert_array_equal(back[path], leaf)
