"""The port's GAE, ValueNorm, entropies and Huber loss against the JAX
package's, on the CPU, from numpy inputs with a seed.

GAE runs the same f32 recurrence in the same order on both sides: atol 1e-5
on returns of magnitude ~10 (a few ulps).  ValueNorm: the same EMA
arithmetic, rtol 1e-6.  Entropies and the Huber loss: atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mat_dcml_tpu.ops import distributions as jd
from mat_dcml_tpu.ops import normalize as jn
from mat_dcml_tpu.ops.gae import compute_gae as jax_gae
from mat_dcml_tpu_torch.ops import distributions as td
from mat_dcml_tpu_torch.ops import normalize as tn
from mat_dcml_tpu_torch.ops.gae import compute_gae


@pytest.mark.parametrize("seed", [0, 1])
def test_gae_matches_jax(seed):
    rng = np.random.default_rng(seed)
    T, E, A = 12, 3, 5
    rewards = rng.normal(size=(T, E, A, 1)).astype(np.float32)
    values = rng.normal(size=(T + 1, E, A, 1)).astype(np.float32)
    done = rng.uniform(size=(T + 1, E, 1, 1)) < 0.3
    masks = np.broadcast_to(np.where(done, 0.0, 1.0), (T + 1, E, A, 1)).astype(np.float32)
    adv, ret = compute_gae(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (rewards, values, masks)),
                           0.99, 0.95)
    jadv, jret = jax_gae(rewards, values, masks, 0.99, 0.95)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), atol=1e-5)


def test_value_norm_matches_jax():
    rng = np.random.default_rng(3)
    js, ts = jn.value_norm_init(1), tn.value_norm_init(1)
    for i in range(5):
        batch = (rng.normal(size=(40, 1)) * (3 + i) + 10 * i).astype(np.float32)
        js = jn.value_norm_update(js, jnp.asarray(batch))
        ts = tn.value_norm_update(ts, torch.from_numpy(batch))
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        x = rng.normal(size=(7, 1)).astype(np.float32) * 20
        np.testing.assert_allclose(tn.value_norm_normalize(ts, torch.from_numpy(x)).numpy(),
                                   np.asarray(jn.value_norm_normalize(js, x)), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tn.value_norm_denormalize(ts, torch.from_numpy(x)).numpy(),
                                   np.asarray(jn.value_norm_denormalize(js, x)), rtol=1e-6, atol=1e-5)


def test_entropies_and_huber_match_jax():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(6, 5, 2)) * 3).astype(np.float32)
    logits[0, :, 1] = -1e10          # a masked action
    np.testing.assert_allclose(td.categorical_entropy(torch.from_numpy(logits)).numpy(),
                               np.asarray(jd.categorical_entropy(logits)), atol=1e-6)
    std = np.asarray([0.3, 0.2], np.float32)
    mean = logits[:, :, :2]
    np.testing.assert_allclose(
        td.normal_entropy(torch.from_numpy(mean), torch.from_numpy(std)).numpy(),
        np.asarray(jd.normal_entropy(mean, std)), atol=1e-6)
    e = (rng.normal(size=(50,)) * 20).astype(np.float32)
    np.testing.assert_allclose(td.huber_loss(torch.from_numpy(e), 10.0).numpy(),
                               np.asarray(jd.huber_loss(e, 10.0)), atol=1e-6, rtol=1e-7)
