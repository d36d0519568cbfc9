"""The bf16 trunk (``MATConfig(dtype="bfloat16")``) against the JAX package's,
on the CPU, with the same weights through ``bridge.py`` and the same noise.

Both trunks round at the same points: flax's ``Dense(dtype=bf16)`` casts its
input, kernel and bias and adds the bias after the product's rounding, its
``LayerNorm`` keeps f32 statistics, scale and bias and rounds its output,
``jax.nn.gelu`` rounds after each of its ops, attention takes f32 scores and
softmax and rounds P before P.V; the heads, values, log-probs and
distributions are f32.  What is left is f32 summation order, which now and
then rounds a value near a bf16 boundary the other way on one side and
moves what follows it by up to a few 1e-3 at these O(1) weights.  So values,
log-probs, logits and caches are held to the JAX package's bf16 bound, rtol
2e-2 and atol 1e-3, except that at most a tenth of them may move by up to
2e-2 (``_close``; measured: forward and evaluate within 1e-6 and 5e-5, one
decode log-prob of 24 by 5.3e-3).

The JAX side is computed by ``tests/torch_bf16_reference.py`` in a process
of its own with XLA's excess precision off: on the CPU, XLA otherwise keeps
f32 between the ops of a fused bf16 computation and skips roundings the JAX
code asks for (about a quarter of such a fusion's outputs move by a bf16
ulp; the Pallas kernels' interpret mode too), which the TPU kernels and the
port do not skip.

- Forward, ``evaluate_actions`` (semi-discrete and ``discrete``).
- The cached decode (semi-discrete, ``discrete``) against JAX's XLA decode on
  replayed noise: log-probs within the bound above, actions equal except
  past a top-2 margin below ``NEAR_TIE`` = 5e-2 (about six bf16 ulps of a
  logit of O(1); measured: no divergence).
- The decode kernels' plain twins against JAX's Pallas kernels in interpret
  mode at bf16 (the rounding points of ``pallas_decode.py``: ``_mm``,
  ``_gelu``, ``_layer_norm``, f32 scores, softmax and P.V): log-probs, logits
  and caches within rtol 2e-2 and atol 1e-3 (the JAX package holds its own
  fused-vs-unfused bf16 pair to rtol 0.05 and atol 0.02; measured: the
  whole decode's log-probs within 1.5e-7, its actions equal; the step's
  caches equal, its logits within 4.8e-7).
- The bf16 engine: its install cast (every f32 parameter to bf16 but the
  heads' and ``log_std``) and its decode against the JAX engine's, and, at
  the reference init, its decode against the f32 engine's within the JAX
  canary contract for a bf16 trunk (``serving/rollout_ctl.py``: a request
  mismatches where its greedy actions differ, or else where its log-probs
  leave rtol 2e-2 / atol 1e-3; at most a quarter may).
- One bf16 PPO update (2 epochs x 2 minibatches, the recipe's lr), and its
  first minibatch step alone, against JAX's on the same trajectory, weights
  and permutations: weights within rtol 5e-3 and atol 5e-4
  (``tests/test_update_attn_parity.py``), the value loss within rtol 1e-2,
  the first step's grad norm and ratio within rtol 1e-2, and the steps in
  the same direction on at least 70%
  of the entries (Adam moves nearly every entry by about lr; where the
  gradient is a sum that cancels, bf16 rounding decides its sign: JAX's own
  two bf16 attention paths agree on 82%, a gradient unrelated to JAX's on
  about half).
- ``RunConfig(model_dtype="bfloat16")`` through the DCML and MuJoCo runners,
  one tiny iteration each on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mat_dcml_tpu_torch.bridge import params_from_jax
from mat_dcml_tpu_torch.models.decode import serve_decode
from mat_dcml_tpu_torch.models.mat import MultiAgentTransformer
from mat_dcml_tpu_torch.models.policy import TransformerPolicy
from mat_dcml_tpu_torch.ops import ar_decode as ard
from mat_dcml_tpu_torch.ops import decode_step as dst
from mat_dcml_tpu_torch.serving.engine import DecodeEngine, EngineConfig
from tests import torch_bf16_reference as R
from tests.torch_port_helpers import configs, inputs, jax_params, torch_in

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-2, 1e-3          # values and log-probs, port vs JAX
FLIP_SHARE, FLIP_ATOL = 0.1, 2e-2   # _close: values a flipped bf16 rounding moved
POLICY_LOSS_ATOL = 1e-2          # test_update_matches_jax
NEAR_TIE = 5e-2
B = R.B


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX references (``tests/torch_bf16_reference.py``), computed once,
    with XLA's excess precision off, in three processes at once."""
    out = tmp_path_factory.mktemp("bf16_reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " " + R.EXCESS_PRECISION_OFF).strip())
    groups = (("families", "engine"), ("kernels",), ("update",))
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_bf16_reference",
                               str(out / f"{k}.npz"), *group], cwd=ROOT, env=env,
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
             for k, group in enumerate(groups)]
    errors = [p.communicate(timeout=600)[1] for p in procs]
    refs = {}
    for k, (p, err) in enumerate(zip(procs, errors)):
        assert p.returncode == 0, err[-4000:]
        with np.load(out / f"{k}.npz") as data:
            refs.update({name: data[name] for name in data.files})
    return refs


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    """Within rtol / atol, but for the few values that a bf16 rounding flipped
    upstream moves: one side's f32 summation order rounds a value near a
    bf16 boundary the other way (about one in 10^4), and what follows it
    moves by up to a few 1e-3 at these O(1) weights.  At most a tenth of the
    values may do so (FLIP_SHARE), and those within FLIP_ATOL."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if got.size == 0:
        return
    err = np.abs(got - want)
    over = err > atol + rtol * np.abs(want)
    assert over.mean() <= FLIP_SHARE and (err <= FLIP_ATOL + rtol * np.abs(want)).all(), (
        f"{what}: {int(over.sum())} of {over.size} beyond rtol {rtol} / atol {atol}, "
        f"max |diff| {err.max():.3g}")


def _model(tcfg, params):
    model = MultiAgentTransformer(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model.eval()


@pytest.fixture(scope="module", params=list(R.FAMILIES))
def family(request):
    jcfg, tcfg = configs(R.FAMILIES[request.param])
    return request.param, jcfg, tcfg, _model(tcfg, jax_params(jcfg))


def test_params_stay_f32_and_gradients_reach_them(family):
    _, jcfg, tcfg, model = family
    assert all(p.dtype == torch.float32 for p in model.parameters())
    state, obs, _ = inputs(jcfg, B)
    with torch.enable_grad():
        v, rep, logits = model(*torch_in(state, obs, R.shifted(jcfg, 2)))
        assert rep.dtype == torch.bfloat16
        assert v.dtype == logits.dtype == torch.float32
        (v.sum() + logits.sum()).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    # every parameter but log_std (which the teacher-forced pass does not read)
    assert {n for n, g in grads.items() if g is None} <= {"decoder.log_std"}
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads.values() if g is not None)
    assert model.encoder.blocks[0].attn.query_p.weight.grad.abs().sum() > 0
    model.zero_grad(set_to_none=True)


def test_forward_matches_jax(family, ref):
    fam, jcfg, tcfg, model = family
    state, obs, _ = inputs(jcfg, B)
    with torch.no_grad():
        v, rep, logits = model(*torch_in(state, obs, R.shifted(jcfg, 2)))
    _close(v, ref[f"{fam}/values"], "values")
    _close(rep.float(), ref[f"{fam}/rep"], "obs_rep")
    _close(logits, ref[f"{fam}/logits"], "logits")


def test_evaluate_actions_matches_jax(family, ref):
    fam, jcfg, tcfg, model = family
    state, obs, avail = inputs(jcfg, B, seed=3)
    act = R.actions(jcfg, np.random.default_rng(4), B)
    policy = TransformerPolicy(tcfg, device="cpu")
    policy.model = model
    with torch.no_grad():
        out = policy.evaluate_actions(*torch_in(state, obs, act, avail))
    for name, x in zip(("values", "log_probs", "entropy"), out):
        assert x.dtype == torch.float32
        _close(x, ref[f"{fam}/evaluate/{name}"], name)


def _agree(act, logp, ref_act, ref_logp, scores, nd, near_tie=NEAR_TIE):
    """Row by row: discrete actions equal up to the first difference, which
    is allowed only where the reference's top-2 score margin is below
    ``near_tie``; over all rows, the log-probs before it (and the tail's
    actions where a row never diverged) as :func:`_close` holds them."""
    mine, theirs = [], []
    for b in range(act.shape[0]):
        diff = np.flatnonzero(act[b, :nd] != ref_act[b, :nd])
        end = act.shape[1] if diff.size == 0 else int(diff[0])
        if diff.size:
            top2 = np.sort(scores[b, end])[-2:]
            assert top2[1] - top2[0] < near_tie, f"row {b}: actions differ at {end}"
        else:
            mine.append(act[b, nd:])
            theirs.append(ref_act[b, nd:])
        mine.append(logp[b, :end])
        theirs.append(ref_logp[b, :end])
    _close(np.concatenate(mine), np.concatenate(theirs), "log-probs and tail actions")


def _nd(cfg):
    return cfg.n_discrete_agents if cfg.action_type == "semi_discrete" else cfg.n_agent


def test_cached_decode_matches_jax_xla(family, ref):
    fam, jcfg, tcfg, model = family
    state, obs, avail = inputs(jcfg, B, seed=5)
    tag = f"{fam}/decode"
    tail = ref[f"{tag}/tail"] if fam == "semi_discrete" else None
    with torch.no_grad():
        v, res = serve_decode(model, state, obs, avail, deterministic=False, mode="cached",
                              device="cpu", gumbel=torch.from_numpy(ref[f"{tag}/gumbel"]),
                              tail_noise=None if tail is None else torch.from_numpy(tail))
    _close(v, ref[f"{tag}/values"], "values")
    _agree(res.action.numpy()[..., 0], res.log_prob.numpy()[..., 0], ref[f"{tag}/action"][..., 0],
           ref[f"{tag}/log_prob"][..., 0], ref[f"{tag}/scores"], _nd(jcfg))


def test_ar_decode_plain_matches_jax_pallas_interpret(ref):
    """The whole decode's plain twin (the kernel's arithmetic) against JAX's
    Pallas kernel in interpret mode, both with a bf16 obs_rep and trunk."""
    jcfg, tcfg = configs(R.AR)
    weights = ard.pack_ar_decode_weights(_model(tcfg, jax_params(jcfg)))
    assert weights.block_qkvp1_w.dtype == torch.bfloat16 and weights.head_w1.dtype == torch.float32
    rep = torch.from_numpy(ref["ar/rep"]).bfloat16()        # bf16 values: exact
    act, logp, scores = ard.ar_decode_plain(
        weights, rep, *(torch.from_numpy(ref[f"ar/{k}"]) for k in ("gumbel", "normal", "avail")),
        n_head=jcfg.n_head, adim=jcfg.action_dim, nd=jcfg.n_discrete_agents, return_scores=True)
    _agree(act.numpy(), logp.numpy(), ref["ar/action"], ref["ar/log_prob"], scores.numpy(),
           jcfg.n_discrete_agents)


def test_decode_step_plain_matches_jax_pallas_interpret(ref):
    """The decode step's plain twin against JAX's Pallas kernel in interpret
    mode: bf16 input, rep and caches (position-major), f32 logits."""
    jcfg, tcfg = configs(R.STEP)
    x_in, rep, caches = R.step_inputs(jcfg)
    work = dst.decode_caches(jcfg.n_block, jcfg.n_agent, B, jcfg.n_embd, "cpu",
                             dtype=torch.bfloat16)
    work.copy_(torch.from_numpy(caches))
    logits = dst.fused_decode_step(
        dst.pack_decode_weights(_model(tcfg, jax_params(jcfg))),
        torch.from_numpy(x_in).bfloat16(), torch.from_numpy(rep).bfloat16(), work,
        R.STEP_POSITION, n_head=jcfg.n_head, adim=jcfg.action_dim)
    assert logits.dtype == torch.float32
    _close(logits, ref["step/logits"], "logits")
    _close(work.float(), ref["step/caches"], "caches")


def test_engine_bf16_casts_and_decodes_as_jax(ref):
    jcfg, tcfg = configs(dict(R.SEMI, dtype="float32"))
    state_dict = params_from_jax(jax_params(jcfg, seed=7))
    eng = DecodeEngine(state_dict, tcfg, EngineConfig(buckets=(B,), serve_dtype="bf16"),
                       device="cpu", log_fn=lambda *_: None)
    assert eng.serve_cfg.dtype == "bfloat16"
    # the install cast: every f32 parameter to bf16 but the heads' and
    # log_std, leaf for leaf as the JAX engine casts them
    flags = {k[len("engine/bf16/params/"):]: bool(v) for k, v in ref.items()
             if k.startswith("engine/bf16/")}
    tags = {k: np.full((1, 1) if k.endswith("kernel") else (1,), float(v))
            for k, v in flags.items()}
    want = {name: torch.bfloat16 if bool(t.flatten()[0]) else torch.float32
            for name, t in params_from_jax(_nest(tags)).items()}
    got = {k: v.dtype for k, v in eng._model.state_dict().items()}
    assert got == want
    assert got["decoder.log_std"] == got["encoder.head.Dense_0.weight"] == torch.float32
    assert got["encoder.blocks.0.ln1.weight"] == torch.bfloat16
    state, obs, avail = inputs(jcfg, B, seed=8)
    act, logp = eng.decode(state, obs, avail)
    _agree(act[..., 0], logp[..., 0], ref["engine/action"][..., 0], ref["engine/log_prob"][..., 0],
           ref["engine/scores"], jcfg.n_discrete_agents)
    eng.warmup()
    assert eng.telemetry.flush()["serving_dtype_bits"] == 16.0


def _nest(flat):
    """``{"a/b/c": leaf}`` -> nested dicts."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *path, last = key.split("/")
        for name in path:
            node = node.setdefault(name, {})
        node[last] = leaf
    return tree


def test_engine_bf16_stays_within_the_canary_contract_of_f32():
    # the reference init (0.01-gain heads), as a trained artifact starts:
    # the JAX canary contract for a bf16 trunk against the f32 engine
    jcfg, tcfg = configs(dict(R.SEMI, n_agent=11, dtype="float32"))
    params = MultiAgentTransformer(tcfg, device="cpu",
                                   generator=torch.Generator().manual_seed(3)).state_dict()
    state, obs, avail = inputs(jcfg, 8, seed=9)
    out = {}
    for dtype in ("f32", "bf16"):
        eng = DecodeEngine(params, tcfg, EngineConfig(buckets=(8,), serve_dtype=dtype),
                           device="cpu", log_fn=lambda *_: None)
        out[dtype] = eng.decode(state, obs, avail)
    (act, logp), (act32, logp32) = out["bf16"], out["f32"]
    nd = tcfg.n_discrete_agents
    # per request, as the canary compares: its greedy actions differ, or
    # else its log-probs leave rtol / atol; at most a quarter may mismatch
    bad = sum(not np.array_equal(act[b, :nd], act32[b, :nd])
              or not np.allclose(logp[b], logp32[b], rtol=RTOL, atol=ATOL) for b in range(8))
    assert bad <= 2, bad


@pytest.mark.parametrize("which", ["whole", "step"])
def test_update_matches_jax(ref, which):
    """The whole update (2 epochs x 2 minibatches) and its first minibatch
    step alone, from the same weights, trajectory and permutations."""
    from mat_dcml_tpu_torch.training import rollout as trollout
    from mat_dcml_tpu_torch.training.ppo import MATTrainer, PPOConfig

    jcfg, tcfg = configs(R.SEMI)
    u = R.UPDATE
    epochs, mbs = (u["ppo_epoch"], u["num_mini_batch"]) if which == "whole" else (1, 1)

    def tree(tag):
        return _nest({k[len(f"update/{tag}/"):]: v for k, v in ref.items()
                      if k.startswith(f"update/{tag}/")})

    before, after = params_from_jax(tree("before")), params_from_jax(tree(f"{which}/after"))
    policy = TransformerPolicy(tcfg, device="cpu")
    policy.model.load_state_dict(before)
    trainer = MATTrainer(policy, PPOConfig(ppo_epoch=epochs, num_mini_batch=mbs))
    fields = {f: torch.from_numpy(v) for f, v in tree("traj").items()}
    traj = trollout.Trajectory(**fields, chunk_stats={})
    rs = trollout.RolloutState(env_states=None, obs=torch.from_numpy(ref["update/rs/obs"]),
                               share_obs=torch.from_numpy(ref["update/rs/share_obs"]),
                               available_actions=fields["available_actions"][-1],
                               mask=fields["masks"][-1], episode_acc=torch.zeros(u["E"], 3))
    perms = torch.from_numpy(ref["update/perms"][:epochs]).long()
    state, met = trainer.train(trainer.init_state(), traj, rs, perms=perms)
    lr = PPOConfig().lr
    agree = total = 0
    for name, p in policy.model.state_dict().items():
        want = after[name].numpy()
        np.testing.assert_allclose(p.numpy(), want, rtol=5e-3, atol=5e-4, err_msg=name)
        step, ref_step = p.numpy() - before[name].numpy(), want - before[name].numpy()
        big = np.abs(ref_step) > lr / 2
        agree += int((np.sign(step[big]) == np.sign(ref_step[big])).sum())
        total += int(big.sum())
    assert total > 1000 and agree >= 0.7 * total, (agree, total)
    metrics = {k[len(f"update/{which}/metrics/"):]: float(v) for k, v in ref.items()
               if k.startswith(f"update/{which}/metrics/")}
    np.testing.assert_allclose(float(met.value_loss), metrics["value_loss"], rtol=1e-2)
    np.testing.assert_allclose(float(met.dist_entropy), metrics["dist_entropy"], rtol=RTOL)
    # the policy loss is a mean of unit-scale advantages times ratios that
    # cancels to near 0, and bf16 moves the ratios by ~1e-2: an absolute bound
    np.testing.assert_allclose(float(met.policy_loss), metrics["policy_loss"], rtol=0,
                               atol=POLICY_LOSS_ATOL)
    if which == "step":
        # one gradient from the same weights: its norm and the ratios agree
        # (measured 3e-4, 2e-3); over four steps the two sides' rounding
        # moves which ratios the surrogate clips, and with them the norm
        # (JAX's own two bf16 attention paths part by 2% there, the port by
        # 14%), so the whole update's are not held
        for name in ("grad_norm", "ratio"):
            np.testing.assert_allclose(float(getattr(met, name)), metrics[name], rtol=1e-2,
                                       err_msg=name)


@pytest.mark.parametrize("env", ["dcml", "mujoco"])
def test_runner_trains_a_bf16_trunk_on_the_cpu(env, tmp_path):
    from mat_dcml_tpu_torch.config import RunConfig
    from mat_dcml_tpu_torch.training.ppo import PPOConfig

    common = dict(model_dtype="bfloat16", device="cpu", n_rollout_threads=2, episode_length=2,
                  num_env_steps=4, n_embd=16, log_interval=1, run_dir=str(tmp_path))
    ppo = PPOConfig(ppo_epoch=1, num_mini_batch=1)
    if env == "dcml":
        from mat_dcml_tpu_torch.training.runner import DCMLRunner

        runner = DCMLRunner(RunConfig(**common), ppo, log_fn=lambda *_: None)
    else:
        from mat_dcml_tpu_torch.envs.mamujoco.lite import MJLiteConfig
        from mat_dcml_tpu_torch.training.mujoco_runner import MujocoRunner

        runner = MujocoRunner(RunConfig(env_name="mujoco", decode_mode="scan", **common), ppo,
                              MJLiteConfig(episode_length=2), log_fn=lambda *_: None)
    assert runner.policy.cfg.dtype == "bfloat16"
    before = [p.detach().clone() for p in runner.policy.model.parameters()]
    runner.train_loop()
    (record,) = runner.records
    assert all(np.isfinite(v) for v in record.values())
    assert all(p.dtype == torch.float32 for p in runner.policy.model.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(before, runner.policy.model.parameters()))
