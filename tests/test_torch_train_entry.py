"""The port's training entry point, ``python -m mat_dcml_tpu_torch.train_dcml``,
run on the CPU for a short job at a small size: it must write finite
``metrics.jsonl`` records with the JAX record's basic keys and checkpoints at
the recipe's cadence, reject flags it does not support, and default to the
card."""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mat_dcml_tpu_torch import train_dcml

ROOT = Path(__file__).resolve().parent.parent
SMALL_RUN = ["--num_env_steps", "32", "--n_rollout_threads", "4", "--episode_length", "4",
             "--n_embd", "16", "--n_block", "1", "--ppo_epoch", "2", "--num_mini_batch", "2",
             "--log_interval", "1"]
KEYS = {"episode", "total_steps", "fps", "average_step_rewards", "value_loss", "policy_loss",
        "dist_entropy", "grad_norm", "param_norm", "update_ratio", "ratio"}


def _run(*args):
    return subprocess.run([sys.executable, "-m", "mat_dcml_tpu_torch.train_dcml", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_short_cpu_run_writes_finite_metrics(tmp_path):
    res = _run("--device", "cpu", "--run_dir", str(tmp_path), *SMALL_RUN)
    assert res.returncode == 0, res.stderr[-2000:]
    # the recipe's cadence (save_interval 50): episode 0 and the last
    models = tmp_path / "DCML/AS/mat/check/models"
    assert sorted(p.name for p in models.iterdir() if p.name.isdigit()) == ["0", "1"]
    assert "saves no model" not in res.stdout
    lines = (tmp_path / "DCML/AS/mat/check/metrics.jsonl").read_text().splitlines()
    records = [json.loads(line) for line in lines]
    assert [r["episode"] for r in records] == [0, 1]
    for r in records:
        assert KEYS <= set(r)
        assert all(math.isfinite(v) for v in r.values())
    assert "aver_episode_delays" in records[0] or "aver_episode_delays" in records[1]


@pytest.mark.parametrize("flag", ["--no_such_flag", "--update_stream_chunks", "--eval_episodes"])
def test_unknown_and_unported_flags_are_errors(tmp_path, capsys, flag):
    with pytest.raises(SystemExit) as exc:
        train_dcml.main(["--device", "cpu", "--run_dir", str(tmp_path), flag, "4"])
    assert exc.value.code == 2 and "unrecognized arguments" in capsys.readouterr().err


def test_scan_decode_run_writes_finite_metrics(tmp_path):
    """``--decode_mode scan``: the rollout decodes through the whole-decode
    path (its plain twin on the CPU)."""
    train_dcml.main(["--device", "cpu", "--run_dir", str(tmp_path), "--decode_mode", "scan",
                     *SMALL_RUN])
    lines = (tmp_path / "DCML/AS/mat/check/metrics.jsonl").read_text().splitlines()
    records = [json.loads(line) for line in lines]
    assert [r["episode"] for r in records] == [0, 1]
    assert all(KEYS <= set(r) and all(math.isfinite(v) for v in r.values()) for r in records)


def test_stride_decode_cannot_train(tmp_path):
    with pytest.raises(ValueError, match="eval-only"):
        train_dcml.main(["--device", "cpu", "--run_dir", str(tmp_path), "--decode_mode", "stride",
                         *SMALL_RUN])


def test_default_device_is_the_card(tmp_path):
    argv = ["--run_dir", str(tmp_path), *SMALL_RUN]
    if torch.cuda.is_available():
        train_dcml.main(argv)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_dcml.main(argv)


def test_train_iteration_collects_and_updates(tmp_path):
    """``MATTrainer.train_iteration`` (collect, then the update) on a runner's
    parts: the weights move, the metrics are finite, the chunk is counted."""
    from mat_dcml_tpu_torch.config import RunConfig
    from mat_dcml_tpu_torch.training.ppo import PPOConfig
    from mat_dcml_tpu_torch.training.runner import DCMLRunner

    run = RunConfig(device="cpu", n_rollout_threads=2, episode_length=3, n_embd=16, n_block=1,
                    run_dir=str(tmp_path))
    runner = DCMLRunner(run, PPOConfig(ppo_epoch=1, num_mini_batch=2, lr=1e-3),
                        log_fn=lambda *_: None)
    state, rollout = runner.setup()
    before = [p.detach().clone() for p in runner.policy.model.parameters()]
    state, rollout, metrics, stats, seconds = runner.trainer.train_iteration(
        runner.collector, state, rollout, generator=runner.generator)
    assert state.update_step == 1
    assert len(seconds) == 2 and all(s > 0 for s in seconds)
    assert all(math.isfinite(float(v)) for v in metrics)
    assert set(stats) == {"n_done", "done_reward_sum", "done_delay_sum", "done_payment_sum",
                          "step_reward_mean"}
    assert any((p - b).abs().max() > 0 for p, b in zip(runner.policy.model.parameters(), before))
    assert rollout.obs.shape == (2, 101, 7)
