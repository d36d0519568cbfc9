"""Run configuration and the trainer's strict command line.

Port of ``mat_dcml_tpu/config.py`` for the fields the port's training path
reads.  Unknown flags are an error, as in the JAX package: a flag of the JAX
CLI that this port does not support yet is unknown here, never silently
ignored.  ``--device`` (default ``cuda``) is the port's own.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from mat_dcml_tpu_torch.training.ppo import PPOConfig


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Run-level settings; defaults are the DCML recipe's."""

    algorithm_name: str = "mat"
    env_name: str = "DCML"
    scenario: str = "AS"
    experiment_name: str = "check"
    seed: int = 1
    n_rollout_threads: int = 8        # env-batch size E
    num_env_steps: int = 1_000_000
    episode_length: int = 50
    log_interval: int = 5
    # checkpoint every save_interval episodes and on the last (0 = never);
    # evaluate every eval_interval episodes when use_eval (DCML only)
    save_interval: int = 50
    eval_interval: int = 25
    use_eval: bool = False
    run_dir: str = "results"
    # restore from this checkpoint directory (a run's models/)
    model_dir: Optional[str] = None
    # "strict": model_dir must hold a checkpoint; "auto": resume from
    # model_dir or this run's own models/ when either holds one, else start
    # fresh (training/runner.py::EpisodicRunner.setup)
    resume: str = "strict"
    # SIGTERM / SIGINT -> emergency checkpoint at the next episode boundary,
    # then exit 75 (training/resilience.py)
    graceful_stop: bool = True
    n_block: int = 2
    n_embd: int = 64
    n_head: int = 2
    model_dtype: str = "float32"
    # rollout decode: "cached", or "scan" (the whole decode in one kernel
    # launch on the card); "stride" is deterministic, so it cannot collect
    decode_mode: str = "cached"
    device: str = "cuda"

    @property
    def episodes(self) -> int:
        return int(self.num_env_steps) // self.episode_length // self.n_rollout_threads


def _parse_bool(s: str) -> bool:
    low = s.lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def _add_dataclass_args(parser: argparse.ArgumentParser, dc) -> None:
    for f in dataclasses.fields(dc):
        default = getattr(dc, f.name)
        if isinstance(default, bool):
            parser.add_argument("--" + f.name, type=_parse_bool, default=default)
        elif default is None:
            parser.add_argument("--" + f.name, default=None)
        else:
            parser.add_argument("--" + f.name, type=type(default), default=default)


def parse_cli(argv=None) -> tuple[RunConfig, PPOConfig]:
    """Strict CLI over :class:`RunConfig` and :class:`PPOConfig`."""
    run, ppo, _ = parse_cli_with_extras(argv)
    return run, ppo


def parse_cli_with_extras(argv=None, extras: argparse.ArgumentParser | None = None,
                          overrides: dict | None = None):
    """:func:`parse_cli` plus an entry point's own flags (``extras``, a
    parser built with ``add_help=False``) and its own defaults for run
    fields (``overrides``), as ``mat_dcml_tpu/config.py::parse_cli_with_extras``.
    Returns ``(run, ppo, namespace)``; unknown flags raise."""
    run, ppo = dataclasses.replace(RunConfig(), **(overrides or {})), PPOConfig()
    parser = argparse.ArgumentParser(description="mat_dcml_tpu_torch trainer", allow_abbrev=False,
                                     parents=[] if extras is None else [extras])
    _add_dataclass_args(parser, run)
    _add_dataclass_args(parser, ppo)
    ns = parser.parse_args(argv)  # strict: unknown flags raise
    return (RunConfig(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(RunConfig)}),
            PPOConfig(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(PPOConfig)}),
            ns)
