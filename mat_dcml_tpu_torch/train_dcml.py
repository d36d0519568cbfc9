"""Train MAT on the DCML worker-selection env with the PyTorch port.

The port's counterpart of the repository's ``train_dcml.py``: the same
recipe and flags (for what the port supports), plus ``--device`` (default
``cuda``; raises when no card is present).  Metrics stream to
``<run_dir>/DCML/AS/mat/<experiment_name>/metrics.jsonl``.

Usage:
  python -m mat_dcml_tpu_torch.train_dcml                       # the recipe, on the card
  python -m mat_dcml_tpu_torch.train_dcml --device cpu --num_env_steps 32 \\
      --n_rollout_threads 4 --episode_length 4 --n_embd 16 --log_interval 1
"""

from __future__ import annotations

import sys

from mat_dcml_tpu_torch.config import parse_cli
from mat_dcml_tpu_torch.training.runner import DCMLRunner


def main(argv=None):
    run, ppo = parse_cli(argv)
    runner = DCMLRunner(run, ppo)
    runner.train_loop()


if __name__ == "__main__":
    main(sys.argv[1:])
