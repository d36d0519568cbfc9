"""Train on the DCML worker-selection env with the PyTorch port.

The port's counterpart of the repository's ``train_dcml.py``: the same
recipe and flags (for what the port supports), plus ``--device`` (default
``cuda``; raises when no card is present).  ``--algorithm_name``: ``mat``
(the default), ``mat_dec`` (MAT-Dec), ``momat`` (MO-MAT), ``dmomat``
(MO-MAT with per-episode preference weights), the feed-forward
actor-critic baselines ``ppo`` (centralised, over the joint action),
``mappo``, ``ippo``, ``happo`` and ``hatrpo`` (``--n_embd`` is their hidden
width), or ``random``; the recurrent ``rmappo``, ``rhappo`` and
``rhatrpo`` raise ``NotImplementedError``.  Metrics
stream to ``<run_dir>/DCML/AS/<algorithm>/<experiment_name>/metrics.jsonl``
and checkpoints to
its ``models/`` every ``--save_interval`` episodes and on the last.  A
SIGTERM / SIGINT stops the run at an episode boundary with an emergency
checkpoint and exit code 75; ``--resume auto`` continues it.

Usage:
  python -m mat_dcml_tpu_torch.train_dcml                       # the recipe, on the card
  python -m mat_dcml_tpu_torch.train_dcml --device cpu --num_env_steps 32 \\
      --n_rollout_threads 4 --episode_length 4 --n_embd 16 --log_interval 1
  python -m mat_dcml_tpu_torch.train_dcml --algorithm_name momat --objective_weights 3,1
  python -m mat_dcml_tpu_torch.train_dcml --algorithm_name happo  # the HAPPO baseline
  python -m mat_dcml_tpu_torch.train_dcml --resume auto         # resume this run's models/
  python -m mat_dcml_tpu_torch.train_dcml --use_eval true --eval_interval 25
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
