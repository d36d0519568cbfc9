"""Multi-agent MuJoCo: the obsk joint-graph factorization and the lite
stand-in dynamics, batched over envs on one device."""

from mat_dcml_tpu_torch.envs.mamujoco.lite import MJLiteConfig, MJLiteEnv

__all__ = ["MJLiteConfig", "MJLiteEnv"]
