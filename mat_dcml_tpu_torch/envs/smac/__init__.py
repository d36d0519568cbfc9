"""SMAC: the map registry, the SMAC-lite combat stand-in and the multi-map
feature translation, batched over envs on one device."""

from mat_dcml_tpu_torch.envs.smac.maps import MapParams, get_map_params, map_param_registry
from mat_dcml_tpu_torch.envs.smac.smaclite import SMACLiteConfig, SMACLiteEnv, SMACTimeStep
from mat_dcml_tpu_torch.envs.smac.translation import (
    TARGET_ACTION_DIM,
    TARGET_NUM_AGENT,
    TASK_EMBEDDING_DIM,
    TranslatedSMACEnv,
    gen_task_embedding,
)

__all__ = [
    "MapParams",
    "get_map_params",
    "map_param_registry",
    "SMACLiteConfig",
    "SMACLiteEnv",
    "SMACTimeStep",
    "TranslatedSMACEnv",
    "gen_task_embedding",
    "TARGET_ACTION_DIM",
    "TARGET_NUM_AGENT",
    "TASK_EMBEDDING_DIM",
]
