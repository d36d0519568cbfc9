"""SMAC map registry (``starcraft2/smac_maps.py`` ``map_param_registry``).

The port's own copy of ``mat_dcml_tpu/envs/smac/maps.py`` (the port imports
nothing of the JAX package): team compositions and the episode limit of each
map, and the simplified unit stats the SMAC-lite combat stand-in
(:mod:`~mat_dcml_tpu_torch.envs.smac.smaclite`) reads.  ``unit_types`` and
``unit_type_bits`` drive the obs and state layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# unit type id -> (health, shield, damage, cooldown_steps, melee)
UNIT_STATS: Dict[str, Tuple[float, float, float, int, bool]] = {
    "marine": (45.0, 0.0, 6.0, 1, False),
    "marauder": (125.0, 0.0, 10.0, 2, False),
    "medivac": (150.0, 0.0, 0.0, 1, False),
    "stalker": (80.0, 80.0, 13.0, 2, False),
    "zealot": (100.0, 50.0, 16.0, 2, True),
    "colossus": (200.0, 150.0, 24.0, 3, False),
    "zergling": (35.0, 0.0, 5.0, 1, True),
    "baneling": (30.0, 0.0, 16.0, 1, True),
    "hydralisk": (80.0, 0.0, 12.0, 1, False),
}


@dataclasses.dataclass(frozen=True)
class MapParams:
    name: str
    agents: Tuple[str, ...]          # ally unit types, one per agent
    enemies: Tuple[str, ...]
    limit: int                       # episode step limit
    map_size: Tuple[float, float] = (32.0, 32.0)

    @property
    def n_agents(self) -> int:
        return len(self.agents)

    @property
    def n_enemies(self) -> int:
        return len(self.enemies)

    @property
    def unit_types(self) -> Tuple[str, ...]:
        """Distinct types on the map, sorted: the one-hot layout."""
        return tuple(sorted(set(self.agents) | set(self.enemies)))

    @property
    def unit_type_bits(self) -> int:
        """0 when homogeneous, else the one-hot width (``smac_maps.py`` field)."""
        n = len(self.unit_types)
        return 0 if n == 1 else n


def _m(n: int) -> Tuple[str, ...]:
    return ("marine",) * n


map_param_registry: Dict[str, MapParams] = {
    "2m": MapParams("2m", _m(2), _m(2), limit=40),
    "3m": MapParams("3m", _m(3), _m(3), limit=60),
    "8m": MapParams("8m", _m(8), _m(8), limit=120),
    "25m": MapParams("25m", _m(25), _m(25), limit=150),
    "5m_vs_6m": MapParams("5m_vs_6m", _m(5), _m(6), limit=70),
    "8m_vs_9m": MapParams("8m_vs_9m", _m(8), _m(9), limit=120),
    "10m_vs_11m": MapParams("10m_vs_11m", _m(10), _m(11), limit=150),
    "27m_vs_30m": MapParams("27m_vs_30m", _m(27), _m(30), limit=180),
    "2s3z": MapParams(
        "2s3z", ("stalker",) * 2 + ("zealot",) * 3,
        ("stalker",) * 2 + ("zealot",) * 3, limit=120,
    ),
    "3s5z": MapParams(
        "3s5z", ("stalker",) * 3 + ("zealot",) * 5,
        ("stalker",) * 3 + ("zealot",) * 5, limit=150,
    ),
    "MMM": MapParams(
        "MMM", ("medivac",) + ("marauder",) * 2 + ("marine",) * 7,
        ("medivac",) + ("marauder",) * 2 + ("marine",) * 7, limit=150,
    ),
}


def get_map_params(name: str) -> MapParams:
    try:
        return map_param_registry[name]
    except KeyError:
        raise KeyError(
            f"unknown SMAC map {name!r}; known: {sorted(map_param_registry)}"
        ) from None
