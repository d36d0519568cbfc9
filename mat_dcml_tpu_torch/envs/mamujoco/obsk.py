"""Joint-graph factorization for multi-agent MuJoCo (``obsk.py`` parity).

The port's copy of ``mat_dcml_tpu/envs/mamujoco/obsk.py``, which uses no
framework: plain Python over joint indices, so both packages build the same
partitions and obs indices.

The reference factorizes a single MuJoCo robot into agents by partitioning
its actuated joints and builds per-agent observations from the k-hop
neighborhood of each agent's joints in the kinematic graph
(``ma_mujoco/multiagent_mujoco/obsk.py``: ``Node``/``HyperEdge`` +
``get_joints_at_kdist`` + ``build_obs``).  This module is the idiomatic
re-design: a plain joint graph with integer adjacency, robot definitions as
data, and the k-hop computation returning *index arrays* — ready to gather
``qpos``/``qvel`` slices as one vectorized take, both for the gated real-gym
adapter and the pure-JAX stand-in.

Supported (scenario, agent_conf) pairs mirror the reference registry
(``obsk.py:273-470``): HalfCheetah 2x3/6x1, Ant 2x4/2x4d/4x2/8x1, Hopper 3x1,
Walker2d 2x3/6x1, Swimmer 2x1, Reacher 2x1, Humanoid(Standup) 9|8 — plus the
scalable configs (``obsk.py:512-663``): manyagent_swimmer NxK (N agents x K
chained rotor segments each, asset auto-generated in the reference,
``manyagent_swimmer.py``), manyagent_ant NxK (K 4-joint leg segments per
agent, ``manyagent_ant.py``), coupled_half_cheetah 1p1 (two tendon-coupled
cheetahs, ``coupled_half_cheetah.py:1-43``).

Corrections vs the reference's registry: its manyagent_ant entry is marked
"TODO: FIX!" and computes non-negative "negative" qpos offsets for all but
the last segment, and its coupled_half_cheetah gives BOTH cheetahs the same
actuator ids 0-5; here every joint gets its true absolute qpos/qvel/actuator
index (second cheetah acts on 6-11).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Joint:
    """One actuated joint: indices into qpos/qvel/action vectors."""

    name: str
    qpos_id: int
    qvel_id: int
    act_id: int


@dataclasses.dataclass(frozen=True)
class RobotGraph:
    """Kinematic graph over actuated joints + free global coordinates."""

    name: str
    joints: Tuple[Joint, ...]
    edges: Tuple[Tuple[int, int], ...]      # joint-index pairs (kinematic links)
    # global (root) obs indices shared by all agents: (qpos ids, qvel ids)
    global_qpos: Tuple[int, ...]
    global_qvel: Tuple[int, ...]

    def neighbors(self, j: int) -> List[int]:
        out = []
        for a, b in self.edges:
            if a == j:
                out.append(b)
            elif b == j:
                out.append(a)
        return out


def _chain(names: Sequence[str], qpos0: int, qvel0: int,
           global_qpos: Sequence[int], global_qvel: Sequence[int],
           extra_edges: Sequence[Tuple[int, int]] = ()) -> RobotGraph:
    joints = tuple(
        Joint(n, qpos0 + i, qvel0 + i, i) for i, n in enumerate(names)
    )
    edges = tuple((i, i + 1) for i in range(len(names) - 1)) + tuple(extra_edges)
    return RobotGraph("chain", joints, edges, tuple(global_qpos), tuple(global_qvel))


def _legged(leg_names: Sequence[Sequence[str]], qpos0: int, qvel0: int,
            global_qpos: Sequence[int], global_qvel: Sequence[int]) -> RobotGraph:
    """Legs radiating from a torso: joints chained within a leg, first joints
    of all legs mutually connected through the torso."""
    joints: List[Joint] = []
    edges: List[Tuple[int, int]] = []
    firsts: List[int] = []
    i = 0
    for leg in leg_names:
        firsts.append(i)
        for k, n in enumerate(leg):
            joints.append(Joint(n, qpos0 + i, qvel0 + i, i))
            if k > 0:
                edges.append((i - 1, i))
            i += 1
    for a in range(len(firsts)):
        for b in range(a + 1, len(firsts)):
            edges.append((firsts[a], firsts[b]))
    return RobotGraph("legged", tuple(joints), tuple(edges),
                      tuple(global_qpos), tuple(global_qvel))


def _robot(scenario: str) -> RobotGraph:
    s = scenario.lower().split("-")[0]
    if s in ("halfcheetah", "half_cheetah"):
        # qpos: [rootx, rootz, rooty, bthigh, bshin, bfoot, fthigh, fshin, ffoot]
        return _chain(
            ["bthigh", "bshin", "bfoot", "fthigh", "fshin", "ffoot"],
            qpos0=3, qvel0=3, global_qpos=[1, 2], global_qvel=[0, 1, 2],
            extra_edges=[(0, 3)],           # back/front hips meet at the torso
        )
    if s == "walker2d":
        return _chain(
            ["thigh", "leg", "foot", "thigh_left", "leg_left", "foot_left"],
            qpos0=3, qvel0=3, global_qpos=[1, 2], global_qvel=[0, 1, 2],
            extra_edges=[(0, 3)],
        )
    if s == "hopper":
        return _chain(["thigh", "leg", "foot"], qpos0=3, qvel0=3,
                      global_qpos=[1, 2], global_qvel=[0, 1, 2])
    if s == "swimmer":
        return _chain(["rot2", "rot3"], qpos0=3, qvel0=3,
                      global_qpos=[2], global_qvel=[0, 1, 2])
    if s == "reacher":
        return _chain(["joint0", "joint1"], qpos0=0, qvel0=0,
                      global_qpos=[], global_qvel=[])
    if s == "ant":
        # qpos: 7 root dofs then 2 per leg (hip, ankle) x 4 legs
        return _legged(
            [["hip1", "ankle1"], ["hip2", "ankle2"],
             ["hip3", "ankle3"], ["hip4", "ankle4"]],
            qpos0=7, qvel0=6, global_qpos=[2, 3, 4, 5, 6], global_qvel=[0, 1, 2, 3, 4, 5],
        )
    if s in ("humanoid", "humanoidstandup"):
        return _legged(
            [["abdomen_z", "abdomen_y", "abdomen_x"],
             ["right_hip_x", "right_hip_z", "right_hip_y", "right_knee"],
             ["left_hip_x", "left_hip_z", "left_hip_y", "left_knee"],
             ["right_shoulder1", "right_shoulder2", "right_elbow"],
             ["left_shoulder1", "left_shoulder2", "left_elbow"]],
            qpos0=7, qvel0=6, global_qpos=[2, 3, 4, 5, 6], global_qvel=[0, 1, 2, 3, 4, 5],
        )
    raise KeyError(f"unknown scenario {scenario!r}")


def _manyagent_swimmer(n_segs: int) -> RobotGraph:
    """Chain of ``n_segs`` actuated rotors (one per body segment); the
    generated asset's qpos/qvel are [slide x, slide y, rot_0..rot_{n-1}]
    (``manyagent_swimmer.py:28-62``; registry ``obsk.py:568-586`` — its rot_i
    at qpos ``-n_segs+i`` == absolute ``2+i`` here).  The reference registry
    has empty globals for this robot, kept as-is."""
    joints = tuple(
        Joint(f"rot{i}", 2 + i, 2 + i, i) for i in range(n_segs)
    )
    edges = tuple((i, i + 1) for i in range(n_segs - 1))
    return RobotGraph("manyagent_swimmer", joints, edges, (), ())


def _manyagent_ant(n_segs: int) -> RobotGraph:
    """``n_segs`` torso segments, each with two 2-joint legs
    (hip1/ankle1/hip2/ankle2): qpos = 7 free-root dofs then 4 rotors per
    segment; actuator order per segment is (hip2, ankle2, hip1, ankle1) as in
    the reference's Node act ids (``obsk.py:588-656``).  Edges: ankle-hip
    within each leg, hips joined through the segment torso, and consecutive
    segments' hips linked (the reference's 4-ary HyperEdge, here as pairs)."""
    joints: List[Joint] = []
    edges: List[Tuple[int, int]] = []
    for si in range(n_segs):
        base = 4 * si
        # (name, qpos offset within segment, act id) — qpos order follows the
        # generated asset's body order, actuators the reference's Node ids
        joints.append(Joint(f"hip1_{si}", 7 + base, 6 + base, 2 + base))
        joints.append(Joint(f"ankle1_{si}", 7 + base + 1, 6 + base + 1, 3 + base))
        joints.append(Joint(f"hip2_{si}", 7 + base + 2, 6 + base + 2, 0 + base))
        joints.append(Joint(f"ankle2_{si}", 7 + base + 3, 6 + base + 3, 1 + base))
        h1, a1, h2, a2 = base, base + 1, base + 2, base + 3
        edges += [(a1, h1), (a2, h2), (h1, h2)]
        if si:
            prev_h1, prev_h2 = base - 4, base - 2
            edges += [(prev_h1, h1), (prev_h2, h2)]
    return RobotGraph(
        "manyagent_ant", tuple(joints), tuple(edges),
        global_qpos=(2, 3, 4, 5, 6), global_qvel=(0, 1, 2, 3, 4, 5),
    )


def _coupled_half_cheetah() -> RobotGraph:
    """Two half cheetahs coupled by a tendon between their back thighs
    (``coupled_half_cheetah.py:1-43``; registry ``obsk.py:512-566``).
    qpos = [root1 x/z/y, 6 joints, root2 x/z/y, 6 joints]; the tendon is an
    edge linking the two bthighs so k-hop obs can see across robots.
    Globals carry BOTH roots (the reference's registry exposes only cheetah
    1's root, leaving agent 2 blind to its own body height/velocity — kept
    corrected here alongside the actuator-id fix in the module docstring)."""
    names = ["bthigh", "bshin", "bfoot", "fthigh", "fshin", "ffoot"]
    joints = tuple(
        [Joint(n, 3 + i, 3 + i, i) for i, n in enumerate(names)]
        + [Joint(n + "2", 12 + i, 12 + i, 6 + i) for i, n in enumerate(names)]
    )
    chain = [(0, 1), (1, 2), (0, 3), (3, 4), (4, 5)]
    edges = tuple(chain + [(a + 6, b + 6) for a, b in chain] + [(0, 6)])
    return RobotGraph(
        "coupled_half_cheetah", joints, edges,
        global_qpos=(1, 2, 10, 11), global_qvel=(0, 1, 2, 9, 10, 11),
    )


def get_parts_and_edges(
    scenario: str, agent_conf: str
) -> Tuple[Tuple[Tuple[int, ...], ...], RobotGraph]:
    """(scenario, '2x3') -> (agent partitions as joint-index tuples, graph).

    ``agent_conf`` is "<n_agents>x<joints_per_agent>"; joints are dealt out in
    graph order except the Ant's special splits (``obsk.py:321-327``): "2x4"
    pairs neighbouring legs, "2x4d" pairs diagonal legs.  The scalable
    scenarios read it differently: manyagent_swimmer NxK = K rotor segments
    per agent, manyagent_ant NxK = K four-joint leg segments per agent,
    coupled_half_cheetah "1p1" = one agent per cheetah.
    """
    s = scenario.lower().split("-")[0]
    if s == "manyagent_swimmer":
        n_agents, per = _parse_conf(agent_conf)
        graph = _manyagent_swimmer(n_agents * per)
        parts = tuple(
            tuple(range(a * per, (a + 1) * per)) for a in range(n_agents)
        )
        return parts, graph
    if s == "manyagent_ant":
        n_agents, per = _parse_conf(agent_conf)
        graph = _manyagent_ant(n_agents * per)
        jper = 4 * per                       # 4 joints per leg segment
        parts = tuple(
            tuple(range(a * jper, (a + 1) * jper)) for a in range(n_agents)
        )
        return parts, graph
    if s == "coupled_half_cheetah":
        if agent_conf != "1p1":
            raise ValueError(
                f"coupled_half_cheetah supports agent_conf '1p1' only "
                f"(obsk.py:556-561), got {agent_conf!r}"
            )
        graph = _coupled_half_cheetah()
        return ((0, 1, 2, 3, 4, 5), (6, 7, 8, 9, 10, 11)), graph

    graph = _robot(scenario)
    n_joints = len(graph.joints)
    if scenario.lower().startswith("ant") and agent_conf == "2x4d":
        parts: Tuple[Tuple[int, ...], ...] = ((0, 1, 4, 5), (2, 3, 6, 7))
        return parts, graph
    n_agents, per = _parse_conf(agent_conf)
    if n_agents * per != n_joints:
        raise ValueError(
            f"{scenario}: {agent_conf} does not tile {n_joints} joints"
        )
    parts = tuple(
        tuple(range(a * per, (a + 1) * per)) for a in range(n_agents)
    )
    return parts, graph


def _parse_conf(agent_conf: str) -> Tuple[int, int]:
    try:
        n_agents, per = (int(x) for x in agent_conf.split("x"))
    except ValueError:
        raise ValueError(f"agent_conf {agent_conf!r} is not '<n>x<k>'") from None
    if n_agents < 1 or per < 1:
        raise ValueError(f"agent_conf {agent_conf!r}: both factors must be >= 1")
    return n_agents, per


def joints_at_kdist(graph: RobotGraph, partition: Sequence[int], k: int) -> List[List[int]]:
    """BFS shells: [joints at distance 0 (own), 1, ..., k] from the agent's
    joints (``get_joints_at_kdist``)."""
    seen = set(partition)
    shells = [sorted(partition)]
    frontier = list(partition)
    for _ in range(k):
        nxt = []
        for j in frontier:
            for nb in graph.neighbors(j):
                if nb not in seen:
                    seen.add(nb)
                    nxt.append(nb)
        shells.append(sorted(set(nxt)))
        frontier = nxt
    return shells


def build_obs_indices(
    graph: RobotGraph, partition: Sequence[int], k: int
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Gather indices (qpos_ids, qvel_ids) for one agent's k-hop obs:
    shell-ordered joint features then the shared globals (``build_obs``)."""
    qpos: List[int] = []
    qvel: List[int] = []
    for shell in joints_at_kdist(graph, partition, k):
        for j in shell:
            qpos.append(graph.joints[j].qpos_id)
            qvel.append(graph.joints[j].qvel_id)
    qpos.extend(graph.global_qpos)
    qvel.extend(graph.global_qvel)
    return tuple(qpos), tuple(qvel)
