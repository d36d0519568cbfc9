"""The port and ``chip_smoke.py`` stand alone: no JAX, no flax, nothing of
the JAX package — neither in their source nor in what importing them loads."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|mat_dcml_tpu)\b(?!_torch)|from\s+(jax|flax|mat_dcml_tpu)\b(?!_torch))",
    re.MULTILINE,
)


def _sources():
    files = sorted((ROOT / "mat_dcml_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def test_no_jax_imports_in_port_source():
    for path in _sources():
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def _modules():
    pkg = ROOT / "mat_dcml_tpu_torch"
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                  for p in pkg.rglob("*.py"))


def test_importing_the_port_loads_no_jax():
    mods = _modules()
    assert {"mat_dcml_tpu_torch.training.ppo", "mat_dcml_tpu_torch.envs.dcml.env",
            "mat_dcml_tpu_torch.train_dcml", "mat_dcml_tpu_torch.ops.decode_step",
            "mat_dcml_tpu_torch.envs.mamujoco.lite", "mat_dcml_tpu_torch.envs.mamujoco.obsk",
            "mat_dcml_tpu_torch.training.mujoco_runner", "mat_dcml_tpu_torch.train_mujoco",
            "mat_dcml_tpu_torch.probes.cache_layout", "mat_dcml_tpu_torch.envs.smac.maps",
            "mat_dcml_tpu_torch.envs.smac.smaclite", "mat_dcml_tpu_torch.envs.smac.translation",
            "mat_dcml_tpu_torch.envs.permute", "mat_dcml_tpu_torch.training.smac_runner",
            "mat_dcml_tpu_torch.train_smac", "mat_dcml_tpu_torch.train_smac_multi",
            "mat_dcml_tpu_torch.envs.spaces", "mat_dcml_tpu_torch.envs.dcml.joint",
            "mat_dcml_tpu_torch.envs.dcml.per_agent", "mat_dcml_tpu_torch.models.bases",
            "mat_dcml_tpu_torch.models.act_layer", "mat_dcml_tpu_torch.models.actor_critic",
            "mat_dcml_tpu_torch.ops.popart", "mat_dcml_tpu_torch.training.ac_rollout",
            "mat_dcml_tpu_torch.training.mappo", "mat_dcml_tpu_torch.training.ippo",
            "mat_dcml_tpu_torch.training.happo"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'mat_dcml_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
