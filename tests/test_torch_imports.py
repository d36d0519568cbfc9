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


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import mat_dcml_tpu_torch, mat_dcml_tpu_torch.bridge\n"
        "import mat_dcml_tpu_torch.serving.engine, mat_dcml_tpu_torch.serving.batcher\n"
        "import mat_dcml_tpu_torch.ops.cuda_attention, mat_dcml_tpu_torch.ops.kernel_lib\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'mat_dcml_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
