"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles alone into a shared library with a plain
``extern "C"`` interface; no source includes PyTorch's headers, so a build
takes seconds and needs neither ``ninja`` nor ``torch.utils.cpp_extension``.
Libraries go to ``mat_dcml_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source and the flags: a changed source rebuilds, an
unchanged one loads at once.  A file lock per source keeps concurrent
processes from building the same library twice, and lets different sources
build at the same time.

Nothing here runs at import: the tests import every module on machines with
no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers, shared memory and spills per kernel, in the build log
)
NVCC_TIMEOUT_S = 600

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "build only on a machine with the CUDA toolkit"
        )
    return path


def sources() -> list:
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Optional[str]:
    """Build ``csrc/<name>.cu`` unless it is built already.

    Returns the build log (seconds, then ``nvcc``'s output) when this call
    built it, else None.  Raises with the compiler's output when it fails.
    """
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".lock-{name}", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return None
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True, timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{proc.stdout}")
            os.replace(tmp, out)
        finally:
            if tmp.exists():
                tmp.unlink()
    return f"{time.perf_counter() - t0:.1f}s\n{proc.stdout}"


def build_all() -> Dict[str, Optional[str]]:
    """Build every ``csrc/*.cu`` at once, one ``nvcc`` per source, all
    started together; returns each source's :func:`build` log.  Raises the
    first failure after every build has ended."""
    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(build, name) for name in names}
    return {name: fut.result() for name, fut in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        if name not in _loaded:
            build(name)
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]
