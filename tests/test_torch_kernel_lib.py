"""The port's kernel build (``ops/kernel_lib.py``) without a CUDA toolkit: a
stand-in ``nvcc`` on PATH records its calls and writes the output file, so
the hashing, caching, failure and clean-up paths run on the CPU."""

import os
import stat

import pytest

from mat_dcml_tpu_torch.ops import kernel_lib

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
for src; do :; done
case "$src" in *broken.cu) echo "error: broken.cu(1): expected a ';'"; exit 2;; esac
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo built > "$2"; fi
  shift
done
echo "ptxas info    : Used 40 registers"
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    src, build, bin_dir = tmp_path / "csrc", tmp_path / "_build", tmp_path / "bin"
    src.mkdir()
    bin_dir.mkdir()
    log = tmp_path / "nvcc_calls.txt"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(kernel_lib, "SRC_DIR", src)
    monkeypatch.setattr(kernel_lib, "BUILD_DIR", build)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    return src, build, log


def _calls(log):
    return log.read_text().splitlines() if log.exists() else []


def test_build_all_builds_every_source_once(fake_toolchain):
    src, build, log = fake_toolchain
    for name in ("a", "b", "c"):
        (src / f"{name}.cu").write_text(f"// {name}\n")
    logs = kernel_lib.build_all()
    assert sorted(logs) == ["a", "b", "c"] and all("registers" in v for v in logs.values())
    assert len(_calls(log)) == 3
    assert kernel_lib.build_all() == {"a": None, "b": None, "c": None}   # all cached
    (src / "broken.cu").write_text("x\n")
    with pytest.raises(RuntimeError, match="broken.cu"):
        kernel_lib.build_all()


def test_builds_each_source_once_and_caches_by_hash(fake_toolchain):
    src, build, log = fake_toolchain
    (src / "a.cu").write_text("// a\n")
    (src / "b.cu").write_text("// b\n")
    assert kernel_lib.sources() == ["a", "b"]
    for name in ("a", "b"):
        assert "registers" in kernel_lib.build(name)
        assert kernel_lib.library_path(name).read_text() == "built\n"
    calls = _calls(log)
    assert len(calls) == 2 and all("arch=compute_90a,code=sm_90a" in c for c in calls)
    assert kernel_lib.build("a") is None     # unchanged source: nothing rebuilt
    assert len(_calls(log)) == 2
    old = kernel_lib.library_path("a")
    (src / "a.cu").write_text("// a, edited\n")
    assert kernel_lib.library_path("a") != old
    assert kernel_lib.build("a") is not None  # the changed source rebuilds
    assert kernel_lib.build("b") is None
    assert len(_calls(log)) == 3
    assert not list(build.glob("*.tmp"))


def test_compiler_error_raises_with_its_output(fake_toolchain):
    src, build, _ = fake_toolchain
    (src / "broken.cu").write_text("int x\n")
    with pytest.raises(RuntimeError, match="expected a ';'"):
        kernel_lib.build("broken")
    assert not kernel_lib.library_path("broken").exists()
    assert not list(build.glob("*.tmp"))


def test_missing_nvcc_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit at its default path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel_lib.nvcc_path()
