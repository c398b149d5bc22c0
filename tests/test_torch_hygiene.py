"""Boundaries of the torch port: it imports nothing of JAX or of the JAX
package, it never picks the CPU on its own, and every kernel source says
what it replaces."""

import ast
from pathlib import Path

import pytest
import torch

import oceanbase_tpu_torch
from oceanbase_tpu_torch import kernels

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "oceanbase_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "oceanbase_tpu" or name.startswith("oceanbase_tpu."))


PY_FILES = sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")) \
    + ["chip_smoke.py"]


@pytest.mark.parametrize("rel", PY_FILES)
def test_no_jax_or_reference_imports(rel):
    bad = [n for n in _imports(ROOT / rel) if _forbidden(n)]
    assert not bad, f"{rel} imports {bad}"


def test_scan_sees_every_module():
    assert len(PY_FILES) >= 25
    assert "oceanbase_tpu_torch/engine/executor.py" in PY_FILES


def test_session_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from oceanbase_tpu_torch.engine.session import Session

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oceanbase_tpu_torch.device(None)


def test_explicit_devices_are_taken_as_given():
    assert oceanbase_tpu_torch.device("cpu") == torch.device("cpu")
    assert oceanbase_tpu_torch.device("cuda") == torch.device("cuda", 0)
    assert oceanbase_tpu_torch.device("cuda:1") == torch.device("cuda", 1)


@pytest.mark.parametrize("src", kernels.SOURCES)
def test_kernel_sources_name_what_they_replace(src):
    text = (PORT / "csrc" / src).read_text()
    head = text.split("#include", 1)[0]
    assert "Replaces oceanbase_tpu/" in head
    assert "Bound on an H100" in head
    assert "Design:" in head


def test_kernel_names_match_launch_counters():
    assert tuple(kernels.LAUNCHES) == kernels.KERNEL_NAMES
    kernels.reset_launches()
    assert all(v == 0 for v in kernels.LAUNCHES.values())
