"""The port stands alone: it imports without jax, names no module of the
JAX package, runs on the card unless asked for the CPU, and never falls
back from a CUDA tensor to a plain version."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import pipelinedp_tpu_torch as tdp
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch import pipeline_backend

pytestmark = pytest.mark.torch_port

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "pipelinedp_tpu_torch"


def port_sources():
    return sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_package_imports_with_jax_blocked():
    modules = sorted(
        "pipelinedp_tpu_torch." +
        ".".join(p.relative_to(PACKAGE).with_suffix("").parts)
        for p in PACKAGE.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "sys.modules['pipelinedp_tpu'] = None\n"
            "import importlib, pipelinedp_tpu_torch\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "pipelinedp_tpu"), (
                f"{path.name}:{node.lineno} imports {name}")


def test_backend_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdp.TorchBackend()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdp.TorchBackend(device="cuda")
    backend = tdp.TorchBackend(device="cpu")
    assert backend.device.type == "cpu"
    assert backend.dtype == torch.float32


def test_backend_defaults_to_cuda_when_present(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert pipeline_backend.TorchBackend().device == torch.device("cuda")


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    kernels.reset_launch_counts()
    n = 64
    pid = torch.arange(n, dtype=torch.int32) % 7
    pk = torch.arange(n, dtype=torch.int32) % 5
    valid = torch.ones(n, dtype=torch.bool)
    k1, k2, u = kernels.row_keys(pid, pk, valid,
                                 np.array([1, 2, 3, 4], np.uint32),
                                 np.array([0, 9], np.uint32), 5,
                                 torch.float32)
    assert k1.dtype == k2.dtype == torch.int64 and u.dtype == torch.float32
    assert all(v == 0 for v in kernels.launch_counts.values())
    with pytest.raises(ValueError, match="expected contiguous"):
        kernels.row_keys(pid.long(), pk, valid, np.zeros(4, np.uint32),
                         np.zeros(2, np.uint32), 5, torch.float32)


def test_mixed_devices_raise_instead_of_falling_back():
    t = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="one device type"):
        kernels.row_keys(t, torch.zeros(4, dtype=torch.int32),
                         torch.ones(4, dtype=torch.bool),
                         np.zeros(4, np.uint32), np.zeros(2, np.uint32), 5,
                         torch.float32)


def test_chip_smoke_fails_without_cuda_and_without_the_repo(tmp_path):
    # chip_smoke.py alone in a directory, on a machine without a card:
    # it must exit non-zero and print no result.
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
