"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax or the reference package ``repro``, and
the entry points never move to the CPU on their own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imports(path) if _banned(mod)]
    assert not bad, f"{path}: imports {bad}"


def test_port_files_found():
    assert len(PORT_FILES) > 20
    assert (ROOT / "src" / "repro_torch" / "csrc" / "weighted_agg.cu").exists()
    assert (ROOT / "src" / "repro_torch" / "csrc" / "quantize.cu").exists()


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.core.fedcd, repro_torch.core.fedavg, "
            "repro_torch.kernels.build; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_servers_need_cuda_unless_cpu_is_asked(monkeypatch):
    import numpy as np

    from repro_torch.config import FedCDConfig
    from repro_torch.core.fedavg import FedAvgServer
    from repro_torch.core.fedcd import FedCDServer
    from repro_torch.models.mlp import (init_mlp_classifier, mlp_accuracy,
                                        mlp_loss)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = FedCDConfig(n_devices=2, devices_per_round=1)
    split = (np.zeros((2, 4, 32, 32, 3), np.float32),
             np.zeros((2, 4), np.int32))
    data = {"train": split, "val": split, "test": split}
    params = init_mlp_classifier(torch.Generator().manual_seed(0), hidden=4)
    for cls in (FedCDServer, FedAvgServer):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(cfg, params, mlp_loss, mlp_accuracy, data)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(cfg, params, mlp_loss, mlp_accuracy, data, device="cuda")
        srv = cls(cfg, params, mlp_loss, mlp_accuracy, data, device="cpu")
        assert srv.device.type == "cpu"


def test_wrappers_compute_the_plain_version_only_on_cpu(monkeypatch,
                                                        tmp_path):
    """Only CPU tensors take the plain version: any other device goes to
    the kernel or raises, and a kernel that cannot be built raises."""
    from repro_torch.kernels import build
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.weighted_agg import ops as wops

    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wops.multi_weighted_agg(torch.zeros(2, 4, **meta),
                                torch.zeros(1, 2, **meta),
                                torch.ones(1, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        qops.quantize(torch.zeros(2, 4, **meta), 8)
    monkeypatch.setattr(build, "nvcc", lambda: "/nonexistent/nvcc")
    monkeypatch.setattr(build, "library_path",
                        lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(OSError):
        build.library.__wrapped__("quantize")
