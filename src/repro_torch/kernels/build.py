"""Build and load the port's CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` — no PyTorch headers, so
a build takes seconds. Libraries go under ``build/repro_torch_kernels/`` at
the repository root, named by a hash of their sources and flags: a changed
source rebuilds at its next use, and a fresh checkout builds everything on
first use. Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

from repro_torch import telemetry

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
SOURCES = ("weighted_agg", "quantize", "conv3x3")
# no --use_fast_math: the kernels rely on IEEE division and rintf
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels cannot be built")
    return str(path)


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its sources' hash."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[Path, str]]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes started together. Returns ``{name: (library, compiler
    output)}``; a library built earlier returns the output kept beside
    it. Raises with the compiler's output if any build fails. Recorded
    in the telemetry's process record: a ``kernels.build`` span, and
    the counters ``nvcc_builds`` and ``library_hits``, one each per
    source, also under ``<counter>.<name>``."""
    with telemetry.process_span("kernels.build"):
        return _build(names)


def _build(names: Iterable[str]) -> Dict[str, Tuple[Path, str]]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    procs = {}
    out: Dict[str, Tuple[Path, str]] = {}
    for name in names:
        if name not in SOURCES:
            raise ValueError(f"unknown kernel source {name!r}")
        path = library_path(name)
        if path.exists():
            telemetry.process_count("library_hits")
            telemetry.process_count(f"library_hits.{name}")
            log = path.with_suffix(".log")
            out[name] = (path, log.read_text() if log.exists() else "")
            continue
        compiler = compiler or nvcc()
        telemetry.process_count("nvcc_builds")
        telemetry.process_count(f"nvcc_builds.{name}")
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)      # atomic: concurrent builders agree
        out[name] = (path, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    path, _ = build((name,))[name]
    lib = ctypes.CDLL(str(path))
    lib.fedcd_error_string.argtypes = [ctypes.c_int]
    lib.fedcd_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = lib.fedcd_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")
