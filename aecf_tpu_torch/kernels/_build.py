"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain ``extern "C"`` interface and is
compiled by ``nvcc`` into a shared library at first use, then loaded with
``ctypes``.  The library goes to ``build/aecf_tpu_torch/<hash>/`` beside the
package (the checkout's ``build/``, which git ignores), keyed by a hash of
the source, every ``csrc/*.cuh`` header the sources share, and the flags,
so an edited source or header rebuilds and an unchanged one is reused.
Nothing is compiled or loaded when this module is imported.
:func:`build_all` compiles several sources at once, one ``nvcc`` each.

The flags carry no ``--use_fast_math`` and no ``-ftz=true``: the entropy
epilogue floors weights at the subnormal 1e-38.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["build_all", "load_library", "library_path"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_DEFAULT_BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
                       / "aecf_tpu_torch")
_BUILD_ROOT = _DEFAULT_BUILD_ROOT  # measure.enable_persistent_cache moves it
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA "
            "kernels are compiled on the machine with the card"
        )
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: ``.../<hash>/``, the hash over
    the source, every shared ``csrc/*.cuh`` header and the flags."""
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_ROOT / digest.hexdigest()[:16] / f"lib{name}.so"


def _compile(name: str, lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
            f"{' '.join(cmd)}\n{proc.stderr}"
        )
    # ptxas -v report (registers, shared memory, spills) beside the library
    (lib.parent / f"{name}.build.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library
    (one handle per process)."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _loaded:
            lib = library_path(name)
            if not lib.exists():
                _compile(name, lib)
            _loaded[name] = ctypes.CDLL(str(lib))
        return _loaded[name]


def build_all(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Compile and load every named source, all ``nvcc`` runs at once."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        libs = list(pool.map(load_library, names))
    return dict(zip(names, libs))
