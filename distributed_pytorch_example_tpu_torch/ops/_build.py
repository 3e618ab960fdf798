"""Build the CUDA kernels in ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own, with ``nvcc`` for ``sm_90a``,
into ``build/lib<name>.so`` inside this package (an ignored directory), at
first use. The sources expose plain C entry points and include no PyTorch
header, so a build takes seconds, not the minutes a
``torch.utils.cpp_extension`` build takes. :func:`build_all` starts one
``nvcc`` per source, all at once.

A missing ``nvcc`` or a failed compile raises: no caller ever falls back to
a kernel's plain version because its build failed.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install path; None when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    return None


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _library_path(name)
    src = CSRC_DIR / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def _start(nvcc: str, name: str) -> "tuple[subprocess.Popen, Path]":
    # write to a per-process temp name, then rename: concurrent builds
    # (test workers) never load a half-written library
    tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp


def build_all(names: Optional[List[str]] = None) -> List[str]:
    """Compile every stale kernel source (default: all of ``csrc/``) with
    one ``nvcc`` process each, started together. Returns the names built.
    Raises ``RuntimeError`` when ``nvcc`` is missing or a compile fails."""
    names = sources() if names is None else list(names)
    stale = [n for n in names if _stale(n)]
    if not stale:
        return []
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
            "/usr/local/cuda/bin): the CUDA kernels in "
            f"{CSRC_DIR} cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = [(n, *_start(nvcc, n)) for n in stale]
    failures = []
    for name, proc, tmp in started:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, _library_path(name))
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return stale


def load_library(name: str) -> ctypes.CDLL:
    """The ``ctypes`` handle of ``csrc/<name>.cu``, building it first if
    its library is missing or older than the source."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            _libs[name] = lib
        return lib
