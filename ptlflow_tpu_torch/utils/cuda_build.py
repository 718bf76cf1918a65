"""Build the hand-written CUDA kernels of ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` for ``sm_90a`` (Hopper) into ``_build/lib<name>-<hash>.so`` inside the
package, where ``<hash>`` is taken from the source, so an edited kernel is
rebuilt and a stale library is never loaded.  Nothing is built when the
package is imported: the first launch of a kernel builds it, and
:func:`build_all` builds every source at once, one ``nvcc`` per source, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of the kernel sources: ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _target(name: str, src: Optional[Path] = None) -> Path:
    src = CSRC / f"{name}.cu" if src is None else src
    digest = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        digest.update(hdr.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[List[str]] = None
              ) -> Dict[str, Tuple[Path, str]]:
    """Compile the named sources (default: all) that are not built yet, one
    nvcc process per source, all running at once.  Returns
    ``{name: (library path, compiler log)}``; the log holds ptxas's
    register and shared-memory report.  Raises if any build fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    results = {}
    for name in names:
        target = _target(name)
        if target.exists():
            results[name] = (target, "")
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent build sees all or none
        results[name] = (target, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return results


def build_file(src: Path) -> Path:
    """Compile a kernel source from outside ``csrc/`` (another version of a
    kernel, to time beside the built one) into ``_build/``; returns the
    library's path.  Raises if nvcc fails."""
    src = Path(src).resolve()
    target = _target(src.stem + "-ext", src)
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}")
        os.replace(tmp, target)
    return target


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, _ = build_all([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
