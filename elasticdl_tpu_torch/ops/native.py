"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` alone into `build/elasticdl_tpu_torch/lib<name>-<hash>.so` under
the repository root, then loaded with ctypes. Nothing here includes
PyTorch's headers, so a build takes seconds, not minutes. The file name
carries a hash of the source and the flags, so an edited kernel is never
served from a stale build; a build writes to a temporary name and renames
it into place, so concurrent builders cannot load a half-written library.

Nothing is built or loaded at import: the CPU tests import every module on
machines with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "elasticdl_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, else the one on
    PATH, else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels are built from "
        f"{CSRC} at first use")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, cmd, proc


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named kernel that has no current build, one `nvcc`
    per source, all started together. Returns {name: {"path", "seconds",
    "log"}} ("log" holds the compiler's output, register and spill counts
    included; "seconds" is 0 for a build that was already current).
    Raises if any compile fails."""
    t0 = time.perf_counter()
    started, report = {}, {}
    for name in names:
        path = library_path(name)
        if path.is_file():
            report[name] = {"path": str(path), "seconds": 0.0, "log": ""}
        else:
            started[name] = _start_build(name)
    failures = []
    for name, (out, tmp, cmd, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"path": str(out),
                        "seconds": time.perf_counter() - t0, "log": log}
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = Path(build([name])[name]["path"])
        lib = ctypes.CDLL(str(path))
        lib.edl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.edl_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise with CUDA's message when a launch returned an error code."""
    if code:
        msg = lib.edl_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
