"""Build-and-load for the port's C++ data-plane libraries.

Counterpart of `elasticdl_tpu/data/nativelib.py`, with the same surface
(`NATIVE_DIR`, `build_shared`, `load_shared`), which `data/parsing.py`
(`load_shared("batch_parse")`) and `data/recordio.py` (`build_shared`)
call as they call the reference's. The sources are the port's own copies
under `data/native/`. What differs is where a library lands: the
reference builds `lib<name>.so` beside its source, the port builds every
native library into the git-ignored `build/elasticdl_tpu_torch/` at the
repository root (beside the CUDA kernels, see `ops/native.py`), under a
name that carries a hash of the source and the flags. So an edited
source is never served from a stale build, and no library is ever loaded
from the reference's tree. A build runs at first use, writes to a
temporary name and renames it into place, so concurrent master and
worker processes never load a half-written library. With no `g++`, the
callers take their pure-Python twins, as the reference's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional

from elasticdl_tpu_torch.common.log_utils import default_logger

logger = default_logger(__name__)

NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "elasticdl_tpu_torch")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_build_failed: Dict[str, bool] = {}


def built_path(src: str, lib_path: str) -> str:
    """Where the library `lib_path` names is built from `src`:
    `BUILD_DIR/<lib stem>-<hash of source and flags>.so`."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(lib_path))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest}.so")


def build_shared(src: str, lib_path: str, force: bool = False) -> Optional[str]:
    """Compile `src` with g++ into the build directory (`lib_path` names
    the library; see `built_path`) unless a current build is there.
    Returns the built library's path, or None when none can be produced.
    A failed build is remembered per library, so N opens do not pay N
    compiles."""
    try:
        out = built_path(src, lib_path)
    except OSError as e:
        logger.warning("native source %s unreadable (%s); pure-python path",
                       src, e)
        return None
    with _lock:
        if os.path.exists(out) and not force:
            return out
        if _build_failed.get(out) and not force:
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            # the module lock serializes this one-time compile (N
            # concurrent opens pay one build, not N):
            # edl-lint: disable=EDL103
            subprocess.run(
                ["g++", *CXX_FLAGS, src, "-o", tmp],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, out)
            logger.info("built native library: %s", out)
            _build_failed[out] = False
            return out
        except (subprocess.SubprocessError, FileNotFoundError, OSError) as e:
            _build_failed[out] = True
            logger.warning("native build failed for %s (%s); pure-python path",
                           src, e)
            return None
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass


def load_shared(name: str, force_build: bool = False) -> Optional[ctypes.CDLL]:
    """Build (if needed) and dlopen native/<name>.cc."""
    src = os.path.join(NATIVE_DIR, f"{name}.cc")
    path = build_shared(src, os.path.join(NATIVE_DIR, f"lib{name}.so"),
                        force=force_build)
    if path is None:
        return None
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        logger.warning("dlopen(%s) failed: %s", path, e)
        return None
