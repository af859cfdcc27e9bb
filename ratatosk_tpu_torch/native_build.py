"""Builds the port's host libraries from the repo's native/*.cpp.

Each loader (io/native.py, ops/native_kmers.py, ops/native_align.py) asks
for its own library only. It is compiled with native/build.sh's flags into
`ratatosk_tpu_torch/build/native/` (git-ignored) and rebuilt when its
source is newer. Processes sharing a checkout may ask at once: the build
runs under an flock on a lock file beside the library, compiles to a
per-pid temp name and renames it into place, so no process ever loads a
half-written file. Nothing here writes to native/.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = _PKG_DIR.parent / "native"
BUILD_DIR = _PKG_DIR / "build" / "native"
# native/build.sh's flags
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
# name -> (source in native/, library file, link flags)
LIBRARIES = {
    "fastx": ("fastx.cpp", "libfastx.so", ["-lz"]),
    "kmers": ("kmers.cpp", "libkmers.so", ["-lpthread"]),
    "align": ("align.cpp", "libralign.so", []),
}


def _fresh(lib: Path, src: Path) -> bool:
    return lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime


def build_native(name: str) -> str:
    """The path of library `name`, built first when it is missing or older
    than its source. Raises subprocess.CalledProcessError when the compiler
    fails and OSError when there is none."""
    src_name, lib_name, link = LIBRARIES[name]
    src = SRC_DIR / src_name
    lib = BUILD_DIR / lib_name
    if _fresh(lib, src):
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{lib_name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # another process may have built it while this one waited
        if not _fresh(lib, src):
            tmp = lib.with_name(f"{lib_name}.{os.getpid()}.tmp")
            try:
                subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS,
                                str(src), "-o", str(tmp), *link],
                               check=True, capture_output=True)
                os.replace(tmp, lib)
            finally:
                tmp.unlink(missing_ok=True)
    return str(lib)
