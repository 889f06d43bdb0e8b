"""Build the port's CUDA kernel library from the repository's sources at
first use, and load it with ctypes.

Every ``csrc/*.cu`` source, each with a plain C interface (no PyTorch
headers, no ninja), compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects: seconds, not minutes.  The shared object goes into ``volcano_tpu_torch/csrc/_build/``
under a name keyed by a hash of every source, every header and the
flags, so an edit to any of them rebuilds and an unchanged tree loads
the library already there.  A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")

#: nvcc flags of each source: Hopper's arch-specific target; no FMA
#: contraction and no fast math, so the f32 arithmetic rounds as the
#: reference's does; ``-Xptxas=-v`` reports registers, shared memory and
#: spills per kernel
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)
#: nvcc flags of the link into one shared library
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


def sources(ext: str = ".cu") -> Tuple[str, ...]:
    """The ``csrc`` files with extension ``ext`` by name, sorted: by
    default the .cu files nvcc compiles."""
    return tuple(sorted(fn for fn in os.listdir(CSRC) if fn.endswith(ext)))


#: (build seconds, nvcc output) of a build made by this process
BUILD_LOG: Optional[Tuple[float, str]] = None


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH)")
    return found


def keyed_library(stem: str, files, flags, build_dir: str) -> str:
    """``<build_dir>/<stem>_<hash>.so``, the hash taken over each file's
    name and bytes and over the flags: an edit to any of them names a new
    library, and an unchanged tree names the one already built."""
    h = hashlib.sha256()
    for path in files:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update("\0".join(flags).encode())
    return os.path.join(build_dir, f"{stem}_{h.hexdigest()[:16]}.so")


def build_once(path: str, make) -> str:
    """Return ``path``, first calling ``make(tmp)`` unless it exists.
    ``make`` writes the library to the private temporary ``tmp`` or
    raises; ``tmp`` is renamed into place, so a concurrent loader never
    maps a half-written library, and removed on failure."""
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        make(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def library_path() -> str:
    """Where the library lives for the current sources, headers and flags."""
    return keyed_library(
        "libvtkernels",
        [os.path.join(CSRC, fn) for fn in (*sources(), *sources(".cuh"))],
        (*NVCC_FLAGS, *LINK_FLAGS),
        BUILD_DIR,
    )


def _nvcc(out: str) -> None:
    """Compile every source in its own nvcc, all at once, and link the
    objects into ``out``.  Raises RuntimeError with nvcc's output."""
    global BUILD_LOG
    objs = [os.path.join(BUILD_DIR, f"{fn}.{os.getpid()}.o") for fn in sources()]
    nvcc = find_nvcc()
    t0 = time.monotonic()
    try:
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, fn), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for fn, obj in zip(sources(), objs)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [code for code in (proc.returncode for proc in procs) if code != 0]
        if not failed:
            link = subprocess.run([nvcc, *LINK_FLAGS, "-o", out, *objs],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(link.stdout)
            if link.returncode != 0:
                failed.append(link.returncode)
        BUILD_LOG = (time.monotonic() - t0, "".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed (exit {failed[0]}):\n{BUILD_LOG[1]}")
    finally:
        for f in objs:
            if os.path.exists(f):
                os.remove(f)


def build() -> str:
    """Build the library unless it is built already; return its path.
    Raises RuntimeError with nvcc's output when the build fails."""
    return build_once(library_path(), _nvcc)


def load() -> ctypes.CDLL:
    """The library, built first if needed."""
    return ctypes.CDLL(build())
