"""Build ``csrc/*.cu`` with nvcc into one shared library and load it with
ctypes.

The library has a plain C interface and includes no PyTorch header, so
each source compiles in seconds; the sources compile in parallel, one nvcc
each, and one more nvcc links them. It is built on the first
CUDA launch into ``build/torch_kernels/`` beside the package, named by a
hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads the cached file. A failed build raises; nothing falls
back to the plain versions. Importing this module runs nothing.

Processes that start together on a fresh checkout (the ranks of a sharded
render, torchrun's workers) build once: ``build`` holds an exclusive file
lock (``fcntl.flock`` on ``<library>.lock``) while it compiles, and a
process that waited for the lock finds the library there and loads it.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "torch_kernels")

# -fmad=false: no product is fused into an add, so the kernels round like
# their plain PyTorch versions. Never --use_fast_math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_functions: dict[str, ctypes._CFuncPtr] = {}


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built"
    )


def _sources() -> list[str]:
    return sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cu"))
        + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    )


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libptt_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless the library for them exists; return its
    path. The compiler's output, ptxas' register and spill report
    included, is kept beside it as ``.log``. One process compiles at a
    time (a file lock); the others wait and load its library."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(out[:-3] + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):
                return out
            return _compile(out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _compile(out: str) -> str:
    """Compile every source and link them into ``out``."""
    stem = f"{out[:-3]}.{os.getpid()}"
    nvcc = find_nvcc()
    jobs = []
    for src in (p for p in _sources() if p.endswith(".cu")):
        obj = f"{stem}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, errors = [], []
    for cmd, _, proc in jobs:
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            errors.append(f"nvcc failed with exit code {proc.returncode}:\n"
                          f"{stderr}")
    objs = [obj for _, obj, _ in jobs]
    tmp = f"{stem}.tmp"
    if not errors:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            errors.append(f"nvcc failed with exit code {proc.returncode}:\n"
                          f"{proc.stderr}")
    with open(out[:-3] + ".log", "w") as f:
        f.write("".join(log))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if errors:
        raise RuntimeError("\n".join(errors))
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """The compiler output of the current library's build ("" if none)."""
    path = library_path()[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The library's C function ``name`` returning int, with ``argtypes``
    set; builds and loads the library on first use."""
    global _lib
    with _lock:
        fn = _functions.get(name)
        if fn is None:
            if _lib is None:
                _lib = ctypes.CDLL(build())
            fn = getattr(_lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[name] = fn
        return fn
