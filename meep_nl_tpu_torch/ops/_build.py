"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, keyed by a hash of every file of csrc/ (the
sources share headers) and the flags, under ``meep_nl_tpu_torch/_build/``
(listed in .gitignore), and loaded with ctypes.  Nothing is built when a
module is imported: the CPU tests import every module on machines without
nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: `--fmad=false` keeps a*b+c as two roundings, like the plain PyTorch
#: version the kernels are held against
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ at first use on a machine with the toolkit")
    return path


def library_path(name: str) -> str:
    """Where csrc/<name>.cu's library goes: the name carries a hash of all
    of csrc/ and the flags, so an edit to a shared header rebuilds."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, fname), "rb") as fh:
            h.update(fname.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its hash-keyed library exists; returns
    the library path.  Raises with nvcc's output when the build fails."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    res = subprocess.run([nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
                          os.path.join(CSRC, f"{name}.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stdout}\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built on first call)."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build(name))
        return _libs[name]
