"""Build and load the port's CUDA kernels.

Each source in `devis_torch/csrc/` is compiled by `nvcc` for `sm_90a` into a
shared library with a plain C interface under `devis_torch/_build/` (listed
in `.gitignore`) and loaded with `ctypes`. A library is rebuilt when it is
missing or older than its source or a header beside it. `build_all` starts
one `nvcc` per source at once; `library` builds on first use. Nothing happens
at import.
"""
from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import subprocess
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("ms_deform_attn", "ms_deform_attn_rows", "ms_deform_attn_proj",
           "ms_deform_attn_taps", "deform_conv", "probes")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def _paths(name: str):
    return (os.path.join(SRC_DIR, name + ".cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"),
            os.path.join(BUILD_DIR, f"{name}.log"))


def _stale(name: str) -> bool:
    src, lib, _ = _paths(name)
    if not os.path.exists(lib):
        return True
    deps = [src] + [os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                    if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(os.path.getmtime(d) for d in deps)


def build_all(names=SOURCES) -> Dict[str, float]:
    """Compile every stale source, all at once. Returns seconds per source
    (0.0 where the library was current); raises if a compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if not _stale(name):
            continue
        src, lib, log = _paths(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, log)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        text, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(log, "w") as f:
            f.write(text)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output (register and shared-memory use per kernel)."""
    with open(_paths(name)[2]) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def source_define(name: str, macro: str) -> int:
    """The integer a `#define macro` of source `name` sets: the one place a
    launch constant is kept where Python needs it too."""
    with open(_paths(name)[0]) as f:
        found = re.search(rf"^#define {macro} (\d+)\b", f.read(), re.M)
    if found is None:
        raise KeyError(f"{macro} is not defined in {name}.cu")
    return int(found.group(1))


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build_all((name,))
        lib = ctypes.CDLL(_paths(name)[1])
        _LIBS[name] = lib
    return lib


def int_array(values) -> ctypes.Array:
    values = [int(v) for v in values]
    return (ctypes.c_int * max(1, len(values)))(*values)


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
