"""Build and load the port's native libraries.

Each CUDA source in ``fastapriori_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface, loaded with ``ctypes``; the host-side C++ source of the native
ingest (``preprocess.cc``) is compiled the same way by the host compiler
(``$CXX``, else ``g++``).  Libraries land in
``fastapriori_tpu_torch/_build/`` (git-ignored) under a name that carries
a hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  A host library's hash also covers the compiler
and the host's identity (machine, CPU model and CPU flags): it is built
with ``-march=native``, and code built for one CPU can die with SIGILL on
another, while a ``_build/`` may outlive the machine it was built on.
:func:`build` starts one compiler per missing library, all at once, and
waits for all of them; each writes a per-process temporary file that is
renamed into place, so processes that build at the same time are safe.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# kernel name -> source file under csrc/
SOURCES = {
    "level_counts": "level_counts.cu",
    "first_match": "first_match.cu",
    "vertical_counts": "vertical_counts.cu",
}

# library name -> C++ source under csrc/ built by the host compiler.
HOST_SOURCES = {
    "fa_native": "preprocess.cc",
}

CXX_FLAGS = (
    "-O3",
    "-std=c++17",
    "-fPIC",
    "-Wall",
    "-Wextra",
    "-march=native",
    "-pthread",
    "-shared",
)

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "fastapriori_tpu_torch build from source at first use"
        )
    return found


def cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++``."""
    return os.environ.get("CXX", "").strip() or "g++"


# /proc/cpuinfo keys that name the CPU (x86, then Arm).
_CPU_KEYS = ("vendor_id", "cpu family", "model", "model name", "flags",
             "CPU implementer", "CPU architecture", "CPU variant", "CPU part",
             "Features")


@functools.lru_cache(maxsize=None)
def host_identity() -> str:
    """What ``-march=native`` code depends on: the machine type and the
    distinct CPU identity lines of /proc/cpuinfo (vendor, family, model,
    model name and flags; their Arm counterparts), or only the machine
    type where there is no such file.  The model number and the flags
    count: a virtualised host may report its model name as "unknown"."""
    lines = set()
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo", errors="replace") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in _CPU_KEYS:
                    lines.add(" ".join(line.split()))
    return "\n".join([platform.machine(), *sorted(lines)])


def _source(name: str) -> str:
    return HOST_SOURCES[name] if name in HOST_SOURCES else SOURCES[name]


def library_path(name: str) -> Path:
    src = (CSRC_DIR / _source(name)).read_bytes()
    if name in HOST_SOURCES:
        salt = "\n".join([cxx(), *CXX_FLAGS, host_identity()])
    else:
        salt = " ".join(NVCC_FLAGS)
    tag = hashlib.sha256(src + salt.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named library that is missing (every CUDA kernel and
    every host library when ``names`` is None), one compiler process
    each, all started together.  Returns, per library, the build seconds
    (0.0 when reused) and, for a kernel, the compiler's register/shared-
    memory report.  Raises RuntimeError with the compiler output on
    failure."""
    names = list([*SOURCES, *HOST_SOURCES] if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: Dict[str, dict] = {}
    procs, failed = [], []
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "ptxas": "reused"}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        if name in HOST_SOURCES:
            cmd = [cxx(), *CXX_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / HOST_SOURCES[name])]
        else:
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / SOURCES[name])]
        try:
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
        except OSError as e:  # no such compiler: the others still run
            failed.append(f"{cmd[0]} could not start for {_source(name)}: "
                          f"{e}")
            continue
        procs.append((name, out, tmp, proc, cmd[0]))
    for name, out, tmp, proc, compiler in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{compiler} failed for {_source(name)} (exit "
                          f"{proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": round(time.perf_counter() - t0, 3)}
        if name in SOURCES:
            report[name]["ptxas"] = " | ".join(
                line.strip() for line in log.splitlines()
                if "registers" in line or "bytes stack" in line
            )
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed (the native
    ingest library is loaded by fastapriori_tpu_torch/native/loader.py,
    which keeps its own cache)."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
