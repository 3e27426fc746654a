"""Build the CUDA sources under `csrc/` with `nvcc` into shared libraries
with a plain C interface, loaded with `ctypes`.

A library is built at first use into `_build/` beside this file (listed
in `.gitignore`) and is named by a hash of its source, the local headers
it includes (`#include "name"`, found beside it) and its flags, so an
edited source or header is rebuilt and an unchanged one is reused.
nvcc's output, with ptxas's register and shared-memory report, is kept
beside the library as `<name>-<hash>.log`.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _local_headers(src: Path) -> bytes:
    """The bytes of the headers `src` includes by `#include "name"`, which
    nvcc finds beside it."""
    names = re.findall(r'^\s*#include\s+"([^"]+)"', src.read_text(), re.M)
    return b"".join((src.parent / n).read_bytes() for n in names)


def build(name: str, defines: tuple[str, ...] = (),
          src: Path | None = None) -> Path:
    """Compile `csrc/<name>.cu` (or `src`, another tree's copy of it)
    unless its library is already built; return the library's path.
    `defines` are extra `-D` flags (a copy of the library built with other
    compile-time constants). Raises with nvcc's output if the build
    fails."""
    src = CSRC / f"{name}.cu" if src is None else Path(src)
    flags = (*NVCC_FLAGS, *defines)
    digest = hashlib.sha256(src.read_bytes() + _local_headers(src)
                            + " ".join(flags).encode()).hexdigest()
    lib = BUILD_DIR / f"{name}-{digest[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one temporary a build: two threads of one process may build the same
    # source (two trees whose copies are equal), each renaming its own
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.{threading.get_ident()}"
                        f".tmp.so")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)      # atomic: a concurrent builder sees all or none
    return lib
