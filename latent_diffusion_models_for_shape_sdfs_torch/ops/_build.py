"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/*.cu` file is a plain C interface compiled by `nvcc` for Hopper
(`sm_90a`) into `csrc/build/` (gitignored) at first use, and loaded with
ctypes. The library name carries a hash of the source, the shared
`csrc/*.cuh` headers and the flags, so an edited source rebuilds and a stale library is never loaded; the build
writes to a temporary name and renames, so concurrent processes can race
safely. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin)")


def build(source: str) -> pathlib.Path:
    """Compile csrc/<source> unless an up-to-date library exists; returns
    the library path. The compiler's report (ptxas registers, shared
    memory, spills) is kept beside it as <lib>.log."""
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    # -I csrc: a variant written elsewhere (tools/*_probe.py) still finds
    # the shared headers
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                           str(tmp), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<source>; one handle per process."""
    if source not in _LOADED:
        _LOADED[source] = ctypes.CDLL(str(build(source)))
    return _LOADED[source]
