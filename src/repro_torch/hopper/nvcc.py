"""Build a CUDA source into a shared library with a plain C interface.

Every Hopper kernel of the port is one ``.cu`` file compiled by ``nvcc``
at first use and loaded with ``ctypes``: no PyTorch headers, so a build
takes seconds.  The library goes into the kernel's git-ignored ``build/``
directory, named by a hash of the source and the flags, so an edited
source never meets a stale build.  Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME); "
                       "the port's kernels are built from source at first "
                       "use")


def library_path(source: Path, flags, build_dir: Path, stem: str) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return build_dir / f"{stem}_{digest[:16]}.so"


def build(source: Path, flags, build_dir: Path,
          stem: str) -> tuple[Path, str, float]:
    """Compile ``source`` unless its library is already built.  Returns
    (library, nvcc's output, seconds); the output is "" and the seconds 0
    when the library was already there."""
    out = library_path(source, flags, build_dir, stem)
    if out.exists():
        return out, "", 0.0
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a private name, then rename: a concurrent builder never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc_path(), *flags, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{source.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr, time.perf_counter() - t0
