"""Build and bind the port's CUDA C++ kernels.

Each source under ``kernels/csrc/`` has a plain C interface.  It is compiled
by ``nvcc`` for ``sm_90a`` into a shared library and loaded with ``ctypes``:
seconds to build, against minutes for a source that includes PyTorch's
headers.  Libraries go to ``build/repro_torch_kernels/`` at the repository
root, keyed by a hash of the source, of the headers under ``csrc/`` and of
the flags it is built with (:func:`nvcc_flags`), so a changed source,
header or flag rebuilds and an unchanged one loads at once.  Nothing is
built when a module is imported: the first call that launches a kernel
builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]    # registers and spills, shown by build(verbose)

# flags one source adds to NVCC_FLAGS.  traj_masked_step's and lane_noise's
# float32 outputs equal their plain versions bit for bit only if no product
# and sum contract into an FMA; the other sources keep nvcc's default
# contraction.
SOURCE_FLAGS: Dict[str, List[str]] = {"traj_masked_step": ["-fmad=false"],
                                      "lane_noise": ["-fmad=false"]}

_LOADED: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas's registers, spills and shared memory) of each source
# this process built
LOGS: Dict[str, str] = {}


def find_nvcc() -> str:
    """``nvcc`` from the PATH, else the toolkit's default /usr/local/cuda."""
    for c in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if c and Path(c).is_file():
            return str(c)
    raise RuntimeError("nvcc not found (put the CUDA toolkit's bin on PATH); "
                       "the port's CUDA kernels are built from source")


def nvcc_flags(name: str) -> List[str]:
    """The flags ``csrc/<name>.cu`` is compiled with."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, [])


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source, every header
    under ``csrc/`` (a source may include any of them) and the flags."""
    key = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        key += header.name.encode() + header.read_bytes()
    key += " ".join(nvcc_flags(name)).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    The library is written under a temporary name and renamed into place,
    so concurrent builders never load a half-written file.  Returns the
    library's path; raises with nvcc's output if the build fails."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *nvcc_flags(name), "-o", tmp,
           str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        LOGS[name] = proc.stdout + proc.stderr
        if verbose and LOGS[name]:
            print(LOGS[name], flush=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)))
    return _LOADED[name]
