"""Build the port's CUDA kernels with nvcc into a shared library with a
plain C interface (loaded with ctypes by kernels.fused.library).

The build runs at the first CUDA call, never at import, into
``nfclab_torch/kernels/_build/``; it is skipped when the library there was
built from the same sources with the same flags.  Run this module to build
by hand: ``python -m nfclab_torch.kernels.build``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ["fused_frontend.cu", "conditioner.cu"]
LIB_NAME = "libnfclab_torch_kernels.so"

# Bit-exactness with the C++ oracle (built -ffp-contract=off) rules out FMA
# contraction, approximate division and flushing denormals to zero.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-fmad=false",
    "-prec-div=true",
    "-prec-sqrt=true",
    "-ftz=false",
    "-Xptxas", "-v",
    "-shared",
    "-Xcompiler", "-fPIC",
]


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built"
        )
    return found


def _stamp() -> str:
    """Hash of the flags and of every file under csrc/ (headers included,
    so a change to a shared header rebuilds the library)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in SRC_DIR.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(SRC_DIR)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return BUILD_DIR / LIB_NAME


def log_path() -> Path:
    return BUILD_DIR / "nvcc.log"


def build(force: bool = False) -> Path:
    """Compile the kernel library if it is missing or stale; returns its
    path.  nvcc's output (with the -Xptxas -v register and spill lines)
    is kept in ``log_path()``.  Raises if nvcc fails."""
    out = lib_path()
    stamp_file = BUILD_DIR / "sources.stamp"
    stamp = _stamp()
    if (not force and out.exists() and stamp_file.exists()
            and stamp_file.read_text() == stamp):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename, so a concurrent loader never
    # maps a half-written library
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *[str(SRC_DIR / s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log_path().write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    stamp_file.write_text(stamp)
    return out


def ptxas_lines() -> list[str]:
    """The register / shared-memory / spill lines of the last build."""
    if not log_path().exists():
        return []
    return [
        ln for ln in log_path().read_text().splitlines()
        if "ptxas info" in ln or "spill" in ln
    ]


if __name__ == "__main__":
    print(build(force=True))
    print("\n".join(ptxas_lines()))
