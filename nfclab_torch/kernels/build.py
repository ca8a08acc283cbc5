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
SOURCES = ["fused_frontend.cu", "conditioner.cu", "fused_v2.cu", "probes.cu"]
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


def _stamp(src_dir: Path) -> str:
    """Hash of the flags and of every file under src_dir (headers
    included, so a change to a shared header rebuilds the library)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in src_dir.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(src_dir)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def lib_path(build_dir: Path = BUILD_DIR) -> Path:
    return build_dir / LIB_NAME


def log_path(build_dir: Path = BUILD_DIR) -> Path:
    return build_dir / "nvcc.log"


def build(force: bool = False, src_dir: Path = SRC_DIR,
          build_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernel library from src_dir into build_dir if it is
    missing or stale; returns its path.  One nvcc per source, all started
    together, then one link.  nvcc's output (with the -Xptxas -v register
    and spill lines) is kept in ``log_path(build_dir)``.  Raises if nvcc
    fails."""
    out = lib_path(build_dir)
    stamp_file = build_dir / "sources.stamp"
    stamp = _stamp(src_dir)
    if (not force and out.exists() and stamp_file.exists()
            and stamp_file.read_text() == stamp):
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    log = []
    # build beside the target and rename, so a concurrent loader never
    # maps a half-written library
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs = [str(Path(tmp) / (s + ".o")) for s in SOURCES]
        jobs = []
        for src, obj in zip(SOURCES, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src_dir / src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        lib_tmp = str(Path(tmp) / LIB_NAME)
        link = [nvcc, "-shared", "-o", lib_tmp, *objs]
        failed = None
        for cmd, proc in jobs:
            text = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0 and failed is None:
                failed = f"nvcc failed ({proc.returncode}):\n{text}"
        if failed is None:
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed = (f"nvcc link failed ({proc.returncode}):\n"
                          f"{proc.stdout}{proc.stderr}")
        log_path(build_dir).write_text("".join(log))
        if failed is not None:
            raise RuntimeError(failed)
        os.replace(lib_tmp, out)
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
