"""Build the native (C++) runtime kernels into a shared library.

The reference implements its whole runtime in C++ (rt-lang/hw/lab layers); here
the native layer holds the bit-exact sequential oracle kernels and hot-loop
helpers, built on demand with g++ and loaded via ctypes (no pybind11 in this
environment).
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sysconfig
import tempfile
from pathlib import Path

_SRC_DIR = Path(__file__).parent / "src"
_BUILD_DIR = Path(__file__).parent / "_build"

SOURCES = [
    "conditioner.cpp",
    "magnitude.cpp",
    "sdr_bridge.cpp",
    "detect_span.cpp",
    "channels.cpp",
    "decode_v.cpp",
    "decode_f.cpp",
    "decode_a.cpp",
    "decode_b.cpp",
    "usb_drivers.cpp",
    "usb_logic.cpp",
]
HEADERS = ["fsm_common.h", "bridge.h", "usb_api.h"]
LIB_NAME = "libnfclab_native.so"


def lib_path() -> Path:
    return _BUILD_DIR / LIB_NAME


CXXFLAGS = [
    "-O3",
    "-march=native",  # SIMD for the branch-free scans; exactness is
    # preserved by -fno-fast-math -ffp-contract=off (no FMA contraction,
    # no reassociation — vector lanes run the same IEEE ops).  -march=native
    # makes the artifact machine-specific; the stamp below includes the
    # host's uname so a copied _build/ rebuilds instead of SIGILLing.
    "-std=c++17",
    "-shared",
    "-fPIC",
    # keep strict IEEE fp so the oracle matches the reference float math
    "-fno-fast-math",
    "-ffp-contract=off",
]


def _stamp() -> str:
    import hashlib
    import platform

    key = " ".join(CXXFLAGS) + "|" + platform.machine() + platform.node()
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def build(force: bool = False) -> Path:
    """Compile the native library if missing or out of date (source mtimes,
    compiler flags, or build host changed). Returns its path.

    Safe across processes: one process compiles, under an exclusive lock
    on ``_build/build.lock``, into a temporary file that replaces the
    library in one rename; the others wait on the lock and find it
    current, and no process ever maps a half-written library."""
    out = lib_path()
    srcs = [_SRC_DIR / s for s in SOURCES]
    stamp_file = _BUILD_DIR / "flags.stamp"
    stamp = _stamp()

    def current() -> bool:
        if not out.exists():
            return False
        deps = srcs + [_SRC_DIR / h for h in HEADERS]
        newest_src = max(s.stat().st_mtime for s in deps)
        stamp_ok = stamp_file.exists() and stamp_file.read_text() == stamp
        return out.stat().st_mtime >= newest_src and stamp_ok

    if not force and current():
        return out
    _BUILD_DIR.mkdir(exist_ok=True)
    with open(_BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and current():  # built by another process meanwhile
            return out
        fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so")
        os.close(fd)
        try:
            cmd = ["g++", *CXXFLAGS, "-o", tmp, *[str(s) for s in srcs],
                   "-ldl"]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        stamp_file.write_text(stamp)
    return out


if __name__ == "__main__":
    print(build(force=True))
