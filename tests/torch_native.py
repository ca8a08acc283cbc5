"""nfclab's native library for the port's tests, without nfclab's build.

nfclab's ``native/build.py`` writes its library in place, so a test process
that loads it while another process (another pytest worker) is still
compiling it maps a truncated file ("file too short"), and nfclab's
binding keeps that error for the life of the process.  The port's build
(``nfclab_torch/native/build.py``) is atomic, and its library comes from
byte-identical sources with the same flags (test_torch_copies.py holds
both).  So the port's tests point nfclab at a copy of the port's library,
through nfclab's own override ``NFCLAB_NATIVE_LIB``, in a file of its own:
the two bindings never share one loaded instance and its process-wide
state.

- ``ref_native_lib(tmp_dir)``: the path of that copy (built if needed);
  pass it as ``NFCLAB_NATIVE_LIB`` in a subprocess's environment.
- ``use_ref_native(tmp_dir)``: load nfclab's binding in this process from
  that copy (a no-op once it is loaded).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path

import pytest


def ref_native_lib(tmp_dir) -> str:
    """A copy of the port's native library in tmp_dir, for nfclab."""
    from nfclab_torch.native import binding

    if not binding.native_available():
        pytest.skip("native library unavailable")
    dst = Path(tmp_dir) / "libnfclab_native_ref.so"
    if not dst.exists():
        from nfclab_torch.native.build import lib_path

        fd, tmp = tempfile.mkstemp(dir=tmp_dir, suffix=".so")
        os.close(fd)
        shutil.copyfile(lib_path(), tmp)
        os.replace(tmp, dst)
    return str(dst)


def use_ref_native(tmp_dir) -> None:
    """Load nfclab's native binding from the copy of the port's library.
    The port's binding loads first, from its own file (ref_native_lib), so
    the override set here is never seen by it."""
    import nfclab.native.binding as ref

    path = ref_native_lib(tmp_dir)
    if ref._lib is not None:
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NFCLAB_NATIVE_LIB", path)
        # a failed load (nfclab's own build raced) is retried from the copy
        mp.setattr(ref, "_load_error", None)
        if not ref.native_available():
            raise RuntimeError(f"nfclab's binding did not load {path}: "
                               f"{ref._load_error}")
