"""Inputs of the port's validation and benchmark tools.

nfclab's tools read the reference decoder's fixture WAVs by name from a
directory of their own.  The port's tools take the WAV paths as
arguments (each tool's usage text names nfclab's fixtures) and check
that they were given and exist before they start, exiting 1 with an
``error:`` line when not.
"""

from __future__ import annotations

import os
import sys


def missing(paths) -> bool:
    """Print an ``error:`` line and return True when no path is given or
    one is not a file (``error: no such file: PATH``, the first such);
    False when every path exists."""
    if not paths:
        print("error: give the WAV captures to read (see --help)",
              file=sys.stderr)
        return True
    for p in paths:
        if not os.path.isfile(p):
            print(f"error: no such file: {p}", file=sys.stderr)
            return True
    return False


def golden_path(wav: str) -> str | None:
    """The golden ``.json`` beside a WAV, if there is one."""
    path = os.path.splitext(wav)[0] + ".json"
    return path if os.path.exists(path) else None
