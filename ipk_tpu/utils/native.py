"""Build-on-demand loader for the native shared libraries.

The ``.so`` artifacts are intentionally NOT committed (a binary built with
host-specific ISA flags can SIGILL on other CPUs, and its libm rounding can
perturb last-bit f32 filter values across environments). Instead
each loader builds its library from source on first use with portable flags
(``-O3 -mtune=generic``), so the artifact always matches the local toolchain.

``IPK_TPU_NO_NATIVE`` is honored on EVERY call (only the successfully loaded
CDLL handle is cached), so callers can force the pure-Python paths at any
point without reaching into private module state.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_handles: dict = {}
_failed: set = set()
_lock = threading.Lock()

#: portable flags: no -march=native (the build host's ISA extensions must
#: not leak into an artifact that could outlive the host)
_CXXFLAGS = ["-O3", "-mtune=generic", "-std=c++17", "-Wall"]


def native_dir() -> str:
    return _NATIVE_DIR


def _build(name: str, extra: list) -> bool:
    src = os.path.join(_NATIVE_DIR, name.replace("lib", "", 1)
                       .replace(".so", ".cpp"))
    out = os.path.join(_NATIVE_DIR, name)
    if not os.path.exists(src):
        return False
    try:
        subprocess.run(["g++", *_CXXFLAGS, "-shared", "-fPIC", *extra,
                        "-o", out, src], check=True, capture_output=True)
    except (subprocess.CalledProcessError, OSError):
        return False
    return True


def load_native_lib(name: str, *, extra_flags: Optional[list] = None
                    ) -> Optional[ctypes.CDLL]:
    """Load ``native/<name>``, compiling it from the same-named ``.cpp`` if
    missing or older than its source. Returns None (pure-Python fallback)
    when IPK_TPU_NO_NATIVE is set, the toolchain is unavailable, or the
    build fails — never raises."""
    if os.environ.get("IPK_TPU_NO_NATIVE"):
        return None
    with _lock:
        if name in _handles:
            return _handles[name]
        if name in _failed:
            return None
        path = os.path.join(_NATIVE_DIR, name)
        src = os.path.join(_NATIVE_DIR, name.replace("lib", "", 1)
                           .replace(".so", ".cpp"))
        stale = (not os.path.exists(path)
                 or (os.path.exists(src)
                     and os.path.getmtime(path) < os.path.getmtime(src)))
        if stale and not _build(name, extra_flags or []):
            _failed.add(name)
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _failed.add(name)
            return None
        _handles[name] = lib
        return lib
