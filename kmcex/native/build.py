"""Build the native runtime library (g++ -> .so, loaded via ctypes).

Compiled on demand into ``kmcex/native/_build/`` and cached by source
mtime; no pip/pybind dependency.  Rebuild is a single translation unit and
takes ~2s.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

_SRC = pathlib.Path(__file__).parent / "src" / "kmcex_native.cpp"
_BUILD_DIR = pathlib.Path(__file__).parent / "_build"
_LIB = _BUILD_DIR / "libkmcex_native.so"


def build_native(force: bool = False) -> pathlib.Path:
    _BUILD_DIR.mkdir(exist_ok=True)
    if _LIB.exists() and not force and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    tmp = _LIB.with_suffix(".so.tmp%d" % os.getpid())
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-fopenmp", str(_SRC), "-o", str(tmp),
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)
    return _LIB
