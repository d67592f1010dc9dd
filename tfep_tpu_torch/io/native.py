"""Loader for the native trajectory-IO library (tfep_tpu_torch/native/trajio.cpp).

After ``tfep_tpu/io/native.py``. Compiled lazily with the system C++
compiler and loaded through ctypes (no pybind11 here). The library is
built from this package's own copy of the source into ``build/native/``
at the root of the checkout, named by the source's digest, so an edited
source never loads a stale library. Each format module guards on
:func:`native_available` and falls back to its pure-Python reader; when the
build fails, :func:`native_build_error` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

__all__ = ['native_lib', 'native_available', 'native_build_error',
           'SOURCE', 'BUILD_DIR']

SOURCE = Path(__file__).resolve().parents[1] / 'native' / 'trajio.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'

_LIB = None
_TRIED = False
_ERROR: Optional[str] = None

_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)

_SIGNATURES = {
    'dcd_read_header': [ctypes.c_char_p, _I64P],
    'dcd_read_frames': [ctypes.c_char_p, _I64P, ctypes.c_int64,
                        _F32P, _F64P],
    'xtc_scan': [ctypes.c_char_p, _I64P, ctypes.c_int64, _I64P],
    'xtc_read_frames': [ctypes.c_char_p, _I64P, ctypes.c_int64,
                        ctypes.c_int64, _F32P, _F32P, _F32P],
    'trr_scan': [ctypes.c_char_p, _I64P, ctypes.c_int64, _I64P],
    'trr_read_frames': [ctypes.c_char_p, _I64P, ctypes.c_int64,
                        ctypes.c_int64, _F32P, _F32P, _F32P],
}


def library_path() -> Path:
    """Where the library of the current source is (or will be) built."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f'libtrajio_{digest}.so'


def _build() -> Path:
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a per-process path and publish atomically: concurrent
    # processes (e.g. pytest-xdist workers) must never load a half-written
    # library.
    tmp_path = lib_path.with_suffix(f'.{os.getpid()}.tmp')
    try:
        subprocess.run(['g++', '-O3', '-shared', '-fPIC', '-o',
                        str(tmp_path), str(SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp_path, lib_path)
    finally:
        if tmp_path.exists():   # failed compile leftovers
            tmp_path.unlink()
    return lib_path


def native_lib():
    """Compile (once) and load the native trajio library; None on failure."""
    global _LIB, _TRIED, _ERROR
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(_build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    except subprocess.CalledProcessError as err:
        _ERROR = f'g++ failed ({err.returncode}):\n{err.stdout}{err.stderr}'
    except (OSError, AttributeError) as err:
        _ERROR = repr(err)
    return _LIB


def native_available() -> bool:
    return native_lib() is not None


def native_build_error() -> Optional[str]:
    """Why the library could not be built or loaded (None if it was)."""
    native_lib()
    return _ERROR
