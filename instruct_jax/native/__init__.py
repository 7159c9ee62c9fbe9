"""Native (C) fast path for panel parsing, bound via ctypes.

Compiled on first use with the system compiler into a cached shared
library; everything degrades gracefully to the pure-Python loader when the
toolchain or the fast-path preconditions are unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

NONINT = np.iinfo(np.int64).min

_LIB = None
_TRIED = False


def _build_lib() -> Optional[ctypes.CDLL]:
    src = os.path.join(os.path.dirname(__file__), "tokenize.c")
    cache_dir = os.path.join(
        os.environ.get("XDG_CACHE_HOME",
                       os.path.expanduser("~/.cache")), "instruct_jax")
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, "libinstruct_tokenize.so")
    if (not os.path.exists(so_path)
            or os.path.getmtime(so_path) < os.path.getmtime(src)):
        with tempfile.TemporaryDirectory() as td:
            tmp_so = os.path.join(td, "lib.so")
            cc = os.environ.get("CC", "cc")
            subprocess.run([cc, "-O3", "-shared", "-fPIC", src, "-o",
                            tmp_so], check=True, capture_output=True)
            os.replace(tmp_so, so_path)
    lib = ctypes.CDLL(so_path)
    lib.tokenize_ints.restype = ctypes.c_longlong
    lib.tokenize_ints.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_longlong,
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        try:
            _LIB = _build_lib()
        except Exception:
            _LIB = None
    return _LIB


def tokenize_file(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(values int64[n_tokens], tokens_per_line int64[n_lines]) or None if
    the native library is unavailable.  Non-integer tokens are NONINT."""
    lib = get_lib()
    if lib is None:
        return None
    with open(path, "rb") as fh:
        buf = fh.read()
    max_tokens = max(len(buf) // 2 + 16, 1024)
    values = np.empty(max_tokens, np.int64)
    max_lines = buf.count(b"\n") + 2
    line_tokens = np.empty(max_lines, np.int64)
    n_lines = lib.tokenize_ints(
        buf, len(buf),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_tokens,
        line_tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_lines)
    if n_lines < 0:
        return None
    line_tokens = line_tokens[:n_lines]
    values = values[:int(line_tokens.sum())]
    return values, line_tokens
