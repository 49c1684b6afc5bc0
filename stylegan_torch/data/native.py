"""ctypes bindings for the native (C++) decode+resize core (the port's copy
of ``stylegan_tpu/data/native.py``).

Builds ``native/stylegan_io.cc`` with ``g++ -O3`` (linking libjpeg and
libpng) at first use into ``build/stylegan_torch/`` at the repository root,
under a name that carries a hash of the source, so a changed source is
rebuilt and a concurrent build never exposes a partial file.  If the
toolchain or the libraries are missing, ``available()`` is False and the
datasets decode with PIL: the pixels are the same either way (the C++
resampler reimplements PIL's triangle filter; tests/test_torch_data.py
holds the two together).  ``decoder()`` says which one decodes JPEG and PNG
files in this process.

ctypes calls release the GIL, so the DataLoader's threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False
build_error = None      # why the library could not be built, if it could not

_SRC = Path(__file__).resolve().parent / "native" / "stylegan_io.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "stylegan_torch"


def _build() -> str | None:
    """The library's path, compiled first if this source has not been;
    None (and `build_error` set) when it cannot be built."""
    global build_error
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libstylegan_io-{digest}.so"
    if so.exists():
        return str(so)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-ljpeg",
                        "-lpng", "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except subprocess.CalledProcessError as e:
        build_error = e.stderr.decode(errors="replace").strip()[-500:]
    except (OSError, subprocess.SubprocessError) as e:
        build_error = str(e)
    if build_error is not None:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return str(so)


def _load():
    global _LIB, _TRIED, build_error
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            build_error = str(e)
            return None
        lib.sgio_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.sgio_decode_resize.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def decoder() -> str:
    """'native' when the C++ core decodes JPEG and PNG files, else 'PIL'."""
    return "native" if available() else "PIL"


def decode_resize(data: bytes, out_res: int, flip: bool) -> np.ndarray:
    """Encoded JPEG/PNG bytes -> (res, res, 3) float32 in [-1, 1].

    Raises ValueError on decode failure (the caller falls back to PIL)."""
    lib = _load()
    if lib is None:
        raise ValueError("native IO unavailable")
    out = np.empty((out_res, out_res, 3), np.float32)
    rc = lib.sgio_decode_resize(
        data, len(data), out_res, int(flip),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError(f"native decode failed (code {rc})")
    return out
