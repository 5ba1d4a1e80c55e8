"""Native (C++) host engines, built with g++ on first use and loaded with
ctypes (counterpart of gill_tpu/native/__init__.py, with the port's own
copies of its sources and the same C ABI).

  * `get_bpe_engine(vocab, bpe_ranks)`: byte-level BPE's merge loop
    (bpe.cpp), which the GPT-2 tokenizer runs every word through;
  * `decode_preprocess(data, size, mean, std)`: JPEG / PNG decode, PIL's
    bicubic resize of the shortest side, center crop and CLIP
    normalization in one pass (image.cpp), which the training loader runs
    every image through.

Each library is compiled by `g++ -O2 -shared -fPIC -std=c++17` (the image
engine with -ljpeg -lpng) into `gill_tpu_torch/csrc/build/` (or
`$GILL_NATIVE_CACHE`), under a name keyed by a hash of the source and the
flags; it is written to a temporary file and renamed into place, so
concurrent processes never load half a file. These are host code, not
device kernels: where no compiler or no libjpeg / libpng is found the
engine is None (`build_error(name)` holds the compiler's output) and the
callers take the Python / PIL path, as gill_tpu's do. GILL_NO_NATIVE_IMAGE=1
turns the image engine off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional, Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "csrc", "build")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
IMAGE_LIBS = ("-ljpeg", "-lpng")

_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}
_ERRORS: Dict[str, str] = {}


def _lib_path(src: str, name: str, extra) -> str:
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join((*CXX_FLAGS, *extra)).encode())
    cache = os.environ.get("GILL_NATIVE_CACHE") or _BUILD_DIR
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, f"lib{name}-{h.hexdigest()[:16]}.so")


def _build(name: str, extra=()) -> Optional[str]:
    """Compiles native/<name>.cpp unless its library exists; returns its
    path, or None with the compiler's output in `build_error(name)`."""
    src = os.path.join(_HERE, f"{name}.cpp")
    path = _lib_path(src, name, extra)
    if os.path.exists(path):
        return path
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        r = subprocess.run(["g++", *CXX_FLAGS, src, "-o", tmp, *extra],
                           capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        _ERRORS[name] = str(e)
        return None
    if r.returncode != 0:
        _ERRORS[name] = (r.stderr or r.stdout).strip() or \
            f"g++ exit {r.returncode}"
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    os.replace(tmp, path)
    return path


def build_error(name: str) -> Optional[str]:
    """The compiler's (or loader's) output where the library `name`
    ("bpe" or "image") failed to build or load, else None."""
    return _ERRORS.get(name)


def _load(name: str, extra, bind) -> Optional[ctypes.CDLL]:
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        lib = None
        try:
            path = _build(name, extra)     # OSError: an unwritable cache
            if path is not None:
                lib = ctypes.CDLL(path)
                bind(lib)
        except (OSError, AttributeError) as e:
            _ERRORS[name] = str(e)
            lib = None
        _LIBS[name] = lib
        return lib


def _bind_bpe(lib):
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.bpe_new.restype = ctypes.c_void_p
    lib.bpe_new.argtypes = [i32p] * 3 + [ctypes.c_int32]
    lib.bpe_encode.restype = ctypes.c_int32
    lib.bpe_encode.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int32, i32p]
    lib.bpe_free.restype = None
    lib.bpe_free.argtypes = [ctypes.c_void_p]


def _bind_image(lib):
    fp = ctypes.POINTER(ctypes.c_float)
    lib.gill_image_decode_preprocess.restype = ctypes.c_int
    lib.gill_image_decode_preprocess.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, fp, fp, fp]
    lib.gill_image_probe.restype = ctypes.c_int
    lib.gill_image_probe.argtypes = [ctypes.c_char_p, ctypes.c_long]


def bpe_lib() -> Optional[ctypes.CDLL]:
    return _load("bpe", (), _bind_bpe)


def image_lib() -> Optional[ctypes.CDLL]:
    return _load("image", IMAGE_LIBS, _bind_image)


class BPEEngine:
    """Int-space BPE: symbols are vocab ids; merges from bpe_ranks."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._handle = handle

    def encode(self, sym_ids: Sequence[int]) -> list:
        n = len(sym_ids)
        if n <= 1:
            return list(sym_ids)
        arr = (ctypes.c_int32 * n)(*sym_ids)
        out = (ctypes.c_int32 * n)()
        m = self._lib.bpe_encode(self._handle, arr, n, out)
        return list(out[:m])

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bpe_free(self._handle)
            self._handle = None


def get_bpe_engine(vocab: Dict[str, int],
                   bpe_ranks: Dict[Tuple[str, str], int]
                   ) -> Optional[BPEEngine]:
    """The merge engine over the int-space rule table of `bpe_ranks`, or
    None when the library is unavailable, there are no merges, or a merge
    result is not in `vocab` (the caller's Python BPE then runs)."""
    if not bpe_ranks:
        return None
    lib = bpe_lib()
    if lib is None:
        return None
    n = len(bpe_ranks)
    left = (ctypes.c_int32 * n)()
    right = (ctypes.c_int32 * n)()
    merged = (ctypes.c_int32 * n)()
    for (a, b), rank in bpe_ranks.items():
        m, la, rb = vocab.get(a + b), vocab.get(a), vocab.get(b)
        if m is None or la is None or rb is None:
            return None
        left[rank], right[rank], merged[rank] = la, rb, m
    handle = lib.bpe_new(left, right, merged, n)
    return BPEEngine(lib, handle) if handle else None


def image_engine_available() -> bool:
    """True when the image engine is loadable (g++, libjpeg and libpng
    present, the build succeeded) and GILL_NO_NATIVE_IMAGE is not 1.
    `decode_preprocess` gives None both without an engine and for a file
    it does not recognize, so a caller that warns about a missing engine
    asks this."""
    if os.environ.get("GILL_NO_NATIVE_IMAGE") == "1":
        return False
    return image_lib() is not None


def decode_preprocess(data: bytes, image_size: int, mean, std):
    """JPEG / PNG bytes -> CLIP-normalized float32 (S, S, 3), or None
    without the engine or for another format (the caller decodes with
    PIL). Within PIL's 8-bit fixed-point resample error (~2/255 before
    normalization) of `utils.image.clip_preprocess`."""
    if os.environ.get("GILL_NO_NATIVE_IMAGE") == "1":
        return None
    lib = image_lib()
    if lib is None:
        return None
    import numpy as np

    if lib.gill_image_probe(data, len(data)) < 0:
        return None
    out = np.empty((image_size, image_size, 3), np.float32)
    m = (ctypes.c_float * 3)(*[float(x) for x in mean])
    s = (ctypes.c_float * 3)(*[float(x) for x in std])
    rc = lib.gill_image_decode_preprocess(
        data, len(data), image_size, m, s,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None
