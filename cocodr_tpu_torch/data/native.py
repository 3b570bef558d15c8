"""The threaded record gather (csrc/host/recordio.cpp) through ctypes: the
port's counterpart of cocodr_tpu/data/native.py.

`NativeTokenCache` reads the record files of data/records.py with
`TokenCache`'s methods (`batch`, `batch_with_mask`, `__getitem__`,
`lengths`) and gives the same arrays byte for byte; a batch is gathered by
`n_threads` threads outside Python's interpreter lock. `open_token_cache`
is the readers' factory, with the JAX package's signature.

The library is built at first use in a process: g++ with the JAX
package's native/Makefile flags (-O3 -std=c++17 -fPIC -shared -lpthread)
into `cocodr_tpu_torch/_build/recordio-<sha of the source and flags>/`,
written under a temporary name and renamed into place, so processes that
build at once leave one whole library. A build that fails raises with the
compiler's output: unlike the JAX package's, this reader never falls back
to the memmap reader on its own; `open_token_cache(prefer_native=False)`
asks for that reader.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

from cocodr_tpu_torch.data.records import TokenCache

PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE / "csrc" / "host" / "recordio.cpp"
BUILD_ROOT = PACKAGE / "_build"
LIB_NAME = "librecordio.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
LINK_FLAGS = ("-lpthread",)
BUILD_TIMEOUT_S = 300

_P = ctypes.c_void_p
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
SIGNATURES = {
    "rio_open": ([ctypes.c_char_p, ctypes.c_int32], _P),
    "rio_total": ([_P], ctypes.c_int64),
    "rio_gather": ([_P, _I64P, ctypes.c_int64, _I32P, _I32P,
                    ctypes.c_int32], ctypes.c_int32),
    "rio_gather_masked": ([_P, _I64P, ctypes.c_int64, _I32P, _I32P,
                           ctypes.c_int32], ctypes.c_int32),
    "rio_lengths": ([_P, _I32P], None),
    "rio_close": ([_P], None),
}


def _compiler() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX or g++ on PATH): the "
                           "record reader is built from "
                           f"{SOURCE} at first use")
    return cxx


def build_dir(build_root: Path = None) -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return Path(build_root or BUILD_ROOT) / f"recordio-{h.hexdigest()[:16]}"


def _build(out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=out_dir))
    try:
        cmd = [_compiler(), *CXX_FLAGS, str(SOURCE), "-o",
               str(tmp / LIB_NAME), *LINK_FLAGS]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=BUILD_TIMEOUT_S)
        if res.returncode:
            raise RuntimeError(f"building the record reader failed:\n$ "
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp / LIB_NAME, out_dir / LIB_NAME)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def library(build_root: Path = None) -> ctypes.CDLL:
    """The record reader's shared library, built at first use."""
    out_dir = build_dir(build_root)
    if not (out_dir / LIB_NAME).is_file():
        _build(out_dir)
    lib = ctypes.CDLL(str(out_dir / LIB_NAME))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


class NativeTokenCache:
    """TokenCache's reader over the native gather."""

    def __init__(self, path: str, n_threads: int = 4):
        with open(path + "_meta") as f:
            meta = json.load(f)
        if np.dtype(meta["type"]) != np.int32:
            raise ValueError(f"{path}: token type {meta['type']}, the "
                             "native reader reads int32")
        self.path = path
        self.max_len = int(meta["embedding_size"])
        self.total_number = int(meta["total_number"])
        self.n_threads = n_threads
        record_bytes = 4 + 4 * self.max_len
        size = os.path.getsize(path)
        if size != self.total_number * record_bytes:
            raise ValueError(f"{path}: size {size} != {self.total_number} "
                             f"x {record_bytes}")
        self._lib = library()
        self._h = self._lib.rio_open(path.encode(), self.max_len)
        if not self._h:
            raise OSError(f"{path}: the record reader could not map it")

    def __len__(self):
        return self.total_number

    def _gather(self, fn, indices) -> Tuple[np.ndarray, np.ndarray]:
        if not self._h:
            raise ValueError(f"{self.path}: the reader is closed")
        idx = np.ascontiguousarray(indices, np.int64).reshape(-1)
        tokens = np.empty((idx.shape[0], self.max_len), np.int32)
        second = np.empty(tokens.shape if fn == "rio_gather_masked"
                          else idx.shape, np.int32)
        status = getattr(self._lib, fn)(
            self._h, _ptr(idx, _I64P), idx.shape[0], _ptr(tokens, _I32P),
            _ptr(second, _I32P), self.n_threads)
        if status:
            raise IndexError(f"{self.path}: a record index out of range "
                             f"[0, {self.total_number})")
        return tokens, second

    def batch(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        """(lengths [B] int32, tokens [B, max_len] int32)."""
        tokens, lengths = self._gather("rio_gather", indices)
        return lengths, tokens

    def batch_with_mask(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens [B, L], attention_mask [B, L]), both int32."""
        return self._gather("rio_gather_masked", indices)

    def __getitem__(self, idx: int) -> Tuple[int, np.ndarray]:
        lengths, tokens = self.batch([idx])
        return int(lengths[0]), tokens[0]

    def lengths(self) -> np.ndarray:
        """All record lengths [N] (the 4-byte prefixes alone)."""
        if not self._h:
            raise ValueError(f"{self.path}: the reader is closed")
        out = np.empty((self.total_number,), np.int32)
        self._lib.rio_lengths(self._h, _ptr(out, _I32P))
        return out

    def close(self):
        if self._h:
            self._lib.rio_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


def open_token_cache(path: str, prefer_native: bool = True,
                     n_threads: int = 4):
    """The native reader, or with prefer_native=False the memmap
    TokenCache; both give the same arrays."""
    if prefer_native:
        return NativeTokenCache(path, n_threads=n_threads)
    return TokenCache(path)
