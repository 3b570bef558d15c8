"""Build the port's CUDA kernels with nvcc and load them through ctypes.

The sources under `cocodr_tpu_torch/csrc/` have a plain C interface (no
PyTorch headers), so each compiles in seconds. At first use in a process,
`library()` compiles every `csrc/*.cu` for sm_90a, one nvcc per source, all
started together, links them into one shared library under
`cocodr_tpu_torch/_build/<sha of the sources and flags>/`, and loads it.
A build that already exists for the same sources is loaded as it is. The
library is written under a temporary name and renamed into place, so an
interrupted build leaves no half-written library and no lock behind.

Each C entry point returns the cudaError_t of its launch; `check` raises on
a non-zero value. Nothing here falls back to another implementation: a
missing nvcc or a failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_ROOT = PACKAGE / "_build"
LIB_NAME = "libcocodr_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point (pointers and the stream as c_void_p, so
# that ctypes never cuts a 64-bit address to a 32-bit int)
SIGNATURES = {
    "cocodr_ffn_block_bf16": [_P] * 14 + [_I, _I, _I, _I, _F, _P],
    "cocodr_ffn_bf16": [_P] * 7 + [_I, _I, _I, _I, _P],
    "cocodr_ffn_block_int8": [_P] * 20 + [_I, _I, _I, _I, _F, _P],
    "cocodr_attention_bf16": [_P] * 5 + [_I, _I, _I, _I, _F, _P],
    "cocodr_dual_sweep_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
    "cocodr_dual_sweep_packed_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
    "cocodr_block32_sweep_bf16": [_P, _P, _P, _I, _I, _I, _P],
    "cocodr_top2_sweep_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
    "cocodr_int8_sweep": [_P, _P, _P, _P, _I, _I, _I, _P],
    "cocodr_topk_f32": [_P, _P, _P, _I, _I, _I, _P],
    "cocodr_topk_i32": [_P, _P, _P, _I, _I, _I, _P],
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    built: bool  # False when an existing build was loaded
    seconds: float  # build (or load) time
    log: str  # nvcc's output, -Xptxas -v register and smem report included


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's kernels are built from cocodr_tpu_torch/csrc at first use"
    )


def _run_all(cmds):
    """Run the commands concurrently; -> their combined output. Raises with
    the output of every failed command; kills any still running on error."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in cmds
    ]
    outs, failed = [], []
    try:
        for c, p in zip(cmds, procs):
            out, _ = p.communicate(timeout=BUILD_TIMEOUT_S)
            outs.append(f"$ {' '.join(c)}\n{out}")
            if p.returncode:
                failed.append(outs[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "\n".join(outs)


def _build(out_dir: Path) -> str:
    nvcc = _nvcc()
    sources, _ = _sources()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=out_dir))
    try:
        objs = [tmp / (s.stem + ".o") for s in sources]
        log = _run_all([
            [nvcc, *COMPILE_FLAGS, "-c", str(s), "-o", str(o)]
            for s, o in zip(sources, objs)
        ])
        tmp_lib = tmp / LIB_NAME
        log += "\n" + _run_all([
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *map(str, objs)]
        ])
        (out_dir / "build.log").write_text(log)
        os.replace(tmp_lib, out_dir / LIB_NAME)
        return log
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """The kernels' shared library, built at first use in the process."""
    sources, headers = _sources()
    out_dir = BUILD_ROOT / _digest(sources + headers)
    path = out_dir / LIB_NAME
    t0 = time.perf_counter()
    built = not path.is_file()
    if built:
        log = _build(out_dir)
    else:
        log_file = out_dir / "build.log"
        log = log_file.read_text() if log_file.is_file() else ""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cocodr_error_string.argtypes = [ctypes.c_int]
    lib.cocodr_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, path, built, time.perf_counter() - t0, log)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg = library().lib.cocodr_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda_operand(name: str, t, dtypes, ndim: int) -> None:
    """What every kernel demands of a tensor operand; raises ValueError."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")
