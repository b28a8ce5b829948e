"""Builds the port's CUDA sources with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles, with the headers ``csrc/*.cuh``, into
one shared library with a plain C interface for ``sm_90a``. The library lands in
``build/kernels/`` at the root of the checkout under a name keyed by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is loaded as it is. Nothing is built when a module is
imported: :func:`library` builds on the first launch, and
:func:`build` starts one ``nvcc`` per source at once (what
``chip_smoke.py`` calls before it drives anything).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flash_decode", "quant_matmul", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: Dict[str, ctypes.CDLL] = {}
#: callables told of every successful nvcc build, as (source name,
#: wall seconds): the serving profiler's compile watch
_BUILD_LISTENERS: List[Callable[[str, float], None]] = []
#: compiler output of the builds this process ran (register / spill
#: reports from ``-Xptxas=-v``), by source name
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the kernels")


def target(name: str) -> Path:
    """The shared library ``name`` builds into (keyed by content)."""
    h = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> List[Path]:
    """Compile every source in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together; raises with the
    compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    out = []
    for name in names:
        dst = target(name)
        out.append(dst)
        if dst.exists():
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, dst))
    # listeners get the wall time each build added (the builds run
    # together, so these sum to the wall time of them all)
    t_prev = time.perf_counter()
    failed = []
    for name, proc, tmp, dst in running:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, dst)
            now = time.perf_counter()
            for fn in list(_BUILD_LISTENERS):
                fn(name, now - t_prev)
            t_prev = now
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use),
    with ``argtypes`` set from ``signatures`` and every function
    returning the ``cudaError_t`` of its launch."""
    lib = _LIBS.get(name)
    if lib is None:
        (path,) = build([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def loaded() -> List[str]:
    """Names of the kernel libraries this process has loaded."""
    return sorted(_LIBS)


def add_build_listener(fn: Callable[[str, float], None]) -> None:
    """Call ``fn(source name, wall seconds)`` after each successful
    build from now on."""
    if fn not in _BUILD_LISTENERS:
        _BUILD_LISTENERS.append(fn)


def check_launch(rc: int, what: str) -> None:
    """Raise if the C function reported a failed launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def dtype_code(t: torch.Tensor, what: str) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"{what}: dtype {t.dtype} not supported "
                        "(float32 or bfloat16)") from None


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launched() -> int:
    """What a wrapper adds to its launch count after its call: 1, or 0
    under a CUDA-graph capture, which records the launch without making
    it (each replay makes it, with no wrapper call: only the card's
    trace counts those)."""
    return 0 if torch.cuda.is_current_stream_capturing() else 1


def require_cuda(what: str, *tensors: torch.Tensor) -> torch.device:
    """All ``tensors`` on one CUDA device; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: tensors must share one CUDA device "
                             f"(got {[str(x.device) for x in tensors]})")
    return dev
