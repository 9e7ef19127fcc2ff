"""Build the CUDA kernels in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` into an object file, and the objects are linked
into one shared library with a plain C interface. Nothing includes
PyTorch's headers, so a build takes seconds. The library is cached under
``build/repro_torch_kernels/<hash>/`` (the hash covers the sources and the
flags), so a second process, or a second run, loads it without compiling.

Every C entry returns ``cudaGetLastError()`` after its launch; the Python
wrappers raise when that is not 0 (see :func:`check`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
_REPO_ROOT = Path(__file__).resolve().parents[3]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes of every C entry: pointers and the stream as c_void_p, so 64-bit
# addresses are never cut to a 32-bit int
SIGNATURES = {
    "repro_flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _F, _I, _I, _F, _P],
    "repro_decode_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _F, _I, _P],
    "repro_ssd_chunk_scan": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _L, _L, _L, _I, _I, _P],
    "repro_cuda_error_string": [_I],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None     # wall time of this process's build


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    return _REPO_ROOT / "build" / "repro_torch_kernels"


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from src/repro_torch/kernels/csrc at "
                           "first use")
    return found


def compile_commands(out_dir: Path) -> List[List[str]]:
    """One nvcc command per source (object files), then the link."""
    exe = nvcc()
    cmds = [[exe, *NVCC_FLAGS, "-c", str(src), "-o",
             str(out_dir / (src.stem + ".o"))] for src in sources()]
    cmds.append([exe, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                 "-o", str(out_dir / LIB_NAME),
                 *[str(out_dir / (src.stem + ".o")) for src in sources()]])
    return cmds


def _build(target: Path) -> None:
    global build_seconds
    t0 = time.monotonic()
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=target.parent))
    try:
        cmds = compile_commands(tmp)
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds[:-1]]
        logs = []
        for cmd, proc in zip(cmds[:-1], procs):
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
        link = subprocess.run(cmds[-1], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        # ptxas's register, shared-memory and spill report per kernel
        (tmp / "nvcc.log").write_text("".join(logs))
        # publish atomically: a concurrent builder of the same hash either
        # wins the rename or finds the finished directory
        try:
            os.rename(tmp, target)
        except OSError:
            if not (target / LIB_NAME).exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.monotonic() - t0


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this checkout."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = build_dir() / source_hash()
        if not (target / LIB_NAME).exists():
            _build(target)
        lib = ctypes.CDLL(str(target / LIB_NAME))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name == "repro_cuda_error_string" \
                else ctypes.c_int
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a launch error."""
    if err != 0:
        msg = load().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({msg})")
