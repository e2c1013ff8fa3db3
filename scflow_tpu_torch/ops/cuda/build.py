"""Build the hand-written CUDA kernels with nvcc at first use; bind with ctypes.

Each source in `scflow_tpu_torch/csrc/` compiles on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries land in `<repo>/build/kernels/`, named by a hash of the
source, every shared header (`csrc/*.cuh`) and the flags, so an edited source
or header rebuilds and an unchanged one is reused.  All missing libraries build in parallel, one nvcc per source.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# per-source extra flags: the raster kernels, the shift lookup and the
# lookup's backward must not contract a*b + c into an FMA, so that they round
# like the plain PyTorch versions' separate products and sums
SOURCES: Dict[str, List[str]] = {
    "corr_lookup.cu": [],
    "corr_lookup_shift.cu": ["-fmad=false"],
    "corr_lookup_bdiag.cu": ["-fmad=false"],
    "corr_lookup_bwd.cu": ["-fmad=false"],
    "rasterize_v3.cu": ["-fmad=false"],
    "rasterize_v4.cu": ["-fmad=false"],
    "rasterize_packed.cu": ["-fmad=false"],
    "rasterize_v12.cu": ["-fmad=false"],
}

_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a host "
                       "with the CUDA toolkit")


def library_path(source: str) -> Path:
    flags = NVCC_FLAGS + SOURCES[source]
    digest = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(flags).encode())
    digest = digest.hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all at once.  Returns
    {source: nvcc's output (ptxas register/shared-memory report)} for the
    sources built by this call; raises with nvcc's output if one fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for source, extra in SOURCES.items():
            out = library_path(source)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp),
                   str(CSRC_DIR / source)]
            procs[source] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        logs, failed = {}, []
        for source, (proc, tmp, out) in procs.items():
            logs[source] = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(source)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[s] for s in failed))
        return logs


_count_lock = threading.Lock()


class CudaKernel:
    """One C launch function of one source.  `launch` calls it on PyTorch's
    current stream, raises if it returns a CUDA error, and counts the launch
    in `launches` (the only place the count moves; under a lock, since a
    server launches from its batcher and keep-alive threads)."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            build_all()
            fn = getattr(ctypes.CDLL(str(library_path(self.source))), self.symbol)
            # every launch function ends with the stream and returns the
            # cudaError_t of the launch
            fn.argtypes = self.argtypes + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        fn = self._load()
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        with _count_lock:
            self.launches += 1
