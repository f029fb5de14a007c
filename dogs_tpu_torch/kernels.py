"""Build and bind the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into a shared library
with a plain C interface (`extern "C"` launchers that return
`cudaGetLastError()`), loaded with ctypes. All libraries build at first use,
one nvcc process per source, all started together, into
`dogs_tpu_torch/_build/`. The file names carry a hash of every source and
header under `csrc/` and of the flags, so an edit to any of them rebuilds
all. Nothing here runs at import time: this module imports on machines with
no CUDA toolkit, and only `build_all` needs one.

Every kernel wrapper of the package checks its inputs, allocates its outputs
and calls `launch` once: `launch` is the only place that reaches a launcher,
and `launches` counts every launch by launcher symbol (`dogs_blend_forward`,
...). Tests and smoke runs read that one counter; `launches.clear()` resets it.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("blend_forward", "blend_backward", "segment_sum", "preprocess", "sparse_adam", "ssim")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# Flags of one source beyond NVCC_FLAGS: the preprocess, the sparse Adam and
# the SSIM round each multiply and add on their own, as the plain PyTorch
# versions' separate operations do.
EXTRA_FLAGS = {"preprocess": ("-fmad=false",), "sparse_adam": ("-fmad=false",), "ssim": ("-fmad=false",)}


@dataclasses.dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    log: str  # nvcc's output, with the -Xptxas -v report
    seconds: float  # wall time of this process's build; 0.0 if it was on disk


def sources_digest() -> str:
    """Hash of every file under csrc/ and of the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + repr(sorted(EXTRA_FLAGS.items())).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def build_all() -> dict[str, Built]:
    """Compile (once per digest) and load every kernel library.

    Raises if nvcc is missing or any build fails."""
    from torch.utils.cpp_extension import CUDA_HOME

    digest = sources_digest()
    paths = {name: BUILD_DIR / f"{name}_{digest}.so" for name in KERNELS}
    missing = [name for name, path in paths.items() if not path.exists()]
    seconds = dict.fromkeys(KERNELS, 0.0)
    if missing:
        nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
        if CUDA_HOME is None or not nvcc.exists():
            raise RuntimeError(f"no CUDA toolkit with nvcc found: cannot build {missing}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name in missing:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [str(nvcc), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o", tmp, str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failures = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                failures.append(f"nvcc failed on csrc/{name}.cu:\n{log}")
                continue
            paths[name].with_suffix(".log").write_text(log)
            os.replace(tmp, paths[name])
        if failures:
            raise RuntimeError("\n".join(failures))
    built = {}
    for name, path in paths.items():
        log_path = path.with_suffix(".log")
        built[name] = Built(
            lib=ctypes.CDLL(str(path)),
            log=log_path.read_text() if log_path.exists() else "",
            seconds=seconds[name],
        )
    return built


@functools.lru_cache(maxsize=None)
def launcher(name: str, symbol: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C launcher `symbol` of library `name`, typed (returns int)."""
    fn = getattr(build_all()[name].lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


launches: collections.Counter = collections.Counter()  # kernel launches by launcher symbol


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device: a kernel wrapper
    never runs a plain version in its place."""
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(
            f"{name} runs the CUDA kernel: its tensors (on "
            f"{sorted({str(t.device) for t in tensors})}) must share one CUDA device"
        )


def launch(name: str, symbol: str, argtypes: tuple, *args, device: torch.device | str = "cuda") -> None:
    """Call the launcher `symbol` of library `name` with `args` and the
    current stream of `device` (its last argument in `argtypes`), with no
    sync, and count it in `launches`. A nonzero return raises."""
    fn = launcher(name, symbol, argtypes)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
    launches[symbol] += 1
