"""Build and load the port's CUDA kernels.

Each source under `csrc/` (`SOURCES`) is compiled with nvcc at first use
into `build/` beside the package (one shared library per source, with a
plain C interface), named by the hash of its source so an edited source is
rebuilt, and loaded with ctypes.  The compilers of all sources run at the
same time.  Nothing here runs at import: the CPU tests import every module
on a machine without nvcc or a card.

`LAUNCHES` counts kernel launches by name.  Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = PKG.parent / "build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of each C entry point (pointers and the stream as void*),
# by the source that holds it
ENCODE_KERNELS = {
    "flate_prep": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "flate_matcher": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "flate_small_runs": [_P, _P, _P, _P, _P, _I, _I, _P],
    "flate_extend": [_P, _P, _P, _P, _I, _I, _I, _P],
    "flate_extend2": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "flate_parse_walk": [_P, _P, _I, _I, _P],
    "flate_pack": [_P, _P, _P, _I, _I, _I, _P],
}
DECODE_KERNELS = {
    "flate_lane_walk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "flate_walk": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}
KERNELS_BY_SOURCE = {PKG / "csrc" / "encode_kernels.cu": ENCODE_KERNELS,
                     PKG / "csrc" / "decode_kernels.cu": DECODE_KERNELS}
SOURCES = tuple(KERNELS_BY_SOURCE)
KERNELS = {**ENCODE_KERNELS, **DECODE_KERNELS}


def source_of(name: str) -> str:
    """Path, relative to the repository root, of the source that holds C
    entry point `name`."""
    for src, kernels in KERNELS_BY_SOURCE.items():
        if name in kernels:
            return src.relative_to(PKG.parent).as_posix()
    raise KeyError(name)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _library_path(source: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build(verbose: bool = False) -> list[pathlib.Path]:
    """Compile every source that has no build yet, all compilers started
    together; returns the libraries' paths in the order of SOURCES.
    verbose prints ptxas' register/spill report."""
    libs = [_library_path(src) for src in SOURCES]
    jobs = []
    for src, lib in zip(SOURCES, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", tmp, str(src)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((src, lib, tmp, proc))
    failures = []
    for src, lib, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {src.name} "
                            f"({proc.returncode}):\n{err}")
            continue
        if verbose:
            print(err, end="")
        os.replace(tmp, lib)             # atomic: no half-written library
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


@functools.lru_cache(maxsize=1)
def library() -> dict:
    """C entry point name -> loaded ctypes function (built on first
    call)."""
    fns = {}
    for src, path in zip(SOURCES, build()):
        lib = ctypes.CDLL(str(path))
        for name, argtypes in KERNELS_BY_SOURCE[src].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns


def launch(name: str, *args) -> None:
    """Call C entry point `name` on the current CUDA stream, raise on a
    launch error, and count the launch."""
    fn = library()[name]
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    LAUNCHES[name] += 1


def use_plain(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper runs the plain version), False
    for a CUDA tensor (it launches the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: tuple) -> None:
    """Raise unless t is a contiguous CUDA tensor of this dtype and shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
