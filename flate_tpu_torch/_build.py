"""Build and load the port's CUDA kernels and its host C.

Each source under `csrc/` (`SOURCES`) is compiled with nvcc at first use
into `build/` beside the package (one shared library per source, with a
plain C interface), named by the hash of its source and of the headers
beside it so an edited source or header is rebuilt, and loaded with
ctypes.  The compilers of all sources run at the
same time.  The host C of the round-1 encoder (`HOST_SOURCE`: Huffman
code lengths and the squeeze's parse DP) is built the same way with the
host C compiler (`cc`, else `gcc`) by host_library(); a failed build
raises.  Nothing here runs at import: the CPU tests import every module
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
_L = ctypes.c_longlong
# argument types of each C entry point (pointers and the stream as void*),
# by the source that holds it
ENCODE_KERNELS = {
    "flate_prep": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "flate_matcher": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _I, _I, _P],
    "flate_small_runs": [_P, _P, _P, _P, _P, _I, _I, _P],
    "flate_extend": [_P, _P, _P, _P, _I, _I, _I, _P],
    "flate_extend2": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "flate_parse_walk": [_P, _P, _I, _I, _P],
    "flate_pack": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "flate_squeeze_dp": [_P, _P, _P, _P, _P, _P, _I, _I, _L, _L, _L, _I, _I,
                         _P],
}
DECODE_KERNELS = {
    "flate_lane_walk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P],
    "flate_walk": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "flate_scan_headers": [_P, _P, _L, _L, _L, _L, _I, _P],
}
SORT_KERNELS = {
    "flate_bitonic": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _I, _P,
                      _I, _P],
}
KERNELS_BY_SOURCE = {PKG / "csrc" / "encode_kernels.cu": ENCODE_KERNELS,
                     PKG / "csrc" / "decode_kernels.cu": DECODE_KERNELS,
                     PKG / "csrc" / "sort_kernels.cu": SORT_KERNELS}
SOURCES = tuple(KERNELS_BY_SOURCE)
KERNELS = {**ENCODE_KERNELS, **DECODE_KERNELS, **SORT_KERNELS}


HOST_SOURCE = PKG / "csrc" / "host_encode.c"
# C entry point -> argument types (pointers as void*); each returns int
HOST_FUNCTIONS = {
    "huff_lengths": [_P, _I, _I, _P],
    "optimal_parse": [_P, _P, _I, _P, _P, _P, _P, _P, _P],
}


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
    """The library of `source`, named by the hash of the source and of the
    headers beside it (csrc/*.cuh), which it may include."""
    h = hashlib.sha1(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:12]}.so"


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


def _host_cc() -> str:
    for cc in ("cc", "gcc"):
        found = shutil.which(cc)
        if found is not None:
            return found
    raise RuntimeError("no host C compiler: put cc or gcc on PATH")


@functools.lru_cache(maxsize=1)
def host_library() -> ctypes.CDLL:
    """The host C library (HOST_SOURCE), built with the host C compiler
    on first call; raises if it cannot be built.  No -ffast-math: the
    parse DP's float32 sums must round as IEEE single adds."""
    lib = _library_path(HOST_SOURCE)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([_host_cc(), "-O3", "-fPIC", "-shared", "-o",
                               tmp, str(HOST_SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"cc failed on {HOST_SOURCE.name} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)             # atomic: no half-written library
    handle = ctypes.CDLL(str(lib))
    for name, argtypes in HOST_FUNCTIONS.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def launch(name: str, *args) -> None:
    """Call C entry point `name` on the current CUDA stream, raise on a
    launch error, and count the launch."""
    fn = library()[name]
    # the raw handle of the current stream, without building a Stream
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
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
               shape: tuple, *, rows: bool = False) -> int:
    """Raise unless t is a contiguous CUDA tensor of this dtype and shape;
    with rows=True each row of a 2-D t need only be contiguous in itself
    (a column slice of a wider tensor passes).  Returns the stride of t's
    first dimension."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.shape != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if rows:
        if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
            raise ValueError(f"{name}: each row must be contiguous")
    elif not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    return t.stride(0) if t.dim() else 0
