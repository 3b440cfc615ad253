"""Build the port's CUDA sources at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``). The library's file name
carries a hash of the sources and flags, so an edited source is rebuilt
and a stale library is never loaded. Nothing here runs at import time:
the CPU-only test machine has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("paged_attention", "paged_attention_int8",
           "chunked_prefill_attention", "rmsnorm", "ssd_scan",
           "ssd_scan_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# a source's own flags: the scan's backward (36 kernels) splits its
# device compilation over the host's cores, which halves its build
SOURCE_FLAGS = {"ssd_scan_bwd": ["--split-compile=0"]}

_libs: Dict[str, ctypes.CDLL] = {}
# engines on worker threads (the async fleet) reach the kernels at once:
# the first use builds and loads each library under this lock, so two
# threads never run nvcc into one target or load a library twice
_build_lock = threading.RLock()
# guards the wrappers' launch and variant counts and ``ops``' plain-call
# counts, which those threads update together
count_lock = threading.Lock()
# nvcc's output of each build made by this process (-Xptxas -v: the
# registers, shared memory and spills of every kernel)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build on a machine with the CUDA toolkit")


def _flags(name: str) -> List[str]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, [])


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> List[str]:
    """Compile every source of ``names`` that has no current library,
    one ``nvcc`` process per source, all started together. Returns the
    names built. Raises with nvcc's output if a build fails."""
    with _build_lock:
        return _build(names)


def _build(names: Iterable[str]) -> List[str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return list(procs)


def load_library(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        with _build_lock:
            lib = _libs.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(_target(name)))
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


# dtype codes of the kernels' C interface (``DISPATCH_DTYPE_HEAD_DIM`` and
# each kernel's own dispatch)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)


def check_inputs(name: str, floats: Sequence[torch.Tensor],
                 ints: Sequence[torch.Tensor]) -> None:
    """The checks every kernel wrapper makes before its shape rules: the
    float tensors share a dtype of ``DTYPES``, the index tensors are
    int32; all are contiguous; the float tensors are 16-byte aligned (the
    kernels load 16 bytes at a time). The device is checked last, by
    ``check_device``, so that these rules hold on any device."""
    tensors = (*floats, *ints)
    dt = floats[0].dtype
    if dt not in DTYPES or any(t.dtype != dt for t in floats):
        raise TypeError(f"{name}: the float inputs must share a dtype of "
                        f"{list(DTYPES)}, got {[t.dtype for t in floats]}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f"{name}: the index inputs are int32, got "
                        f"{[t.dtype for t in ints]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in floats):
        raise ValueError(f"{name}: the float inputs must be 16-byte aligned "
                         f"(the kernel loads 16 bytes at a time)")


def check_device(name: str, tensors: Sequence[torch.Tensor]) -> None:
    """Every wrapper's last check: all tensors on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")


def check_head_dim(name: str, head_dim: int) -> None:
    """The attention kernels' rule: ``head_dim`` is one of
    ``HEAD_DIMS`` (``DISPATCH_DTYPE_HEAD_DIM``)."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {head_dim} is not one of "
                         f"{HEAD_DIMS}")


class Long(int):
    """An int that a kernel's C interface takes as ``long long`` (a
    stride or an offset that may pass 2^31)."""


def _ctype(arg):
    if isinstance(arg, torch.Tensor):
        return ctypes.c_void_p
    if isinstance(arg, Long):
        return ctypes.c_longlong
    return ctypes.c_float if isinstance(arg, float) else ctypes.c_int


def launch(name: str, *args, entry: str = "") -> None:
    """Call ``<name>_launch(*args, stream)`` of ``csrc/<name>.cu`` (or its
    function ``entry``, a second entry of the same library) on the
    current stream of the tensors' device. Tensors pass as their data
    pointers, ``Long`` as ``long long``, other Python ints as ``int`` and
    floats as ``float``. Raises with CUDA's error string if the launch
    fails."""
    lib = load_library(name)
    fn = getattr(lib, entry or f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = [_ctype(a) for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    device = next(a for a in args if isinstance(a, torch.Tensor)).device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                    for a in args), stream)
    if code:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{entry or name} kernel launch failed: {msg} "
                           f"({code})")
