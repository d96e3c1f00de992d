"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each ``repro_torch/kernels/<name>/kernel.cu`` is compiled on its own into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), all sources at once, one nvcc each.  The libraries go to
``build/repro_torch_kernels/`` at the root of the checkout, named by a hash
of the source and the flags: an edited source is rebuilt, an unchanged one
is loaded as it is.  Nothing is compiled or loaded when a module is
imported; the first launch, or :func:`build`, does it.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

#: Every kernel of the port, by directory name.
KERNELS = ("adagrad", "server_step", "flash_attention", "rwkv6", "mamba")

_COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: Each kernel's nvcc flags (part of its library's hash).  ``-fmad=false``
#: keeps every multiply and add separately rounded, as the eager PyTorch
#: versions are: K1, K2 and K5 promise bit-equality with them.  Attention
#: is held to its plain version within a tolerance, and lets nvcc contract
#: ``a*b+c`` into one fused multiply-add.  The selective scan (K4) writes
#: every multiply and add as an intrinsic that is never contracted, and
#: keeps the default so that its ``expf`` compiles as PyTorch's exp does.
NVCC_FLAGS = {
    "adagrad": _COMMON_FLAGS + ("-fmad=false",),
    "server_step": _COMMON_FLAGS + ("-fmad=false",),
    "flash_attention": _COMMON_FLAGS,
    "rwkv6": _COMMON_FLAGS + ("-fmad=false",),
    "mamba": _COMMON_FLAGS,
}

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parents[2] / "build" / "repro_torch_kernels"

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def source(name: str) -> Path:
    return _HERE / name / "kernel.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes()
                            + " ".join(NVCC_FLAGS[name]).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def log_path(name: str) -> Path:
    """nvcc's output for kernel ``name``'s library (ptxas's registers,
    shared memory and spills per CUDA function, from ``-Xptxas=-v``)."""
    return library_path(name).with_suffix(".log")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def build(names=KERNELS) -> float:
    """Compile every library of ``names`` that is not built yet, all at
    once, and return the wall seconds it took.  Raises with nvcc's output
    when a source does not compile."""
    t0 = time.perf_counter()
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, out) for n, out in todo if not out.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs.append((name, out, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS[name], "-o", str(tmp), str(source(name))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                              f"{log}")
            else:
                out.with_suffix(".log").write_text(log)
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str, entry: str, argtypes: list) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if need be),
    with its C ``entry`` declared as ``int entry(*argtypes, stream)``
    beside ``repro_cuda_error_string``.  Every pointer and the stream must
    be ``c_void_p``: ctypes would cut an undeclared pointer to 32 bits."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build()
            lib = ctypes.CDLL(str(library_path(name)))
            getattr(lib, entry).restype = ctypes.c_int
            getattr(lib, entry).argtypes = [*argtypes, ctypes.c_void_p]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            _loaded[name] = lib
    return lib


def refuse_dtensor(name: str, t) -> None:
    """Raise ``TypeError`` for a DTensor.  A kernel reads a tensor's
    pointer with the shape it is given, and a DTensor's pointer is its
    local shard's: launched with the global shape, the kernel would read
    out of bounds.  Callers pass local shards (``to_local()``), and only
    along dimensions where the kernel's work is independent."""
    if isinstance(t, torch.Tensor) and type(t) is not torch.Tensor:
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            raise TypeError(
                f"{name} is a DTensor {tuple(t.shape)} placed "
                f"{tuple(t.placements)}; the kernels take plain tensors: "
                f"pass its local shard")


def route(device: torch.device, kernel: str) -> str:
    """The dispatch rule of every wrapper: ``"cuda"`` for a CUDA device
    (launch the kernel), ``"cpu"`` for the CPU (run the plain version),
    ``"meta"`` for the meta device (outputs of the right shape and dtype,
    nothing computed: the dry-run's route, see :func:`meta_launch`); any
    other device raises."""
    if device.type in ("cuda", "cpu", "meta"):
        return device.type
    raise ValueError(f"no {kernel} kernel for device {device}")


#: The accounting modes open in this thread, innermost last
#: (``repro_torch.launch.hlo_analysis.Accounting`` pushes itself here).
#: Each wrapper reports its kernel's work to them (:func:`accounted`).
ACCOUNTS: list = []


@contextlib.contextmanager
def accounted(name: str, work: tuple):
    """Around one wrapper call on any route: report kernel ``name``'s
    useful ``work`` (flops, bytes) to every open accounting mode, which
    counts the call as one opaque kernel and does not count again the
    torch ops run inside it (the plain version's, the outputs'
    allocation)."""
    for acct in ACCOUNTS:
        acct.kernel(name, *work)
    try:
        yield
    finally:
        for acct in ACCOUNTS:
            acct.kernel_done()


def meta_launch(wrapper) -> None:
    """A launch on the meta route: adds one to ``wrapper.meta_launches``
    (never to ``wrapper.launches``, which counts the card's launches)."""
    wrapper.meta_launches += 1


#: While a CUDA graph is captured inside :func:`capturing`, the launches
#: the capture records, by wrapper.
_captured: dict | None = None


@contextlib.contextmanager
def capturing():
    """Around a CUDA graph's capture: yields a dict that :func:`launch`
    fills with each wrapper's launches recorded by the capture, which
    runs nothing, so they are not added to ``wrapper.launches``.  The
    graph's owner adds them there at each replay (``launch.serve.
    DecodeGraph``)."""
    global _captured
    outer, _captured = _captured, {}
    try:
        yield _captured
    finally:
        _captured = outer


def launch(wrapper, name: str, entry: str, argtypes: list,
           device: torch.device, *args) -> None:
    """Call C ``entry`` of kernel ``name`` with ``args`` and the current
    stream of ``device``; raise if it returned a CUDA error
    (``cudaGetLastError()`` right after the launch: a refused launch never
    runs, and a later synchronize would not report it); else add one to
    ``wrapper.launches``, or, while the stream is captured into a CUDA
    graph, to the count of :func:`capturing` (a capture outside it
    raises: its replays would launch kernels that no count sees)."""
    lib = library(name, entry, argtypes)
    with torch.cuda.device(device):
        captured = torch.cuda.is_current_stream_capturing()
        if captured and _captured is None:
            raise RuntimeError(f"{name} launched under a CUDA graph capture "
                               f"outside build.capturing(): its replays "
                               f"would not be counted")
        code = getattr(lib, entry)(*args,
                                   torch.cuda.current_stream().cuda_stream)
    if code:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code} ({msg})")
    if captured:
        _captured[wrapper] = _captured.get(wrapper, 0) + 1
    else:
        wrapper.launches += 1


__all__ = ["ACCOUNTS", "BUILD_DIR", "KERNELS", "NVCC_FLAGS", "accounted",
           "build", "capturing", "launch", "library", "log_path",
           "meta_launch", "refuse_dtensor", "route"]
