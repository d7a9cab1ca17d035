"""Build the CUDA kernels with ``nvcc`` at first use, load them with ctypes,
and check what the wrappers hand them.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C entry
point, so the sources compile in parallel and no source includes PyTorch's
headers. Libraries go to ``kernels/build/`` (git-ignored), named by a hash
of the sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. A build that fails raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("flash_attention", "flash_attention_bwd", "decode_attention", "fused_xent")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use "
                       "and need the CUDA toolkit on PATH or in /usr/local/cuda")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, all ``nvcc``
    processes at once. Returns the compiler's output (ptxas register and
    spill report) for each library it built."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            os.unlink(tmp)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))


# Element-type codes of the C entry points (csrc/common.cuh).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def refuse_graph(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise when a forward wrapper is called where autograd would record a
    graph: the wrappers compute values only and would silently drop it.
    ``ops`` differentiates them through ``torch.autograd.Function``s, whose
    forward runs with grad mode off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel}: the kernel wrapper is forward only; call "
                           f"repro_torch.kernels.ops.{kernel}, which differentiates it, "
                           "or call the wrapper under torch.no_grad()")


def check_tensors(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise unless the tensors are what a kernel takes: CUDA, one device,
    one element type of DTYPE_CODES, and a dense last dimension."""
    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: the kernel takes CUDA tensors, got {t.device}")
        if t.device != first.device:
            raise ValueError(f"{kernel}: tensors on {first.device} and {t.device}")
        if t.dtype != first.dtype or t.dtype not in DTYPE_CODES:
            raise TypeError(f"{kernel}: needs one dtype among float32/bfloat16, "
                            f"got {[x.dtype for x in tensors]}")
        if t.stride(-1) != 1:
            raise ValueError(f"{kernel}: the last dimension must be dense, "
                             f"got strides {t.stride()}")


def check_dense(kernel: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    """Raise unless ``t`` is a dense (contiguous) ``dtype`` tensor of ``shape``
    on ``device``: the side inputs of a kernel (labels, log-sum-exp)."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{kernel}: needs a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device} (contiguous: {t.is_contiguous()})")


def stream_handle(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
