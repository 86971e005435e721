"""Build and load the hand-written CUDA kernels of ``sesa_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Builds go
to ``<BUILD_ROOT>/<hash>/``, keyed by a hash of every source and header plus
the flags, so an edited source rebuilds and an unchanged one loads at once.
``BUILD_ROOT`` is ``cache.cache_dir()`` at import: ``$SESA_CACHE_DIR``, else
``sesa_tpu_torch/build``. Nothing is built when this module is imported:
the first call that needs a library builds it; ``build_all`` builds every
library in parallel (one ``nvcc`` per source, all started together). A
failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

import torch

from sesa_tpu_torch.cache import cache_dir

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_ROOT = cache_dir()
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of every exported function, by library
SIGNATURES = {
    "attention": {
        "sesa_attn_proj": [_P] * 10 + [_I] * 9 + [_P],
        "sesa_attn_vr": [_P] * 4 + [_I] * 4 + [_P],
        "sesa_attn_core": [_P] * 3 + [_I] * 5 + [_F, _I] + [_L] * 10 + [_I, _I, _P],
        "sesa_attn_out": [_P] * 4 + [_I] * 5 + [_P],
    },
    "ff": {
        "sesa_ff_up": [_P] * 7 + [_I] * 5 + [_P],
        "sesa_ff_down": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    },
    "conformer_attention": {
        "sesa_conf_attn_proj": [_P] * 6 + [_I] * 5 + [_P],
        "sesa_conf_attn_core": [_P] * 4 + [_I] * 5 + [_F, _I] + [_L] * 10 + [_I] * 3 + [_P],
        "sesa_conf_attn_out": [_P] * 5 + [_I] * 5 + [_P],
    },
    "convblock": {
        "sesa_conv_up": [_P] * 7 + [_I] * 5 + [_P],
        "sesa_conv_dw": [_P] * 5 + [_I] * 6 + [_P],
        "sesa_conv_down": [_P] * 5 + [_I] * 5 + [_P],
    },
    "apollo_conv": {
        "sesa_apollo_dw": [_P] * 5 + [_I] * 4 + [_F, _P],
        "sesa_apollo_up": [_P] * 4 + [_I] * 4 + [_P],
        "sesa_apollo_down": [_P] * 5 + [_I] * 4 + [_P],
    },
    "rope_attention": {
        "sesa_rope_attn": [_P] * 4 + [_I] * 12 + [_F, _P],
    },
    "vmem_attention": {
        "sesa_vmem_attn": [_P] * 4 + [_I] + [_L] * 16 + [_I] * 4 + [_F, _P],
    },
    "int8_attention": {
        "sesa_i8_prepass": [_P] * 3 + [_L] * 3 + [_I] * 9 + [_P],
        "sesa_i8_attn": [_I] + [_P] * 6 + [_I] + [_L] * 16 + [_I] * 4 + [_F, _I, _I, _P],
    },
    "ssd": {
        "sesa_ssd": [_P] * 6 + [_I] + [_L] * 4 + [_I] * 6 + [_L, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _lib_path(name: str) -> str:
    return os.path.join(build_dir(), f"lib{name}.so")


def build_all(names=None) -> Dict[str, float]:
    """Build the libraries not built yet, one nvcc each, all in parallel.

    Returns {name: seconds} for the libraries built by this call. The
    compiler's output (with ``-Xptxas -v`` register and shared-memory
    counts) is kept beside each library as ``lib<name>.log``.
    """
    names = list(SIGNATURES) if names is None else list(names)
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        dst = _lib_path(name)
        if os.path.exists(dst):
            continue
        tmp = f"{dst}.{os.getpid()}.tmp"
        log = open(os.path.join(out_dir, f"lib{name}.log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       log, tmp, dst, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, log, tmp, dst, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, dst)
    if failed:
        logs = "\n".join(open(os.path.join(out_dir, f"lib{n}.log")).read()[-4000:]
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if not os.path.exists(_lib_path(name)):
            build_all([name])
        lib = ctypes.CDLL(_lib_path(name))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def refuse_autograd(kernel: str, *inputs) -> None:
    """Raise when autograd would record a launch of ``kernel``: grad mode is
    on and a tensor among ``inputs`` (nested dicts, lists and tuples are
    searched) requires grad. A kernel called through ``ctypes`` returns a
    tensor with no ``grad_fn``, so training through it would leave every
    parameter upstream of the call without a gradient, silently. Each
    wrapper calls this on the non-CPU path, before anything else: the plain
    versions that CPU tensors run are differentiable."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in _tensors(inputs)):
        raise RuntimeError(
            f"{kernel}: the hand-written CUDA kernel has no backward (the JAX package has "
            "no backward for its Pallas kernel either), and an input requires grad under "
            "grad mode; run it under torch.no_grad(), or train the model in f32, whose "
            "path launches no kernel (bs_mamba2's f32 path launches K8)")


def refuse_export(kernel: str) -> None:
    """Raise ``ValueError`` naming ``kernel`` when ``torch.export`` traces a
    launch of it: a kernel called through ``ctypes`` is no op the trace can
    record (its fake tensors hold no memory to hand the kernel). Each
    wrapper calls this on the non-CPU path, where it would launch; the plain
    versions that CPU tensors run export as they are."""
    if torch.compiler.is_exporting():
        raise ValueError(
            f"{kernel}: torch.export cannot trace the hand-written CUDA kernel (a ctypes "
            "call); export on the CPU, where its plain version runs, or a path that "
            "launches no kernel (the f32 forward of every model but bs_mamba2)")


def check_tensor(kernel: str, name: str, t, shape, dtype) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    ``dtype`` and ``shape`` (the kernels read 16-byte chunks)."""
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f"{kernel}: {name} must be a contiguous, 16-byte aligned CUDA {dtype} tensor "
            f"of shape {tuple(shape)}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned an error: a CUDA error
    code, or (csrc/hopper.cuh) 9000 for a CUDA driver without the
    tensor-map encoder and 10000 + the CUresult of a tensor map the CUDA
    driver refused."""
    if rc == 9000:
        raise RuntimeError(f"{what}: the CUDA driver has no cuTensorMapEncodeTiled")
    if rc >= 10000:
        raise RuntimeError(f"{what}: the CUDA driver refused a TMA tensor map "
                           f"(CUresult {rc - 10000})")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
