"""Build and load the port's native code, and count kernel launches.

Three shared libraries are compiled at first use, from sources in the
repository only, into ``build/`` at the repository root:

* the BVH builder, ``native/bvh_builder.cpp`` (the same C++ the JAX
  package loads), with ``g++``;
* the OBJ tokenizer, ``native/obj_loader.cpp`` (the JAX package's too),
  with ``g++``;
* the CUDA kernels, ``hybridrenderer_tpu_torch/csrc/*.cu``, with
  ``nvcc`` for ``sm_90a`` into one library with a plain C interface.

Each library's file name carries a hash of its sources and flags, and is
written under a temporary name and renamed into place, so concurrent
processes never load a half-written or stale library. A failed build
raises; there is no fallback.

Every CUDA kernel of the port has a ``Kernel`` record below. Its wrapper
calls ``Kernel.launch``, which runs the C entry point on the current
stream, raises on a CUDA error, and adds one to the launch count. A
plain PyTorch version that runs on a CUDA tensor adds one to
``plain_cuda_calls`` instead, so a run can show which path it took.
A CUDA graph's replay runs no Python: the renderer takes the counts a
capture added (``counts`` before and after), puts them back, and adds
them again at every replay (``add_counts``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(REPO_ROOT, "build")

BVH_SOURCE = os.path.join(REPO_ROOT, "native", "bvh_builder.cpp")
OBJ_SOURCE = os.path.join(REPO_ROOT, "native", "obj_loader.cpp")
# native/Makefile builds with -march=native, where g++ contracts the SAH
# cost's multiply-adds into FMAs; x86-64-v3 has FMA too, so the tree is
# identical to the JAX package's, and the library runs on any x86-64 host
# from Haswell on
BVH_FLAGS = ["-O3", "-march=x86-64-v3", "-fPIC", "-std=c++17", "-shared"]

CUDA_SOURCES = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))
CUDA_HEADERS = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh")))
# -fmad=false: no multiply-add contraction, so a kernel doing the same
# float operations in the same order as its plain PyTorch version gets
# the same bits (PyTorch's eager elementwise ops round every step)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def _digest(paths, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def _build(out_path, cmd_for):
    """Run ``cmd_for(tmp_path)`` and move the result to ``out_path``;
    the compiler's output goes to ``out_path + '.log'``."""
    if os.path.exists(out_path):
        return out_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out_path}.{os.getpid()}.tmp"
    cmd = cmd_for(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    with open(out_path + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"build failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr[-4000:]}")
    os.replace(tmp, out_path)
    return out_path


@functools.cache
def bvh_library() -> ctypes.CDLL:
    """The native BVH builders (binned SAH and LBVH), compiled with g++
    at first use."""
    lib = ctypes.CDLL(_host_library(BVH_SOURCE, "libhr_bvh"))
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    for fn in (lib.hrtpu_build_sah, lib.hrtpu_build_lbvh):
        fn.argtypes = [fp, fp, fp, ctypes.c_int64, fp, fp, ip, ip, ip]
        fn.restype = ctypes.c_int
    return lib


def _gxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native code cannot be built")
    return cxx


def _host_library(source, stem) -> str:
    """``source`` compiled with g++ into build/, at first use."""
    path = os.path.join(BUILD_DIR,
                        f"{stem}-{_digest([source], BVH_FLAGS)}.so")
    cxx = _gxx()
    return _build(path, lambda out: [cxx, *BVH_FLAGS, "-o", out, source])


@functools.cache
def obj_library() -> ctypes.CDLL:
    """The native OBJ tokenizer, compiled with g++ at first use; its
    entry points are declared by scene/loader_native.py."""
    return ctypes.CDLL(_host_library(OBJ_SOURCE, "libhr_obj"))


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def kernel_library_path() -> str:
    digest = _digest(CUDA_SOURCES + CUDA_HEADERS, NVCC_FLAGS)
    return os.path.join(BUILD_DIR, f"libhr_kernels-{digest}.so")


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name → argument types (every one ends with the stream)
_SIGNATURES = {
    "hr_raster_tiles": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                        _P, _P, _P],
    "hr_trace_packet": [_P, _P, _I, _P, _P, _P, _P, _F, _I, _I, _I, _P, _P,
                        _P, _P, _P],
    "hr_trace_any": [_P, _P, _I, _P, _P, _P, _P, _F, _I, _I, _P, _P],
    "hr_trace_closest": [_P, _P, _I, _P, _P, _P, _P, _F, _I, _I, _P, _P, _P,
                         _P, _P],
    "hr_trace_wide": [_P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _F, _I, _I,
                      _P, _P, _P, _P, _P, _P],
    "hr_trace_mimt": [_P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _F, _I, _I,
                      _P, _P, _P, _P, _P, _P],
    "hr_temporal_fetch": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _I, _P, _P],
    "hr_window_sample": [_P, _I, _I, _I, _P, _I, _P, _P],
    "hr_atrous": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "hr_filter_moments": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    "hr_variance_blur": [_P, _I, _I, _P, _P],
    "hr_shade_hit": [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int64, _I,
                     _P, _P, _P, _P, _P],
    "hr_shade_finish": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    "hr_taa_reproject": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                         _P],
    "hr_taa_resolve": [_P, _P, _P, _I, _I, _P, _P],
}


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """The CUDA kernels, compiled with nvcc for sm_90a at first use."""
    nvcc = nvcc_path()
    path = kernel_library_path()
    _build(path, lambda out: [nvcc, *NVCC_FLAGS, "-o", out, *CUDA_SOURCES])
    lib = ctypes.CDLL(path)
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.hr_trace_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.hr_trace_info.restype = ctypes.c_int
    lib.hr_error_string.argtypes = [ctypes.c_int]
    lib.hr_error_string.restype = ctypes.c_char_p
    return lib


@dataclasses.dataclass
class Kernel:
    """One hand-written CUDA kernel of the port."""

    name: str
    source: str     # path in the repository
    replaces: str   # file:line of the TPU kernel
    # whether a render path launches it; variance_blur's output feeds
    # nothing in the reference, so the frame skips it (ops/svgf.py)
    on_path: bool = True
    launches: int = 0
    plain_cuda_calls: int = 0

    def launch(self, entry: str, *args):
        """Run C entry point ``entry`` on the current CUDA stream."""
        import torch

        lib = kernel_library()
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} "
                               f"({lib.hr_error_string(rc).decode()})")
        self.launches += 1

    def note_plain(self, tensor):
        if tensor.is_cuda:
            self.plain_cuda_calls += 1


_CSRC = "hybridrenderer_tpu_torch/csrc/"
_TPU = "hybridrenderer_tpu/ops/"
KERNELS = {
    k.name: k for k in (
        Kernel("raster_tiles", _CSRC + "raster.cu",
               _TPU + "raster_pallas.py:784"),
        # K1's keyed vis-only mode (csrc/raster.cu), counted on its own
        Kernel("raster_vis", _CSRC + "raster.cu",
               _TPU + "raster_pallas.py:519"),
        # K1's bf16 attribute mode (raster_attr_bits=16), counted on its own
        Kernel("raster_tiles_bf16", _CSRC + "raster.cu",
               _TPU + "raster_pallas.py:784"),
        Kernel("trace_any", _CSRC + "trace.cu",
               _TPU + "trace_pallas.py:869"),
        Kernel("trace_closest", _CSRC + "trace.cu",
               _TPU + "trace_pallas.py:869"),
        Kernel("trace_packet", _CSRC + "trace.cu",
               _TPU + "trace_pallas.py:132"),
        Kernel("trace_wide", _CSRC + "trace.cu",
               _TPU + "trace_pallas.py:457"),
        Kernel("trace_mimt", _CSRC + "trace.cu",
               _TPU + "trace_pallas.py:1518"),
        Kernel("temporal_fetch", _CSRC + "temporal.cu",
               _TPU + "temporal_pallas.py:55"),
        Kernel("window_sample", _CSRC + "temporal.cu",
               _TPU + "temporal_pallas.py:264"),
        Kernel("atrous", _CSRC + "stencil.cu",
               _TPU + "stencil_pallas.py:183"),
        Kernel("filter_moments", _CSRC + "stencil.cu",
               _TPU + "stencil_pallas.py:246"),
        Kernel("variance_blur", _CSRC + "stencil.cu",
               _TPU + "stencil_pallas.py:308", on_path=False),
        # radiance hit shading around its occlusion query (closesthit.rchit
        # and miss.rmiss): plain jnp in the reference, no TPU kernel
        Kernel("shade_hit", _CSRC + "shade.cu", _TPU + "trace.py:703"),
        Kernel("shade_finish", _CSRC + "shade.cu", _TPU + "trace.py:691"),
        # TAA's resolve around K5 (taa.comp): plain jnp in the reference,
        # no TPU kernel
        Kernel("taa_reproject", _CSRC + "taa.cu", _TPU + "taa.py:52"),
        Kernel("taa_resolve", _CSRC + "taa.cu", _TPU + "taa.py:52"),
    )
}


def reset_counts():
    for k in KERNELS.values():
        k.launches = 0
        k.plain_cuda_calls = 0


def counts() -> dict:
    """Every kernel's (launches, plain_cuda_calls)."""
    return {n: (k.launches, k.plain_cuda_calls) for n, k in KERNELS.items()}


def set_counts(c: dict):
    for n, (launches, plain) in c.items():
        KERNELS[n].launches, KERNELS[n].plain_cuda_calls = launches, plain


def add_counts(delta: dict):
    """Add a captured graph's launches and plain calls, at its replay."""
    for n, (launches, plain) in delta.items():
        KERNELS[n].launches += launches
        KERNELS[n].plain_cuda_calls += plain


def ptr(t) -> int:
    """Device pointer of a tensor, for a ctypes c_void_p argument."""
    return t.data_ptr()


def aligned(t, nbytes=16):
    """``t``, or a copy of it whose data starts on an ``nbytes`` boundary
    (a view's offset can break the alignment vector loads need)."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def check(t, name, dtype, shape, device):
    """Raise unless ``t`` has the dtype, shape and device given and is
    contiguous (``None`` in ``shape`` matches any size)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if len(t.shape) != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
