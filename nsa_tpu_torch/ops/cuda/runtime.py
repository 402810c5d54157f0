"""Build, load and call the port's CUDA kernels.

Every source under ``nsa_tpu_torch/csrc/`` is compiled by its own ``nvcc``
call, all started together, and one more links the objects into one shared
library with a plain C interface, on first use, into
``nsa_tpu_torch/_build/`` (listed in ``.gitignore``), loaded with
``ctypes``.  The library's name carries a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is loaded as it is, with
the build's ``nvcc`` output kept beside it.
Nothing here runs at import time; a missing ``nvcc`` or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_p, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signature of every exported kernel launcher (all return cudaError_t)
SIGNATURES = {
    "nsa_prefill_fwd": [_p] * 9 + [_i] * 7 + [_f, _p],
    "nsa_prefill_bwd_dq": [_p] * 15 + [_i] * 7 + [_f, _p],
    "nsa_prefill_bwd_dkv": [_p] * 14 + [_ll] + [_i] * 7 + [_f, _p],
    # its workspace's bytes at given shapes, written to a long long
    "nsa_prefill_bwd_dkv_workspace": [_i] * 6 + [_p],
    # the one-position decode kernels (rows 2, 3, 6, 7) read the position
    # from a device int32 (a pointer) and so can be replayed in a CUDA graph
    "nsa_decode_select": [_p] * 6 + [_i] * 11 + [_f, _p],
    "nsa_decode_attend": [_p] * 7 + [_i] * 9 + [_f, _p],
    # the two kernels' launch geometry, written to an int array (see the source)
    "nsa_decode_split_plan": [_i] * 5 + [_p],
    "nsa_decode_select_emit": [_p] * 16 + [_i] * 13 + [_f, _p],
    "nsa_decode_attend_fused": [_p] * 19 + [_i] * 11 + [_f, _f, _p],
    "nsa_decode_select_emit_ragged": [_p] * 17 + [_i] * 13 + [_f, _p],
    "nsa_decode_attend_fused_ragged": [_p] * 19 + [_i] * 11 + [_f, _f, _p],
    "nsa_decode_attend_fused_paged": [_p] * 20 + [_i] * 12 + [_f, _f, _p],
    # the two kernels' launch plan, written to an int array (see the source)
    "nsa_decode_attend_ragged_plan": [_i] * 9 + [_p],
    # the ragged emission launch's blocks and shared memory, written to an int array
    "nsa_decode_emit_plan": [_i] * 4 + [_p],
    "nsa_paged_gather": [_p] * 3 + [_i] * 8 + [_p],
    "nsa_flash_attention": [_p] * 4 + [_i] * 6 + [_f, _p],
    # the whole-model decode: a host array of pointers and of ints (see
    # csrc/nsa_decode_mega.cu for their order), their lengths, scale, eps
    "nsa_decode_mega": [_p, _i, _p, _i, _f, _f, _p],
    # its launch plan for the same ints, written to an int array
    "nsa_decode_mega_plan": [_p, _i, _p],
}


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float     # 0.0 when an existing build was loaded
    log: str                 # nvcc's output (ptxas register/smem/spill lines), kept beside it

    def call(self, name: str, *args) -> None:
        """Launch through the C entry point; raise if it reports an error."""
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} failed with cudaError_t {rc}")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def library_path() -> Path:
    """Where the library of the current sources and flags is built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libnsa_kernels_{digest.hexdigest()[:16]}.so"


def require_built() -> None:
    """Raise unless the library is built: processes that share one build
    (the ranks of a mesh) must not race ``nvcc``, so one builds it first
    (``library()``) and the others only load it."""
    if not library_path().is_file():
        raise RuntimeError(f"the kernel library {library_path().name} is not built: build it "
                           f"once (runtime.library()) before starting the ranks")


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library, once per process."""
    path = library_path()
    seconds, log = 0.0, ""
    if not path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            cus = [src for src in _sources() if src.suffix == ".cu"]
            objs = [os.path.join(tmp, src.stem + ".o") for src in cus]
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                     for src, obj in zip(cus, objs)]
            log = "".join(p.communicate()[0] for p in procs)
            if any(p.returncode for p in procs):
                raise RuntimeError(f"nvcc failed:\n{log}")
            so = os.path.join(tmp, "lib.so")
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs],
                                  capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to link ({proc.returncode}):\n{log}")
            path.with_suffix(".log").write_text(log)
            os.replace(so, path)
        seconds = time.perf_counter() - t0
    elif path.with_suffix(".log").is_file():
        log = path.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=path, build_seconds=seconds, log=log)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (a wrapper then runs its plain
    version), False when all lie on one CUDA device; raise otherwise."""
    devices = {x.device for x in tensors}
    if all(dev.type == "cpu" for dev in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError("kernel operands must all be on one CUDA device or all "
                         f"on the CPU, got {sorted(map(str, devices))}")
    return False


def check(name: str, x: torch.Tensor, dtype: torch.dtype, shape) -> int:
    """Validate one kernel operand and return its data pointer; ``None`` in
    ``shape`` matches any size."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, the kernel takes {dtype}")
    if x.dim() != len(shape) or any(
        s is not None and s != xs for s, xs in zip(shape, x.shape)
    ):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, the kernel takes {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")
    return x.data_ptr()


def device_position(t, like: torch.Tensor) -> torch.Tensor:
    """The position ``t`` as the one-position decode kernels read it: one
    int32 in ``like``'s device memory.  An int is written there by a fill
    (no host sync); a tensor must already be one, a 0-d int32 on that
    device (a captured decode step's position, advanced on the device)."""
    if not isinstance(t, torch.Tensor):
        return torch.full((), int(t), dtype=torch.int32, device=like.device)
    if t.dim() != 0 or t.dtype != torch.int32 or t.device != like.device:
        raise ValueError(f"a device position is a 0-d int32 tensor on {like.device}; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t


def stream_of(x: torch.Tensor) -> int:
    """The current CUDA stream of the tensor's device, as a pointer."""
    return torch.cuda.current_stream(x.device).cuda_stream
