"""Build and bind the hand-written Hopper kernels.

Every CUDA source under `paddle_tpu_torch/csrc/` is compiled by `nvcc`
for `sm_90a` (one `nvcc -c` per source, all started together), and the
objects are linked into ONE shared library with a plain C interface,
loaded with `ctypes`.  The library lands in `build/paddle_tpu_torch/`
at the repo root (listed in .gitignore), named by a hash of the sources
and flags, so a rebuild happens only after a source changes.

The build runs on the first launch of any kernel, never at import: the
CPU tests import every module on a machine with no `nvcc`.  A failed
build raises with nvcc's output; nothing falls back to the plain
versions.

The C entry points take the CUDA device index first, then a dtype code
(`DTYPE_CODES`), raw pointers and sizes, and the stream last; each
returns `cudaGetLastError()` after its launch, which `check` turns into
an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["library", "build", "build_info", "check", "require",
           "cuda_device_index", "dtype_code", "stream_of", "records_grad",
           "DTYPE_CODES",
           "BUILD_DIR", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# argument types of every C entry point (csrc/*.cu, extern "C")
_SIGNATURES = {
    "ptt_rms_norm": (_I, _I, _P, _P, _P, _LL, _I, _F, _P),
    "ptt_rms_norm_plan": (_I, _I, _I, _I, _LL, _P),
    "ptt_add_rms_norm": (_I, _I, _P, _P, _P, _P, _P, _LL, _I, _F, _P),
    "ptt_rms_norm_bwd": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I,
                         _I, _F, _P),
    "ptt_rms_norm_bwd_blocks": (_I, _I, _I, _I, _I, _LL),
    "ptt_rms_norm_bwd_plan": (_I, _I, _I, _I, _P),
    "ptt_rope": (_I, _I, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _LL, _I,
                 _P),
    "ptt_rope_plan": (_I, _I, _I, _I, _LL, _LL, _P),
    "ptt_paged_attention": (_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _F, _I, _P),
    "ptt_paged_attention_body": (_I, _I, _I, _P, _P, _P),
    "ptt_paged_attention_plan": (_I, _I, _I, _I, _I, _I, _P),
    "ptt_flash_fwd": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _I, _I, _I, _F, _I, _P),
    "ptt_flash_bwd": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "ptt_flash_plan": (_I, _I, _I, _I, _I, _I, _P),
    "ptt_fused_adamw": (_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _LL, _F, _F,
                        _F, _F, _F, _F, _F, _F, _F, _I, _P),
    "ptt_ce_rows": (_I, _I, _P, _P, _P, _P, _P, _LL, _I, _P),
    "ptt_ce_rows_plan": (_I, _I, _P, _P, _LL, _I, _P),
    "ptt_quant_matmul": (_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _P),
    "ptt_quant_matmul_clusters": (_I, _I, _I, _I),
    "ptt_quant_matmul_plan": (_I, _P, _I, _I, _I, _I, _I, _I, _P),
}

_lib = None
# what the last build in this process did: seconds spent (in all, and
# each source's nvcc from the common start) and nvcc's output (ptxas
# register / shared-memory / spill report per kernel)
build_info = {"seconds": 0.0, "built": False, "log": "", "path": "",
              "source_seconds": {}}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin): the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs, sorted(CSRC.glob("*.cuh"))


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library unless a build of these exact sources
    exists; returns its path.  Raises RuntimeError with nvcc's output
    when a compile or the link fails."""
    srcs, headers = _sources()
    out = BUILD_DIR / f"libpaddle_tpu_torch_{_digest(srcs + headers)}.so"
    build_info["path"] = str(out)
    if out.exists():
        return out
    nvcc = _nvcc()
    t0 = time.perf_counter()
    work = BUILD_DIR / f"work_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in srcs:
        obj = work / (src.stem + ".o")
        log = work / (src.stem + ".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
                 str(obj)], stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((src, obj, log, proc))
    logs, failed, done = [], [], {}
    while len(done) < len(jobs):
        for src, _, _, proc in jobs:
            if src.name not in done and proc.poll() is not None:
                done[src.name] = round(time.perf_counter() - t0, 1)
        time.sleep(0.1)
    for src, obj, log, proc in jobs:
        rc = proc.wait()
        text = log.read_text()
        logs.append(f"== {src.name} (rc {rc})\n{text}")
        if rc != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           + "\n".join(logs))
    tmp = work / out.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(j[1]) for j in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {out.name} failed:\n{link.stdout}")
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0, built=True,
                      log="\n".join(logs), source_seconds=done)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32, bfloat16 or "
                        f"float16, not {dtype}")
    return DTYPE_CODES[dtype]


def stream_of(device: torch.device) -> int:
    """Raw handle of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str):
    """Raise if a C entry point reported a CUDA error for its launch
    (a cudaError_t code, see driver_types.h)."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def require(cond: bool, msg: str, *tensors):
    """Argument check of a kernel wrapper: raise ValueError unless
    `cond`, naming the shapes and dtypes of `tensors`.  The message is
    a constant so that a passing check formats nothing — the checks run
    on every launch of the decode loop."""
    if not cond:
        got = ", ".join(f"{tuple(t.shape)} {t.dtype}" for t in tensors)
        raise ValueError(f"{msg} (got {got})" if tensors else msg)


def records_grad(*tensors) -> bool:
    """Whether autograd would record an op on `tensors`.  Only then do
    the wrappers go through their autograd.Function: without a graph
    (the decode loop runs under inference_mode) they launch the forward
    kernel directly and skip apply's per-call Python work."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def cuda_device_index(*tensors) -> int:
    """The one CUDA device all `tensors` live on."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs span devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors, got {dev}")
    return dev.index if dev.index is not None else torch.cuda.current_device()
