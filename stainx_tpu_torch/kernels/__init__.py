"""Hand-written CUDA kernels for Hopper, built at first use.

Counterpart of ``stainx_tpu/kernels/__init__.py``. Each ``csrc/*.cu`` source
is compiled by ``nvcc`` for ``sm_90a`` into its own shared library with a
plain C interface, under ``build/stainx_tpu_torch/`` at the root of the
checkout (``build/`` is git-ignored), and loaded with :mod:`ctypes`. Every
source is compiled by its own ``nvcc`` process, all started together. A
library's file name carries a hash of its source, of every shared header
(``csrc/*.cuh``) and of the flags, so an edited source or header is rebuilt
and never confused with an old build.

Nothing here runs at import time: the CPU path never builds, and a failed
build raises instead of falling back. The input checks and the grid sizing
that the wrappers share live here too.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from stainx_tpu_torch import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "stainx_tpu_torch"

# -fmad=false keeps every a*b+c as a rounded product and a rounded sum, the
# order the plain PyTorch versions evaluate in, so the on-card comparison of
# a kernel with its plain version sees only summation-order and libm ulps.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The ``nvcc`` on ``PATH``, else ``$CUDA_HOME/bin/nvcc`` (or
    ``$CUDA_PATH``, or ``/usr/local/cuda``); raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")


def _lib_path(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no current build, one ``nvcc``
    per source, all in parallel, each counted in ``build.nvcc``. Returns
    ``{source stem: library path}``. Raises ``RuntimeError`` with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {src.stem: (src, _lib_path(src)) for src in sorted(CSRC.glob("*.cu"))}
    procs = {}
    for stem, (src, lib) in paths.items():
        if lib.is_file():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[stem] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            lib,
        )
    failures = []
    for stem, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {stem}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
            profiling.count("build.nvcc")
    if failures:
        raise RuntimeError("\n".join(failures))
    return {stem: lib for stem, (_src, lib) in paths.items()}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, building all sources first
    if needed. Declares the shared error-string helper."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[stem]))
            lib.stainx_error_string.argtypes = [ctypes.c_int]
            lib.stainx_error_string.restype = ctypes.c_char_p
            _libs[stem] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code other than 0."""
    if code != 0:
        msg = lib.stainx_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def check_rgb_batch(images: torch.Tensor, what: str) -> None:
    """Raise unless ``images`` is an (N, 3, H, W) uint8 or float32 tensor,
    what the Macenko and Reinhard kernels take."""
    if images.dim() != 4 or images.shape[1] != 3:
        raise ValueError(f"{what} expects (N, 3, H, W) images, got shape {tuple(images.shape)}")
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"{what} takes uint8 or float32 images, got {images.dtype}")


def check_cuda(tensor: torch.Tensor, what: str) -> None:
    """Raise unless ``tensor`` is a contiguous CUDA tensor, as a kernel reads
    it (a CPU tensor never gets here: the wrappers run the plain version)."""
    if tensor.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {tensor.device}; expected a CUDA or CPU tensor")
    if not tensor.is_contiguous():
        raise ValueError(f"{what} needs a contiguous tensor")


def current_stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream, for a launch
    from C: what ``torch.cuda.current_stream(device).cuda_stream`` gives,
    without building a ``Stream`` object each call (host time that a small,
    host-bound call such as the small-patch transform pays in full)."""
    return torch._C._cuda_getCurrentRawStream(torch.device(device).index)


def on_device(device):
    """``torch.cuda.device(device)`` for a launch from C, or nothing when
    ``device`` (a device or an index) is already the current one."""
    index = device if isinstance(device, int) else torch.device(device).index
    if torch.cuda.current_device() == index:
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def ceil_to(v: int, q: int) -> int:
    """``v`` rounded up to a multiple of ``q``."""
    return -(-v // q) * q


@functools.cache
def device_limits(index: int) -> tuple[int, int]:
    """(SMs, opt-in shared memory a block in bytes) of CUDA device
    ``index``, read once per device."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def grid_blocks(items: int, device: torch.device) -> int:
    """Blocks of a grid-stride launch of 256-thread blocks over ``items``
    work items, one a thread, at most 8 blocks (2048 threads) an SM."""
    sms = device_limits(torch.device(device).index)[0]
    return max(1, min(-(-items // 256), sms * 8))


def row_blocks(rows: int, items: int, device: torch.device) -> int:
    """Blocks a row gets in a (blocks, rows) launch of 256-thread blocks over
    rows of ``items`` work items each: about 8 blocks (2048 threads) an SM
    over all rows, at least one a row, and no more than one per 256 items."""
    sms = device_limits(torch.device(device).index)[0]
    return max(1, min(-(-sms * 8 // max(rows, 1)), -(-items // 256)))


MAX_GRID_X = 2**31 - 1  # a launch's x extent; y and z stop at 65 535


def folded_grid(items: int, blocks: int, what: str) -> int:
    """Blocks of a one-dimensional launch that folds ``items`` rows (or
    images) of ``blocks`` blocks each into the grid's x extent, where the
    kernel finds its item as ``blockIdx.x / blocks``: any number of items
    up to 2³¹ − 1 blocks in all. Raises past that."""
    total = items * blocks
    if total > MAX_GRID_X:
        raise ValueError(f"{what}: {items} rows of {blocks} blocks exceed a grid of "
                         f"{MAX_GRID_X} blocks")
    return total
