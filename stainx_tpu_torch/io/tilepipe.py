"""ctypes wrapper and batch iterator over the native tilepipe reader.

Counterpart of ``stainx_tpu/io/tilepipe.py``. The shared library builds
from this package's own ``tilepipe.cpp`` with ``g++`` at first use, into
``build/stainx_tpu_torch/`` under a name that hashes the source and the
flags (the CUDA libraries' rule, :mod:`stainx_tpu_torch.kernels`); it is
compiled to a per-process temporary file and moved into place with
``os.replace``, so a concurrent process never loads a half-written file.
Without a toolchain the loader reads with ``np.fromfile`` and gives the same
batches: :func:`tilepipe_available` says which route runs.

:class:`RawTileLoader` follows the port's device rule. On ``device="cpu"``
it yields CPU uint8 tensors that are zero-copy views of the reader's slots,
with the JAX loader's lifetime contract. On a CUDA device (``None`` means
``cuda:0``) it yields CUDA uint8 tensors the caller owns: the readers fill
page-locked host tensors (the slots are handed to ``tp_open``), and each
batch is copied to the card from there with ``non_blocking`` on a side
stream, which the consumer's stream waits on.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading
from collections.abc import Callable, Iterator, Sequence
from pathlib import Path

import numpy as np
import torch

from stainx_tpu_torch.kernels import BUILD_DIR
from stainx_tpu_torch.utils import get_device

SRC = Path(__file__).resolve().with_name("tilepipe.cpp")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread", "-std=c++17")
N_SLOTS = 2  # double buffering: the readers fill one slot while the other is consumed

_lock = threading.Lock()
_loaded: dict[str, object] = {}


def lib_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return Path(build_dir) / f"libtilepipe_{digest}.so"


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``tilepipe.cpp`` into ``build_dir`` unless its library is
    there already; returns the library's path. Raises ``OSError`` when
    ``g++`` is missing and ``subprocess.CalledProcessError`` when it fails."""
    lib = lib_path(build_dir)
    if not lib.is_file():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                           capture_output=True)
            os.replace(tmp, lib)
        finally:
            tmp.unlink(missing_ok=True)
    return lib


def _load_library() -> ctypes.CDLL | None:
    with _lock:
        if "lib" not in _loaded:
            try:
                lib = ctypes.CDLL(str(build_library()))
            except (OSError, subprocess.CalledProcessError) as exc:
                _loaded["lib"], _loaded["error"] = None, f"{type(exc).__name__}: {exc}"
            else:
                lib.tp_open.restype = ctypes.c_void_p
                lib.tp_open.argtypes = [ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
                lib.tp_enqueue.restype = ctypes.c_int
                lib.tp_enqueue.argtypes = [
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
                    ctypes.c_int,
                ]
                lib.tp_wait.restype = ctypes.c_int
                lib.tp_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.tp_buffer.restype = ctypes.POINTER(ctypes.c_uint8)
                lib.tp_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.tp_close.restype = None
                lib.tp_close.argtypes = [ctypes.c_void_p]
                _loaded["lib"], _loaded["error"] = lib, None
        return _loaded["lib"]


def tilepipe_available() -> bool:
    """True when the native reader built and loaded."""
    return _load_library() is not None


class TilePipe:
    """Low-level handle: ``n_slots`` slots of ``slot_bytes`` and a pool of
    ``n_threads`` reader threads. ``buffers``: None for slots the library
    allocates, or ``n_slots`` contiguous CPU uint8 tensors of at least
    ``slot_bytes`` each, which the pipe keeps alive until :meth:`close`."""

    def __init__(self, slot_bytes: int, n_slots: int = 2, n_threads: int = 4,
                 buffers: Sequence[torch.Tensor] | None = None):
        if slot_bytes <= 0 or n_slots < 1 or n_threads < 1:
            # tp_open rejects these too (returning null), but zero threads
            # would deadlock the first wait(): say why here.
            raise ValueError(
                f"tilepipe needs slot_bytes > 0, n_slots >= 1, n_threads >= 1 "
                f"(got {slot_bytes}, {n_slots}, {n_threads})"
            )
        ptrs = None
        if buffers is not None:
            buffers = list(buffers)
            if len(buffers) != n_slots or not all(
                    b.device.type == "cpu" and b.dtype == torch.uint8 and b.is_contiguous()
                    and b.numel() >= slot_bytes for b in buffers):
                raise ValueError(f"tilepipe buffers must be {n_slots} contiguous CPU uint8 "
                                 f"tensors of at least {slot_bytes} bytes")
            ptrs = (ctypes.c_void_p * n_slots)(*(b.data_ptr() for b in buffers))
        lib = _load_library()
        if lib is None:
            raise RuntimeError(f"tilepipe native library unavailable ({_loaded['error']})")
        self._lib = lib
        self._buffers = buffers
        self.slot_bytes = slot_bytes
        self.n_slots = n_slots
        self._handle = lib.tp_open(slot_bytes, n_slots, n_threads, ptrs)
        if not self._handle:
            raise MemoryError("tilepipe: slot allocation failed")

    def enqueue(self, slot: int, files: Sequence[str | os.PathLike], offsets: Sequence[int],
                lengths: Sequence[int]) -> None:
        """Start async reads of ``files`` (anything ``os.fspath`` takes)
        into ``slot`` at byte ``offsets``."""
        n = len(files)
        paths_blob = b"\0".join(os.fsencode(p) for p in files) + b"\0"
        off = (ctypes.c_uint64 * n)(*offsets)
        lng = (ctypes.c_uint64 * n)(*lengths)
        if self._lib.tp_enqueue(self._handle, slot, paths_blob, off, lng, n) != 0:
            raise ValueError(f"tilepipe enqueue failed (slot={slot})")

    def wait(self, slot: int) -> None:
        """Block until the slot's reads finish; raises on any failed read."""
        errors = self._lib.tp_wait(self._handle, slot)
        if errors < 0:
            raise ValueError(f"tilepipe: invalid slot {slot} (n_slots={self.n_slots})")
        if errors:
            raise OSError(f"tilepipe: {errors} read(s) failed in slot {slot}")

    def buffer(self, slot: int) -> np.ndarray:
        """Zero-copy uint8 view of the slot buffer (valid until close)."""
        ptr = self._lib.tp_buffer(self._handle, slot)
        if not ptr:
            raise ValueError(f"tilepipe: invalid slot {slot} (n_slots={self.n_slots})")
        return np.ctypeslib.as_array(ptr, shape=(self.slot_bytes,))

    def close(self) -> None:
        """Stop the readers (after their queued reads) and free the slots
        the library allocated."""
        if getattr(self, "_handle", None):
            self._lib.tp_close(self._handle)
            self._handle = None
        self._buffers = None

    def __del__(self):  # pragma: no cover
        self.close()


class RawTileLoader:
    """Double-buffered batch iterator over raw uint8 tile files.

    Each file holds one tile of ``tile_shape`` bytes (C-order uint8). While
    batch k is consumed, the reader threads fill batch k+1. Yields
    ``(B, *tile_shape)`` uint8 tensors on ``device`` (module docstring).

    On the CPU they are zero-copy views into the slot buffers: each is
    valid only until its slot is refilled (two iterations later), and all
    die when iteration ends (the buffers are freed), so copy any batch that
    must outlive that. The final batch is yielded as a copy, so
    ``[b for b in loader]`` never holds freed memory. On a CUDA device every
    batch is the caller's; a slot is refilled only after the copy that
    reads it has finished.
    """

    def __init__(
        self,
        files: Sequence[str | os.PathLike],
        tile_shape: tuple[int, ...],
        batch_size: int,
        n_threads: int = 4,
        drop_remainder: bool = False,
        device: str | torch.device | None = None,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be at least 1, got {batch_size}")
        self.files = list(files)
        self.tile_shape = tuple(int(s) for s in tile_shape)
        self.tile_bytes = math.prod(self.tile_shape)
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self.device = get_device(device)
        self._use_native = tilepipe_available()
        self._n_threads = n_threads

    def __len__(self) -> int:
        fn = math.floor if self.drop_remainder else math.ceil
        return fn(len(self.files) / self.batch_size)

    def _batches(self) -> list[list]:
        return [self.files[i * self.batch_size : (i + 1) * self.batch_size]
                for i in range(len(self))]

    def __iter__(self) -> Iterator[torch.Tensor]:
        if self.device.type == "cpu":
            return self._host_batches()
        return self._card_batches()

    def _shape(self, files) -> tuple[int, ...]:
        return (len(files),) + self.tile_shape

    def _enqueue(self, pipe: TilePipe, slot: int, files) -> None:
        pipe.enqueue(slot, files, [j * self.tile_bytes for j in range(len(files))],
                     [self.tile_bytes] * len(files))

    def _read(self, files, out: np.ndarray) -> np.ndarray:
        """The numpy route: ``out[j]`` = file j, read with ``np.fromfile``."""
        for j, path in enumerate(files):
            out[j] = np.fromfile(path, np.uint8, count=self.tile_bytes).reshape(self.tile_shape)
        return out

    def _slots(self, pipe: TilePipe, batches, before_refill: Callable[[int], None] | None = None):
        """``(slot, view, is_last)`` per batch from the native readers; a
        slot is refilled with the batch two steps ahead once the consumer
        asks for the next batch (after ``before_refill(slot)``)."""
        for i, files in enumerate(batches[:N_SLOTS]):
            self._enqueue(pipe, i, files)
        for i, files in enumerate(batches):
            slot = i % N_SLOTS
            pipe.wait(slot)
            view = pipe.buffer(slot)[: len(files) * self.tile_bytes].reshape(self._shape(files))
            yield slot, view, i == len(batches) - 1
            if i + N_SLOTS < len(batches):
                if before_refill is not None:
                    before_refill(slot)
                self._enqueue(pipe, slot, batches[i + N_SLOTS])

    def _host_batches(self) -> Iterator[torch.Tensor]:
        batches = self._batches()
        if not self._use_native:
            for files in batches:
                yield torch.from_numpy(self._read(files, np.empty(self._shape(files), np.uint8)))
            return
        pipe = TilePipe(self.batch_size * self.tile_bytes, N_SLOTS, self._n_threads)
        try:
            for _, view, last in self._slots(pipe, batches):
                # The final view would dangle once the loop ends and close()
                # frees the slots: hand it out as a copy.
                yield torch.from_numpy(view.copy() if last else view)
        finally:
            pipe.close()

    def _card_batches(self) -> Iterator[torch.Tensor]:
        dev = self.device
        slot_bytes = self.batch_size * self.tile_bytes
        staging = [torch.empty(slot_bytes, dtype=torch.uint8, pin_memory=True)
                   for _ in range(N_SLOTS)]
        copy_stream = torch.cuda.Stream(dev)
        copied: list[torch.cuda.Event | None] = [None] * N_SLOTS

        def release(slot: int) -> None:
            # No reader refills a slot while an async copy still reads it.
            if copied[slot] is not None:
                copied[slot].synchronize()

        def to_card(slot: int, shape) -> torch.Tensor:
            host = staging[slot][: math.prod(shape)].view(shape)
            consumer = torch.cuda.current_stream(dev)
            with torch.cuda.stream(copy_stream):
                out = torch.empty(shape, dtype=torch.uint8, device=dev)
                out.copy_(host, non_blocking=True)
                done = torch.cuda.Event()
                done.record(copy_stream)
            consumer.wait_event(done)
            out.record_stream(consumer)
            copied[slot] = done
            return out

        batches = self._batches()
        pipe = None
        try:
            if self._use_native:
                pipe = TilePipe(slot_bytes, N_SLOTS, self._n_threads, buffers=staging)
                for slot, view, _ in self._slots(pipe, batches, release):
                    yield to_card(slot, view.shape)
            else:
                for i, files in enumerate(batches):
                    slot = i % N_SLOTS
                    release(slot)
                    self._read(files, staging[slot].numpy()[: len(files) * self.tile_bytes]
                               .reshape(self._shape(files)))
                    yield to_card(slot, self._shape(files))
        finally:
            # The readers and the copies stop using the staging tensors
            # before they can be freed.
            if pipe is not None:
                pipe.close()
            for slot in range(N_SLOTS):
                release(slot)
