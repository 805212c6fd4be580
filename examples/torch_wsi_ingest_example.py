"""End-to-end WSI tile ingest on the card: native double-buffered reads,
a page-locked copy, and the Macenko transform (PyTorch / CUDA port).

Connects :class:`stainx_tpu_torch.io.RawTileLoader` (a pool of C++ reader
threads filling two slots) to :class:`stainx_tpu_torch.StainNormalizerTransform`
on ``cuda:0``, and measures sustained throughput including host IO:

- ``ingest-only``  — the reader threads alone, disk (or page cache) → the
  page-locked slots the card path reads from;
- ``copy-only``    — one batch's bytes, page-locked host → card, repeated;
- ``compute-only`` — the transform alone on a batch resident on the card;
- ``end-to-end``   — the overlapped loop: the readers fill batch k+1 and a
  side stream copies it while the card transforms batch k.

Perfect overlap runs at the slowest leg's speed, so the overlap efficiency
is that leg's time over the end-to-end time, and the slowest leg names the
bound. The counterpart of ``examples/wsi_ingest_example.py``; it imports no
JAX.

Run: ``python examples/torch_wsi_ingest_example.py [--tiles 256] [--batch 32] [--size 512]``
"""

from __future__ import annotations

import argparse
import math
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from stainx_tpu_torch import StainNormalizerTransform  # noqa: E402
from stainx_tpu_torch.io import RawTileLoader, TilePipe, tilepipe_available  # noqa: E402
from stainx_tpu_torch.testing import synthetic_he_batch  # noqa: E402

CHUNK = 64  # tiles synthesized at a time


def write_tile_store(root: Path, n_tiles: int, size: int, seed: int = 0) -> list[Path]:
    """A synthetic WSI tile store: one raw uint8 (3, size, size) tile per
    file, Beer–Lambert H&E tiles made from ``seed`` in chunks of 64."""
    files = []
    for start in range(0, n_tiles, CHUNK):
        chunk = synthetic_he_batch(min(CHUNK, n_tiles - start), size, size,
                                   seed=seed + start // CHUNK)
        for j, tile in enumerate(chunk):
            files.append(root / f"tile_{start + j:05d}.raw")
            tile.tofile(files[-1])
    return files


def measure(files, tile_shape, batch_size: int, transform) -> dict:
    """Seconds for each leg over the whole store (``len(loader)`` batches,
    the remainder dropped) and the end-to-end loop, and the host link's rate
    in bytes/s from the copy-only leg. Every leg runs once before it is
    timed (page cache, page-locked allocations, the transform's first
    call)."""
    dev = torch.device("cuda", 0)

    def loader(on):
        return RawTileLoader(files, tile_shape, batch_size, drop_remainder=True, device=on)

    n_batches = len(loader("cpu"))
    tile_bytes = math.prod(tile_shape)
    batch_bytes = batch_size * tile_bytes
    host = torch.empty(batch_bytes, dtype=torch.uint8, pin_memory=True)
    on_card = torch.empty(batch_bytes, dtype=torch.uint8, device=dev)
    resident = None
    for batch in loader(dev):  # the warm-up pass
        resident = batch
        transform(batch)
    torch.cuda.synchronize(dev)
    slots = [torch.empty(batch_bytes, dtype=torch.uint8, pin_memory=True) for _ in range(2)]

    def ingest():
        # The card path's read leg: the readers filling two page-locked
        # slots that stay allocated (a CPU-device loader allocates and
        # faults in fresh slots every pass). Without the native reader, the
        # numpy route of a CPU-device loader.
        if not tilepipe_available():
            for _ in loader("cpu"):
                pass
            return
        batches = [files[i * batch_size:(i + 1) * batch_size] for i in range(n_batches)]
        offsets, lengths = [j * tile_bytes for j in range(batch_size)], [tile_bytes] * batch_size
        pipe = TilePipe(batch_bytes, 2, buffers=slots)
        try:
            for i in range(min(2, n_batches)):
                pipe.enqueue(i, batches[i], offsets, lengths)
            for i in range(n_batches):
                pipe.wait(i % 2)
                if i + 2 < n_batches:
                    pipe.enqueue(i % 2, batches[i + 2], offsets, lengths)
        finally:
            pipe.close()

    def copy():
        for _ in range(n_batches):
            on_card.copy_(host, non_blocking=True)

    def compute():
        for _ in range(n_batches):
            transform(resident)

    def end_to_end():
        for batch in loader(dev):
            transform(batch)

    times = {}
    for name, fn in (("ingest-only", ingest), ("copy-only", copy), ("compute-only", compute),
                     ("end-to-end", end_to_end)):
        fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)  # the device queue is in order: all done
        times[name] = time.perf_counter() - t0
    return {"seconds": times, "batches": n_batches, "batch_bytes": batch_bytes,
            "link_bytes_per_s": batch_bytes * n_batches / times["copy-only"]}


def report(result: dict, batch_size: int, size: int, out=print) -> None:
    """Each leg in ms a batch, img/s and MPix/s, the host link's rate, and
    the overlap efficiency (the slowest leg's time over the end-to-end
    time)."""
    n_batches = result["batches"]
    n_imgs = n_batches * batch_size
    mpix = n_imgs * size * size / 1e6
    for name, t in result["seconds"].items():
        out(f"{name:13s}: {1e3 * t / n_batches:9.4f} ms/batch {n_imgs / t:9.1f} img/s "
            f"{mpix / t:9.1f} MPix/s ({t:.4f} s)")
    out(f"host link (page-locked → card): {result['link_bytes_per_s'] / 1e9:.2f} GB/s, "
        f"{result['batch_bytes'] / 1e6:.1f} MB a batch")
    legs = {k: v for k, v in result["seconds"].items() if k != "end-to-end"}
    bound = max(legs, key=legs.get)
    overlap = legs[bound] / result["seconds"]["end-to-end"]
    out(f"pipeline is {bound.split('-')[0]}-bound; overlap efficiency {overlap:.1%} "
        f"(end-to-end against the {bound} floor)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("this example runs on a CUDA card and none is available")

    print(f"device: {torch.cuda.get_device_name(0)}, native tilepipe: {tilepipe_available()}")
    with tempfile.TemporaryDirectory(prefix="stainx_wsi_") as td:
        files = write_tile_store(Path(td), args.tiles, args.size)
        reference = synthetic_he_batch(1, args.size, args.size, seed=42)
        transform = StainNormalizerTransform("macenko", reference=reference)
        result = measure(files, (3, args.size, args.size), args.batch, transform)
        report(result, args.batch, args.size)


if __name__ == "__main__":
    main()
