"""The port's tile-ingest path (``stainx_tpu_torch.io``) on the CPU, against
``stainx_tpu.io`` on the same files.

The counterparts of ``tests/test_io.py`` for the port's loader on
``device="cpu"``; its batches byte-equal to the JAX loader's on the native
route and on the numpy route; the port's library built under
``build/stainx_tpu_torch/`` and never in ``stainx_tpu/io/``; and the slice
end to end: the loader feeding the port's ``StainNormalizerTransform``
against the JAX transform on the same arrays (1 grey level). The
page-locked stage to the card carries the ``cuda`` marker and skips here.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from stainx_tpu import StainNormalizerTransform as JaxTransform
from stainx_tpu.io import RawTileLoader as JaxLoader
from stainx_tpu_torch import StainNormalizerTransform
from stainx_tpu_torch.io import RawTileLoader, TilePipe, tilepipe, tilepipe_available
from stainx_tpu_torch.kernels import BUILD_DIR
from stainx_tpu_torch.testing import synthetic_he_batch

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def tile_dir(tmp_path):
    rng = np.random.default_rng(0)
    shape = (3, 16, 16)
    tiles = []
    for i in range(11):
        tile = rng.integers(0, 256, shape, dtype=np.uint8)
        path = tmp_path / f"tile_{i:03d}.raw"
        tile.tofile(path)
        tiles.append((str(path), tile))
    return shape, tiles


def _needs_native():
    if not tilepipe_available():
        pytest.skip("native tilepipe unavailable (no g++)")


def test_native_library_builds():
    assert tilepipe_available(), "g++ toolchain present but tilepipe failed to build"


def test_library_in_the_port_build_dir(tmp_path):
    """The port's library lives under build/stainx_tpu_torch/ with a name that
    hashes its source; a fresh build writes nothing into stainx_tpu/io/."""
    _needs_native()
    jax_io = ROOT / "stainx_tpu" / "io"
    before = {p.name: p.stat().st_mtime_ns for p in jax_io.iterdir()}
    lib = tilepipe.build_library(tmp_path / "build")
    assert lib.parent == tmp_path / "build" and lib.is_file()
    assert lib.name == tilepipe.lib_path(tmp_path / "build").name
    assert tilepipe.lib_path().parent == BUILD_DIR and tilepipe.lib_path().is_file()
    assert list(tmp_path.joinpath("build").iterdir()) == [lib]  # the temporary file is gone
    assert {p.name: p.stat().st_mtime_ns for p in jax_io.iterdir()} == before


def test_loader_matches_direct_reads(tile_dir):
    shape, tiles = tile_dir
    loader = RawTileLoader([p for p, _ in tiles], tile_shape=shape, batch_size=4, device="cpu")
    assert len(loader) == 3
    seen = 0
    for batch in loader:
        assert batch.dtype == torch.uint8 and batch.device.type == "cpu"
        for row in batch:
            np.testing.assert_array_equal(row.numpy(), tiles[seen][1])
            seen += 1
    assert seen == 11  # remainder batch included


def test_loader_drop_remainder(tile_dir):
    shape, tiles = tile_dir
    loader = RawTileLoader([p for p, _ in tiles], tile_shape=shape, batch_size=4,
                           drop_remainder=True, device="cpu")
    assert len(loader) == 2
    assert sum(b.shape[0] for b in loader) == 8


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("drop_remainder", [False, True])
def test_batches_equal_the_jax_loader(tile_dir, monkeypatch, native, drop_remainder):
    """Byte for byte the JAX loader's batches, on the native route and on
    the numpy route, which each loader takes when its library is missing."""
    if native:
        _needs_native()
    else:
        monkeypatch.setattr(tilepipe, "tilepipe_available", lambda: False)
    shape, tiles = tile_dir
    files = [p for p, _ in tiles]
    port = RawTileLoader(files, shape, 4, n_threads=2, drop_remainder=drop_remainder, device="cpu")
    assert port._use_native is native
    jax_loader = JaxLoader(files, shape, 4, n_threads=2, drop_remainder=drop_remainder)
    assert len(port) == len(jax_loader)
    count = 0
    for got, want in zip(port, jax_loader):
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        count += 1
    assert count == len(port)


def test_tilepipe_low_level(tile_dir):
    _needs_native()
    shape, tiles = tile_dir
    tile_bytes = int(np.prod(shape))
    pipe = TilePipe(slot_bytes=4 * tile_bytes, n_slots=2, n_threads=2)
    try:
        paths = [p for p, _ in tiles[:4]]
        pipe.enqueue(0, paths, [i * tile_bytes for i in range(4)], [tile_bytes] * 4)
        pipe.wait(0)
        view = pipe.buffer(0).reshape(4, *shape)
        for i in range(4):
            np.testing.assert_array_equal(view[i], tiles[i][1])
    finally:
        pipe.close()


def test_tilepipe_caller_buffers(tile_dir):
    """Slots the caller owns (the page-locked stage hands its tensors to
    tp_open): the reads land in them, and malformed buffers raise."""
    _needs_native()
    shape, tiles = tile_dir
    tile_bytes = int(np.prod(shape))
    buffers = [torch.zeros(4 * tile_bytes + 5, dtype=torch.uint8) for _ in range(2)]
    pipe = TilePipe(slot_bytes=4 * tile_bytes, n_slots=2, n_threads=2, buffers=buffers)
    try:
        pipe.enqueue(1, [p for p, _ in tiles[4:8]], [i * tile_bytes for i in range(4)],
                     [tile_bytes] * 4)
        pipe.wait(1)
        got = buffers[1][: 4 * tile_bytes].reshape(4, *shape).numpy()
        np.testing.assert_array_equal(got, np.stack([t for _, t in tiles[4:8]]))
        assert pipe.buffer(1).ctypes.data == buffers[1].data_ptr()
        assert not buffers[0].any()
    finally:
        pipe.close()
    for bad in ([buffers[0]], [buffers[0], torch.zeros(8, dtype=torch.uint8)],
                [buffers[0], buffers[1].to(torch.int32)]):
        with pytest.raises(ValueError, match="buffers must be"):
            TilePipe(slot_bytes=4 * tile_bytes, n_slots=2, buffers=bad)


def test_missing_file_raises(tile_dir, tmp_path):
    _needs_native()
    shape, _ = tile_dir
    tile_bytes = int(np.prod(shape))
    pipe = TilePipe(slot_bytes=2 * tile_bytes, n_slots=1, n_threads=1)
    try:
        pipe.enqueue(0, [str(tmp_path / "missing.raw")], [0], [tile_bytes])
        with pytest.raises(OSError, match="read"):
            pipe.wait(0)
    finally:
        pipe.close()


def test_missing_file_raises_in_the_loader(tile_dir, tmp_path):
    _needs_native()
    shape, tiles = tile_dir
    files = [p for p, _ in tiles[:3]] + [str(tmp_path / "missing.raw")]
    with pytest.raises(OSError, match="read"):
        for _ in RawTileLoader(files, shape, 2, device="cpu"):
            pass


def test_feeds_normalizer(tile_dir):
    from stainx_tpu_torch import Reinhard

    shape, tiles = tile_dir
    loader = RawTileLoader([p for p, _ in tiles], tile_shape=shape, batch_size=4, device="cpu")
    norm = Reinhard(device="cpu").fit(torch.as_tensor(tiles[0][1][None]))
    for batch in loader:
        out = norm.transform(batch)
        assert out.shape == batch.shape


def test_path_entries_accepted(tile_dir):
    """pathlib.Path entries work on the native route as on the numpy one."""
    shape, tiles = tile_dir
    loader = RawTileLoader([Path(p) for p, _ in tiles], tile_shape=shape, batch_size=4,
                           device="cpu")
    seen = 0
    for batch in loader:
        for row in batch:
            np.testing.assert_array_equal(row.numpy(), tiles[seen][1])
            seen += 1
    assert seen == 11


def test_collected_batches_final_is_owned(tile_dir):
    """The final batch is a copy: in ``[b for b in loader]`` it would
    otherwise alias slot memory freed when iteration ends. Earlier batches
    stay zero-copy views of the slots."""
    shape, tiles = tile_dir
    loader = RawTileLoader([p for p, _ in tiles], tile_shape=shape, batch_size=4, device="cpu")
    batches = [b for b in loader]
    last = batches[-1]
    np.testing.assert_array_equal(last[-1].numpy(), tiles[-1][1])
    if loader._use_native:  # batch 0 viewed slot 0, as the final batch's source did
        assert batches[0].data_ptr() != last.data_ptr()


def test_degenerate_pipe_args_rejected():
    """slot_bytes <= 0, n_slots < 1 or n_threads < 1 raise ValueError instead
    of allocating nothing and deadlocking the first wait()."""
    for kwargs in (
        dict(slot_bytes=0),
        dict(slot_bytes=64, n_slots=0),
        dict(slot_bytes=64, n_threads=0),
        dict(slot_bytes=64, n_slots=-1),
    ):
        with pytest.raises(ValueError, match="tilepipe needs"):
            TilePipe(**kwargs)
    with pytest.raises(ValueError, match="batch_size"):
        RawTileLoader([], (3, 4, 4), 0, device="cpu")


def test_invalid_slot_raises_not_ub():
    """tp_wait and tp_buffer check the slot index."""
    _needs_native()
    pipe = TilePipe(slot_bytes=64, n_slots=2, n_threads=1)
    try:
        with pytest.raises(ValueError, match="invalid slot"):
            pipe.wait(5)
        with pytest.raises(ValueError, match="invalid slot"):
            pipe.buffer(-1)
        with pytest.raises(ValueError, match="enqueue failed"):
            pipe.enqueue(2, ["x"], [0], [1])
    finally:
        pipe.close()


def test_default_device_needs_cuda(tile_dir):
    """``device=None`` means cuda:0: without CUDA the loader raises as
    ``get_device`` does, and never yields CPU tensors in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    shape, tiles = tile_dir
    with pytest.raises(RuntimeError, match="CUDA"):
        RawTileLoader([p for p, _ in tiles], shape, 4)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_slice_end_to_end(tmp_path, monkeypatch, native):
    """The slice on the CPU: 8 tiles of 3x64^2 from disk through the port's
    loader into ``StainNormalizerTransform("macenko", reference=ref)``,
    against ``stainx_tpu.StainNormalizerTransform`` on the same arrays,
    within 1 grey level (the output is float in [0, 1])."""
    if native:
        _needs_native()
    else:
        monkeypatch.setattr(tilepipe, "tilepipe_available", lambda: False)
    tiles = synthetic_he_batch(8, 64, 64, seed=5)
    ref = synthetic_he_batch(1, 64, 64, seed=42)
    files = []
    for i, tile in enumerate(tiles):
        files.append(tmp_path / f"tile_{i}.raw")
        tile.tofile(files[-1])
    port = StainNormalizerTransform("macenko", reference=ref, device="cpu")
    jax_t = JaxTransform("macenko", reference=ref, device="cpu")
    loader = RawTileLoader(files, (3, 64, 64), 4, drop_remainder=True, device="cpu")
    outs = [port(batch) for batch in loader]
    assert len(outs) == 2
    got = torch.cat(outs).numpy()
    want = np.asarray(jax_t(tiles))
    assert got.shape == want.shape == (8, 3, 64, 64) and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / 255.0 + 1e-6)


@pytest.mark.cuda
def test_page_locked_stage_on_the_card(tile_dir):
    """On the card: CUDA batches through the page-locked stage, the caller's
    (they survive the loader), equal to the files, on both routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the page-locked stage copies to it")
    shape, tiles = tile_dir
    files = [p for p, _ in tiles]
    for native in (True, False):
        loader = RawTileLoader(files, shape, 4, n_threads=2)
        loader._use_native = native and tilepipe_available()
        batches = [b.clone() if i % 2 else b for i, b in enumerate(loader)]
        torch.cuda.synchronize()
        assert all(b.is_cuda and b.dtype == torch.uint8 for b in batches)
        got = torch.cat(batches).cpu().numpy()
        np.testing.assert_array_equal(got, np.stack([t for _, t in tiles]))
