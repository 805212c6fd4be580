"""The port on the committed structured tiles, on the CPU.

The port's counterpart of ``tests/test_real_data.py``. The six committed
tiles (``examples/data/``: a 384² target and five 384² sources, synthetic
H&E renders with background, nuclei and texture, ``examples/make_data.py``)
are read by the examples' own PNG reader, ``examples_torch/_png.py``:

- the port (``device="cpu"``, the kernels' plain versions) against the numpy
  oracle on each source tile, at ``tests/test_real_data.py``'s tolerances;
- the port against ``stainx_tpu`` (its Pallas kernels in interpret mode,
  and backend ``xla``) on the five sources as one batch, within the JAX
  repo's cross-path contracts: HE atol 2e-5 and maxC rtol 1e-4 at fit, one
  grey level on outputs;
- ``read_png`` against PIL's decode of every committed PNG, the filters
  those PNGs use, a ``write_png`` → ``read_png`` round trip, RGBA input and
  the formats ``read_png`` refuses.
"""

import glob
import os
import struct
import zlib

import numpy as np
import pytest
import torch

import stainx_tpu
from examples_torch._common import DATA_DIR, load_nchw
from examples_torch._png import read_png, write_png
from stainx_tpu_torch import HistogramMatching, Macenko, Reinhard

from tests.oracles import numpy_reference as oracle

PNGS = sorted(glob.glob(os.path.join(DATA_DIR, "*.png")))
SOURCES = [os.path.basename(p) for p in PNGS if os.path.basename(p) != "target.png"]
METHODS = {"macenko": (Macenko, stainx_tpu.Macenko),
           "reinhard": (Reinhard, stainx_tpu.Reinhard),
           "histogram_matching": (HistogramMatching, stainx_tpu.HistogramMatching)}

# tests/test_real_data.py's tolerances against the oracle
ATOL, MACENKO_ATOL, MACENKO_MAE = 1.0, 2.0, 0.35
# the JAX repo's cross-path contracts (tests/test_kernels.py)
HE_ATOL, MC_RTOL, GREY = 2e-5, 1e-4, 1.0


@pytest.fixture(scope="module")
def target():
    return load_nchw(os.path.join(DATA_DIR, "target.png"))


@pytest.fixture(scope="module")
def sources():
    return np.concatenate([load_nchw(os.path.join(DATA_DIR, name)) for name in SOURCES])


def _grey_diff(got, want) -> np.ndarray:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    return np.abs(got.astype(np.float32) - np.asarray(want).astype(np.float32))


def test_the_committed_tiles():
    assert [os.path.basename(p) for p in PNGS] == ["target.png"] + [
        f"test_{i}.png" for i in range(1, 6)]
    for path in PNGS:
        assert load_nchw(path).shape == (1, 3, 384, 384)


# ------------------------------------------------------------ against the oracle
@pytest.mark.parametrize("name", SOURCES)
def test_macenko_against_oracle(target, sources, name):
    """Fit at the oracle's tolerances, then every pixel of the tile: these
    tiles carry background pixels, which the β-mask drops."""
    he_o, mc_o = oracle.macenko_fit(target)
    norm = Macenko(device="cpu").fit(target)
    np.testing.assert_allclose(norm._stain_matrix.numpy(), he_o, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(norm._target_max_conc.numpy(), mc_o, rtol=1e-3, atol=1e-4)
    tile = sources[SOURCES.index(name)][None]
    diff = _grey_diff(norm.transform(tile), oracle.macenko_transform(tile, he_o, mc_o))
    assert diff.max() <= MACENKO_ATOL and diff.mean() <= MACENKO_MAE


@pytest.mark.parametrize("name", SOURCES)
def test_reinhard_against_oracle(target, sources, name):
    tile = sources[SOURCES.index(name)][None]
    want = oracle.reinhard_transform(tile, *oracle.reinhard_fit(target))
    got = Reinhard(device="cpu").fit(target).transform(tile)
    assert _grey_diff(got, want).max() <= ATOL


@pytest.mark.parametrize("name", SOURCES)
def test_histogram_matching_against_oracle(target, sources, name):
    tile = sources[SOURCES.index(name)][None]
    want = oracle.hm_transform(tile, oracle.hm_fit(target))
    got = HistogramMatching(device="cpu").fit(target).transform(tile)
    assert _grey_diff(got, want).max() <= ATOL


# ------------------------------------------------------------ against stainx_tpu
@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_against_stainx_tpu(target, sources, method, backend):
    """The five sources as one batch (Reinhard and HM take the batch's
    statistics), fitted on the target, through both packages."""
    port_cls, jax_cls = METHODS[method]
    port = port_cls(device="cpu").fit(target)
    ref = jax_cls(backend=backend).fit(target)
    if method == "macenko":
        np.testing.assert_allclose(port._stain_matrix.numpy(), np.asarray(ref._stain_matrix),
                                   atol=HE_ATOL, rtol=0)
        np.testing.assert_allclose(port._target_max_conc.numpy(),
                                   np.asarray(ref._target_max_conc).reshape(-1), rtol=MC_RTOL)
    got, want = port.transform(sources), np.asarray(ref.transform(sources))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8 and got.shape == want.shape
    assert _grey_diff(got, want).max() <= GREY


def test_hm_one_grey_level_on_test_4_is_jax_s_own(target, sources):
    """On test_4.png alone, histogram matching sits one grey level from the
    oracle on some pixels (the oracle builds its LUT in float64, both
    packages in float32); the JAX package gives the same bits on both its
    backends, so the difference is the JAX package's own, within the gate."""
    tile = sources[SOURCES.index("test_4.png")][None]
    want = oracle.hm_transform(tile, oracle.hm_fit(target))
    port = HistogramMatching(device="cpu").fit(target).transform(tile).numpy()
    assert _grey_diff(port, want).max() == ATOL
    for backend in ("pallas", "xla"):
        ref = stainx_tpu.HistogramMatching(backend=backend).fit(target)
        np.testing.assert_array_equal(port, np.asarray(ref.transform(tile)))


def test_one_tile_as_in_the_batch(target, sources):
    """Macenko normalizes each image on its own: a tile alone gives the
    same bits as in the batch of five."""
    norm = Macenko(device="cpu").fit(target)
    batch = norm.transform(sources)
    for i in range(len(SOURCES)):
        assert torch.equal(norm.transform(sources[i:i + 1]), batch[i:i + 1])


# ---------------------------------------------------------------------- _png
@pytest.mark.parametrize("path", PNGS, ids=os.path.basename)
def test_read_png_matches_pil(path):
    image = pytest.importorskip("PIL.Image")
    want = np.asarray(image.open(path).convert("RGB"), dtype=np.uint8)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)


def _filters(path: str) -> set[int]:
    """The row filters a committed 8-bit RGB PNG uses."""
    data, pos, idat = open(path, "rb").read(), 8, b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(384, 1 + 3 * 384)
    return set(raw[:, 0].tolist())


def test_committed_pngs_use_the_filters_read_png_undoes():
    used = set().union(*(_filters(p) for p in PNGS))
    assert {1, 2, 3, 4} <= used <= {0, 1, 2, 3, 4}


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 13, 3), (64, 48, 3)])
def test_write_png_round_trip(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)


def test_write_png_is_read_by_pil(tmp_path):
    image = pytest.importorskip("PIL.Image")
    img = read_png(PNGS[1])
    write_png(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(np.asarray(image.open(tmp_path / "x.png")), img)


@pytest.mark.parametrize("optimize", [False, True])
def test_read_png_rgba_drops_alpha(tmp_path, optimize):
    image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(5)
    rgba = rng.integers(0, 256, (33, 29, 4), dtype=np.uint8)
    rgba[::3, :, :3] = 200  # runs of equal pixels: the encoder picks several filters
    image.fromarray(rgba, "RGBA").save(tmp_path / "a.png", optimize=optimize)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), rgba[..., :3])


def _patched_ihdr(src: str, dst, **fields) -> None:
    """Copy of ``src`` with IHDR bytes replaced (its CRC recomputed)."""
    data = bytearray(open(src, "rb").read())
    ihdr = bytearray(data[16:29])
    offsets = {"depth": 8, "colour": 9, "interlace": 12}
    for key, value in fields.items():
        ihdr[offsets[key]] = value
    data[16:29] = ihdr
    data[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + bytes(ihdr)))
    with open(dst, "wb") as f:
        f.write(bytes(data))


@pytest.mark.parametrize("case", ["grey", "palette", "sixteen_bit", "interlaced", "bad_crc",
                                  "not_png", "truncated"])
def test_read_png_refuses(tmp_path, case):
    path = tmp_path / f"{case}.png"
    if case in ("grey", "palette", "sixteen_bit"):
        image = pytest.importorskip("PIL.Image")
        pixels = np.arange(64, dtype=np.uint8).reshape(8, 8)
        if case == "sixteen_bit":
            image.fromarray(pixels.astype(np.uint16) * 1000).save(path)
        else:
            image.fromarray(pixels, "L").convert("L" if case == "grey" else "P").save(path)
    elif case == "interlaced":
        _patched_ihdr(PNGS[0], path, interlace=1)
    else:
        data = bytearray(open(PNGS[0], "rb").read())
        if case == "bad_crc":
            data[40] ^= 0xFF  # a byte of the first IDAT chunk
        elif case == "not_png":
            data[1] = ord("Q")
        else:
            data = data[:len(data) // 2]
        path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        read_png(str(path))


@pytest.mark.parametrize("bad", [np.zeros((4, 4, 3), np.float32), np.zeros((4, 4, 4), np.uint8),
                                 np.zeros((0, 4, 3), np.uint8), np.zeros((4, 4), np.uint8)],
                         ids=["float32", "four_channels", "empty", "two_dims"])
def test_write_png_refuses(tmp_path, bad):
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), bad)
