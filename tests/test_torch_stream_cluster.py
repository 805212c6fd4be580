"""Host-side logic of the two routes of B4 and B5, on the CPU.

B4 (``macenko_transform_stream``) and B5 (``macenko_fit_stream``) run on the
card either one thread-block cluster a row, with the row's pixels resident
in shared memory, or streamed over many blocks. What decides between them,
the cluster's shape and the streamed route's scratch layout are plain
Python, held here against the numbers of ``csrc/macenko_stream.cu`` and the
H100's limits (232 448 bytes of opt-in shared memory a block, and the
clusters of each size the card holds at once, as
``cudaOccupancyMaxActiveClusters`` reports them). The
plain versions, which the wrappers run on a CPU tensor whatever the route,
are held against B1's and B2's plain versions and the JAX package's
streaming kernels in interpret mode on seeded tiles.
"""

import contextlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stainx_tpu.kernels.macenko_stream import macenko_fit_stream as jax_fit_stream
from stainx_tpu.kernels.macenko_stream import macenko_transform_stream as jax_transform_stream
from stainx_tpu.ops import macenko as jax_mk
from stainx_tpu_torch import kernels, profiling
from stainx_tpu_torch.kernels import macenko_fused as mf
from stainx_tpu_torch.kernels import macenko_stream as ms

from tests.oracles import numpy_reference as oracle

H100_SMEM = 232_448
H100_ACTIVE = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}  # clusters of c blocks at once


def h100_active(c, resident):
    return H100_ACTIVE[c]
SOURCE = (kernels.CSRC / "macenko_stream.cu").read_text()


def _tiles(n, h, w, seed, he_scale=1.0):
    return np.concatenate(
        [oracle.synthetic_he_tile(h, w, seed=seed + i, he_scale=he_scale) for i in range(n)]
    )


# ----------------------------------------------------------- cluster shape
class TestClusterShape:
    @pytest.mark.parametrize(
        "rows,row_len,itemsize,want",
        [
            (64, 512 * 512, 1, (2, 131_072, 63_168)),  # the main path's transform: one wave
            (256, 224 * 224, 1, (1, 50_176, 50_176)),  # WSI tiles: an image a block
            (256, 224 * 224, 4, (1, 50_176, 15_792)),  # path (a)'s float32 batch
            (1, 512 * 512, 1, (16, 16_384, 16_384)),  # a lone 512^2 row: past the portable 8
            (4, 224 * 224, 4, (16, 3_136, 3_136)),
            (8, 512 * 512, 1, (8, 32_768, 32_768)),  # 8 clusters of 16 do not fit at once
            (16, 384 * 384, 1, (4, 36_864, 36_864)),  # nor 16 of 8
            (96, 512 * 512, 1, (1, 262_144, 63_168)),
            (2, 71 * 73, 1, (16, 336, 336)),  # ragged rows round up to 16 pixels
            (1, 505_344, 1, (16, 31_584, 31_584)),  # the largest uint8 row
            (1, 126_336, 4, (16, 7_904, 7_904)),  # the largest float32 row
        ],
    )
    def test_shape(self, rows, row_len, itemsize, want):
        assert ms.cluster_shape(rows, row_len, itemsize, H100_SMEM, h100_active) == want

    @pytest.mark.parametrize(
        "row_len,itemsize",
        [(505_345, 1), (126_337, 4), (2048 * 2048, 1), (1999 * 2011, 1), (224 * 224 * 256, 4), (0, 1)],
    )
    def test_rows_past_a_cluster_stream(self, row_len, itemsize):
        assert ms.cluster_shape(64, row_len, itemsize, H100_SMEM, h100_active) is None
        dtype = torch.uint8 if itemsize == 1 else torch.float32
        assert ms.route(row_len, dtype, H100_SMEM) == "stream"

    @pytest.mark.parametrize("itemsize", [1, 4])
    def test_every_shape_fits_and_covers_its_row(self, itemsize):
        """Over row lengths and row counts: the slices cover the row and are
        whole 16-byte loads, the resident part fits a block's shared memory,
        and the cluster is the largest of which the card holds every row's
        cluster at once (1 when none is)."""
        budget = ms.resident_budget(itemsize, H100_SMEM)
        for row_len in range(1, 600_000, 4_099):
            for rows in (1, 3, 7, 8, 17, 64, 300):
                shape = ms.cluster_shape(rows, row_len, itemsize, H100_SMEM, h100_active)
                if row_len > ms.FIT_BLOCKS * budget:
                    assert shape is None
                    continue
                c, s, r = shape
                assert c in ms.CLUSTER_SIZES and s % ms.SLICE_QUANTUM == 0
                assert c * s >= row_len and s < -(-row_len // c) + ms.SLICE_QUANTUM
                assert r == min(s, budget) and r % ms.SLICE_QUANTUM == 0
                assert ms.CLUSTER_FIXED_BYTES + 3 * r * itemsize <= H100_SMEM  # the block's smem
                assert c == 1 or H100_ACTIVE[c] >= rows
                assert all(H100_ACTIVE[big] < rows for big in ms.CLUSTER_SIZES if big > c)

    @pytest.mark.parametrize(
        "row_len,dtype,want",
        [
            (512 * 512, torch.uint8, "cluster"),  # the main path's transform and reference fit
            (224 * 224, torch.uint8, "cluster"),  # WSI tiles
            (224 * 224, torch.float32, "cluster"),  # path (a)'s batch
            (256 * 256, torch.uint8, "cluster"),
            (8 * 63_168, torch.uint8, "cluster"),  # 8 full blocks
            (512 * 512, torch.float32, "stream"),  # past a float32 cluster
            (2048 * 2048, torch.uint8, "stream"),  # path (b)
            (256 * 224 * 224, torch.float32, "stream"),  # path (a)'s pool
        ],
    )
    def test_route(self, row_len, dtype, want):
        assert ms.route(row_len, dtype, H100_SMEM) == want

    def test_cluster_sizes_match_the_source(self):
        """Clusters past the portable 8 need the kernel's non-portable
        attribute, set before every launch and occupancy query."""
        assert max(ms.CLUSTER_SIZES) == 16 and ms.FIT_BLOCKS == 8
        assert "cudaFuncAttributeNonPortableClusterSizeAllowed, 1" in SOURCE

    def test_constants_match_the_source(self):
        fixed = int(re.search(r"kClusterFixed = (\d+);", SOURCE).group(1))
        assert fixed == ms.CLUSTER_FIXED_BYTES
        threads = int(re.search(r"kCThreads = (\d+);", SOURCE).group(1))
        assert threads == 1024
        struct = re.search(r"struct RowParams \{(.*?)\};", SOURCE, re.S).group(1)
        offset, fields = 0, {}
        for name, width in re.findall(r"float (\w+)(?:\[(\d+)\])?;", struct):
            fields[name] = slice(offset, offset + int(width or 1))
            offset += int(width or 1)
        assert offset == ms.PARAMS_WIDTH
        assert fields["he"] == ms.HE_COLUMNS
        assert fields["phi"] == ms.PHI_COLUMNS
        assert fields["maxc"] == ms.MAXC_COLUMNS


# ---------------------------------------------------------- scratch layout
class TestStreamLayout:
    @pytest.mark.parametrize(
        "rows,blocks,key_len",
        [(1, 1280, 224 * 224 * 256), (4, 1056, 0), (64, 1088, 0), (1, 1, 5), (2, 264, 2048 * 2048)],
    )
    def test_regions_are_aligned_disjoint_and_sized(self, rows, blocks, key_len):
        layout, total = ms.stream_layout(rows, blocks, key_len)
        assert list(layout) == ["params", "sel", "hist", "partials", "keys"]
        sizes = {
            "params": rows * ms.PARAMS_WIDTH * 4,
            "sel": rows * ms.SEL_BYTES,
            "hist": rows * 2 * ms.HIST_BINS * 4 + rows * 4,  # the tickets follow the bins
            "partials": blocks * ms.PARTIAL_SUMS * 8,
            "keys": 2 * rows * key_len * 4,  # float32 input only
        }
        end = 0
        for name, (off, nbytes) in layout.items():
            assert nbytes == sizes[name]
            assert off % ms.ALIGN == 0 and off >= end
            end = off + nbytes
        assert end <= total and total % ms.ALIGN == 0 and total - end < ms.ALIGN

    def test_params_view_of_the_buffer(self):
        """The wrapper views RowParams at offset 0 of the byte buffer."""
        layout, total = ms.stream_layout(3, 10)
        buf = torch.zeros(total, dtype=torch.uint8)
        off, nbytes = layout["params"]
        view = buf[off:off + nbytes].view(torch.float32).view(3, ms.PARAMS_WIDTH)
        view[2, ms.MAXC_COLUMNS] = torch.tensor([1.5, 2.5])
        assert buf.view(torch.float32)[2 * ms.PARAMS_WIDTH + 22].item() == 1.5


# ------------------------------------------------ cluster scratch, key field
TRAIN_ROWS, TRAIN_LEN = 128, 256 * 256  # the batch-mode training transform: 128x3x256^2 float32


def _cluster_call(monkeypatch, images, fit):
    """``ms._run`` on the cluster route with the card's parts replaced by
    H100 stand-ins (no card, no build): returns ``(RowParams, the C call's
    arguments by name)``. The stand-in C call only records its arguments."""
    calls = []
    names = ("x", "out", "n", "p", "ipr", "is_uint8", "vec", "csize", "slice", "resident",
             "fallback", "idx99", "stain", "tmc", "prm", "keys", "stream")

    class Lib:
        _stainx_declared = True

        @staticmethod
        def stainx_cluster_run(*args):
            calls.append(dict(zip(names, args, strict=True)))
            return 0

    monkeypatch.setattr(kernels, "device_limits", lambda index: (132, H100_SMEM))
    monkeypatch.setattr(kernels, "current_stream", lambda dev: None)
    monkeypatch.setattr(kernels, "on_device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(ms, "_lib", lambda: Lib)
    monkeypatch.setattr(ms, "_active_clusters", lambda index, dtype, c, r: H100_ACTIVE[c])
    out = None if fit else torch.empty_like(images)
    stain, tmc = torch.zeros(3, 2), torch.ones(2)
    params = ms._run(images, out, stain, tmc, fit=fit, force="cluster")
    (call,) = calls
    return params, call


class TestClusterKeyField:
    def test_train_transform_key_field(self):
        """128 float32 rows of 256^2 take a block a row, 15 792 of its 65 536
        pixels resident: the other 49 744 of each row get 8 bytes of keys."""
        shape = ms.cluster_shape(TRAIN_ROWS, TRAIN_LEN, 4, H100_SMEM, h100_active)
        assert shape == (1, 65_536, 15_792)
        buf_rows, keyfield = ms.cluster_scratch(TRAIN_ROWS, *shape, 4)
        assert keyfield == 128 * 49_744 * 8 == 50_937_856
        assert buf_rows == TRAIN_ROWS + keyfield // (ms.PARAMS_WIDTH * 4)

    @pytest.mark.parametrize(
        "rows,row_len,itemsize",
        [
            (TRAIN_ROWS, TRAIN_LEN, 1),  # the tile store's uint8 rows, 63 168 resident
            (1, TRAIN_LEN, 4),  # the batch-mode fit of one 256^2 tile: a cluster of 16
            (1, TRAIN_LEN, 1),
            (4, 224 * 224, 4),
            (1, 126_336, 4),  # the largest float32 row: 16 slices of 7 904, all resident
        ],
    )
    def test_no_key_field_for_uint8_or_resident_rows(self, rows, row_len, itemsize):
        shape = ms.cluster_shape(rows, row_len, itemsize, H100_SMEM, h100_active)
        assert ms.cluster_scratch(rows, *shape, itemsize) == (rows, 0)

    @pytest.mark.parametrize("rows", [1, 3, 17, 40, 128, 300])
    def test_key_field_layout_is_aligned(self, rows):
        """Every float32 shape the route picks: the key field starts 16-byte
        aligned right after the RowParams, each block's two planes of 16-byte
        words start 16-byte aligned, and the buffer holds them all with less
        than a row of RowParams to spare."""
        row_bytes = ms.PARAMS_WIDTH * 4
        for row_len in range(16, 126_337, 3_001):
            c, s, r = ms.cluster_shape(rows, row_len, 4, H100_SMEM, h100_active)
            buf_rows, keyfield = ms.cluster_scratch(rows, c, s, r, 4)
            start = rows * row_bytes
            assert start % 16 == 0
            assert keyfield == rows * c * 2 * (s - r) * 4
            for b in (0, 1, rows * c - 1):
                block = start + b * 2 * (s - r) * 4
                assert block % 16 == 0 and (block + (s - r) * 4) % 16 == 0
            assert 0 <= buf_rows * row_bytes - (start + keyfield) < row_bytes

    def test_wrapper_allocates_and_counts_the_key_field(self, monkeypatch):
        images = torch.empty((TRAIN_ROWS, 3, 256, 256), dtype=torch.float32)
        before = profiling.counters("keyfield.")
        params, call = _cluster_call(monkeypatch, images, fit=False)
        assert (call["csize"], call["slice"], call["resident"]) == (1, 65_536, 15_792)
        assert params.shape == (TRAIN_ROWS, ms.PARAMS_WIDTH) and params.is_contiguous()
        assert call["prm"] == params.data_ptr()
        assert call["keys"] == params.data_ptr() + TRAIN_ROWS * ms.PARAMS_WIDTH * 4
        keyfield = TRAIN_ROWS * 49_744 * ms.KEY_BYTES
        assert params.untyped_storage().nbytes() == TRAIN_ROWS * ms.PARAMS_WIDTH * 4 + keyfield
        after = profiling.counters("keyfield.")
        assert after.get("keyfield.B4", 0) - before.get("keyfield.B4", 0) == 1
        assert after.get("keyfield.B5", 0) == before.get("keyfield.B5", 0)

    @pytest.mark.parametrize(
        "shape,dtype,fit",
        [((TRAIN_ROWS, 3, 256, 256), torch.uint8, False), ((1, 3, 256, 256), torch.float32, True),
         ((1, 3, 256, 256), torch.uint8, True)],
        ids=["store-transform", "train-fit", "store-fit"],
    )
    def test_wrapper_passes_no_key_field(self, monkeypatch, shape, dtype, fit):
        before = profiling.counters("keyfield.")
        params, call = _cluster_call(monkeypatch, torch.empty(shape, dtype=dtype), fit)
        assert call["keys"] is None
        assert params.shape == (shape[0] if not fit else 1, ms.PARAMS_WIDTH)
        assert params.untyped_storage().nbytes() == params.numel() * 4
        assert profiling.counters("keyfield.") == before

    def test_key_field_bytes_in_the_span(self, monkeypatch):
        images = torch.empty((TRAIN_ROWS, 3, 256, 256), dtype=torch.float32)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.annotate("stainx.kernel.B4"):
                _cluster_call(monkeypatch, images, fit=False)
        sess = profiling.session()
        (span,) = [s for s in sess.spans if s.name == "stainx.kernel.B4"]
        assert span.args == {"route": "cluster", "csize": 1, "slice": 65_536,
                             "resident": 15_792, "keyfield": 128 * 49_744 * 8}
        assert sess.counts["keyfield.B4"] == 1

    def test_c_interface_takes_every_argument(self, monkeypatch):
        """The wrapper's ctypes declaration has one type a parameter of the
        C entry point, the key field's pointer among them."""

        class Fn:
            pass

        class Lib:
            pass

        for name in ("stainx_cluster_run", "stainx_stream_run", "stainx_stream_fields",
                     "stainx_cluster_occupancy"):
            setattr(Lib, name, Fn())
        monkeypatch.setattr(kernels, "library", lambda stem: Lib)
        lib = ms._lib()
        params = re.search(r"int stainx_cluster_run\((.*?)\) \{", SOURCE, re.S).group(1)
        assert len(lib.stainx_cluster_run.argtypes) == len(params.split(","))
        assert "void* keys, void* stream" in params

    def test_float32_resident_planes_hold_od(self):
        """The float32 cluster kernel turns its resident planes into OD once,
        as load_slice copies them in, and every pass reads that OD back with
        no logarithm; uint8 planes keep raw bytes and the table."""
        assert re.search(r"constexpr bool kOdOnce = sizeof\(T\) == 4;", SOURCE)
        load = re.search(r"__device__ void load_slice\(.*?\n\}\n", SOURCE, re.S).group(0)
        assert load.count("if constexpr (kOdOnce<T>)") == 2  # the 16-byte and the scalar copy
        assert load.count("od_f32(") == 5
        resident = re.search(r"void resident_od\(.*?\n\}\n", SOURCE, re.S).group(0)
        od_once, raw = resident.split("} else {")
        assert "od_f32" not in od_once and "od_of" not in od_once and "float4" in od_once
        assert "load_od<T, 4>(planes" in raw
        kernel = re.search(r"cluster_kernel\(const T\* __restrict__ x.*?\n\}\n", SOURCE,
                           re.S).group(0)
        assert kernel.count("load_slice<T>(sl, planes);") == 1
        csweep = re.search(r"void csweep\(.*?\n\}\n", SOURCE, re.S).group(0)
        assert csweep.count("resident_od<T>(sl.planes") == 1

    def test_float32_keys_written_past_the_resident_pixels_only(self):
        """A selection's first pass writes the key field from the sweep over
        the pixels past the resident ones alone: the resident sweep calls its
        function for threads past its last group too, with q at or past R,
        where a write would land on another pixel's keys."""
        count = re.search(r"void count_pixels\(.*?\n\}\n", SOURCE, re.S).group(0)
        assert SOURCE.count("store_keys<Mode>(") == 1 and count.count("store_keys<Mode>(") == 1
        rest = count[count.index("csweep<T, kRest>"):]
        assert rest.index("store_keys<Mode>(") < rest.index("});")
        assert "if (d == 0) {" in count[:count.index("csweep<T, kRest>")]
        assert count.count("csweep<T, kResident>(sl, sh.lut, from_od);") == 1


# ----------------------------------------------------------- plain versions
@pytest.fixture(scope="module")
def fitted():
    he, mc = jax_mk.macenko_fit(jnp.asarray(oracle.synthetic_he_tile(64, 64, seed=42)))
    return torch.as_tensor(np.array(he)), torch.as_tensor(np.array(mc))


class TestPlainVersions:
    @pytest.mark.parametrize("force", [None, "cluster", "stream"])
    @pytest.mark.parametrize("shape", [(3, 48, 40), (1, 33, 65)], ids=["batch", "ragged"])
    def test_transform_is_b1_plain_on_the_cpu_by_any_route(self, shape, force, fitted):
        he, mc = fitted
        x = torch.as_tensor(_tiles(*shape, seed=31, he_scale=1.1))
        got = ms.macenko_transform_stream(x, he, mc, force=force)
        assert torch.equal(got, mf.macenko_transform_mega_plain(x, he, mc))

    @pytest.mark.parametrize("force", [None, "cluster", "stream"])
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_fit_is_b2_plain_on_the_cpu_by_any_route(self, dtype, force):
        x = _tiles(3, 40, 48, seed=17)
        x = torch.as_tensor(x if dtype == "uint8" else x.astype(np.float32) / 255.0)
        he, mc = ms.macenko_fit_stream(x, force=force)
        he2, mc2 = mf.macenko_fit_mega_plain(x)
        assert torch.equal(he, he2) and torch.equal(mc, mc2)

    def test_fit_plain_matches_jax_stream_kernel(self):
        pool = _tiles(2, 96, 80, seed=23, he_scale=0.95)
        he_j, mc_j = jax_fit_stream(jnp.asarray(pool), interpret=True)
        he, mc = ms.macenko_fit_stream_plain(torch.as_tensor(pool))
        np.testing.assert_allclose(he.numpy(), np.asarray(he_j), atol=2e-5)
        np.testing.assert_allclose(mc.numpy(), np.asarray(mc_j).reshape(-1), rtol=1e-4)

    def test_transform_plain_matches_jax_stream_kernel(self, fitted):
        he, mc = fitted
        src = oracle.synthetic_he_tile(160, 200, seed=29, he_scale=1.1)
        want = jax_transform_stream(jnp.asarray(src), he.numpy(), mc.numpy(), interpret=True)
        got = ms.macenko_transform_stream_plain(torch.as_tensor(src), he, mc)
        np.testing.assert_allclose(got.numpy().astype(np.float32),
                                   np.asarray(want).astype(np.float32), atol=1.0, rtol=0)

    def test_cpu_path_never_builds_by_any_route(self, monkeypatch, fitted):
        def no_build():
            raise AssertionError("the CPU path must not build the CUDA kernels")

        monkeypatch.setattr(kernels, "build_all", no_build)
        he, mc = fitted
        x = torch.as_tensor(_tiles(1, 32, 32, seed=2))
        counts = profiling.counters("launch.")
        for force in ("cluster", "stream"):
            ms.macenko_fit_stream(x, force=force)
            ms.macenko_transform_stream(x, he, mc, force=force)
        assert profiling.counters("launch.") == counts
