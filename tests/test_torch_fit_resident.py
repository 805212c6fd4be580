"""B2's size rule, the fit ladder and the small-patch batch mode, on the CPU.

B2 (``macenko_fit_mega``) holds the pool in one block's shared memory on
the card; its plain version runs here. The route ladder that sends a pool
to B2 where it fits and to B5 past that is a pure function of the pool's
bytes and the card's shared memory. The plain fit is held against the JAX package's fit on pooled
shapes at and past the resident limit (the Pallas kernel in interpret mode
at small sizes, the XLA path at large ones), with the JAX repo's gates: HE
atol 2e-5 and maxC rtol 1e-4 (the plain version sums in float64 and
selects on the pseudo-angle; the JAX kernel sums in float32, the XLA path
selects on atan2, so a few ulps differ). The small-patch batch-mode
forward is held against the JAX package's within 1 grey level (1/255 of
its [0, 1] output, plus the division's rounding).
"""

import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import stainx_tpu
from stainx_tpu.kernels.macenko_fused import macenko_fit_mega as jax_fit_mega
from stainx_tpu.ops import macenko as jax_mk
from stainx_tpu_torch import StainNormalizerTransform, kernels, profiling
from stainx_tpu_torch.kernels import macenko_fused as mf
from stainx_tpu_torch.kernels import macenko_stream as ms
from stainx_tpu_torch.ops import macenko as mk
from stainx_tpu_torch.testing import largest

from tests.oracles import numpy_reference as oracle

HE_ATOL, MC_RTOL = 2e-5, 1e-4
H100_SMEM_OPTIN = 232_448
# The largest pools B2 holds on an H100 (14 080 fixed bytes, 8 bytes of
# keys a pixel and 3 (uint8) or 12 (float32) of planes, each rounded up to
# 16): 19 850 uint8 pixels and 10 918 float32 ones. Pool shapes (N, H, W)
# of that many pixels and of one more, with the route each takes.
FIT_EDGE = {
    "uint8": [((2, 25, 397), "mega"), ((3, 13, 509), "stream")],
    "float32": [((2, 53, 103), "mega"), ((1, 61, 179), "stream")],
}
# An H100 SM's shared memory; each resident block also takes a 1 KB reserve.
H100_SMEM_PER_SM = 233_472
SOURCE = (kernels.CSRC / "macenko_fused.cu").read_text()


def _source_int(name: str) -> int:
    """The value of ``constexpr int <name> = <literal>;`` in
    ``csrc/macenko_fused.cu``."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _pool(shape, dtype, seed=0, he_scale=1.0):
    n, h, w = shape
    x = np.concatenate([oracle.synthetic_he_tile(h, w, seed=seed + i, he_scale=he_scale)
                        for i in range(n)])
    return x if dtype == "uint8" else x.astype(np.float32) / 255.0


def _assert_fit_close(got, want):
    he_t, mc_t = got
    he_j, mc_j = want
    np.testing.assert_allclose(he_t.numpy(), np.asarray(he_j), atol=HE_ATOL, rtol=0)
    np.testing.assert_allclose(mc_t.numpy(), np.asarray(mc_j).reshape(-1), rtol=MC_RTOL)


class TestFitBody:
    """B2's shared memory (``fit_resident_bytes``): B2 takes a pool wherever
    it fits a block's opt-in shared memory, B5 past it."""

    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_body_at_the_limit(self, dtype):
        torch_dtype = getattr(torch, dtype)
        for (n, h, w), route in FIT_EDGE[dtype]:
            pixels = n * h * w
            assert mk.fit_route(pixels, torch_dtype, H100_SMEM_OPTIN) == route
            fits = mf.fit_resident_bytes(pixels, torch_dtype) <= H100_SMEM_OPTIN
            assert fits == (route == "mega")
        (n, h, w), _ = FIT_EDGE[dtype][0]
        (n1, h1, w1), _ = FIT_EDGE[dtype][1]
        assert n1 * h1 * w1 == n * h * w + 1

    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    @pytest.mark.parametrize("pixels", [1, 4096, 5183, 16384])
    def test_resident_bytes(self, dtype, pixels):
        torch_dtype = getattr(torch, dtype)
        itemsize = 1 if dtype == "uint8" else 4
        got = mf.fit_resident_bytes(pixels, torch_dtype)
        assert got % 16 == 0
        assert mf.FIT_FIXED_BYTES + 8 * pixels + 3 * itemsize * pixels <= got
        assert got < mf.FIT_FIXED_BYTES + 8 * pixels + 3 * itemsize * pixels + 32
        # The fit's head holds a 1024-thread block's partial sums, B1's a
        # 512-thread block's: 16 more warps of 10 doubles.
        assert got - mf.resident_bytes(pixels, torch_dtype) == 16 * 10 * 8

    def test_small_patches_are_resident(self):
        for dtype in (torch.uint8, torch.float32):
            assert mk.fit_route(64 * 64, dtype, H100_SMEM_OPTIN) == "mega"
        assert mk.fit_route(128 * 128, torch.uint8, H100_SMEM_OPTIN) == "mega"
        assert mk.fit_route(128 * 128, torch.float32, H100_SMEM_OPTIN) == "stream"


class TestFitRoute:
    """``fit_route``: B5 from the first pool that does not fit B2's block
    up, B2 below it; the floor follows the card's shared memory."""

    @pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
    def test_floor(self, dtype):
        floor = 19_851 if dtype == torch.uint8 else 10_919  # on an H100
        assert mk.fit_route(floor - 1, dtype, H100_SMEM_OPTIN) == "mega"
        assert mk.fit_route(floor, dtype, H100_SMEM_OPTIN) == "stream"
        assert mk.fit_route(64 * 64, dtype, H100_SMEM_OPTIN) == "mega"
        assert mk.fit_route(256 * 224 * 224, dtype, H100_SMEM_OPTIN) == "stream"
        smaller = mf.fit_resident_bytes(64 * 64, dtype)
        assert mk.fit_route(64 * 64, dtype, smaller) == "mega"
        assert mk.fit_route(64 * 64, dtype, smaller - 1) == "stream"
        assert mk.CPU_ROUTE_SMEM == H100_SMEM_OPTIN

    @pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
    def test_resident_pools_take_b2(self, dtype):
        """Every pool B2 holds on an H100 is B2's."""
        (n, h, w), _ = FIT_EDGE[str(dtype).split(".")[1]][0]
        assert mk.fit_route(n * h * w, dtype, H100_SMEM_OPTIN) == "mega"


class TestResidentFootprint:
    """The resident blocks' shared memory (``csrc/macenko_fused.cu``'s
    ``ResidentShared``, whose size the source's static_asserts tie to its
    constants): the wrapper's constants, the packed histogram copies'
    16-bit counts at the largest row and pool a block holds, and two B1
    blocks an SM at 96² uint8."""

    def test_fixed_bytes_are_the_layout(self):
        assert mf.RESIDENT_FIXED_BYTES == _source_int("kResidentFixed")
        assert mf.FIT_FIXED_BYTES == _source_int("kFitFixed")
        assert (mf.RESIDENT_FIXED_BYTES, mf.FIT_FIXED_BYTES) == (12_800, 14_080)
        assert mf.RESIDENT_FIXED_BYTES % 16 == 0 and mf.FIT_FIXED_BYTES % 16 == 0

    @pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
    def test_packed_counts_stay_below_two_to_the_16(self, dtype):
        """A word of a histogram copy holds both selections' counts of one
        bin in 16 bits each. Copy ``threadIdx & (kRCopies - 1)`` takes the
        groups of V ≤ 4 keys whose index is its own modulo kRCopies (every
        block's thread count is a multiple of it), so it counts at most
        4·⌈P / (4·kRCopies)⌉ keys of a selection (⌈P/8⌉ and up to 3 more):
        below 2¹⁶ at the largest B1 row and B2 pool a 232 448-byte block
        holds."""
        copies = _source_int("kRCopies")
        rows = largest(lambda p: mf.transform_body(p, dtype, H100_SMEM_OPTIN) == "resident")
        pool = largest(lambda p: mk.fit_route(p, dtype, H100_SMEM_OPTIN) == "mega")
        assert (rows, pool) == ((19_968, 19_850) if dtype == torch.uint8 else (10_982, 10_918))
        for pixels in (rows, pool):
            per_copy = 4 * math.ceil(pixels / (4 * copies))
            assert per_copy < 2**16, (pixels, copies, per_copy)

    def test_two_b1_blocks_an_sm(self):
        """Two resident B1 blocks and their reserves fit an H100 SM up to
        9 354 uint8 pixels an image (a 96² patch is 9 216) and 5 145
        float32."""
        for dtype, most in ((torch.uint8, 9_354), (torch.float32, 5_145)):
            assert 2 * (mf.resident_bytes(most, dtype) + 1024) <= H100_SMEM_PER_SM
            assert 2 * (mf.resident_bytes(most + 1, dtype) + 1024) > H100_SMEM_PER_SM


class TestPlainFitNearTheLimit:
    """The plain fit (what B2 computes) against the JAX package."""

    @pytest.mark.parametrize(
        "dtype, shape",
        [("uint8", (1, 71, 73)), ("float32", (1, 71, 73)), ("uint8", (3, 17, 19)),
         ("float32", (2, 32, 32))],
        ids=["ragged-u8", "ragged-f32", "ragged-pool-u8", "pool-f32"],
    )
    def test_matches_jax_kernel(self, dtype, shape):
        x = _pool(shape, dtype, seed=20)
        want = jax_fit_mega(jnp.asarray(x), interpret=True)
        _assert_fit_close(mf.macenko_fit_mega_plain(torch.as_tensor(x)), want)

    @pytest.mark.parametrize(
        "dtype, shape",
        [(d, s) for d, cases in FIT_EDGE.items() for s, _ in cases]
        + [("uint8", (4, 64, 64)), ("uint8", (8, 48, 48)), ("uint8", (1, 144, 144))],
    )
    def test_matches_jax_xla_path(self, dtype, shape):
        x = _pool(shape, dtype, seed=30, he_scale=1.1)
        want = jax_mk.macenko_fit(jnp.asarray(x), use_pallas=False)
        _assert_fit_close(mf.macenko_fit_mega_plain(torch.as_tensor(x)), want)

    def test_b5_plain_agrees_past_the_limit(self):
        """Past the resident limit a pool goes to B5, whose plain version
        takes B6's selection conventions: the same fit as B2's."""
        x = torch.as_tensor(_pool((1, 1, 19_851), "uint8", seed=40))
        he2, mc2 = mf.macenko_fit_mega_plain(x)
        he5, mc5 = ms.macenko_fit_stream_plain(x)
        assert torch.equal(he2, he5) and torch.equal(mc2, mc5)


class TestSmallPatchBatchMode:
    """``StainNormalizerTransform("macenko", mode="batch")`` with its default
    ``batch_ref_index=0``: a fit of the first patch every forward, then the
    transform of the batch, which the card runs as B2 and B1."""

    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_matches_jax(self, dtype):
        x = _pool((8, 64, 64), dtype, seed=50, he_scale=1.1)
        port = StainNormalizerTransform("macenko", mode="batch", device="cpu")
        ref = stainx_tpu.StainNormalizerTransform("macenko", mode="batch", device="cpu")
        assert port.batch_ref_index == 0
        got, want = port(x), np.asarray(ref(x))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1.0 / 255.0 + 1e-6, rtol=0)

    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_oracle_mae(self, dtype):
        x = _pool((8, 64, 64), dtype, seed=60)
        got = StainNormalizerTransform("macenko", mode="batch", device="cpu")(x)
        he, mc = oracle.macenko_fit(x[:1])
        want = oracle.macenko_transform(x, he, mc).astype(np.float32)
        assert float(np.abs(got.numpy() * 255.0 - want).mean()) <= 0.35

    def test_cpu_path_never_builds_or_counts(self, monkeypatch):
        def no_build():
            raise AssertionError("the CPU path must not build the CUDA kernels")

        monkeypatch.setattr(kernels, "build_all", no_build)
        before = profiling.counters("launch.")
        x = _pool((4, 64, 64), "uint8", seed=70)
        StainNormalizerTransform("macenko", mode="batch", device="cpu")(x)
        mf.macenko_fit_mega(torch.as_tensor(x[:1]))
        assert profiling.counters("launch.") == before

    def test_fit_selections_needs_the_card(self):
        """The check-only entry launches B2 or raises."""
        with pytest.raises(ValueError, match="expected a CUDA"):
            mf.fit_selections(torch.zeros((1, 3, 8, 8), dtype=torch.uint8))
