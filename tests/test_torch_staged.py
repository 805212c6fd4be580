"""The PyTorch port's staged Macenko route against the JAX package, on the CPU.

bfloat16, float16 and float64 input does not go to the fused kernels
(B1/B2, B4/B5) in either package: it runs the staged pipeline, whose
selections are B3 (``kth_smallest_pallas``) or, on long rows, B6. On the
CPU the port runs the kernels' plain versions; the JAX package runs
``macenko_fit`` / ``macenko_transform`` with ``use_pallas=True`` (B3 in
interpret mode) and ``stainx_tpu.Macenko(backend="pallas")``. JAX holds
float64 as float32 (x64 is off), so float64 is compared with JAX on a
float32 copy.

Tolerances are the JAX repo's own: fit HE atol 2e-5 and maxC rtol 1e-4
(float32 sums taken in another order); transform within 1 grey level plus
one quantum of the output dtype at [128, 256) (a sub-level difference can
straddle a rounding boundary of bfloat16 or float16). Under
``precision="fast"`` both reconstruct in bfloat16, but XLA and PyTorch
round a chain of bfloat16 multiply-adds differently, so the gate there is
the same tolerance, not equality. JAX calls sit in module-scoped fixtures.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import stainx_tpu
from stainx_tpu.ops import macenko as jax_mk
from stainx_tpu_torch import Macenko, StainNormalizerTransform
from stainx_tpu_torch.convert import state_from_jax
from stainx_tpu_torch.kernels import selection as sel
from stainx_tpu_torch.kernels import selection_stream as ss
from stainx_tpu_torch.ops import macenko as mk
from stainx_tpu_torch.ops import percentile as pct

from tests.oracles import numpy_reference as oracle

HE_ATOL, MC_RTOL, GREY = 2e-5, 1e-4, 1.0
DTYPES = ["bfloat16", "float16", "float64"]
QUANTUM = {"bfloat16": 1.0, "float16": 0.125, "float64": 0.0}


def _tile(h, w, seed, he_scale=1.0):
    return oracle.synthetic_he_tile(h, w, seed=seed, he_scale=he_scale)


def _port(x01, dtype):
    """Port input: float32 [0, 1] numpy cast to ``dtype``."""
    return torch.as_tensor(x01).to(getattr(torch, dtype))


def _jax(x01, dtype):
    """JAX input: the same values; float64 as float32 (JAX holds no x64)."""
    return jnp.asarray(x01).astype("float32" if dtype == "float64" else dtype)


def _f01(x_u8):
    return x_u8.astype(np.float32) / 255.0


def _assert_fit_close(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=HE_ATOL)
    np.testing.assert_allclose(
        got[1].numpy(), np.asarray(want[1], np.float32).reshape(-1), rtol=MC_RTOL
    )


def _assert_grey_close(got, want, dtype):
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(),
        np.asarray(want).astype(np.float32),
        atol=GREY + QUANTUM[dtype],
        rtol=0,
    )


@pytest.fixture(scope="module")
def ref64():
    return _f01(_tile(64, 64, seed=42))


@pytest.fixture(scope="module")
def batch01():
    return _f01(np.concatenate([_tile(72, 80, seed=s, he_scale=1.1) for s in range(4)]))


@pytest.fixture(scope="module")
def jax_staged(ref64, batch01):
    """JAX staged fits of the reference, ``{dtype: (he, mc)}``, and
    transforms of the batch with them, ``{(dtype, precision): out}``."""
    fits, outs = {}, {}
    for dtype in DTYPES:
        he, mc = jax_mk.macenko_fit(_jax(ref64, dtype), use_pallas=True)
        fits[dtype] = np.asarray(he), np.asarray(mc)
        for precision in ("stable", "fast"):
            out = jax_mk.macenko_transform(
                _jax(batch01, dtype), he, mc, precision=precision, use_pallas=True
            )
            outs[dtype, precision] = np.asarray(out).astype(np.float32)
    return fits, outs


@pytest.fixture(scope="module")
def port_outputs(batch01, ref64):
    """Port transforms of the batch, ``{(dtype, precision): out}``, each
    with a port fit of the reference in that dtype."""
    out = {}
    for dtype in DTYPES:
        he, mc = mk.macenko_fit(_port(ref64, dtype))
        for precision in ("stable", "fast"):
            out[dtype, precision] = mk.macenko_transform(
                _port(batch01, dtype), he, mc, precision=precision
            )
    return out


class TestStagedFit:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_matches_jax_staged_fit(self, dtype, jax_staged, ref64):
        he, mc = mk.macenko_fit(_port(ref64, dtype))
        assert he.dtype == torch.float32 and he.shape == (3, 2) and mc.shape == (2,)
        _assert_fit_close((he, mc), jax_staged[0][dtype])

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_pooled_fit_matches_jax(self, dtype):
        pool = _f01(np.concatenate([_tile(48, 40, seed=s) for s in (5, 6, 7)]))
        want = jax_mk.macenko_fit(_jax(pool, dtype), use_pallas=True)
        _assert_fit_close(mk.macenko_fit(_port(pool, dtype)), want)


class TestStagedTransform:
    @pytest.mark.parametrize("precision", ["stable", "fast"])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_matches_jax_staged_transform(self, dtype, precision, jax_staged, batch01):
        """With JAX's fitted state, the port's transform is JAX's within the
        tolerance, under both precisions."""
        he, mc = (torch.as_tensor(np.array(a)) for a in jax_staged[0][dtype])
        got = mk.macenko_transform(_port(batch01, dtype), he, mc, precision=precision)
        assert got.dtype == getattr(torch, dtype) and got.shape == batch01.shape
        _assert_grey_close(got, jax_staged[1][dtype, precision], dtype)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_port_end_to_end_matches_jax(self, dtype, port_outputs, jax_staged):
        """The port's own fit and transform, against JAX's."""
        for precision in ("stable", "fast"):
            _assert_grey_close(
                port_outputs[dtype, precision], jax_staged[1][dtype, precision], dtype
            )

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_fast_reconstructs_in_bfloat16(self, dtype, port_outputs, jax_staged):
        """``fast`` is not ``stable`` on the staged route: the bfloat16
        reconstruction moves a large share of the outputs, as it moves
        JAX's (float64 is float32 in JAX and takes its kernels, where
        ``fast`` changes nothing), and by no more than the tolerance."""
        stable = port_outputs[dtype, "stable"].to(torch.float32)
        fast = port_outputs[dtype, "fast"].to(torch.float32)
        moved = (fast != stable).float().mean().item()
        if dtype == "float64":
            assert moved > 0.9
        else:
            want = jax_staged[1]
            jax_moved = float((want[dtype, "fast"] != want[dtype, "stable"]).mean())
            assert moved > 0.5 * jax_moved > 0.05, (moved, jax_moved)
        assert (fast - stable).abs().max().item() <= GREY + QUANTUM[dtype]

    def test_fast_is_a_no_op_for_kernel_dtypes(self, batch01, ref64):
        he, mc = mk.macenko_fit(torch.as_tensor(ref64))
        x = torch.as_tensor(batch01)
        assert torch.equal(
            mk.macenko_transform(x, he, mc, precision="fast"), mk.macenko_transform(x, he, mc)
        )

    @pytest.mark.parametrize("value", [255, 250])
    def test_uniform_tiles_match_jax(self, value):
        """A uniform tile takes the <3-pixel fallback; the two-pass
        covariance is exactly zero in both packages."""
        he, mc = jax_mk.macenko_fit(jnp.asarray(_tile(32, 32, seed=3)))
        tile = np.full((1, 3, 24, 24), value / 255.0, np.float32)
        want = jax_mk.macenko_transform(_jax(tile, "bfloat16"), he, mc, use_pallas=True)
        got = mk.macenko_transform(_port(tile, "bfloat16"), torch.as_tensor(np.asarray(he)),
                                   torch.as_tensor(np.asarray(mc)))
        assert torch.isfinite(got.float()).all()
        _assert_grey_close(got, want, "bfloat16")

    def test_seed_state_passes_through(self, batch01, ref64):
        state = torch.zeros(7, dtype=torch.int32)
        x = _port(batch01, "float16")
        he, mc, new = mk.macenko_fit(_port(ref64, "float16"), seed_state=state)
        assert new is state
        out, new = mk.macenko_transform(x, he, mc, seed_state=state)
        assert new is state and torch.equal(out, mk.macenko_transform(x, he, mc))


class TestPublicAPI:
    @pytest.mark.parametrize("precision", ["stable", "fast"])
    @pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
    def test_matches_jax_normalizer(self, dtype, precision, ref64, batch01):
        ref_u8 = _tile(64, 64, seed=42)
        jax_norm = stainx_tpu.Macenko(backend="pallas", precision=precision).fit(ref_u8)
        want = np.asarray(jax_norm.transform(_jax(batch01, dtype))).astype(np.float32)
        norm = Macenko(device="cpu", precision=precision).fit(ref_u8)
        got = norm.transform(_port(batch01, dtype))
        assert got.dtype == getattr(torch, dtype)
        _assert_grey_close(got, want, dtype)

    @pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float64", "uint8", "float32"])
    def test_precision_reaches_the_staged_route(self, dtype, batch01):
        """The normalizer passes ``precision`` on: ``fast`` changes the
        staged dtypes' outputs and leaves the kernel dtypes' alone."""
        ref_u8 = _tile(64, 64, seed=42)
        x = torch.as_tensor((batch01 * 255).astype(np.uint8)) if dtype == "uint8" else _port(
            batch01, dtype)
        stable = Macenko(device="cpu").fit(ref_u8).transform(x)
        fast = Macenko(device="cpu", precision="fast").fit(ref_u8).transform(x)
        assert torch.equal(fast, stable) == (dtype in ("uint8", "float32"))

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_oracle_mae(self, dtype):
        """Input in ``dtype`` made from uint8 tiles; the oracle runs on the
        float32 values of that same input, fit and transform."""
        ref = _port(_f01(_tile(64, 64, seed=42)), dtype)
        batch = _port(_f01(np.concatenate([_tile(64, 64, seed=s, he_scale=1.15)
                                           for s in (123, 124)])), dtype)
        he_o, mc_o = oracle.macenko_fit(ref.float().numpy())
        want = oracle.macenko_transform(batch.float().numpy(), he_o, mc_o)
        for precision in ("stable", "fast"):
            got = Macenko(device="cpu", precision=precision).fit(ref).transform(batch)
            assert np.abs(got.float().numpy() - want).mean() <= 0.35

    def test_jax_state_file_drives_the_staged_route(self, tmp_path, batch01, monkeypatch):
        jax_norm = stainx_tpu.Macenko(backend="pallas").fit(_tile(64, 64, seed=42))
        path = tmp_path / "ref.npz"
        jax_norm.save_state(str(path))
        want = np.asarray(jax_norm.transform(_jax(batch01, "bfloat16"))).astype(np.float32)
        calls = []
        plain = sel.kth_smallest_pallas_plain
        monkeypatch.setattr(sel, "kth_smallest_pallas",
                            lambda x, r: calls.append(x.shape) or plain(x, r))
        ported = Macenko(device="cpu").load_state(state_from_jax(path, device="cpu"))
        got = ported.transform(_port(batch01, "bfloat16"))
        assert calls == [(4, 72 * 80), (8, 72 * 80)]
        _assert_grey_close(got, want, "bfloat16")


class TestRoutes:
    def test_select_route(self):
        """Where the threshold measured on the H100 puts the paths'
        selections."""
        assert mk.select_route(1, 512 * 512) == "rows"  # (c) fit, 512^2 reference
        assert mk.select_route(128, 512 * 512) == "rows"  # (c) transform, 64 images
        assert mk.select_route(512, 224 * 224) == "rows"  # (d) transform, 256 images
        assert mk.select_route(1, 256 * 224 * 224) == "stream"  # (d) fit pool
        assert mk.select_route(2, 256 * 224 * 224) == "stream"
        assert mk.select_route(32, 1 << 22) == "stream"  # few long rows: B6 spreads them
        assert mk.select_route(64, 1 << 22) == "rows"  # many: B3's clusters fill the card
        assert mk.select_route(1, (1 << 22) - 1) == "rows"
        assert mk.select_route(32, 1 << 20) == "rows"  # B3 won (32, 2^20) K=1 on the H100
        assert mk.select_route(1, 1 << 20) == "rows"

    @pytest.mark.parametrize("threshold,want", [(10**9, "rows"), (16, "stream")])
    def test_both_selects_give_the_same_output(self, monkeypatch, threshold, want, batch01, ref64):
        """B3 and B6 are exact, so the route never changes an output; the
        spies show which one ran, with the ranks and rows the JAX package
        gives them."""
        baseline = Macenko(device="cpu").fit(_port(ref64, "float16")).transform(
            _port(batch01, "float16")
        )
        calls = []

        def spy(name, fn):
            def wrapped(x, ranks, *rest, **kw):
                calls.append((name, tuple(x.shape), tuple(ranks.shape)))
                return fn(x, ranks, *rest, **kw)
            return wrapped

        monkeypatch.setattr(pct, "SELECT_STREAM_MIN_ELEMS", threshold)
        monkeypatch.setattr(sel, "kth_smallest_pallas", spy("rows", sel.kth_smallest_pallas))
        monkeypatch.setattr(ss, "kth_smallest_streaming", spy("stream", ss.kth_smallest_streaming))
        got = Macenko(device="cpu").fit(_port(ref64, "float16")).transform(
            _port(batch01, "float16")
        )
        p = 72 * 80
        assert calls == [
            (want, (1, 64 * 64), (1, 2)),
            (want, (2, 64 * 64), (2, 1)),
            (want, (4, p), (4, 2)),
            (want, (8, p), (8, 1)),
        ]
        assert torch.equal(got, baseline)

    def test_kernel_dtypes_do_not_take_the_staged_route(self, monkeypatch, batch01, ref64):
        def refuse(*args, **kw):
            raise AssertionError("uint8 and float32 run the fused kernels")

        monkeypatch.setattr(mk, "_staged_transform", refuse)
        monkeypatch.setattr(mk, "_staged_fit", refuse)
        for x in (torch.as_tensor(batch01), torch.as_tensor((batch01 * 255).astype(np.uint8))):
            Macenko(device="cpu").fit(x[:1]).transform(x)

    @pytest.mark.parametrize("precision", ["stable", "fast"])
    def test_transform_module_reaches_the_staged_route(
        self, monkeypatch, precision, batch01, ref64
    ):
        """``StainNormalizerTransform`` with a prebuilt ``Macenko`` carries
        its precision to the staged route, and batch mode fits and
        transforms a float16 batch there."""
        x = _port(batch01, "float16")
        want = Macenko(device="cpu", precision=precision).fit(_port(ref64, "float16")).transform(x)
        he, mc = mk.macenko_fit(x)
        want_batch = mk.macenko_transform(x, he, mc) / 255.0
        seen = []
        staged = mk._staged_transform
        monkeypatch.setattr(mk, "_staged_transform",
                            lambda *a: seen.append(a[-1]) or staged(*a))
        norm = Macenko(device="cpu", precision=precision)
        module = StainNormalizerTransform(normalizer=norm, reference=_port(ref64, "float16"))
        assert torch.equal(module(x), want)
        batch_mode = StainNormalizerTransform("macenko", mode="batch", batch_ref_index=None,
                                              device="cpu")
        out = batch_mode(x)
        assert out.dtype == torch.float16 and torch.isfinite(out).all()
        assert torch.equal(out, want_batch)
        assert seen == [precision, "stable"]
