"""The PyTorch port's Macenko path against the JAX package, on the CPU.

On a CPU tensor every kernel wrapper of ``stainx_tpu_torch`` runs its plain
PyTorch version; the JAX kernels run in interpret mode. Tolerances are the
JAX repo's own cross-implementation gates (``tests/test_kernels.py``): fit
HE atol 2e-5 and maxC rtol 1e-4 (the plain versions sum in float64 and use
``acos`` where the JAX kernel sums in float32 and roots a cubic, so a few
ulps differ); transform outputs within 1 grey level (a few ulps can move a
truncated uint8 value by one level); the numpy oracle's MAE ≤ 0.35.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import stainx_tpu
from stainx_tpu.kernels.macenko_fused import macenko_fit_mega as jax_fit_mega
from stainx_tpu.ops import macenko as jax_mk
from stainx_tpu_torch import Macenko, kernels, profiling
from stainx_tpu_torch.convert import state_from_jax
from stainx_tpu_torch.kernels import macenko_fused as mf
from stainx_tpu_torch.ops import macenko as mk
from stainx_tpu_torch.utils import get_device

from tests.oracles import numpy_reference as oracle

HE_ATOL, MC_RTOL, GREY = 2e-5, 1e-4, 1.0


def _tile(h, w, seed, he_scale=1.0):
    return oracle.synthetic_he_tile(h, w, seed=seed, he_scale=he_scale)


def _as_dtype(x_u8, dtype):
    return x_u8 if dtype == "uint8" else (x_u8.astype(np.float32) / 255.0)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def ref64():
    return _tile(64, 64, seed=42)


@pytest.fixture(scope="module")
def fitted(ref64):
    """JAX kernel fit of the 64² reference: (HE, maxC) as numpy."""
    he, mc = jax_fit_mega(jnp.asarray(ref64), interpret=True)
    return np.asarray(he), np.asarray(mc)


@pytest.fixture(scope="module")
def batch_72x80():
    return np.concatenate([_tile(72, 80, seed=s, he_scale=1.1) for s in range(4)])


def _assert_fit_close(got, want):
    he_t, mc_t = got
    he_j, mc_j = want
    np.testing.assert_allclose(he_t.numpy(), np.asarray(he_j), atol=HE_ATOL)
    np.testing.assert_allclose(mc_t.numpy(), np.asarray(mc_j).reshape(-1), rtol=MC_RTOL)


def _assert_grey_close(got, want, atol=GREY):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want).astype(np.float32), atol=atol, rtol=0)


class TestFit:
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    @pytest.mark.parametrize("pooled", [False, True])
    def test_plain_fit_matches_jax_kernel(self, dtype, pooled, ref64):
        img = np.concatenate([_tile(64, 64, seed=s) for s in (42, 5, 6, 7)]) if pooled else ref64
        img = _as_dtype(img, dtype)
        want = jax_fit_mega(jnp.asarray(img), interpret=True)
        _assert_fit_close(mf.macenko_fit_mega_plain(_t(img)), want)

    def test_wrapper_on_cpu_is_plain(self, ref64):
        a = mf.macenko_fit_mega(_t(ref64))
        b = mf.macenko_fit_mega_plain(_t(ref64))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


class TestTransform:
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_plain_matches_jax_kernel(self, dtype, fitted, batch_72x80):
        he, mc = fitted
        x = _as_dtype(batch_72x80, dtype)
        want = jax_mk.macenko_transform(jnp.asarray(x), he, mc, use_pallas=True)
        got = mf.macenko_transform_mega_plain(_t(x), _t(he), _t(mc))
        assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
        _assert_grey_close(got, want)

    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_plain_matches_jax_xla_path(self, dtype, fitted, batch_72x80):
        he, mc = fitted
        x = _as_dtype(batch_72x80, dtype)
        want = jax_mk.macenko_transform(jnp.asarray(x), he, mc, use_pallas=False)
        _assert_grey_close(mk.macenko_transform(_t(x), _t(he), _t(mc)), want)


# The largest images B1's resident body holds on an H100 (232 448 bytes of
# opt-in shared memory a block): 12 800 fixed bytes, 8 bytes of keys a pixel
# and 3 (uint8) or 12 (float32) of planes, each rounded up to 16, so 19 968
# uint8 pixels and 10 982 float32 ones. Shapes (H, W) of that many pixels
# and of one more.
H100_SMEM_OPTIN = 232_448
RESIDENT_EDGE = {
    "uint8": [((96, 208), "resident"), ((19, 1051), "l2")],
    "float32": [((38, 289), "resident"), ((21, 523), "l2")],
}


class TestResidentRule:
    """B1's two bodies compute one function; the size rule only picks the
    body. Its plain version is held against the JAX kernel at the shapes
    that bound the rule, and the rule itself is a pure function."""

    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_body_at_the_limit(self, dtype):
        torch_dtype = getattr(torch, dtype)
        for (h, w), body in RESIDENT_EDGE[dtype]:
            assert mf.transform_body(h * w, torch_dtype, H100_SMEM_OPTIN) == body
            fits = mf.resident_bytes(h * w, torch_dtype) <= H100_SMEM_OPTIN
            assert fits == (body == "resident")
        assert mf.transform_body(64 * 64, torch_dtype, H100_SMEM_OPTIN) == "resident"
        assert mf.resident_bytes(64 * 64, torch_dtype) % 16 == 0

    @pytest.mark.parametrize(
        "dtype, shape",
        [(d, hw) for d, cases in RESIDENT_EDGE.items() for hw, _ in cases]
        + [("uint8", (64, 64)), ("float32", (64, 64))],
    )
    def test_plain_matches_jax_kernel_at_the_rule_edges(self, dtype, shape, fitted):
        he, mc = fitted
        x = _as_dtype(np.concatenate([_tile(*shape, seed=s, he_scale=1.1) for s in (8, 9)]), dtype)
        want = jax_mk.macenko_transform(jnp.asarray(x), he, mc, use_pallas=True)
        got = mf.macenko_transform_mega_plain(_t(x), _t(he), _t(mc))
        assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
        _assert_grey_close(got, want)

    def test_fallback_tile_matches_jax(self, fitted):
        """A tile whose red plane is light (OD below β) but for two pixels:
        fewer than 3 survive the β-mask, so the transform takes every
        pixel's moments and angles. As in :class:`TestEdgeTiles`, the JAX
        XLA path is the comparison (the Pallas kernel's float32 sums move
        this tile's stain plane)."""
        he, mc = fitted
        tile = _tile(64, 64, seed=11).copy()
        tile[0, 0] = np.maximum(tile[0, 0], 215)
        tile[0, :, 5, 7] = (120, 60, 150)
        tile[0, :, 40, 3] = (90, 70, 130)
        od = -np.log((tile.astype(np.float32) + 1.0) / 240.0)
        assert (od.min(axis=1) >= 0.15).sum() == 2
        want = jax_mk.macenko_transform(jnp.asarray(tile), he, mc, use_pallas=False)
        got = mf.macenko_transform_mega_plain(_t(tile), _t(he), _t(mc))
        _assert_grey_close(got, want)


class TestEdgeTiles:
    """Tiles whose covariance is exactly zero. Their output rests on what the
    degenerate eigh branch makes of it: the port sums in float64, gets an
    exact zero covariance and the zero stain plane, and so matches the JAX
    XLA path (240 everywhere). The JAX Pallas kernel's float32 tree sums
    leave a residue of a few ulps, which picks an arbitrary plane (measured
    on the CPU: 255 for the uniform-250 tile, (44, 13, 40) for the white
    one), so the comparison here is with ``use_pallas=False``."""

    @pytest.mark.parametrize("value", [255, 250])
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_uniform_tiles(self, value, dtype, fitted):
        he, mc = fitted
        tile = _as_dtype(np.full((1, 3, 72, 80), value, np.uint8), dtype)
        want = jax_mk.macenko_transform(jnp.asarray(tile), he, mc, use_pallas=False)
        got = mf.macenko_transform_mega_plain(_t(tile), _t(he), _t(mc)).float()
        assert torch.isfinite(got).all()
        flat = got.reshape(3, -1)
        assert (flat.amax(1) == flat.amin(1)).all()
        _assert_grey_close(got, want)

    def test_negative_max_concentration_tile(self):
        """The pen-ink-like tile of ``tests/test_kernels.py``: its own fit
        gives a negative maxC, and the sign-preserving guard keeps the
        transform finite and mostly unsaturated."""
        tile = _negative_maxc_tile()
        _, mc_tile = mk.macenko_fit(_t(tile))
        assert float(mc_tile[1]) < -0.005
        he, mc = mk.macenko_fit(_t(_tile(64, 64, seed=3)))
        out = mk.macenko_transform(_t(tile), he, mc).float()
        assert torch.isfinite(out).all()
        assert ((out == 0) | (out == 255)).float().mean() < 0.5


def _negative_maxc_tile():
    """OD design of ``tests/test_kernels.py::test_negative_max_concentration_tile``."""
    psi0, delta, n = 0.0, -2.8, 64
    rng = np.random.default_rng(0)
    total = n * n
    n_bg, n_sat, n_anchor = 2560, 20, 16
    n_bulk = total - n_bg - n_sat - n_anchor
    d = np.ones(3) / np.sqrt(3)
    t1 = np.array([1.0, -1.0, 0.0]) / np.sqrt(2)
    t2 = np.array([1.0, 1.0, -2.0]) / np.sqrt(6)

    def v(psi):
        return np.cos(psi) * t1 + np.sin(psi) * t2

    od = np.zeros((total, 3))
    i = 0
    psis = psi0 + rng.uniform(0.05, 0.2, n_bulk)
    rs = rng.uniform(0.06, 0.10, n_bulk)
    od[i : i + n_bulk] = 0.5 * d + rs[:, None] * np.stack([v(p) for p in psis])
    i += n_bulk
    od[i : i + n_anchor] = 0.5 * d + 0.08 * v(psi0 - 0.2)
    i += n_anchor
    ps = psi0 + delta + rng.uniform(-0.02, 0.02, n_sat)
    od[i : i + n_sat] = 0.5 * d + 0.09 * np.stack([v(p) for p in ps])
    i += n_sat
    od[i:] = 0.17 * (0.5 * d + 0.08 * v(psi0 + 0.125))
    tile = np.clip(np.round(240.0 * np.exp(-od) - 1.0), 0, 255).astype(np.uint8)
    rng.shuffle(tile, axis=0)
    return tile.T.reshape(1, 3, n, n)


@pytest.fixture(scope="module")
def jax_normalizer(ref64):
    return stainx_tpu.Macenko(backend="pallas").fit(ref64)


class TestPublicAPI:
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_matches_jax_normalizer(self, dtype, ref64, jax_normalizer, batch_72x80):
        x = _as_dtype(batch_72x80, dtype)
        want = jax_normalizer.transform(x)
        got = Macenko(device="cpu").fit(ref64).transform(x)
        assert got.device.type == "cpu" and got.dtype == getattr(torch, dtype)
        _assert_grey_close(got, want)

    def test_oracle_mae(self, ref64):
        batch = np.concatenate([_tile(64, 64, seed=s, he_scale=1.15) for s in (123, 124)])
        got = Macenko(device="cpu").fit(ref64).transform(batch).float().numpy()
        he_o, mc_o = oracle.macenko_fit(ref64)
        want = oracle.macenko_transform(batch, he_o, mc_o).astype(np.float32)
        assert np.abs(got - want).mean() <= 0.35

    @pytest.mark.parametrize("source", ["npz", "state_dict"])
    def test_jax_state_carries_over(self, source, tmp_path, jax_normalizer, batch_72x80):
        if source == "npz":
            path = tmp_path / "ref.npz"
            jax_normalizer.save_state(str(path))
            ported = Macenko(device="cpu").load_state(state_from_jax(path, device="cpu"))
            direct = Macenko(device="cpu").load_state_file(str(path))
            assert torch.equal(direct.transform(batch_72x80), ported.transform(batch_72x80))
        else:
            state = {k: np.asarray(v) for k, v in jax_normalizer.state.items()}
            ported = Macenko(device="cpu").load_state(state_from_jax(state, device="cpu"))
        want = jax_normalizer.transform(batch_72x80)
        _assert_grey_close(ported.transform(batch_72x80), want)

    def test_save_state_round_trip(self, tmp_path, ref64, batch_72x80):
        m = Macenko(device="cpu").fit(ref64)
        path = tmp_path / "port.npz"
        m.save_state(str(path))
        with np.load(path) as data:
            assert sorted(data.files) == ["_stain_matrix", "_target_max_conc"]
        back = Macenko(device="cpu").load_state_file(str(path))
        assert torch.equal(back.transform(batch_72x80), m.transform(batch_72x80))
        moved = back.to_device("cpu")
        assert moved is back and back.device == torch.device("cpu")
        assert torch.equal(back.state["_stain_matrix"], m.state["_stain_matrix"])

    @pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
    def test_low_precision_floats_match_jax(self, dtype, ref64, jax_normalizer, batch_72x80):
        x32 = batch_72x80.astype(np.float32) / 255.0
        want = np.asarray(jax_normalizer.transform(jnp.asarray(x32).astype(dtype)))
        got = Macenko(device="cpu").fit(ref64).transform(torch.as_tensor(x32).to(getattr(torch, dtype)))
        assert got.dtype == getattr(torch, dtype)
        # One grey level, plus one quantum of the output dtype at [128, 256):
        # a sub-level f32 difference can straddle a rounding boundary.
        quantum = {"bfloat16": 1.0, "float16": 0.125}[dtype]
        _assert_grey_close(got, np.asarray(want, np.float32), atol=GREY + quantum)

    def test_normalize_to_0_1(self, ref64, batch_72x80):
        raw = Macenko(device="cpu").fit(ref64).transform(batch_72x80)
        unit = Macenko(device="cpu", normalize_to_0_1=True).fit(ref64).transform(batch_72x80)
        assert torch.equal(unit, raw / 255.0)

    @pytest.mark.parametrize("stage", ["transform", "fit"])
    def test_seed_state_passes_through(self, stage, fitted, batch_72x80):
        he, mc = fitted
        state = mf.seed_state_init()
        assert state.dtype == torch.int32 and state.shape == (7,)
        x = _t(batch_72x80)
        if stage == "transform":
            out, new = mk.macenko_transform(x, _t(he), _t(mc), seed_state=state)
            assert torch.equal(out, mk.macenko_transform(x, _t(he), _t(mc)))
        else:
            he_t, mc_t, new = mk.macenko_fit(x, seed_state=state)
            he2, mc2 = mk.macenko_fit(x)
            assert torch.equal(he_t, he2) and torch.equal(mc_t, mc2)
        assert new is state


class TestErrors:
    def test_bad_precision(self):
        with pytest.raises(ValueError, match="precision"):
            Macenko(device="cpu", precision="medium")
        with pytest.raises(ValueError, match="precision"):
            stainx_tpu.Macenko(device="cpu", precision="medium")

    @pytest.mark.parametrize("shape", [(3, 16, 16), (1, 4, 16, 16), (1, 16, 16, 3)])
    @pytest.mark.parametrize("stage", ["fit", "transform"])
    def test_layout_errors_match_jax(self, shape, stage, ref64):
        bad = np.zeros(shape, np.uint8)
        for m in (Macenko(device="cpu"), stainx_tpu.Macenko(device="cpu")):
            if stage == "transform":
                m.fit(ref64)
            with pytest.raises(ValueError, match=f"Macenko {stage} expects"):
                getattr(m, stage)(bad)

    def test_transform_before_fit(self):
        with pytest.raises(ValueError, match="Must call fit"):
            Macenko(device="cpu").transform(np.zeros((1, 3, 8, 8), np.uint8))

    def test_default_device_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            get_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            get_device("cuda:0")
        with pytest.raises(RuntimeError, match="CUDA"):
            Macenko()
        with pytest.raises(ValueError, match="unsupported device"):
            get_device("meta")
        assert get_device("cpu") == torch.device("cpu")

    def test_kernel_dtype_is_checked(self):
        with pytest.raises(TypeError, match="uint8 or float32"):
            mf.macenko_transform_mega(
                torch.zeros((1, 3, 8, 8), dtype=torch.int16), torch.zeros(3, 2), torch.ones(2)
            )

    def test_cpu_path_never_builds(self, monkeypatch, ref64):
        def no_build():
            raise AssertionError("the CPU path must not build the CUDA kernels")

        monkeypatch.setattr(kernels, "build_all", no_build)
        before = profiling.counters("launch.")
        Macenko(device="cpu").fit(ref64).transform(ref64)
        assert profiling.counters("launch.") == before
