"""The port's Macenko on PatchCamelyon-shaped 96² patches against the
benchmark's Macenko reference (``portbench/reference/macenko.py``) through
the check that decides ``macenko-u8-96.store-b512``'s ``correct``, the route
facts the cell rests on (B2 fits the reference, B1's resident body
transforms, two blocks of it an SM), and, on the card, B1 at the cell's
shape, its span's device interval, its counters and blocks an SM, and the
selections of B1's resident body and of B2 at 96² and at the largest row
and pool a block holds, and B1 on a tile that takes the <3-pixel fallback.

The reference is loaded by its path, as the benchmark loads it, so that
the file runs on a card's machine, where JAX is absent (``pytest
--noconftest``)."""

from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, control, gen, harness, spec
from stainx_tpu_torch import Macenko, kernels, profiling
from stainx_tpu_torch.kernels import macenko_fused as mf
from stainx_tpu_torch.kernels.selection import monotone_key
from stainx_tpu_torch.ops import eigh3
from stainx_tpu_torch.ops import macenko as ops_macenko
from stainx_tpu_torch.testing import HE_REF, largest, selections_exact, synthetic_he_batch

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "portbench/configs/macenko-u8-96.json").read_text())
LIMITS = CONFIG["limits"]
CELL = "macenko-u8-96.store-b512"
P = 96 * 96
H100_SMEM = ops_macenko.CPU_ROUTE_SMEM  # a block's opt-in shared memory on an H100


def _load(name: str, path: str):
    spec_ = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


REF = _load("portbench_test_patch_reference", "portbench/reference/macenko.py")


def _patches(n: int, seed: int, device=torch.device("cpu")) -> torch.Tensor:
    """``n`` seeded 3x96x96 uint8 patches of the benchmark's kind."""
    g = gen.torch_generator(np.random.SeedSequence(seed), torch.device(device))
    return gen.tiles(n, (3, 96, 96), "uint8", (0.85, 1.15), g)


def _item(n: int, seed: int, device=torch.device("cpu")) -> check.Item:
    """One call of the port on ``n`` patches after a fit on one more, every
    row checked."""
    ref, batch = _patches(1, seed, device), _patches(n, seed + 1, device)
    system = Macenko(device=device).fit(ref)
    out = system.transform(batch).cpu().numpy()
    state = {k: v.cpu().numpy() for k, v in system.state.items()}
    return check.Item(ref.cpu().numpy(), state, batch.cpu().numpy(), np.arange(n), out)


@pytest.mark.parametrize("seed", [7, 2**32 + 5, 3_000_000_019])
def test_the_port_is_within_the_configurations_limits(seed):
    """The port's plain path, fitted on one 1x3x96² patch, on 8x3x96² uint8
    patches: every limit of ``macenko-u8-96`` holds."""
    found = check.gaps([_item(8, seed)], REF, 255.0)
    ok, checks = check.judge(found, LIMITS)
    assert ok, checks


def test_the_bf16_control_is_not_correct():
    [ctrl] = control.control_items([_item(8, 11)], REF, 255.0)
    found = check.gaps([ctrl], REF, 255.0)
    assert not check.judge(found, LIMITS)[0], found


def test_the_cells_routes():
    """A 512x3x96² uint8 call goes to B1 (below B4's floor), on its resident
    body (114 176 bytes of shared memory), and the 96² reference's fit to
    B2."""
    assert ops_macenko.transform_route(512, P, torch.uint8) == "mega"
    assert mf.transform_body(P, torch.uint8, H100_SMEM) == "resident"
    assert mf.resident_bytes(P, torch.uint8) == 12_800 + 73_728 + 27_648 == 114_176
    assert ops_macenko.fit_route(P, torch.uint8, H100_SMEM) == "mega"
    # Two such blocks and their 1 KB reserves fit an H100 SM's 233 472 bytes.
    assert mf.resident_bytes(P, torch.uint8) + 1024 <= 233_472 // 2


def test_a_small_run_of_the_cell_is_correct():
    """The cell on the CPU at 8 patches a call, its configuration's limits,
    checked against the committed reference."""
    cell = spec.cell(CELL)
    cell.traffic.update(batch=8, pool_batches=2, in_flight=2, check_rows=8)
    result = harness.run_cell(cell, 2**32 + 17, 0.3, False, torch.device("cpu"),
                              time.perf_counter())
    assert result["correct"] is True and result["attempted"] > 0, result["checks"]


# ------------------------------------------------------------------ card
def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B1 and its span's events run there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_b1_at_the_cells_shape_is_the_reference():
    """B1 on 512x3x96² uint8 after B2's fit of one 96² patch: every limit of
    the configuration holds over all 512 patches."""
    dev = _card()
    before = profiling.counters()
    found = check.gaps([_item(512, 2**33 + 3, dev)], REF, 255.0)
    ok, checks = check.judge(found, LIMITS)
    assert ok, checks
    after = profiling.counters()
    delta = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    assert delta.get("launch.B2") == 1 and delta.get("launch.B1") == 1, delta


@pytest.mark.cuda
def test_the_b1_span_and_counters_in_a_session():
    """Each of three profiled transforms holds one ``stainx.kernel.B1`` span
    with a device interval (its launch alone, recorded inside the C call)
    inside its transform's, on the resident body with
    the blocks an SM the card reports, and counts one ``resident.B1`` and no
    ``l2.B1``; the same call off a session gives the same bits and makes no
    span."""
    dev = _card()
    system = Macenko(device=dev).fit(_patches(1, 5, dev))
    batch = _patches(512, 6, dev)
    plain = system.transform(batch)
    torch.cuda.synchronize(dev)
    before = profiling.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        profiled = [system.transform(batch) for _ in range(3)]
        torch.cuda.synchronize(dev)
    after = profiling.counters()
    delta = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    assert delta.get("launch.B1") == 3 and delta.get("resident.B1") == 3, delta
    assert "l2.B1" not in delta and not any(k.startswith("launch.B4") for k in delta), delta
    assert all(torch.equal(out, plain) for out in profiled)
    sess = profiling.session()
    assert len(sess.roots()) == 3
    b1 = [s for s in sess.spans if s.name == "stainx.kernel.B1"]
    assert len(b1) == 3 and len({s.call for s in b1}) == 3
    smem = mf.resident_bytes(P, torch.uint8)
    props = torch.cuda.get_device_properties(dev)
    per_sm = getattr(props, "shared_memory_per_multiprocessor", None)
    for s in b1:
        assert s.args["route"] == "resident"
        assert s.args["blocks_per_sm"] >= 1
        if per_sm is not None:  # shared memory sets it: 512 threads use a quarter of an SM
            assert s.args["blocks_per_sm"] == min(per_sm // (smem + 1024), 4), (per_sm, s.args)
        if per_sm == 233_472:  # an H100: two 96² blocks an SM
            assert s.args["blocks_per_sm"] == 2, s.args
        assert s.device_ms is not None and 0 < s.device_ms
        whole = sess.spans[s.call]
        assert whole.name == "stainx.transform" and s.device_ms <= whole.device_ms
    # Off a session the same call opens no span: the session stays as it was.
    spans = list(sess.spans)
    again = system.transform(batch)
    torch.cuda.synchronize(dev)
    assert torch.equal(again, plain)
    assert profiling.session() is sess and sess.spans == spans


def _rows(n: int, p: int, dtype: torch.dtype, seed: int, dev) -> torch.Tensor:
    x = torch.as_tensor(synthetic_he_batch(n, 1, p, seed=seed)).to(dev)
    return x if dtype == torch.uint8 else x.float() / 255.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["u8-96", "u8-largest", "f32-largest"])
def test_resident_selections_are_exact(case):
    """B1's resident body on 96² uint8 patches and on the largest rows a
    block holds (19 968 uint8 pixels, 10 982 float32): its four selections
    are those of the plain select on the keys it selected on, bit for bit;
    its output is within 1 grey level of the plain version and the same
    bits as the uncounted launch's."""
    dev = _card()
    smem = kernels.device_limits(dev.index)[1]
    dtype = torch.float32 if case.startswith("f32") else torch.uint8
    if case == "u8-96":
        x = _patches(16, 21, dev)
    else:
        p = largest(lambda q: mf.transform_body(q, dtype, smem) == "resident")
        if smem == H100_SMEM:
            assert p == (19_968 if dtype == torch.uint8 else 10_982)
        x = _rows(3, p, dtype, 22 + p, dev)
    he, mc = mf.macenko_fit_mega_plain(_patches(1, 23, dev))
    out, keys, sel = mf.resident_selections(x, he, mc)
    plain = mf.macenko_transform_mega_plain(x, he, mc)
    again = mf.macenko_transform_mega(x, he, mc)
    torch.cuda.synchronize(dev)
    assert selections_exact(keys, sel, x.shape[2] * x.shape[3])
    assert (out.float() - plain.float()).abs().max().item() <= 1.0
    assert torch.equal(again, out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_b2_at_its_largest_pool(dtype):
    """B2 on the largest pool a block holds (19 850 uint8 pixels, 10 918
    float32): its selections are the plain select's on its keys, bit for
    bit, its fit within HE atol 2e-5 and maxC rtol 1e-4 of the plain
    version; the next pool is B5's and B2 refuses it."""
    dev = _card()
    smem = kernels.device_limits(dev.index)[1]
    p = largest(lambda q: ops_macenko.fit_route(q, dtype, smem) == "mega")
    if smem == H100_SMEM:
        assert p == (19_850 if dtype == torch.uint8 else 10_918)
    x = _rows(1, p, dtype, 24 + p, dev)
    he, mc, keys, sel = mf.fit_selections(x)
    he_w, mc_w = mf.macenko_fit_mega(x)
    he_p, mc_p = mf.macenko_fit_mega_plain(x)
    torch.cuda.synchronize(dev)
    assert selections_exact(keys[None], sel[None], p)
    assert torch.equal(he_w, he) and torch.equal(mc_w, mc)
    torch.testing.assert_close(he, he_p, atol=2e-5, rtol=0)
    torch.testing.assert_close(mc, mc_p, atol=0, rtol=1e-4)
    assert ops_macenko.fit_route(p + 1, dtype, smem) == "stream"
    with pytest.raises(ValueError, match="shared memory"):
        mf.macenko_fit_mega(_rows(1, p + 1, dtype, 25 + p, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3.0, 6.0, 240.0])
def test_div_rn_divides_on_the_card(c):
    """The plain versions divide by a constant on the card as on the CPU and
    in the kernels, where PyTorch's CUDA ``x / c`` multiplies by the float32
    reciprocal."""
    dev = _card()
    x = torch.rand(1 << 16, generator=torch.Generator().manual_seed(int(c))) * 300
    assert torch.equal(eigh3.div_rn(x.to(dev), c).cpu(), eigh3.div_rn(x, c))


@pytest.mark.cuda
def test_b1_on_a_fallback_tile_is_its_plain_version():
    """Two 67x71 uint8 images whose red plane is light (OD below β) but for
    two pixels, drawn on the card as ``chip_smoke.py``'s phase 8 draws them
    at seed 0: the <3-pixel fallback takes every pixel, and the stain
    vectors come out nearly parallel, so a last-bit difference upstream
    moves the output. B1's angle keys are the plain version's angles bit for
    bit and its output within 1 grey level (the plain version dividing by a
    reciprocal's product put it 2 off)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(899_216_310)
    scale = 0.9 + 0.3 * torch.rand((), generator=g, device=dev)
    he_true = torch.tensor(HE_REF, device=dev) * scale
    conc = torch.stack([0.3 + 1.8 * torch.rand((2, 67 * 71), generator=g, device=dev),
                        0.2 + torch.rand((2, 67 * 71), generator=g, device=dev)], 1)
    x = torch.clamp(240.0 * torch.exp(-torch.einsum("cs,nsp->ncp", he_true, conc)), 0.0, 255.0)
    x = x.to(torch.uint8).reshape(2, 3, 67, 71)
    x[:, 0] = torch.clamp(x[:, 0], min=215)
    x[:, :, 5, 7] = torch.tensor([120, 60, 150], dtype=torch.uint8, device=dev)[None, :]
    x[:, :, 40, 3] = torch.tensor([90, 70, 130], dtype=torch.uint8, device=dev)[None, :]
    x = x.contiguous()
    he, mc = mf.macenko_fit_mega(_patches(1, 31, dev))
    out, keys, sel = mf.resident_selections(x, he, mc)
    plain = mf.macenko_transform_mega_plain(x, he, mc)
    od = mf.od_from_planes(x.reshape(2, 3, -1), True)
    cnt, sums = mf.masked_moments(od, torch.ones(2, 67 * 71, dtype=torch.bool, device=dev))
    assert int((od.amin(1) >= mf.BETA).sum(-1).max()) == 2
    evecs = eigh3.eigh3_top2(mf.cov_from_moments(cnt, sums))
    angles = mf.pseudo_angle(mf._project(od, evecs[..., 0]), mf._project(od, evecs[..., 1]))
    torch.cuda.synchronize(dev)
    assert torch.equal(monotone_key(angles), keys[:, 0].to(torch.int64) & 0xFFFFFFFF)
    assert selections_exact(keys, sel, 67 * 71)
    assert (out.float() - plain.float()).abs().max().item() <= 1.0
