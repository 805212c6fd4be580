"""The port's Macenko on PatchCamelyon-shaped 96² patches against the
benchmark's Macenko reference (``portbench/reference/macenko.py``) through
the check that decides ``macenko-u8-96.store-b512``'s ``correct``, the route
facts the cell rests on (B2 fits the reference, B1's resident body
transforms, one block of it an SM), and, on the card, B1 at the cell's
shape, its span's device interval and its counters.

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
from stainx_tpu_torch import Macenko, profiling
from stainx_tpu_torch.kernels import macenko_fused as mf
from stainx_tpu_torch.ops import macenko as ops_macenko

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
    body (122 368 bytes of shared memory), and the 96² reference's fit to
    B2."""
    assert ops_macenko.transform_route(512, P, torch.uint8) == "mega"
    assert mf.transform_body(P, torch.uint8, H100_SMEM) == "resident"
    assert mf.resident_bytes(P, torch.uint8) == 20_992 + 73_728 + 27_648 == 122_368
    assert ops_macenko.fit_route(P, torch.uint8, H100_SMEM) == "mega"
    # Two such blocks and their 1 KB reserves pass an H100 SM's 233 472 bytes.
    assert 2 * (mf.resident_bytes(P, torch.uint8) + 1024) > 233_472


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
        assert s.device_ms is not None and 0 < s.device_ms
        whole = sess.spans[s.call]
        assert whole.name == "stainx.transform" and s.device_ms <= whole.device_ms
    # Off a session the same call opens no span: the session stays as it was.
    spans = list(sess.spans)
    again = system.transform(batch)
    torch.cuda.synchronize(dev)
    assert torch.equal(again, plain)
    assert profiling.session() is sess and sess.spans == spans
