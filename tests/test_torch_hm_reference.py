"""The benchmark's plain PyTorch histogram matching
(``portbench/reference/histogram_matching.py``) against the numpy oracle,
the port against it through the check that decides a histogram-matching
cell's ``correct``, its bfloat16 control, planted faults, and the
``stainx.stats`` span of the port's histogram-matching transform.

The reference is loaded by its path, as the benchmark loads it, and so is
the oracle, so that the file runs on a card's machine, where JAX is absent
(``pytest --noconftest``) and an installed ``tests`` package may shadow
this one."""

from __future__ import annotations

import ast
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, control, faults, gen, harness, spec
from stainx_tpu_torch import HistogramMatching, profiling

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "portbench/configs/hm-u8-512.json").read_text())
LIMITS = CONFIG["limits"]
CELL = "hm-u8-512.store-b256"


def _load(name: str, path: str):
    spec_ = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


REF = _load("portbench_test_hm_reference", "portbench/reference/histogram_matching.py")
oracle = _load("hm_reference_test_oracle", "tests/oracles/numpy_reference.py")


def _tiles(n: int, size: int, seed: int) -> torch.Tensor:
    """``n`` seeded 3 x size x size uint8 tiles of the benchmark's kind."""
    g = gen.torch_generator(np.random.SeedSequence(seed), torch.device("cpu"))
    return gen.tiles(n, (3, size, size), "uint8", (0.85, 1.15), g)


def _port_item(n: int = 16, size: int = 64, seed: int = 2**32 + 5) -> check.Item:
    """One call of the port's plain path on ``n`` tiles after a fit on one
    more, every row checked."""
    ref, batch = _tiles(1, size, seed), _tiles(n, size, seed + 1)
    system = HistogramMatching(device="cpu").fit(ref)
    out = system.transform(batch).numpy()
    state = {k: v.cpu().numpy() for k, v in system.state.items()}
    return check.Item(ref.numpy(), state, batch.numpy(), np.arange(n), out)


def test_the_reference_states_its_interface():
    assert REF.STATISTICS == "call"
    assert REF.OPS_PER_PIXEL == {"fit": 0, "transform": 0, "float_input": 3, "unit_output": 3}
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_the_reference_imports_nothing_of_the_program():
    names = set()
    tree = ast.parse((ROOT / "portbench/reference/histogram_matching.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert names <= {"__future__", "numpy", "torch"}, names


@pytest.mark.parametrize("seed", [7, 2**32 + 5, 3_000_000_019])
def test_the_reference_is_the_numpy_oracle(seed):
    """Histograms within 1e-6 and outputs within one grey level of the
    oracle's, on seeded 16x3x64^2 tiles of the benchmark's kind (more images
    than a block holds, so the counts add over blocks)."""
    images = _tiles(REF.BLOCK_ROWS + 1, 64, seed).numpy()
    state = REF.fit(images[:1])
    hists = oracle.hm_fit(images[:1])
    gaps = REF.state_gaps({"_ref_histograms_256": np.stack(hists)}, state)
    assert gaps["hist_gap"] <= 1e-6, gaps
    got = REF.transform(images[1:], state)
    want = oracle.hm_transform(images[1:], hists)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1


def test_the_lut_is_the_ports_on_counts_at_the_cells_scale():
    """The reference's LUT, floored to the uint8 table, equals the port's
    plain ``hm_build_lut`` on counts of 2^26 values a channel (a call of
    256x3x512^2) matched to 2^18 (one 512^2 tile) with empty tail bins,
    where a CDF value one ulp off a flat stretch of the reference's CDF
    moves an entry by the stretch's width: both add in the JAX package's
    order."""
    from stainx_tpu_torch.kernels import histogram as hk

    rng = np.random.default_rng(28)
    bins = np.arange(256)
    for _ in range(20):
        centre, width = rng.uniform(90, 200, 3), rng.uniform(10, 35, 3)
        pmf = np.exp(-0.5 * ((bins[None] - centre[:, None]) / width[:, None]) ** 2)
        source = np.stack([rng.multinomial(2**26, p / p.sum()) for p in pmf])
        shifted = np.clip(np.round(rng.normal(centre[:, None] + rng.uniform(-15, 15, (3, 1)),
                                              width[:, None], (3, 2**18))), 0, 255)
        ref = np.stack([np.bincount(row.astype(np.int64), minlength=256) for row in shifted])
        ref_hist = torch.as_tensor(ref, dtype=torch.float32) / (2**18 + 1e-8)
        ours = REF.lut(torch.as_tensor(source), ref_hist, 2**26)
        port = hk.hm_build_lut(torch.as_tensor(source, dtype=torch.float32), ref_hist, 2.0**26)
        assert torch.equal(torch.floor(ours), torch.floor(port))


def test_float_input_is_the_numpy_oracle():
    """A float32 call in [0, 1] is quantized as the oracle quantizes it and
    comes back in [0, 1], within one grey level."""
    images = _tiles(5, 40, 11).numpy().astype(np.float32) / 255.0
    state = REF.fit(images[:1])
    got = REF.transform(images[1:], state)
    want = oracle.hm_transform(images[1:], oracle.hm_fit(images[:1]))
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got.astype(np.float64) - want).max() * 255.0 <= 1.0 + 1e-4


def test_the_port_is_within_the_configurations_limits():
    """The port's plain path at 16x3x64^2 uint8 against the reference
    through the check: every limit of ``hm-u8-512`` holds, and the fitted
    histograms agree."""
    found = check.gaps([_port_item()], REF, 255.0)
    ok, checks = check.judge(found, LIMITS)
    assert ok, checks
    assert found["hist_gap"] <= 1e-6, found


def test_the_bf16_control_is_not_correct():
    item = _port_item()
    [ctrl] = control.control_items([item], REF, 255.0)
    found = check.gaps([ctrl], REF, 255.0)
    assert not check.judge(found, LIMITS)[0]
    assert sum(found[k] > v for k, v in LIMITS.items()) >= 1, found


def test_statistics_are_those_of_the_whole_call():
    """Why the reference states ``"call"``: transformed whole, the call
    agrees with the port; in 16-row blocks, each block takes its own CDF and
    the outputs move by more than the limit."""
    item = _port_item(n=32)
    state = REF.fit(item.fit_input)
    whole = REF.transform(item.call_input, state).astype(np.float64)
    blocks = np.concatenate([REF.transform(item.call_input[lo:lo + check.BLOCK_ROWS], state)
                             for lo in range(0, 32, check.BLOCK_ROWS)]).astype(np.float64)
    prog = item.program_rows.astype(np.float64)
    assert np.abs(prog - whole).max() <= LIMITS["out_max"]
    assert np.abs(prog - whole).mean() <= LIMITS["out_mae"]
    assert np.abs(prog - blocks).mean() > LIMITS["out_mae"]


@pytest.fixture
def small_cell():
    """The histogram-matching cell on the CPU at 16x3x64^2, its
    configuration's limits, checked against the committed reference."""
    cell = spec.cell(CELL)
    cell.config["tile"] = [3, 64, 64]
    cell.traffic.update(batch=16, pool_batches=2, in_flight=2, check_rows=16)
    return cell


def test_a_sound_run_of_the_cell_is_correct(small_cell):
    result = harness.run_cell(small_cell, 2**32 + 17, 0.3, False, torch.device("cpu"),
                              time.perf_counter())
    assert result["correct"] is True and result["attempted"] > 0, result["checks"]
    assert result["notes"]["gap_hist_gap"] <= 1e-6


@pytest.mark.parametrize("fault", ["returns_its_input", "half_the_batch"])
def test_a_fault_is_not_correct(small_cell, fault):
    result = harness.run_cell(small_cell, 2**32 + 17, 0.3, False, torch.device("cpu"),
                              time.perf_counter(), faults.FAULTS[fault])
    assert result["correct"] is False, result["checks"]


@pytest.mark.cuda
def test_the_stats_span_on_the_card():
    """On the card: a profiled and an unprofiled transform give equal bits
    and equal launch counts, and each profiled call holds one ``stainx.stats``
    span, a child of ``stainx.kernel.B8``, with a device interval."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the span's events are recorded by the C call")
    dev = torch.device("cuda", 0)
    system = HistogramMatching(device=dev).fit(_tiles(1, 512, 3).to(dev))
    batch = _tiles(16, 512, 4).to(dev)

    def launches(fn):
        before = profiling.counters("launch.")
        out = fn()
        torch.cuda.synchronize(dev)
        after = profiling.counters("launch.")
        return out, {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}

    plain, plain_launches = launches(lambda: system.transform(batch))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        profiled, profiled_launches = launches(
            lambda: [system.transform(batch) for _ in range(3)])
    assert plain_launches == {"launch.B8a": 1, "launch.B8b": 1}
    assert profiled_launches == {k: 3 * v for k, v in plain_launches.items()}
    assert all(torch.equal(out, plain) for out in profiled)
    sess = profiling.session()
    assert len(sess.roots()) == 3
    stats = [s for s in sess.spans if s.name == "stainx.stats"]
    assert len(stats) == 3 and len({s.call for s in stats}) == 3
    for s in stats:
        assert sess.spans[s.parent].name == "stainx.kernel.B8"
        assert s.device_ms is not None and 0 < s.device_ms
        whole = sess.spans[s.call]
        assert whole.name == "stainx.transform" and s.device_ms < whole.device_ms


@pytest.mark.cuda
def test_the_transform_off_a_session_is_the_same_call():
    """On the card: outside a session the C call gets two null events, and
    its output, LUT and table equal those of a profiled call bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the C call records the events")
    from stainx_tpu_torch.kernels import histogram as hk

    dev = torch.device("cuda", 0)
    ref = HistogramMatching(device=dev).fit(_tiles(1, 512, 5).to(dev))._ref_histograms_256
    values = _tiles(8, 512, 6).to(dev).reshape(8, 3, -1)
    with profiling.caller_timed("stainx.stats", dev) as events:
        assert events is None
    off = hk.hm_transfer(values, ref, torch.uint8)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        on = hk.hm_transfer(values, ref, torch.uint8)
    torch.cuda.synchronize(dev)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert [s.name for s in profiling.session().spans] == ["stainx.kernel.B8", "stainx.stats"]
    assert all(torch.equal(a, b) for a, b in zip(off, hk.hm_transfer_plain(values, ref, torch.uint8)))
