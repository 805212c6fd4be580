"""The comparison that decides ``correct``: the reference, its control, and
the faults a cell can have, at sizes a test run holds (the program's plain
PyTorch path on the CPU)."""

from __future__ import annotations

import importlib.util
import json
import math
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import stainx_tpu_torch
from portbench import check, control, faults, gen, harness, spec

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
REF = spec.load_module("reference", "macenko")

CELLS = {
    "store": ("macenko-u8-256", [3, 32, 32],
              {"driver": "closed_loop", "batch": 4, "pool_batches": 2, "in_flight": 2,
               "check_batches": 1, "check_rows": 4}),
    "train": ("macenko-batchmode-f32-256", [3, 24, 24],
              {"driver": "closed_loop", "batch": 4, "pool_batches": 3, "in_flight": 2,
               "check_batches": 3, "check_rows": 4}),
}


def small_cell(kind: str) -> spec.Cell:
    """A cell of a committed configuration at a small tile, with small traffic."""
    config_name, tile, traffic = CELLS[kind]
    config = json.loads((ROOT / "portbench/configs" / f"{config_name}.json").read_text())
    config["tile"] = tile
    return spec.Cell(f"{config_name}.{kind}", 1, config, dict(traffic))


def _oracle():
    path = ROOT / "tests/oracles/numpy_reference.py"
    spec_ = importlib.util.spec_from_file_location("portbench_test_oracle", path)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_reference_is_the_numpy_oracle(dtype):
    """The frozen copy gives the repository's numpy oracle's bits."""
    oracle = _oracle()
    rng = np.random.default_rng(3)
    images = np.stack([oracle.synthetic_he_tile(20, 24, seed=s, he_scale=1.0 + 0.05 * s)[0]
                       for s in range(3)])
    if dtype == "float32":
        images = images.astype(np.float32) / 255.0
    state = REF.fit(images)
    he, mc = oracle.macenko_fit(images)
    assert np.array_equal(state["_stain_matrix"], he)
    assert np.array_equal(state["_target_max_conc"], mc)
    src = images[rng.permutation(3)]
    assert np.array_equal(REF.transform(src, state), oracle.macenko_transform(src, he, mc))


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.0 + 2**-8, 1.0 + 3 * 2**-8, 1.0 + 2**-9, -3.14159, 0.0], np.float32)
    r = REF.bf16(x)
    assert r.tolist() == [1.0, 1.0, 1.0 + 4 * 2**-8, 1.0, -3.140625, 0.0]
    assert np.array_equal(REF.bf16(r), r)


def test_state_gaps():
    a = {"_stain_matrix": np.ones((3, 2), np.float32), "_target_max_conc": np.array([2.0, 4.0])}
    b = {"_stain_matrix": np.ones((3, 2), np.float32) + 1e-3,
         "_target_max_conc": np.array([2.0, 4.4])}
    gaps = REF.state_gaps(b, a)
    assert gaps["he_gap"] == pytest.approx(1e-3, rel=1e-3)
    assert gaps["maxc_gap"] == pytest.approx(0.1)


def test_judge_holds_each_number_to_its_limit():
    ok, checks = check.judge({"out_mae": 0.01, "he_gap": float("nan")}, {"out_mae": 0.02})
    assert ok and checks == {"out_mae": {"value": 0.01, "limit": 0.02}}
    assert not check.judge({"out_mae": 0.03}, {"out_mae": 0.02})[0]
    assert not check.judge({"out_mae": float("nan")}, {"out_mae": 0.02})[0]
    assert not check.judge({}, {"out_mae": 0.02})[0]
    assert check.lines(checks) == ["check out_mae 0.01 limit 0.02 ok"]


def _run(kind: str, patch=None, seed: int = 2**32 + 17) -> dict:
    return harness.run_cell(small_cell(kind), seed, 0.3, False, CPU, time.perf_counter(), patch)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_a_sound_run_is_correct(kind):
    result = _run(kind)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    for name, c in result["checks"].items():
        assert 0 <= c["value"] <= c["limit"], name


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_the_bf16_control_is_not_correct(kind):
    """The reference in bfloat16, in the program's place, fails the limits."""
    readings = control.readings(small_cell(kind), 2**33 + 1, 0.3, CPU)
    assert readings["correct"] is False
    limits = small_cell(kind).config["limits"]
    assert sum(readings["found"][k] > v for k, v in limits.items()) >= 2


@pytest.mark.parametrize("kind,fault", [(k, f) for k in sorted(CELLS) for f in faults.FAULTS
                                         if faults.applies(f, small_cell(k))])
def test_a_fault_in_the_timed_path_is_not_correct(kind, fault):
    result = _run(kind, faults.FAULTS[fault])
    assert result["correct"] is False, result["checks"]


def test_each_checked_forward_keeps_the_state_it_used():
    """In a cell that fits every batch, each checked forward's fit is its
    own batch's: the states kept do not alias one another."""
    cell = small_cell("train")
    job, driver, st, streams = harness.setup(cell, 5, 0.2, CPU)
    driver.warm(job, st)
    driver.run(job, st, 0.2, harness.trace.NoTrace())
    matrices = [s["_stain_matrix"] for s in st.states]
    assert all(m is not matrices[0] for m in matrices[1:])
    assert not torch.equal(matrices[0], matrices[1])


# Methods whose transform reads the whole call: the oracle's functions as
# ``"call"`` reference modules, the port's class beside each.


def _same(a):
    return a


def _reinhard_reference(oracle, statistics: str = "call"):
    """The oracle's Reinhard as a reference module, with ``rounding`` applied
    to every stored intermediate (off, it gives the oracle's bits)."""

    def fit(images, rounding=_same):
        lab = rounding(oracle.rgb_to_lab(images))
        return {"_reference_mean": rounding(lab.mean(axis=(0, 2, 3))),
                "_reference_std": rounding(lab.std(axis=(0, 2, 3), ddof=1))}

    def transform(images, state, rounding=_same):
        r = rounding
        lab = r(oracle.rgb_to_lab(images))
        mean = r(lab.mean(axis=(0, 2, 3), keepdims=True))
        std = r(lab.std(axis=(0, 2, 3), ddof=1, keepdims=True))
        ref_mean = np.reshape(state["_reference_mean"], (1, 3, 1, 1))
        ref_std = np.reshape(state["_reference_std"], (1, 3, 1, 1))
        lab_n = r(((lab - mean) / (std + 1e-8)) * ref_std + ref_mean)
        rgb = np.clip(r(oracle.lab_to_rgb(lab_n)), 0.0, 1.0)
        return oracle.restore_dtype(rgb, images.dtype, images.dtype == np.uint8, in_0_255=False)

    def state_gaps(program, reference):
        return {"stat_gap": max(float(np.max(np.abs(np.asarray(program[k], np.float64) - v)
                                             / np.abs(v))) for k, v in reference.items())}

    return types.SimpleNamespace(STATISTICS=statistics, fit=fit, transform=transform,
                                 state_gaps=state_gaps, bf16=REF.bf16,
                                 OPS_PER_PIXEL=REF.OPS_PER_PIXEL)


def _hm_reference(oracle, statistics: str = "call"):
    """The oracle's histogram matching as a reference module."""

    def fit(images):
        return {"_ref_histograms_256": np.stack(oracle.hm_fit(images))}

    def transform(images, state):
        return oracle.hm_transform(images, list(state["_ref_histograms_256"]))

    def state_gaps(program, reference):
        gap = np.abs(np.asarray(program["_ref_histograms_256"], np.float64)
                     - reference["_ref_histograms_256"])
        return {"hist_gap": float(gap.max())}

    return types.SimpleNamespace(STATISTICS=statistics, fit=fit, transform=transform,
                                 state_gaps=state_gaps)


CALL_METHODS = {"reinhard": (stainx_tpu_torch.Reinhard, _reinhard_reference),
                "hm": (stainx_tpu_torch.HistogramMatching, _hm_reference)}


def _port_item(method: str, rows=None, n: int = 32, seed: int = 11) -> check.Item:
    """One call of the port's plain path on ``n`` tiles of 3x32x32 uint8 from
    ``gen``, after a fit on one more; ``rows`` (all, unless given) checked."""
    g = gen.torch_generator(np.random.SeedSequence(seed), CPU)
    ref = gen.tiles(1, (3, 32, 32), "uint8", (0.85, 1.15), g)
    batch = gen.tiles(n, (3, 32, 32), "uint8", (0.85, 1.15), g)
    system = CALL_METHODS[method][0](device="cpu").fit(ref)
    out = system.transform(batch).numpy()
    rows = np.arange(n) if rows is None else np.asarray(rows)
    state = {k: v.cpu().numpy() for k, v in system.state.items()}
    return check.Item(ref.numpy(), state, batch.numpy(), rows, out[rows])


@pytest.mark.parametrize("method", sorted(CALL_METHODS))
def test_a_call_reference_compares_whole_calls(method):
    """Through the check, the oracle's Reinhard and HM agree with the port
    when they transform the whole call; transformed 16 rows at a time, as an
    ``"image"`` reference is, they take other statistics and read far off."""
    oracle = _oracle()
    item = _port_item(method)
    whole = check.gaps([item], CALL_METHODS[method][1](oracle, "call"), 255.0)
    assert whole["out_max"] <= 1 and whole["out_mae"] <= 0.02, whole
    blocks = check.gaps([item], CALL_METHODS[method][1](oracle, "image"), 255.0)
    assert blocks["out_max"] >= 2, blocks


@pytest.mark.parametrize("method", sorted(CALL_METHODS))
def test_a_call_reference_checks_sampled_rows_against_the_whole_call(method):
    """With fewer rows checked than the call holds, a ``"call"`` reference
    transforms the call's whole input once and compares the sampled rows of
    its output."""
    oracle = _oracle()
    rows = gen.sample(32, 5, np.random.SeedSequence(4))
    item = _port_item(method, rows)
    reference = CALL_METHODS[method][1](oracle, "call")
    seen = []
    transform = reference.transform
    reference.transform = lambda images, state: seen.append(images) or transform(images, state)
    found = check.gaps([item], reference, 255.0)
    assert len(seen) == 1 and seen[0] is item.call_input and len(seen[0]) == 32
    assert found["out_max"] <= 1 and found["out_mae"] <= 0.02, found
    alone = check.Item(item.fit_input, item.program_state, item.call_input[rows],
                       np.arange(len(rows)), item.program_rows)
    assert check.gaps([alone], reference, 255.0)["out_max"] >= 2


def test_check_items_carry_the_whole_call_and_the_sampled_rows():
    cell = small_cell("store")
    cell.traffic.update(batch=6, check_rows=3)
    job, driver, st, streams = harness.setup(cell, 9, 0.2, CPU)
    driver.warm(job, st)
    driver.run(job, st, 0.2, harness.trace.NoTrace())
    [item] = driver.check_items(job, st, streams["check"])
    slot = next(s for s in range(len(st.pool)) if np.array_equal(st.pool[s].numpy(),
                                                                 item.call_input))
    assert item.call_input.shape == (6, 3, 32, 32) and len(item.rows) == 3
    assert np.all(np.diff(item.rows) > 0)
    assert np.array_equal(item.program_rows, st.last[slot].numpy()[item.rows])


REINHARD_CELL = {
    "name": "reinhard-u8-32", "method": "reinhard",
    "system": {"class": "Reinhard", "kwargs": {}}, "call": "transform", "fit": "reference",
    "tile": [3, 32, 32], "dtype": "uint8", "out_full_scale": 255.0, "stain_scale": [0.85, 1.15],
    "reference": "reinhard-call",
    # From 12 seeds of this cell (program, worst / bf16 control, least): stat_gap
    # 1.7e-6 / 2.1e-3, out_mae 1.5e-4 / 0.40, out_max 1 / 2.
    "limits": {"stat_gap": 1e-4, "out_mae": 0.02, "out_max": 1.5},
}


@pytest.fixture
def reinhard_cell(monkeypatch):
    """A Reinhard cell on the CPU whose reference is the oracle's Reinhard as
    a ``"call"`` module, put in place of the files' lookup."""
    reference = _reinhard_reference(_oracle(), "call")
    load = spec.load_module

    def load_module(kind, name, here=spec.HERE):
        if (kind, name) == ("reference", "reinhard-call"):
            return reference
        return load(kind, name, here)

    monkeypatch.setattr(spec, "load_module", load_module)
    traffic = {"driver": "closed_loop", "batch": 32, "pool_batches": 2, "in_flight": 2,
               "check_batches": 1, "check_rows": 32}
    return spec.Cell("reinhard-u8-32.store", 1, json.loads(json.dumps(REINHARD_CELL)), traffic)


def test_a_sound_run_of_a_call_reference_cell_is_correct(reinhard_cell):
    result = harness.run_cell(reinhard_cell, 2**32 + 17, 0.3, False, CPU, time.perf_counter())
    assert result["correct"] is True and result["attempted"] > 0, result["checks"]


def test_the_bf16_control_of_a_call_reference_cell_is_not_correct(reinhard_cell):
    readings = control.readings(reinhard_cell, 2**33 + 1, 0.3, CPU)
    assert readings["correct"] is False
    limits = reinhard_cell.config["limits"]
    assert sum(readings["found"][k] > v for k, v in limits.items()) >= 2


@pytest.mark.parametrize("fault", [f for f in sorted(faults.FAULTS) if faults.applies(
    f, spec.Cell("reinhard-u8-32.store", 1, REINHARD_CELL, {}))])
def test_a_fault_in_a_call_reference_cell_is_not_correct(reinhard_cell, fault):
    result = harness.run_cell(reinhard_cell, 2**32 + 17, 0.3, False, CPU, time.perf_counter(),
                              faults.FAULTS[fault])
    assert result["correct"] is False, result["checks"]


def _gaps_in_blocks(items, reference, full_scale):
    """The check's output comparison as it stood before references stated
    ``STATISTICS``: every reference transformed ``BLOCK_ROWS`` rows at a time."""
    found = {}
    total, count, worst = 0.0, 0, 0.0
    for item in items:
        ref_state = reference.fit(item.fit_input)
        for name, value in reference.state_gaps(item.program_state, ref_state).items():
            found[name] = max(found.get(name, 0.0), value) if math.isfinite(value) else math.nan
        rows_input = item.call_input[item.rows]
        for lo in range(0, len(rows_input), check.BLOCK_ROWS):
            ref = reference.transform(rows_input[lo:lo + check.BLOCK_ROWS], ref_state)
            prog = item.program_rows[lo:lo + check.BLOCK_ROWS].astype(np.float64)
            prog = prog * (255.0 / full_scale)
            diff = np.abs(prog - ref.astype(np.float64))
            total += float(diff.sum())
            count += diff.size
            worst = max(worst, float(diff.max())) if np.isfinite(diff).all() else math.nan
    found["out_max"] = worst
    found["out_mae"] = total / count if count else math.nan
    return found


@pytest.mark.parametrize("kind,check_rows", [(k, r) for k in sorted(CELLS) for r in (40, 21)])
def test_macenko_gaps_are_the_16_row_computation_to_the_bit(kind, check_rows):
    """An ``"image"`` reference's numbers are those of the 16-row blocks,
    bit for bit, over calls of more than two blocks."""
    cell = small_cell(kind)
    cell.traffic.update(batch=40, check_rows=check_rows)
    job, driver, st, streams = harness.setup(cell, 2**32 + 3, 0.2, CPU)
    driver.warm(job, st)
    driver.run(job, st, 0.2, harness.trace.NoTrace())
    items = driver.check_items(job, st, streams["check"])
    full_scale = cell.config.get("out_full_scale", 255.0)
    found = check.gaps(items, REF, full_scale)
    assert REF.STATISTICS == "image" and found == _gaps_in_blocks(items, REF, full_scale)
    assert len(items[0].rows) == check_rows
