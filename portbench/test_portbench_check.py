"""The comparison that decides ``correct``: the reference, its control, and
the faults a cell can have, at sizes a test run holds (the program's plain
PyTorch path on the CPU)."""

from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, control, faults, harness, spec

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
