"""The benchmark's plain PyTorch Reinhard (``portbench/reference/reinhard.py``)
against the numpy oracle, the port against it through the check that
decides a Reinhard cell's ``correct``, its bfloat16 control, and the
``stainx.stats`` span of the port's Reinhard transform.

The reference is loaded by its path, as the benchmark loads it, and so is
the oracle, so that the file runs on a card's machine, where JAX is absent
(``pytest --noconftest``) and an installed ``tests`` package may shadow
this one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, control, gen
from stainx_tpu_torch import Reinhard, profiling

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "portbench/configs/reinhard-u8-512.json").read_text())
LIMITS = CONFIG["limits"]


def _load(name: str, path: str):
    spec_ = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


REF = _load("portbench_test_reinhard_reference", "portbench/reference/reinhard.py")
oracle = _load("reinhard_reference_test_oracle", "tests/oracles/numpy_reference.py")


def _tiles(n: int, size: int, seed: int) -> torch.Tensor:
    """``n`` seeded 3 x size x size uint8 tiles of the benchmark's kind."""
    g = gen.torch_generator(np.random.SeedSequence(seed), torch.device("cpu"))
    return gen.tiles(n, (3, size, size), "uint8", (0.85, 1.15), g)


def _port_item(n: int = 16, size: int = 64, seed: int = 2**32 + 5) -> check.Item:
    """One call of the port's plain path on ``n`` tiles after a fit on one
    more, every row checked."""
    ref, batch = _tiles(1, size, seed), _tiles(n, size, seed + 1)
    system = Reinhard(device="cpu").fit(ref)
    out = system.transform(batch).numpy()
    state = {k: v.cpu().numpy() for k, v in system.state.items()}
    return check.Item(ref.numpy(), state, batch.numpy(), np.arange(n), out)


def test_the_reference_states_its_interface():
    assert REF.STATISTICS == "call"
    assert set(REF.OPS_PER_PIXEL) == {"fit", "transform", "float_input", "unit_output"}
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_the_reference_is_the_numpy_oracle(dtype):
    """Statistics within 1e-6 (relative) and outputs within one grey level
    of the oracle's, on seeded tiles of the benchmark's kind, over more
    images than a block holds."""
    images = _tiles(2 * REF.BLOCK_ROWS + 3, 40, 7).numpy()
    if dtype == "float32":
        images = images.astype(np.float32) / 255.0
    state = REF.fit(images[:2])
    mean, std = oracle.reinhard_fit(images[:2])
    gaps = REF.state_gaps({"_reference_mean": mean, "_reference_std": std}, state)
    assert gaps["stat_gap"] <= 1e-6, gaps
    got = REF.transform(images[2:], state)
    want = oracle.reinhard_transform(images[2:], state["_reference_mean"],
                                     state["_reference_std"])
    assert got.dtype == want.dtype == images.dtype and got.shape == want.shape
    scale = 1.0 if dtype == "uint8" else 255.0
    assert np.abs(got.astype(np.float64) - want.astype(np.float64)).max() * scale <= 1.0


def test_bf16_rounds_to_nearest_even():
    x = torch.tensor([1.0, 1.0 + 2**-8, 1.0 + 3 * 2**-8, 1.0 + 2**-9, -3.14159, 0.0])
    r = REF.bf16(x)
    assert r.dtype == torch.float32
    assert r.tolist() == [1.0, 1.0, 1.0 + 4 * 2**-8, 1.0, -3.140625, 0.0]
    assert torch.equal(REF.bf16(r), r)


def test_the_port_is_within_the_configurations_limits():
    """The port's plain path at 16x3x64^2 uint8 against the reference
    through the check: every limit of ``reinhard-u8-512`` holds."""
    found = check.gaps([_port_item()], REF, 255.0)
    ok, checks = check.judge(found, LIMITS)
    assert ok, checks


def test_the_bf16_control_breaks_at_least_two_limits():
    item = _port_item()
    [ctrl] = control.control_items([item], REF, 255.0)
    found = check.gaps([ctrl], REF, 255.0)
    assert not check.judge(found, LIMITS)[0]
    assert sum(found[k] > v for k, v in LIMITS.items()) >= 2, found


def test_statistics_are_those_of_the_whole_call():
    """Why the reference states ``"call"``: transformed whole, the call
    agrees with the port; in 16-row blocks, each block takes its own
    statistics and the outputs move by far more than the limit."""
    item = _port_item(n=32)
    state = REF.fit(item.fit_input)
    whole = REF.transform(item.call_input, state).astype(np.float64)
    blocks = np.concatenate([REF.transform(item.call_input[lo:lo + check.BLOCK_ROWS], state)
                             for lo in range(0, 32, check.BLOCK_ROWS)]).astype(np.float64)
    prog = item.program_rows.astype(np.float64)
    assert np.abs(prog - whole).max() <= LIMITS["out_max"]
    assert np.abs(prog - whole).mean() <= LIMITS["out_mae"]
    assert np.abs(prog - blocks).mean() > 10 * LIMITS["out_mae"]


def test_caller_timed_is_a_no_op_off_a_session_and_a_span_in_one():
    """Off a session one shared no-op that enters as None; inside one, a
    span with its parent, which on a CPU device enters as None too."""
    with profiling.annotate("stainx.test.off"):
        pass
    a, b = profiling.caller_timed("stainx.a", "cpu"), profiling.caller_timed("stainx.b", None)
    assert a is b
    with a as events:
        assert events is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("stainx.test.outer"):
            with profiling.caller_timed("stainx.test.inner", "cpu") as events:
                assert events is None
    spans = profiling.session().spans
    assert [s.name for s in spans] == ["stainx.test.outer", "stainx.test.inner"]
    assert spans[1].parent == 0 and spans[1].device_ms is None and spans[1].end_ns > 0


@pytest.mark.cuda
def test_the_stats_span_on_the_card():
    """On the card: a profiled and an unprofiled transform give equal bits
    and equal launch counts, and each profiled call holds one ``stainx.stats``
    span, a child of ``stainx.kernel.B7``, with a device interval."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the span's events are recorded by the C call")
    dev = torch.device("cuda", 0)
    system = Reinhard(device=dev).fit(_tiles(1, 512, 3).to(dev))
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
    assert plain_launches == {"launch.B7b": 1, "launch.B7a": 1}
    assert profiled_launches == {k: 3 * v for k, v in plain_launches.items()}
    assert all(torch.equal(out, plain) for out in profiled)
    sess = profiling.session()
    assert len(sess.roots()) == 3
    stats = [s for s in sess.spans if s.name == "stainx.stats"]
    assert len(stats) == 3 and len({s.call for s in stats}) == 3
    for s in stats:
        assert sess.spans[s.parent].name == "stainx.kernel.B7"
        assert s.device_ms is not None and 0 < s.device_ms
        whole = sess.spans[s.call]
        assert whole.name == "stainx.transform" and s.device_ms < whole.device_ms
