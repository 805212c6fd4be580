"""One run of one cell: set-up, the measured window, the check, the result.

The system under test is the port, ``stainx_tpu_torch``, built as the
configuration says (``system``: a class of the package and its keyword
arguments; ``call``: the entry the window drives; ``fit``: ``reference``,
a fit at set-up on one tile made from the seed, or ``per_batch``, where the
entry fits every batch itself, on its image ``fit_index`` or, where that is
null, on all of its pixels). The benchmark takes from the program only
its outputs, its fitted state (``.state``) and, in the traced run, its
kernels' names and times.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time

import torch

from portbench import check, counts, gen, guard, spec, trace
from portbench.records import Run

# The traced stretch: where it opens in the window, and its length.
STRETCH_AT = 0.25
STRETCH_MAX_S = 2.0


class Job:
    """The port, set up as a configuration states, on one device."""

    def __init__(self, config: dict, device: torch.device):
        import stainx_tpu_torch

        self.config, self.device = config, device
        system = config["system"]
        self.system = getattr(stainx_tpu_torch, system["class"])(device=device, **system["kwargs"])
        self.call = getattr(self.system, config["call"])
        self.span = "api.forward" if config["call"] == "__call__" else f"api.{config['call']}"
        self.fits_per_batch = config["fit"] == "per_batch"
        self.fit_input = self.fit_state = None

    def fit_rows(self, batch):
        """The part of a batch that a per-batch fit reads."""
        idx = self.config.get("fit_index")
        return batch if idx is None else batch[idx:idx + 1]

    def state(self) -> dict:
        return getattr(self.system, "normalizer", self.system).state

    def fit_reference(self, stream) -> None:
        """Fit once on one tile made from the seed, and keep it and the
        program's state for the check."""
        c = self.config
        ref = gen.tiles(1, c["tile"], c["dtype"], c["stain_scale"],
                        gen.torch_generator(stream, self.device))
        self.system.fit(ref)
        self.fit_input = ref.cpu().numpy()
        self.fit_state = {k: v.detach().cpu().numpy() for k, v in self.state().items()}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def events(self, count: int) -> list:
        if self.device.type != "cuda":
            return []
        return [torch.cuda.Event() for _ in range(count)]


def streams_of(seed: int) -> dict:
    return dict(zip(("inputs", "traffic", "check", "fit"), gen.seed_streams(seed, 4)))


def setup(cell: spec.Cell, seed: int, seconds: float, device: torch.device):
    """The job, its driver and the driver's state: inputs made, the
    reference fit done; nothing warmed."""
    streams = streams_of(seed)
    job = Job(cell.config, device)
    if cell.config["fit"] == "reference":
        job.fit_reference(streams["fit"])
    driver = spec.load_module("drivers", cell.traffic["driver"])
    return job, driver, driver.prepare(job, cell, streams, seconds), streams


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: torch.device,
             started: float, patch=None) -> dict:
    """One run; returns the result line's object. ``patch(job)``, given,
    breaks the timed path after set-up (the tests' faults)."""
    import stainx_tpu_torch.kernels

    marks = {"port_import_s": time.perf_counter() - started}
    if device.type == "cuda":
        stainx_tpu_torch.kernels.build_all()
    marks["import_build_s"] = time.perf_counter() - started
    job, driver, st, streams = setup(cell, seed, seconds, device)
    job.sync()
    marks["inputs_fit_s"] = time.perf_counter() - started
    driver.warm(job, st)
    job.sync()
    marks["warm_s"] = time.perf_counter() - started
    if traced and device.type == "cuda":
        tracer = trace.Stretch(seconds * STRETCH_AT, min(STRETCH_MAX_S, seconds / 2), job.sync)
        tracer.prime(lambda: driver.warm(job, st))
    else:
        tracer = trace.NoTrace()
    if patch is not None:
        patch(job)
    job.sync()
    # What set-up made lives for the whole run, as in a long-lived process:
    # out of the collector's sight, a collection in the window scans only the
    # window's own objects.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - started

    window = driver.run(job, st, seconds, tracer)
    if traced and tracer.record is None:
        raise SystemExit("the traced stretch recorded no device kernel for its calls: "
                         "no per-layer metric can be read")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    reference = spec.load_module("reference", cell.config["reference"])
    items = driver.check_items(job, st, streams["check"])
    del st, job
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    found = check.gaps(items, reference, cell.config.get("out_full_scale", 255.0))
    check_s = time.perf_counter() - t_check
    ok, checks = check.judge(found, cell.config["limits"])

    run = Run(cell, setup_s, window, tracer.record,
              counts.call_cost(cell.config, cell.traffic.get("batch", 1), reference.OPS_PER_PIXEL))
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.load_module("metrics", m["name"]).read(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            print(f"metric {m['name']}: nothing to read in this run", file=sys.stderr)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and window.failed == 0), "attempted": window.calls,
              "failed": window.failed, "metrics": metrics, "device": dev}
    if tracer.record is not None:
        rec = tracer.record
        dev["busy_s"], dev["window_s"] = rec.busy_s, rec.stretch_s
        result["breakdown"] = {"device_ops": rec.device_ops, "idle_gaps": rec.idle_gaps}
    result["notes"] = {"setup_s": setup_s, **marks, "window_s": window.seconds, **window.notes,
                       "bound": run.cost.bound, "least_ms": run.cost.least_s * 1e3,
                       "check_s": check_s, **_gap_notes(found, checks)}
    if tracer.record is not None:
        rec = tracer.record
        result["notes"].update(traced_calls=rec.calls,
                               kernel_ms_per_call=rec.kernel_s / rec.calls * 1e3,
                               busy_ms_per_call=rec.busy_s / rec.calls * 1e3)
        # The traced run's own window, beside the untraced runs': what tracing costs.
        for m in cell.end_to_end:
            value = spec.load_module("metrics", m["name"]).read(run)
            if m["name"] != "setup_s" and value is not None:
                result["notes"][f"traced_{m['name']}"] = value
    result["checks"] = checks
    return result


def _gap_notes(found: dict, checks: dict) -> dict:
    """The numbers the check found but holds to no limit."""
    return {f"gap_{k}": v for k, v in found.items() if k not in checks}


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        query = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
        out = subprocess.run(query, capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError) as err:
        return f"unknown ({err.__class__.__name__})"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def _finite(obj):
    """JSON has no NaN or infinity: they are written as null."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    found = guard.forbidden()
    if found:
        raise SystemExit(f"modules of JAX or of the JAX package are loaded: {', '.join(found)}")
    for line in check.lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
