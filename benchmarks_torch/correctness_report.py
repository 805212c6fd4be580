"""The port's correctness report: every method against the numpy oracle over
the size matrix, each deviation beside its gate.

The counterpart of ``benchmarks/correctness_report.py``, with the same
cells (``--sizes`` squares, ``--dtypes``, and with ``--non-square`` the
reference's 321×199 probe), the same seeds and the same rows
``(algorithm, case, metric, measured, gate)``: Reinhard and histogram
matching on seeded noise, max|diff| ≤ 1 grey level (1/255 for float
input); Macenko on synthetic H&E tiles, MAE ≤ 0.35 and the stain matrix's
max|diff| ≤ 5e-3. On the card the Macenko rows run the one-block kernels
(B2, B1) or the multi-block ones (B5, B4), as the route ladder gives each
size. Exits 1 if any gate fails.

    python -m benchmarks_torch.correctness_report [--sizes 64 128 256] \\
        [--dtypes uint8 float32] [--non-square] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from benchmarks_torch import utils
from stainx_tpu_torch import HistogramMatching, Macenko, Reinhard
from stainx_tpu_torch.utils import get_device


def case_rows(oracle, device, rng, h, w, as_float):
    """One (H, W, dtype) cell: all three algorithms against the oracle, on
    ``device``. The port's copy of the JAX report's ``_case_rows``: the same
    draws from ``rng``, inputs, rows and gates."""
    # Reinhard / HM on seeded noise; Macenko on synthetic Beer–Lambert H&E
    # (its stain plane must be well posed).
    ref_n = rng.integers(0, 256, (1, 3, h, w), dtype=np.uint8)
    src_n = rng.integers(0, 256, (2, 3, h, w), dtype=np.uint8)
    ref_he = oracle.synthetic_he_tile(h, w, seed=42)
    src_he = oracle.synthetic_he_tile(h, w, seed=123, he_scale=1.15)
    if as_float:
        ref_n, src_n = ref_n.astype(np.float32) / 255.0, src_n.astype(np.float32) / 255.0
        ref_he, src_he = ref_he.astype(np.float32) / 255.0, src_he.astype(np.float32) / 255.0
    # Reinhard and HM keep the input's range, so one grey level is 1/255 for
    # float input; Macenko's output is [0, 255]-valued for both dtypes.
    grey = 1.0 / 255.0 if as_float else 1.0
    label = f"{h}x{w}{'f' if as_float else 'u'}"
    rows = []

    r = utils.to_numpy(Reinhard(device=device).fit(ref_n).transform(src_n)).astype(np.float32)
    r_o = oracle.reinhard_transform(src_n, *oracle.reinhard_fit(ref_n)).astype(np.float32)
    rows.append(("reinhard", label, "max|diff|", float(np.abs(r - r_o).max()), grey))

    hm = HistogramMatching(device=device).fit(ref_n).transform(src_n)
    hh = utils.to_numpy(hm).astype(np.float32)
    h_o = oracle.hm_transform(src_n, oracle.hm_fit(ref_n)).astype(np.float32)
    rows.append(("hist_match", label, "max|diff|", float(np.abs(hh - h_o).max()), grey))

    m = Macenko(device=device)
    out = utils.to_numpy(m.fit(ref_he).transform(src_he)).astype(np.float32)
    he_o, mc_o = oracle.macenko_fit(ref_he)
    m_o = oracle.macenko_transform(src_he, he_o, mc_o).astype(np.float32)
    rows.append(("macenko", label, "MAE", float(np.abs(out - m_o).mean()), 0.35))
    he_err = float(np.abs(utils.to_numpy(m._stain_matrix) - he_o).max())
    rows.append(("macenko", label, "HE max|diff|", he_err, 5e-3))
    return rows


def failures(rows) -> int:
    """The rows whose measured deviation is above its gate (or not a number)."""
    return sum(not value <= gate for _, _, _, value, gate in rows)


def main(argv=None) -> list[tuple]:
    """Print the report; returns its rows."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", nargs="+", type=int, default=[64, 128, 256])
    p.add_argument("--dtypes", nargs="+", choices=["uint8", "float32"], default=["uint8"])
    p.add_argument("--non-square", action="store_true", help="add the reference's 321x199 probe")
    p.add_argument("--json", action="store_true", help="one JSON line a row")
    utils.add_device_argument(p)
    args = p.parse_args(argv)
    dev = get_device(args.device)
    print(utils.card_stamp(dev), flush=True)

    oracle = utils.load_oracle()
    rng = np.random.default_rng(42)
    cells = [(s, s) for s in args.sizes] + ([(321, 199)] if args.non_square else [])
    rows = []
    for h, w in cells:
        for dt in args.dtypes:
            rows += case_rows(oracle, dev, rng, h, w, dt == "float32")

    if not args.json:
        print(f"{'algorithm':<12} {'case':>10} {'metric':<14} {'measured':>12} {'gate':>10}")
    for algo, label, metric, value, limit in rows:
        ok = value <= limit
        if args.json:
            print(json.dumps({"algorithm": algo, "case": label, "metric": metric,
                              "measured": value, "gate": limit, "ok": ok,
                              "device": utils.device_name(dev)}))
        else:
            print(f"{algo:<12} {label:>10} {metric:<14} {value:>12.6f} ≤ {limit:<8g}"
                  f"{'' if ok else '  FAIL'}")
    return rows


if __name__ == "__main__":
    sys.exit(1 if failures(main()) else 0)
