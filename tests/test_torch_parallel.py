"""The port's distributed layer on a 2-rank ``("batch",)`` mesh against
``stainx_tpu.parallel`` on 2 virtual CPU devices.

One ``gloo`` group runs every case of the suite (``tests/
torch_parallel_cases.py``, suite "batch") while this process computes the
JAX results on the same seeded inputs; each case is its own test. The
counterparts of ``tests/test_parallel.py``'s classes: the percentile on its
adversarial fields (bit for bit against JAX, and against the port's
single-device ``kth_smallest``, or numpy's sort where the field holds
±inf, which ``kth_smallest`` leaves out), the sharded fits and transforms,
uneven N, a single image, tensor masks given straight to the ``*_sharded``
functions, the error for a missing axis, and the process group a mesh axis
reuses. Every rank's result, and a second run of each case, must be the
same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from stainx_tpu import parallel as jp
from stainx_tpu.ops.percentile import static_nearest_rank_index
from stainx_tpu_torch.ops.percentile import kth_smallest
from tests import torch_parallel_cases as cases

SUITE = "batch"
NAMES = cases.suite_case_names(SUITE)


def _params(method, images):
    p = cases.oracle_params(method, images)
    return tuple(jnp.asarray(a) for a in p) if isinstance(p, tuple) else jnp.asarray(p)



def _jax_percentile(name, mesh):
    x, mask, q = cases.percentile_field(name)
    spec = P(*([None] * (x.ndim - 1)), "batch")
    if mask is None:
        fn = lambda xs: jp.distributed_masked_percentile(xs, None, q, "batch")  # noqa: E731
        args, specs = (jnp.asarray(x),), (spec,)
    else:
        fn = lambda xs, ms: jp.distributed_masked_percentile(xs, ms, q, "batch")  # noqa: E731
        args, specs = (jnp.asarray(x), jnp.asarray(mask)), (spec, spec)
    run = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=specs, out_specs=P(), check_vma=False))
    return {"pct": np.asarray(run(*args))}


def _single_device(name):
    """The same percentiles on one device: the port's ``kth_smallest`` on
    finite fields, numpy's sort on fields with ±inf; NaN for an empty row."""
    x, mask, q = cases.percentile_field(name)
    x2 = np.atleast_2d(x)
    m2 = np.ones_like(x2, bool) if mask is None else np.atleast_2d(mask)
    nested = isinstance(q, tuple) and isinstance(q[0], tuple)
    rows = q if nested else tuple((v,) for v in (q if isinstance(q, tuple) else (q,)))
    out = np.full((len(rows), len(rows[0])), np.nan, np.float32)
    for i, row in enumerate(rows):
        cnt = int(m2[i].sum())
        if cnt == 0:
            continue
        ranks = [static_nearest_rank_index(v, cnt) for v in row]
        if np.isfinite(x2[i]).all():
            got = kth_smallest(torch.as_tensor(x2[i : i + 1]), torch.as_tensor([ranks]),
                               torch.as_tensor(m2[i : i + 1]))
            out[i] = got.numpy()[0]
        else:
            out[i] = np.sort(x2[i][m2[i]])[ranks]
    if nested:
        return out[0] if x.ndim == 1 else out
    return out[0, 0] if x.ndim == 1 else out[:, 0]


def _jax_cases(mesh):
    he = cases.he_batch()
    refs = {}
    for name in cases.PERCENTILE_CASES:
        refs[f"percentile_{name}"] = (lambda name=name: _jax_percentile(name, mesh), None, None)
    for m in ("reinhard", "histogram_matching", "macenko"):
        refs[f"fit_{m}"] = (lambda m=m: cases.fit_out(jp.fit_on_mesh(m, he, mesh)), m, None)
        refs[f"transform_{m}"] = (lambda m=m: {"out": np.asarray(
            jp.transform_on_mesh(m, he, _params(m, he[:1]), mesh))}, m, None)
        refs[f"uneven_fit_{m}"] = (lambda m=m: cases.fit_out(jp.fit_on_mesh(m, he[:5], mesh)), m, None)
        refs[f"uneven_transform_{m}"] = (lambda m=m: {"out": np.asarray(
            jp.transform_on_mesh(m, he[:5], _params(m, he[:1]), mesh))}, m, None)
        # The tensor masks keep he[:5, :, :31]: JAX's fit of exactly that.
        refs[f"masks_fit_{m}"] = (lambda m=m: cases.fit_out(jp.fit_on_mesh(m, he[:5, :, :31], mesh)), m,
                                  None)
    for m in ("reinhard", "histogram_matching"):
        refs[f"masks_transform_{m}"] = (lambda m=m: {"out": np.asarray(
            jp.transform_on_mesh(m, he[:5, :, :31], _params(m, he[:1]), mesh))}, m, None)
    refs["single_image"] = (lambda: {
        "out": np.asarray(jp.transform_on_mesh("reinhard", he[:1], _params("reinhard", he[1:2]),
                                               mesh)),
        **cases.fit_out(jp.fit_on_mesh("reinhard", he[:1], mesh)),
    }, "reinhard", None)
    refs["bad_batch_axis"] = (lambda: cases.error_of(
        lambda: jp.fit_on_mesh("reinhard", he, mesh, batch_axis="nope")), None,
        "not an axis of the mesh")
    refs["group_reused"] = (lambda: {}, None, None)
    return refs



@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """Start the group, compute the JAX side meanwhile, return both."""
    group = cases.Group(SUITE, tmp_path_factory.mktemp(SUITE))
    mesh = jp.make_mesh(shape=(2,), axis_names=("batch",), devices=jax.devices()[:2])
    refs = {}
    for name, (fn, fit, error) in _jax_cases(mesh).items():
        try:
            refs[name] = (fn(), fit, error)
        except Exception as exc:  # reported by the case's own test
            refs[name] = (exc, fit, error)
    return group, refs


def test_every_case_has_a_jax_side(suite):
    assert sorted(suite[1]) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_case(suite, name):
    group, refs = suite
    want, fit, error = refs[name]
    if isinstance(want, Exception):
        raise want
    got = group.case(name)
    cases.check(got, want, fit=fit, error=error)
    if name.startswith("percentile_"):
        single = _single_device(name[len("percentile_"):])
        assert np.array_equal(got["pct"], single, equal_nan=True), (got["pct"], single)
