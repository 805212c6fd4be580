"""The port's distributed layer on ``("batch", "pixel")`` meshes against
``stainx_tpu.parallel`` on virtual CPU devices: a (1, 2) mesh of 2 ranks
(suite "pixel") and a (2, 2) mesh of 4 (suite "mesh4").

Each suite is one ``gloo`` group that runs every case of
``tests/torch_parallel_cases.py`` while this process computes the JAX
results on the same seeded inputs; each case is its own test. The
counterparts of ``tests/test_parallel.py``'s pixel-sharded, 2D-mesh and
pre-sharded classes: pixel-sharded Macenko transforms (one image, uint8,
float32, ``precision="fast"``, the background-tile fallback decided on the
global count, a padded image with its ``valid`` mask), odd H for every
method, pixel-sharded fits with and without odd H and uneven N, the batch
and pixel axes together, randomized compositions, the batch-only wrappers
on a 2D mesh, ``macenko_fit_sharded`` over both axes, the validation
errors, and ``DTensor`` inputs (the local shard used as it is, the same
bits as the plain input; a ``DTensor`` of another mesh brought onto the
call's). The (2, 2, 1) and (1, 2, 2) ``("batch", "pixel", "model")``
meshes run the three pixel-sharded fits and transforms (the statistics
reduce over the batch and pixel axes only), and ``make_mesh`` builds
("batch",) meshes of the first two of four ranks, by ``devices`` and by
shape (the ranks outside get ``ValueError``). Every rank's result, and a second run of each
case, must be the same bits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from stainx_tpu import parallel as jp
from stainx_tpu.parallel.distributed import macenko_transform_sharded
from tests import torch_parallel_cases as cases

METHODS = ("macenko", "reinhard", "histogram_matching")


def _params(method, images):
    p = cases.oracle_params(method, images)
    return tuple(jnp.asarray(a) for a in p) if isinstance(p, tuple) else jnp.asarray(p)




def _tr(method, x, params, mesh, **kw):
    return {"out": np.asarray(jp.transform_on_mesh(method, x, params, mesh, **kw))}


def _pixel_refs(mesh):
    he = cases.he_batch()
    tr = functools.partial(_tr, mesh=mesh, pixel_axis="pixel")
    refs = {
        "macenko_single_image": (lambda: tr("macenko", he[:1], _params("macenko", he[1:2])),
                                 None, None),
        "macenko_fast": (lambda: tr("macenko", he[:2], _params("macenko", he[2:3]),
                                    precision="fast"), None, None),
        "macenko_float32": (lambda: tr("macenko", he[:2].astype(np.float32) / 255.0,
                                       _params("macenko", he[2:3])), None, None),
        "background_fallback": (lambda: tr(
            "macenko", np.full((1, 3, 32, 32), 250, np.uint8),
            tuple(jnp.asarray(a) for a in cases.BACKGROUND_PARAMS)), None, None),
    }
    for m in METHODS:
        refs[f"odd_h_{m}"] = (lambda m=m: tr(m, he[:2, :, :31], _params(m, he[2:3])), m, None)
        refs[f"fit_{m}"] = (lambda m=m: cases.fit_out(jp.fit_on_mesh(m, he, mesh, pixel_axis="pixel")), m,
                            None)
        refs[f"fit_odd_h_{m}"] = (lambda m=m: cases.fit_out(
            jp.fit_on_mesh(m, he[:, :, :31], mesh, pixel_axis="pixel")), m, None)

    def valid_mask():
        padded = np.concatenate([he[:1], np.zeros((1, 3, 2, 32), np.uint8)], axis=2)
        valid = (np.arange(34) < 32)[None, :, None] & np.ones((1, 34, 32), bool)
        he_p, mc_p = _params("macenko", he[1:2])
        spec, vspec = P(None, None, "pixel"), P(None, "pixel")
        run = jax.jit(jax.shard_map(
            lambda im, v: macenko_transform_sharded(im, he_p, mc_p, "pixel", valid=v),
            mesh=mesh, in_specs=(spec, vspec), out_specs=spec, check_vma=False))
        out = run(jax.device_put(jnp.asarray(padded), NamedSharding(mesh, spec)),
                  jax.device_put(jnp.asarray(valid), NamedSharding(mesh, vspec)))
        return {"out": np.asarray(out)[:, :, :32]}

    refs["valid_mask"] = (valid_mask, None, None)
    return refs


def _mesh4_refs(mesh):
    he = cases.he_batch()
    tr = functools.partial(_tr, mesh=mesh, pixel_axis="pixel")
    refs = {}
    for m in METHODS:
        refs[f"transform_pixel_{m}"] = (lambda m=m: tr(m, he, _params(m, he[:1])), m, None)
        refs[f"fit_odd_h_{m}"] = (lambda m=m: cases.fit_out(
            jp.fit_on_mesh(m, he[:, :, :31], mesh, pixel_axis="pixel")), m, None)
        refs[f"batch_only_fit_{m}"] = (lambda m=m: cases.fit_out(jp.fit_on_mesh(m, he, mesh)), m, None)

        def presharded(m=m):
            pre = jax.device_put(jnp.asarray(he), NamedSharding(mesh, P("batch", None, "pixel")))
            return {**cases.fit_out(jp.fit_on_mesh(m, pre, mesh, pixel_axis="pixel")),
                    **tr(m, pre, _params(m, he[:1]))}

        refs[f"presharded_{m}"] = (presharded, m, None)
    refs["fit_pixel_macenko"] = (lambda: cases.fit_out(
        jp.fit_on_mesh("macenko", he, mesh, pixel_axis="pixel")), "macenko", None)
    refs["fit_odd_h_uneven_reinhard"] = (lambda: cases.fit_out(
        jp.fit_on_mesh("reinhard", he[:3, :, :31], mesh, pixel_axis="pixel")), "reinhard", None)
    refs["uneven_pixel_reinhard"] = (lambda: tr("reinhard", he[:3], _params("reinhard", he[:1])),
                                     None, None)
    refs["odd_h_uneven_reinhard"] = (lambda: tr("reinhard", he[:3, :, :31],
                                                _params("reinhard", he[3:4])), None, None)
    refs["batch_only_transform_reinhard"] = (lambda: _tr(
        "reinhard", he, _params("reinhard", he[:1]), mesh), None, None)
    for seed in range(6):
        def composition(seed=seed):
            method, batch, ref = cases.random_composition(seed)
            return tr(method, batch, _params(method, ref))

        refs[f"random_{seed}"] = (composition, None, None)
    bad = (jnp.zeros((3, 2)), jnp.ones(2))
    refs["error_pixel_axis_missing"] = (lambda: cases.error_of(
        lambda: jp.transform_on_mesh("macenko", he, bad, mesh, pixel_axis="nope")), None,
        "not an axis of the mesh")
    refs["error_pixel_axis_is_batch"] = (lambda: cases.error_of(
        lambda: jp.transform_on_mesh("macenko", he, bad, mesh, pixel_axis="batch")), None,
        "must differ from batch_axis")
    # Port only: JAX pads a host array itself; a DTensor must divide the axes.
    refs["error_dtensor_uneven"] = (lambda: {}, None, "divisible")

    def fit_sharded_2d():
        spec = P("batch", None, "pixel")
        run = jax.jit(jax.shard_map(
            functools.partial(jp.macenko_fit_sharded, axis_name=("batch", "pixel")),
            mesh=mesh, in_specs=spec, out_specs=P(), check_vma=False))
        return cases.fit_out(run(jax.device_put(jnp.asarray(he), NamedSharding(mesh, spec))))

    refs["fit_sharded_2d"] = (fit_sharded_2d, "macenko", None)
    refs["presharded_no_copy"] = (lambda: {}, None, None)

    axes3 = ("batch", "pixel", "model")
    devices = jax.devices()[:4]
    m3 = {name: jp.make_mesh(shape=shape, axis_names=axes3, devices=devices)
          for name, shape in (("221", (2, 2, 1)), ("122", (1, 2, 2)))}
    for name, m in m3.items():
        for method in METHODS:
            refs[f"mesh3d_{name}_fit_{method}"] = (lambda method=method, m=m: cases.fit_out(
                jp.fit_on_mesh(method, he, m, pixel_axis="pixel")), method, None)
            refs[f"mesh3d_{name}_transform_{method}"] = (lambda method=method, m=m: _tr(
                method, he, _params(method, he[:1]), m, pixel_axis="pixel"), None, None)
    refs["mesh3d_221_odd_h_uneven_reinhard"] = (lambda: _tr(
        "reinhard", he[:3, :, :31], _params("reinhard", he[3:4]), m3["221"], pixel_axis="pixel"),
        None, None)
    refs["mesh3d_122_batch_only_fit_reinhard"] = (lambda: cases.fit_out(
        jp.fit_on_mesh("reinhard", he, m3["122"])), "reinhard", None)

    def fit_sharded_3d():
        spec = P("batch", None, "pixel")
        run = jax.jit(jax.shard_map(
            functools.partial(jp.macenko_fit_sharded, axis_name=("batch", "pixel")),
            mesh=m3["122"], in_specs=spec, out_specs=P(), check_vma=False))
        return cases.fit_out(run(jax.device_put(jnp.asarray(he), NamedSharding(m3["122"], spec))))

    refs["mesh3d_122_fit_sharded"] = (fit_sharded_3d, "macenko", None)
    # JAX's make_mesh takes the first devices: two of them, by list and by shape.
    first2 = jp.make_mesh(shape=None, axis_names=("batch",), devices=devices[:2])
    refs["submesh_devices_fit_reinhard"] = (lambda: cases.fit_out(
        jp.fit_on_mesh("reinhard", he, first2)), "reinhard", None)
    refs["submesh_devices_transform_macenko"] = (lambda: _tr(
        "macenko", he, _params("macenko", he[:1]), first2), None, None)
    refs["submesh_shape_fit_histogram_matching"] = (lambda: cases.fit_out(jp.fit_on_mesh(
        "histogram_matching", he, jp.make_mesh(shape=(2,), axis_names=("batch",),
                                               devices=devices))), "histogram_matching", None)
    for m in METHODS:
        # The port's batch lives on the (2, 2, 1) mesh; JAX's is the host array.
        refs[f"dtensor_other_mesh_{m}"] = (lambda m=m: {
            **cases.fit_out(jp.fit_on_mesh(m, he, mesh, pixel_axis="pixel")),
            **tr(m, he, _params(m, he[:1]))}, m, None)
    return refs


SUITES = {
    "pixel": ((1, 2), _pixel_refs),
    "mesh4": ((2, 2), _mesh4_refs),
}
PARAMS = [(s, n) for s in SUITES for n in cases.suite_case_names(s)]


@pytest.fixture(scope="module")
def suites(tmp_path_factory):
    """Start both groups, compute the JAX side meanwhile, return both."""
    groups = {s: cases.Group(s, tmp_path_factory.mktemp(s)) for s in SUITES}
    refs = {}
    for s, (shape, build) in SUITES.items():
        n = shape[0] * shape[1]
        mesh = jp.make_mesh(shape=shape, axis_names=("batch", "pixel"), devices=jax.devices()[:n])
        for name, (fn, fit, error) in build(mesh).items():
            try:
                refs[s, name] = (fn(), fit, error)
            except Exception as exc:  # reported by the case's own test
                refs[s, name] = (exc, fit, error)
    return groups, refs


@pytest.mark.parametrize("suite", list(SUITES))
def test_every_case_has_a_jax_side(suites, suite):
    assert sorted(n for s, n in suites[1] if s == suite) == sorted(cases.suite_case_names(suite))


@pytest.mark.parametrize("suite,name", PARAMS)
def test_case(suites, suite, name):
    groups, refs = suites
    want, fit, error = refs[suite, name]
    if isinstance(want, Exception):
        raise want
    cases.check(groups[suite].case(name), want, fit=fit, error=error)
