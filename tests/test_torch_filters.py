"""Port parity: clouds, voxel statistics, eigen-decomposition and the main-
path filters (mola_fe_lidar_tpu_torch.{cloud,ops.eigen3,filters}) against
the JAX reference, on the same numpy inputs (HDL-64 scans at reduced
azimuth, random clouds from a seeded generator)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.cloud import metric_map as jmm
from mola_fe_lidar_tpu.cloud import voxel as jvoxel
from mola_fe_lidar_tpu.filters import generators as jgen
from mola_fe_lidar_tpu.filters import pipeline as jpipe
from mola_fe_lidar_tpu.obs.hdl64 import hdl64_sequence
from mola_fe_lidar_tpu.ops import eigen3 as jeigen3
from mola_fe_lidar_tpu_torch.cloud import metric_map, voxel
from mola_fe_lidar_tpu_torch.filters import generators, pipeline
from mola_fe_lidar_tpu_torch.ops import eigen3

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scan():
    """One deskew-ready HDL-64 scan, 16384 rays (azimuth 256)."""
    obs, _ = hdl64_sequence(n_scans=2, n_azimuth=256)
    return obs[1]


def _raw(scan, capacity=16384):
    g = generators.GeneratorRawPoints(capacity=capacity, min_range=2.0, keep_time=True,
                                     device="cpu")
    gj = jgen.GeneratorRawPoints(capacity=capacity, min_range=2.0, keep_time=True)
    return g(scan)["raw"], gj(scan)["raw"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud_with_duplicates(rng, n=3000):
    xyz = (rng.standard_normal((n, 3)) * 8).astype(np.float32)
    xyz[n // 2:] = np.round(xyz[n // 2:])  # many points share cells
    mask = (rng.uniform(size=n) > 0.1).astype(np.float32)
    xyz[mask < 0.5] = 1e6
    return xyz, mask


def test_generator_and_range_gate_match(scan):
    raw, rawj = _raw(scan)
    np.testing.assert_array_equal(raw.mask.numpy(), np.asarray(rawj.mask))
    np.testing.assert_array_equal(raw.xyz.numpy(), np.asarray(rawj.xyz))
    np.testing.assert_array_equal(raw.attrs["time"].numpy(), np.asarray(rawj.attrs["time"]))


def test_voxel_sort_order_is_exactly_the_reference(rng):
    xyz, mask = _cloud_with_duplicates(rng)
    vs = voxel.lex_sort_by_voxel(_t(xyz), _t(mask), 1.0)
    vj = jvoxel.lex_sort_by_voxel(jnp.asarray(xyz), jnp.asarray(mask), 1.0)
    # exact: equal cells keep input order on both sides
    np.testing.assert_array_equal(vs.order.numpy(), np.asarray(vj.order))
    np.testing.assert_array_equal(vs.first.numpy(), np.asarray(vj.first))
    np.testing.assert_array_equal(vs.seg_id.numpy(), np.asarray(vj.seg_id))
    assert int(vs.num_voxels) == int(vj.num_voxels)


@pytest.mark.parametrize("shape", [(16, 3), (17, 4), (20000, 9)])
def test_prefix_sum_rounds_like_the_reference_cumsum(rng, shape):
    x = (rng.standard_normal(shape) * 50).astype(np.float32)
    # exact: same association of the f32 additions
    np.testing.assert_array_equal(voxel.prefix_sum(_t(x)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(x), axis=0)))


def test_voxel_stats_scan(scan):
    raw, _ = _raw(scan)
    xyz, mask = raw.xyz.numpy(), raw.mask.numpy()
    st = voxel.voxel_stats_scan(voxel.lex_sort_by_voxel(_t(xyz), _t(mask), 1.0))
    sj = jax.jit(lambda a, b: jvoxel.voxel_stats_scan(jvoxel.lex_sort_by_voxel(a, b, 1.0)))(
        jnp.asarray(xyz), jnp.asarray(mask))
    ok = np.asarray(sj.count) > 0.5
    np.testing.assert_array_equal(st.count.numpy(), np.asarray(sj.count))
    # the prefix sums agree bitwise; what remains is per-element f32
    # arithmetic that XLA may fuse differently: 1e-5 relative
    np.testing.assert_allclose(st.mean.numpy()[ok], np.asarray(sj.mean)[ok], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.cov.numpy()[ok], np.asarray(sj.cov)[ok], rtol=1e-4, atol=1e-6)


def test_eigen3(rng):
    B = rng.standard_normal((500, 3, 3)).astype(np.float32)
    A = B @ np.swapaxes(B, 1, 2)
    line = np.outer([1.0, 2.0, 0.5], [1.0, 2.0, 0.5]).astype(np.float32)
    A = np.concatenate([A, line[None], np.eye(3, dtype=np.float32)[None] * 0.3])
    ev = eigen3.sym_eigenvalues_3x3(_t(A)).numpy()
    evj = np.asarray(jeigen3.sym_eigenvalues_3x3(jnp.asarray(A)))
    scale = np.abs(evj).max(axis=1, keepdims=True)
    np.testing.assert_allclose(ev / scale, evj / scale, atol=1e-5)  # f32 acos/cos
    v, ok = eigen3.smallest_eigenvector_3x3(_t(A), return_valid=True)
    vj, okj = jeigen3.smallest_eigenvector_3x3(jnp.asarray(A), return_valid=True)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    good = np.asarray(okj) & (np.diff(evj, axis=1).min(axis=1) > 1e-2 * scale[:, 0])
    np.testing.assert_allclose(v.numpy()[good], np.asarray(vj)[good], atol=1e-3)
    w = eigen3.largest_eigenvector_3x3(_t(A)).numpy()
    wj = np.asarray(jeigen3.largest_eigenvector_3x3(jnp.asarray(A)))
    np.testing.assert_allclose(w[good], wj[good], atol=1e-3)


def test_hash_permutation_is_the_reference(rng):
    for n in (1, 257, 16384):
        np.testing.assert_array_equal(pipeline._hash_perm_host(n), jpipe._hash_perm_host(n))


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("capacity", [64, 700, 2000])
def test_compaction_is_exact(rng, uniform, capacity):
    flags = (rng.uniform(size=1000) > 0.4).astype(np.float32)
    vals = rng.standard_normal((1000, 3)).astype(np.float32)
    f, fj = (pipeline._compact_uniform, jpipe._compact_uniform) if uniform else (
        pipeline._compact, jpipe._compact)
    m, v = f(_t(flags), capacity, _t(vals))
    mj, vj = fj(jnp.asarray(flags), capacity, jnp.asarray(vals))
    np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
    keep = np.asarray(mj) > 0.5
    np.testing.assert_array_equal(v.numpy()[keep], np.asarray(vj)[keep])


def test_deskew(scan):
    raw, rawj = _raw(scan)
    twist = np.array([8.0, 0.3, 0.0, 0.01, -0.02, 0.9], np.float32)
    out = pipeline.FilterDeskew(scan_period=0.1, anchor="start")({"raw": raw}, twist=_t(twist))
    outj = jpipe.FilterDeskew(scan_period=0.1, anchor="start")({"raw": rawj},
                                                               twist=jnp.asarray(twist))
    # per-point exp + 3x3 products in f32: ~1e-6 relative on ~50 m points
    np.testing.assert_allclose(out["raw"].xyz.numpy(), np.asarray(outj["raw"].xyz),
                               rtol=1e-6, atol=1e-4)


def test_edges_planes_layers_agree(scan):
    raw, rawj = _raw(scan)
    kw = dict(voxel_filter_resolution=1.0, edges_capacity=256, planes_capacity=1024,
              decimated_capacity=1024, stats_mode="scan")
    out = pipeline.FilterEdgesPlanes(**kw)({"raw": raw})
    outj = jpipe.FilterEdgesPlanes(**kw)({"raw": rawj})
    for name in ("edges", "planes", "decimated"):
        pc, pj = out[name], outj[name]
        a = {tuple(r) for r in pc.xyz.numpy()[pc.mask.numpy() > 0.5]}
        b = {tuple(r) for r in np.asarray(pj.xyz)[np.asarray(pj.mask) > 0.5]}
        agree = len(a & b) / max(len(a | b), 1)
        # a point flips class only where an eigen-ratio sits within f32
        # round-off of its threshold; on this scan every point agrees
        assert agree >= 0.99, (name, agree)
        assert pc.mask.shape == pj.mask.shape
    np.testing.assert_array_equal(out["decimated"].xyz.numpy(), np.asarray(outj["decimated"].xyz))
    pm = out["planes"].mask.numpy() > 0.5
    np.testing.assert_allclose(out["planes"].attrs["normal"].numpy()[pm],
                               np.asarray(outj["planes"].attrs["normal"])[pm], atol=1e-3)


def test_metric_map_npz_and_numpy_layers_cross_packages(tmp_path, rng):
    xyz = rng.standard_normal((300, 3)).astype(np.float32)
    pcj = jmm.from_points(xyz, capacity=256, attrs={"time": rng.uniform(size=300)})
    pc = metric_map.from_points(xyz, capacity=256, attrs={"time": rng.uniform(size=300)},
                                device="cpu")
    np.testing.assert_array_equal(pc.xyz.numpy(), np.asarray(pcj.xyz))  # same subsample
    jmm.save_metric_map(str(tmp_path / "j.npz"), {"raw": pcj})
    back = metric_map.load_metric_map(str(tmp_path / "j.npz"), device="cpu")
    np.testing.assert_array_equal(back["raw"].xyz.numpy(), np.asarray(pcj.xyz))
    np.testing.assert_array_equal(back["raw"].attrs["time"].numpy(), np.asarray(pcj.attrs["time"]))
    metric_map.save_metric_map(str(tmp_path / "t.npz"), back)
    again = jmm.load_metric_map(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(np.asarray(again["raw"].mask), np.asarray(pcj.mask))
    layers = metric_map.to_numpy_layers(metric_map.from_numpy_layers(
        {"raw": {"xyz": np.asarray(pcj.xyz), "mask": np.asarray(pcj.mask),
                 "attrs": {"time": np.asarray(pcj.attrs["time"])}}}, device="cpu"))
    np.testing.assert_array_equal(layers["raw"]["xyz"], np.asarray(pcj.xyz))


# ---------------------------------------------------------------------------
# the pairwise-registration path's filters and the segment statistics

@pytest.mark.parametrize("num_segments", [None, 700])
def test_voxel_stats_are_the_reference_bit_for_bit(scan, num_segments):
    """Rows of a voxel are summed in order, as XLA's segment_sum does; the
    one difference is XLA's flush of subnormal results to zero."""
    raw, _ = _raw(scan)
    xyz, mask = raw.xyz.numpy(), raw.mask.numpy()
    s = num_segments or xyz.shape[0]  # 700 overflows: the tail goes to the trash slot
    st = voxel.voxel_stats(voxel.lex_sort_by_voxel(_t(xyz), _t(mask), 1.0), s)
    sj = jax.jit(lambda a, b: jvoxel.voxel_stats(jvoxel.lex_sort_by_voxel(a, b, 1.0), s))(
        jnp.asarray(xyz), jnp.asarray(mask))
    for f in ("count", "mean", "cov", "valid"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                   rtol=0, atol=np.finfo(np.float32).tiny)


def _small(scan, capacity=2048):
    """The scan voxel-downsampled to at most 2048 points, in both packages."""
    raw, rawj = _raw(scan)
    kw = dict(voxel_size=0.5, output_capacity=capacity, output_layer="raw")
    return (pipeline.FilterVoxelDownsample(**kw)({"raw": raw})["raw"],
            jpipe.FilterVoxelDownsample(**kw)({"raw": rawj})["raw"])


def _same_layer(pc, pj, atol=1e-6):
    np.testing.assert_array_equal(pc.mask.numpy(), np.asarray(pj.mask))
    np.testing.assert_allclose(pc.xyz.numpy(), np.asarray(pj.xyz), rtol=0, atol=atol)


@pytest.mark.parametrize("cls, kw", [
    ("FilterVoxelDownsample", dict(voxel_size=0.7, method="first", output_capacity=4096)),
    ("FilterVoxelDownsample", dict(voxel_size=0.7, method="mean", output_capacity=4096)),
    ("FilterVoxelDownsample", dict(voxel_size=0.3, method="mean", output_capacity=2048)),
    ("mp2p_icp_filters::FilterDecimateVoxels", dict(voxel_size=1.0)),
    ("FilterDecimate", dict(decimation=7)),
    ("FilterDecimate", dict(decimation=3, output_capacity=1000)),
    ("FilterBoundingBox", dict(min_corner=(-20, -15, -1), max_corner=(25, 30, 3))),
    ("mp2p_icp_filters::FilterBoundingBox", dict(min_corner=(-5, -5, -3), max_corner=(5, 5, 3),
                                                 keep_inside=False)),
])
def test_point_filters_match(scan, cls, kw):
    from mola_fe_lidar_tpu.filters.base import FILTER_REGISTRY as JREG
    from mola_fe_lidar_tpu_torch.filters.base import FILTER_REGISTRY

    raw, rawj = _raw(scan)
    out = FILTER_REGISTRY.get(cls)(**kw)({"raw": raw})
    outj = JREG.get(cls)(**kw)({"raw": rawj})
    assert set(out) == set(outj)
    for name in out:
        _same_layer(out[name], outj[name])


def test_decimate_to_count_keeps_attributes(scan):
    raw, rawj = _raw(scan)
    out = pipeline.FilterDecimateToCount(count=3000)({"raw": raw})["raw"]
    outj = jpipe.FilterDecimateToCount(count=3000)({"raw": rawj})["raw"]
    _same_layer(out, outj, atol=0)
    np.testing.assert_array_equal(out.attrs["time"].numpy(), np.asarray(outj.attrs["time"]))


def test_filter_registry_has_every_reference_name():
    from mola_fe_lidar_tpu.filters.base import FILTER_REGISTRY as JREG
    from mola_fe_lidar_tpu_torch.filters.base import FILTER_REGISTRY

    assert set(JREG.names()) <= set(FILTER_REGISTRY.names())


# planarity 1 - λ0/λ1 amplifies the eigenvalues' round-off where λ1 is small
PLANARITY_ATOL = 1e-3


def _normal_agreement(a, b, mask):
    """|cos| between the normals of the masked rows (a normal's sign is
    the eigen-extraction's choice, the same in both packages)."""
    return np.abs(np.sum(a * b, axis=-1))[mask > 0.5]


@pytest.mark.parametrize("method", ["knn", "voxel"])
def test_normals_match(scan, method):
    pc, pj = _small(scan)
    kw = dict(method=method, knn=8, voxel_size=1.5, max_voxels=1024)
    out = pipeline.FilterNormals(**kw)({"raw": pc})["raw"]
    outj = jpipe.FilterNormals(**kw)({"raw": pj})["raw"]
    _same_layer(out, outj, atol=0)
    pl, plj = out.attrs["planarity"].numpy(), np.asarray(outj.attrs["planarity"])
    m = pc.mask.numpy()
    np.testing.assert_allclose(pl, plj, atol=PLANARITY_ATOL)
    planar = (plj[:, 0] > 0.5) & (m > 0.5)
    cos = _normal_agreement(out.attrs["normal"].numpy(), np.asarray(outj.attrs["normal"]), planar)
    # a kNN set can differ where two neighbours tie within the reference's
    # norm-expansion round-off (~1e-4 m): a handful of rows, not more
    assert np.mean(cos > 1 - 1e-4) > 0.99, np.sort(cos)[:5]


def test_gicp_covariances_match(scan):
    pc, pj = _small(scan)
    out = pipeline.FilterGICPCovariances(knn=10)({"raw": pc})["raw"]
    outj = jpipe.FilterGICPCovariances(knn=10)({"raw": pj})["raw"]
    C, Cj = out.attrs["cov"].numpy(), np.asarray(outj.attrs["cov"])
    planar = (np.asarray(outj.attrs["planarity"])[:, 0] > 0.5) & (pc.mask.numpy() > 0.5)
    close = np.all(np.abs(C - Cj) < 1e-4, axis=-1)[planar]
    assert np.mean(close) > 0.99
    np.testing.assert_allclose(out.attrs["planarity"].numpy(), np.asarray(outj.attrs["planarity"]),
                               atol=PLANARITY_ATOL)


def test_edges_planes_segment_mode(scan):
    raw, rawj = _raw(scan)
    kw = dict(voxel_filter_resolution=1.0, edges_capacity=256, planes_capacity=1024,
              decimated_capacity=1024, stats_mode="segment", max_voxels=3000)
    out = pipeline.FilterEdgesPlanes(**kw)({"raw": raw})
    outj = jpipe.FilterEdgesPlanes(**kw)({"raw": rawj})
    # the segment statistics are bit-identical, so are the classes
    for name in ("edges", "planes", "decimated"):
        _same_layer(out[name], outj[name], atol=0)
    pm = out["planes"].mask.numpy() > 0.5
    np.testing.assert_allclose(out["planes"].attrs["normal"].numpy()[pm],
                               np.asarray(outj["planes"].attrs["normal"])[pm], atol=1e-3)
