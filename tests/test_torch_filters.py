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
