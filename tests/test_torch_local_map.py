"""Port parity: the hash-built rolling local map
(mola_fe_lidar_tpu_torch.frontend.local_map) against the JAX reference.

The clouds span +-500 m at a 0.25 m dedup pitch, so the voxel cells run to
~2000 and every term of the multiply-XOR hash overflows int32: the port
must wrap exactly as the reference's int32 arithmetic does. With world
poses whose products are exact in f32 (axis-permutation rotations,
integer translations), the build is integer logic and gathers: outputs
must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.cloud.metric_map import PointCloud as JPointCloud
from mola_fe_lidar_tpu.frontend import local_map as jlm
from mola_fe_lidar_tpu_torch.cloud.metric_map import PointCloud
from mola_fe_lidar_tpu_torch.frontend import local_map

torch.set_num_threads(1)
RES = 0.25


def _layer(rng, n=512, spread=500.0):
    xyz = (rng.uniform(-spread, spread, size=(n, 3))).astype(np.float32)
    xyz[: n // 4] = np.round(xyz[: n // 4])  # shared cells -> real dedup
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    xyz[mask < 0.5] = 1e6
    normal = rng.standard_normal((n, 3)).astype(np.float32)
    planarity = rng.uniform(size=(n, 1)).astype(np.float32)
    return xyz, mask, {"normal": normal, "planarity": planarity}


def _poses(rng, w):
    perm = np.eye(3, dtype=np.float32)[[1, 0, 2]] * np.array([1, -1, 1], np.float32)
    Rs = np.stack([perm if i % 2 else np.eye(3, dtype=np.float32) for i in range(w)])
    ts = rng.integers(-20, 20, size=(w, 3)).astype(np.float32)
    return Rs, ts


def test_hash_overflows_int32_and_wraps_like_the_reference(rng):
    cell = rng.integers(-2000, 2000, size=(1000, 3)).astype(np.int32)
    assert np.abs(cell.astype(np.int64) * 83492791).max() > 2**31
    j = (jnp.asarray(cell[:, 0]) * np.int32(73856093)) ^ (
        jnp.asarray(cell[:, 1]) * np.int32(19349663)) ^ (
        jnp.asarray(cell[:, 2]) * np.int32(83492791))
    T = 1 << 14
    np.testing.assert_array_equal(
        local_map._spatial_hash(torch.from_numpy(cell), T).numpy(),
        np.asarray(jnp.bitwise_and(j, T - 1)))


@pytest.mark.parametrize("with_ranks", [False, True])
def test_device_build_hash_matches_reference(rng, with_ranks):
    W, cap = 3, 1024
    lay = [_layer(rng) for _ in range(W)]
    xyz = np.stack([l[0] for l in lay])
    mask = np.stack([l[1] for l in lay])
    attrs = {k: np.stack([l[2][k] for l in lay]) for k in ("normal", "planarity")}
    Rs, ts = _poses(rng, W)
    kf_valid = np.array([1.0, 1.0, 0.0], np.float32)
    ranks = inv = None
    if with_ranks:
        inv = np.array([2, 0, 1], np.int32)
        ranks = np.empty(W, np.int32)
        ranks[inv] = np.arange(W, dtype=np.int32)
    out = local_map._device_build_hash(
        {"planes": (torch.from_numpy(xyz), torch.from_numpy(mask),
                    {k: torch.from_numpy(v) for k, v in attrs.items()})},
        torch.from_numpy(Rs), torch.from_numpy(ts), torch.from_numpy(kf_valid), RES,
        (("planes", cap),),
        None if ranks is None else torch.from_numpy(ranks),
        None if inv is None else torch.from_numpy(inv))["planes"]
    ref = jlm._device_build_hash(
        {"planes": (jnp.asarray(xyz), jnp.asarray(mask),
                    {k: jnp.asarray(v) for k, v in attrs.items()})},
        jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(kf_valid), jnp.float32(RES),
        (("planes", cap),),
        None if ranks is None else jnp.asarray(ranks),
        None if inv is None else jnp.asarray(inv))["planes"]
    assert out.mask.sum() > 500  # real dedup, not an empty map
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(out.xyz.numpy(), np.asarray(ref.xyz))
    for k in ("normal", "planarity"):
        np.testing.assert_array_equal(out.attrs[k].numpy(), np.asarray(ref.attrs[k]))


def test_ring_over_the_window_matches_reference(rng):
    """Five keyframes through a 3-slot ring (wrap-around: age ranks)."""
    port = local_map.DeviceLocalMap(window=3, capacity_mult=2, dedup_voxel=RES,
                                    keep_layers={"planes"}, mode="hash")
    ref = jlm.DeviceLocalMap(window=3, capacity_mult=2, dedup_voxel=RES,
                             keep_layers={"planes"}, mode="hash")
    Rs, ts = _poses(rng, 5)
    for i in range(5):
        xyz, mask, attrs = _layer(rng)
        pose = (Rs[i].astype(np.float64), ts[i].astype(np.float64))
        port.add_keyframe({"planes": PointCloud(torch.from_numpy(xyz), torch.from_numpy(mask),
                                                {k: torch.from_numpy(v) for k, v in attrs.items()}),
                           "raw": PointCloud(torch.zeros(4, 3), torch.zeros(4), {})}, pose)
        ref.add_keyframe({"planes": JPointCloud(jnp.asarray(xyz), jnp.asarray(mask),
                                                {k: jnp.asarray(v) for k, v in attrs.items()})},
                         pose)
        out, want = port.build()["planes"], ref.build()["planes"]
        assert set(port.build()) == {"planes"}  # keep_layers drops "raw"
        np.testing.assert_array_equal(out.mask.numpy(), np.asarray(want.mask))
        np.testing.assert_array_equal(out.xyz.numpy(), np.asarray(want.xyz))
        np.testing.assert_array_equal(out.attrs["normal"].numpy(), np.asarray(want.attrs["normal"]))
    assert len(port) == 3


def test_sort_mode_is_not_ported():
    """The builder's modes are "sort" and "hash"; another raises ValueError
    as in the reference (the sort build itself is held to the reference in
    tests/test_torch_map_builds.py)."""
    assert local_map.DeviceLocalMap(mode="sort").mode == "sort"
    for lib in (local_map, jlm):
        with pytest.raises(ValueError):
            lib.DeviceLocalMap(mode="grid")
