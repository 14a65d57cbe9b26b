"""The on-card HDL-64 generator against the numpy copy, on the CPU at a
small azimuth count: every range and every point, with noise and dropout
off (their draws come from different generators by design)."""

import numpy as np
import pytest

import hdl64
import hdl64_torch


@pytest.mark.parametrize("route_kind,parked", [("snake", 0), ("block", 40)])
def test_torch_scans_equal_numpy(route_kind, parked):
    world_np = hdl64.HDL64World(seed=3, range_noise=0.0, dropout=0.0)
    world_t = hdl64.HDL64World(seed=3, range_noise=0.0, dropout=0.0)
    if parked:
        world_np.add_parked_cars(parked)
        world_t.add_parked_cars(parked)
    route = hdl64.make_route(route_kind, world_np)
    obs_t, gt_t = hdl64_torch.generate(world_t, route, n_scans=3, n_azimuth=256, seed=7,
                                       device="cpu", first_scan=5, batch=2)
    for j, i in enumerate(range(5, 8)):
        ref = world_np.scan(route, i * hdl64.SWEEP_PERIOD, n_azimuth=256)
        got = obs_t[j]
        assert got["timestamp"] == ref["timestamp"]
        np.testing.assert_array_equal(got["valid"], ref["valid"])
        np.testing.assert_array_equal(got["time"], ref["time"])
        np.testing.assert_allclose(got["xyz"], ref["xyz"], rtol=0, atol=1e-5)
        assert 0.3 < ref["valid"].mean() < 1.0
        R0, p0 = route(i * hdl64.SWEEP_PERIOD)
        np.testing.assert_array_equal(gt_t[j][0], R0)
        np.testing.assert_array_equal(gt_t[j][1], p0)


def test_cast_ranges_equal_numpy():
    world = hdl64.HDL64World(seed=11)
    route = hdl64.make_route("snake", world)
    rng_t, d_sensor, tau = hdl64_torch.scan_geometry(hdl64_torch.TorchWorld(world, "cpu"),
                                                     route, [1.3], 128)
    times = 1.3 + np.arange(128) / 128 * hdl64.SWEEP_PERIOD
    Rs, ps = route.poses(times)
    d_world = np.einsum("ajk,bak->baj", Rs, d_sensor.numpy().reshape(64, 128, 3)).reshape(-1, 3)
    o_world = np.broadcast_to(ps[None], (64, 128, 3)).reshape(-1, 3)
    ref = world.cast(o_world, d_world, np.broadcast_to(times[None], (64, 128)).reshape(-1))
    got = rng_t[0].numpy()
    hit = np.isfinite(ref) & (ref < world.max_range)
    np.testing.assert_array_equal(np.isfinite(got) & (got < world.max_range), hit)
    np.testing.assert_allclose(got[hit], ref[hit], rtol=1e-12, atol=0)


def test_noise_and_dropout_follow_the_seed():
    world = hdl64.HDL64World(seed=0)
    route = hdl64.make_route("snake", world)
    a, _ = hdl64_torch.generate(world, route, 2, 128, seed=2**31 + 17, device="cpu")
    b, _ = hdl64_torch.generate(world, route, 2, 128, seed=2**31 + 17, device="cpu")
    c, _ = hdl64_torch.generate(world, route, 2, 128, seed=5, device="cpu")
    assert all(np.array_equal(x["xyz"], y["xyz"]) for x, y in zip(a, b))
    assert not np.array_equal(a[0]["xyz"], c[0]["xyz"])
    assert abs(a[0]["valid"].mean() - c[0]["valid"].mean()) < 0.05
