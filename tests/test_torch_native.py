"""Port parity: the native C++ runtime (mola_fe_lidar_tpu_torch.native) --
the pose graph's Dijkstra against the port's pure-Python graph and the JAX
package's ``make_pose_graph()``, the KITTI reader against the reference's
native reader and ``obs/kitti.py``, the graph in the front-end's state, its
snapshots and checkpoints, and concurrent builds of the library.

Tolerances: Dijkstra poses within 1e-12 (the same compositions, rounded in
another order by numpy's matrix products), hop counts and node sets equal;
the reader's arrays byte-equal.
"""

import ctypes
import itertools
import threading

import numpy as np
import pytest

from mola_fe_lidar_tpu import native as jnative
from mola_fe_lidar_tpu.frontend import pose_graph as jpose_graph
from mola_fe_lidar_tpu_torch import native
from mola_fe_lidar_tpu_torch.frontend import pose_graph
from mola_fe_lidar_tpu_torch.frontend.checkpoint import load_checkpoint, save_checkpoint
from mola_fe_lidar_tpu_torch.obs import kitti, runner


def _rot(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _edges(rng, n=14):
    chain = [(i, i + 1) for i in range(n - 1)]
    extra = [(0, 5), (3, 9), (2, 11), (6, 13), (4, 12)]
    return [(a, b, _rot(rng.normal(0, 0.2, 3)), rng.normal(0, 3, 3)) for a, b in chain + extra]


def _assert_same_dijkstra(g, ref, sources):
    for src in sources:
        poses, topo = g.dijkstra_nodes_estimate(src)
        rposes, rtopo = ref.dijkstra_nodes_estimate(src)
        assert topo == rtopo and set(poses) == set(rposes)
        for n, (R, t) in poses.items():
            np.testing.assert_allclose(R, rposes[n][0], rtol=0, atol=1e-12)
            np.testing.assert_allclose(t, rposes[n][1], rtol=0, atol=1e-12)


def test_dijkstra_matches_python_and_reference_under_pruning():
    graphs = [pose_graph.make_pose_graph(), pose_graph.PoseGraph(), jpose_graph.make_pose_graph()]
    assert type(graphs[0]) is native.NativePoseGraph
    assert type(graphs[2]).__name__ == "NativePoseGraph"
    for a, b, R, t in _edges(np.random.default_rng(2)):
        for g in graphs:
            g.insert_edge(a, b, R, t)
    for victim in (None, 5, 0, 9, 13):
        for g in graphs:
            if victim is not None:
                g.remove_node(victim)
        ng, py, ref = graphs
        assert ng.nodes == py.nodes == set(ref.nodes)
        assert ng.root == py.root == ref.root and len(ng) == len(py)
        assert ng.num_edges == len(py.edges)
        for a, b in itertools.combinations(range(14), 2):
            assert ng.has_edge(a, b) == py.has_edge(a, b) == ref.has_edge(a, b)
        sources = [None] + sorted(ng.nodes)[:4]
        _assert_same_dijkstra(ng, py, sources)
        _assert_same_dijkstra(ng, ref, sources)
    assert native.NATIVE_AVAILABLE and native.build_error == ""
    assert type(pose_graph.make_pose_graph(prefer_native=False)) is pose_graph.PoseGraph


@pytest.mark.parametrize("stride, min_range, max_range, max_points, want_intensity", [
    (1, 0.0, 0.0, 200_000, True),
    (3, 2.0, 40.0, 200_000, True),
    (1, 0.0, 0.0, 1000, False),
], ids=["whole", "stride_and_range", "capped_xyz_only"])
def test_kitti_read_bin_native_matches(tmp_path, stride, min_range, max_range, max_points,
                                       want_intensity):
    rng = np.random.default_rng(5)
    rows = np.concatenate([rng.normal(0, 25, (3000, 3)), rng.random((3000, 1))], 1)
    path = tmp_path / "000000.bin"
    rows.astype(np.float32).tofile(path)
    args = (str(path), stride, min_range, max_range, max_points, want_intensity)
    xyz, inten = native.kitti_read_bin_native(*args)
    jxyz, jinten = jnative.kitti_read_bin_native(*args)
    assert xyz.tobytes() == jxyz.tobytes()
    # obs/kitti.py's reader with the same decimation and gating in numpy
    data = kitti.read_velodyne_bin(str(path))[::stride]
    x, y, z = data[:, 0], data[:, 1], data[:, 2]
    r2 = (x * x + y * y) + z * z
    keep = r2 >= np.float32(min_range * min_range)
    if max_range > 0:
        keep &= r2 <= np.float32(max_range) * np.float32(max_range)
    want = data[keep][:max_points]
    assert xyz.tobytes() == np.ascontiguousarray(want[:, :3]).tobytes()
    if want_intensity:
        assert inten.tobytes() == jinten.tobytes() == np.ascontiguousarray(want[:, 3]).tobytes()
    else:
        assert inten is None and jinten is None
    assert len(xyz) == min(len(data), max_points) if max_range == 0 else 0 < len(xyz) < len(data)
    with pytest.raises(IOError):
        native.kitti_read_bin_native(str(tmp_path / "missing.bin"))


def test_module_state_copy_and_checkpoint_hold_the_native_graph(tmp_path):
    """The front-end's graph, its ``state_copy`` and a checkpoint loaded
    into a fresh module are native graphs with the same Dijkstra."""
    cfg = runner.realtime_config(128 / 2048)
    module = runner.build_module(cfg, device="cpu")
    other = runner.build_module(cfg, device="cpu")
    try:
        st = module.state
        assert type(st.local_pose_graph) is native.NativePoseGraph
        with module._state_lock:
            for a, b, R, t in _edges(np.random.default_rng(3), n=8):
                st.local_pose_graph.insert_edge(a, b, R, t)
                st.edge_log.append((a, b, R, t))
            st.last_kf = 7
        save_checkpoint(module, str(tmp_path / "ckpt"))
        load_checkpoint(other, str(tmp_path / "ckpt"))
        loaded = other.state.local_pose_graph
        assert type(loaded) is native.NativePoseGraph
        assert loaded.nodes == st.local_pose_graph.nodes and loaded.root == 0
        _assert_same_dijkstra(loaded, st.local_pose_graph, [None, 2, 7])
        with module._state_lock:  # a pruned node stays out of the snapshot
            st.local_pose_graph.remove_node(7)
        snap = module.state_copy()
        assert type(snap.local_pose_graph) is native.NativePoseGraph
        assert snap.local_pose_graph is not st.local_pose_graph
        assert snap.local_pose_graph.nodes == st.local_pose_graph.nodes and 7 not in st.local_pose_graph.nodes
        _assert_same_dijkstra(snap.local_pose_graph, st.local_pose_graph, [None, 3, 6])
        traj = runner.estimated_trajectory(module)
        assert sorted(traj) == sorted(st.local_pose_graph.nodes)
    finally:
        module.shutdown()
        other.shutdown()


def test_concurrent_builds_land_one_library(tmp_path, monkeypatch):
    """Builds racing into one directory each rename a whole library into
    the same source-hashed name, and leave no temporary files."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build())
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [paths[0].name]
    assert paths[0].name == f"libmola_native_{native._digest()}.so"
    lib = ctypes.CDLL(str(paths[0]))
    lib.pg_create.restype = ctypes.c_void_p
    lib.pg_destroy.argtypes = [ctypes.c_void_p]
    lib.pg_destroy(lib.pg_create())
