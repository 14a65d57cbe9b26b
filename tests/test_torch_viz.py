"""Port parity for the PLY export (``obs/viz.py``) and the runner's
``--viz-out`` / ``--profile``: the same numpy points, layered clouds,
poses and pose graphs through both packages write byte-identical files.

Inputs, made from seeds with numpy: clouds with every layer colour, an
unnamed layer and an empty one; keyframe trajectories; a pose graph of
three keyframes with their layered clouds in each package's
``WorldModel``, held by a stand-in for the front-end module (the fields
``export_run`` reads), which a stubbed replay hands to both runners.

Tolerance: none -- the bytes are equal.
"""

import json
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.cloud.metric_map import PointCloud as JPointCloud
from mola_fe_lidar_tpu.frontend import pose_graph as jpose_graph
from mola_fe_lidar_tpu.frontend import worldmodel as jworldmodel
from mola_fe_lidar_tpu.obs import runner as jrunner
from mola_fe_lidar_tpu.obs import viz as jviz
from mola_fe_lidar_tpu.utils import profiler as jprofiler
from mola_fe_lidar_tpu_torch.cloud.metric_map import PointCloud
from mola_fe_lidar_tpu_torch.frontend import pose_graph, worldmodel
from mola_fe_lidar_tpu_torch.geometry import se3_np
from mola_fe_lidar_tpu_torch.obs import runner, viz
from mola_fe_lidar_tpu_torch.utils import profiler

torch.set_num_threads(1)
LAYERS = ("raw", "decimated", "planes", "edges", "zlayer", "empty")


def _layers(rng, n=40):
    """{layer: (xyz f32 [n,3] with padding rows at 1e6, mask)}."""
    out = {}
    for name in LAYERS:
        xyz = rng.normal(0, 20, (n, 3)).astype(np.float32)
        mask = (rng.uniform(size=n) < (0.0 if name == "empty" else 0.8)).astype(np.float32)
        xyz[mask < 0.5] = 1e6
        out[name] = (xyz, mask)
    return out


def _port_map(layers):
    return {k: PointCloud(torch.from_numpy(x), torch.from_numpy(m), {})
            for k, (x, m) in layers.items()}


def _ref_map(layers):
    return {k: JPointCloud(jnp.asarray(x), jnp.asarray(m), {}) for k, (x, m) in layers.items()}


def _poses(rng, n=4):
    return {k: se3_np.exp(np.concatenate([rng.normal(0, 10, 3), rng.normal(0, 0.5, 3)]))
            for k in range(n)}


def _same_files(a, b, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_write_ply_matches_reference(rng, tmp_path):
    xyz = rng.normal(0, 50, (25, 3))
    xyz[0] = [1e-5, -0.00005, 123456.78]  # rounding at the fourth decimal
    cols = rng.integers(0, 256, (25, 3))
    for i, (pts, c) in enumerate(((xyz, None), (xyz, cols), (np.zeros((0, 3)), None))):
        viz.write_ply(str(tmp_path / f"p{i}.ply"), pts, c)
        jviz.write_ply(str(tmp_path / f"j{i}.ply"), pts, c)
        assert (tmp_path / f"p{i}.ply").read_bytes() == (tmp_path / f"j{i}.ply").read_bytes()


def test_export_metric_map_matches_reference(rng, tmp_path):
    layers = _layers(rng)
    for name, keep in (("all", LAYERS), ("empty", ("empty",))):
        sub = {k: layers[k] for k in keep}
        viz.export_metric_map(str(tmp_path / f"p_{name}.ply"), _port_map(sub))
        jviz.export_metric_map(str(tmp_path / f"j_{name}.ply"), _ref_map(sub))
        assert (tmp_path / f"p_{name}.ply").read_bytes() == \
            (tmp_path / f"j_{name}.ply").read_bytes()


def test_export_trajectory_matches_reference(rng, tmp_path):
    poses = _poses(rng)
    viz.export_trajectory(str(tmp_path / "p.ply"), poses)
    jviz.export_trajectory(str(tmp_path / "j.ply"), poses)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    viz.export_trajectory(str(tmp_path / "p2.ply"), poses, axis_len=2.0)
    jviz.export_trajectory(str(tmp_path / "j2.ply"), poses, axis_len=2.0)
    assert (tmp_path / "p2.ply").read_bytes() == (tmp_path / "j2.ply").read_bytes()


@pytest.fixture
def modules(rng):
    """(port module, reference module): stand-ins holding the same pose
    graph (root 0, three keyframes) and layered clouds, a profiler with the
    same counters, and the lock ``export_run`` takes."""
    rels = [(0, 1, *se3_np.exp(np.array([3.0, 0.2, 0, 0, 0, 0.1]))),
            (1, 2, *se3_np.exp(np.array([3.0, -0.1, 0, 0, 0, -0.2]))),
            (0, 2, *se3_np.exp(np.array([6.1, 0.3, 0, 0, 0, -0.1])))]
    clouds = [_layers(rng) for _ in range(3)]
    out = []
    for graph, wm, mm, prof, cls in (
            (pose_graph.PoseGraph(), worldmodel.WorldModel(device="cpu"), _port_map,
             profiler.Profiler("LidarOdometry"), "port"),
            (jpose_graph.PoseGraph(), jworldmodel.WorldModel(), _ref_map,
             jprofiler.Profiler("LidarOdometry"), "ref")):
        graph.insert_node(0)
        for a, b, R, t in rels:
            graph.insert_edge(a, b, R, t)
        for kf, layers in enumerate(clouds):
            wm.add_entity(kf)
            wm.annotate(kf, worldmodel.ANNOTATION_NAME_PC_LAYERS, mm(layers))
        for v in (0.5, 1.0, 0.25):
            prof.register_user_measure("checkNonAdjacent.lc.goodness", v)
        out.append(SimpleNamespace(_state_lock=threading.Lock(), worldmodel=wm, profiler=prof,
                                   state=SimpleNamespace(local_pose_graph=graph),
                                   shutdown=lambda: None))
    return out


def test_export_run_matches_reference(modules, tmp_path):
    port, ref = modules
    for max_kf, names in ((50, ("trajectory.ply", "kf_0000.ply", "kf_0001.ply", "kf_0002.ply")),
                          (2, ("trajectory.ply", "kf_0000.ply", "kf_0001.ply"))):
        viz.export_run(str(tmp_path / f"p{max_kf}"), port, max_keyframes=max_kf)
        jviz.export_run(str(tmp_path / f"j{max_kf}"), ref, max_keyframes=max_kf)
        assert sorted(p.name for p in (tmp_path / f"p{max_kf}").iterdir()) == sorted(names)
        _same_files(tmp_path / f"p{max_kf}", tmp_path / f"j{max_kf}", names)


def test_runner_viz_out_and_profile_match_reference(modules, monkeypatch, tmp_path, capsys):
    """Both runners' ``--viz-out`` and ``--profile`` over a stubbed replay:
    the same PLY files, byte for byte, and the same profiler report."""
    port, ref = modules
    summary = {"n_scans": 3, "n_keyframes": 3, "n_factors": 3, "wall_s": 1.5,
               "kf_poses": {}, "backend": None}
    monkeypatch.setattr(jrunner, "run_replay", lambda *a, **k: dict(summary, module=ref))
    monkeypatch.setattr(runner, "run_replay", lambda *a, **k: dict(summary, module=port))
    prints = []
    for main, side, extra in ((jrunner.main, "j", ()), (runner.main, "p", ("--device", "cpu"))):
        assert main(["--scans", "3", "--profile", "--viz-out", str(tmp_path / side), *extra]) == 0
        prints.append(capsys.readouterr().out)
    _same_files(tmp_path / "p", tmp_path / "j",
                ("trajectory.ply", "kf_0000.ply", "kf_0001.ply", "kf_0002.ply"))
    reports = [text.split("PLY exports written to ", 1)[1].split("\n", 1)[1] for text in prints]
    assert reports[0] == reports[1] and reports[0].startswith("=== LidarOdometry ===")
    assert "checkNonAdjacent.lc.goodness" in reports[0]
    assert json.loads(prints[1][:prints[1].index("\n}\n") + 2])["n_scans"] == 3
