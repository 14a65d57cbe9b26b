"""Port parity for the nearby-keyframe and loop-closure search
(mola_fe_lidar_tpu_torch.frontend.odometry, .worldmodel, .pose_graph,
.models.icp's symmetric quality) against the JAX package.

* The loop-closure stages (symmetric edges quality and its required-min
  veto included) on a batch of Monte-Carlo guesses: the guesses are made
  here with numpy and handed to both packages (torch cannot reproduce
  ``jax.random``). Tolerance per lane: 1 mm / 0.2 mrad, equal iteration
  counts, quality within 1e-3.
* The loop-closure submap: the same keyframe clouds and pose graph in both
  modules; graph edges are axis-permutation rotations with integer
  translations, so every composed pose is exact and the hash build is
  integer logic and gathers: outputs must be identical.
* The job selection of ``check_for_nearby_kfs`` on the same pose graph:
  the pools are replaced by recorders, so the selection (window, stride
  decimation, dedup, loop-closure candidate, pruning) is compared without
  running any check; equal node lists and guesses to 1e-9.
* ``WorldModel`` spill and reload, and the pose graph under pruning.
"""

import dataclasses
import itertools
import math
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_fe_lidar_tpu.cloud.metric_map import load_metric_map as jload_metric_map
from mola_fe_lidar_tpu.frontend import pose_graph as jpose_graph
from mola_fe_lidar_tpu.frontend.odometry import LidarOdometry as JLidarOdometry
from mola_fe_lidar_tpu.geometry import se3 as jse3
from mola_fe_lidar_tpu.models.config import AlignKind as JAlignKind
from mola_fe_lidar_tpu.parallel import batch as jbatch
from mola_fe_lidar_tpu_torch.cloud.metric_map import PointCloud
from mola_fe_lidar_tpu_torch.filters.generators import apply_generators
from mola_fe_lidar_tpu_torch.frontend import pose_graph
from mola_fe_lidar_tpu_torch.frontend.worldmodel import (ANNOTATION_NAME_PC_LAYERS,
                                                         WorldModel)
from mola_fe_lidar_tpu_torch.geometry import se3
from mola_fe_lidar_tpu_torch.models import icp
from mola_fe_lidar_tpu_torch.models.config import AlignKind
from mola_fe_lidar_tpu_torch.obs.hdl64 import hdl64_sequence
from mola_fe_lidar_tpu_torch.obs.runner import build_module, realtime_config
from mola_fe_lidar_tpu_torch.parallel import batch
from test_torch_batch import _assert_lanes_match, _jmap

torch.set_num_threads(1)
AZIMUTH = 256
N_MC = 4


def _modules(**params):
    cfg = realtime_config(AZIMUTH / 2048)
    cfg["params"].update(params)
    port = build_module(cfg, device="cpu")
    ref = JLidarOdometry()
    ref.initialize(cfg)
    return port, ref


@pytest.fixture(scope="module")
def setup():
    """Both modules at the realtime configuration, the filtered layers of
    four HDL-64 scans 3 scans apart (the port's filter chain) and their
    ground-truth poses."""
    port, ref = _modules()
    obs, gt = hdl64_sequence(n_scans=10, n_azimuth=AZIMUTH)
    layers = []
    for i in (0, 3, 6, 9):
        mm = port._filter_core(apply_generators(port.generators, obs[i]), torch.zeros(6))[0]
        layers.append({n: pc for n, pc in mm.items() if n != "raw"})
    yield port, ref, layers, [gt[i] for i in (0, 3, 6, 9)]
    port.shutdown()
    ref.shutdown()


def mc_guesses(R, t, n, sigma_xyz=0.25, sigma_yaw=0.02):
    """Deterministic stand-ins for the Monte-Carlo guesses (f32 numpy):
    yaw and translation perturbations of the centre, the same for both
    packages."""
    rng = np.random.default_rng(11)
    dxyz = rng.normal(0, sigma_xyz, (n, 3))
    yaw = rng.normal(0, sigma_yaw, n)
    c, s = np.cos(yaw), np.sin(yaw)
    Rz = np.zeros((n, 3, 3))
    Rz[:, 0, 0], Rz[:, 0, 1], Rz[:, 1, 0], Rz[:, 1, 1], Rz[:, 2, 2] = c, -s, s, c, 1.0
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    return (Rz @ R).astype(np.float32), (Rz @ t + dxyz).astype(np.float32)


def test_lc_stages_match_reference_with_injected_guesses(setup):
    port, ref, layers, gt = setup
    stages = port.icp_cases[AlignKind.LOOP_CLOSURE]
    jstages = ref.icp_cases[JAlignKind.LOOP_CLOSURE]
    assert any(q.symmetric for q in stages[0].quality)
    # a cap of 25 iterations (both sides) keeps the CPU run short; one lane
    # of these guesses runs into it
    params = dataclasses.replace(stages[0], max_iterations=25)
    jparams = dataclasses.replace(jstages[0], max_iterations=25)
    (R0, p0), (R3, p3) = gt[0], gt[3]
    gR, gt_ = mc_guesses(R0.T @ R3, R0.T @ (p3 - p0), N_MC)
    res = batch.batched_align(layers[3], layers[0],
                              se3.Pose(torch.from_numpy(gR), torch.from_numpy(gt_)), params)
    jres = jbatch.batched_align(_jmap(layers[3], N_MC), _jmap(layers[0], N_MC),
                                jse3.Pose(jnp.asarray(gR), jnp.asarray(gt_)), jparams)
    _assert_lanes_match(res, jres)
    assert float(res.quality.max()) > 0.1
    assert set(res.term_reason.tolist()) == {icp.TERM_CONVERGED, icp.TERM_MAX_ITERS}


def test_symmetric_quality_keeps_the_larger_direction():
    """A target twice as dense as the source: the reverse direction pairs
    only half of the target, the forward one all of the source."""
    rng = np.random.default_rng(5)
    src = rng.uniform(-10, 10, (200, 3)).astype(np.float32)
    tgt = np.concatenate([src + 0.01, rng.uniform(-10, 10, (200, 3)).astype(np.float32)])
    pose = se3.Pose(torch.eye(3), torch.zeros(3))

    def cloud(x):
        return {"edges": PointCloud(torch.from_numpy(x), torch.ones(len(x)), {})}

    params = port_quality_params(symmetric=False)
    fwd = float(icp._quality(pose, cloud(src), cloud(tgt), params))
    rev = float(icp._quality(pose, cloud(tgt), cloud(src), params))
    sym = float(icp._quality(pose, cloud(tgt), cloud(src), port_quality_params(symmetric=True)))
    d = np.linalg.norm(tgt[:, None] - src[None], axis=-1).min(axis=1)
    assert rev == pytest.approx(np.mean(d < 0.3)) and rev < 0.75
    assert fwd == 1.0 and sym == max(fwd, rev)


def port_quality_params(symmetric):
    from mola_fe_lidar_tpu_torch.models.config import ICPParams, Quality
    return ICPParams(quality=(Quality(kind="paired_ratio", src_layer="edges", tgt_layer="edges",
                                      threshold_distance=0.3, symmetric=symmetric),))


def test_monte_carlo_guesses_are_seeded_yaw_perturbations():
    center = se3.Pose(torch.eye(3), torch.tensor([1.0, 2.0, 0.5]))
    a = batch.monte_carlo_guesses(torch.Generator().manual_seed(7), center, 64, 3.0, 0.05)
    b = batch.monte_carlo_guesses(torch.Generator().manual_seed(7), center, 64, 3.0, 0.05)
    c = batch.monte_carlo_guesses(torch.Generator().manual_seed(8), center, 64, 3.0, 0.05)
    assert torch.equal(a.R, b.R) and torch.equal(a.t, b.t) and not torch.equal(a.t, c.t)
    assert a.R.shape == (64, 3, 3)
    torch.testing.assert_close(a.R[:, 2], torch.tensor([0.0, 0.0, 1.0]).expand(64, 3))
    spread = (a.t - center.t).std(dim=0)
    assert 2.0 < float(spread.min()) and float(spread.max()) < 4.5


# ---------------------------------------------------------------------------
# keyframe graphs shared by both modules

def _exact_pose(i):
    """Edge i -> i+1: a quarter turn every third edge, integer steps."""
    R = np.eye(3)
    if i % 3 == 2:
        R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return R, np.array([3.0, float(i % 2), 0.0])


def _fill(module, clouds, edges, to_cloud):
    st = module.state
    wm = module.worldmodel
    for n, cloud in clouds.items():
        wm.add_entity(n)
        if cloud is not None:
            wm.annotate(n, ANNOTATION_NAME_PC_LAYERS, to_cloud(cloud))
    st.local_pose_graph.insert_node(min(clouds))
    for a, b, R, t in edges:
        st.local_pose_graph.insert_edge(a, b, R, t)
        wm.add_neighbors(a, b)
    st.last_kf = max(clouds)


@pytest.mark.parametrize("k", [1, 3])
def test_lc_submap_matches_reference(setup, k):
    _, _, layers, _ = setup
    port, ref = _modules(lc_submap_keyframes=k)
    try:
        clouds = {n: layers[n % 4] for n in range(6)}
        edges = [(i, i + 1, *_exact_pose(i)) for i in range(5)]
        _fill(port, clouds, edges, lambda c: c)
        _fill(ref, clouds, edges, _jmap)
        got, want = port._build_lc_submap(2), ref._build_lc_submap(2)
        assert set(got) == set(want) == {"decimated", "planes", "edges"}
        for name, pc in got.items():
            assert pc.capacity == 2 * layers[0][name].capacity  # lc_submap_capacity_mult
            np.testing.assert_array_equal(pc.mask.numpy(), np.asarray(want[name].mask))
            np.testing.assert_array_equal(pc.xyz.numpy(), np.asarray(want[name].xyz))
            for a, v in pc.attrs.items():
                np.testing.assert_array_equal(v.numpy(), np.asarray(want[name].attrs[a]))
        assert float(got["planes"].mask.sum()) > float(layers[2]["planes"].mask.sum())
    finally:
        port.shutdown()
        ref.shutdown()


class _Recorder:
    """Stands in for the nearby pool: records what would run."""

    def __init__(self):
        self.calls = []

    def submit(self, fn, *args):
        self.calls.append((fn, args))

    def shutdown(self, wait=True):
        pass


def _ring(n_kf, spacing=3.0, extra=()):
    """Keyframes on a circle (the last one back near the first): the edges
    i -> i+1 and the ``extra`` pairs, each the pose of the second keyframe
    in the first one's frame."""
    poses = []
    for i in range(n_kf):
        # a slowly widening circle: no two keyframes at the same distance
        r = n_kf * spacing / (2 * math.pi) * (1 + 0.03 * i)
        th = 2 * math.pi * i / n_kf
        c, s = math.cos(th + math.pi / 2), math.sin(th + math.pi / 2)
        poses.append((np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]),
                      np.array([r * math.cos(th), r * math.sin(th), 0.0])))
    edges = []
    for a, b in [(i, i + 1) for i in range(n_kf - 1)] + list(extra):
        (Ra, ta), (Rb, tb) = poses[a], poses[b]
        edges.append((a, b, Ra.T @ Rb, Ra.T @ (tb - ta)))
    return edges


SCENARIOS = {
    "preset": dict(params={}, extra=None),
    "lc_and_stride": dict(params=dict(max_nearby_align_checks=2,
                                      min_topo_dist_to_consider_loopclosure=5), extra=None),
    "dedup": dict(params=dict(max_nearby_align_checks=1,
                              min_topo_dist_to_consider_loopclosure=3), extra="dedup"),
    "pruned": dict(params=dict(max_KFs_local_graph=8,
                               min_topo_dist_to_consider_loopclosure=4), extra=None),
}


def _selection(calls, port):
    out = {"nearby": [], "lc": []}
    for fn, args in calls:
        if port:
            fn, args = args[0], args[1:]
        name = fn.__name__
        if "nearby_batch" in name:
            out["nearby"] += list(args[1])
        else:
            assert args[0] == "lc"
            out["lc"].append(tuple(args[2:5]))
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_nearby_job_selection_matches_reference(scenario):
    spec = SCENARIOS[scenario]
    port, ref = _modules(**spec["params"])
    try:
        clouds = {n: object() for n in range(16)}
        dedup = spec["extra"] == "dedup"
        if dedup:
            clouds[11] = None  # no stored cloud
        # dedup: an existing non-adjacent edge 13 - 15
        edges = _ring(16, extra=[(13, 15)] if dedup else ())
        for module in (port, ref):
            _fill(module, clouds, edges, lambda c: c)
            if dedup:
                module.state.checked_KF_pairs.add((12, 15))
            module._nearby_pool.shutdown()
            module._nearby_pool = _Recorder()
        port.check_for_nearby_kfs()
        ref.check_for_nearby_kfs()
        got = _selection(port._nearby_pool.calls, port=True)
        want = _selection(ref._nearby_pool.calls, port=False)
        assert [n for n, _, _ in got["nearby"]] == [n for n, _, _ in want["nearby"]]
        assert [n for n, _, _ in got["lc"]] == [n for n, _, _ in want["lc"]]
        for (_, R, t), (_, Rj, tj) in zip(got["nearby"] + got["lc"], want["nearby"] + want["lc"]):
            np.testing.assert_allclose(R, Rj, atol=1e-9)
            np.testing.assert_allclose(t, tj, atol=1e-9)
        assert got["nearby"] or got["lc"]
        assert len(got["nearby"]) <= port.params.max_nearby_align_checks
        assert port.state.checked_KF_pairs == ref.state.checked_KF_pairs
        assert port.state.local_pose_graph.nodes == set(ref.state.local_pose_graph.nodes)
        if scenario == "pruned":
            assert len(port.state.local_pose_graph) == 8
    finally:
        port._nearby_pool = ref._nearby_pool = _Recorder()
        port.shutdown()
        ref.shutdown()


def test_zero_nearby_checks_skips_the_nearby_search():
    """The reference divides by zero here once a keyframe has candidates;
    the port skips the nearby checks and still selects the loop closure."""
    port, ref = _modules(max_nearby_align_checks=0, min_topo_dist_to_consider_loopclosure=5)
    try:
        clouds = {n: object() for n in range(16)}
        for module in (port, ref):
            _fill(module, clouds, _ring(16), lambda c: c)
            module._nearby_pool.shutdown()
            module._nearby_pool = _Recorder()
        port.check_for_nearby_kfs()
        got = _selection(port._nearby_pool.calls, port=True)
        assert got["nearby"] == [] and len(got["lc"]) == 1
        with pytest.raises(ZeroDivisionError):
            ref.check_for_nearby_kfs()
    finally:
        port._nearby_pool = ref._nearby_pool = _Recorder()
        port.shutdown()
        ref.shutdown()


def test_pose_graph_matches_reference_under_pruning():
    rng = np.random.default_rng(2)
    port_g, ref_g = pose_graph.make_pose_graph(), jpose_graph.make_pose_graph()
    edges = [(i, i + 1) for i in range(11)] + [(0, 5), (3, 9), (2, 11)]
    for a, b in edges:
        R = jse3_np_exp(rng.normal(0, 0.2, 3))
        t = rng.normal(0, 3, 3)
        port_g.insert_edge(a, b, R, t)
        ref_g.insert_edge(a, b, R, t)
    for victim in (None, 5, 0, 9):
        if victim is not None:
            port_g.remove_node(victim)
            ref_g.remove_node(victim)
        assert port_g.nodes == set(ref_g.nodes) and port_g.root == ref_g.root
        for a, b in itertools.combinations(range(12), 2):
            assert port_g.has_edge(a, b) == ref_g.has_edge(a, b)
        for src in sorted(port_g.nodes)[:3]:
            poses, topo = port_g.dijkstra_nodes_estimate(src)
            jposes, jtopo = ref_g.dijkstra_nodes_estimate(src)
            assert topo == jtopo and set(poses) == set(jposes)
            for n, (R, t) in poses.items():
                np.testing.assert_allclose(R, jposes[n][0], atol=1e-9)
                np.testing.assert_allclose(t, jposes[n][1], atol=1e-9)


def jse3_np_exp(w):
    """Rotation matrix of the rotation vector ``w`` (Rodrigues)."""
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def test_worldmodel_spills_and_reloads(setup, tmp_path):
    _, _, layers, _ = setup
    wm = WorldModel(spill_dir=str(tmp_path), max_resident=2, device="cpu")
    for n in range(4):
        wm.annotate(n, ANNOTATION_NAME_PC_LAYERS, layers[n])
    wm.add_neighbors(0, 1)
    assert wm.resident_count() == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["kf_00000000.npz", "kf_00000001.npz"]
    assert all(wm.has_annotation(n, ANNOTATION_NAME_PC_LAYERS) for n in range(4))
    assert not wm.has_annotation(7, ANNOTATION_NAME_PC_LAYERS)
    back = wm.annotation(0, ANNOTATION_NAME_PC_LAYERS)  # reload spills kf 2
    assert wm.resident_count() == 2 and (tmp_path / "kf_00000002.npz").exists()
    for name, pc in layers[0].items():
        assert back[name].xyz.device == torch.device("cpu")
        assert torch.equal(back[name].xyz, pc.xyz) and torch.equal(back[name].mask, pc.mask)
        for a, v in pc.attrs.items():
            assert torch.equal(back[name].attrs[a], v)
    assert wm.entity_neighbors(1) == {0} and wm.entities() == [0, 1, 2, 3]
    # the spill files are the reference's npz layout
    jback = jload_metric_map(str(tmp_path / "kf_00000001.npz"))
    np.testing.assert_array_equal(np.asarray(jback["planes"].xyz), layers[1]["planes"].xyz.numpy())


def test_module_takes_a_provided_worldmodel_or_makes_one_on_its_device():
    from mola_fe_lidar_tpu_torch.frontend.odometry import LidarOdometry
    port, _ = _modules()
    other = LidarOdometry(device="cpu")
    try:
        assert isinstance(port.worldmodel, WorldModel)
        assert port.worldmodel.device == torch.device("cpu")
        shared = WorldModel(device="cpu")
        other.provide_service(shared)
        other.initialize(realtime_config(AZIMUTH / 2048))
        assert other.worldmodel is shared
    finally:
        port.shutdown()
        other.shutdown()


def test_concurrent_accepts_lose_no_edge():
    """Many pool threads accepting edges at once (a very short interpreter
    switch interval): every edge lands in the graph, the edge log and the
    counters exactly once."""
    from mola_fe_lidar_tpu_torch.frontend.backend import HostPose
    port = build_module(realtime_config(AZIMUTH / 2048), device="cpu")
    port.state.local_pose_graph.insert_node(0)
    pairs = [(a, b) for a in range(12) for b in range(a + 2, 12)]
    R, t = np.eye(3), np.array([5.0, 0.0, 0.0])
    pose = HostPose(R.astype(np.float32), t.astype(np.float32))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            futures = [pool.submit(port._accept_non_adjacent, "nearby", a, b, R, t, 0.9, pose)
                       for a, b in pairs]
            for f in futures:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
        port.shutdown()
    assert sorted((a, b) for a, b, _, _ in port.state.edge_log) == pairs
    assert all(port.state.local_pose_graph.has_edge(a, b) for a, b in pairs)
    assert all(b in port.worldmodel.entity_neighbors(a) for a, b in pairs)
    stats = port.profiler.stats()["counter:checkNonAdjacent.nearby.accepted"]
    assert stats["count"] == stats["total"] == len(pairs)
    assert len(port.slam_backend.factors) == len(pairs)
