"""Checkpoint and resume of the odometry front-end (port of
``mola_fe_lidar_tpu/frontend/checkpoint.py``), in the reference's on-disk
format, so either package resumes the other's checkpoints:

* ``state.json``: twist, damped twist, world pose, keyframe bookkeeping,
  the local pose graph (nodes, root, edges) and the checked pairs;
* ``last_points.npz``: the last filtered scan (``save_metric_map`` keys);
* ``keyframes/kf_XXXXXXXX.npz`` and ``worldmodel.json``: every keyframe's
  layered cloud and the keyframe neighbours.

The rolling local map is not saved: after a resume in ``local_map`` mode
the scans align to the last scan until the next keyframe reseeds the map.
Loaded clouds go to the module's device.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from ..cloud.metric_map import load_metric_map, save_metric_map
from .pose_graph import make_pose_graph
from .worldmodel import ANNOTATION_NAME_PC_LAYERS

if TYPE_CHECKING:
    from .odometry import LidarOdometry


def save_checkpoint(module: "LidarOdometry", ckpt_dir: str) -> None:
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    st = module.state
    with module._state_lock:
        graph = st.local_pose_graph
        edges = [{"a": int(a), "b": int(b), "R": np.asarray(R).tolist(),
                  "t": np.asarray(t).tolist()} for (a, b, R, t) in st.edge_log]
        nodes = sorted(int(n) for n in graph.nodes)
        checked = sorted([list(p) for p in st.checked_KF_pairs])
    meta = {
        "last_obs_tim": st.last_obs_tim,
        "twist": np.asarray(st.twist).tolist(),
        "twist_is_good": bool(st.twist_is_good),
        "twist_smooth": np.asarray(st.twist_smooth).tolist(),
        "twist_smooth_age": int(st.twist_smooth_age),
        "world_R": np.asarray(st.world_R).tolist(),
        "world_t": np.asarray(st.world_t).tolist(),
        "last_kf": st.last_kf,
        "accum_R": np.asarray(st.accum_since_last_kf_R).tolist(),
        "accum_t": np.asarray(st.accum_since_last_kf_t).tolist(),
        "kf_decor_counter": int(st.kf_decor_counter),
        "mc_seed": int(st.mc_seed),
        "graph_nodes": nodes,
        "graph_edges": edges,
        "graph_root": graph.root,
        "checked_KF_pairs": checked,
    }
    (d / "state.json").write_text(json.dumps(meta))
    if st.last_points is not None:
        save_metric_map(str(d / "last_points.npz"), st.last_points)
    wm = module.worldmodel
    if wm is not None:
        kf_dir = d / "keyframes"
        kf_dir.mkdir(exist_ok=True)
        for kf in wm.entities():
            mm = wm.annotation(kf, ANNOTATION_NAME_PC_LAYERS)
            if mm is not None:
                save_metric_map(str(kf_dir / f"kf_{kf:08d}.npz"), mm)
        neigh = {str(k): sorted(wm.entity_neighbors(k)) for k in wm.entities()}
        (d / "worldmodel.json").write_text(json.dumps(
            {"entities": wm.entities(), "neighbors": neigh}))


def load_checkpoint(module: "LidarOdometry", ckpt_dir: str) -> None:
    d = Path(ckpt_dir)
    meta = json.loads((d / "state.json").read_text())
    module.reset()
    st = module.state
    st.last_obs_tim = meta["last_obs_tim"]
    st.twist = np.asarray(meta["twist"], np.float64)
    st.twist_is_good = meta["twist_is_good"]
    if "twist_smooth" in meta:  # older checkpoints predate the damped twist
        st.twist_smooth = np.asarray(meta["twist_smooth"], np.float64)
        st.twist_smooth_age = int(meta["twist_smooth_age"])
    if "world_R" in meta:
        st.world_R = np.asarray(meta["world_R"], np.float64)
        st.world_t = np.asarray(meta["world_t"], np.float64)
    st.last_kf = meta["last_kf"]
    st.accum_since_last_kf_R = np.asarray(meta["accum_R"], np.float64)
    st.accum_since_last_kf_t = np.asarray(meta["accum_t"], np.float64)
    st.kf_decor_counter = meta["kf_decor_counter"]
    st.mc_seed = meta["mc_seed"]
    st.checked_KF_pairs = {tuple(p) for p in meta["checked_KF_pairs"]}
    g = make_pose_graph()
    # the saved root first: the graph adopts the first node as its root
    if meta.get("graph_root") is not None:
        g.insert_node(int(meta["graph_root"]))
    for n in meta["graph_nodes"]:
        g.insert_node(n)
    for e in meta["graph_edges"]:
        R, t = np.asarray(e["R"]), np.asarray(e["t"])
        g.insert_edge(e["a"], e["b"], R, t)
        st.edge_log.append((e["a"], e["b"], R, t))
    with module._state_lock:
        st.local_pose_graph = g
    lp = d / "last_points.npz"
    if lp.exists():
        st.last_points = load_metric_map(str(lp), device=module.device)
    wm = module.worldmodel
    wm_meta = d / "worldmodel.json"
    if wm is not None and wm_meta.exists():
        info = json.loads(wm_meta.read_text())
        for kf in info["entities"]:
            wm.add_entity(int(kf))
            f = d / "keyframes" / f"kf_{int(kf):08d}.npz"
            if f.exists():
                wm.annotate(int(kf), ANNOTATION_NAME_PC_LAYERS,
                            load_metric_map(str(f), device=module.device))
        for k, ns in info["neighbors"].items():
            for nb in ns:
                wm.add_neighbors(int(k), int(nb))
