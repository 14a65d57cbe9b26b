"""The comparison that decides ``correct`` catches a broken program: a run
driven as the harness drives it (on the CPU, at the rehearsal sizes, the
look for a card skipped), with the timed path broken underneath, comes
out not correct, for each fault the cell can have:

* a step that returns its state unchanged (the query's answer is its
  prior);
* an answer altered where it is produced (a pose moved by 0.5 m).

The stream's cell (``odom-snake``) the same, with the fault in the
front-end's scan-to-map align: the scan's pose left at its guess (the
constant-velocity prediction), and every pose moved by 1 mm.

The cells run on one card, so no exchange between cards can be left out;
no cell takes a mean over a batch (the probe batch's lanes are each
judged by the gate), so there is no half of a batch to leave out."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import run as bench_run
from mola_fe_lidar_tpu_torch.frontend import localizer as loc_mod
from mola_fe_lidar_tpu_torch.frontend import odometry as odo_mod
from mola_fe_lidar_tpu_torch.geometry import se3


def _run(workload: str, seed: int, seconds: int = 12) -> dict:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench_run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                             str(seconds), "--trace", "0", "--rehearse"])
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _localize_fault(monkeypatch, kind: str):
    for name in ("localize", "localize_raw"):
        original = getattr(loc_mod.MapLocalizer, name)

        def broken(self, scan, init, *a, _orig=original, **k):
            res = _orig(self, scan, init, *a, **k)
            R = init.R if kind == "unchanged" else res.pose.R
            t = init.t if kind == "unchanged" else res.pose.t + 0.5
            R, t = _like(R, res.pose.R), _like(t, res.pose.t)
            return res._replace(pose=se3.Pose(R, t))

        monkeypatch.setattr(loc_mod.MapLocalizer, name, broken)


def _like(x, like):
    """``x`` in the container and dtype of ``like`` (a tensor or an array)."""
    import torch
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x),
                               dtype=like.dtype, device=like.device)
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, dtype=like.dtype)


@pytest.mark.parametrize("workload", ["loc-track", "loc-gated"])
@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, kind):
    seed = 2**31 + 99
    sound = _run(workload, seed)
    with monkeypatch.context() as m:
        _localize_fault(m, kind)
        broken = _run(workload, seed)
    assert broken["correct"] is False
    # a compared number past its limit, and far past the sound run's reading
    assert any(c["value"] > c["limit"] and c["value"] > 5 * sound["checks"][n]["value"]
               for n, c in broken["checks"].items())


def _align_fault(monkeypatch, kind: str):
    """The front-end's align returns its guess (``unchanged``) or its
    answer moved by 1 mm along x (``altered``)."""
    original = odo_mod.align_pipeline

    def broken(src, tgt, init_pose, stages, _orig=original):
        res = _orig(src, tgt, init_pose, stages)
        if kind == "unchanged":
            return res._replace(pose=init_pose)
        nudge = torch.tensor([1e-3, 0.0, 0.0], dtype=res.pose.t.dtype, device=res.pose.t.device)
        return res._replace(pose=se3.Pose(res.pose.R, res.pose.t + nudge))

    monkeypatch.setattr(odo_mod, "align_pipeline", broken)


@pytest.fixture(scope="module")
def sound_stream():
    return _run("odom-snake", 2**31 + 7, seconds=8)


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_a_broken_stream_is_not_correct(monkeypatch, sound_stream, kind):
    assert sound_stream["correct"] is True
    with monkeypatch.context() as m:
        _align_fault(m, kind)
        broken = _run("odom-snake", 2**31 + 7, seconds=8)
    assert broken["correct"] is False
    gap = broken["checks"]["pose_gap_median_m"]
    assert gap["value"] > gap["limit"] and gap["value"] > 5 * sound_stream["checks"][
        "pose_gap_median_m"]["value"]
