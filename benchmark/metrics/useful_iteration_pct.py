"""``useful_iteration_pct``: the share of the dispatched lane iterations
that a lane needed, 100 x the lanes' final iteration counts
(``lane_iterations``) over lanes x dispatched ``iterations``, summed over
the ``icp.align`` spans of the traced slice's queries (``models/icp.py``).
A block of 4 runs past convergence, and a probe batch runs until its
slowest lane: the rest is frozen work. None where the program records no
spans or counters."""

ROOTS = ("localize", "localize_raw")


def read(ctx):
    from mola_fe_lidar_tpu_torch.utils import profiler
    if ctx["slice"] is None or not hasattr(profiler, "spans"):
        return None
    spans = profiler.spans()
    roots = {s.id for s in spans if s.parent is None and s.name in ROOTS}
    aligns = [s.attrs for s in spans
              if s.name == "icp.align" and s.request in roots and "lane_iterations" in s.attrs]
    dispatched = sum(a["lanes"] * a["iterations"] for a in aligns)
    if not dispatched:
        return None
    return 100.0 * sum(a["lane_iterations"] for a in aligns) / dispatched
