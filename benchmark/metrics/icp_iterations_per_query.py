"""``icp_iterations_per_query``: the ICP iterations the host dispatched
for a query, the ``iterations`` counter of every ``icp.align`` span
(``models/icp.py``: blocks x block, lanes counted once) under the traced
slice's ``localize`` / ``localize_raw`` roots, over those roots. None
where the program records no spans or counters."""

ROOTS = ("localize", "localize_raw")


def read(ctx):
    from mola_fe_lidar_tpu_torch.utils import profiler
    if ctx["slice"] is None or not hasattr(profiler, "spans"):
        return None
    spans = profiler.spans()
    roots = {s.id for s in spans if s.parent is None and s.name in ROOTS}
    its = [s.attrs["iterations"] for s in spans
           if s.name == "icp.align" and s.request in roots and "iterations" in s.attrs]
    if not roots or not its:
        return None
    return sum(its) / len(roots)
