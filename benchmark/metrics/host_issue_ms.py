"""``host_issue_ms``: the host time of a query spent issuing work rather
than waiting on the card: each ``localize`` / ``localize_raw`` root span
of the traced slice less its read spans (``localize.read``, ``icp.read``:
the host blocked on a device read), averaged over the slice's queries.
None where the program records no spans."""

ROOTS = ("localize", "localize_raw")
READS = ("localize.read", "icp.read")


def read(ctx):
    from mola_fe_lidar_tpu_torch.utils import profiler
    if ctx["slice"] is None or not hasattr(profiler, "spans"):
        return None
    spans = [s for s in profiler.spans() if s.end_ns is not None]
    issue = {s.id: s.end_ns - s.start_ns for s in spans if s.parent is None and s.name in ROOTS}
    if not issue:
        return None
    for s in spans:
        if s.name in READS and s.request in issue:
            issue[s.request] -= s.end_ns - s.start_ns
    return sum(issue.values()) / len(issue) * 1e-6
