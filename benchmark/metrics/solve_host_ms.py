"""``solve_host_ms``: the host time of one ICP iteration's solve
(``_solve``, the freeze and the convergence test; Horn's float64 SVD in
the localizer), the ``icp.solve`` spans of the traced slice's queries
(``models/icp.py``) summed over the iterations dispatched (the
``icp.align`` spans' ``iterations``). Host time: the spans do not wait for
the card. None where the program records no spans or counters."""

ROOTS = ("localize", "localize_raw")


def read(ctx):
    from mola_fe_lidar_tpu_torch.utils import profiler
    if ctx["slice"] is None or not hasattr(profiler, "spans"):
        return None
    spans = profiler.spans()
    roots = {s.id for s in spans if s.parent is None and s.name in ROOTS}
    mine = [s for s in spans if s.request in roots]
    its = sum(s.attrs.get("iterations", 0) for s in mine if s.name == "icp.align")
    ns = sum(s.end_ns - s.start_ns for s in mine
             if s.name == "icp.solve" and s.end_ns is not None)
    if not its or not ns:
        return None
    return ns / its * 1e-6
