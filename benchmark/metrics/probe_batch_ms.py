"""``probe_batch_ms``: the host time of the gated query's probe batch, the
mean ``localize.probes`` span (``frontend/localizer.py``: the probes'
pipeline and its read) over the traced slice's queries that reached it.
None where no query of the slice reached the probe batch, or where the
program records no spans."""


def read(ctx):
    from mola_fe_lidar_tpu_torch.utils import profiler
    if ctx["slice"] is None or not hasattr(profiler, "spans"):
        return None
    spans = profiler.spans()
    roots = {s.id for s in spans if s.parent is None and s.name == "localize"}
    probes = [s for s in spans
              if s.name == "localize.probes" and s.request in roots and s.end_ns is not None]
    if not probes:
        return None
    return sum(s.end_ns - s.start_ns for s in probes) / len(probes) * 1e-6
