"""``launches_per_query``: CUDA kernel events in the traced slice over the
queries completed in it."""


def read(ctx):
    sl = ctx["slice"]
    if sl is None or sl.unit != "query" or not sl.units or not sl.kernel_launches:
        return None
    return sl.kernel_launches / sl.units
