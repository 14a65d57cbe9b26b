"""``launches_per_scan``: CUDA kernel events in the traced slice over the
scans completed in it (the stream's scan step, its map rebuilds and the
nearby checks that ran beside it)."""


def read(ctx):
    sl = ctx["slice"]
    if sl is None or sl.unit != "scan" or not sl.units or not sl.kernel_launches:
        return None
    return sl.kernel_launches / sl.units
