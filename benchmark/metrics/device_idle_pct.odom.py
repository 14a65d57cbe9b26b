"""``device_idle_pct.odom``: the share of the stream's traced slice (four
scans) in which no operation ran on the device: 100 x (1 - union of the
device operations' intervals / the slice's length)."""


def read(ctx):
    sl = ctx["slice"]
    if sl is None or sl.unit != "scan" or sl.window_s <= 0 or sl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
