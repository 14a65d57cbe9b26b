"""``knn_roofline.odom``: K1, the k-NN search (``ops/knn_kernel.py``), as a
share of its roofline in the stream's traced slice: the least time of the
shapes its launch counter (``launches_by_shape``) counted in the slice, at
the real sizes of the scans' layers and of the local map behind the padded
buffers (``roofline.py``), over the device time of its kernels in the
trace, in percent."""

import roofline


def read(ctx):
    sl = ctx["slice"]
    if sl is None or sl.unit != "scan":
        return None
    return roofline.share_pct("knn", sl.shapes.get("knn", {}), sl.kernel_time, sl.valid)
