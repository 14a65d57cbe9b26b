"""``knn_roofline``: K1, the k-NN search (``ops/knn_kernel.py``), as a share of its roofline in
the traced slice: the least time of the shapes its launch counter
(``launches_by_shape``) counted in the slice, at the real sizes of the
map and the queries rather than their padded buffers (``roofline.py``: 8
f32 operations a pair at 67 TFLOP/s, or each byte once at 3.35 TB/s, the
larger) over the device time of its kernels in the trace, in percent."""

import roofline


def read(ctx):
    sl = ctx["slice"]
    if sl is None:
        return None
    return roofline.share_pct("knn", sl.shapes.get("knn", {}), sl.kernel_time, sl.valid)
