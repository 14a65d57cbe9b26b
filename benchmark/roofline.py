"""The yardstick of the kernels' roofline shares: the published peaks of
one H100 and the operations and bytes an exact nearest-neighbour search
needs, counted from its shape alone (whatever implementation ran).

A search of ``n`` sources against ``m`` targets for the ``k`` nearest, in
``B`` lanes: each (source, target) pair costs 8 f32 operations (three
differences, three products, two sums); each input byte is read once and
each output byte written once. An input the lanes share (the localizer's
probe batch expands one scan and one map over its lanes) is read once, so
inputs are counted once and outputs once a lane: the byte count never
exceeds what the call needs. The least time is the larger of operations
over the f32 peak (no tensor cores) and bytes over the memory bandwidth.

A launch's shape gives its buffers' padded sizes; only real points need
work, so each padded size is replaced by the real size the feed reports
for that buffer (``valid``) before anything is counted.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
OPS_PER_PAIR = 8
POINT_BYTES = 16       # x, y, z and the validity mask, f32 each
NEIGHBOUR_BYTES = 8    # a squared distance (f32) and an index (i32)

# the search kernels' names in a trace: ``knn_search<K, R>`` or
# ``knn_search_shared<K>`` (demangled or mangled); K = 1 is K2, any other K1
_KERNEL = re.compile(r"knn_search(?:_shared)?(?:<|ILi)(\d+)")


def search_ops(batch: int, n: int, m: int) -> float:
    return float(OPS_PER_PAIR) * batch * n * m


def search_bytes(batch: int, n: int, m: int, k: int) -> float:
    return float(POINT_BYTES) * (n + m) + float(NEIGHBOUR_BYTES) * batch * n * k


def least_seconds(batch: int, n: int, m: int, k: int) -> float:
    return max(search_ops(batch, n, m) / PEAK_F32_FLOPS,
               search_bytes(batch, n, m, k) / PEAK_HBM_BYTES_PER_S)


def kernel_of(name: str) -> Optional[str]:
    """``"nn"`` (K2), ``"knn"`` (K1) or None for a kernel name."""
    found = _KERNEL.search(name)
    if found is None:
        return None
    return "nn" if found.group(1) == "1" else "knn"


def real_shape(shape: Tuple[int, int, int, int], valid: Optional[dict]):
    """(B, n, m, k) with the padded source and target sizes replaced by
    the real ones: ``valid["pairs"]["<n>x<m>"]`` for a pair of buffers
    named there, else ``valid["n"][n]``, and ``valid["m"][m]`` or, for a
    target buffer not named there, ``valid["m"]["other"]``. Without
    ``valid`` every slot counts."""
    b, n, m, k = shape
    if not valid:
        return shape
    pair = valid.get("pairs", {}).get(f"{n}x{m}")
    if pair is not None:
        return (b, pair[0], pair[1], k)
    sizes_m = valid.get("m", {})
    return (b, valid.get("n", {}).get(n, n), sizes_m.get(m, sizes_m.get("other", m)), k)


def share_pct(kernel: str, shapes: Dict[Tuple[int, int, int, int], int],
              kernel_time: Dict[str, float], valid: Optional[dict] = None) -> Optional[float]:
    """Least time of the launched shapes, at their real sizes, over the
    kernel's measured device time, in percent; None when the slice
    launched none of it."""
    measured = sum(t for name, t in kernel_time.items() if kernel_of(name) == kernel)
    least = sum(c * least_seconds(*real_shape(shape, valid)) for shape, c in shapes.items())
    if measured <= 0 or least <= 0:
        return None
    return 100.0 * least / measured

