"""Device meshes (port of ``mola_fe_lidar_tpu/parallel/mesh.py``).

The reference scales scan-pair work over a ``jax.sharding.Mesh``: batches
shard over a ``data`` axis and the target point axis of one cloud over a
``model`` axis, with one program placed across the devices by a single
controller. The port keeps that single-process design: a :class:`Mesh` is
an array of ``torch.device`` positions, one process issues each
position's launches in turn, and a "collective" is a copy to the lead
position (``devices.flat[0]``) followed by a merge. A position is not
necessarily a distinct card: :func:`force_device_count` lays ``n``
positions over the cards there are (the analogue of the reference's
``--xla_force_host_platform_device_count`` / ``jax_num_cpu_devices``), so
a mesh runs, positions sharing one device, wherever one device exists.

There is no sharded tensor type. :func:`shard_batch` returns the
per-position slices of a batch (a list), where the reference returns one
array sharded over the mesh; ``make_batched_align(params, mesh)`` takes
either those slices or the whole batch, and returns the whole result on
the lead position (the reference's ``tests/test_parallel.py::
test_sharded_batch_over_mesh`` asserts a result sharded over the mesh).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_forced_count: Optional[int] = None


def force_device_count(n: Optional[int]) -> Optional[int]:
    """Make :func:`devices` return ``n`` positions, position i on device
    ``i % count`` of the real list; ``None`` restores the real list.
    Returns the previous setting."""
    global _forced_count
    if n is not None and n < 1:
        raise ValueError(f"force_device_count needs n >= 1, got {n}")
    previous, _forced_count = _forced_count, n
    return previous


def devices(kind: str = "cuda") -> List[torch.device]:
    """The process's device list: the CUDA cards (``kind="cuda"``) or one
    CPU position, laid over :func:`force_device_count` positions when set."""
    if kind == "cuda":
        real = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        real = [torch.device("cpu")]
    else:
        raise ValueError(f"unknown device kind {kind!r}")
    if _forced_count is None or not real:
        return real
    return [real[i % len(real)] for i in range(_forced_count)]


_device_list = devices  # the list function, where a parameter is named ``devices``


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over an object array of ``torch.device`` positions."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The positions along ``axis`` with every other axis at 0."""
        at = [slice(None) if a == axis else 0 for a in self.axis_names]
        return list(self.devices[tuple(at)].reshape(-1))


def make_mesh(axes: Dict[str, int], devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Build a mesh from ``{"data": 4, "model": 2}``-style axis sizes over
    the first devices of ``devices`` (default: the CUDA device list)."""
    devs = list(devices) if devices is not None else _device_list()
    n = int(np.prod(list(axes.values())))
    if n > len(devs):
        raise ValueError(f"mesh needs {n} devices, have {len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(tuple(axes.values())), tuple(axes.keys()))


def default_mesh(devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """1-D data mesh over every device of the list."""
    devs = list(devices) if devices is not None else _device_list()
    return make_mesh({"data": len(devs)}, devs)


def tree_map(fn: Callable, *trees):
    """``fn`` over the tensor leaves of trees of one structure (dicts,
    lists, tuples and named tuples); other leaves come from the first."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return t


def _leading(tree) -> int:
    found = []
    tree_map(lambda x: found.append(x.shape[0]), tree)
    if not found:
        raise ValueError("a batch needs at least one tensor")
    return found[0]


def pad_batch(tree, multiple: int):
    """Pad every leaf's leading axis with zeros to a multiple (for even
    sharding). Returns (padded_tree, original_batch)."""
    b = _leading(tree)
    pad = (-b) % multiple
    if pad == 0:
        return tree, b
    return tree_map(lambda x: torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]), tree), b


def shard_batch(mesh: Mesh, tree, axis: str = "data") -> list:
    """The leading axis of every leaf split into one contiguous slice per
    position of ``axis``, each slice on its position's device (a view
    where it is already there). The batch must divide by the axis size."""
    devs = mesh.axis_devices(axis)
    b = _leading(tree)
    if b % len(devs):
        raise ValueError(f"batch {b} does not divide over the {len(devs)} positions of {axis!r}")
    per = b // len(devs)
    return [tree_map(lambda x: x.narrow(0, i * per, per).to(dev), tree)
            for i, dev in enumerate(devs)]


def run_per_position(fn: Callable, args: Sequence[tuple], positions: Sequence[torch.device]):
    """``[fn(*a) for a in args]``, where ``args[i]`` lives on
    ``positions[i]``: the positions of one device run in order; distinct
    CUDA cards each run from a thread of their own, so that they overlap."""
    groups: Dict[torch.device, List[int]] = defaultdict(list)
    for i, dev in enumerate(positions):
        groups[dev].append(i)
    out: list = [None] * len(args)

    def run(dev, idxs):
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            for i in idxs:
                out[i] = fn(*args[i])

    if len(groups) == 1 or any(dev.type != "cuda" for dev in groups):
        for dev, idxs in groups.items():
            run(dev, idxs)
        return out
    with ThreadPoolExecutor(len(groups), thread_name_prefix="mesh") as pool:
        for fut in [pool.submit(run, dev, idxs) for dev, idxs in groups.items()]:
            fut.result()
    return out


def gather_batch(parts: Sequence, device: torch.device):
    """Per-position results back on ``device``, concatenated along the
    leading (lane) axis in position order."""
    return tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]), *parts)
