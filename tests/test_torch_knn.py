"""Port parity: the plain twins of the CUDA kernels K1 (k-NN) and K2 (1-NN)
against the reference's XLA search (ops.matching) and its Pallas kernels
(pallas_knn / pallas_nearest_neighbors, run in interpret mode as the
reference's own CPU tests run them); the wrappers' CPU dispatch; and, on a
machine with a CUDA card, the kernels against the twins.

Tolerances: the twins and the Pallas kernels both compute difference-form
f32 distances, so distances agree to 1e-5 m and indices exactly wherever
neighbours are separated; the XLA search uses the norm expansion, whose
cancellation costs up to ~1e-3 m at 30 m scale (its own tests use 1e-3).
Equal distances may be ordered differently by the reference, so indices
are compared only where consecutive distances differ by more than 1e-3 m.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mola_fe_lidar_tpu.ops.matching as jmatching
import mola_fe_lidar_tpu.ops.pallas_knn as pknn
import mola_fe_lidar_tpu.ops.pallas_nn as pnn
from mola_fe_lidar_tpu_torch.ops import knn_kernel, matching, nn_kernel

torch.set_num_threads(1)
SEP = 1e-3
# list lengths that run at a longer compiled one (chip_smoke.NEW_KS)
NEW_KS = (2, 3, 7, 9, 12, 17, 33, 100)


@pytest.fixture
def interp(monkeypatch):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(pknn.pl, "pallas_call", patched)
    monkeypatch.setattr(pnn.pl, "pallas_call", patched)


def _clouds(rng, n=300, m=520, src_valid=0.9, tgt_valid=0.9, scale=30.0):
    src = (rng.standard_normal((n, 3)) * scale).astype(np.float32)
    tgt = (rng.standard_normal((m, 3)) * scale).astype(np.float32)
    sm = (rng.uniform(size=n) < src_valid).astype(np.float32)
    tm = (rng.uniform(size=m) < tgt_valid).astype(np.float32)
    src[sm < 0.5] = 1e6
    tgt[tm < 0.5] = 1e6
    return src, sm, tgt, tm


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _separated(d):
    """Rows whose k distances (and the gap to the sentinel) are all
    separated by more than SEP."""
    d = np.asarray(d)
    if d.ndim == 1:
        return np.ones(d.shape[0], bool)
    return np.all(np.diff(d, axis=1) > SEP, axis=1)


@pytest.mark.parametrize("k", knn_kernel.REGISTER_K + (3, 32))
def test_knn_twin_matches_pallas_and_xla(rng, interp, k):
    src, sm, tgt, tm = _clouds(rng)
    res = matching.knn(*_t(src, sm, tgt, tm), k)
    pal = pknn.pallas_knn(*_j(src, sm, tgt, tm), k=k, src_block=128, tgt_tile=128)
    xla = jmatching.knn(*_j(src, sm, tgt, tm), k=k)
    ok = sm > 0.5
    d = res.dist.numpy()
    assert np.all(np.diff(d[ok], axis=1) >= 0)  # ascending
    np.testing.assert_allclose(d[ok], np.asarray(pal.dist)[ok], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d[ok], np.asarray(xla.dist)[ok], rtol=1e-3, atol=1e-3)
    sep = ok & _separated(d)
    assert sep.mean() > 0.5
    np.testing.assert_array_equal(res.idx.numpy()[sep], np.asarray(pal.idx)[sep])
    np.testing.assert_array_equal(res.idx.numpy()[sep], np.asarray(xla.idx)[sep])
    assert np.all(d[~ok] > 1e14)  # masked sources: the 1e15 sentinel


def test_nn_twin_matches_pallas_and_xla(rng, interp):
    src, sm, tgt, tm = _clouds(rng, m=700)
    res = matching.nearest_neighbors(*_t(src, sm, tgt, tm))
    pi, pd = pnn.pallas_nearest_neighbors(*_j(src, sm, tgt, tm), src_block=128, tgt_tile=128)
    xla = jmatching.nearest_neighbors(*_j(src, sm, tgt, tm))
    ok = sm > 0.5
    np.testing.assert_allclose(res.dist.numpy()[ok], np.asarray(pd)[ok], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res.dist.numpy()[ok], np.asarray(xla.dist)[ok],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(res.idx.numpy()[ok], np.asarray(pi)[ok])
    np.testing.assert_array_equal(res.idx.numpy()[ok], np.asarray(xla.idx)[ok])
    assert np.all(res.dist.numpy()[~ok] > 1e14)


def test_fewer_valid_targets_than_k(interp):
    src = np.zeros((8, 3), np.float32)
    tgt = np.array([[0.1, 0, 0], [0, 0.2, 0]] + [[5.0, 5, 5]] * 6, np.float32)
    tm = np.array([1.0, 1.0] + [0.0] * 6, np.float32)
    res = matching.knn(*_t(src, np.ones(8, np.float32), tgt, tm), 4)
    pal = pknn.pallas_knn(*_j(src, np.ones(8, np.float32), tgt, tm), k=4,
                          src_block=128, tgt_tile=128)
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(pal.idx))
    np.testing.assert_allclose(res.dist.numpy(), np.asarray(pal.dist), rtol=1e-6)
    assert np.all(res.dist.numpy()[:, 2:] > 1e14)
    assert np.all(res.idx.numpy()[:, 2:] == 0)


def test_fewer_targets_than_k_and_duplicates():
    src = np.zeros((3, 3), np.float32)
    tgt = np.array([[0.1, 0, 0]] * 3 + [[9.0, 9, 9]] * 2, np.float32)
    res = matching.knn(*_t(src, np.ones(3, np.float32), tgt, np.ones(5, np.float32)), 8)
    np.testing.assert_allclose(res.dist.numpy()[:, :3], 0.1, atol=1e-6)
    assert res.idx.numpy()[0, :3].tolist() == [0, 1, 2]  # ties: lower index first
    assert np.all(res.dist.numpy()[:, 5:] > 1e14)


def test_masked_targets_never_win(rng):
    src = np.zeros((4, 3), np.float32)
    tgt = np.array([[0.01, 0, 0]] + [[5.0, 5, 5]] * 7, np.float32)
    tm = np.array([0.0] + [1.0] * 7, np.float32)
    res = matching.nearest_neighbors(*_t(src, np.ones(4, np.float32), tgt, tm))
    assert np.all(res.idx.numpy() != 0)
    empty = matching.nearest_neighbors(*_t(src, np.ones(4, np.float32), tgt, np.zeros(8, np.float32)))
    assert np.all(empty.dist.numpy() > 1e14) and np.all(empty.idx.numpy() == 0)


def test_wrappers_take_the_twin_on_cpu(rng):
    src, sm, tgt, tm = _clouds(rng, n=50, m=90)
    before = (knn_kernel.launches, nn_kernel.launches)
    a = knn_kernel.knn(*_t(src, sm, tgt, tm), 5)
    b = matching.knn(*_t(src, sm, tgt, tm), 5)
    assert torch.equal(a.idx, b.idx) and torch.equal(a.dist, b.dist)
    c = nn_kernel.nearest_neighbors(*_t(src, sm, tgt, tm))
    assert torch.equal(c.idx, matching.nearest_neighbors(*_t(src, sm, tgt, tm)).idx)
    assert (knn_kernel.launches, nn_kernel.launches) == before  # twins are not launches
    with pytest.raises(ValueError):
        knn_kernel.knn(*(x.to("meta") for x in _t(src, sm, tgt, tm)), 5)


@pytest.mark.parametrize("k", [6, 10])
def test_self_knn_with_duplicates(rng, interp, k):
    """Source = target (the normal and GICP filters) on a grid: every point
    is its own nearest neighbour, and duplicates tie at d² = 0. The k
    smallest distances are the same multiset as the Pallas kernel's; the
    twin (and, bit for bit, the CUDA kernel) orders equal distances by
    target index, where Pallas orders them by its tile merge. So indices
    are held equal to Pallas only on rows without a tie at the k-th place,
    and the twin's own order is checked."""
    xyz = rng.integers(-3, 4, (400, 3)).astype(np.float32)
    xyz[200:] += (rng.standard_normal((200, 3)) * 0.3).astype(np.float32)
    mask = (rng.uniform(size=400) < 0.9).astype(np.float32)
    xyz[mask < 0.5] = 1e6
    res = matching.knn(*_t(xyz, mask, xyz, mask), k)
    pal = pknn.pallas_knn(*_j(xyz, mask, xyz, mask), k=k, src_block=128, tgt_tile=128)
    ok = mask > 0.5
    d, idx = res.dist.numpy()[ok], res.idx.numpy()[ok]
    np.testing.assert_allclose(d, np.asarray(pal.dist)[ok], rtol=1e-6)
    assert np.all(d[:, 0] == 0.0)
    # (d², index) ascending, and each index at its reported distance
    assert np.all((np.diff(d, axis=1) > 0) | ((np.diff(d, axis=1) == 0) & (np.diff(idx, axis=1) > 0)))
    src = np.where(ok)[0]
    np.testing.assert_allclose(np.linalg.norm(xyz[idx] - xyz[src, None], axis=-1), d, atol=1e-6)
    nxt = matching.knn(*_t(xyz, mask, xyz, mask), k + 1).dist.numpy()[ok, k]
    clear = np.all(np.diff(d, axis=1) > 0, axis=1) & (nxt > d[:, -1])
    assert 0.1 < clear.mean() < 1.0  # both tie-free and tied rows are present
    np.testing.assert_array_equal(idx[clear], np.asarray(pal.idx)[ok][clear])


@pytest.mark.cuda
@pytest.mark.parametrize("k", knn_kernel.COMPILED_K + NEW_KS)
def test_cuda_kernels_match_twins(rng, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py, or pytest -m cuda on one)")
    src, sm, tgt, tm = (torch.from_numpy(x).cuda() for x in _clouds(rng, n=3000, m=20000))
    got = knn_kernel.knn(src, sm, tgt, tm, k)
    want = matching.knn(src, sm, tgt, tm, k)
    # bit-identical by construction (same f32 operation order, same ties)
    assert torch.equal(got.idx, want.idx) and torch.equal(got.dist, want.dist)
    got1 = nn_kernel.nearest_neighbors(src, sm, tgt, tm)
    want1 = matching.nearest_neighbors(src, sm, tgt, tm)
    assert torch.equal(got1.idx, want1.idx) and torch.equal(got1.dist, want1.dist)


# ---------------------------------------------------------------------------
# The launch plan (pure Python) and the search it drives, emulated on the CPU

MAIN_SHAPES = [(8192, 32768, 4), (2048, 8192, 8), (2048, 8192, 5), (2048, 2048, 5),
               (1024, 32768, 1), (8192, 32768, 1), (8192, 8192, 1),
               (4096, 131072, 4), (4096, 131072, 1)]  # the map localizer's
EDGE_SHAPES = [(1, 1, 1), (777, 37, 4), (300, 1, 16), (5, 26, 8), (100_000, 300, 5),
               (3, 70_000, 4), (129, 2500, 1), (777, 2500, 128), (2048, 8192, 33),
               (5, 26, 3)]


def _all_plans(n, m, k):
    yield knn_kernel.plan_launch(n, m, k, 132)
    for r in knn_kernel.rows_for(k):
        for c in knn_kernel.CLUSTERS:
            for stage in (knn_kernel.STAGE_TARGETS, 64):
                yield knn_kernel.make_plan(n, m, k, r, c, stage)


@pytest.mark.parametrize("n,m,k", MAIN_SHAPES + EDGE_SHAPES)
def test_plan_covers_every_target_once_in_order(n, m, k):
    for plan in _all_plans(n, m, k):
        assert 1 <= plan.cluster <= 8  # portable cluster sizes only
        assert plan.part_len % knn_kernel.STEP_ALIGN == 0
        assert plan.chunk % knn_kernel.STEP_ALIGN == 0 and plan.chunk <= plan.part_len
        assert plan.tiles * plan.tile >= n and (plan.tiles - 1) * plan.tile < n
        assert plan.smem <= 232448
        # parts in launch order (cluster rank major, warp minor), each
        # streamed in chunks: every target index exactly once, ascending
        seen = []
        for rank in range(plan.cluster):
            for w in range(knn_kernel.WARPS):
                p0 = (rank * knn_kernel.WARPS + w) * plan.part_len
                for off in range(0, plan.part_len, plan.chunk):
                    hi = min(p0 + off + min(plan.chunk, plan.part_len - off), m)
                    seen.extend(range(p0 + off, hi))
        assert seen == list(range(m))


@pytest.mark.parametrize("n,m,k", MAIN_SHAPES)
def test_plan_fills_the_card_at_main_path_shapes(n, m, k):
    plan = knn_kernel.plan_launch(n, m, k, 132)
    assert plan.blocks * knn_kernel.THREADS // 32 >= 2 * 132
    assert plan == knn_kernel.plan_launch(n, m, k, 132)  # a pure function


def test_plan_rejects_unsupported_k():
    for k in (0, knn_kernel.MAX_K + 1):
        with pytest.raises(ValueError):
            knn_kernel.plan_launch(10, 10, k, 132)
    with pytest.raises(ValueError):  # shared-memory lists take R = 1 only
        knn_kernel.make_plan(10, 10, 32, 2, 1)


def test_every_k_plans_for_its_compiled_length():
    """Each k <= 128 runs at the smallest compiled length >= k, with that
    length's plan (R = 1 for the shared-memory lists), within a block's
    shared memory at every cluster size and staging budget."""
    for k in range(1, knn_kernel.MAX_K + 1):
        kc = knn_kernel.compiled_k(k)
        assert kc >= k and kc in knn_kernel.COMPILED_K
        assert not any(k <= c < kc for c in knn_kernel.COMPILED_K)
        for n, m in ((2048, 8192), (4096, 131072), (10, 10)):
            plan = knn_kernel.plan_launch(n, m, k, 132)
            assert plan == knn_kernel.plan_launch(n, m, kc, 132)
            assert plan.rows in knn_kernel.rows_for(k)
        for c in knn_kernel.CLUSTERS:
            for stage in (0, knn_kernel.STAGE_TARGETS, 64):
                assert knn_kernel.make_plan(777, 2500, k, 1, c, stage).smem <= 232448
    assert knn_kernel.rows_for(17) == (1,) and knn_kernel.rows_for(16) == knn_kernel.ROWS


@pytest.mark.parametrize("k", NEW_KS)
def test_routed_length_is_the_compiled_lists_prefix(rng, k):
    """The first k columns of the twin at the compiled length are the twin
    at k, also with fewer valid targets (and fewer targets) than k: the
    sentinel fill comes after every real neighbour."""
    kc = knn_kernel.compiled_k(k)
    for m, valid in ((520, 0.9), (k + 3, 0.3), (max(1, k // 2), 1.0)):
        src, sm, tgt, tm = _t(*_clouds(rng, n=60, m=m, tgt_valid=valid))
        want = matching.knn(src, sm, tgt, tm, k)
        got = matching.knn(src, sm, tgt, tm, kc)
        assert torch.equal(got.idx[:, :k], want.idx) and torch.equal(got.dist[:, :k], want.dist)


def _sqd(s, t):
    d = (s - t).astype(np.float32)
    return np.float32(np.float32(d[0] * d[0] + d[1] * d[1]) + np.float32(d[2] * d[2]))


def _insert(lst, v, i, lex):
    """The kernel's shift insertion: before the first entry it beats."""
    below = [v < d or (lex and v == d and i < j) for d, j in lst]
    if below[-1]:
        lst.insert(below.index(True), (v, i))
        lst.pop()


def _emulate(src, sm, tgt, tm, k, plan):
    """``csrc/knn_common.cuh::knn_search`` in Python: per part and chunk,
    the K best steps by step minimum, their exact rescan in (d2, index)
    order, then the merge of the parts in launch order."""
    big, step = np.float32(1e30), knn_kernel.step_len(k)
    m = tgt.shape[0]
    s_all = np.where(sm[:, None] > 0.5, src, 0).astype(np.float32)
    t_all = np.where(tm[:, None] > 0.5, tgt, 3e4).astype(np.float32)
    idx = np.zeros((src.shape[0], k), np.int32)
    dist = np.zeros((src.shape[0], k), np.float32)
    for i, s in enumerate(s_all):
        d_all = np.array([_sqd(s, t) for t in t_all] + [np.inf] * step, np.float32)
        merged = [(big, 0)] * k
        for p in range(plan.parts):
            lst = [(big, 0)] * k
            for off in range(0, plan.part_len, plan.chunk):
                base = p * plan.part_len + off
                # the scan stops at the first step that is all padding
                live = min(plan.chunk, plan.part_len - off, -(-max(0, m - base) // step) * step)
                steps = [(big, 0)] * k
                for j in range(0, live, step):
                    _insert(steps, np.float32(min(d_all[base + j:base + j + step])), j // step, False)
                for dmin, js in steps:
                    if dmin < big:
                        for u in range(step):
                            g = base + js * step + u
                            if d_all[g] <= steps[-1][0]:
                                _insert(lst, d_all[g], g, True)
            for v, g in lst:
                _insert(merged, v, g, False)
        for q, (v, g) in enumerate(merged):
            g = min(g, m - 1)
            if v > 1e8:
                v, g = big, 0
            dist[i, q] = np.sqrt(np.float32(v if sm[i] > 0.5 else big))
            idx[i, q] = g
    return idx, dist


def _tie_clouds(rng, n, m, extent=2):
    """Integer grid points in a small box: squared distances are exact and
    equal distances straddle every part and cluster-rank boundary."""
    src = rng.integers(-extent, extent + 1, (n, 3)).astype(np.float32)
    tgt = rng.integers(-extent, extent + 1, (m, 3)).astype(np.float32)
    sm = (rng.uniform(size=n) < 0.9).astype(np.float32)
    tm = (rng.uniform(size=m) < 0.9).astype(np.float32)
    src[sm < 0.5] = 1e6
    tgt[tm < 0.5] = 1e6
    return src, sm, tgt, tm


@pytest.mark.parametrize("k", knn_kernel.REGISTER_K)
def test_emulated_search_is_the_twin_under_ties(rng, k):
    src, sm, tgt, tm = _tie_clouds(rng, 24, 300)
    want = matching.knn(*_t(src, sm, tgt, tm), k)
    for plan in (knn_kernel.make_plan(24, 300, k, 1, 8),   # 32 parts, some empty
                 knn_kernel.make_plan(24, 300, k, 1, 2, 64),  # streamed in chunks
                 knn_kernel.plan_launch(24, 300, k, 132)):
        idx, dist = _emulate(src, sm, tgt, tm, k, plan)
        np.testing.assert_array_equal(idx, want.idx.numpy())
        np.testing.assert_array_equal(dist, want.dist.numpy())


def _emulate_shared(src, sm, tgt, tm, k, plan):
    """``csrc/knn_common.cuh::knn_search_shared`` in Python: per part, every
    target in index order into a list by strict '<' against its k-th entry
    and a shift that stops at an equal distance, then the k-way merge of
    the parts' lists (strict '<', parts in launch order)."""
    big = np.float32(1e30)
    m = tgt.shape[0]
    s_all = np.where(sm[:, None] > 0.5, src, 0).astype(np.float32)
    t_all = np.where(tm[:, None] > 0.5, tgt, 3e4).astype(np.float32)
    idx = np.zeros((src.shape[0], k), np.int32)
    dist = np.zeros((src.shape[0], k), np.float32)
    for i, s in enumerate(s_all):
        lists = []
        for p in range(plan.parts):
            lst = [(big, 0)] * k
            for g in range(p * plan.part_len, min((p + 1) * plan.part_len, m)):
                d2 = _sqd(s, t_all[g])
                if d2 < lst[-1][0]:
                    at = k - 1
                    while at > 0 and lst[at - 1][0] > d2:
                        at -= 1
                    lst = lst[:at] + [(d2, g)] + lst[at:-1]
            lists.append(lst)
        heads = [0] * plan.parts
        for q in range(k):
            bp = None
            for p in range(plan.parts):
                if heads[p] < k and (bp is None or lists[p][heads[p]][0] < lists[bp][heads[bp]][0]):
                    bp = p
            v, g = lists[bp][heads[bp]]
            heads[bp] += 1
            g = min(g, m - 1)
            if v > 1e8:
                v, g = big, 0
            dist[i, q] = np.sqrt(np.float32(v if sm[i] > 0.5 else big))
            idx[i, q] = g
    return idx, dist


@pytest.mark.parametrize("k", knn_kernel.SHARED_K[:1])
def test_emulated_shared_search_is_the_twin_under_ties(rng, k):
    src, sm, tgt, tm = _tie_clouds(rng, 12, 300)
    for m, plan in ((300, knn_kernel.make_plan(12, 300, k, 1, 8)),   # 32 parts, some empty
                    (20, knn_kernel.make_plan(12, 20, k, 1, 1)),     # fewer targets than k
                    (300, knn_kernel.plan_launch(12, 300, k, 132))):
        want = matching.knn(*_t(src, sm, tgt[:m], tm[:m]), k)
        idx, dist = _emulate_shared(src, sm, tgt[:m], tm[:m], k, plan)
        np.testing.assert_array_equal(idx, want.idx.numpy())
        np.testing.assert_array_equal(dist, want.dist.numpy())


def test_entry_points_default_to_the_card():
    import inspect

    from mola_fe_lidar_tpu_torch.cloud import metric_map
    from mola_fe_lidar_tpu_torch.filters import generators
    from mola_fe_lidar_tpu_torch.frontend.localizer import MapLocalizer
    from mola_fe_lidar_tpu_torch.frontend.odometry import LidarOdometry
    from mola_fe_lidar_tpu_torch.frontend.worldmodel import WorldModel
    from mola_fe_lidar_tpu_torch.obs import runner

    for fn in (LidarOdometry.__init__, WorldModel.__init__, MapLocalizer.__init__,
               runner.build_module, runner.run_replay,
               generators.GeneratorRawPoints.__init__, generators.generators_from_config,
               metric_map.from_points, metric_map.from_numpy_layers,
               metric_map.load_metric_map):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default) == torch.device("cuda"), fn
    assert torch.device(runner.parser().parse_args([]).device) == torch.device("cuda")


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py, or pytest -m cuda on one)")


@pytest.mark.cuda
@pytest.mark.parametrize("k", knn_kernel.COMPILED_K + (3, 100))
def test_cuda_every_plan_matches_twin_at_edges(k):
    """Every compiled R and cluster size, and the wrappers, bit for bit:
    ties across part and cluster-rank boundaries with n not a multiple of
    any tile, m below one part and m = 1, all targets masked, chunked
    staging (the battery ``chip_smoke.py`` runs)."""
    _cuda_or_skip()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.check_plans(torch.device("cuda", 0), ks=(k,)) > 0
