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


@pytest.mark.parametrize("k", knn_kernel.SUPPORTED_K)
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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 5, 8, 16])
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
