"""The operation and byte counts of the roofline shares, on hand-worked
shapes, and the kernel names they are matched to."""

import pytest

import roofline


def test_counts_of_a_query_against_the_map():
    # 4096 sources x 131,072 targets, k = 4, one lane
    assert roofline.search_ops(1, 4096, 131072) == 8 * 4096 * 131072
    assert roofline.search_bytes(1, 4096, 131072, 4) == 16 * (4096 + 131072) + 8 * 4096 * 4
    # compute-bound: 4.29e9 operations at 67 TFLOP/s
    assert roofline.least_seconds(1, 4096, 131072, 4) == pytest.approx(4.294967296e9 / 67e12)


def test_shared_inputs_are_counted_once_and_outputs_per_lane():
    assert roofline.search_bytes(10, 4096, 131072, 1) == 16 * (4096 + 131072) + 8 * 10 * 4096
    assert roofline.search_ops(10, 4096, 131072) == 10 * roofline.search_ops(1, 4096, 131072)


def test_a_byte_bound_shape():
    # 1 source against 8 targets for k = 8: bytes dominate
    ops_s = 8 * 1 * 8 / 67e12
    bytes_s = (16 * 9 + 8 * 8) / 3.35e12
    assert bytes_s > ops_s
    assert roofline.least_seconds(1, 1, 8, 8) == pytest.approx(bytes_s)


@pytest.mark.parametrize("name,kernel", [
    ("void knn_search<4, 2>(KnnArgs)", "knn"),
    ("void knn_search<1, 2>(KnnArgs)", "nn"),
    ("void knn_search_shared<64>(KnnArgs)", "knn"),
    ("_Z10knn_searchILi1ELi1EEv7KnnArgs", "nn"),
    ("_Z10knn_searchILi16ELi2EEv7KnnArgs", "knn"),
    ("void at::native::vectorized_elementwise_kernel<4>", None),
])
def test_kernel_names(name, kernel):
    assert roofline.kernel_of(name) == kernel


def test_padded_sizes_are_counted_at_their_real_sizes():
    # a 131,072-slot map holding 120,000 points, an edges map of 4352
    # slots holding 4300, edges queries of 2048 slots holding 700 on average
    valid = {"n": {4096: 4096, 2048: 700.0}, "m": {131072: 120000, "other": 4300}}
    assert roofline.real_shape((10, 4096, 131072, 4), valid) == (10, 4096, 120000, 4)
    assert roofline.real_shape((1, 2048, 4352, 1), valid) == (1, 700.0, 4300, 1)
    assert roofline.real_shape((1, 2048, 4352, 1), None) == (1, 2048, 4352, 1)
    times = {"void knn_search<1, 2>(KnnArgs)": 1e-3}
    padded = roofline.share_pct("nn", {(1, 4096, 131072, 1): 1}, times)
    real = roofline.share_pct("nn", {(1, 4096, 131072, 1): 1}, times, valid)
    assert real == pytest.approx(padded * 120000 / 131072)


def test_share_of_measured_time():
    shapes = {(1, 4096, 131072, 1): 3}
    least = 3 * roofline.least_seconds(1, 4096, 131072, 1)
    times = {"void knn_search<1, 2>(KnnArgs)": 4 * least, "void knn_search<4, 2>(KnnArgs)": 1.0}
    assert roofline.share_pct("nn", shapes, times) == pytest.approx(25.0)
    assert roofline.share_pct("knn", {}, times) is None
    assert roofline.share_pct("nn", shapes, {}) is None
