"""The kernels' work counts, on cases counted by hand. They read the rays,
the scene and the reference's answers only: what a kernel visits cannot
lower them."""
import math

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.reference import closest_hit


@pytest.fixture(params=[64, 1])
def two_squares(monkeypatch, request):
    """Two unit squares in the z = 0 plane, x in [0, 1] and in [5, 6], two
    triangles each, in clusters of two triangles: one cluster a square (in
    one group of clusters, or in one group each)."""
    monkeypatch.setattr(closest_hit, "CLUSTER", 2)
    monkeypatch.setattr(closest_hit, "GROUP_CLUSTERS", request.param)
    v0 = np.array([[0, 0, 0], [1, 1, 0], [5, 0, 0], [6, 1, 0]], np.float64)
    e1 = np.array([[1, 0, 0], [-1, 0, 0], [1, 0, 0], [-1, 0, 0]], np.float64)
    e2 = np.array([[0, 1, 0], [0, -1, 0], [0, 1, 0], [0, -1, 0]], np.float64)
    return closest_hit.build_clusters(v0, e1, e2, "cpu")


def _rays(rows):
    o = torch.tensor([r[0] for r in rows], dtype=torch.float32)
    d = torch.tensor([r[1] for r in rows], dtype=torch.float32)
    return o, d / d.norm(dim=1, keepdim=True)


def test_traversal_work_counted_by_hand(two_squares):
    assert two_squares.lo.shape[0] == 2
    o, d = _rays([((0.25, 0.25, 1), (0, 0, -1)),      # hits the first square: its cluster
                  ((3.0, 0.5, 1), (0, 0, -1)),        # misses everything: no cluster
                  ((0.5, 0.5, 1), (5.0, 0, -1))])     # over the first, hits the second
    ops, bytes_ = roofline.traversal_work(two_squares, o, d)
    assert ops == 2 * (22 + 2 * 38)
    assert bytes_ == 3 * 40 + 2 * (24 + 2 * 36)


def test_traversal_work_reads_only_inputs(two_squares):
    o, d = _rays([((0.25, 0.25, 1), (0, 0, -1)), ((0.5, 0.5, 1), (5.0, 0, -1))])
    want = roofline.traversal_work(two_squares, o, d)
    parked = torch.full((3, 3), 2e30)
    o2 = torch.cat([parked, o.flip(0)])
    d2 = torch.cat([torch.full((3, 3), 0.57735026), d.flip(0)])
    assert roofline.traversal_work(two_squares, o2, d2) == want


def test_knn_work_counted_by_hand():
    pos = torch.tensor([[float(i), 0.0, 0.0] for i in range(10)])
    pts = torch.tensor([[0.0, 0.0, 0.0], [9.0, 0.0, 0.0], [4.0, 0.0, 0.0]])
    mask = torch.tensor([True, True, False])
    ops, bytes_ = roofline.knn_work(pos, pts, mask, 3)
    assert ops == 8 * 6
    assert bytes_ == 2 * 17 + 8 * 6 + 12 * 6


def test_bound_takes_the_larger():
    t, by = roofline.bound_s(67e12, 1.0)
    assert math.isclose(t, 1.0) and by == "operations"
    t, by = roofline.bound_s(1.0, 3.35e12 * 2)
    assert math.isclose(t, 2.0) and by == "bytes"
