"""The plain reference: its closest hits against brute force, and its pixels
and photons against the port's, on tiny scenes on the CPU."""
import importlib

import numpy as np
import pytest
import torch

from benchmark import cell
from benchmark.scenes import height_field
from benchmark.reference import closest_hit

RI = importlib.import_module("benchmark.entries.render_images")


def _brute(v0, e1, e2, o, d):
    """Closest triangle of every ray against every triangle, float64."""
    o, d = o.double(), d.double()
    p = torch.linalg.cross(d[:, None].expand(-1, len(e2), -1), e2[None].expand(len(d), -1, -1))
    det = (p * e1[None]).sum(-1)
    inv = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    tv = o[:, None] - v0[None]
    u = (p * tv).sum(-1) * inv
    q = torch.linalg.cross(tv, e1[None].expand_as(tv))
    v = (q * d[:, None]).sum(-1) * inv
    t = (q * e2[None]).sum(-1) * inv
    ok = (det != 0) & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (u + v <= 1) & (t > 0)
    t = torch.where(ok, t, torch.inf)
    tt, idx = t.min(1)
    return tt, torch.where(torch.isfinite(tt), idx, -1)


@pytest.mark.parametrize("cluster,group", [(4, 64), (4, 2), (128, 64)])
def test_closest_hits_match_brute_force(monkeypatch, cluster, group):
    monkeypatch.setattr(closest_hit, "CLUSTER", cluster)
    monkeypatch.setattr(closest_hit, "GROUP_CLUSTERS", group)
    rs = importlib.import_module("benchmark.reference.loader").Scene(
        height_field.height_field_scene(6, 4, 1))
    v0, e1, e2 = (torch.as_tensor(x) for x in (rs.tri_v0, rs.tri_e1, rs.tri_e2))
    cl = closest_hit.build_clusters(rs.tri_v0, rs.tri_e1, rs.tri_e2, "cpu")
    g = torch.Generator().manual_seed(5)
    o = torch.rand((512, 3), generator=g, dtype=torch.float64) * torch.tensor([12.0, 3, 12]) \
        - torch.tensor([1.0, -0.5, 1])
    d = torch.randn((512, 3), generator=g, dtype=torch.float64)
    d = d / d.norm(dim=1, keepdim=True)
    t, tid = closest_hit.closest_triangles(cl, o, d)
    bt, bid = _brute(v0, e1, e2, o, d)
    assert (tid >= 0).sum() > 100 and (tid < 0).sum() > 50
    assert torch.equal(tid, bid)
    hit = tid >= 0
    assert torch.allclose(t[hit], bt[hit], rtol=1e-12, atol=0)


def test_reference_pixels_and_photons_match_the_port(tiny):
    """Bit for bit on the CPU, where the port's plain traversal and k-NN
    serve: the same Sobol samples through the same arithmetic."""
    workload, config, traffic, check = tiny
    seed = 2**31 + 99
    pixels = RI.sample_pixels(seed, traffic["width"] ** 2, check["pixels"])
    keep = RI.checked_scramble(traffic, seed) if RI._is_pm(config) else None
    run_, frames, maps, _ = RI.measure(config, traffic, 0.0, False, "cpu", 0.0, pixels, keep)
    ref = RI.reference(cell.scene_dict(config, traffic), torch.float32, "cpu")
    nums = RI.check_numbers(ref, config, traffic, check, seed, pixels, frames, maps)
    assert nums["image_rel_l1"] < 1e-6 and nums["pixels_off_share"] == 0.0
    assert nums.get("photons_missing_share", 0.0) == 0.0
    assert nums.get("photons_count_gap", 0.0) == 0.0
    assert np.abs(frames[0][1]).sum() > 0


def test_a_checked_scramble_the_window_never_rendered_is_not_correct():
    """The photon mapper's checked image and maps must come from the window."""
    from conftest import tiny_cell

    config, traffic, check = tiny_cell("pm-hf2m-512-4spp")
    traffic = dict(traffic, image_seeds=[2**31 + 99, 7])
    seed = next(s for s in range(2**31, 2**31 + 64) if RI.checked_scramble(traffic, s) == 7)
    _, nums = cell.run(config, traffic, check, seed, 0.0, False, "cpu", 0.0)
    assert all(v == float("inf") for v in nums.values()), nums
