"""The reference's train step: the L2 image loss of a path-traced image against
a target, and its gradients with respect to material tables, by reverse mode.

A plain counterpart of mcrt_tpu_torch's `parallel.sharding.train_step`: camera
rays of the given (px, py, si), the path tracer of tracer.py run with autograd
on (the closest hits found on detached rays and re-evaluated from the real
ones, as the port detaches its traversal; the Sobol decisions are integer
functions of the path's indices), the samples splatted into a film by the
box filter, the film scanned to an image, and loss = mean((image -
target)^2). `sgd` is the reference's update of the tables, which the check
holds the port's updated tables to. Nothing of the port and nothing of JAX
is imported.

The paths are traced in blocks of `block` so that a step of 512 x 512 fits:
the whole film first, without autograd; then the cotangent of the film,
d loss / d film, through the scan and the loss at that film; then, block by
block, the vector-Jacobian product of that cotangent with the block's own
splat, summed over the blocks. The film is the sum of the blocks' splats, so
this is the gradient of the whole step whatever the filter's radius.

TF32 is off for the process's matrix products (a float32 product may
otherwise run in a lower precision on the card).
"""
from __future__ import annotations

import math

import torch

from . import camera as cam_mod
from . import closest_hit, common, tracer
from . import loader as ref_loader

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK = 65536   # paths traced at once
RANGES = {"mat_reflectance": (0.0, 1.0), "mat_specular_roughness": (1e-3, 1.0),
          "mat_ior": (1.0, None), "mat_transparency": (0.0, 1.0)}   # valid values


def sgd(params: dict, grads: dict, lr: float, ior_rows) -> dict:
    """The tables after one plain SGD step of size `lr`, in float64: each table
    less lr times its gradient, clamped to its valid range (RANGES); the
    mat_ior rows outside `ior_rows` (materials without an ior, -1) kept."""
    new = {}
    for k, p in params.items():
        p = p.detach().to(torch.float64)
        lo, hi = RANGES[k]
        v = torch.clamp(p - lr * grads[k].to(p), min=lo, max=hi)
        new[k] = torch.where(ior_rows.to(p.device), v, p) if k == "mat_ior" else v
    return new


def bf16(x):
    """x stored in bfloat16 and computed in its own dtype (floats only)."""
    return x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point() else x


def splat(width, height, radius, px, value):
    """(H*W, 4) film of (R,) samples at continuous coords px (R, 2) with values
    (R, 3) under the box filter of `radius`: rgb weighted sums and the weight."""
    dtype = value.dtype
    K = int(math.floor(2.0 * radius + 1.0))
    x, y = px[:, 0], px[:, 1]
    x0 = torch.floor(x + 0.5 - radius).to(torch.int64)
    y0 = torch.floor(y + 0.5 - radius).to(torch.int64)
    x1 = torch.floor(x - 0.5 + radius).to(torch.int64)
    y1 = torch.floor(y - 0.5 + radius).to(torch.int64)
    acc = torch.zeros((height * width, 4), dtype=dtype, device=value.device)
    for dy in range(K):
        yy = y0 + dy
        in_y = (yy >= 0) & (yy < height) & (yy <= y1)
        for dx in range(K):
            xx = x0 + dx
            inside = (xx >= 0) & (xx < width) & (xx <= x1) & in_y
            w = inside.to(dtype)
            idx = torch.clamp(yy, 0, height - 1) * width + torch.clamp(xx, 0, width - 1)
            acc = acc.index_add(0, idx, torch.cat([value * w[:, None], w[:, None]], dim=-1))
    return acc


def scan(acc):
    """(N, 4) film -> (N, 3) image: the weighted mean, clamped at 0."""
    w = acc[:, 3:4]
    return torch.clamp(acc[:, :3] / torch.where(w == 0.0, torch.ones_like(w), w), min=0.0)


class TrainReference:
    """The reference's scene of a scene dict on a device (its tables, stored in
    bfloat16 for the control), and its train step's loss and gradients."""

    def __init__(self, sd: dict, dtype, device, max_bounces: int, global_seed: int = 0,
                 control: bool = False, scene: ref_loader.Scene | None = None):
        self.scene = scene if scene is not None else ref_loader.Scene(sd)
        tables = self.scene.tables(dtype, device)
        self.control = control
        self.tables = type(tables)(*map(bf16, tables)) if control else tables
        self.meta = self.scene.meta()
        v0, e1, e2 = (x.to(torch.float64).cpu().numpy() for x in
                      (self.tables.tri_v0, self.tables.tri_e1, self.tables.tri_e2))
        self.clusters = closest_hit.build_clusters(v0, e1, e2, device)
        self.intersect = closest_hit.make_intersect(self.tables, self.meta, self.clusters)
        self.cfg = tracer.PTConfig(max_bounces=max_bounces, global_seed=global_seed)
        self.cam = self.scene.cameras[0]
        film = self.cam.film or {}
        if str(film.get("filter", "box")).lower() != "box":
            raise ValueError("the reference's film is the box filter")
        self.radius = float(film.get("radius", 0.5))

    def _film(self, tables, px, py, si):
        """(H*W, 4) film of the paths (px, py, si) through `tables`."""
        cam, dtype = self.cam, tables.tri_v0.dtype
        rays = cam_mod.generate_rays(cam, px, py, si, self.cfg.global_seed, dtype)
        st = tracer.init_state(tables, self.cfg.ior_stack_size, rays.origin, rays.direction,
                               rays.pixel_index, rays.sample_index)
        step = tracer.pt_step(tables, self.meta, self.cfg, self.intersect,
                              common.build_packs(tables, self.meta))
        while bool(st.alive.any()) and int(st.bounce.min()) < self.cfg.max_bounces:
            st = step(st)
        return splat(cam.width, cam.height, self.radius, rays.px, st.radiance)

    def loss_and_grads(self, params: dict, px, py, si, target, block: int = BLOCK):
        """(loss, {name: gradient in float64}) of the train step whose material
        tables `params` (a dict of the tables' mat_* fields) replace the
        scene's: loss = mean((scan(film) - target)^2) over the (H, W, 3) image."""
        params = {k: (bf16(v) if self.control else v).detach().to(self.tables.tri_v0.device)
                  for k, v in params.items()}
        target = torch.as_tensor(target).to(self.tables.tri_v0).reshape(-1, 3)
        n = px.shape[0]
        blocks = [slice(b, min(b + block, n)) for b in range(0, n, block)]
        with torch.no_grad():
            tables = self.tables._replace(**params)
            acc = sum(self._film(tables, px[b], py[b], si[b]) for b in blocks)
        acc = acc.requires_grad_()
        loss = torch.mean((scan(acc) - target) ** 2)
        (cot,) = torch.autograd.grad(loss, [acc])
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        grads = {k: torch.zeros_like(v, dtype=torch.float64) for k, v in params.items()}
        for b in blocks:
            film = self._film(self.tables._replace(**leaves), px[b], py[b], si[b])
            got = torch.autograd.grad((film * cot).sum(), list(leaves.values()),
                                      allow_unused=True)
            for k, g in zip(leaves, got):
                if g is not None:
                    grads[k] += g.to(torch.float64)
        return loss.detach(), grads
