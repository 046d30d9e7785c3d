"""The renderer's training step: material gradients of a pixel loss.

The port of the JAX package's `sharded_train_step` (mcrt_tpu/parallel/
sharding.py) on one device. A step renders camera rays through the
differentiable path tracer (`trace(differentiable=True)`, every bounce
rematerialised), splats them into the film, scans the image and takes the
gradient of the L2 loss against a target image with respect to a dict of
material tables, by reverse mode through the detached-sampling path replay.
Sharding the rays over several cards, with the film and the gradients
all-reduced, is not ported yet.
"""
from __future__ import annotations

import torch

from ..camera import camera as cam_mod
from ..camera import film as film_mod
from ..integrator import path_tracer as pt
from ..ops import cluster_bvh
from ..utils.device import resolve_device, torch_dtype

# Material tables a training step differentiates by default: the JAX
# package's four (reflectance and the three Fresnel-coupled parameters).
DEFAULT_TRAIN_PARAMS = (
    "mat_reflectance", "mat_specular_roughness", "mat_ior", "mat_transparency",
)


def image_step(meta, cfg: pt.PTConfig, cam, film_cfg, dtype, device=None):
    """Returns fn(tables, cbvh, params, px, py, si) -> (H, W, 3) image.

    `params` is a dict of SceneTables mat_* fields that replace the tables'
    own, so the packs and the BVH intersect closure are rebuilt from them and
    the image is differentiable in them. cbvh None intersects by brute force.
    px, py, si are (R,) pixel coordinates and sample indices on the device.
    The camera's constants are uploaded here, once: inside a step the upload
    would synchronise the host with the card."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    consts = cam_mod.camera_consts(cam, dtype, device)

    def image(tables, cbvh, params, px, py, si):
        t = tables._replace(**params)
        intersect_fn = cluster_bvh.make_intersect_fn(t, meta, cbvh) if cbvh is not None else None
        on = lambda x: torch.as_tensor(x, device=device)
        rays = cam_mod.generate_rays(cam, on(px), on(py), on(si), cfg.global_seed, dtype,
                                     consts=consts)
        radiance = pt.trace(t, meta, cfg, rays.origin, rays.direction, rays.pixel_index,
                            rays.sample_index, intersect_fn=intersect_fn, differentiable=True)
        return film_mod.scan(film_mod.splat(film_cfg, rays.px, radiance))

    return image


def train_step(meta, cfg: pt.PTConfig, cam, film_cfg, dtype, with_bvh: bool = False,
               device=None):
    """Differentiable render step: returns fn(tables[, cbvh], params, px, py,
    si, target) -> (loss, grads), cbvh present exactly when `with_bvh`.

    `params` is a dict of material tables, any subset of SceneTables' mat_*
    fields (e.g. {k: getattr(tables, k) for k in DEFAULT_TRAIN_PARAMS}), and
    `grads` mirrors it; a bare tensor differentiates mat_reflectance alone and
    gets a bare tensor back. The loss is mean((image - target)^2), a 0-d
    tensor on the device; nothing in the step reads the card from the host.
    device: None is the CUDA device (raise without one); "cpu" on request."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    image = image_step(meta, cfg, cam, film_cfg, dtype, device)

    def value_and_grad(tables, cbvh, params, px, py, si, target):
        named = params if isinstance(params, dict) else {"mat_reflectance": params}
        leaves = {k: v.detach().requires_grad_() for k, v in named.items()}
        img = image(tables, cbvh, leaves, px, py, si)
        loss = torch.mean((img - torch.as_tensor(target, dtype=dtype, device=device)) ** 2)
        got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), got)}
        return loss.detach(), grads if isinstance(params, dict) else grads["mat_reflectance"]

    if with_bvh:
        return value_and_grad
    return lambda tables, params, px, py, si, target: value_and_grad(
        tables, None, params, px, py, si, target)
