"""Frozen copy of mcrt_tpu_torch/camera/camera.py for the benchmark's plain reference:
later changes to the port do not reach it.

Camera ray generation: pinhole + thin-lens, vectorized over (pixel, sample) batches.

Parity with the reference's per-pixel loop (source/camera/camera.cpp:66-99) as
ported by the JAX package: pixel jitter from Sobol dims PIXEL=0,1 at sequence 0;
thin-lens aperture sample from LENS=2,3; focus distance along `forward`.

The camera's constants are uploaded once (`camera_consts`): building a tensor
from host values inside the bounce loop would synchronise the device each time.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry as g
from . import sobol
from .loader import CameraDef


class CameraRays(NamedTuple):
    origin: torch.Tensor       # (R,3)
    direction: torch.Tensor    # (R,3)
    px: torch.Tensor           # (R,2) continuous film coordinates of the sample
    pixel_index: torch.Tensor  # (R,) int64 holding the uint32 linear pixel index
    sample_index: torch.Tensor # (R,) int64 holding the uint32 sample index


class CameraConsts(NamedTuple):
    """A camera's scalars and basis vectors as tensors of one dtype and device."""
    pixel_size: torch.Tensor
    half_w: torch.Tensor
    half_h: torch.Tensor
    focal_length: torch.Tensor
    aperture_radius: torch.Tensor
    focus_distance: torch.Tensor
    forward: torch.Tensor      # (3,)
    left: torch.Tensor
    up: torch.Tensor
    eye: torch.Tensor


def camera_consts(cam: CameraDef, dtype, device) -> CameraConsts:
    sc = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return CameraConsts(
        pixel_size=sc(cam.sensor_width / cam.width), half_w=sc(cam.width * 0.5),
        half_h=sc(cam.height * 0.5), focal_length=sc(cam.focal_length),
        aperture_radius=sc(cam.aperture_radius), focus_distance=sc(cam.focus_distance),
        forward=sc(cam.forward), left=sc(cam.left), up=sc(cam.up), eye=sc(cam.eye))


def generate_rays(
    cam: CameraDef,
    pixel_x,
    pixel_y,
    sample_index,
    global_seed: int = 0,
    dtype=torch.float32,
    consts: CameraConsts | None = None,
) -> CameraRays:
    """Rays for integer pixel coords (R,) and per-pixel sample indices (R,), on
    the device of `pixel_x`. `consts` (from camera_consts) saves the upload."""
    pixel_x = sobol.as_u32(pixel_x)
    dev = pixel_x.device
    pixel_y = sobol.as_u32(pixel_y, dev)
    sample_index = sobol.as_u32(sample_index, dev)
    pixel_index = (pixel_y * cam.width + pixel_x) & 0xFFFFFFFF
    k = consts if consts is not None else camera_consts(cam, dtype, dev)

    ctx = sobol.make_ctx(global_seed, pixel_index, sample_index, dtype)
    u0 = sobol.sample(ctx, 0)
    u1 = sobol.sample(ctx, 1)

    # The jittered position stays inside its pixel: in float32, x + u rounds up
    # to x + 1 for u within half an ulp of x below 1 (about 4 samples of a
    # 512x512 image), and the film's splat would then put the sample in the
    # next pixel, where render()'s per-pixel sums keep it in its own.
    fx, fy = pixel_x.to(dtype), pixel_y.to(dtype)
    px = torch.minimum(fx + u0, torch.nextafter(fx + 1.0, fx))
    py = torch.minimum(fy + u1, torch.nextafter(fy + 1.0, fy))
    local_x = k.pixel_size * (k.half_w - px)
    local_y = k.pixel_size * (k.half_h - py)

    direction = g.normalize(
        k.forward * k.focal_length + k.left * local_x[:, None] + k.up * local_y[:, None]
    )
    origin = k.eye.expand(direction.shape)

    if cam.thin_lens:
        u2 = sobol.sample(ctx, 2)
        u3 = sobol.sample(ctx, 3)
        ap = g.uniform_disk(u2, u3) * k.aperture_radius
        t_focus = k.focus_distance / g.dot(direction, k.forward)
        focus_point = origin + direction * t_focus[:, None]
        origin = k.eye + k.left * ap[:, 0:1] + k.up * ap[:, 1:2]
        direction = g.normalize(focus_point - origin)

    return CameraRays(
        origin=origin.contiguous(),
        direction=direction,
        px=torch.stack([px, py], dim=-1),
        pixel_index=pixel_index,
        sample_index=sample_index,
    )
