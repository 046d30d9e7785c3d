"""The renderer's sharded steps: rays split over ranks, film and gradients summed.

The port of the JAX package's mcrt_tpu/parallel/sharding.py on
`torch.distributed`. Where the JAX package shards a (pixel, sample) batch over
a 1-D device mesh with shard_map, replicates the scene tables and the
ClusterBVH, and `psum`s the film and the parameter gradients, here every rank
of a process group is one device of that mesh: it takes its contiguous slice
of the global batch, traces it through the same path tracer and intersect
closure as one device, splats it into a local film and all-reduces the film
(and, in the train step, the gradients) by sum. The collectives are enqueued
on the device's stream, so no step reads the card from the host.

`train_step` is `sharded_train_step` over a world of one with no process
group: a step renders camera rays through the differentiable path tracer
(`trace(differentiable=True)`, every bounce rematerialised), splats them into
the film, scans the image and takes the gradient of the L2 loss against a
target image with respect to a dict of material tables, by reverse mode
through the detached-sampling path replay.

The JAX package's steps pass `vary_axes=(axis,)` to `pt.trace`: an annotation
of shard_map's device-variance typing, which changes no value. torch has no
such typing, so the port's steps have no counterpart of it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..camera import camera as cam_mod
from ..camera import film as film_mod
from ..integrator import path_tracer as pt
from ..materials import gather_bwd
from ..ops import cluster_bvh
from ..ops import traverse_kernel as tk
from ..utils import trace
from ..utils.device import resolve_device, torch_dtype

# Material tables a training step differentiates by default: the JAX
# package's four (reflectance and the three Fresnel-coupled parameters).
DEFAULT_TRAIN_PARAMS = (
    "mat_reflectance", "mat_specular_roughness", "mat_ior", "mat_transparency",
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks a sharded step splits its rays over and reduces across: the
    counterpart of the JAX package's 1-D mesh on the "rays" axis. `group` is
    a torch.distributed process group, or None for a world of one with no
    process group (nothing is reduced)."""
    group: object | None
    rank: int
    size: int


LOCAL = Mesh(None, 0, 1)


def make_mesh(group=None) -> Mesh:
    """The mesh of `group` (None: the default group), with this process's rank
    and the group's size; a world of one (LOCAL) when torch.distributed has no
    process group."""
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("make_mesh: a group was given, but torch.distributed is not initialised")
        return LOCAL
    group = dist.group.WORLD if group is None else group
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group))


def shard(total: int, rank: int, size: int) -> tuple[int, int]:
    """(start, count) of rank's contiguous slice of a length-`total` batch;
    the batch must divide evenly, as shard_map requires."""
    if total % size:
        raise ValueError(f"a batch of {total} rays does not divide over {size} ranks")
    per = total // size
    return rank * per, per


def _all_reduce(mesh: Mesh, x):
    """x summed over the mesh's ranks, in place (nothing to do without a group)."""
    if mesh.group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def _summed(mesh: Mesh, local):
    """The film summed over the ranks, whose gradient flows to `local` once.

    The forward value is the reduced film exactly: `local - local.detach()` is
    zero. The backward sends the summed film's cotangent to this rank's own
    film and to nothing else, so the per-rank gradients add up to the
    gradient of the whole batch. (torch.distributed.nn.functional.all_reduce
    would reduce the cotangent again in its backward: with the gradients then
    summed, they would come out `size` times too large.)"""
    if mesh.group is None:
        return local
    total = _all_reduce(mesh, local.detach().clone())
    return total + (local - local.detach())


def _local_film(meta, cfg: pt.PTConfig, cam, film_cfg, mesh: Mesh, dtype, device,
                differentiable: bool):
    """Returns fn(tables, cbvh, px, py, si) -> this rank's (H, W, 4) film of its
    slice of the global (R,) px, py, si. cbvh None intersects by brute force;
    a cbvh through cluster_bvh.make_intersect_fn, by the route its tables
    take (best-first for float64 tables on the card, whose steps then run
    eagerly).
    The camera's constants are uploaded here, once: inside a step the upload
    would synchronise the host with the card. On the card the trace's loop is
    captured at the first call and replayed by the later ones of the same
    shapes, which copy their tables in (`graphs`: the forward trace's
    path_tracer.BatchTrace, the differentiable trace's trips, see
    path_tracer._run_trips). The two halves are `film.prepare(tables, cbvh,
    px, py, si) -> (intersect_fn, rays)` and `film.render(tables,
    intersect_fn, rays) -> film`."""
    consts = cam_mod.camera_consts(cam, dtype, device)
    graphs = {}

    def prepare(tables, cbvh, px, py, si):
        lo, per = shard(px.shape[0], mesh.rank, mesh.size)
        on = lambda x: torch.as_tensor(x[lo:lo + per], device=device)
        intersect_fn = (None if cbvh is None
                        else cluster_bvh.make_intersect_fn(tables, meta, cbvh))
        rays = cam_mod.generate_rays(cam, on(px), on(py), on(si), cfg.global_seed, dtype,
                                     consts=consts)
        return intersect_fn, rays

    def render(tables, intersect_fn, rays):
        radiance = pt.trace(tables, meta, cfg, rays.origin, rays.direction, rays.pixel_index,
                            rays.sample_index, intersect_fn=intersect_fn,
                            differentiable=differentiable, graphs=graphs)
        return film_mod.splat(film_cfg, rays.px, radiance)

    def film(tables, cbvh, px, py, si):
        return render(tables, *prepare(tables, cbvh, px, py, si))

    film.prepare, film.render, film.graphs = prepare, render, graphs
    return film


def _trip_replays(graphs) -> tuple[int, int]:
    """The replays of G_f and of G_b that the GraphedTrips in `graphs` (a
    differentiable film's) have run."""
    return (sum(g.replays[0] for g in graphs.values()),
            sum(g.replays[1] for g in graphs.values()))


def sharded_render_step(meta, cfg: pt.PTConfig, cam, film_cfg, mesh: Mesh, dtype,
                        with_bvh: bool = False, device=None):
    """Returns fn(tables[, cbvh], px, py, si, film) -> film, cbvh present
    exactly when `with_bvh`.

    px, py, si are the global (R,) batch, the same on every rank; R must
    divide by the mesh's size. Each rank traces its contiguous slice through
    `pt.trace` (the ClusterBVH's intersect when cbvh is given, the same
    intersect path as one device), and every rank gets film + the sum of the
    ranks' (H, W, 4) splats. The all-reduce runs after the trace, outside
    its graph. The returned function's `graphs` holds the trace's runs
    (path_tracer.BatchTrace, one per batch size): the first call of a size
    captures its bounce step on the card, later calls copy their tables in
    and replay it; close them (and clear the dict) when done.
    device: None is the CUDA device (raise without one); "cpu" on request."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    local = _local_film(meta, cfg, cam, film_cfg, mesh, dtype, device, differentiable=False)

    def step(tables, cbvh, px, py, si, film):
        return torch.as_tensor(film, device=device) + _all_reduce(mesh, local(tables, cbvh, px, py, si))

    fn = step if with_bvh else lambda tables, px, py, si, film: step(tables, None, px, py, si, film)
    fn.graphs = local.graphs
    return fn


def sharded_train_step(meta, cfg: pt.PTConfig, cam, film_cfg, mesh: Mesh, dtype,
                       with_bvh: bool = False, device=None):
    """Differentiable render step: returns fn(tables[, cbvh], params, px, py,
    si, target, stats=None) -> (loss, grads), cbvh present exactly when
    `with_bvh`.

    `params` is a dict of material tables, any subset of SceneTables' mat_*
    fields (e.g. {k: getattr(tables, k) for k in DEFAULT_TRAIN_PARAMS}), and
    `grads` mirrors it; a bare tensor differentiates mat_reflectance alone and
    gets a bare tensor back. px, py, si are the global (R,) batch, split over
    the mesh as in `sharded_render_step`. The loss is mean((image -
    target)^2) of the image scanned from the summed film, a 0-d tensor on the
    device; the gradients are summed over the ranks, so every rank returns the
    same loss and gradients. Nothing in the step reads the card from the host.
    The returned function's `graphs` holds the trips captured on the card
    (path_tracer._run_trips): the first call captures, later calls replay;
    trips that traverse best-first run eagerly under checkpoint, and capture
    nothing.
    device: None is the CUDA device (raise without one); "cpu" on request.

    stats: if a dict, the step records into it (utils/trace) the spans
    `train.step` (the whole call) and, inside it, `train.params` (the tables
    with the params in, the intersect closure, the camera rays),
    `train.forward` (the trips, the splat, the scan and the loss) and
    `train.backward` (`torch.autograd.grad` and the gradients' assembly),
    and the counters "trip_forward_replays" and "trip_backward_replays"
    (the replays of the trips' G_f and G_b in the call, utils/cuda_graph;
    counted here, since the backward's replays run on autograd's thread)
    and "traverse_launches" and "gather_bwd_launches" (the traversal
    kernel's launches and the material gather backward's kernel calls that
    ran in the call: on the card one of the latter a G_b replay, and one more
    in the first call's eager warm-up trip; 0 on the CPU), added to what the
    dict holds. With None nothing is recorded."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    local = _local_film(meta, cfg, cam, film_cfg, mesh, dtype, device, differentiable=True)

    def value_and_grad(tables, cbvh, params, px, py, si, target, stats=None):
        with trace.recording(stats), trace.span("train.step"):
            launches, replays = tk.kernel.launches, _trip_replays(local.graphs)
            gathers = gather_bwd.kernel.launches
            with trace.span("train.params"):
                named = params if isinstance(params, dict) else {"mat_reflectance": params}
                leaves = {k: v.detach().requires_grad_() for k, v in named.items()}
                traced = tables._replace(**leaves)
                intersect_fn, rays = local.prepare(traced, cbvh, px, py, si)
            with trace.span("train.forward"):
                img = film_mod.scan(_summed(mesh, local.render(traced, intersect_fn, rays)))
                loss = torch.mean((img - torch.as_tensor(target, dtype=dtype, device=device)) ** 2)
            with trace.span("train.backward"):
                got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(leaves.values(), got)]
                if mesh.group is not None:   # one all-reduce for every table
                    flat = _all_reduce(mesh, torch.cat([g.reshape(-1) for g in grads]))
                    grads = [f.view_as(g)
                             for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
                grads = dict(zip(leaves, grads))
            after = _trip_replays(local.graphs)
            trace.count("trip_forward_replays", after[0] - replays[0])
            trace.count("trip_backward_replays", after[1] - replays[1])
            trace.count("traverse_launches", tk.kernel.launches - launches)
            trace.count("gather_bwd_launches", gather_bwd.kernel.launches - gathers)
        return loss.detach(), grads if isinstance(params, dict) else grads["mat_reflectance"]

    fn = value_and_grad if with_bvh else lambda tables, params, px, py, si, target, stats=None: \
        value_and_grad(tables, None, params, px, py, si, target, stats)
    fn.graphs = local.graphs
    return fn


def image_step(meta, cfg: pt.PTConfig, cam, film_cfg, dtype, device=None):
    """Returns fn(tables, cbvh, params, px, py, si) -> (H, W, 3) image.

    `params` is a dict of SceneTables mat_* fields that replace the tables'
    own, so the packs and the BVH intersect closure are rebuilt from them and
    the image is differentiable in them. cbvh None intersects by brute force.
    px, py, si are (R,) pixel coordinates and sample indices on the device."""
    device = resolve_device(device)
    film = _local_film(meta, cfg, cam, film_cfg, LOCAL, torch_dtype(dtype), device,
                       differentiable=True)
    return lambda tables, cbvh, params, px, py, si: film_mod.scan(
        film(tables._replace(**params), cbvh, px, py, si))


def train_step(meta, cfg: pt.PTConfig, cam, film_cfg, dtype, with_bvh: bool = False,
               device=None):
    """The train step on one device: `sharded_train_step` over a world of one
    with no process group. Returns fn(tables[, cbvh], params, px, py, si,
    target, stats=None) -> (loss, grads), cbvh present exactly when
    `with_bvh`; `stats` as sharded_train_step's.
    device: None is the CUDA device (raise without one); "cpu" on request."""
    return sharded_train_step(meta, cfg, cam, film_cfg, LOCAL, dtype, with_bvh, device)
