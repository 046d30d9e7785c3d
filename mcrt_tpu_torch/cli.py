"""CLI driver: scene discovery, option menu, render dispatch.

The port of the JAX package's CLI (reference source/main.cpp:10-61 and
source/common/option.{hpp,cpp}): scans a scene directory for *.json, builds
one option per camera, shows the option table and the "Use photon mapping?
(y/n)" prompt (option.cpp:43-112), then renders and writes a timestamped TGA.
The flag mode (--scene/--camera/...) renders one scene without prompts.
Renders run on the CUDA device; `--device cpu` runs them on the CPU.

Usage:
  python -m mcrt_tpu_torch [scene_dir]                   # interactive menu
  python -m mcrt_tpu_torch --scene tests/scenes/caustic_sphere.json [--camera 0]
                     [--photon-map] [--spp N] [--size WxH] [--out render.tga]
                     [--checkpoint ckpt/] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import pathlib
import sys
import time

from .camera import image as image_mod
from .render import RenderConfig, render
from .scene.loader import Scene


class Option:
    """One renderable (scene file, camera index) pair (option.hpp:8-16)."""

    def __init__(self, path: pathlib.Path, camera_desc: str, camera_idx: int, photon_map: bool):
        self.path = path
        self.camera = camera_desc
        self.camera_idx = camera_idx
        self.photon_map = photon_map


def available(scene_dir: pathlib.Path) -> list[Option]:
    """Scan scene_dir/*.json -> one Option per camera (option.cpp:12-41)."""
    options: list[Option] = []
    for path in sorted(scene_dir.iterdir()):
        if path.suffix != ".json":
            continue
        try:
            j = json.loads(path.read_text())
            cams = j["cameras"]
        except (json.JSONDecodeError, KeyError):
            continue
        photon_map = "photon_map" in j
        for i, c in enumerate(cams):
            eye = c["eye"]
            f = float(c["focal_length"])
            s = float(c["sensor_width"])
            desc = (
                f"Eye: ({eye[0]:.0f} {eye[1]:.0f} {eye[2]:.0f}), "
                f"Focal length: {int(f)}mm ({int(s)}mm)"
            )
            options.append(Option(path, desc, i, photon_map))
    return options


def print_table(options: list[Option], out=sys.stdout) -> None:
    """Terminal table in the reference's format (option.cpp:45-86)."""
    max_opt = 13
    max_fil = max((len(o.path.stem) for o in options), default=4) + 1
    max_cam = max((len(o.camera) for o in options), default=6) + 1

    def line(cols):
        out.write("| " + "".join(f"{c:<{w}}| " for c, w in cols) + "\n")

    out.write(" " + "_" * (max_opt + max_fil + max_cam + 5) + "\n")
    line([("Option", max_opt), ("File", max_fil), ("Camera", max_cam)])
    sep = "|" + "_" * (max_opt + 1) + "|" + "_" * (max_fil + 1) + "|" + "_" * (max_cam + 1) + "|"
    out.write(sep + "\n")
    for i, o in enumerate(options):
        line([(str(i), max_opt), (o.path.stem, max_fil), (o.camera, max_cam)])
        out.write(sep + "\n")


def get_option(options: list[Option]) -> Option:
    """Interactive selection + photon-mapping prompt (option.cpp:43-112)."""
    print_table(options)
    while True:
        try:
            choice = int(input("\nSelect option: "))
        except (ValueError, EOFError):
            print("Invalid option, try again: ", end="")
            continue
        if 0 <= choice < len(options):
            break
        print("Invalid option, try again: ", end="")
    opt = options[choice]
    if opt.photon_map:
        while True:
            a = input("\nUse photon mapping? (y/n) ").strip().lower()
            if a in ("y", "n"):
                break
            print("Answer with the letters y or n: ", end="")
        if a == "n":
            opt.photon_map = False
    return opt


def run_option(
    opt: Option,
    out_path: pathlib.Path | None = None,
    cfg: RenderConfig | None = None,
    size: tuple[int, int] | None = None,
    verbose: bool = True,
    checkpoint_dir: pathlib.Path | None = None,
    device=None,
) -> pathlib.Path:
    """Load, render, tonemap, write TGA. Returns the written path. `device`:
    None renders on the CUDA device (and raises without one), "cpu" on the CPU."""
    j = json.loads(opt.path.read_text())
    if size is not None:
        img = j["cameras"][opt.camera_idx].setdefault("image", {})
        img["width"], img["height"] = size
    scene = Scene(j, scene_dir=opt.path.parent)
    cam = scene.cameras[opt.camera_idx]
    if cfg is None:
        cfg = RenderConfig()
    if opt.photon_map:
        cfg = dataclasses.replace(cfg, integrator="photon_mapper")

    t0 = time.time()
    hdr = render(scene, opt.camera_idx, cfg, device=device, checkpoint_dir=checkpoint_dir,
                 verbose=verbose)
    dt = time.time() - t0
    if verbose:
        spp = (cfg.sqrtspp or cam.sqrtspp) ** 2
        n_rays = cam.width * cam.height * spp
        print(f"Render completed in {dt:.1f}s ({n_rays / max(dt, 1e-9) / 1e6:.2f} M camera rays/s)")

    if out_path is None:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
        out_path = pathlib.Path.cwd() / f"{cam.savename}_{stamp}.tga"
    image_mod.write_tga(out_path, image_mod.finalize(hdr, cam.image))
    if verbose:
        print(f"Wrote {out_path}")
    return out_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mcrt_tpu_torch", description=__doc__.split("\n")[0])
    ap.add_argument("scene_dir", nargs="?", default="scenes",
                    help="directory of scene .json files (interactive mode)")
    ap.add_argument("--scene", type=str, default=None, help="render this scene file directly")
    ap.add_argument("--camera", type=int, default=0)
    ap.add_argument("--photon-map", action="store_true")
    ap.add_argument("--spp", type=int, default=None, help="sqrtspp override")
    ap.add_argument("--size", type=str, default=None, help="WxH image size override")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="directory for film and photon-map checkpoints")
    ap.add_argument("--max-bounces", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to render on (default: the CUDA card; 'cpu' on request)")
    args = ap.parse_args(argv)

    size = None
    if args.size:
        w, h = args.size.lower().split("x")
        size = (int(w), int(h))
    cfg = RenderConfig(
        sqrtspp=args.spp, max_bounces=args.max_bounces, global_seed=args.seed,
        integrator="photon_mapper" if args.photon_map else "path_tracer",
    )

    if args.scene:
        path = pathlib.Path(args.scene)
        if not path.exists():
            print(f"Scene file not found: {path}", file=sys.stderr)
            return 1
        opt = Option(path, "", args.camera, args.photon_map)
    else:
        scene_dir = pathlib.Path(args.scene_dir)
        if not scene_dir.is_dir():
            print(f"Specified scene directory does not exist: {scene_dir}", file=sys.stderr)
            return 1
        options = available(scene_dir)
        if not options:
            print(f"No scenes found in {scene_dir}.", file=sys.stderr)
            return 1
        opt = get_option(options)
    run_option(
        opt,
        out_path=pathlib.Path(args.out) if args.out else None,
        cfg=cfg, size=size, verbose=not args.quiet,
        checkpoint_dir=pathlib.Path(args.checkpoint) if args.checkpoint else None,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
