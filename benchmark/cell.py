"""One run of one cell, put together from modules found by name.

A cell is (configuration, traffic, check). The configuration's "scene" names
the module scenes/<scene>.py whose `build(config, traffic)` makes the scene
dict that the port and the reference are both given; the traffic's "entry"
names the module entries/<entry>.py that drives one of the port's public
entry points for the window and checks what it produced against the plain
reference (reference/). A new scene kind or entry point is a new file there.
"""
from __future__ import annotations

import dataclasses
import importlib
import re

from . import devtrace

MODULE_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


@dataclasses.dataclass
class Run:
    """What the metric readers (metrics/) read. An entry fills what it has."""
    samples_per_image: int
    images: list                 # per image: {"wall": s, "stats": {name: number}}
    window_s: float              # first image's start to last image's end
    setup_s: float               # process start to the first timed image
    peak_bytes: int
    profile: devtrace.Profile | None = None
    work: dict = dataclasses.field(default_factory=dict)   # kernel -> (launches kept, least s)


def named(kind: str, name: str):
    """The module benchmark/<kind>/<name>.py (kind "scenes" or "entries")."""
    if not MODULE_NAME.match(name):
        raise ValueError(f"not a module name: {name!r}")
    return importlib.import_module(f"benchmark.{kind}.{name}")


def scene_dict(config: dict, traffic: dict) -> dict:
    return named("scenes", config["scene"]).build(config, traffic)


def entry(traffic: dict):
    return named("entries", traffic["entry"])


def run(config, traffic, check, seed, seconds, trace, device, process_start):
    """(Run, {number compared: value}) of one run of a cell."""
    return entry(traffic).run(config, traffic, check, seed, seconds, trace, device,
                              process_start)
