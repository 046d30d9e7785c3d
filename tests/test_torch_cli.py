"""The port's CLI (`python -m mcrt_tpu_torch`): scene discovery, the option
table, the prompts, and a photon-mapped render written as a TGA on the CPU."""
import io
import json
import pathlib

import numpy as np
import pytest
import torch

from mcrt_tpu_torch import cli
from mcrt_tpu_torch.camera import image as image_mod
from mcrt_tpu_torch.scene.synthetic import height_field_scene

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

SCENES = pathlib.Path(__file__).parent / "scenes"


@pytest.fixture
def scene_dir(tmp_path):
    """caustic_sphere.json (with a photon_map block, cut to 2000 emissions), a
    height field without one, and files the scan must skip."""
    j = json.loads((SCENES / "caustic_sphere.json").read_text())
    j["photon_map"]["emissions"] = 2000
    (tmp_path / "caustic_sphere.json").write_text(json.dumps(j))
    (tmp_path / "height_field.json").write_text(json.dumps(height_field_scene(4, 8, 1, as_lists=True)))
    (tmp_path / "notes.txt").write_text("not a scene")
    (tmp_path / "broken.json").write_text("{not json")
    return tmp_path


def test_available_and_print_table(scene_dir):
    opts = cli.available(scene_dir)
    assert [(o.path.name, o.camera_idx, o.photon_map) for o in opts] == [
        ("caustic_sphere.json", 0, True), ("height_field.json", 0, False)]
    assert opts[0].camera == "Eye: (0 2 -3), Focal length: 35mm (35mm)"
    buf = io.StringIO()
    cli.print_table(opts, out=buf)
    lines = buf.getvalue().splitlines()
    assert "Option" in lines[1] and "File" in lines[1] and "Camera" in lines[1]
    assert lines[3].startswith("| 0") and "caustic_sphere" in lines[3]
    assert lines[5].startswith("| 1") and "height_field" in lines[5]


@pytest.mark.parametrize("answer,photon_map", [("y", True), ("n", False)])
def test_get_option_prompts(scene_dir, monkeypatch, capsys, answer, photon_map):
    replies = iter(["7", "x", "0", "maybe", answer])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(replies))
    opt = cli.get_option(cli.available(scene_dir))
    assert opt.path.name == "caustic_sphere.json" and opt.photon_map is photon_map
    out = capsys.readouterr().out
    assert "Invalid option" in out and "Answer with the letters y or n" in out


def test_main_photon_map_writes_tga(scene_dir, tmp_path):
    out = tmp_path / "out.tga"
    rc = cli.main(["--scene", str(scene_dir / "caustic_sphere.json"), "--photon-map",
                   "--device", "cpu", "--size", "8x8", "--spp", "1", "--max-bounces", "8",
                   "--out", str(out), "--quiet"])
    assert rc == 0
    img = image_mod.read_tga(out)
    assert img.shape == (8, 8, 3) and img.max() > 0


def test_main_interactive_path_tracer(scene_dir, tmp_path, monkeypatch):
    replies = iter(["1"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(replies))
    out = tmp_path / "hf.tga"
    rc = cli.main([str(scene_dir), "--device", "cpu", "--spp", "1", "--max-bounces", "4",
                   "--out", str(out), "--quiet"])
    assert rc == 0 and image_mod.read_tga(out).shape == (8, 8, 3)


def test_main_reports_missing_inputs(tmp_path, capsys):
    assert cli.main(["--scene", str(tmp_path / "nope.json"), "--device", "cpu"]) == 1
    assert cli.main([str(tmp_path / "no_dir"), "--device", "cpu"]) == 1
    assert cli.main([str(tmp_path), "--device", "cpu"]) == 1        # no scenes in it
    err = capsys.readouterr().err
    assert "not found" in err and "does not exist" in err and "No scenes" in err


def test_checkpoint_flag_keeps_photon_maps(scene_dir, tmp_path):
    ck = tmp_path / "ck"
    argv = ["--scene", str(scene_dir / "caustic_sphere.json"), "--photon-map", "--device", "cpu",
            "--size", "4x4", "--spp", "1", "--max-bounces", "4", "--checkpoint", str(ck),
            "--quiet"]
    assert cli.main(argv + ["--out", str(tmp_path / "a.tga")]) == 0
    assert len(list(ck.glob("photons_*.npz"))) == 2 and len(list(ck.glob("film_*.npz"))) == 1
    assert cli.main(argv + ["--out", str(tmp_path / "b.tga")]) == 0
    a, b = (image_mod.read_tga(tmp_path / n) for n in ("a.tga", "b.tga"))
    np.testing.assert_array_equal(a, b)
