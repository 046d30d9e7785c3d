"""The last line a run prints, and the runs that print none."""
import json
import sys
import time

import torch

from benchmark import cell, run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _spec(workload, check):
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    spec = run.cell_spec(bench, workload)
    spec["check"] = check
    return spec


def test_last_line_shape(tiny):
    workload, config, traffic, check = tiny
    r, nums = cell.run(config, traffic, check, 2**31 + 7, 0.1, True, "cpu", time.time())
    spec = _spec(workload, check)
    for trace in (False, True):
        line = run.result_line(spec, r, nums, trace, {"platform": "cpu", "kind": "cpu",
                                                      "count": 1})
        keys = list(line)
        assert keys[:5] == KEYS and keys[-1] == "checks"
        assert ("breakdown" in keys) == trace
        assert line["correct"] is True and line["attempted"] == len(r.images) >= 1
        assert set(line["checks"]) == set(check["limits"])
        wanted = spec["per_layer"] if trace else spec["end_to_end"]
        assert set(line["metrics"]) <= {m["name"] for m in wanted}
        if not trace:
            assert {"samples_per_s", "setup_s"} <= set(line["metrics"])
        json.loads(json.dumps(line))


def test_no_card_no_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "pin_host", lambda: None)
    rc = run.main(["--workload", "pt-hf2m-512-16spp", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_banned_modules_by_whole_top_level_name(monkeypatch):
    assert "mcrt_tpu" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "mcrt_tpu_torch_extra", object())
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "mcrt_tpu.render", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.banned_modules() == ["jax", "mcrt_tpu"]


def test_pin_host_keeps_two_cores(monkeypatch):
    got = []
    monkeypatch.setattr(run.os, "sched_getaffinity", lambda pid: set(range(8)))
    monkeypatch.setattr(run.os, "sched_setaffinity", lambda pid, cpus: got.append(list(cpus)))
    run.pin_host()
    monkeypatch.setattr(run.os, "sched_getaffinity", lambda pid: {5})
    run.pin_host()
    assert got == [[2, 3], [5]]
