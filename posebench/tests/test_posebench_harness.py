"""The harness on the CPU: ``BENCHMARK.json`` within the contract, new
pieces found by name with no edit to an existing file, and the result
line's keys."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO, small_copy
from posebench.lib import cell, runner, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# the numbers compared, each beside its limit, come last under a key of
# their own (the benchmark contract's rule for the result line)
CHECKS = "checks"


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "posebench/run.py"]
    assert b["paths"] == ["posebench"] and 1 <= b["run_seconds"] <= 51
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert c["file"] == f"posebench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert any(w["config"] == c["name"] for w in b["workloads"])
        assert spec.config(c["name"])["source"] == c["source"]
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        doc = spec.workload(w["traffic"])
        assert doc["config"] == w["config"] and doc["chips"] == w["chips"]
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(cells) // 4)
    names = set()
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            keys = {"name", "unit", "better", "source"} | (
                {"bound"} if kind == "end_to_end" else {"layer", "moves"})
            assert set(m) - {"workloads"} == keys, m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["name"] not in names
            names.add(m["name"])
            assert m["better"] in ("lower", "higher")
            assert set(m.get("workloads", cells)) <= set(cells)
            assert spec.metric_reader(m["name"]).UNIT == m["unit"]
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert m["source"] in SOURCES and _line(m["layer"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in b["per_layer"]:
        moves = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moves.get("workloads", cells))
    for cell in cells:
        got = runner.cell_metrics(b, cell, False)
        assert "setup_s" in got and len(got) >= 2
        assert runner.cell_metrics(b, cell, True)
    assert len(json.dumps(b)) < 64 * 1024


def test_new_pieces_are_found_by_name(tmp_path):
    root = small_copy(tmp_path)
    before = {k: spec.names(k, s, root) for k, s in (
        ("workloads", ".json"), ("configs", ".json"), ("metrics", ".py"))}
    cfg = json.loads(open(os.path.join(
        root, "configs", "thin368coco-fp32-432x368.json")).read())
    cfg.update(input_wh=[96, 64])
    with open(os.path.join(root, "configs", "thin-tiny.json"), "w") as f:
        json.dump(cfg, f)
    wl = json.loads(open(os.path.join(
        root, "workloads", "thin432-batch16.json")).read())
    wl.update(config="thin-tiny", batch=2, scenes=4, check_images=4,
              trace_calls=1)
    with open(os.path.join(root, "workloads", "thin-tiny.b2.json"),
              "w") as f:
        json.dump(wl, f)
    with open(os.path.join(root, "metrics", "calls_per_s.py"), "w") as f:
        f.write('UNIT = "calls/s"\n\n\ndef read(ctx):\n    o = ctx["outcome"]'
                '\n    return o["calls"] / o["window_s"]\n')
    bench = json.loads(open(os.path.join(root, "..", "BENCHMARK.json")).read())
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["thin-tiny.b2"]})
    next(m for m in bench["end_to_end"] if m["name"] == "images_per_s")[
        "workloads"].append("thin-tiny.b2")
    with open(os.path.join(root, "..", "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = {k: spec.names(k, s, root) for k, s in (
        ("workloads", ".json"), ("configs", ".json"), ("metrics", ".py"))}
    assert set(after["workloads"]) - set(before["workloads"]) == {
        "thin-tiny.b2"}
    assert set(after["configs"]) - set(before["configs"]) == {"thin-tiny"}
    assert set(after["metrics"]) - set(before["metrics"]) == {"calls_per_s"}
    result, lines, _ = runner.run("thin-tiny.b2", 2 ** 33 + 1, 1.0, False,
                               device="cpu", root=root)
    assert list(result) == RESULT_KEYS + [CHECKS]
    assert set(result["metrics"]) == {"images_per_s", "setup_s",
                                      "calls_per_s"}
    assert result["correct"] and lines[-1].startswith("check images")


PACED_ENTRY = '''"""A paced loop: a pause of the configuration's ``pause_s``
before each call of ``inference_batch``."""

import time

from posebench.entries import _program


def run(cell):
    if cell.workload["loop"] != "paced":
        raise ValueError("the paced entry drives a paced loop")
    pause, up = cell.config["pause_s"], cell.config["upsample"]

    def call(est, imgs):
        time.sleep(pause)
        return est.inference_batch(imgs, upsample_size=up)

    return _program.drive(cell, call)
'''


def test_new_keys_and_loops_need_no_edit(tmp_path):
    """A configuration with keys the harness does not know (one passed on
    to the program's estimator) and a workload with a new loop, run by an
    entry file of its own: added, found and run with no file edited."""
    root = small_copy(tmp_path)
    cfg = json.loads(open(os.path.join(
        root, "configs", "thin368coco-fp32-432x368.json")).read())
    cfg.update(input_wh=[96, 64], pause_s=0.01,
               program={"device_preprocess": True})
    with open(os.path.join(root, "configs", "thin-paced.json"), "w") as f:
        json.dump(cfg, f)
    wl = json.loads(open(os.path.join(
        root, "workloads", "thin432-batch16.json")).read())
    wl.update(config="thin-paced", entry="paced", loop="paced", batch=2,
              scenes=4, check_images=4, trace_calls=1)
    with open(os.path.join(root, "workloads", "thin-paced.b2.json"),
              "w") as f:
        json.dump(wl, f)
    with open(os.path.join(root, "entries", "paced.py"), "w") as f:
        f.write(PACED_ENTRY)
    bench_path = os.path.join(root, "..", "BENCHMARK.json")
    bench = json.loads(open(bench_path).read())
    next(m for m in bench["end_to_end"] if m["name"] == "images_per_s")[
        "workloads"].append("thin-paced.b2")
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    assert spec.config("thin-paced", root)["program"] == {
        "device_preprocess": True}
    result, _, _ = runner.run("thin-paced.b2", 2 ** 32 + 5, 2.0, False,
                              device="cpu", root=root)
    assert result["correct"] and result["attempted"] >= 2
    assert result["metrics"]["images_per_s"]["value"] < 2 / 0.01
    # the closed-loop entries refuse a loop they do not drive
    wl.update(entry="inference_batch")
    with open(os.path.join(root, "workloads", "thin-paced.b2.json"),
              "w") as f:
        json.dump(wl, f)
    with pytest.raises(ValueError, match="closed loop"):
        runner.run("thin-paced.b2", 5, 1.0, False, device="cpu", root=root)


@pytest.mark.parametrize("k", [1, 3])
def test_keeper_holds_k_calls_drawn_from_the_seed(k):
    """Reservoir sampling: never more than ``k`` calls held, the same
    calls for the same seed, and every call of the window alike likely."""
    def kept(seed, calls):
        keeper = cell.Keeper(seed, k)
        for i in range(calls):
            keeper.offer(i, i)
            assert len(keeper.slots) <= k
        return keeper.kept()

    assert kept(2 ** 33 + 7, 200) == kept(2 ** 33 + 7, 200)
    assert len(kept(1, 200)) == k and kept(1, 2) == list(range(min(k, 2)))
    hits = np.zeros(20)
    for seed in range(20000):
        hits[kept(seed, 20)] += 1
    share = hits / (20000 * k / 20)     # 1 +- 0.03 (k = 1) for each call
    assert share.min() > 0.85 and share.max() < 1.15


def test_traced_result_line_keys(tmp_path):
    root = small_copy(tmp_path, {
        "configs/thin368coco-fp32-432x368.json": {"input_wh": [96, 64]},
        "workloads/thin432-single.json": {"scenes": 4,
                                          "check_images": 2,
                                          "trace_calls": 1}})
    result, _, _ = runner.run("thin432-single", 7, 15.0, True, device="cpu",
                           root=root)
    assert list(result) == RESULT_KEYS + ["breakdown", CHECKS]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    for name, m in result["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"])


@pytest.mark.parametrize("bad", ["", "a b", "x/y", ".hidden", "a" * 65])
def test_names_outside_the_rules_are_refused(bad):
    with pytest.raises(ValueError):
        spec.check_name(bad)


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "posebench/run.py", "--workload", "thin432-single",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
