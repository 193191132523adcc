"""BENCHMARK.json against the contract's limits and the files it names."""
import json
import os
import re
import shutil
import subprocess
import sys

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PB = os.path.join(ROOT, "portbench")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]] + [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert 1 <= b["run_seconds"] <= 51
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_every_name_resolves_to_its_files():
    b = bench()
    for c in b["configs"]:
        assert c["file"].startswith("portbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    configs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert w["config"] in configs
        with open(os.path.join(PB, "traffic", f"{w['traffic']}.json")) as f:
            kind = json.load(f)["kind"]
        assert os.path.isfile(os.path.join(PB, "traffic", f"{kind}.py"))
        assert os.path.isfile(os.path.join(PB, "limits", f"{w['name']}.json"))
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(PB, "metrics", f"{m['name']}.py")), m["name"]
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_a_cell_added_as_files_alone_is_picked_up(tmp_path):
    """A new traffic mix, its limits and a BENCHMARK.json entry, in a copy of
    the folder: the harness finds them by name, with no code edited."""
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "out", "__pycache__"))
    b = bench()
    b["workloads"].append({"name": "sd15-train-small", "config": "sd15", "traffic": "train-small",
                           "chips": 1, "why": "a cell added as data"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "sd15-train-paper" in m.get("workloads", []):
            m["workloads"].append("sd15-train-small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    mix = json.loads((tmp_path / "portbench/traffic/train-paper.json").read_text())
    mix["flags"] = [f if not f.startswith("--train_batch_size") else "--train_batch_size=2"
                    for f in mix["flags"]]
    (tmp_path / "portbench/traffic/train-small.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/limits/sd15-train-small.json").write_text(
        (tmp_path / "portbench/limits/sd15-train-paper.json").read_text())
    code = ("import json, portbench.harness as h; b = h.benchmark(); c = h.cell(b, 'sd15-train-small');"
            "t = h.load_json('traffic', c['traffic'] + '.json'); h.load_json('limits', c['name'] + '.json');"
            "print(json.dumps([t['kind'], [m['name'] for m in h.cell_metrics(b, c['name'], 'end_to_end')],"
            " len(h.cell_metrics(b, c['name'], 'per_layer'))]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, check=True, env={**os.environ, "PYTHONPATH": str(tmp_path)})
    kind, e2e, n_layer = json.loads(out.stdout.strip().splitlines()[-1])
    assert kind == "train" and "train_samples_per_s" in e2e and "setup_s" in e2e and n_layer == 7


def test_command_names_no_file_outside_paths():
    b = bench()
    assert b["paths"] == ["portbench"] and len(b["command"]) <= 32
    for word in b["command"]:
        assert not word.startswith("/") and ".." not in word
