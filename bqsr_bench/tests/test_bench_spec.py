"""Every configuration, traffic and metric of the manifest loads by name,
and a name with no file fails loudly."""

import json

import pytest

from bqsr_bench.harness import spec


def _manifest():
    return spec.manifest()


def test_every_cell_loads_with_its_files():
    man = _manifest()
    assert man["paths"] == ["bqsr_bench"]
    for w in man["workloads"]:
        cell = spec.cell(w["name"], man)
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["name"] == w["traffic"]
        assert cell["end_to_end"] and cell["per_layer"]
        assert "setup_s" in [m["name"] for m in cell["end_to_end"]]


def test_every_config_file_states_source_assumed_reduced():
    for c in _manifest()["configs"]:
        data = spec.config(c["name"])
        assert data["name"] == c["name"]
        assert c["file"] == f"bqsr_bench/configs/{c['name']}.json"
        assert data["source"] and data["assumed"]
        assert data["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in data


def test_every_metric_has_a_reader():
    man = _manifest()
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    man = _manifest()
    e2e = {m["name"] for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells


@pytest.mark.parametrize("kind,call", [
    ("cell", lambda: spec.cell("no-such-cell")),
    ("config", lambda: spec.config("no-such-config")),
    ("traffic", lambda: spec.traffic("no-such-traffic")),
    ("metric", lambda: spec.reader("no_such_metric")),
])
def test_a_missing_name_fails_loudly(kind, call):
    with pytest.raises(spec.SpecError):
        call()


def test_a_traffic_for_another_format_is_refused():
    man = _manifest()
    bad = json.loads(json.dumps(man))
    bad["workloads"][0]["traffic"] = "whole-file"
    with pytest.raises(spec.SpecError):
        spec.cell(bad["workloads"][0]["name"], bad)


def test_every_config_names_an_input_format_with_its_two_functions():
    for c in _manifest()["configs"]:
        fmt = spec.input_format(spec.config(c["name"])["format"])
        assert callable(fmt.write) and callable(fmt.expected)


def test_a_config_of_a_format_with_no_file_fails_loudly(tmp_path,
                                                       monkeypatch):
    import shutil
    bench = tmp_path / "bqsr_bench"
    shutil.copytree(spec.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = bench / "configs" / "ecoli-50x-fastq.json"
    cfg = json.loads(path.read_text())
    cfg["format"] = "no-such-format"
    path.write_text(json.dumps(cfg))
    monkeypatch.setattr(spec, "BENCH_DIR", str(bench))
    with pytest.raises(spec.SpecError, match="no formats file"):
        spec.cell("ecoli-50x-fastq.resident", _manifest())
    with pytest.raises(spec.SpecError, match="no formats file"):
        spec.input_format("no-such-format")
