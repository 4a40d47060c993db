"""Every part BENCHMARK.json names is found by its name."""

import json

import pytest

from benchmark.harness import registry

SPEC = registry.benchmark_spec()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_parts_are_found(cell):
    c = registry.cell(SPEC, cell)
    registry.load_module("systems", c["config_data"]["system"])
    kind = registry.load_module("traffic", c["mix"]["kind"])
    assert callable(kind.drive) and callable(kind.warm_rows)
    e2e, layer = registry.cell_metrics(SPEC, cell)
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in e2e + layer:
        assert callable(registry.reader(m["name"]).read)


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    data = json.loads((registry.REPO_DIR / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["source"] == conf["source"] and data["reduced"] == conf["reduced"]
    assert conf["file"].startswith(SPEC["paths"][0] + "/")


def test_per_layer_metrics_move_a_metric_of_their_cells():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])


def test_a_split_metric_reads_through_the_reader_of_its_quantity():
    assert registry.reader("device.idle_share.batch") is registry.reader("device.idle_share.stream")
    assert registry.reader("verify.ms_per_batch.stream") is registry.reader("verify.ms_per_batch")
    with pytest.raises(FileNotFoundError):
        registry.reader("no_such_metric.batch")


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        registry.load_json("workloads", "no_such_cell")
    with pytest.raises(ValueError):
        registry.load_module("metrics", "../run")
