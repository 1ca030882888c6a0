"""BENCHMARK.json and the files it names: the contract's keys, names and
units, and every cell, configuration and metric found by name."""
import json
import re

import pytest

from fsibench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_has_exactly_the_contract_s_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["fsibench"]
    assert 1 <= MAN["run_seconds"] <= 51
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word
    files = [w for w in MAN["command"] if w.endswith(".py")]
    assert all(f.startswith("fsibench/") for f in files)


def test_every_name_and_unit_uses_the_allowed_characters():
    names = []
    for c in MAN["configs"]:
        names.append(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names)
    metric_names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


def test_bounds_and_layers():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert "bound" not in m and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_every_cell_loads_by_name(name):
    w, config, traffic, limits = harness.cell(name)
    assert config["name"] == w["config"]
    assert config["reduced"] == []
    assert {"velocity", "p", "phi", "maps"} <= set(limits["limits"]) \
        <= set(harness.kind(config).NUMBERS)
    e2e = harness.metrics_of(MAN, name, False)
    layer = harness.metrics_of(MAN, name, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer
    for m in e2e + layer:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_every_configuration_file_loads(c):
    conf = json.loads((harness.ROOT / c["file"]).read_text())
    assert conf["dtype"] in ("float32", "float64")
    assert conf["chunk_steps"] > 0 and conf["warmup_steps"] > 0
    assert conf["follow_steps"] > 0
    assert (harness.HERE / "kinds" / f"{conf['kind']}.py").is_file()
    assert conf["reduced"] == c["reduced"]
    assert 1 <= len(conf["source"]) <= 200


def test_a_seed_gives_the_same_inputs_and_every_seed_the_same_sizes():
    _, config, _, _ = harness.cell("soft_disc_lid_f64.n4096")
    seeded = harness.kind(config).seeded
    a = seeded(config, 4096, 2**31 + 12345)
    assert a == seeded(config, 4096, 2**31 + 12345)
    b = seeded(config, 4096, 7)
    assert a != b and len(a[1]) == len(b[1])
    for disc, _ in (a, b):
        assert abs(disc[0] - 0.6) < 0.5 / 4095
        assert abs(disc[1] - 0.5) < 0.5 / 4095 and disc[2] == 0.2


def test_the_seeded_flow_has_the_lid_s_speed_and_no_slip_on_the_walls():
    import numpy as np

    _, config, _, _ = harness.cell("soft_disc_lid_f64.n4096")
    mod = harness.kind(config)
    _, modes = mod.seeded(config, 4096, 2**31 + 5)
    g = np.linspace(0.0, 1.0, 257)
    X, Y = np.meshgrid(g, g)
    u, v = mod.velocity(modes, X, Y, np)
    assert abs(np.sqrt(u * u + v * v).max() - 1.0) < 1e-12
    for f in (u, v):
        for edge in (f[0], f[-1], f[:, 0], f[:, -1]):
            assert np.abs(edge).max() < 1e-12
