"""Port parity: the reference's route XML and parked-vehicle literals
(gabril_carla_tpu_torch/env/world.py: parse_routes_xml, parse_routes,
load_parked_tables, load_benchmark_specs).

A bench2drive-style XML of three vendored routes (trigger points, ``value``,
``from``/``to`` and ``x``/``y`` children, weathers) and a parked-vehicle
file in the reference's literal format are written into the test's tmp dir.
The port's parse equals the JAX package's; the WorldSpecs built from them
are bitwise JAX's, with the parked tables given, found beside the XML
("auto" without a vendored table) or vendored; eval_routes --routes_xml
runs on the XML and writes the records it writes from the vendored JSON.
Tolerance: none (numpy in both packages).
"""

import dataclasses
import json
import math
from pathlib import Path
from xml.sax.saxutils import quoteattr

import numpy as np
import pytest
import torch

import gabril_carla_tpu.data.vendored as JV
import gabril_carla_tpu.env.world as JW
import gabril_carla_tpu_torch.data.vendored as PV
import gabril_carla_tpu_torch.env.world as PW
from chip_smoke import without_wall
from gabril_carla_tpu_torch.cli import eval_routes
from gabril_carla_tpu_torch.train.bc import build_bc_models, init_bc_params
from gabril_carla_tpu_torch.train.checkpoint import save_manifest, save_params
from gabril_carla_tpu_torch.utils.prng import prng_key
from test_torch_common import cpu_threads
from test_torch_rollout import small_cfg

# 3100: x/y flow ends, from/to interval, a float value; 1825: a from/to
# frequency; 1711: a string value (direction)
ROUTES = (3100, 1825, 1711)
FROM_TO = ("source_dist_interval", "frequency")
WEATHER_ATTRS = ("route_percentage", "cloudiness", "precipitation", "fog_density",
                 "sun_altitude_angle", "wetness")


def _attrs(**kw) -> str:
    return " ".join(f"{k}={quoteattr(str(v))}" for k, v in kw.items())


def write_routes_xml(path: Path, ids=ROUTES) -> Path:
    """The vendored routes ``ids`` in bench2drive220.xml's layout."""
    raw = PV.load_routes_json(PV.routes_path(), list(ids))
    lines = ['<?xml version="1.0" encoding="UTF-8"?>', "<routes>"]
    for rid in ids:
        r = raw[rid]
        lines.append(f"  <route {_attrs(id=rid, town=r['town'])}>")
        lines.append("    <weathers>")
        for w in r["weather_keys"]:
            lines.append(f"      <weather {_attrs(**dict(zip(WEATHER_ATTRS, w)))}/>")
        lines.append("    </weathers>")
        lines.append("    <waypoints>")
        for x, y in r["waypoints"].tolist():
            lines.append(f"      <position {_attrs(x=repr(x), y=repr(y), z='0.0')}/>")
        lines.append("    </waypoints>")
        lines.append("    <scenarios>")
        for i, s in enumerate(r["scenarios"]):
            name = f"{s['type']}_{i}"
            lines.append(f"      <scenario {_attrs(name=name, type=s['type'])}>")
            for k, v in s.items():
                if k == "type":
                    continue
                if k == "trigger":
                    attrs = _attrs(x=v[0], y=v[1], z="0.0", yaw=v[2])
                    lines.append(f"        <trigger_point {attrs}/>")
                elif isinstance(v, tuple):
                    attrs = _attrs(**({"from": v[0], "to": v[1]} if k in FROM_TO
                                      else {"x": v[0], "y": v[1], "z": "0.0"}))
                    lines.append(f"        <{k} {attrs}/>")
                else:
                    lines.append(f"        <{k} {_attrs(value=v)}/>")
            lines.append("      </scenario>")
        lines.append("    </scenarios>")
        lines.append("  </route>")
    lines.append("</routes>")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    return path


def write_parked_py(path: Path, towns) -> Path:
    """The vendored parked tables of ``towns`` as the reference's
    leaderboard/utils/parked_vehicles.py literals (yaw in degrees)."""
    tables = PV.load_parked_npz(PV.parked_tables_path())
    lines = ["# parked vehicle slots", ""]
    for town in sorted(set(towns)):
        lines.append(f"{town} = [")
        for x, y, yaw in tables[town].tolist():
            lines.append(f"    {{'location':({x!r}, {y!r}, 0.3), 'rotation':(0.0, "
                         f"{math.degrees(yaw)!r}, 0.0), 'mesh':'vehicle.lincoln.mkz'}},")
        lines.append("]")
        lines.append("")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines))
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(route XML in <root>/routes/, parked literals in
    <root>/leaderboard/utils/: where "auto" looks beside the XML)."""
    root = tmp_path_factory.mktemp("reference")
    xml = write_routes_xml(root / "routes" / "bench2drive_test.xml")
    towns = [r["town"] for r in PV.load_routes_json(PV.routes_path(), list(ROUTES)).values()]
    return xml, write_parked_py(root / "leaderboard" / "utils" / "parked_vehicles.py", towns)


def assert_tree_equal(a, b, path="route"):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def assert_specs_equal(a, b):
    for f in dataclasses.fields(JW.WorldSpec):
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(y, x, err_msg=f.name)


def test_parse_routes_xml_matches_jax(files):
    xml, _ = files
    got, want = PW.parse_routes_xml(xml), JW.parse_routes_xml(str(xml))
    assert sorted(got) == sorted(ROUTES)
    assert_tree_equal(got, want)
    # the dispatch, and the XML carries the vendored JSON's raw routes
    assert_tree_equal(PW.parse_routes(xml, [3100]), JW.parse_routes(str(xml), [3100]))
    raw = PV.load_routes_json(PV.routes_path(), list(ROUTES))
    assert_tree_equal(PW.parse_routes(str(xml)), {r: raw[r] for r in ROUTES})
    kinds = {type(v).__name__ for r in got.values() for s in r["scenarios"] for v in s.values()}
    assert kinds == {"str", "float", "tuple"}


def test_load_parked_tables_matches_jax(files):
    _, parked = files
    got, want = PW.load_parked_tables(parked), JW.load_parked_tables(str(parked))
    assert sorted(got) == sorted(want) and got
    for town in want:
        assert got[town].dtype == np.float32 and len(got[town]) > 10
        np.testing.assert_array_equal(got[town], want[town], err_msg=town)
    vend = PW.load_parked_tables(PV.parked_tables_path())
    for town, jt in JW.load_parked_tables(str(JV.parked_tables_path())).items():
        np.testing.assert_array_equal(vend[town], jt, err_msg=town)


@pytest.mark.parametrize("parked", ["literals", "auto", "none"])
def test_load_benchmark_specs_xml_bitwise(files, parked):
    xml, lits = files
    arg = {"literals": str(lits), "auto": "auto", "none": None}[parked]
    got = PW.load_benchmark_specs(list(ROUTES), routes_file=xml, parked_tables_path=arg)
    want = JW.load_benchmark_specs(str(xml), list(ROUTES), parked_tables_path=arg)
    assert_specs_equal(want, got)
    if parked == "auto":  # the vendored tables: the same specs as the JSON route table
        assert_specs_equal(want, PW.load_benchmark_specs(list(ROUTES)))


def test_auto_finds_the_literals_beside_the_xml(files, tmp_path, monkeypatch):
    """Without a vendored table, "auto" reads ../leaderboard/utils/
    parked_vehicles.py beside the route file, in both packages."""
    xml, lits = files
    monkeypatch.setattr(PV, "BENCHMARK_DIR", tmp_path)
    monkeypatch.setattr(JV, "BENCHMARK_DIR", tmp_path)
    monkeypatch.setattr(JV, "REF_PARKED_PY", tmp_path / "absent.py")
    got = PW.load_benchmark_specs(list(ROUTES), routes_file=xml)
    want = JW.load_benchmark_specs(str(xml), list(ROUTES))
    assert_specs_equal(want, got)
    assert_specs_equal(want, PW.load_benchmark_specs(list(ROUTES), routes_file=xml,
                                                     parked_tables_path=str(lits)))
    bare = PW.load_benchmark_specs(list(ROUTES), routes_file=xml, parked_tables_path=None)
    assert got.statics_alive.sum() > bare.statics_alive.sum()  # the parked slots arrived


def test_eval_routes_on_the_xml(files, tmp_path):
    """eval_routes --routes_xml <xml> on the CPU writes the records it
    writes from the vendored route table."""
    xml, _ = files
    cfg = small_cfg(port=True)
    with cpu_threads(1):
        params = init_bc_params(build_bc_models(cfg, device="cpu"), cfg, prng_key(0))
        save_params(tmp_path / "ckpt", 1, {k: v.detach() for k, v in params.items()})
        save_manifest(tmp_path / "ckpt", cfg, 1)
        args = ["--checkpoint", str(tmp_path / "ckpt"), "--route_id", "1825", "--seeds", "3",
                "--steps", "6"]
        assert eval_routes.main(args + ["--routes_xml", str(xml), "--out", str(tmp_path / "xml")],
                                device="cpu") == 0
        assert eval_routes.main(args + ["--out", str(tmp_path / "json")], device="cpu") == 0
    one = "route_1825/seed_3/stats.json"
    got = json.loads((tmp_path / "xml" / one).read_text())
    assert got["route_id"] == "RouteScenario_1825"
    assert without_wall(got) == without_wall(json.loads((tmp_path / "json" / one).read_text()))
