"""The benchmark's files: every cell, configuration, traffic mix, runner and
metric found by name from BENCHMARK.json; the FLOP counts; the reference's
imports; the trace's reduction on synthetic events."""

import ast
import json
import re
import subprocess
import sys

import pytest

from h100_bench import flops, harness, trace

BENCH = harness.read_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert all(0 < m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("section,keys,optional", [
    ("configs", {"name", "source", "file", "reduced", "why"}, set()),
    ("workloads", {"name", "config", "traffic", "chips", "why"}, set()),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}, {"workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}, {"workloads"})])
def test_every_entry_has_exactly_its_keys(section, keys, optional):
    for entry in BENCH[section]:
        assert keys <= set(entry) <= keys | optional, entry["name"]
        for key in ("why", "layer", "source"):
            text = entry.get(key)
            if key in keys and isinstance(text, str):
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = harness.Cell(cell, BENCH)
    assert c.traffic["runner"] in ("train_pairs", "serve", "train_labels")
    assert callable(c.runner().run) and callable(c.runner().control)
    assert set(c.spec["limits"]) and all(v > 0 for v in c.spec["limits"].values())
    assert any(m["name"] != "setup_s" for m in c.end_to_end)
    assert c.per_layer
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read)


@pytest.mark.parametrize("metric,values,key", [
    ("train_pairs_per_s", {"pairs_per_s": 2.0, "setup_s": 9.0}, "pairs_per_s"),
    ("dp_train_pairs_per_s", {"pairs_per_s": 8.0, "setup_s": 9.0}, "pairs_per_s"),
    ("register_p95_ms", {"pairs_per_s": 80.0, "p95_ms": 48.0, "setup_s": 9.0}, "p95_ms"),
    ("setup_s", {"pairs_per_s": 2.0, "setup_s": 9.0}, "setup_s")])
def test_an_end_to_end_metric_takes_the_runner_quantity_its_name_ends_with(metric, values, key):
    sys.path.insert(0, str(harness.BENCH_DIR))
    import run as bench_run
    assert bench_run.reported_as(metric, values) == key
    with pytest.raises(KeyError):
        bench_run.reported_as("register_p50_ms", values)


def test_every_cell_reports_each_of_its_end_to_end_metrics():
    for w in BENCH["workloads"]:
        moved = {m["moves"] for m in harness.Cell(w["name"], BENCH).per_layer}
        assert moved <= {m["name"] for m in harness.Cell(w["name"], BENCH).end_to_end}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_a_reader_finds_nothing_in_an_untraced_run(metric):
    reader = harness.load_module(harness.BENCH_DIR / "metrics" / f"{metric}.py", "m")
    assert reader.read(harness.RunData(pairs=10, steps=10, calls=3, window_s=1.0)) is None


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_sizes(config):
    body = harness.read_json(harness.ROOT / config["file"])
    assert body["model"]["inshape"] == [160, 192, 224]
    assert config["reduced"] == body["reduced"] == []


@pytest.mark.parametrize("enc,dec,svf,fwd,train", [
    ([16, 32, 32, 32], [32, 32, 32, 32, 32, 16, 16], 1, 1007.1, 3009.4),
    ([64] * 4, [64] * 6, 2, 1079.5, 3190.8)])
def test_conv_flop_counts(enc, dec, svf, fwd, train):
    convs = flops.unet_convs((160, 192, 224), 2, enc, dec, svf)
    assert flops.forward_flops(convs) / 1e9 == pytest.approx(fwd, abs=0.05)
    assert flops.train_flops(convs) / 1e9 == pytest.approx(train, abs=0.05)


def test_bf16_serving_bound_is_the_known_one():
    convs = flops.unet_convs((160, 192, 224), 2, [16, 32, 32, 32], [32, 32, 32, 32, 32, 16, 16])
    assert flops.conv_pass_least_s(convs, "bfloat16", train=False) * 1e3 == \
        pytest.approx(1.121, abs=0.001)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((harness.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_neither_jax_nor_the_port(path):
    assert not set(_imports(path)) & {*harness.FORBIDDEN, "voxelmorph_tpu_torch"}


def test_reference_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r); import h100_bench.reference.vxm, "
            "h100_bench.reference.synth; print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(harness.ROOT))
    loaded = set(json.loads(subprocess.check_output([sys.executable, "-c", code], text=True)
                            .replace("'", '"')))
    assert not loaded & {*harness.FORBIDDEN, "voxelmorph_tpu_torch"}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "voxelmorph_tpu_torch_like", sys)
    assert "voxelmorph_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert "jaxlib" in harness.forbidden_modules()


@pytest.mark.parametrize("intervals,busy", [
    ([(0, 2), (1, 3), (5, 6)], 4),
    ([(0, 10), (2, 3), (4, 5)], 10),
    ([(3, 4), (0, 1)], 2),
    ([], 0)])
def test_union_of_intervals(intervals, busy):
    assert sum(b - a for a, b in trace.union(intervals)) == busy


def _events():
    """A window of 100 us on one host thread: a conv span launching two
    kernels that overlap another stream's kernel, and a gap."""
    return [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "conv3.fwd", "ts": 5, "dur": 10, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sum", "ts": 40, "dur": 40, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 6, "dur": 1,
         "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 8, "dur": 1,
         "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 41, "dur": 1,
         "tid": 1, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "conv3_wgmma_kernel<bf16>", "ts": 10, "dur": 20,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "reduce", "ts": 20, "dur": 20,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "ncclAllReduce", "ts": 90, "dur": 20,
         "args": {"correlation": 9}},
    ]


def test_trace_busy_window_and_spans():
    t = trace.Trace(_events())
    assert t.window_s == pytest.approx(100e-6)
    # (10, 40) and (90, 100) clipped to the window
    assert t.busy_s == pytest.approx(40e-6)
    assert [k.spans for k in t.kernels] == [["conv3.fwd"], ["conv3.fwd"], []]
    assert t.kernel_seconds(flops.conv_layer) == pytest.approx(40e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["aten::sum"] == pytest.approx(50e-6)
    assert gaps["conv3.fwd"] == pytest.approx(10e-6)
    assert t.top_ops()[0][1] == pytest.approx(20e-6)


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.Trace(_events()[1:])


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 5, -7, 10 ** 30])
def test_seeds_take_any_integer(seed):
    s = harness.Seeds(seed)
    assert all(0 <= v < 2 ** 32 for v in (s.data, s.picks, s.trainer, s.sample))
    assert vars(harness.Seeds(seed)) == vars(s)
