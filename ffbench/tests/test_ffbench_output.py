"""The window's arithmetic, the result line, and metrics found by name."""

import json

import pytest

from ffbench import run, serve, stats
from ffbench.tests import tiny

SEED = 2**31 + 101


def _strict(line: str) -> dict:
    def no_constant(name):
        raise ValueError(f"non-finite number {name} in the result line")

    return json.loads(line, parse_constant=no_constant)


def test_percentiles_and_rate_over_a_window_with_a_stall():
    # Ten requests due every 0.1 s, each answered 0.2 s after its due time,
    # except that a 2 s stall at 0.45 s holds back the five due after it;
    # one request never finishes.
    records = []
    for i in range(10):
        due = 0.1 * i
        done = due + 0.2 if due < 0.45 else 2.45 + 0.2 * (i - 4)
        records.append(serve.Record(i, due, 16, 8, done_s=done, tokens=[1] * 8))
    records.append(serve.Record(10, 1.0, 16, 8))
    end = 3.9
    lat = stats.latencies_s(records, end)
    assert lat[-1] == pytest.approx(end - 1.0)
    assert lat[:5] == pytest.approx([0.2] * 5)
    assert lat[5] == pytest.approx(2.45 + 0.2 - 0.5)
    # nearest rank: the ceil(p / 100 * 11)-th smallest of the eleven
    ordered = sorted(lat)
    assert stats.nearest_rank(lat, 90) == ordered[9]
    assert stats.nearest_rank(lat, 50) == ordered[5]
    assert stats.nearest_rank(lat, 100) == pytest.approx(end - 1.0)
    # the stall stays in the window's time: 80 tokens read back over 3.9 s
    assert stats.rate(80, end) == pytest.approx(80 / 3.9)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("workload", ["llava7b.qa", "llava7b.captions"])
def test_result_line_parses_strictly(tiny_bench, workload):
    result, checks = run.run_cell(tiny_bench, workload, SEED, 2.0, False, device="cpu")
    parsed = _strict(json.dumps(result, allow_nan=False))
    assert list(parsed) == ["correct", "attempted", "failed", "metrics", "device", "build_s", "checks"]
    assert parsed["correct"] is True and parsed["failed"] == 0 and parsed["attempted"] > 0
    want = {m["name"] for m in tiny_bench.metrics(workload, trace=False)}
    assert set(parsed["metrics"]) == want and "setup_s" in want
    for m in parsed["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float) and m["value"] > 0
    assert set(parsed["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in parsed["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_traced_result_line(tiny_bench):
    result, _ = run.run_cell(tiny_bench, "llava7b.qa", SEED, 3.0, True, device="cpu")
    parsed = _strict(json.dumps(result, allow_nan=False))
    assert list(parsed)[-3:] == ["breakdown", "build_s", "checks"]
    names = {m["name"] for m in tiny_bench.metrics("llava7b.qa", trace=True)}
    assert set(parsed["metrics"]) <= names and "preprocess_ms_per_frame.qa" in parsed["metrics"]
    assert {"busy_s", "window_s"} <= set(parsed["device"]) and parsed["device"]["window_s"] > 0
    for key in ("device_ops", "idle_gaps"):
        assert len(parsed["breakdown"][key]) <= 10


def test_a_metric_is_found_by_its_name(tmp_path):
    bench = tiny.make_bench(tmp_path)
    (bench.dir / "metrics" / "dummy_ms.qa.py").write_text(
        "def read(run):\n    return 1e3 * len(run.window.records)\n")
    (bench.dir / "metrics" / "silent.qa.py").write_text("def read(run):\n    return None\n")
    bench.data["per_layer"] += [
        {"name": "dummy_ms.qa", "unit": "ms", "better": "lower", "source": "host_clock", "layer": "test",
         "moves": "answer_p90_ms", "workloads": ["llava7b.qa"]},
        {"name": "silent.qa", "unit": "ms", "better": "lower", "source": "host_clock", "layer": "test",
         "moves": "answer_p90_ms"}]
    result, _ = run.run_cell(bench, "llava7b.qa", SEED, 2.0, True, device="cpu")
    assert result["metrics"]["dummy_ms.qa"] == {"value": 1e3 * result["attempted"], "unit": "ms"}
    assert "silent.qa" not in result["metrics"]


def test_one_reader_serves_each_split_of_its_name(tmp_path):
    bench = tiny.make_bench(tmp_path)
    (bench.dir / "metrics" / "dummy_ms.py").write_text("def read(run):\n    return 2.0\n")
    (bench.dir / "metrics" / "dummy_ms.captions.py").write_text("def read(run):\n    return 3.0\n")
    assert bench.reader("dummy_ms.qa")(None) == 2.0
    assert bench.reader("dummy_ms.captions")(None) == 3.0
    with pytest.raises(FileNotFoundError):
        bench.reader("no_such_metric.qa")


def test_without_a_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "llava7b.qa", "--seed", "1", "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_every_entry_has_its_files():
    bench = run.Bench(tiny.REPO / "BENCHMARK.json")
    from ffbench import families, reference

    for w in bench.data["workloads"]:
        config = bench.config(w["config"])
        assert bench.traffic(w["traffic"])["serving"]["slots"] > 0 and bench.cell(w["name"])["rate_rps"] > 0
        assert families.load(config["kind"]).build and reference.load(config["kind"]).features
    for kind in ("end_to_end", "per_layer"):
        for m in bench.data[kind]:
            assert callable(bench.reader(m["name"]))
