import pytest

import stats


def test_percentile_uses_every_sample_and_sees_a_stall():
    xs = [4.0] * 95 + [50.0] * 5           # five stalls in a hundred calls
    assert stats.percentile(xs, 50) == 4.0
    assert stats.percentile(xs, 95) == pytest.approx(4.0 + 46.0 * 0.05)
    assert stats.percentile(xs, 96) == pytest.approx(50.0)
    assert stats.percentile(xs, 100) == 50.0


def test_percentile_matches_linear_interpolation():
    xs = [3.0, 1.0, 2.0, 10.0]
    assert stats.percentile(xs, 0) == 1.0
    assert stats.percentile(xs, 50) == 2.5
    assert stats.percentile(xs, 95) == pytest.approx(3.0 + 7.0 * 0.85)
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_rates_count_every_call_of_the_window():
    import importlib.util
    import os
    import types

    here = os.path.dirname(stats.__file__)

    def reader(name):
        spec = importlib.util.spec_from_file_location(name, os.path.join(here, "metrics",
                                                                         name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    win = types.SimpleNamespace(units=30000.0, seconds=2.0, latency_ms=[4.0] * 19 + [40.0])
    ctx = types.SimpleNamespace(window=win, setup_s=9.5)
    assert reader("solves_per_s")(ctx) == 15000.0
    assert reader("robot_ticks_per_s")(ctx) == 15000.0
    assert reader("batch_ms_p95")(ctx) == pytest.approx(4.0 + 36.0 * 0.05)
    assert reader("tick_ms_p95")(ctx) == reader("batch_ms_p95")(ctx)
    assert reader("setup_s")(ctx) == 9.5


def test_samples_hold_every_call_of_the_window(tmp_path, capsys):
    import json

    import run

    path = tmp_path / "samples.json"
    rc = run.main(["--workload", "panda_arm.track", "--seed", "11", "--seconds", "0.3",
                   "--rehearse", "--batch", "8", "--samples", str(path)])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1].split(": ", 1)[1])
    got = json.loads(path.read_text())
    assert {len(v) for v in got.values()} == {line["attempted"]}
    assert got["start_s"] == sorted(got["start_s"]) and got["start_s"][0] >= 0.0
