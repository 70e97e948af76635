"""The benchmark's arithmetic on synthetic calls, spans and traces."""

import pytest

import reduce
from harness import Run


def _metric(bench, name):
    import harness

    return harness.load(bench.home / "metrics" / f"{name}.py", "t_")


def test_rate_is_all_bytes_over_all_the_window():
    assert reduce.rate_mb_s(50_000_000, 2.0) == pytest.approx(25.0)


def test_percentile_matches_statistics_inclusive():
    values = [float(v) for v in range(1, 101)]
    assert reduce.percentile(values, 95) == pytest.approx(95.05)
    assert reduce.percentile([3.0], 95) == 3.0
    assert reduce.percentile([1.0, 2.0], 50) == pytest.approx(1.5)


def test_merge_and_clip():
    assert reduce.merge([(0, 1), (0.5, 2), (3, 4)]) == [(0, 2), (3, 4)]
    assert reduce.clip([("a", -1, 1), ("b", 2, 3), ("c", 5, 6)], 0, 4) == [
        ("a", 0, 1), ("b", 2, 3)]


def test_device_summary_on_a_synthetic_trace():
    device = [("k7_match", 1.0, 1.5), ("Memcpy DtoH", 1.4, 1.6),
              ("pack_tokens_kernel", 4.0, 4.25), ("k7_match", 9.0, 11.0)]
    host = [("splice", 1.6, 3.9), ("scan", 4.3, 5.0)]
    s = reduce.device_summary(device, host, (0.0, 10.0))
    # busy: [1, 1.6] + [4, 4.25] + [9, 10] (the last clipped to the window)
    assert s["busy_s"] == pytest.approx(0.6 + 0.25 + 1.0)
    assert s["kernel_s"] == pytest.approx(0.5 + 0.25 + 1.0)
    assert s["window_s"] == 10.0
    assert s["device_ops"][0] == ["k7_match", pytest.approx(1.5)]
    gaps = {round(sec, 6): label for label, sec in s["idle_gaps"]}
    assert gaps == {1.0: "other", 2.4: "splice", 4.75: "scan"}
    assert [g[1] for g in s["idle_gaps"]] == sorted(
        (g[1] for g in s["idle_gaps"]), reverse=True)


def test_idle_and_roofline():
    assert reduce.idle_pct(0.5, 10.0) == pytest.approx(95.0)
    # 3.35 GB at 3.35e12 B/s is 1 ms; 10 ms of kernels is 10% of it.
    assert reduce.roofline_pct(3_350_000_000, 3.35e12, 0.01) == \
        pytest.approx(10.0)


def test_metric_readers_on_a_synthetic_run(bench):
    run = Run(setup_s=12.5, window_s=10.0, call_s=[0.4] * 19 + [0.6],
              bytes_in=200_000_000, bytes_out=80_000_000,
              peak_bytes=300 * 2**20,
              spans={"splice": (57, 8.0), "encode_group": (56, 1.0),
                     "scan": (20, 6.0), "plan_pack": (460, 1.5)},
              launches=700,
              trace={"busy_s": 0.25, "kernel_s": 0.2, "window_s": 10.0,
                     "least_bytes": 140_000_000},
              peak_bytes_per_s=3.35e12)
    want = {
        "compress_MBps": 20.0, "decode_MBps": 8.0,
        "call_p95_ms": reduce.percentile(run.call_s, 95) * 1e3,
        "peak_device_MiB": 300.0, "setup_s": 12.5,
        "splice_share.compress": 80.0, "groups_per_MB.compress": 0.28,
        "scan_share.decode": 60.0, "plan_pack_share.decode": 15.0,
        "launches_per_MB.compress": 3.5, "launches_per_MB.decode": 8.75,
        "kernels_roofline.compress": 100 * 140e6 / 3.35e12 / 0.2,
        "kernels_roofline.decode": 100 * 140e6 / 3.35e12 / 0.2,
        "device_idle_pct.compress": 97.5, "device_idle_pct.decode": 97.5,
    }
    names = {m["name"] for kind in ("end_to_end", "per_layer")
             for m in bench.spec[kind]}
    assert names == set(want)
    for name, value in want.items():
        assert _metric(bench, name).read(run) == pytest.approx(value), name


def test_readers_report_nothing_where_there_is_nothing_to_read(bench):
    run = Run(setup_s=1.0, window_s=1.0, call_s=[1.0], bytes_in=10,
              bytes_out=10)
    for metric in bench.spec["per_layer"]:
        assert _metric(bench, metric["name"]).read(run) is None, metric
    assert _metric(bench, "peak_device_MiB").read(run) is None
