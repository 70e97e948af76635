"""bench_torch_device.py's pure helpers on the CPU: the roofline arithmetic,
the artifact's layout, and main() refusing to time anything without a card.
"""

import os
import subprocess
import sys
import pathlib

import pytest

torch = pytest.importorskip("torch")

import bench_torch_device as bench  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_pcie_link_rates():
    # Gen 5 x16: 32 GT/s a lane, 128b/130b, 16 lanes, 8 bits a byte.
    assert bench.pcie_gbps(5, 16) == pytest.approx(63.015384615, rel=1e-9)
    assert bench.pcie_gbps(4, 16) == pytest.approx(31.507692307, rel=1e-9)
    assert bench.pcie_gbps(3, 8) == pytest.approx(7.876923076, rel=1e-9)
    # Gen 2 x16: 5 GT/s a lane, 8b/10b.
    assert bench.pcie_gbps(2, 16) == pytest.approx(8.0)


def test_tile_roofline_and_hbm_rate():
    assert bench.HBM_GBPS == 3350.0
    # (24 + 8 nrounds) bytes per output byte against 3,350 GB/s.
    assert bench.tile_roofline_gbps(1) == pytest.approx(3350 / 32)
    assert bench.tile_roofline_gbps(5) == pytest.approx(3350 / 64)
    assert bench.tile_roofline_gbps(17) == pytest.approx(3350 / 160)


def test_row_summary():
    r = bench.row("device_crc32", "GB/s", [3.0, 1.0, 2.0, 5.0, 4.0],
                  bytes=7)
    assert r == {"name": "device_crc32", "unit": "GB/s", "median": 3.0,
                 "min": 1.0, "max": 5.0, "samples": 5, "bytes": 7}
    assert bench.row("kernel_build", "s", [0.5])["median"] == 0.5


def test_artifact_layout_has_every_row():
    names = bench.row_names()
    for label in ("mixed1mib", "mixed16mib", "mixed64mib"):
        for stem in ("decode_scan_", "device_inflate_tile_",
                     "device_inflate_e2e_resident_"):
            assert stem + label in names
    for name in ("launch_latency", "kernel_build", "warmup_wall",
                 "h2d_pinned", "h2d_pageable", "d2h_pinned", "device_crc32",
                 "device_adler32",
                 "device_inflate_indexed_e2e_resident_16mib",
                 "device_encode_group_L1", "device_encode_group_L6",
                 "device_encode_stage_find_L1", "device_encode_stage_find_L6",
                 "warm_first_uncompress_device", "warm_first_compress_device",
                 "warm_second_compress_device"):
        assert name in names
    assert len(names) == len(set(names)) == 25

    rows = [bench.row(n, "s", [1.0]) for n in names]
    art = bench.artifact("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100",
                         rows)
    assert set(art) == {"card", "torch", "cuda", "date", "seed", "method",
                        "groups", "root", "rows"}
    assert art["groups"] == list(bench.DEFAULT_GROUPS)
    assert art["root"] is None
    assert art["card"]["name"] == "NVIDIA H100 80GB HBM3"
    assert art["card"]["power_limit"] == "700.00 W"
    assert art["seed"] == bench.SEED      # the smoke's payload seed
    assert [r["name"] for r in art["rows"]] == names
    assert all({"median", "min", "max"} <= set(r) for r in art["rows"])
    with pytest.raises(ValueError):
        bench.artifact("card, 1 W", "card", rows[1:])


def test_parse_args_defaults():
    args = bench.parse_args([])
    assert args.out == pathlib.Path("chiprun_out/bench_torch_device.json")
    assert bench.parse_args(["--out", "x.json"]).out == pathlib.Path(
        "x.json")
    assert args.groups == bench.DEFAULT_GROUPS
    assert args.root == REPO


def test_groups_select_rows():
    # The compress group (the encoder's stages, timed in turns with a
    # parent tree) runs only when asked for; every row lies in one group.
    assert "compress" not in bench.DEFAULT_GROUPS
    compress = bench.row_names(("compress",))
    assert compress == ["stream_digests", "find_group_L6", "find_group_L1",
                        "compress_64mib_l6_tensor",
                        "compress_peak_memory_64mib_l6",
                        "compress_peak_memory_8mib_l9", "create_zip_archive"]
    every = bench.row_names(bench.GROUPS)
    assert every == bench.row_names() + compress
    assert sum(len(bench.row_names((g,))) for g in bench.GROUPS) == len(every)
    assert bench.row_names(("encode",)) == [
        "device_encode_group_L1", "device_encode_stage_find_L1",
        "device_encode_group_L6", "device_encode_stage_find_L6"]
    args = bench.parse_args(["--groups", "encode,compress", "--root", "x"])
    assert args.groups == ("encode", "compress")
    assert args.root == pathlib.Path("x")
    with pytest.raises(SystemExit):
        bench.parse_args(["--groups", "encode,bogus"])
    rows = [bench.row(n, "s", [1.0]) for n in compress]
    art = bench.artifact("card, 1 W", "card", rows, ("compress",), "x")
    assert art["groups"] == ["compress"] and art["root"] == "x"
    with pytest.raises(ValueError):
        bench.artifact("card, 1 W", "card", rows)


def test_main_without_cuda_writes_nothing(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = tmp_path / "sub" / "bench.json"
    assert bench.main(["--out", str(out)]) != 0
    assert not any(tmp_path.iterdir())
    assert capsys.readouterr().out == ""


def test_bench_imports_neither_jax_nor_reference():
    code = ("import sys, bench_torch_device\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'zippy_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
