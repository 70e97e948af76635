"""The zip-archive cell, driven through the harness on the CPU at a tiny
size (SF 0.001: tens of rows a table, a 64 KiB text pool): correct as the
program, traced and untraced; not correct as the control (zlib's Huffman
coding alone) or with one byte of the archive changed. The generators of
the eight tables: each row's columns and keys as clause 4.2.3 gives them,
and the orders' totals and statuses as their lineitems make them."""

import time
import zlib

import pytest

import harness

CELL = "tpch-tables-zip.create-tensor"
TINY = {"scale_factor": 0.001, "text_pool_bytes": 1 << 16}
COLUMNS = {"part.tbl": 9, "partsupp.tbl": 5, "supplier.tbl": 7,
           "customer.tbl": 8, "orders.tbl": 9, "lineitem.tbl": 16,
           "nation.tbl": 4, "region.tbl": 3}


@pytest.fixture(autouse=True)
def tracing_restored():
    """Loading a per-layer reader turns the program's tracing on: each test
    leaves it as it found it."""
    from zippy_tpu_torch import profiling

    was = profiling.enabled()
    yield
    (profiling.enable if was else profiling.disable)()


def rehearse(bench, *, trace=False, impl="program", seed=2**31 + 2227):
    return harness.run_cell(bench, CELL, seed, 0.3, trace,
                            t0=time.perf_counter(), device="cpu",
                            overrides=TINY, impl=impl)


@pytest.fixture(scope="module")
def cfg(bench):
    return {**bench.config(bench.cell(CELL)), **TINY}


@pytest.fixture(scope="module")
def tables(bench, cfg):
    return bench.payload(cfg, 2**33 + 41)


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_is_correct_as_the_program(bench, trace):
    result, lines = rehearse(bench, trace=trace)
    assert result["correct"], result
    assert result["failed"] == 0 and result["attempted"] >= 1
    checks = result["checks"]
    size = checks["entry_over_ref_pct"]
    assert size["value"] < size["at_most"]
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in bench.spec[kind]
               if CELL in m.get("workloads", [CELL])}
    if trace:
        # No card here: the launches and the device trace's metrics are
        # absent.
        assert set(result["metrics"]) == {
            "splice_share.zip", "framing_share.zip", "crc_share.zip",
            "host_wait_share.zip", "upload_MB_per_MB.zip",
            "fetch_used_pct.zip", "groups_per_MB.zip"}
        metrics = result["metrics"]
        # The rows are joined on the card: the host splices nothing.
        assert metrics["splice_share.zip"]["value"] == 0
        assert metrics["framing_share.zip"]["value"] > 0
        assert 0 < metrics["fetch_used_pct.zip"]["value"] <= 100
        assert metrics["groups_per_MB.zip"]["value"] > 0
        # Only the encode groups' row lengths go up: 16 bytes a row.
        assert 0 < metrics["upload_MB_per_MB.zip"]["value"] < 0.01
    else:
        assert set(result["metrics"]) == allowed - {"peak_device_MiB"}


def test_the_control_is_not_correct_on_size_alone(bench):
    control, _ = rehearse(bench, impl="control")
    assert not control["correct"]
    checks = control["checks"]
    assert checks["bad_outputs"]["value"] == 0
    assert checks["entry_over_ref_pct"]["value"] > \
        checks["entry_over_ref_pct"]["at_most"]


@pytest.mark.parametrize("where", ["stream", "local_header", "central",
                                   "end_record"])
def test_a_changed_byte_is_not_correct(bench, monkeypatch, where):
    import zippy_tpu_torch as zt

    real = zt.create_zip_archive

    def changed(entries, **kwargs):
        out = bytearray(real(entries, **kwargs))
        at = {"stream": 100, "local_header": 6,
              "central": out.rfind(b"PK\x01\x02") + 8,
              "end_record": len(out) - 10}[where]
        out[at] ^= 0x01
        return bytes(out)

    monkeypatch.setattr(zt, "create_zip_archive", changed)
    result, _ = rehearse(bench)
    assert not result["correct"], result["checks"]
    assert result["checks"]["bad_outputs"]["value"] >= 1


def test_the_reference_reads_its_own_archive(tables):
    ref = harness.load(harness.HERE / "reference" / "zip_ref.py", "t_")
    blob = ref.write_zip(tables)
    crcs = {name: zlib.crc32(data) for name, data in tables.items()}
    problems, sizes = ref.archive_problems(blob, tables, crcs, {})
    assert problems == [] and list(sizes) == list(tables)


@pytest.mark.parametrize("name", list(COLUMNS))
def test_each_row_has_its_clause_columns_and_keys(cfg, tables, name):
    sf = cfg["scale_factor"]
    parts, supps = int(200_000 * sf), int(10_000 * sf)
    custs, step = int(150_000 * sf), cfg["chunk"]
    rows = [r.split("|") for r in tables[name].decode("ascii").splitlines()]
    assert rows
    for r in rows:
        assert len(r) == COLUMNS[name] + 1 and r[-1] == "", r
    keys = [int(r[0]) for r in rows]
    if name == "part.tbl":
        per = parts // cfg["chunks"]
        assert keys == list(range((step - 1) * per + 1, step * per + 1))
        assert all(len(r[1].split()) == 5 == len(set(r[1].split()))
                   for r in rows)
    elif name == "partsupp.tbl":
        assert all(1 <= int(r[1]) <= supps for r in rows)
        assert len(rows) == 4 * len(set(keys))
    elif name in ("supplier.tbl", "customer.tbl"):
        total = supps if name == "supplier.tbl" else custs
        per = total // cfg["chunks"]
        assert keys == list(range((step - 1) * per + 1, step * per + 1))
        assert all(0 <= int(r[3]) <= 24 for r in rows)
        assert all(r[4].startswith(f"{int(r[3]) + 10}-") for r in rows)
    elif name == "orders.tbl":
        assert all(1 <= int(r[1]) <= custs and int(r[1]) % 3 for r in rows)
        assert all(k % 32 < 8 for k in keys)
    elif name == "lineitem.tbl":
        orders = {int(r.split("|")[0]) for r in
                  tables["orders.tbl"].decode().splitlines()}
        assert set(keys) == orders
        assert all(1 <= int(r[1]) <= parts and 1 <= int(r[2]) <= supps
                   for r in rows)
    elif name == "nation.tbl":
        assert keys == list(range(25))
        assert all(0 <= int(r[2]) <= 4 for r in rows)
    else:
        assert keys == list(range(5))


def test_the_orders_are_their_lineitems_orders(tables):
    lines: dict = {}
    for r in tables["lineitem.tbl"].decode().splitlines():
        f = r.split("|")
        price, disc, tax = (round(float(v) * 100) for v in f[5:8])
        total, status = lines.get(int(f[0]), (0, set()))
        lines[int(f[0])] = (total + price * (100 - disc) // 100
                            * (100 + tax) // 100, status | {f[9]})
    for r in tables["orders.tbl"].decode().splitlines():
        f = r.split("|")
        total, status = lines[int(f[0])]
        assert round(float(f[3]) * 100) == total
        assert f[2] == (status.pop() if len(status) == 1 else "P")
