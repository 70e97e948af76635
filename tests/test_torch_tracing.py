"""zippy_tpu_torch.profiling's spans, counters and call records on the CPU:
off by default and then inert, one record per compress/uncompress with the
spans PERF.md names, self times that add up to the call, the copy and scan
counters against what was copied and scanned, outputs unchanged by tracing,
the stage mode, and the labels under a profiler."""

import gzip
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zippy_tpu_torch as zt  # noqa: E402
from zippy_tpu_torch import gzip_format, parallel, profiling  # noqa: E402
from zippy_tpu_torch.ops import deflate_device as dd  # noqa: E402
from zippy_tpu_torch.ops import inflate_device as idev  # noqa: E402
from _torch_parity import mixed_payload, one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

TEXT = mixed_payload(40_000, 61)
MORE = mixed_payload(30_000, 62)

# The spans a call on the CPU makes (PERF.md, section 3); "encode.wait"
# waits on a card's event and needs a card.
COMPRESS_SPANS = {"framing", "encode.issue", "find_tokens", "kraft", "pack",
                  "join", "fetch", "checksums", "checksum.wait"}
UNCOMPRESS_SPANS = {"framing", "scan", "plan_pack", "upload", "tables",
                    "extract", "resolve", "checksums", "checksum.wait",
                    "fetch"}


@pytest.fixture(autouse=True)
def tracing_restored():
    """Each test starts with tracing off and leaves it as it found it."""
    was = profiling.enabled()
    profiling.disable()
    yield
    (profiling.enable if was else profiling.disable)()


def _traced(fn, *args, **kwargs):
    """fn's result and the record of the call, with tracing on."""
    profiling.enable()
    try:
        seq = _last_seq()
        out = fn(*args, **kwargs)
    finally:
        profiling.disable()
    (rec,) = profiling.recent(1)
    assert rec.seq != seq
    return out, rec


def _last_seq():
    last = profiling.recent(1)
    return last[0].seq if last else None


def _full_flush_stream(chunks: int) -> bytes:
    """A gzip stream with a full flush after each 1 KiB chunk: a Huffman
    block and an empty stored block a chunk."""
    co = zlib.compressobj(6, zlib.DEFLATED, 31)
    body = [co.compress(TEXT[i * 1024 % 30_000:][:1024])
            + co.flush(zlib.Z_FULL_FLUSH) for i in range(chunks)]
    return b"".join(body) + co.flush()


@pytest.mark.parametrize("under_profiler", [False, True])
def test_off_by_default_keeps_no_record_and_no_label(monkeypatch,
                                                     under_profiler):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    seq = _last_seq()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    if under_profiler:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]):
            blob = zt.compress(TEXT, 1, device="cpu")
            assert zt.uncompress(blob, device="cpu") == TEXT
    else:
        blob = zt.compress(TEXT, 1, device="cpu")
        assert zt.uncompress(blob, device="cpu") == TEXT
    assert _last_seq() == seq
    assert profiling.laps() is None


@pytest.mark.parametrize("direction", ["compress", "uncompress"])
def test_one_record_a_call_whose_self_times_sum_to_its_wall(direction):
    blob = zt.compress(TEXT + MORE, 6, device="cpu")
    if direction == "compress":
        _, rec = _traced(zt.compress, TEXT + MORE, 6, device="cpu")
        want = COMPRESS_SPANS
    else:
        _, rec = _traced(zt.uncompress, blob, device="cpu")
        want = UNCOMPRESS_SPANS
    assert rec.name == direction and not rec.failed
    assert set(rec.spans) == want
    wall = rec.end_ns - rec.start_ns
    assert abs(sum(s[1] for s in rec.spans.values()) + rec.self_ns
               - wall) < 1_000_000
    for n, self_ns, total_ns in rec.spans.values():
        assert n >= 1 and 0 <= self_ns <= total_ns <= wall
    assert rec.launches == 0                  # no kernel on the CPU


@pytest.mark.parametrize("case", ["compress_l1", "compress_l6",
                                  "uncompress_two_members"])
def test_outputs_identical_with_tracing_on_and_off(case):
    if case == "uncompress_two_members":
        blob = gzip.compress(TEXT, 6) + gzip.compress(MORE, 9)

        def run():
            return zt.uncompress(blob, device="cpu")
    else:
        level = int(case[-1])

        def run():
            return (gzip_format.write_member(TEXT, level,
                                             random_name_padding=False,
                                             device="cpu"),
                    zt.compress(MORE, level, zt.dfZlib, device="cpu"))
    off = run()
    on, rec = _traced(run)
    assert on == off
    if case == "uncompress_two_members":
        assert on == TEXT + MORE
        assert rec.spans["scan"][0] == 2      # a scan a member
    else:
        assert gzip.decompress(on[0]) == TEXT
        assert zlib.decompress(on[1]) == MORE


@pytest.mark.parametrize("stream,passes", [("small", 1),
                                           ("full_flush_300", 2),
                                           ("random_5m", 1)])
def test_scan_passes(stream, passes):
    """One pass where the first call's tables, sized from the stream's
    bytes, hold it: a stored block every 16 KiB of random bytes is 320 of
    them. Two where a flush every KiB outgrows them."""
    if stream == "small":
        blob = gzip.compress(TEXT, 6)
    elif stream == "random_5m":
        blob = gzip.compress(np.random.default_rng(63).integers(
            0, 256, 5 << 20, dtype=np.uint8).tobytes(), 6)
        index = idev.build_decode_index(blob, 80)
        assert index["stored"].shape[0] > 256
    else:
        blob = _full_flush_stream(300)
        index = idev.build_decode_index(blob, 80)
        assert index["block_lens"].shape[0] > 256
    out, rec = _traced(zt.uncompress, blob, device="cpu")
    assert out == gzip.decompress(blob)
    assert rec.counters["scan.passes"] == passes
    assert rec.spans["scan"][0] == 1


@pytest.mark.parametrize("direction", ["compress", "uncompress"])
def test_copy_counters_are_the_bytes_copied(monkeypatch, direction):
    seen = {"fetch": 0, "used": 0, "upload": 0}
    if direction == "compress":
        fetch_piece = dd._fetch_piece

        def fetch(piece, state):
            # A group's two state rows and its piece's bytes are copied; the
            # stream holds each piece's bytes but the first of one that
            # starts inside its predecessor's last byte.
            phase, bits, cut, data = fetch_piece(piece, state)
            seen["fetch"] += state.nbytes + data.nbytes
            seen["used"] += data.nbytes - (phase > 0)
            return phase, bits, cut, data

        monkeypatch.setattr(dd, "_fetch_piece", fetch)
        monkeypatch.setattr(dd, "_group_size", lambda k, block_size: 1)
        blob, rec = _traced(zt.compress, TEXT + MORE, 6, device="cpu")
        assert gzip.decompress(blob) == TEXT + MORE
        assert "upload.bytes" not in rec.counters
    else:
        upload, fetch_out = idev._upload_packs, idev._fetch

        def upload_packs(packs, device, keep):
            out = upload(packs, device, keep)
            seen["upload"] += out.nbytes
            return out

        def fetch(buf, stages=None):
            seen["fetch"] += buf.nbytes
            seen["used"] += buf.nbytes
            return fetch_out(buf, stages)

        monkeypatch.setattr(idev, "_upload_packs", upload_packs)
        monkeypatch.setattr(idev, "_fetch", fetch)
        blob = gzip.compress(TEXT + MORE, 6)
        out, rec = _traced(zt.uncompress, blob, device="cpu")
        assert out == TEXT + MORE
        assert rec.counters["upload.bytes"] == seen["upload"] > 0
    assert rec.counters["fetch.bytes"] == seen["fetch"] > 0
    assert rec.counters["fetch.used_bytes"] == seen["used"] > 0


def _decode_call(entry: str, whole: bytes, tmp_path):
    """(the decode of `whole` through one entry point, what it must
    return), its input made beforehand, untraced."""
    cut = [0, 15_000, 40_000, len(whole)]
    if entry == "uncompress_one_member":
        blob = gzip.compress(whole, 6)
        return lambda: zt.uncompress(blob, device="cpu"), whole
    if entry == "uncompress_three_members":
        blob = b"".join(gzip.compress(whole[a:b], 6)
                        for a, b in zip(cut, cut[1:]))
        assert len(gzip_format.member_indexes(blob)) == 3
        return lambda: zt.uncompress(blob, device="cpu"), whole
    if entry == "uncompress_parallel":
        blob = zt.compress_indexed(whole, 6, member_size=20_000,
                                   device="cpu")
        return lambda: zt.uncompress_parallel(blob, device="cpu"), whole
    if entry.startswith("uncompress_device"):
        blob = zt.compress_device_indexed(whole, 6, member_size=20_000,
                                          device="cpu")
        if entry.endswith("array"):
            return lambda: b"".join(
                buf.numpy().tobytes() for buf, _ in zt.uncompress_device(
                    blob, array=True, device="cpu")), whole
        return lambda: zt.uncompress_device(blob, device="cpu"), whole
    names = [f"f{i}.txt" for i in range(3)]
    archive = tmp_path / "a.zip"
    archive.write_bytes(zt.create_zip_archive(
        {n: whole[a:b] for n, a, b in zip(names, cut, cut[1:])},
        device="cpu"))

    def extract():
        zt.extract_all_zip(archive, tmp_path / "out", device="cpu")
        return b"".join((tmp_path / "out" / n).read_bytes() for n in names)
    return extract, whole


@pytest.mark.parametrize("entry", [
    "uncompress_one_member", "uncompress_three_members",
    "uncompress_parallel", "uncompress_device_bytes",
    "uncompress_device_array", "extract_all_zip"])
def test_each_decode_fetches_its_sums_once_a_pass(tmp_path, entry):
    """Every decode entry point dispatches its streams through
    inflate_streams, which waits on the card for the sums once a pass of
    up to 1 GiB of output: once here, whatever the number of members or
    entries."""
    whole = TEXT + MORE
    call, want = _decode_call(entry, whole, tmp_path)
    profiling.enable()
    try:
        seq = _last_seq()
        with profiling.call("decode"):
            out = call()
    finally:
        profiling.disable()
    (rec,) = profiling.recent(1)
    assert rec.seq != seq and out == want
    assert rec.spans["checksum.wait"][0] == 1


@pytest.mark.parametrize("bad", ["flipped_crc", "not_a_stream"])
def test_a_call_that_raises_leaves_a_failed_record(bad):
    if bad == "flipped_crc":
        blob = bytearray(gzip.compress(TEXT, 6))
        blob[-8] ^= 0xFF
    else:
        blob = b"neither gzip nor zlib, but long enough"
    profiling.enable()
    with pytest.raises(zt.ZippyError):
        zt.uncompress(bytes(blob), device="cpu")
    profiling.disable()
    (rec,) = profiling.recent(1)
    assert rec.name == "uncompress" and rec.failed
    assert rec.end_ns >= rec.start_ns
    assert "framing" in rec.spans


def test_the_records_kept_are_at_most_4096():
    profiling.enable()
    for _ in range(profiling.KEPT + 5):
        with profiling.call("empty"):
            with profiling.call("nested"):      # adds to the outer record
                profiling.count("n")
    profiling.disable()
    records = profiling.recent(10 * profiling.KEPT)
    assert len(records) == profiling.KEPT
    assert [r.seq for r in records] == list(range(
        records[0].seq, records[0].seq + profiling.KEPT))
    assert {r.name for r in records[-5:]} == {"empty"}
    assert records[-1].counters == {"n": 1}


@pytest.mark.parametrize("label", ["zt.scan", "zt.splice", "zt.compress",
                                   "zt.uncompress"])
def test_spans_label_the_profiler_under_trace(tmp_path, label):
    with profiling.trace(str(tmp_path)) as prof:
        blob = zt.compress(TEXT, 1, device="cpu")
        assert zt.uncompress(blob, device="cpu") == TEXT
        # The host splice now joins a run that does not start the stream.
        two_runs = parallel.deflate_sharded(TEXT + MORE, 1, ["cpu"] * 2)
        assert zlib.decompress(two_runs, -15) == TEXT + MORE
    assert not profiling.enabled()              # on for the block alone
    assert label in {e.name for e in prof.events()}


@pytest.mark.parametrize("tracing", [False, True])
def test_stage_mode_adds_seconds_whether_tracing_or_not(tracing):
    stages: dict = {}
    if tracing:
        profiling.enable()
    with profiling.call("staged"):
        with profiling.span("a", stages):
            with profiling.span("a", stages):   # the same name: not again
                np.arange(1000).sum()
        with profiling.span("b", stages, torch.device("cpu")):
            pass
    profiling.disable()
    assert set(stages) == {"a", "b"} and all(v >= 0 for v in stages.values())
    if tracing:
        rec = profiling.recent(1)[0]
        assert rec.name == "staged"
        assert rec.spans["a"][0] == 1 and rec.spans["b"][0] == 1


def test_the_inflate_stages_keep_their_names():
    stages: dict = {}
    blob = zlib.compress(TEXT, 6)[2:-4]
    assert idev.inflate_device(blob, device="cpu", stages=stages) == TEXT
    assert set(stages) == {"scan", "plan_pack", "upload", "tables", "extract",
                           "resolve", "checksums", "fetch"}
    stages = {}
    x = torch.from_numpy(np.frombuffer(TEXT + MORE, np.uint8).copy())
    assert zlib.decompress(dd.deflate_array(x, 6, stages=stages),
                           -15) == TEXT + MORE
    assert set(stages) == {"find_tokens", "kraft", "pack", "join", "fetch"}


def test_laps_charge_each_step_and_reach_the_record_once_closed():
    import time

    profiling.enable()
    with profiling.call("laps"):
        with profiling.span("group"):
            lap = profiling.laps()
            for name, seconds in (("a", 0.002), ("b", 0.001), ("a", 0.003)):
                time.sleep(seconds)
                lap(name)
            assert "a" not in profiling._local.rec.spans    # not yet
            lap.close()
    profiling.disable()
    rec = profiling.recent(1)[0]
    assert rec.spans["a"][0] == 2 and rec.spans["b"][0] == 1
    assert rec.spans["a"][1] == rec.spans["a"][2] >= 5_000_000
    assert 1_000_000 <= rec.spans["b"][1] < rec.spans["a"][1]
    group = rec.spans["group"]
    assert group[1] == group[2] - rec.spans["a"][1] - rec.spans["b"][1]
    assert group[1] < 1_000_000
