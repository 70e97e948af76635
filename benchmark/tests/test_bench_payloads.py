"""The input generator: the same bytes for a seed, other bytes for another,
and rows that keep TPC-H's rules for LINEITEM (clause 4.2.3)."""

import datetime
import zlib

import pytest

import harness
from conftest import HOME

payloads = harness.load(HOME / "data" / "tpch_lineitem.py", "t_data_")

SMALL = {"payload": "tpch_lineitem", "scale_factor": 0.001, "chunks": 10,
         "chunk": 1, "comment_chars": [10, 43], "text_pool_bytes": 1 << 16}


def _rows(data: bytes) -> list:
    return [line.split("|") for line in data.decode().splitlines()]


def test_lineitem_repeats_for_a_seed_and_differs_across_seeds():
    a = payloads.make(SMALL, 2**31 + 11)
    assert a == payloads.make(SMALL, 2**31 + 11)
    assert a != payloads.make(SMALL, 2**31 + 12)


def test_lineitem_takes_any_whole_seed():
    for seed in (0, -3, 2**31 + 5, 2**70):
        assert payloads.make(SMALL, seed).endswith(b"|\n")


def test_lineitem_rows_keep_the_specifications_rules():
    rows = _rows(payloads.make(SMALL, 2**31 + 13))
    day = datetime.date.fromisoformat
    orders: dict = {}
    for r in rows:
        assert len(r) == 17 and r[16] == ""
        (ok, pk, sk, ln, q, price, disc, tax, rf, ls, ship, commit,
         receipt, instruct, mode, comment) = r[:16]
        pk, sk, q = int(pk), int(sk), int(q)
        orders.setdefault(int(ok), []).append(int(ln))
        assert 1 <= pk <= 200 and 1 <= sk <= 10 and 1 <= q <= 50
        assert (sk - 1 - pk) % 10 in {(i * (10 // 4 + (pk - 1) // 10)) % 10
                                      for i in range(4)}
        retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
        assert price == f"{q * retail // 100}.{q * retail % 100:02d}"
        assert disc in {f"0.{d:02d}" for d in range(11)}
        assert tax in {f"0.{t:02d}" for t in range(9)}
        assert 1 <= (day(receipt) - day(ship)).days <= 30
        current = datetime.date(1995, 6, 17)
        assert rf == "N" if day(receipt) > current else rf in "RA"
        assert ls == ("O" if day(ship) > current else "F")
        assert instruct in payloads.SHIP_INSTRUCT
        assert mode in payloads.SHIP_MODE
        assert 10 <= len(comment) <= 43
    keys = sorted(orders)
    # dbgen's sparse keys: 8 of every 32, 150 orders in chunk 1 of 10.
    assert len(keys) == 150 and keys[:9] == [1, 2, 3, 4, 5, 6, 7, 32, 33]
    assert all(orders[k] == list(range(1, len(orders[k]) + 1))
               and len(orders[k]) <= 7 for k in keys)


def test_the_text_pool_speaks_the_grammar():
    pool = payloads.text_pool(20000, payloads.rng_for(3))
    assert len(pool) == 20000
    words = {w for table in (payloads.NOUNS, payloads.VERBS,
                             payloads.ADJECTIVES, payloads.ADVERBS,
                             payloads.PREPOSITIONS, payloads.AUXILIARIES)
             for entry, _ in table for w in entry.split()} | {"the"}
    for token in pool.split()[1:-1]:
        assert token.rstrip(".;:?!-,") in words, token


@pytest.mark.parametrize("seeds", [(1, 2**31 + 1, 2**33 + 1)])
def test_every_seed_gives_the_same_work(seeds):
    cfg = {**SMALL, "scale_factor": 0.05, "text_pool_bytes": 1 << 20}
    data = [payloads.make(cfg, s) for s in seeds]
    sizes = [len(d) for d in data]
    ratios = [len(zlib.compress(d, 6)) / len(d) for d in data]
    assert max(sizes) - min(sizes) < 0.01 * min(sizes), sizes
    assert max(ratios) - min(ratios) < 0.005 * min(ratios), ratios


def test_the_harness_finds_the_generator_by_the_payloads_name():
    assert harness.Bench().payload(SMALL, 5) == payloads.make(SMALL, 5)
    with pytest.raises(FileNotFoundError):
        harness.Bench().payload({**SMALL, "payload": "mixed_text"}, 1)
