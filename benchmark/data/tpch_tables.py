"""The payload "tpch_tables": TPC-H's eight tables as dbgen writes them to
`<table>.tbl` (`|`-separated fields, a `|` and a newline after the last),
for step `chunk` of `chunks` (dbgen's `-C`, `-S`) at scale factor
`scale_factor`, as {file name: bytes} in the configuration's `tables`
order. Each column follows the specification's clause 4.2.3 and each
table's rows clause 4.2.5, cut to the step as dbgen cuts them: the parts
(and their four PARTSUPP rows each), suppliers and customers of the step's
tenth of the keys, the step's orders, and LINEITEM from tpch_lineitem.py;
NATION and REGION are not chunked and come whole.

LINEITEM is tpch_lineitem.py's, byte for byte, and its text pool (clause
4.2.2.10's grammar) gives every table's comments. The orders are the
lineitems' orders: O_TOTALPRICE, O_ORDERSTATUS and O_ORDERDATE come from
the same draws of the seed (`_order_lines` makes them again). The other
columns draw from a generator of their own table, from the seed.

Pure numpy and Python on the host; the same seed gives the same bytes.
"""

from __future__ import annotations

import datetime
import importlib.util
import pathlib

import numpy as np


def _lineitem_module():
    """tpch_lineitem.py as a module of this file's own."""
    path = pathlib.Path(__file__).with_name("tpch_lineitem.py")
    spec = importlib.util.spec_from_file_location("_tables_tpch_lineitem",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LI = _lineitem_module()

# Clause 4.2.3's lists.
COLORS = (
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
    "green", "grey", "honeydew", "hot", "indian", "ivory", "khaki", "lace",
    "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
    "maroon", "medium", "metallic", "midnight", "mint", "misty", "moccasin",
    "navajo", "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
    "peru", "pink", "plum", "powder", "puff", "purple", "red", "rose",
    "rosy", "royal", "saddle", "salmon", "sandy", "seashell", "sienna",
    "sky", "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
    "tomato", "turquoise", "violet", "wheat", "white", "yellow")
TYPES = (("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"),
         ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"),
         ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
CONTAINERS = (("SM", "LG", "MED", "JUMBO", "WRAP"),
              ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"))
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
NATIONS = (("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
           ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
           ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
           ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
           ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
           ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
           ("UNITED KINGDOM", 3), ("UNITED STATES", 1))
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
# Clause 4.2.2.7: a v-string's characters, 64 of them.
VCHARS = np.frombuffer(
    b"0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ, ",
    np.uint8)
# Each table's rows, clause 4.2.5, at scale factor 1.
ROWS_AT_SF1 = {"part": 200_000, "supplier": 10_000, "customer": 150_000,
               "orders": 1_500_000}
# Each table's own generator is seeded by the run's seed and the table's place
# in dbgen's order; LINEITEM (6) draws from tpch_lineitem.py's.
TABLE_INDEX = {"part.tbl": 1, "partsupp.tbl": 2, "supplier.tbl": 3,
               "customer.tbl": 4, "orders.tbl": 5, "nation.tbl": 7,
               "region.tbl": 8}


def _step_keys(table: str, p: dict) -> np.ndarray:
    """The keys of `table` in step `chunk` of `chunks`, from 1."""
    per = int(ROWS_AT_SF1[table] * p["scale_factor"]) // p["chunks"]
    return np.arange((p["chunk"] - 1) * per + 1, p["chunk"] * per + 1,
                     dtype=np.int64)


def _rng(seed: int, table: str) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), TABLE_INDEX[table]])


class _Text:
    """Clause 4.2.2.10's text strings, substrings of the text pool."""

    def __init__(self, pool: str, rng: np.random.Generator):
        self.pool, self.rng = pool, rng

    def __call__(self, n: int, lo: int, hi: int) -> list:
        lens = self.rng.integers(lo, hi + 1, n)
        offs = self.rng.integers(0, len(self.pool) - hi + 1, n)
        return [self.pool[o:o + m] for o, m in zip(offs.tolist(),
                                                    lens.tolist())]


def _vstrings(rng, n: int, lo: int, hi: int) -> list:
    """Clause 4.2.2.7's random v-strings of `lo` to `hi` characters."""
    lens = rng.integers(lo, hi + 1, n)
    chars = VCHARS[rng.integers(0, len(VCHARS), int(lens.sum()))].tobytes()
    ends = np.cumsum(lens).tolist()
    return [chars[e - m:e].decode("ascii")
            for e, m in zip(ends, lens.tolist())]


def _phones(rng, nations: np.ndarray) -> list:
    """Clause 4.2.2.9: country code (nation key + 10) and three locals."""
    a, b = rng.integers(100, 1000, (2, len(nations)))
    c = rng.integers(1000, 10000, len(nations))
    return [f"{n + 10}-{x}-{y}-{z}" for n, x, y, z in
            zip(nations.tolist(), a.tolist(), b.tolist(), c.tolist())]


def _money(cents: int) -> str:
    sign = "-" if cents < 0 else ""
    return f"{sign}{abs(cents) // 100}.{abs(cents) % 100:02d}"


def _retail(partkey: np.ndarray) -> np.ndarray:
    """P_RETAILPRICE in cents."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def part(p: dict, rng, text) -> tuple[bytes, np.ndarray]:
    """PART's rows of the step and their keys."""
    key = _step_keys("part", p)
    n = len(key)
    names = np.argsort(rng.random((n, len(COLORS))), axis=1)[:, :5]
    mfgr = rng.integers(1, 6, n)
    brand = rng.integers(1, 6, n)
    kinds = [rng.integers(0, len(t), n) for t in TYPES]
    size = rng.integers(1, 51, n)
    box = [rng.integers(0, len(c), n) for c in CONTAINERS]
    comment = text(n, 5, 22)
    rows = [
        f"{k}|{' '.join(COLORS[c] for c in nm)}|Manufacturer#{m}|"
        f"Brand#{m}{b}|{TYPES[0][t0]} {TYPES[1][t1]} {TYPES[2][t2]}|{s}|"
        f"{CONTAINERS[0][c0]} {CONTAINERS[1][c1]}|{_money(r)}|{cm}|\n"
        for k, nm, m, b, t0, t1, t2, s, c0, c1, r, cm in zip(
            key.tolist(), names.tolist(), mfgr.tolist(), brand.tolist(),
            *(t.tolist() for t in kinds), size.tolist(),
            *(c.tolist() for c in box), _retail(key).tolist(), comment)]
    return "".join(rows).encode("ascii"), key


def partsupp(p: dict, rng, text, partkey: np.ndarray) -> bytes:
    """PARTSUPP's four rows a part of the step: the suppliers of clause
    4.2.3's formula."""
    supps = int(ROWS_AT_SF1["supplier"] * p["scale_factor"])
    pk = np.repeat(partkey, 4)
    i = np.tile(np.arange(4), len(partkey))
    sk = (pk + i * (supps // 4 + (pk - 1) // supps)) % supps + 1
    n = len(pk)
    qty = rng.integers(1, 10000, n)
    cost = rng.integers(100, 100001, n)
    comment = text(n, 49, 198)
    return "".join(
        f"{a}|{b}|{q}|{_money(c)}|{cm}|\n" for a, b, q, c, cm in zip(
            pk.tolist(), sk.tolist(), qty.tolist(), cost.tolist(),
            comment)).encode("ascii")


def _with_phrase(comment: str, rng, last: str) -> str:
    """`comment` with "Customer " ... `last` written over it at a random
    place, its length kept (S_COMMENT's complaints and recommendations)."""
    span = len(comment) - 9 - len(last)
    at = int(rng.integers(0, span + 1))
    gap = int(rng.integers(0, span - at + 1))
    end = at + 9 + gap
    return (comment[:at] + "Customer " + comment[at + 9:end] + last
            + comment[end + len(last):])


def supplier(p: dict, rng, text) -> bytes:
    """SUPPLIER's rows of the step; of the whole table's SF x 5 rows with
    "Customer%Complaints" and SF x 5 with "Customer%Recommends" in their
    comment, those of the step."""
    key = _step_keys("supplier", p)
    n = len(key)
    address = _vstrings(rng, n, 10, 40)
    nation = rng.integers(0, 25, n)
    phone = _phones(rng, nation)
    bal = rng.integers(-99999, 1000000, n)
    comment = text(n, 25, 100)
    marked = max(1, round(5 * p["scale_factor"]))
    total = int(ROWS_AT_SF1["supplier"] * p["scale_factor"])
    picks = rng.choice(np.arange(1, total + 1), 2 * marked, replace=False)
    first = int(key[0]) if n else 0
    for j, k in enumerate(picks.tolist()):
        if first <= k < first + n:
            comment[k - first] = _with_phrase(
                comment[k - first], rng,
                "Complaints" if j < marked else "Recommends")
    return "".join(
        f"{k}|Supplier#{k:09d}|{a}|{nk}|{ph}|{_money(b)}|{cm}|\n"
        for k, a, nk, ph, b, cm in zip(key.tolist(), address,
                                       nation.tolist(), phone, bal.tolist(),
                                       comment)).encode("ascii")


def customer(p: dict, rng, text) -> bytes:
    """CUSTOMER's rows of the step."""
    key = _step_keys("customer", p)
    n = len(key)
    address = _vstrings(rng, n, 10, 40)
    nation = rng.integers(0, 25, n)
    phone = _phones(rng, nation)
    bal = rng.integers(-99999, 1000000, n)
    seg = rng.integers(0, len(SEGMENTS), n)
    comment = text(n, 29, 116)
    return "".join(
        f"{k}|Customer#{k:09d}|{a}|{nk}|{ph}|{_money(b)}|{SEGMENTS[s]}|"
        f"{cm}|\n"
        for k, a, nk, ph, b, s, cm in zip(key.tolist(), address,
                                          nation.tolist(), phone,
                                          bal.tolist(), seg.tolist(),
                                          comment)).encode("ascii")


def _order_lines(p: dict, seed: int) -> tuple:
    """The step's orders as tpch_lineitem draws them from the seed: (order
    keys, order dates as days from START, each order's total price in
    cents, each order's status), from the same draws in the same order."""
    rng = LI.rng_for(seed)
    sf = p["scale_factor"]
    per = int(ROWS_AT_SF1["orders"] * sf) // p["chunks"]
    idx = np.arange((p["chunk"] - 1) * per + 1, p["chunk"] * per + 1,
                    dtype=np.int64)
    orderkey = ((idx >> 3) << 5) | (idx & 7)
    span = (LI.END - LI.START).days
    orderdate = rng.integers(0, span - 151 + 1, per)
    lines = rng.integers(1, 8, per)
    n = int(lines.sum())
    order = np.repeat(np.arange(per), lines)
    partkey = rng.integers(1, int(ROWS_AT_SF1["part"] * sf) + 1, n)
    rng.integers(0, 4, n)                       # the supplier's corner
    quantity = rng.integers(1, 51, n)
    price = quantity * _retail(partkey)
    discount = rng.integers(0, 11, n)
    tax = rng.integers(0, 9, n)
    ship = orderdate[order] + rng.integers(1, 122, n)
    # dbgen: ((eprice * (100 - discount)) / 100) * (100 + tax) / 100, in
    # whole cents a line.
    line = (price * (100 - discount)) // 100 * (100 + tax) // 100
    total = np.bincount(order, weights=line, minlength=per).astype(np.int64)
    open_lines = np.bincount(order, weights=ship > (LI.CURRENT
                                                    - LI.START).days,
                             minlength=per).astype(np.int64)
    status = np.where(open_lines == 0, "F",
                      np.where(open_lines == lines, "O", "P"))
    return orderkey, orderdate, total, status


def orders(p: dict, seed: int, rng, text) -> bytes:
    """ORDERS' rows of the step: the orders of tpch_lineitem's chunk."""
    key, date, total, status = _order_lines(p, seed)
    n = len(key)
    customers = int(ROWS_AT_SF1["customer"] * p["scale_factor"])
    # O_CUSTKEY is never a multiple of 3: the k-th key not divisible by 3.
    k = rng.integers(0, customers - customers // 3, n)
    cust = k + k // 2 + 1
    prio = rng.integers(0, len(PRIORITIES), n)
    clerk = rng.integers(1, max(1, int(1000 * p["scale_factor"])) + 1, n)
    comment = text(n, 19, 78)
    days = [(LI.START + datetime.timedelta(days=d)).isoformat()
            for d in range((LI.END - LI.START).days + 1)]
    return "".join(
        f"{ok}|{c}|{st}|{_money(t)}|{days[d]}|{PRIORITIES[pr]}|"
        f"Clerk#{cl:09d}|0|{cm}|\n"
        for ok, c, st, t, d, pr, cl, cm in zip(
            key.tolist(), cust.tolist(), status.tolist(), total.tolist(),
            date.tolist(), prio.tolist(), clerk.tolist(), comment)
    ).encode("ascii")


def nation(text) -> bytes:
    comment = text(len(NATIONS), 31, 114)
    return "".join(f"{k}|{name}|{r}|{cm}|\n" for k, ((name, r), cm) in
                   enumerate(zip(NATIONS, comment))).encode("ascii")


def region(text) -> bytes:
    comment = text(len(REGIONS), 31, 115)
    return "".join(f"{k}|{name}|{cm}|\n" for k, (name, cm) in
                   enumerate(zip(REGIONS, comment))).encode("ascii")


def tpch_tables(p: dict, seed: int) -> dict:
    """The step's eight tables, {file name: `.tbl` bytes}, in `tables`
    order."""
    pools = []
    make_pool = LI.text_pool
    LI.text_pool = lambda n, rng: pools.append(make_pool(n, rng)) or pools[-1]
    try:
        tables = {"lineitem.tbl": LI.tpch_lineitem(p, seed)}
    finally:
        LI.text_pool = make_pool
    (pool,) = pools

    def draws(name):
        rng = _rng(seed, name)
        return rng, _Text(pool, rng)

    tables["part.tbl"], partkey = part(p, *draws("part.tbl"))
    tables["partsupp.tbl"] = partsupp(p, *draws("partsupp.tbl"), partkey)
    tables["supplier.tbl"] = supplier(p, *draws("supplier.tbl"))
    tables["customer.tbl"] = customer(p, *draws("customer.tbl"))
    tables["orders.tbl"] = orders(p, seed, *draws("orders.tbl"))
    tables["nation.tbl"] = nation(draws("nation.tbl")[1])
    tables["region.tbl"] = region(draws("region.tbl")[1])
    return {name: tables[name] for name in p["tables"]}


def make(cfg: dict, seed: int) -> dict:
    """The payload of a configuration whose `payload` is "tpch_tables", for
    `seed`."""
    return tpch_tables(cfg, seed)
