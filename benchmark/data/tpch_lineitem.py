"""The payload "tpch_lineitem": rows of TPC-H's LINEITEM table as dbgen
writes them to `lineitem.tbl` (`|`-separated fields, a `|` and a newline
after the last), for chunk `chunk` of `chunks` (dbgen's `-C`, `-S`) at scale
factor `scale_factor`, from a configuration's keys and the run's seed. Each
column follows the specification's clause 4.2.3; the comments are
substrings of `text_pool_bytes` of text made by clause 4.2.2.10's grammar
from clause 4.2.2.13's weighted word lists (the lists below), of
`comment_chars` characters. The seed draws every random value; the orders,
and so the keys, are the chunk's.

Pure numpy and Python on the host; the same seed gives the same bytes.
"""

from __future__ import annotations

import datetime

import numpy as np

# The word lists of dbgen's dists.dss (TPC-H clause 4.2.2.13), with the
# words query 13's `%special%requests%` looks for: (word, weight). dbgen
# draws each with probability weight / the list's total.
NOUNS = (("packages", 40), ("requests", 40), ("accounts", 40),
         ("deposits", 40), ("foxes", 20), ("ideas", 20), ("theodolites", 20),
         ("pinto beans", 20), ("instructions", 20), ("dependencies", 10),
         ("excuses", 10), ("platelets", 10), ("asymptotes", 10),
         ("courts", 5), ("dolphins", 5), ("multipliers", 1),
         ("sauternes", 1), ("warthogs", 1), ("frets", 1), ("dinos", 1),
         ("attainments", 1), ("somas", 1), ("Tiresias", 1), ("patterns", 1),
         ("forges", 1), ("braids", 1), ("hockey players", 1), ("frays", 1),
         ("warhorses", 1), ("dugouts", 1), ("notornis", 1), ("epitaphs", 1),
         ("pearls", 1), ("tithes", 1), ("waters", 1), ("orbits", 1),
         ("gifts", 1), ("sheaves", 1), ("depths", 1), ("sentiments", 1),
         ("decoys", 1), ("realms", 1), ("pains", 1), ("grouches", 1),
         ("escapades", 1))
VERBS = (("sleep", 20), ("wake", 20), ("are", 20), ("cajole", 20),
         ("haggle", 20), ("nag", 10), ("use", 10), ("boost", 10),
         ("affix", 5), ("detect", 5), ("integrate", 5), ("maintain", 1),
         ("nod", 1), ("was", 1), ("lose", 1), ("sublate", 1), ("solve", 1),
         ("thrash", 1), ("promise", 1), ("engage", 1), ("hinder", 1),
         ("print", 1), ("x-ray", 1), ("breach", 1), ("eat", 1), ("grow", 1),
         ("impress", 1), ("mold", 1), ("poach", 1), ("serve", 1),
         ("run", 1), ("dazzle", 1), ("snooze", 1), ("doze", 1),
         ("unwind", 1), ("kindle", 1), ("play", 1), ("hang", 1),
         ("believe", 1), ("doubt", 1))
ADJECTIVES = (("special", 20), ("pending", 20), ("unusual", 20),
              ("express", 20), ("furious", 1), ("sly", 1), ("careful", 1),
              ("blithe", 1), ("quick", 1), ("fluffy", 1), ("slow", 1),
              ("quiet", 1), ("ruthless", 1), ("thin", 1), ("close", 1),
              ("dogged", 1), ("daring", 1), ("brave", 1), ("stealthy", 1),
              ("permanent", 1), ("enticing", 1), ("idle", 1), ("busy", 1),
              ("regular", 50), ("final", 40), ("ironic", 40), ("even", 30),
              ("bold", 20), ("silent", 10))
ADVERBS = (("sometimes", 1), ("always", 1), ("never", 1),
           ("furiously", 50), ("slyly", 50), ("carefully", 50),
           ("blithely", 40), ("quickly", 30), ("fluffily", 20), ("slowly", 1),
           ("quietly", 1), ("ruthlessly", 1), ("thinly", 1), ("closely", 1),
           ("doggedly", 1), ("daringly", 1), ("bravely", 1),
           ("stealthily", 1), ("permanently", 1), ("enticingly", 1),
           ("idly", 1), ("busily", 1), ("regularly", 1), ("finally", 1),
           ("ironically", 1), ("evenly", 1), ("boldly", 1), ("silently", 1))
PREPOSITIONS = (("about", 50), ("above", 50), ("according to", 50),
                ("across", 50), ("after", 50), ("against", 40),
                ("along", 40), ("alongside of", 30), ("among", 30),
                ("around", 20), ("at", 10), ("atop", 1), ("before", 1),
                ("behind", 1), ("beneath", 1), ("beside", 1),
                ("besides", 1), ("between", 1), ("beyond", 1), ("by", 1),
                ("despite", 1), ("during", 1), ("except", 1), ("for", 1),
                ("from", 1), ("in place of", 1), ("inside", 1),
                ("instead of", 1), ("into", 1), ("near", 1), ("of", 1),
                ("on", 1), ("outside", 1), ("over", 1), ("past", 1),
                ("since", 1), ("through", 1), ("throughout", 1), ("to", 1),
                ("toward", 1), ("under", 1), ("until", 1), ("up", 1),
                ("upon", 1), ("whithout", 1), ("with", 1), ("within", 1))
AUXILIARIES = tuple((w, 1) for w in (
    "do", "may", "might", "shall", "will", "would", "can", "could",
    "should", "ought to", "must", "will have to", "shall have to",
    "could have to", "should have to", "must have to", "need to", "try to"))
TERMINATORS = ((".", 50), (";", 1), (":", 1), ("?", 1), ("!", 1), ("--", 1))
# Clause 4.2.2.10: sentences, noun phrases and verb phrases. N a noun
# phrase, V a verb phrase, P a prepositional phrase ("<preposition> the
# <noun phrase>"), T a terminator; in a phrase N a noun, J an adjective,
# D an adverb, V a verb, X an auxiliary.
SENTENCES = (("NVT", 3), ("NVPT", 3), ("NVNT", 3), ("NPVNT", 1),
             ("NPVPT", 1))
NOUN_PHRASES = (("N", 10), ("JN", 20), ("J,JN", 10), ("DJN", 50))
VERB_PHRASES = (("V", 30), ("XV", 1), ("VD", 40), ("XVD", 1))

SHIP_INSTRUCT = ("DELIVER IN PERSON", "COLLECT COD", "NONE",
                 "TAKE BACK RETURN")
SHIP_MODE = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
START = datetime.date(1992, 1, 1)
END = datetime.date(1998, 12, 31)
CURRENT = datetime.date(1995, 6, 17)


def rng_for(seed: int) -> np.random.Generator:
    """numpy's generator for any whole number, negative or beyond 64 bits."""
    return np.random.default_rng(seed % (1 << 64))


def _draw(rng, table, n: int) -> list:
    words, weights = zip(*table)
    p = np.asarray(weights, float)
    return [words[i] for i in rng.choice(len(words), n, p=p / p.sum())]


def _phrases(rng, table, parts: dict, n: int) -> list:
    """`n` phrases of the weighted `table` of templates; each letter of a
    template takes the next word of `parts[letter]`, a comma stays on the
    word before it."""
    templates = _draw(rng, table, n)
    feeds = {k: iter(_draw(rng, v, n * 2)) for k, v in parts.items()}
    out = []
    for t in templates:
        words = []
        for ch in t:
            if ch == ",":
                words[-1] += ","
            else:
                words.append(next(feeds[ch]))
        out.append(" ".join(words))
    return out


def text_pool(n: int, rng) -> str:
    """At least `n` characters of sentences of the grammar, each ended by
    its terminator and a space."""
    out, size = [], 0
    while size < n:
        k = max(1024, (n - size) // 60)
        kinds = _draw(rng, SENTENCES, k)
        nps = iter(_phrases(rng, NOUN_PHRASES,
                            {"N": NOUNS, "J": ADJECTIVES, "D": ADVERBS},
                            3 * k))
        vps = iter(_phrases(rng, VERB_PHRASES,
                            {"V": VERBS, "X": AUXILIARIES, "D": ADVERBS}, k))
        preps = iter(_draw(rng, PREPOSITIONS, 2 * k))
        terms = iter(_draw(rng, TERMINATORS, k))
        for kind in kinds:
            words = []
            for ch in kind[:-1]:
                if ch == "N":
                    words.append(next(nps))
                elif ch == "V":
                    words.append(next(vps))
                else:
                    words.append(f"{next(preps)} the {next(nps)}")
            sentence = " ".join(words) + next(terms) + " "
            out.append(sentence)
            size += len(sentence)
    return "".join(out)[:n]


def _dates(days: np.ndarray, table: list) -> list:
    return [table[d] for d in days.tolist()]


def tpch_lineitem(p: dict, seed: int) -> bytes:
    """LINEITEM rows of one dbgen chunk (clause 4.2.3), as `.tbl` bytes."""
    rng = rng_for(seed)
    sf = p["scale_factor"]
    per = int(1_500_000 * sf) // p["chunks"]
    idx = np.arange((p["chunk"] - 1) * per + 1, p["chunk"] * per + 1,
                    dtype=np.int64)
    orderkey = ((idx >> 3) << 5) | (idx & 7)     # dbgen's sparse keys
    span = (END - START).days
    orderdate = rng.integers(0, span - 151 + 1, per)
    lines = rng.integers(1, 8, per)
    n = int(lines.sum())
    order = np.repeat(np.arange(per), lines)
    linenumber = np.arange(n) - np.repeat(np.cumsum(lines) - lines, lines) + 1
    parts, supps = int(200_000 * sf), int(10_000 * sf)
    partkey = rng.integers(1, parts + 1, n)
    corner = rng.integers(0, 4, n)
    suppkey = (partkey + corner * (supps // 4 + (partkey - 1) // supps)) \
        % supps + 1
    quantity = rng.integers(1, 51, n)
    retail = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    price = quantity * retail                    # in cents
    discount = rng.integers(0, 11, n)
    tax = rng.integers(0, 9, n)
    odate = orderdate[order]
    ship = odate + rng.integers(1, 122, n)
    commit = odate + rng.integers(30, 91, n)
    receipt = ship + rng.integers(1, 31, n)
    current = (CURRENT - START).days
    returnflag = np.where(receipt <= current,
                          np.where(rng.integers(0, 2, n) == 0, "R", "A"), "N")
    linestatus = np.where(ship > current, "O", "F")
    instruct = rng.integers(0, len(SHIP_INSTRUCT), n)
    mode = rng.integers(0, len(SHIP_MODE), n)
    pool = text_pool(p["text_pool_bytes"], rng)
    lo, hi = p["comment_chars"]
    clen = rng.integers(lo, hi + 1, n)
    coff = rng.integers(0, len(pool) - hi + 1, n)
    table = [(START + datetime.timedelta(days=d)).isoformat()
             for d in range(span + 160)]
    rows = [
        f"{ok}|{pk}|{sk}|{ln}|{q}|{c // 100}.{c % 100:02d}|0.{d:02d}|"
        f"0.{t:02d}|{rf}|{ls}|{sd}|{cd}|{rd}|{SHIP_INSTRUCT[si]}|"
        f"{SHIP_MODE[sm]}|{pool[o:o + m]}|\n"
        for ok, pk, sk, ln, q, c, d, t, rf, ls, sd, cd, rd, si, sm, o, m
        in zip(orderkey[order].tolist(), partkey.tolist(), suppkey.tolist(),
               linenumber.tolist(), quantity.tolist(), price.tolist(),
               discount.tolist(), tax.tolist(), returnflag.tolist(),
               linestatus.tolist(), _dates(ship, table),
               _dates(commit, table), _dates(receipt, table),
               instruct.tolist(), mode.tolist(), coff.tolist(),
               clen.tolist())]
    return "".join(rows).encode("ascii")


def make(cfg: dict, seed: int) -> bytes:
    """The payload of a configuration whose `payload` is "tpch_lineitem",
    for `seed`."""
    return tpch_lineitem(cfg, seed)
