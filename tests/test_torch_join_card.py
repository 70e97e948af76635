"""K10 (csrc/join.cu) on the card against its plain version
(join_kernels.join_rows_plain): the piece's bytes up to the group's last
bit and the state row, on every case of tests/_join_cases.py at every
start phase, on seeded random groups of 1 to 64 rows, and on the groups
the join must refuse; and whole streams of the card's encoder against the
CPU's. Marked `card`: it skips on a host without a CUDA card, and runs on
the card with
    ZIPPY_TPU_TEST_REAL=1 python -m pytest tests/test_torch_join_card.py
(no jax is imported, so the card's host needs none)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _join_cases as jc  # noqa: E402
from zippy_tpu_torch.ops import deflate_device as td  # noqa: E402
from zippy_tpu_torch.ops import join_kernels as jk  # noqa: E402
from zippy_tpu_torch.ops import kernel_build as kb  # noqa: E402

CASES = list(jc.cases(0))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(data: dict, last: int, phase: int, card) -> None:
    want, want_row = jc.join(data, last, phase)
    before = kb.LAUNCHES["join_rows"]
    got, row = jc.join(data, last, phase, card)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["join_rows"] == before + 1
    assert row.tolist() == want_row.tolist()
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("case", CASES)
def test_k10_equals_plain(card, case):
    for phase in range(8):
        rows, block, last = jc.cases(phase)[case]
        _same(jc.group(rows, 7, block), last, phase, card)


@pytest.mark.card
@pytest.mark.parametrize("seed", range(16))
def test_k10_equals_plain_on_random_groups(card, seed):
    rng = np.random.default_rng(seed)
    g = int(rng.integers(1, jk.MAX_ROWS + 1))
    for phase in range(8):
        _same(jc.group(jc.random_rows(g, 100 * seed + phase), seed), int(
            rng.integers(-1, g)), phase, card)


@pytest.mark.card
@pytest.mark.parametrize("bit", sorted(jk.ERRORS))
def test_k10_refuses_as_plain(card, bit):
    wn = jc.BLOCK // 2 + 8
    rows = [(2, 4000, 999, 1500), (0, 100, 0, 300), (1, 60, 0, 700)]
    change = {1: (2, (1, 32 * wn + 1, 0, 700)),
              2: (0, (2, 4000, 32 * jk.HDR_WORDS + 1, 1500)),
              4: (2, (3, 60, 0, 700)), 8: (1, (0, 100, 0, jc.BLOCK + 1))}
    if bit in change:
        rows[change[bit][0]] = change[bit][1]
    else:
        rows = [(1, 32 * wn, 0, 700)] * 2
    data = jc.group(rows, 3)
    want, want_row = jc.join(data, -1, 5)
    _, row = jc.join(data, -1, 5, card)
    assert row.tolist() == want_row.tolist() and row[jk.ERROR] == bit


@pytest.mark.card
@pytest.mark.parametrize("level", [-2, 1, 6, 9])
def test_card_stream_equals_cpu_stream(card, level):
    rng = np.random.default_rng(level + 10)
    text = b"".join(b"%d the quick brown fox jumps over %d lazy dogs\n"
                    % (i, i * 7 % 13) for i in range(6000))
    data = b"".join([text[:150_000], rng.integers(
        0, 256, 70_000, dtype=np.uint8).tobytes(), text[150_000:]])
    before = kb.LAUNCHES["join_rows"]
    got = td.deflate(data, level, 4096)
    assert kb.LAUNCHES["join_rows"] > before
    assert got == td.deflate(data, level, 4096, device="cpu")
