"""Call: zippy_tpu_torch.create_zip_archive of the configuration's tables,
each held on the card as a 1-D uint8 tensor, uploaded once in set-up: the
caller's own data, outside the program's memory. Each call writes one zip64
archive of them, every entry deflated at the configuration's level (the
writer's own BestSpeed), and returns it as host bytes.

Judged: every kept archive holds the tables, by name and in order, each
deflated with its CRC-32 and size, in the writer's layout byte for byte
outside the streams, each stream inflating to exactly its table; and no
entry's stream is more than the configuration's
`entry_over_ref_pct_at_most` percent larger than zlib's raw stream of that
table at the same level: an encoder that does less work per byte than its
level states is not the cell's encoder.

Control: the reference's archive of the tables, zlib at the same level with
Huffman coding only (no match search).
"""

from __future__ import annotations

import hashlib
import zlib


class Call:
    def __init__(self, ctx):
        import torch

        import zippy_tpu_torch

        self.zt, self.ctx = zippy_tpu_torch, ctx
        self.tables = ctx.payload
        self.total = sum(map(len, self.tables.values()))
        self.src = {name: torch.frombuffer(bytearray(data),
                                           dtype=torch.uint8).to(ctx.device)
                    for name, data in self.tables.items()}

    def __call__(self) -> bytes:
        return self.zt.create_zip_archive(self.src, device=self.ctx.device)

    def sizes(self, out: bytes) -> tuple[int, int]:
        return self.total, len(out)

    def judge(self, outs: list) -> tuple[list, dict]:
        """A line for each archive that is not one of the tables (archives
        that are alike are judged once), and the largest entry stream's
        size over zlib's, in percent, beside its limit."""
        ref = self.ctx.ref
        kinds: dict = {}
        for out in outs:
            key = hashlib.blake2b(out, digest_size=16).digest()
            kinds.setdefault(key, [out, 0])[1] += 1
        crcs = {name: zlib.crc32(data) for name, data in self.tables.items()}
        level = self.ctx.cfg["level"]
        base = {name: len(ref.deflate(data, level))
                for name, data in self.tables.items()}
        found, judged, worst = [], {}, None
        for blob, count in kinds.values():
            why, sizes = ref.archive_problems(blob, self.tables, crcs, judged)
            found += [f"archive: {'; '.join(why)}"] * count if why else []
            if not why:
                for name, size in sizes.items():
                    over = 100.0 * (size / base[name] - 1.0)
                    worst = over if worst is None else max(worst, over)
        return found, {"entry_over_ref_pct": {
            "value": worst,
            "at_most": self.ctx.cfg["entry_over_ref_pct_at_most"]}}

    def close(self) -> None:
        self.src = None

    def control(self):
        def huffman_only() -> bytes:
            return self.ctx.ref.write_zip(self.tables, zlib.Z_HUFFMAN_ONLY)
        return huffman_only
