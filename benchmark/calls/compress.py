"""Call: zippy_tpu_torch.compress on the card (engine "device") of the
configuration's payload, at its level and format. The payload is one uint8
tensor on the card, uploaded in set-up: the caller's own data, outside the
program's memory. Each call returns the stream as host bytes.

Judged: every kept stream is one whole member of the payload (framing,
body, CRC-32, ISIZE), and none is more than the configuration's
`stream_over_ref_pct_at_most` percent larger than the reference's stream at
the same level: an encoder that does less work per byte than its level
states is not the cell's encoder.

Control: the reference's stream at the configuration's `control_level`, a
level whose match search is cut.
"""

from __future__ import annotations

import hashlib

FORMATS = {"gzip": "dfGzip"}


class Call:
    def __init__(self, ctx):
        import torch

        import zippy_tpu_torch

        self.zt, self.ctx = zippy_tpu_torch, ctx
        self.data = ctx.payload
        self.level = ctx.cfg["level"]
        self.fmt = getattr(zippy_tpu_torch, FORMATS[ctx.cfg["format"]])
        self.src = torch.frombuffer(bytearray(self.data),
                                    dtype=torch.uint8).to(ctx.device)

    def __call__(self) -> bytes:
        return self.zt.compress(self.src, self.level, self.fmt,
                                engine_name="device", device=self.ctx.device)

    def sizes(self, out: bytes) -> tuple[int, int]:
        return len(self.data), len(out)

    def judge(self, outs: list) -> tuple[list, dict]:
        """A line for each stream that is not a whole member of the payload
        (streams that are alike are judged once), and the largest stream's
        size over the reference's, in percent, beside its limit."""
        kinds: dict = {}
        for out in outs:
            key = hashlib.blake2b(out, digest_size=16).digest()
            kinds.setdefault(key, [out, 0])[1] += 1
        found = []
        for blob, count in kinds.values():
            why = self.ctx.ref.member_problem(blob, self.data)
            if why:
                found += [why] * count
        ref = len(self.ctx.ref.compress(self.data, self.level))
        worst = max((100.0 * (len(blob) / ref - 1.0)
                     for blob, _ in kinds.values()), default=None)
        return found, {"stream_over_ref_pct": {
            "value": worst,
            "at_most": self.ctx.cfg["stream_over_ref_pct_at_most"]}}

    def close(self) -> None:
        self.src = None

    def control(self):
        def cut_search() -> bytes:
            return self.ctx.ref.compress(self.data,
                                         self.ctx.cfg["control_level"])
        return cut_search
