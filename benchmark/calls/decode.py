"""Call: zippy_tpu_torch.uncompress on the card (engine "device") of one
stream of the configuration's payload that the reference made in set-up at
the configuration's level: a foreign stream (CPython's zlib, with no
index). Each call returns the payload as host bytes.

Judged: every kept output is the payload, byte for byte.

Control: the reference's own decode with one byte, at an offset drawn from
the seed, changed: a silent corruption, which the codec's checksums exist to
stop.
"""

from __future__ import annotations

import random


class Call:
    def __init__(self, ctx):
        import zippy_tpu_torch

        self.zt, self.ctx = zippy_tpu_torch, ctx
        self.data = ctx.payload
        self.blob = ctx.ref.compress(self.data, ctx.cfg["level"])

    def __call__(self) -> bytes:
        return self.zt.uncompress(self.blob, engine_name="device",
                                  device=self.ctx.device)

    def sizes(self, out: bytes) -> tuple[int, int]:
        return len(self.blob), len(out)

    def judge(self, outs: list) -> tuple[list, dict]:
        found = []
        for out in outs:
            why = (None if out == self.data
                   else self.ctx.ref.bytes_problem(out, self.data))
            if why:
                found.append(why)
        return found, {}

    def close(self) -> None:
        pass

    def control(self):
        at = random.Random(self.ctx.seed).randrange(len(self.data))

        def corrupted() -> bytes:
            out = bytearray(self.ctx.ref.decode(self.blob))
            out[at] ^= 0x01
            return bytes(out)
        return corrupted
