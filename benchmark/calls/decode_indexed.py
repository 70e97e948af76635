"""Call: zippy_tpu_torch.uncompress_device(array=True) of an indexed gzip
stream of the configuration's payload: members of `member_bytes` at its
level, each followed by the ZX sidecars of its decode index, which
zippy_tpu_torch.compress_device_indexed wrote in set-up from the payload
uploaded to the card. Each call decodes the stream, host bytes, into card
memory and returns the members there, one uint8 tensor each.

Judged on the card: after each call (`sizes`), every member against its
slice of the payload's copy on the card (members of `member_bytes`, the
last the rest), with one host sync; the verdict
and the byte count are kept and the tensors dropped, so no output outlives
its call and the window's peak memory is the codec's own. After the window
(`judge`): one problem for each call whose members were not the payload,
the plain reference's decode of the stream, and `sidecar_members`, the
reference's count of data members that carry a decode index, at least one
a member of the payload: a stream written without sidecars, decoded by the
scanned path, is not this cell's.

Control: the reference's own decode with one byte, at an offset drawn from
the seed, changed, returned as members on the card.
"""

from __future__ import annotations

import math
import random
import sys
import time


class Parts:
    """A call's output: its members on the card until `Call.sizes` has
    judged them, then only the verdict (None where they were the payload)
    and their byte count."""

    __slots__ = ("members", "nbytes", "problem")

    def __init__(self, members: list):
        self.members, self.nbytes, self.problem = members, 0, None


class Call:
    def __init__(self, ctx):
        import torch

        import zippy_tpu_torch

        self.zt, self.torch, self.ctx = zippy_tpu_torch, torch, ctx
        self.data = ctx.payload
        self.member = ctx.cfg["member_bytes"]
        self.src = torch.frombuffer(bytearray(self.data),
                                    dtype=torch.uint8).to(ctx.device)
        t0 = time.perf_counter()
        self.blob = zippy_tpu_torch.compress_device_indexed(
            self.src, ctx.cfg["level"], member_size=self.member,
            device=ctx.device)
        print(f"  set-up: the indexed stream, {len(self.blob)} bytes, "
              f"written in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        # The members' slices of the payload, and where each member's
        # comparison with its slice is written: one launch a member, one
        # reduction and one sync a call.
        self.slices = self.src.split(self.member)
        self.lengths = [int(s.numel()) for s in self.slices]
        self.differs = torch.empty_like(self.src, dtype=torch.bool)
        self.flags = self.differs.split(self.member)
        self.call_s = self.check_s = 0.0
        self.calls = self.checks = 0

    def __call__(self) -> Parts:
        t0 = time.perf_counter()
        out = Parts(self.zt.uncompress_device(self.blob, array=True,
                                              device=self.ctx.device))
        self.call_s += time.perf_counter() - t0
        self.calls += 1
        return out

    def sizes(self, out: Parts) -> tuple[int, int]:
        """Judges `out`'s members against the payload on the card and drops
        them: (stream bytes in, bytes out)."""
        t0 = time.perf_counter()
        members, out.members = out.members, None
        out.nbytes = sum(total for _, total in members)
        if [(int(buf.numel()), total) for buf, total in members] != [
                (n, n) for n in self.lengths]:
            out.problem = (f"{len(members)} members of {out.nbytes} bytes, "
                           f"not the payload's {len(self.data)} in "
                           f"{len(self.lengths)} members")
        else:
            for (buf, _), ref, flag in zip(members, self.slices, self.flags):
                self.torch.ne(buf, ref, out=flag)
            if self.differs.any().item():                   # the one sync
                bad = [i for i, flag in enumerate(self.flags) if flag.any()]
                out.problem = (f"{len(bad)} of {len(members)} members differ "
                               f"from the payload, the first member {bad[0]}")
        del members
        self.check_s += time.perf_counter() - t0
        self.checks += 1
        return len(self.blob), out.nbytes

    def judge(self, outs: list) -> tuple[list, dict]:
        found = [out.problem for out in outs if out.problem]
        ref = self.ctx.ref
        if ref.decode(self.blob) != self.data:
            found.append("the stream does not decode to the payload")
        try:
            count = ref.sidecar_members(self.blob)
        except ValueError as exc:
            found.append(f"stream: {exc}")
            count = None
        if self.checks and self.call_s:
            check = self.check_s / self.checks
            print(f"  the check after each call: {1e3 * check:.4f} ms, "
                  f"{100 * check * self.calls / self.call_s:.4f}% of a "
                  "call's mean time", file=sys.stderr)
        return found, {"sidecar_members": {
            "value": count,
            "at_least": math.ceil(len(self.data) / self.member)}}

    def close(self) -> None:
        self.src = self.slices = self.differs = self.flags = None

    def control(self):
        at = random.Random(self.ctx.seed).randrange(len(self.data))

        def corrupted() -> Parts:
            torch = self.torch
            data = bytearray(self.ctx.ref.decode(self.blob))
            data[at] ^= 0x01
            flat = torch.frombuffer(data, dtype=torch.uint8).to(
                self.ctx.device)
            return Parts([(part, int(part.numel()))
                          for part in flat.split(self.member)])
        return corrupted
