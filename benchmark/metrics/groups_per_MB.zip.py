"""Encode groups the archive writer issued (calls of
deflate_device._encode_group) per 10^6 input bytes."""

SPANS = {"encode_group": ["zippy_tpu_torch.ops.deflate_device:_encode_group"]}


def read(run):
    if "encode_group" not in run.spans or not run.bytes_in:
        return None
    return run.spans["encode_group"][0] / (run.bytes_in / 1e6)
