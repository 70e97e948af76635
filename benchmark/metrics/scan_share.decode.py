"""Share of the window spent inside the decode's host scan
(inflate_device.inflate_scan, which build_decode_index and the archive
layer's decode_entries reach)."""

SPANS = {"scan": ["zippy_tpu_torch.ops.inflate_device:inflate_scan"]}


def read(run):
    if "scan" not in run.spans:
        return None
    return 100.0 * run.spans["scan"][1] / run.window_s
