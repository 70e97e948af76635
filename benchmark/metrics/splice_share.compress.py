"""Share of the window spent inside deflate_device._splice_group, the host's
splice of each fetched encode group onto its streams."""

SPANS = {"splice": ["zippy_tpu_torch.ops.deflate_device:_splice_group"]}


def read(run):
    if "splice" not in run.spans:
        return None
    return 100.0 * run.spans["splice"][1] / run.window_s
