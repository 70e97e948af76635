"""Share of the window spent in the decode's host planner and pack
(inflate_device._plan_tiles and _tile_pack)."""

SPANS = {"plan_pack": ["zippy_tpu_torch.ops.inflate_device:_plan_tiles",
                       "zippy_tpu_torch.ops.inflate_device:_tile_pack"]}


def read(run):
    if "plan_pack" not in run.spans:
        return None
    return 100.0 * run.spans["plan_pack"][1] / run.window_s
