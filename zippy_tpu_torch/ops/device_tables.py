"""The DEFLATE tables the encoder and its kernels read on the device, as
int64 tensors, one copy per device."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables

_CL_EXTRA = np.zeros(19, np.int32)
_CL_EXTRA[16:19] = (2, 3, 7)

CONSTS = {
    "len_idx": tables.LENGTH_TO_CODE_INDEX,
    "dist_lut": tables.DISTANCE_CODE_LUT,
    "base_len": tables.BASE_LENGTHS,
    "len_extra": tables.LENGTH_EXTRA_BITS,
    "base_dist": tables.BASE_DISTANCES,
    "dist_extra": tables.DISTANCE_EXTRA_BITS,
    "fixed_ll": tables.FIXED_LITLEN_LENGTHS[:286],
    "fixed_d": tables.FIXED_DISTANCE_LENGTHS,
    "fixed_ll_codes": tables.FIXED_LITLEN_CODES[:286],
    "fixed_d_codes": tables.FIXED_DISTANCE_CODES,
    "clcl_order": tables.CLCL_ORDER,
    "cl_extra": _CL_EXTRA,
}


@functools.cache
def const(name: str, device: torch.device) -> torch.Tensor:
    """A constant table as an int64 tensor on `device`."""
    return torch.from_numpy(CONSTS[name].astype(np.int64)).to(device)
