"""Small host constants (weights, fit matrices), copied to a device once.

A copy from the host to the card drains the card's stream, and the
integrations and spectral fits that need these constants run inside the
minor loops; so each distinct constant is copied once per device and then
served from this cache.  The cache holds at most ``MAX_ENTRIES`` tensors and
drops the least recently used one past that.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

MAX_ENTRIES = 256

_cache: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(host, device=device)


def device_const(values, device) -> torch.Tensor:
    """``values`` as a float32 tensor on ``device``, shared by every caller
    that asks for the same values there; callers must not write to it."""
    host = np.ascontiguousarray(values, np.float32)
    device = torch.device(device)
    key = (host.tobytes(), host.shape, device)
    tensor = _cache.get(key)
    if tensor is None:
        tensor = _cache[key] = _upload(host, device)
        if len(_cache) > MAX_ENTRIES:
            _cache.popitem(last=False)
    else:
        _cache.move_to_end(key)
    return tensor
