"""Host syncs counted with CUDA's sync debug mode (``chip_smoke.py``'s
``_count_syncs``)."""

from __future__ import annotations

import warnings

import torch


def count_syncs(run) -> int:
    """Run ``run()`` with the sync debug mode on and count the operations it
    warns about: reads to the host and blocking copies."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)
