"""Host state -> port tensors.

The wow/flutter path has no learned weights: its state is the host position
plan, the band limits and the banded DFT matrix.  ``plan_to_torch`` moves a
plan dict (the JAX package's or the port's own, both numpy) onto a device.
"""

from __future__ import annotations

import numpy as np
import torch


def plan_to_torch(plan: dict, device) -> dict:
    """``plan_positions``/``plan_positions_fast`` dict -> tensors on ``device``.

    ``n`` and ``base_int`` become int32, ``base_frac`` float32; ``max_n``
    and ``drift`` stay Python ints (they size the kernel's grid)."""
    return {
        "n": torch.as_tensor(np.asarray(plan["n"], np.int32), device=device),
        "base_int": torch.as_tensor(np.asarray(plan["base_int"], np.int32),
                                    device=device),
        "base_frac": torch.as_tensor(np.asarray(plan["base_frac"], np.float32),
                                     device=device),
        "max_n": int(plan["max_n"]),
        "drift": int(plan["drift"]),
    }
