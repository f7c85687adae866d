"""Device choice and the port's float32 policy.

Every public entry takes an explicit ``device``.  The default is ``"cuda"``
and it raises when there is no card: the port never falls back to the CPU
on its own.  ``"cpu"`` runs the plain PyTorch versions of the kernels and is
taken only when asked for (the parity tests do).  ``device_kind`` reports
what torch sees, and ``profile_trace`` writes a ``torch.profiler`` trace
around a block (the JAX package's ``utils/device.py``; its
``enable_persistent_compile_cache`` has no counterpart: the port's kernel
and codec builds are cached by source hash under ``build/``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch


def pin_fp32() -> None:
    """True float32 everywhere: the JAX tracking product runs at
    ``Precision.HIGHEST``, and TF32's ~3 decimal digits would move the speed
    curve by far more than the ~5e-7 that flips a dither rounding."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """Validate ``device`` ("cuda", "cuda:N" or "cpu") and pin the fp32
    policy.  Raises when CUDA is asked for and no card is present."""
    pin_fp32()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch sees no CUDA card; "
                "pass device='cpu' to run the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev


def as_device_tensor(x, device="cuda", dtype=None):
    """A tensor keeps its device (cast to ``dtype`` if given); anything else
    is uploaded to ``device`` (:func:`resolve_device`)."""
    if isinstance(x, torch.Tensor):
        pin_fp32()
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=resolve_device(device))


def best_device() -> torch.device:
    """The card, as :func:`resolve_device` ("cuda") gives it.  Raises without
    one: unlike the JAX package's, it does not fall back to the CPU."""
    return resolve_device("cuda")


def device_kind() -> str:
    """``"cuda"`` when torch sees a card, else ``"cpu"``.  Reports only:
    nothing chooses a device from it."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """``torch.profiler`` over the block (CPU activity, and CUDA where torch
    sees a card), written as one Chrome trace into ``log_dir``; does nothing
    when no ``log_dir`` is given."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        logging.info(f"Wrote profiler trace to {path}")
