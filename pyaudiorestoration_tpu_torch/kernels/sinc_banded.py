"""K1 and K2: the banded windowed-sinc resampler, CUDA kernels for Hopper.

K1 replaces ``pyaudiorestoration_tpu/kernels/sinc_pallas.py:
sinc_banded_pallas_dma_segments`` (Pallas body ``_kernel_dma`` and
``_shift_mac``): it loads each segment row's window from the signal itself.
K2 replaces ``sinc_pallas.py:sinc_banded_pallas`` (Pallas body ``_kernel``):
it reads a window buffer gathered beforehand.  Both are entries of
``csrc/sinc_banded.cu``, which shares one tap loop between them and says in
its header what bounds them on the card and what the design does about that.

The kernels are built at first use with ``nvcc`` into one shared library in
``build/torch_kernels/`` at the checkout root, under a name that hashes the
sources and flags (a stale build is never loaded), and bound with
``ctypes``.  Nothing is built or imported when this module is imported.

``sinc_banded`` (K1) and ``sinc_banded_gathered`` (K2) are the wrappers: a
CUDA tensor goes to the kernel (or the call raises), a CPU tensor goes to
the plain PyTorch version (``sinc_banded_plain``, ``sinc_shift_mac``), which
``chip_smoke.py`` also holds each kernel against on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["sinc_banded", "sinc_banded_plain", "sinc_banded_gathered",
           "sinc_shift_mac", "gather_windows", "build"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_SOURCES = ("sinc_banded.cu",)
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build() -> Path:
    """Compile the kernel sources (if this exact build is not there yet) and
    return the shared library's path."""
    srcs = [_CSRC / s for s in _SOURCES]
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    so = _BUILD_DIR / f"libsinc_banded_{h.hexdigest()[:16]}.so"
    if so.is_file():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.sinc_banded_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = lib.sinc_banded_gathered_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check_grids(bs, rel, in_seg, nt: int, drift: int):
    """Validate the (T, max_n) grids and the tap parameters; returns (T, max_n)."""
    if bs.dim() != 2:
        raise ValueError("bs must be (T, max_n)")
    T, max_n = bs.shape
    for name, t, dt in (("bs", bs, torch.float32), ("rel", rel, torch.float32),
                        ("in_seg", in_seg, torch.bool)):
        if t.dtype != dt or tuple(t.shape) != (T, max_n):
            raise ValueError(f"{name} must be {dt} of shape {(T, max_n)}")
    if nt < 1 or drift < 0:
        raise ValueError(f"need nt >= 1 and drift >= 0, got {nt}, {drift}")
    return T, max_n


def _kernel_device(name: str, tensors: dict, max_n: int, nt: int, drift: int):
    """The one device of ``tensors``; for a CUDA device, also check what the
    kernel needs (contiguity, the window in a block's shared memory)."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {dev}")
    if dev.type == "cuda":
        for key, t in tensors.items():
            if not t.is_contiguous():
                raise ValueError(f"{key} must be contiguous")
        smem = (max_n + 2 * (nt + drift) + 2 * nt) * 4
        if smem > 227 * 1024:
            raise ValueError(f"window of {smem} bytes exceeds a block's shared memory")
    return dev


def _launch(entry: str, dev, args):
    """Call a kernel entry on the current stream of ``dev``; raise on a
    nonzero CUDA error."""
    lib = _load()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")


def sinc_banded(sig_flat, base_int, bs, rel, in_seg, nt: int, drift: int):
    """K1: banded windowed-sinc resample of T segment rows -> (T, max_n)
    float32, each row's window loaded from the signal.

    ``sig_flat`` (N,) float32: the signal (channels/takes flattened with zero
    guards, see ``_flatten_takes``).  ``base_int`` (T,) int32: each row's
    integer anchor.  ``bs``/``rel``/``in_seg`` (T, max_n): the grids of
    ``segment_grids``.  ``nt``: half the tap count (the sinc quality);
    ``drift``: the anchor drift bound of the plan."""
    T, max_n = _check_grids(bs, rel, in_seg, nt, drift)
    if sig_flat.dim() != 1 or sig_flat.dtype != torch.float32:
        raise ValueError("sig_flat must be a 1-D float32 tensor")
    if base_int.dtype != torch.int32 or tuple(base_int.shape) != (T,):
        raise ValueError(f"base_int must be int32 of shape {(T,)}")
    dev = _kernel_device("sinc_banded", {
        "sig_flat": sig_flat, "base_int": base_int, "bs": bs, "rel": rel,
        "in_seg": in_seg}, max_n, nt, drift)
    if dev.type == "cpu":
        return sinc_banded_plain(sig_flat, base_int, bs, rel, in_seg, nt, drift)
    out = torch.empty((T, max_n), dtype=torch.float32, device=dev)
    if T == 0 or max_n == 0:
        return out
    _launch("sinc_banded_f32", dev, (
        sig_flat.data_ptr(), sig_flat.numel(), base_int.data_ptr(), bs.data_ptr(),
        rel.data_ptr(), in_seg.data_ptr(), out.data_ptr(), T, max_n, nt, drift))
    sinc_banded.launches += 1
    return out


sinc_banded.launches = 0  # kernel launches since the last reset


def sinc_banded_gathered(buf, bs, rel, in_seg, nt: int, drift: int):
    """K2: banded windowed-sinc resample of T segment rows -> (T, max_n)
    float32 from gathered windows (the interface of the Pallas ``_kernel``).

    ``buf`` (T, max_n + 2 (nt + drift)) float32: row i is the signal from
    ``base_int_i - (nt + drift)`` on, zero outside it (:func:`gather_windows`).
    ``bs``/``rel``/``in_seg`` (T, max_n): the grids of ``segment_grids``."""
    T, max_n = _check_grids(bs, rel, in_seg, nt, drift)
    L = max_n + 2 * (nt + drift)
    if buf.dtype != torch.float32 or tuple(buf.shape) != (T, L):
        raise ValueError(f"buf must be float32 of shape {(T, L)}")
    dev = _kernel_device("sinc_banded_gathered", {
        "buf": buf, "bs": bs, "rel": rel, "in_seg": in_seg}, max_n, nt, drift)
    if dev.type == "cpu":
        return sinc_shift_mac(buf, bs, rel, in_seg, max_n, nt, drift)
    out = torch.empty((T, max_n), dtype=torch.float32, device=dev)
    if T == 0 or max_n == 0:
        return out
    _launch("sinc_banded_gathered_f32", dev, (
        buf.data_ptr(), bs.data_ptr(), rel.data_ptr(), in_seg.data_ptr(),
        out.data_ptr(), T, max_n, nt, drift))
    sinc_banded_gathered.launches += 1
    return out


sinc_banded_gathered.launches = 0  # kernel launches since the last reset


def gather_windows(sig_flat, base_int, L: int, U: int):
    """(T, L) window buffer: row i is ``sig_flat[base_int_i - U + p]`` for p
    in [0, L), zero outside the signal (respeeder_device.py:565-567)."""
    n_sig = sig_flat.shape[0]
    idx = (base_int.to(torch.int64) - U)[:, None] + torch.arange(
        L, device=sig_flat.device)[None, :]
    inside = (idx >= 0) & (idx < n_sig)
    return torch.where(inside, sig_flat[idx.clamp(0, max(n_sig - 1, 0))],
                       torch.zeros((), dtype=sig_flat.dtype, device=sig_flat.device))


def sinc_banded_plain(sig_flat, base_int, bs, rel, in_seg, nt: int, drift: int):
    """Plain PyTorch version of K1 on any device: gather each row's window,
    then the shift-MAC of :func:`sinc_shift_mac` (K2's plain version)."""
    max_n = bs.shape[1]
    U = nt + drift
    buf = gather_windows(sig_flat, base_int, max_n + 2 * U, U)
    return sinc_shift_mac(buf, bs, rel, in_seg, max_n, nt, drift)


def sinc_shift_mac(buf, bs, rel, in_seg, max_n: int, nt: int, drift: int):
    """Port of ``respeeder_device.sinc_shift_mac``: 2*(nt+drift) passes, each
    sliding the (T, max_n + 2U) window ``buf`` one sample and accumulating
    ``sinc * cutoff * hann`` taps where the tap index lies in [-nt, nt)."""
    U = nt + drift
    ki = torch.arange(max_n, dtype=torch.int32, device=bs.device)[None, :]
    ind_local = torch.round(rel).to(torch.int32)
    shift = rel - ind_local
    fc = torch.clamp(bs, max=1.0)
    m = ind_local - ki  # |m| <= drift by the caller's drift contract
    out = torch.zeros(bs.shape, dtype=torch.float32, device=bs.device)
    for v in range(2 * U):
        jj = (v - U) - m
        valid = (jj >= -nt) & (jj < nt) & in_seg
        jf = jj.to(torch.float32)
        x = (jf - shift) * fc
        hann = 0.5 - 0.5 * torch.cos(math.pi * (jf + nt) / nt)
        w = torch.where(valid, torch.sinc(x) * fc * hann, 0.0)
        out = out + buf[:, v:v + max_n] * w
    return out
