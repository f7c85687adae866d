"""K1 and K2: the banded windowed-sinc resampler, CUDA kernels for Hopper.

K1 replaces ``pyaudiorestoration_tpu/kernels/sinc_pallas.py:
sinc_banded_pallas_dma_segments`` (Pallas body ``_kernel_dma`` and
``_shift_mac``): it loads each segment row's window from the signal itself.
K2 replaces ``sinc_pallas.py:sinc_banded_pallas`` (Pallas body ``_kernel``):
it reads a window buffer gathered beforehand.  Both are kernels of
``csrc/sinc_banded.cu``, which shares one tap loop between them and says in
its header what bounds them on the card and what the design does about that.

Each kernel has two entries.  The plan entries (``sinc_banded_plan`` for K1,
``sinc_banded_gathered_plan`` for K2) take each row's plan (endpoint speeds,
output count, base fraction) and build the row's grids inside the kernel,
bit-equal to :func:`segment_grids`; the main path calls them once over all
rows.  The grid entries (``sinc_banded``, ``sinc_banded_gathered``) take the
(T, max_n) grids themselves (K1's serves ``sinc_resample``'s banded branch).

The kernels are built at first use with ``nvcc`` into one shared library in
``build/torch_kernels/`` at the checkout root, under a name that hashes the
sources and flags (a stale build is never loaded), and bound with
``ctypes``.  Nothing is built or imported when this module is imported.

Every wrapper sends a CUDA tensor to its kernel (or raises) and a CPU tensor
to its plain PyTorch version, which ``chip_smoke.py`` also holds each entry
against on the card; each counts its kernel launches in the program's
counters (``utils.timing``): ``k1.launches`` and ``k2.launches``.
A failed build, load or launch raises :class:`KernelError`, and arguments
a kernel cannot take raise :class:`KernelArgumentError` (also a
``ValueError``), so callers that tolerate data faults can tell them apart.
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
import torch.nn.functional as F

from ..utils import timing

__all__ = ["KernelError", "KernelArgumentError", "sinc_banded", "sinc_banded_plain",
           "sinc_banded_plan", "sinc_banded_plan_plain", "sinc_banded_gathered",
           "sinc_banded_gathered_plan", "sinc_banded_gathered_plan_plain",
           "sinc_shift_mac", "gather_windows", "fixed_order_cumsum",
           "segment_grids", "build"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_SOURCES = ("sinc_banded.cu",)
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch."""


class KernelArgumentError(KernelError, ValueError):
    """A kernel wrapper was given arguments its kernel cannot take."""


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
        raise KernelError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return so


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRIES = {  # entry -> argtypes (pointers, sizes, then the stream)
    "sinc_banded_f32": [_P, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "sinc_banded_plan_f32": [_P, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "sinc_banded_gathered_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "sinc_banded_gathered_plan_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except OSError as e:
                raise KernelError(f"loading the kernel library failed: {e}") from e
            for name, argtypes in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def smem_bytes(max_n: int, nt: int, drift: int, plan: bool) -> int:
    """Shared memory of one CTA (``Layout`` in the CUDA source): two
    windows, the taper tables in whole blocks of 7 taps (8 floats), and for
    a plan entry the fc and cumsum grids with the scan's block totals."""
    def up(x, m):
        return -(-x // m) * m

    total = 2 * up(max_n + 2 * (nt + drift), 4) + 2 * 8 * -(-(nt - 1) // 7)
    if plan:
        scratch, n = 0, max_n
        while n > 16:
            n = -(-n // 16)
            scratch += n
        total += up(max_n, 4) + max_n + scratch
    return 4 * total


def _check_grids(bs, rel, in_seg, nt: int, drift: int):
    """Validate the (T, max_n) grids and the tap parameters; returns (T, max_n)."""
    if bs.dim() != 2:
        raise KernelArgumentError("bs must be (T, max_n)")
    T, max_n = bs.shape
    for name, t, dt in (("bs", bs, torch.float32), ("rel", rel, torch.float32),
                        ("in_seg", in_seg, torch.bool)):
        if t.dtype != dt or tuple(t.shape) != (T, max_n):
            raise KernelArgumentError(f"{name} must be {dt} of shape {(T, max_n)}")
    if nt < 1 or drift < 0:
        raise KernelArgumentError(f"need nt >= 1 and drift >= 0, got {nt}, {drift}")
    return T, max_n


def _check_plan(s_lo, s_hi, n, base_frac, max_n: int, nt: int, drift: int):
    """Validate the (T,) plan and the tap parameters; returns T."""
    if s_lo.dim() != 1:
        raise KernelArgumentError("s_lo must be (T,)")
    T = s_lo.shape[0]
    for name, t, dt in (("s_lo", s_lo, torch.float32), ("s_hi", s_hi, torch.float32),
                        ("n", n, torch.int32), ("base_frac", base_frac, torch.float32)):
        if t.dtype != dt or tuple(t.shape) != (T,):
            raise KernelArgumentError(f"{name} must be {dt} of shape {(T,)}")
    if max_n < 0 or nt < 1 or drift < 0:
        raise KernelArgumentError(f"need max_n >= 0, nt >= 1 and drift >= 0, got {max_n}, "
                         f"{nt}, {drift}")
    return T


def _kernel_device(name: str, tensors: dict, max_n: int, nt: int, drift: int,
                   plan: bool = False):
    """The one device of ``tensors``; for a CUDA device, also check what the
    kernel needs (contiguity; the row's window, taper and, for a plan entry,
    its grid scan in a block's shared memory)."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise KernelArgumentError(f"all inputs must be on one device, got {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise KernelArgumentError(f"{name} runs on cuda or cpu tensors, not {dev}")
    if dev.type == "cuda":
        for key, t in tensors.items():
            if not t.is_contiguous():
                raise KernelArgumentError(f"{key} must be contiguous")
        smem = smem_bytes(max_n, nt, drift, plan)
        if smem > 227 * 1024:
            raise KernelArgumentError(f"a row needs {smem} bytes of shared memory, over the "
                             "227 KB of a block")
    return dev


def _launch(entry: str, dev, args):
    """Call a kernel entry on the current stream of ``dev``; raise on a
    nonzero CUDA error."""
    lib = _load()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"{entry} kernel launch failed: CUDA error {rc}")


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
        raise KernelArgumentError("sig_flat must be a 1-D float32 tensor")
    if base_int.dtype != torch.int32 or tuple(base_int.shape) != (T,):
        raise KernelArgumentError(f"base_int must be int32 of shape {(T,)}")
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
    timing.count("k1.launches")
    return out


def sinc_banded_gathered(buf, bs, rel, in_seg, nt: int, drift: int):
    """K2: banded windowed-sinc resample of T segment rows -> (T, max_n)
    float32 from gathered windows (the interface of the Pallas ``_kernel``).

    ``buf`` (T, max_n + 2 (nt + drift)) float32: row i is the signal from
    ``base_int_i - (nt + drift)`` on, zero outside it (:func:`gather_windows`).
    ``bs``/``rel``/``in_seg`` (T, max_n): the grids of ``segment_grids``."""
    T, max_n = _check_grids(bs, rel, in_seg, nt, drift)
    L = max_n + 2 * (nt + drift)
    if buf.dtype != torch.float32 or tuple(buf.shape) != (T, L):
        raise KernelArgumentError(f"buf must be float32 of shape {(T, L)}")
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
    timing.count("k2.launches")
    return out


def sinc_banded_plan(sig_flat, base_int, s_lo, s_hi, n, base_frac, max_n: int,
                     nt: int, drift: int):
    """K1 from the per-segment plan: banded windowed-sinc resample of T rows
    -> (T, max_n) float32, each row's window loaded from the signal and its
    grids built in the kernel (bit-equal to :func:`segment_grids`).

    ``sig_flat`` (N,) float32: the signal (channels/takes flattened with zero
    guards, see ``_flatten_takes``).  ``base_int`` (T,) int32: each row's
    integer anchor.  ``s_lo``/``s_hi`` (T,) float32: the endpoint speeds;
    ``n`` (T,) int32: the output counts; ``base_frac`` (T,) float32.
    ``nt``: half the tap count (the sinc quality); ``drift``: the anchor
    drift bound of the plan."""
    T = _check_plan(s_lo, s_hi, n, base_frac, max_n, nt, drift)
    if sig_flat.dim() != 1 or sig_flat.dtype != torch.float32:
        raise KernelArgumentError("sig_flat must be a 1-D float32 tensor")
    if base_int.dtype != torch.int32 or tuple(base_int.shape) != (T,):
        raise KernelArgumentError(f"base_int must be int32 of shape {(T,)}")
    dev = _kernel_device("sinc_banded_plan", {
        "sig_flat": sig_flat, "base_int": base_int, "s_lo": s_lo, "s_hi": s_hi,
        "n": n, "base_frac": base_frac}, max_n, nt, drift, plan=True)
    if dev.type == "cpu":
        return sinc_banded_plan_plain(sig_flat, base_int, s_lo, s_hi, n, base_frac,
                                      max_n, nt, drift)
    out = torch.empty((T, max_n), dtype=torch.float32, device=dev)
    if T == 0 or max_n == 0:
        return out
    _launch("sinc_banded_plan_f32", dev, (
        sig_flat.data_ptr(), sig_flat.numel(), base_int.data_ptr(), s_lo.data_ptr(),
        s_hi.data_ptr(), n.data_ptr(), base_frac.data_ptr(), out.data_ptr(), T, max_n,
        nt, drift))
    timing.count("k1.launches")
    return out


def sinc_banded_gathered_plan(buf, s_lo, s_hi, n, base_frac, max_n: int, nt: int,
                              drift: int):
    """K2 from the per-segment plan: banded windowed-sinc resample of T rows
    -> (T, max_n) float32 from gathered windows, the grids built in the
    kernel (bit-equal to :func:`segment_grids`).

    ``buf`` (T, max_n + 2 (nt + drift)) float32: row i is the signal from
    ``base_int_i - (nt + drift)`` on, zero outside it (:func:`gather_windows`).
    The plan arguments are :func:`sinc_banded_plan`'s."""
    T = _check_plan(s_lo, s_hi, n, base_frac, max_n, nt, drift)
    L = max_n + 2 * (nt + drift)
    if buf.dtype != torch.float32 or tuple(buf.shape) != (T, L):
        raise KernelArgumentError(f"buf must be float32 of shape {(T, L)}")
    dev = _kernel_device("sinc_banded_gathered_plan", {
        "buf": buf, "s_lo": s_lo, "s_hi": s_hi, "n": n, "base_frac": base_frac},
        max_n, nt, drift, plan=True)
    if dev.type == "cpu":
        return sinc_banded_gathered_plan_plain(buf, s_lo, s_hi, n, base_frac, max_n,
                                               nt, drift)
    out = torch.empty((T, max_n), dtype=torch.float32, device=dev)
    if T == 0 or max_n == 0:
        return out
    _launch("sinc_banded_gathered_plan_f32", dev, (
        buf.data_ptr(), s_lo.data_ptr(), s_hi.data_ptr(), n.data_ptr(),
        base_frac.data_ptr(), out.data_ptr(), T, max_n, nt, drift))
    timing.count("k2.launches")
    return out


def reset_launches():
    """Set the launch counts of K1 and K2 to 0."""
    timing.reset_counters("k1.launches", "k2.launches")


def launches():
    """Launches of (K1, K2) since the last reset, over both entries of each."""
    c = timing.counters()
    return c.get("k1.launches", 0), c.get("k2.launches", 0)


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


def sinc_banded_plan_plain(sig_flat, base_int, s_lo, s_hi, n, base_frac, max_n: int,
                           nt: int, drift: int):
    """Plain PyTorch version of K1's plan entry: :func:`segment_grids`, then
    :func:`sinc_banded_plain`."""
    return sinc_banded_plain(sig_flat, base_int,
                             *segment_grids(s_lo, s_hi, n, base_frac, max_n), nt, drift)


def sinc_banded_gathered_plan_plain(buf, s_lo, s_hi, n, base_frac, max_n: int,
                                    nt: int, drift: int):
    """Plain PyTorch version of K2's plan entry: :func:`segment_grids`, then
    :func:`sinc_shift_mac`."""
    return sinc_shift_mac(buf, *segment_grids(s_lo, s_hi, n, base_frac, max_n),
                          max_n, nt, drift)


def fixed_order_cumsum(x, base: int = 16):
    """Float32 cumsum over the last axis in one fixed order: sequential
    inside ``base``-element blocks, block totals scanned the same way
    recursively and added back.  That is the order of XLA's CPU cumsum, so
    the sinc grids are bit-identical to the JAX reference's on the CPU, and
    the same on every run on the card (``torch.cumsum`` adds in float64 on
    the CPU and in a scan order of its own on CUDA; the grids' ``rel`` sums
    ~max_n terms, where a few ulps are ~1e-4 samples of position).  The plan
    entries' kernels scan in this order too."""
    n = x.shape[-1]
    if n <= base:
        cols = list(torch.unbind(x, dim=-1))
        for i in range(1, n):
            cols[i] = cols[i - 1] + cols[i]
        return torch.stack(cols, dim=-1) if n else x
    nb = -(-n // base)
    xb = F.pad(x, (0, nb * base - n)).reshape(*x.shape[:-1], nb, base)
    local = fixed_order_cumsum(xb, base)
    carry = fixed_order_cumsum(local[..., -1], base)
    excl = F.pad(carry[..., :-1], (1, 0))
    return (local + excl[..., None]).reshape(*x.shape[:-1], nb * base)[..., :n]


def segment_grids(s_lo, s_hi, nn, bf, max_n: int):
    """Per-segment block-speed / position grids (the reference's lerped block
    speeds, resampling.py:107-119).  Returns (bs, rel, in_seg): (T, max_n)
    lerped block speeds, positions relative to the integer window anchor,
    and the validity mask."""
    dev = s_lo.device
    kf = torch.arange(max_n, dtype=torch.float32, device=dev)[None, :]
    ki = torch.arange(max_n, dtype=torch.int32, device=dev)[None, :]
    denom = torch.clamp(nn[:, None] - 1, min=1).to(torch.float32)
    bs = s_lo[:, None] + kf / denom * (s_hi[:, None] - s_lo[:, None])
    in_seg = ki < nn[:, None]
    inv = torch.where(in_seg, 1.0 / bs, 0.0)
    rel = fixed_order_cumsum(inv) + bf[:, None]
    return bs, rel, in_seg
