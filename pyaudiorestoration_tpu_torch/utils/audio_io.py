"""Audio file I/O of the PyTorch/CUDA port, backed by its own native C++
codec (``../csrc/audioio.cpp``, a copy of the JAX package's).

The same functions, arguments and behaviour as
``pyaudiorestoration_tpu/utils/audio_io.py``: WAV and FLAC reads, float32
WAV/RF64 and 16/24-bit FLAC writes, the random-access ``StreamReader`` and
the incremental writers of the streamed tier, and the process-wide export
format that ``--flac-out`` sets.

The codec is compiled with the host C++ compiler at first use (never at
import) into ``build/torch_native/`` at the checkout root, under a name that
hashes the source and the flags, so a stale build is never loaded.  Where
no compiler is available, WAV reads and float32 WAV writes go through
:mod:`scipy.io.wavfile`, as in the JAX package; FLAC needs the codec.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["read_file", "write_file", "write_wav", "write_flac", "probe_file",
           "StreamReader", "StreamWriter", "FlacStreamWriter", "open_writer",
           "set_output_format", "out_ext", "build"]

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "audioio.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
# the flags of pyaudiorestoration_tpu/native/Makefile, so both builds encode
# the same bytes (-march=native: the library is built on the machine that
# runs it; the FLAC encoder's loops vectorize 4-8x wider with AVX)
_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native", "-shared")

_lib = None
_lib_lock = threading.Lock()


def build() -> Path:
    """Compile the codec (if this exact build is not there yet) and return
    the shared library's path.  Raises ``OSError`` if the compiler fails."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    so = _BUILD_DIR / f"libaudioio_{h.hexdigest()[:16]}.so"
    if so.is_file():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    cmd = [cxx, *_CXX_FLAGS, "-o", str(tmp), str(_SOURCE)]
    try:
        # bounded: a stuck toolchain or filesystem fails the build, not
        # every caller
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise OSError(f"building the audio codec failed: {e}") from e
    if r.returncode != 0:
        raise OSError(f"building the audio codec failed ({r.returncode}): "
                      f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return so


def _bind(lib):
    f, i, ll, vp, cp = (ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_char_p)
    sigs = {
        "audioio_open": (vp, [cp]),
        "audioio_sample_rate": (i, [vp]),
        "audioio_channels": (i, [vp]),
        "audioio_frames": (ll, [vp]),
        "audioio_read": (i, [vp, f]),
        "audioio_close": (None, [vp]),
        "audioio_write_wav_f32": (i, [cp, f, ll, i, i]),
        "audioio_write_wav_pcm16": (i, [cp, f, ll, i, i]),
        "audioio_stream_open": (vp, [cp]),
        "audioio_stream_sample_rate": (i, [vp]),
        "audioio_stream_channels": (i, [vp]),
        "audioio_stream_frames": (ll, [vp]),
        "audioio_stream_read": (i, [vp, ll, ll, f]),
        "audioio_stream_close": (None, [vp]),
        "audioio_write_flac": (i, [cp, f, ll, i, i, i, i]),
        "audioio_flac_wopen": (vp, [cp, i, i, i, i]),
        "audioio_flac_wwrite": (i, [vp, f, ll]),
        "audioio_flac_wclose": (i, [vp]),
        "audioio_probe": (i, [cp, ctypes.POINTER(i), ctypes.POINTER(i),
                              ctypes.POINTER(ll)]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _get_lib():
    """Load (building if necessary) the native codec, or None when it
    cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            try:
                path = build()
            except OSError:
                logging.exception("Building the native audio codec failed")
                return None
            _lib = _bind(ctypes.CDLL(str(path)))
    return _lib


def _floats(x):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def probe_file(path):
    """Header-only (sample_rate, channels, frames): no decode, no frame
    index.  ``frames`` can be 0 for a FLAC whose STREAMINFO omits the total;
    callers then open a :class:`StreamReader`."""
    lib = _get_lib()
    if lib is None:
        raise OSError("native audioio unavailable")
    sr, ch, fr = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    rc = lib.audioio_probe(str(path).encode(), ctypes.byref(sr), ctypes.byref(ch),
                           ctypes.byref(fr))
    if rc != 0:
        raise OSError(f"cannot probe {path}")
    return int(sr.value), int(ch.value), int(fr.value)


class StreamReader:
    """Random-access block reader over an audio file (native codec).

    WAV streams from disk; FLAC indexes its frame offsets once at open and
    decodes only the frames a read touches.  Usage::

        with StreamReader(path) as r:
            block = r.read(start_frame, num_frames)   # (num, channels) f32
    """

    def __init__(self, path):
        lib = _get_lib()
        if lib is None:
            raise OSError("native audioio unavailable")
        self._lib = lib
        self._h = lib.audioio_stream_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"Cannot open {path}")
        self.sample_rate = lib.audioio_stream_sample_rate(self._h)
        self.channels = lib.audioio_stream_channels(self._h)
        self.frames = lib.audioio_stream_frames(self._h)

    def read(self, start, count):
        count = min(count, self.frames - start)
        out = np.empty((count, self.channels), dtype=np.float32)
        ret = self._lib.audioio_stream_read(self._h, int(start), int(count), _floats(out))
        if ret != 0:
            raise OSError(f"stream read failed at {start} (+{count}): {ret}")
        return out

    def close(self):
        if self._h:
            self._lib.audioio_stream_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class StreamWriter:
    """Incremental float32 WAV writer, header patched on close (RF64 past
    4 GiB): blocks append as they leave the device, so peak host memory is
    one block whatever the take's length."""

    # fixed header layout (offsets): RIFF/RF64 @0, riff size @4, WAVE @8,
    # JUNK/ds64 @12 (28-byte payload @20, the BWF RF64 reservation pattern),
    # fmt @48 (16-byte payload @56), fact @72 (dwSampleLength @80),
    # data @84 (size @88), samples from @92
    _DS64_OFF, _FACT_OFF, _DATA_SIZE_OFF, _DATA_START = 12, 80, 88, 92

    def __init__(self, path, sr, channels):
        self.path = path
        self.sr = int(sr)
        self.channels = int(channels)
        self.frames = 0
        self._f = open(path, "wb")
        f = self._f
        f.write(b"RIFF" + (0).to_bytes(4, "little") + b"WAVE")
        # 28-byte JUNK reservation: rewritten in place as ds64 when the
        # final size exceeds the 32-bit RIFF fields (EBU Tech 3306)
        f.write(b"JUNK" + (28).to_bytes(4, "little") + b"\x00" * 28)
        f.write(b"fmt " + (16).to_bytes(4, "little"))
        f.write((3).to_bytes(2, "little"))                      # IEEE float
        f.write(self.channels.to_bytes(2, "little"))
        f.write(self.sr.to_bytes(4, "little"))
        f.write((self.sr * self.channels * 4).to_bytes(4, "little"))
        f.write((self.channels * 4).to_bytes(2, "little"))
        f.write((32).to_bytes(2, "little"))
        # non-PCM formats require a fact chunk
        f.write(b"fact" + (4).to_bytes(4, "little") + (0).to_bytes(4, "little"))
        f.write(b"data" + (0).to_bytes(4, "little"))

    def write(self, block):
        block = np.ascontiguousarray(np.asarray(block, dtype=np.float32))
        if block.ndim == 1:
            block = block[:, None]
        if block.shape[1] != self.channels:
            raise ValueError(f"block has {block.shape[1]} channels, "
                             f"the file {self.channels}")
        self._f.write(block.tobytes())
        self.frames += block.shape[0]

    def close(self):
        if self._f is None:
            return
        data_len = self.frames * self.channels * 4
        riff_size = self._DATA_START - 8 + data_len
        f = self._f
        u32_max = 0xFFFFFFFF
        if riff_size <= u32_max and self.frames <= u32_max:
            f.seek(4)
            f.write(riff_size.to_bytes(4, "little"))
            f.seek(self._FACT_OFF)
            f.write(self.frames.to_bytes(4, "little"))
            f.seek(self._DATA_SIZE_OFF)
            f.write(data_len.to_bytes(4, "little"))
        else:
            # > 4 GiB: finalize as RF64, sizes in the ds64 chunk and the
            # 32-bit fields holding the 0xFFFFFFFF sentinel
            f.seek(0)
            f.write(b"RF64" + u32_max.to_bytes(4, "little"))
            f.seek(self._DS64_OFF)
            f.write(b"ds64" + (28).to_bytes(4, "little")
                    + riff_size.to_bytes(8, "little")
                    + data_len.to_bytes(8, "little")
                    + self.frames.to_bytes(8, "little")
                    + (0).to_bytes(4, "little"))
            f.seek(self._FACT_OFF)
            f.write(u32_max.to_bytes(4, "little"))
            f.seek(self._DATA_SIZE_OFF)
            f.write(u32_max.to_bytes(4, "little"))
        f.close()
        self._f = None
        logging.info(f"Wrote {self.path} ({self.frames} frames, streamed)")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FlacStreamWriter:
    """Incremental FLAC writer (native encoder, STREAMINFO patched on
    close), quantized to ``bits`` (16 or 24); the same ``write(block)`` /
    ``close()`` contract as :class:`StreamWriter`."""

    def __init__(self, path, sr, channels, bits=24, level=1):
        lib = _get_lib()
        if lib is None:
            raise OSError("native audioio unavailable (FLAC needs it)")
        self._lib = lib
        self.path = path
        self.sr = int(sr)
        self.channels = int(channels)
        self.bits = int(bits)
        self.level = int(level)
        self.frames = 0
        self._h = lib.audioio_flac_wopen(os.fsencode(path), self.channels,
                                         self.sr, self.bits, self.level)
        if not self._h:
            raise OSError(f"Cannot open FLAC writer for {path}")

    def write(self, block):
        block = np.ascontiguousarray(np.asarray(block, dtype=np.float32))
        if block.ndim == 1:
            block = block[:, None]
        if block.shape[1] != self.channels:
            raise ValueError(f"block has {block.shape[1]} channels, "
                             f"the file {self.channels}")
        if self._lib.audioio_flac_wwrite(self._h, _floats(block), block.shape[0]) != 0:
            raise OSError(f"FLAC stream write failed for {self.path}")
        self.frames += block.shape[0]

    def close(self):
        if self._h is None:
            return
        rc = self._lib.audioio_flac_wclose(self._h)
        self._h = None
        if rc != 0:
            try:
                os.remove(self.path)
            finally:
                raise OSError(f"FLAC stream finalize failed for {self.path}")
        logging.info(f"Wrote {self.path} ({self.frames} frames, streamed FLAC)")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def open_writer(path, sr, channels, bits=None, level=None):
    """Streaming writer for ``path`` chosen by extension: ``.flac`` gets the
    incremental FLAC encoder, anything else float32 WAV/RF64.  ``bits`` and
    ``level`` default to the :func:`set_output_format` settings."""
    if str(path).lower().endswith(".flac"):
        return FlacStreamWriter(path, sr, channels,
                                bits=_OUT_FLAC_BITS if bits is None else bits,
                                level=_OUT_FLAC_LEVEL if level is None else level)
    return StreamWriter(path, sr, channels)


def read_file(audio_path):
    """Read a WAV or FLAC file.  Returns ``(signal, sample_rate,
    num_channels)``, ``signal`` float32 of shape (frames, channels)."""
    lib = _get_lib()
    if lib is not None:
        handle = lib.audioio_open(os.fsencode(audio_path))
        if not handle:
            raise OSError(f"Native audioio failed to decode {audio_path}")
        try:
            sr = lib.audioio_sample_rate(handle)
            channels = lib.audioio_channels(handle)
            frames = lib.audioio_frames(handle)
            signal = np.empty((frames, channels), dtype=np.float32)
            lib.audioio_read(handle, _floats(signal))
        finally:
            lib.audioio_close(handle)
        if frames == 0:
            raise AttributeError(f"Reading {audio_path} produced no samples")
        return signal, sr, channels
    # no codec: WAV only
    from scipy.io import wavfile

    sr, data = wavfile.read(audio_path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[:, None]
    return data, int(sr), data.shape[1]


def write_flac(path, signal, sr, bits_per_sample=16, level=1):
    """Write a FLAC file (native encoder).  ``signal``: (n,) or (n, C)
    float in [-1, 1], quantized to 16 or 24 bits; ``level`` 0 = fixed
    predictors only (fast), 1 = with an LPC candidate (smallest)."""
    lib = _get_lib()
    if lib is None:
        raise OSError("native audioio unavailable (FLAC needs it)")
    x = np.ascontiguousarray(np.asarray(signal, np.float32))
    if x.ndim == 1:
        x = x[:, None]
    rc = lib.audioio_write_flac(str(path).encode(), _floats(x), x.shape[0], x.shape[1],
                                int(sr), int(bits_per_sample), int(level))
    if rc != 0:
        raise OSError(f"FLAC write failed ({rc}) for {path}")
    return path


def write_wav(path, signal, sr, subtype="FLOAT"):
    """Write interleaved float32 (or, with another ``subtype``, 16-bit PCM)
    WAV.  ``signal``: (frames,) or (frames, channels)."""
    signal = np.ascontiguousarray(np.asarray(signal, dtype=np.float32))
    if signal.ndim == 1:
        signal = signal[:, None]
    frames, channels = signal.shape
    lib = _get_lib()
    if lib is not None:
        fn = lib.audioio_write_wav_f32 if subtype == "FLOAT" else lib.audioio_write_wav_pcm16
        if fn(os.fsencode(path), _floats(signal), frames, channels, int(sr)) != 0:
            raise OSError(f"Native audioio failed to write {path}")
        return
    from scipy.io import wavfile

    wavfile.write(path, int(sr), signal if subtype == "FLOAT" else
                  (np.clip(signal, -1, 1) * 32767).astype(np.int16))


# process-wide export format: every write_file call honours it, so one CLI
# flag (--flac-out) switches the pipeline's outputs to the archive format
_OUT_FORMAT = "wav"
_OUT_FLAC_BITS = 24
_OUT_FLAC_LEVEL = 1


def set_output_format(fmt, bits=24, level=1):
    """Select the export container of :func:`write_file`: "wav" (float32,
    the default) or "flac" (quantized to ``bits``, 16 or 24; ``level`` 0 =
    fast, 1 = small)."""
    global _OUT_FORMAT, _OUT_FLAC_BITS, _OUT_FLAC_LEVEL
    if fmt not in ("wav", "flac"):
        raise ValueError(f"unknown output format {fmt!r}")
    if fmt == "flac" and bits not in (16, 24):
        raise ValueError("FLAC output must be 16 or 24 bit")
    if level not in (0, 1):
        raise ValueError("FLAC level must be 0 (fast) or 1 (small)")
    _OUT_FORMAT = fmt
    _OUT_FLAC_BITS = int(bits)
    _OUT_FLAC_LEVEL = int(level)


def out_ext():
    """The current export extension, "wav" or "flac"."""
    return _OUT_FORMAT


def write_file(audio_path, signal, sr, channels=None, suffix="_out"):
    """Write ``signal`` to ``<audio_path without ext><suffix>.<ext>`` in the
    :func:`set_output_format` container; returns the output path."""
    out_path = f"{os.path.splitext(audio_path)[0]}{suffix}.{_OUT_FORMAT}"
    if _OUT_FORMAT == "flac":
        write_flac(out_path, signal, sr, _OUT_FLAC_BITS, _OUT_FLAC_LEVEL)
    else:
        write_wav(out_path, signal, sr)
    logging.info(f"Wrote {out_path}")
    return out_path
