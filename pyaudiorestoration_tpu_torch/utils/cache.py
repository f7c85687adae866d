"""Spectrogram cache with stride reuse and optional on-disk persistence
(counterpart of pyaudiorestoration_tpu/utils/cache.py).

Reference: the in-session ``fft_storage`` keyed by (fft_size, channel, hop,
zeropad) with denser-hop stride reuse (spectrum.py:52-68, 355-389) — the
reference's "checkpoint" of expensive FFT work (SURVEY.md §5).

The cache holds tensors on its device (so a hit avoids both the recompute
and a host transfer; a denser entry is decimated there) and can spill to
``.npz`` files next to the audio.  The files keep the JAX package's names
(``<base>.fft_<fft>_<ch>_<hop>_<zp>.npz``) and key (``spec``), so a cache
written by either package is read by the other.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from .device import resolve_device

__all__ = ["SpectrumCache"]


class SpectrumCache:
    def __init__(self, audio_path=None, persist=False, device="cuda"):
        self.audio_path = audio_path
        self.persist = persist and audio_path is not None
        self.device = resolve_device(device)
        self.storage = {}

    @staticmethod
    def key(fft_size, channel, hop, zeropad):
        return (int(fft_size), int(channel), int(hop), int(zeropad))

    def _disk_path(self, key):
        base = os.path.splitext(self.audio_path)[0]
        return f"{base}.fft_{key[0]}_{key[1]}_{key[2]}_{key[3]}.npz"

    def get_related_keys(self, key):
        """Keys that can serve this request: exact, or denser hop whose
        stride divides evenly (spectrum.py:55-68)."""
        fft_size, channel, hop, zeropad = key
        exact = key if key in self.storage else None
        denser = [k for k in self.storage
                  if k[0] == fft_size and k[1] == channel and k[3] == zeropad
                  and hop % k[2] == 0 and k[2] < hop]
        return exact, denser

    def lookup(self, fft_size, channel, hop, zeropad):
        """Return the cached spectrogram tensor (possibly stride-decimated
        from a denser entry) or None."""
        key = self.key(fft_size, channel, hop, zeropad)
        exact, denser = self.get_related_keys(key)
        if exact is not None:
            return self.storage[exact]
        if denser:
            src_key = denser[0]
            step = key[2] // src_key[2]
            decimated = self.storage[src_key][..., ::step]
            self.storage[key] = decimated
            return decimated
        if self.persist:
            path = self._disk_path(key)
            if os.path.isfile(path):
                logging.debug(f"Spectrum cache disk hit: {path}")
                with np.load(path) as z:
                    data = torch.as_tensor(z["spec"], device=self.device)
                self.storage[key] = data
                return data
        return None

    def store(self, fft_size, channel, hop, zeropad, spec):
        """Keep ``spec`` (a tensor or host array) on the cache's device,
        and write it to disk when persisting."""
        key = self.key(fft_size, channel, hop, zeropad)
        spec = torch.as_tensor(spec, device=self.device)
        self.storage[key] = spec
        if self.persist:
            np.savez_compressed(self._disk_path(key), spec=spec.cpu().numpy())
        return key

    def get_or_compute(self, signal, fft_size, channel, hop, zeropad,
                       compute=None):
        """Cache-through accessor; ``compute`` defaults to the port's STFT
        magnitude on the cache's device."""
        hit = self.lookup(fft_size, channel, hop, zeropad)
        if hit is not None:
            return hit
        if compute is None:
            from ..ops import fourier

            def compute(sig):
                mono = sig[:, channel] if sig.ndim == 2 else sig
                if not isinstance(mono, torch.Tensor):
                    mono = np.ascontiguousarray(mono)
                return fourier.get_mag(mono, fft_size, hop, zeropad=zeropad,
                                       device=self.device)
        spec = compute(signal)
        self.store(fft_size, channel, hop, zeropad, spec)
        return self.storage[self.key(fft_size, channel, hop, zeropad)]

    def clear(self):
        """Manual 'Clear Storage' (spectrum.py:347-353)."""
        self.storage.clear()
