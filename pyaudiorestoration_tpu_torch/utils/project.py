"""Project-file I/O: the reference's JSON formats plus legacy text formats
(counterpart of pyaudiorestoration_tpu/utils/project.py).  ``STORE`` holds
the port's marker classes; ``save_json`` writes the same bytes as the JAX
package (sorted keys, tab indent), so a project saved by either package
loads in the other.

Formats (widgets.py:1224-1272):
* ``.spd``       lines=TraceLine, regs=RegLine       (pyrespeeder_gui.py:17-18)
* ``.tapesync``  lags=LagSample, azimuths=AzimuthLine (pytapesynch_gui.py:22-23);
                 legacy key "markers" == lags (samples/rhythm.tapesync)
* ``.drop``      dropouts=DropoutSample              (dropout_healer_gui.py:23-24)
* ``.pan``       markers=PanSample                   (pypan_gui.py:9-10)
* ``.noise``     no markers, settings only           (renoiser_gui.py:29)
plus widget settings keys (fft_size, fft_overlap, ..., see ConfigStorer users)
and "reference"/"source" audio paths.

Legacy text formats ``.speed`` / ``.sin`` / ``.syn`` (io_ops.py:26-82).
"""

from __future__ import annotations

import json
import logging
import os

from ..models import markers as mk

STORE = {
    ".spd": {"lines": mk.TraceLine, "regs": mk.RegLine},
    ".tapesync": {"lags": mk.LagSample, "azimuths": mk.AzimuthLine},
    ".drop": {"dropouts": mk.DropoutSample},
    ".pan": {"markers": mk.PanSample},
    ".noise": {},
}

# alias keys accepted on load for older files
LOAD_ALIASES = {".tapesync": {"markers": "lags"}}


def save_json(json_path, dic):
    logging.info(f"Saving {os.path.basename(json_path)}")
    try:
        with open(json_path, "w") as w:
            json.dump(dic, w, indent="\t", sort_keys=True)
    except OSError:
        logging.exception("Saving failed, perhaps lack of disk space")


def load_json(json_path):
    try:
        with open(json_path, "r") as r:
            return json.load(r)
    except FileNotFoundError:
        logging.exception(f"{os.path.basename(json_path)} file missing")
        return {}


class Project:
    """A loaded project: settings dict + typed marker lists."""

    def __init__(self, ext, settings=None, markers=None):
        self.ext = ext
        self.settings = dict(settings or {})
        self.markers = {name: list((markers or {}).get(name, ())) for name in STORE[ext]}

    @property
    def fft_size(self):
        return int(self.settings.get("fft_size", 1024))

    @property
    def fft_overlap(self):
        return int(self.settings.get("fft_overlap", 4))

    @property
    def hop(self):
        return self.fft_size // self.fft_overlap

    @property
    def fft_zeropad(self):
        return int(self.settings.get("fft_zeropad", 1))

    def marker_list(self, name):
        return self.markers.get(name, [])

    def to_dict(self):
        sync = dict(self.settings)
        for name in STORE[self.ext]:
            sync[name] = [list(m.to_cfg()) for m in self.markers.get(name, [])]
        return sync

    def save(self, path):
        save_json(path, self.to_dict())
        return path

    @classmethod
    def load(cls, path):
        ext = os.path.splitext(path)[1]
        if ext not in STORE:
            raise ValueError(f"Unknown project extension {ext}")
        sync = load_json(path)
        aliases = LOAD_ALIASES.get(ext, {})
        markers = {}
        settings = {}
        for key, value in sync.items():
            name = aliases.get(key, key)
            if name in STORE[ext]:
                cls_ = STORE[ext][name]
                markers[name] = [cls_.from_cfg(*item) for item in value]
            else:
                settings[key] = value
        return cls(ext, settings, markers)


def project_path_for(audio_path, ext):
    """``<audio_basename><EXT>`` convention (widgets.py:1231)."""
    return os.path.splitext(audio_path)[0] + ext


# ---------------------------------------------------------------------------
# Legacy text formats (io_ops.py:26-82)
# ---------------------------------------------------------------------------

def read_trace(filename):
    """Read legacy ``.speed`` trace data: list of (offset, times, freqs)."""
    speedfilename = filename.rsplit(".", 1)[0] + ".speed"
    data = []
    if os.path.isfile(speedfilename):
        with open(speedfilename, "r") as text_file:
            for line in text_file:
                if line:
                    if "?" in line:
                        offset = float(line.split(" ")[1])
                        data.append((offset, [], []))
                    else:
                        s = line.split(" ")
                        data[-1][1].append(float(s[0]))
                        data[-1][2].append(float(s[1]))
    return data


def read_regs(filename):
    """Read legacy ``.sin`` regression data: list of parameter rows."""
    speedfilename = filename.rsplit(".", 1)[0] + ".sin"
    data = []
    if os.path.isfile(speedfilename):
        with open(speedfilename, "r") as text_file:
            for line in text_file:
                if line.strip():
                    data.append([float(v) for v in line.split(" ")])
    return data


def read_lag(filename):
    """Read legacy ``.syn`` lag data: list of rows."""
    speedfilename = filename.rsplit(".", 1)[0] + ".syn"
    data = []
    if os.path.isfile(speedfilename):
        with open(speedfilename, "r") as text_file:
            for line in text_file:
                if line.strip():
                    data.append([float(v) for v in line.split(" ")])
    return data
