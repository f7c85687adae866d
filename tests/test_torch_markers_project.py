"""The port's markers and project files against the JAX package's: the
master curves bit for bit, and .spd files that cross between the packages
byte for byte."""

import numpy as np
import pytest

from pyaudiorestoration_tpu.models import markers as mj
from pyaudiorestoration_tpu.utils import project as pj
from pyaudiorestoration_tpu_torch.models import markers as mt
from pyaudiorestoration_tpu_torch.utils import project as pt

SR, HOP, DUR = 44100, 512, 6.0


def _lines(mk):
    rng = np.random.default_rng(0)
    out = []
    for i, (t0, t1) in enumerate([(0.0, 3.5), (2.5, 5.0), (5.5, 6.0)]):
        t = np.linspace(t0, t1, 80 + i)
        f = 1000.0 * 2 ** (0.01 * np.sin(2 * np.pi * 0.7 * t) + 1e-3 * rng.standard_normal(len(t)))
        out.append(mk.TraceLine(t, f, auto_align=True, other_lines=list(out)))
    return out


def _regs(mk):
    return [mk.RegLine(0.5, 2.0, 0.01, 4.0, 0.3, 0.0),
            mk.RegLine(3.0, 5.0, -0.012, 4.2, 1.1, 0.05)]


@pytest.mark.parametrize("bands", [(0, 9999999), (0.5, 20.0)])
def test_master_speed_line_bit_equal(bands):
    a, b = _lines(mt), _lines(mj)
    for la, lb in zip(a, b):
        assert np.array_equal(la.speed, lb.speed) and la.offset == lb.offset
        assert np.array_equal(la.spec_center, lb.spec_center)
    ra = mt.MasterSpeedLine(SR, HOP, DUR, bands).get_linspace(a)
    rb = mj.MasterSpeedLine(SR, HOP, DUR, bands).get_linspace(b)
    assert np.array_equal(ra, rb)
    assert ([len(g) for g in mt.MasterSpeedLine.get_overlapping_lines(a)]
            == [len(g) for g in mj.MasterSpeedLine.get_overlapping_lines(b)])


def test_master_reg_line_bit_equal():
    ra = mt.MasterRegLine(SR, HOP, DUR).get_linspace(_regs(mt))
    rb = mj.MasterRegLine(SR, HOP, DUR).get_linspace(_regs(mj))
    assert np.array_equal(ra, rb)
    assert np.array_equal(mt.MasterRegLine(SR, HOP, DUR).update([]),
                          mj.MasterRegLine(SR, HOP, DUR).update([]))


def _project(pkg_mk, pkg_proj, src):
    return pkg_proj.Project(".spd", {"source": src, "fft_size": 2048, "fft_overlap": 8,
                                     "fft_zeropad": 2, "mode": "Peak", "tolerance": 1.0,
                                     "resampling_mode": "Sinc", "sinc_quality": 16,
                                     "suffix": ""},
                            {"lines": _lines(pkg_mk), "regs": _regs(pkg_mk)})


def test_spd_crosses_packages_byte_for_byte(tmp_path):
    src = str(tmp_path / "take.wav")
    p_t = _project(mt, pt, src).save(str(tmp_path / "t.spd"))
    p_j = _project(mj, pj, src).save(str(tmp_path / "j.spd"))
    assert open(p_t, "rb").read() == open(p_j, "rb").read()
    # each package loads the other's file and re-saves it unchanged
    for loader, path, out in ((pt, p_j, "tj.spd"), (pj, p_t, "jt.spd")):
        proj = loader.Project.load(path)
        assert [type(m).__module__ for m in proj.marker_list("lines")] == [
            loader.STORE[".spd"]["lines"].__module__] * 3
        resaved = proj.save(str(tmp_path / out))
        assert open(resaved, "rb").read() == open(p_t, "rb").read()
    loaded = pt.Project.load(p_j)
    assert loaded.fft_size == 2048 and loaded.hop == 256 and loaded.fft_zeropad == 2
    assert pt.project_path_for(src, ".spd") == str(tmp_path / "take.spd")


def test_store_points_at_the_port_markers():
    assert pt.STORE[".spd"] == {"lines": mt.TraceLine, "regs": mt.RegLine}
    assert set(pt.STORE) == set(pj.STORE)
    with pytest.raises(ValueError):
        pt.Project.load("x.unknown")
