"""The port's CLI exits as the JAX package's does on a bad input: an
``OSError`` or ``ValueError`` becomes one ``error: ...`` line on stderr and
exit code 1 (JAX ``cli.py:309-316``), and ``-v`` re-raises it.  Each case
gives both CLIs the same argv (the port's with ``--device cpu``).  Every
case here fails in the same call in both packages (the read of the input,
or the same argument check), so the two lines are compared verbatim."""

import numpy as np
import pytest
from scipy.io import wavfile

from pyaudiorestoration_tpu import cli as cli_j
from pyaudiorestoration_tpu_torch import cli as cli_t


def jax_argv(argv):
    """``argv`` without its ``--device X`` pair, which JAX's CLI lacks."""
    out = list(argv)
    if "--device" in out:
        i = out.index("--device")
        del out[i:i + 2]
    return out


def error_exit(main, argv, capsys):
    """``main(argv)`` in this process: (exit code, stderr's lines)."""
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().err.strip().splitlines()


# name: (argv, the exception both raise under -v, its message)
CASES = {
    "respeed, missing input": (["respeed", "{missing}"], OSError,
                               "Native audioio failed to decode {missing}"),
    "respeed --fast, missing input": (["respeed", "--fast", "{missing}"], OSError,
                                      "Cannot open {missing}"),
    "heal, missing input": (["heal", "{missing}", "--detect", "0.1", "0.2", "100", "200"],
                            OSError, "Native audioio failed to decode {missing}"),
    "hpss, missing input": (["hpss", "{missing}"], OSError, "Cannot open {missing}"),
    "measure, missing input": (["measure", "{missing}"], OSError,
                               "Native audioio failed to decode {missing}"),
    "respeed-batch --tier fixed without --f0": (
        ["respeed-batch", "{wav}", "--tier", "fixed"], ValueError,
        "--tier fixed requires --f0"),
    "renoise --preview without --noise or --selection": (
        ["renoise", "{wav}", "--preview", "{tmp}/p.png"], ValueError,
        "preview needs --noise or --selection"),
}


def _case(tmp_path, name):
    if name.startswith("renoise --preview"):
        pytest.importorskip("matplotlib")
    argv, exc, msg = CASES[name]
    wav = tmp_path / "take.wav"
    wavfile.write(wav, 8000, 0.1 * np.random.default_rng(0).standard_normal(8000)
                  .astype(np.float32))
    fields = {"missing": str(tmp_path / "missing.wav"), "wav": str(wav), "tmp": str(tmp_path)}
    return [a.format(**fields) for a in argv], exc, msg.format(**fields)


@pytest.mark.parametrize("name", list(CASES))
def test_bad_input_exits_1_with_jaxs_error_line(name, tmp_path, capsys):
    argv, _, msg = _case(tmp_path, name)
    want = error_exit(cli_j.main, argv, capsys)
    assert want == (1, [f"error: {msg}"])
    assert error_exit(cli_t.main, argv + ["--device", "cpu"], capsys) == want
    assert not (tmp_path / "p.png").exists()


@pytest.mark.parametrize("name", list(CASES))
def test_verbose_reraises_as_jax_does(name, tmp_path, capsys):
    argv, exc, msg = _case(tmp_path, name)
    for main, extra in ((cli_j.main, []), (cli_t.main, ["--device", "cpu"])):
        with pytest.raises(exc) as info:
            main(["-v", *argv, *extra])
        assert str(info.value) == msg
    assert "error:" not in capsys.readouterr().err
