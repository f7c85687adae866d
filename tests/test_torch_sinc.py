"""K1, the banded windowed-sinc resampler: the port's plain PyTorch version
against the JAX Pallas kernel (interpret mode) and the XLA tier, a float64
ground truth of its weights, and a numpy model of the CUDA kernel's
direct-tap rule.  The CUDA kernel itself runs only on a card; chip_smoke.py
holds it against the plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu.kernels import sinc_pallas
from pyaudiorestoration_tpu.pipelines import respeeder_device as rj
from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
from pyaudiorestoration_tpu_torch.utils.convert import plan_to_torch

torch.set_num_threads(2)


def _wow_case(sr=8000, hop=256, seconds=2, depth=0.03, seed=7):
    """test_pallas_kernels.py:10-32: noise through a wow plan."""
    n = seconds * sr
    rng = np.random.default_rng(seed)
    sig = (rng.standard_normal(n) * 0.3).astype(np.float32)
    t = np.arange(n // hop) * hop / sr
    speeds = 1.0 + depth * np.sin(2 * np.pi * 1.3 * t)
    plan = rj.plan_positions_fast(speeds, hop, n)
    return sig, speeds.astype(np.float32), plan, rt._drift_bucket(plan["drift"])


def _unaligned_case():
    """test_pallas_dma_unaligned_signal_length: len(sig) not 1024-aligned."""
    rng = np.random.default_rng(3)
    n = 32768 + 940
    sig = (rng.standard_normal(n) * 0.3).astype(np.float32)
    step = 128
    T = n // step - 1
    plan = {"n": np.full(T, step, np.int32),
            "base_int": (np.arange(T) * step).astype(np.int32),
            "base_frac": np.zeros(T, np.float32), "max_n": 140, "drift": 8}
    return sig, np.ones(T + 1, np.float32), plan, 8


def _torch_sinc(sig, speeds, plan, nt, drift, backend="auto"):
    p = plan_to_torch(plan, "cpu")
    return rt.run_banded_sinc(torch.from_numpy(sig), torch.from_numpy(speeds),
                              p["n"], p["base_int"], p["base_frac"], p["max_n"],
                              nt, drift, backend).numpy()


@pytest.mark.parametrize("case,nt", [("wow", 30), ("unaligned", 8)])
def test_plain_matches_jax_pallas_and_xla(case, nt):
    sig, speeds, plan, drift = _wow_case() if case == "wow" else _unaligned_case()
    max_n = int(plan["max_n"])
    args = (jnp.asarray(sig), jnp.asarray(speeds), jnp.asarray(plan["n"]),
            jnp.asarray(plan["base_int"]), jnp.asarray(plan["base_frac"]))
    got = _torch_sinc(sig, speeds, plan, nt, drift)
    xla = np.asarray(rj.sinc_banded_device(*args, max_n, nt, drift))
    np.testing.assert_allclose(got, xla, atol=3e-5, rtol=0)
    pallas = np.asarray(sinc_pallas.sinc_banded_pallas_dma_segments(
        args[0], args[1][:-1], args[1][1:], *args[2:], max_n, nt, drift,
        tile=8, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=3e-5, rtol=0)


def test_two_channels_flatten_into_segments():
    """run_banded_sinc flattens (C, n) into one segment axis with zero guard
    bands (respeeder_device.py:727-736); each channel matches JAX's."""
    sig, speeds, plan, drift = _wow_case(seconds=1, seed=11)
    x = np.stack([sig, -0.5 * sig[::-1]]).astype(np.float32)
    ref = np.asarray(rj.run_banded_sinc(
        jnp.asarray(x), jnp.asarray(speeds), jnp.asarray(plan["n"]),
        jnp.asarray(plan["base_int"]), jnp.asarray(plan["base_frac"]),
        int(plan["max_n"]), 16, drift, backend="xla"))
    got = _torch_sinc(x, speeds, plan, 16, drift, backend="pallas")
    assert got.shape == ref.shape == (2, len(plan["n"]), plan["max_n"])
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)


@pytest.mark.parametrize("T,max_n", [(40, 140), (7, 563), (3, 5)])
def test_segment_grids_bit_equal(T, max_n):
    rng = np.random.default_rng(T)
    s = (1 + 0.03 * rng.standard_normal(T + 1)).astype(np.float32)
    nn = rng.integers(0, max_n + 1, T).astype(np.int32)
    nn[0] = 0
    bf = rng.uniform(0, 1, T).astype(np.float32)
    ref = rj.segment_grids(jnp.asarray(s[:-1]), jnp.asarray(s[1:]),
                           jnp.asarray(nn), jnp.asarray(bf), max_n)
    got = rt.segment_grids(torch.from_numpy(s[:-1]), torch.from_numpy(s[1:]),
                           torch.from_numpy(nn), torch.from_numpy(bf), max_n)
    for r, g in zip(ref, got):
        assert np.array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("L", [0, 1, 16, 17, 255, 563, 4200])
def test_fixed_order_cumsum_matches_jnp_cumsum(L):
    x = (1.0 / (1 + 0.03 * np.random.default_rng(L).standard_normal((9, L)))).astype(np.float32)
    ref = np.asarray(jnp.cumsum(jnp.asarray(x), axis=1))
    assert np.array_equal(rt.fixed_order_cumsum(torch.from_numpy(x)).numpy(), ref)


def _weight_inputs(fc_case, nt=30, drift=8, max_n=140, tile=8, seed=3):
    """test_pallas_kernels.py:109-163: adversarial cutoffs."""
    U = nt + drift
    rng = np.random.default_rng(seed)
    fc_lo = 1.0 / (1.0 + (drift - 2) / max_n)
    if fc_case == "one":
        bs = np.ones((tile, max_n), np.float32)
    elif fc_case == "floor":
        bs = np.full((tile, max_n), fc_lo, np.float32)
    else:
        bs = (1.0 + 0.02 * rng.standard_normal((tile, max_n))).astype(np.float32)
    k = np.arange(max_n, dtype=np.float64)[None, :]
    rel = (k + rng.uniform(-drift + 1, drift - 1, (tile, max_n))).astype(np.float32)
    buf = rng.standard_normal((tile, max_n + 2 * U)).astype(np.float32) * 0.3
    return buf, bs, rel, nt, drift, max_n


@pytest.mark.parametrize("fc_case", ["one", "floor", "mixed"])
def test_shift_mac_weights_match_float64_ground_truth(fc_case):
    buf, bs, rel, nt, drift, max_n = _weight_inputs(fc_case)
    U = nt + drift
    in_seg = torch.ones(bs.shape, dtype=torch.bool)
    got = kb.sinc_shift_mac(torch.from_numpy(buf), torch.from_numpy(bs),
                            torch.from_numpy(rel), in_seg, max_n, nt, drift).numpy()
    fc = np.minimum(bs.astype(np.float64), 1.0)
    k = np.arange(max_n)[None, :]
    m = np.round(rel.astype(np.float64)) - k
    shift = rel.astype(np.float64) - np.round(rel.astype(np.float64))
    acc = np.zeros(bs.shape)
    for v in range(2 * U):
        jf = (v - U) - m
        x = (jf - shift) * fc
        w = np.sinc(x) * fc * (0.5 - 0.5 * np.cos(np.pi / nt * (jf + nt)))
        w = np.where((jf >= -nt) & (jf < nt), w, 0.0)
        acc += buf[:, v:v + max_n].astype(np.float64) * w
    assert np.max(np.abs(got - acc)) < 1e-5


def _direct_tap_model(sig, base_int, bs, rel, in_seg, nt, drift):
    """numpy model of csrc/sinc_banded.cu: tap j of lane k reads window
    position p = round(rel) + U + j, and counts only where p lies in
    [k, k + 2U) and k < n_i."""
    T, max_n = bs.shape
    U = nt + drift
    idx = (base_int.astype(np.int64) - U)[:, None] + np.arange(max_n + 2 * U)[None, :]
    win = np.where((idx >= 0) & (idx < len(sig)), sig[np.clip(idx, 0, len(sig) - 1)], 0.0)
    win = win.astype(np.float32)
    k = np.arange(max_n)[None, :]
    anchor = np.round(rel).astype(np.int64)  # half to even, as rintf
    shift = rel - anchor.astype(np.float32)
    fc = np.minimum(bs, np.float32(1.0))
    m = anchor - k
    rows = np.arange(T)[:, None]
    acc = np.zeros(bs.shape, np.float32)
    for j in range(-nt, nt):
        ok = in_seg & (m + j >= -U) & (m + j < U)
        p = np.clip(anchor + U + j, 0, max_n + 2 * U - 1)
        x = (np.float32(j) - shift) * fc
        hann = np.float32(0.5 - 0.5 * np.cos(np.float32(np.pi) * np.float32(j + nt) / np.float32(nt)))
        w = np.sinc(x.astype(np.float64)).astype(np.float32) * fc * hann
        acc += np.where(ok, win[rows, p] * w, np.float32(0.0))
    return acc


@pytest.mark.parametrize("contract", ["held", "broken"])
def test_direct_tap_rule_equals_plain_version(contract):
    """The CUDA kernel's formulation (direct taps with the window rule)
    equals the shift-MAC plain version, also where |round(rel) - k| > drift
    drops taps."""
    rng = np.random.default_rng(5)
    T, max_n, nt, drift = 12, 90, 10, 8
    sig = (rng.standard_normal(4000) * 0.3).astype(np.float32)
    base_int = rng.integers(-50, 3900, T).astype(np.int32)
    bs = (1.0 + 0.05 * rng.standard_normal((T, max_n))).astype(np.float32)
    spread = drift - 1 if contract == "held" else 3 * drift
    rel = (np.arange(max_n)[None, :]
           + rng.uniform(-spread, spread, (T, max_n))).astype(np.float32)
    in_seg = np.arange(max_n)[None, :] < rng.integers(0, max_n + 1, T)[:, None]
    plain = kb.sinc_banded(torch.from_numpy(sig), torch.from_numpy(base_int),
                           torch.from_numpy(bs), torch.from_numpy(rel),
                           torch.from_numpy(in_seg), nt, drift).numpy()
    model = _direct_tap_model(sig, base_int, bs, rel, in_seg, nt, drift)
    np.testing.assert_allclose(model, plain, atol=1e-5, rtol=0)
    assert np.all(plain[~in_seg] == 0)


def test_wrapper_uses_plain_version_on_cpu_and_checks_inputs():
    sig, speeds, plan, drift = _wow_case(seconds=1)
    p = plan_to_torch(plan, "cpu")
    T = 16
    bs, rel, in_seg = rt.segment_grids(torch.from_numpy(speeds[:T]),
                                       torch.from_numpy(speeds[1:T + 1]), p["n"][:T],
                                       p["base_frac"][:T], p["max_n"])
    args = (torch.from_numpy(sig), p["base_int"][:T], bs, rel, in_seg)
    before = kb.sinc_banded.launches
    out = kb.sinc_banded(*args, 16, drift)
    assert kb.sinc_banded.launches == before  # no kernel launch on the CPU
    assert torch.equal(out, kb.sinc_banded_plain(*args, 16, drift))
    with pytest.raises(ValueError):
        kb.sinc_banded(args[0].double(), *args[1:], 16, drift)
    with pytest.raises(ValueError):
        kb.sinc_banded(args[0], args[1].long(), *args[2:], 16, drift)
    with pytest.raises(ValueError):
        kb.sinc_banded(*args[:4], in_seg.float(), 16, drift)
    with pytest.raises(ValueError):
        kb.sinc_banded(args[0], args[1], bs[:, :-1], *args[3:], 16, drift)


# ---------------------------------------------------------------- K2

def _jax_kernel(buf, bs, rel, in_seg, nt, drift, max_n):
    """JAX's K2 body run through pl.pallas_call in interpret mode
    (test_pallas_kernels.py:142-148)."""
    import functools

    import jax
    from jax.experimental import pallas as pl

    return np.asarray(pl.pallas_call(
        functools.partial(sinc_pallas._kernel, nt=nt, drift=drift, max_n=max_n),
        out_shape=jax.ShapeDtypeStruct(bs.shape, jnp.float32), interpret=True,
    )(jnp.asarray(buf), jnp.asarray(bs), jnp.asarray(rel),
      jnp.asarray(in_seg.astype(np.float32))))


@pytest.mark.parametrize("case", ["wow", "unaligned", "stereo"])
def test_sinc_banded_device_matches_jax_pallas_and_xla(case):
    """The gathered tier (K2's plain version on the CPU) against JAX's K2,
    sinc_banded_pallas in interpret mode, and JAX's XLA tier
    (test_pallas_kernels.py:10-57, plus two channels)."""
    if case == "unaligned":
        sig, speeds, plan, drift = _unaligned_case()
        nt = 8
    else:
        sig, speeds, plan, drift = _wow_case(seconds=2 if case == "wow" else 1)
        nt = 30
    chans = [sig] if case != "stereo" else [sig, -0.5 * sig[::-1]]
    x = np.stack(chans).astype(np.float32)
    max_n = int(plan["max_n"])
    p = plan_to_torch(plan, "cpu")
    got = rt.sinc_banded_device(torch.from_numpy(x if case == "stereo" else x[0]),
                                torch.from_numpy(speeds), p["n"], p["base_int"],
                                p["base_frac"], max_n, nt, drift).numpy()
    got = got if case == "stereo" else got[None]
    assert got.shape == (len(chans), len(plan["n"]), max_n)
    for c, ch in enumerate(chans):
        args = (jnp.asarray(ch), jnp.asarray(speeds), jnp.asarray(plan["n"]),
                jnp.asarray(plan["base_int"]), jnp.asarray(plan["base_frac"]))
        pallas = np.asarray(sinc_pallas.sinc_banded_pallas(
            *args, max_n, nt, drift, tile=8, interpret=True))
        np.testing.assert_allclose(got[c], pallas, atol=3e-5, rtol=0)
        xla = np.asarray(rj.sinc_banded_device(*args, max_n, nt, drift))
        np.testing.assert_allclose(got[c], xla, atol=3e-5, rtol=0)


@pytest.mark.parametrize("fc_case", ["one", "floor", "mixed"])
def test_gathered_matches_jax_kernel_body(fc_case):
    buf, bs, rel, nt, drift, max_n = _weight_inputs(fc_case)
    in_seg = np.ones(bs.shape, bool)
    in_seg[3, 100:] = False  # a short segment
    got = kb.sinc_banded_gathered(torch.from_numpy(buf), torch.from_numpy(bs),
                                  torch.from_numpy(rel), torch.from_numpy(in_seg),
                                  nt, drift).numpy()
    ref = _jax_kernel(buf, bs, rel, in_seg, nt, drift, max_n)
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)
    assert np.all(got[~in_seg] == 0)


def test_gathered_wrapper_uses_plain_version_on_cpu_and_checks_inputs():
    buf, bs, rel, nt, drift, max_n = _weight_inputs("mixed")
    args = [torch.from_numpy(buf), torch.from_numpy(bs), torch.from_numpy(rel),
            torch.ones(bs.shape, dtype=torch.bool)]
    before = kb.sinc_banded_gathered.launches
    out = kb.sinc_banded_gathered(*args, nt, drift)
    assert kb.sinc_banded_gathered.launches == before  # no kernel launch on the CPU
    assert torch.equal(out, kb.sinc_shift_mac(*args, max_n, nt, drift))
    bad = {0: args[0][:, :-1], 1: args[1].double(), 2: args[2][:-1],
           3: args[3].float()}
    for i, t in bad.items():
        with pytest.raises(ValueError):
            kb.sinc_banded_gathered(*args[:i], t, *args[i + 1:], nt, drift)
    with pytest.raises(ValueError):  # the buffer's width follows nt + drift
        kb.sinc_banded_gathered(*args, nt, drift + 1)
    with pytest.raises(ValueError):
        kb.sinc_banded_gathered(*args, 0, drift)
    with pytest.raises(ValueError):
        kb.sinc_banded_gathered(args[0].to("meta"), *args[1:], nt, drift)


def test_gather_windows_zero_outside_signal():
    sig = torch.arange(1, 11, dtype=torch.float32)
    buf = kb.gather_windows(sig, torch.tensor([0, 8], dtype=torch.int32), 6, 2)
    assert buf.tolist() == [[0, 0, 1, 2, 3, 4], [7, 8, 9, 10, 0, 0]]


# ---------------------------------------------------------------- plan entries

def _plan_case(case):
    """Numpy inputs of the plan entries, (sig_flat, base_int, s_lo, s_hi, n,
    base_frac, max_n, nt, drift), and the (T+1,) speed curve where the rows
    follow one (else None)."""
    if case in ("wow", "n0"):
        sig, speeds, plan, drift = _wow_case(seconds=1)
        n = plan["n"].copy()
        if case == "n0":
            n[[0, 5, len(n) - 1]] = 0  # rows with no output
        return (sig, plan["base_int"], speeds[:-1], speeds[1:], n, plan["base_frac"],
                int(plan["max_n"]), 16, drift), speeds
    if case == "unaligned":
        sig, speeds, plan, drift = _unaligned_case()
        return (sig, plan["base_int"], speeds[:-1], speeds[1:], plan["n"],
                plan["base_frac"], int(plan["max_n"]), 8, drift), speeds
    # rows of two signals flattened with zero guards (respeeder_device's
    # _flatten_takes): the channels of one take, or a batch of two takes
    sig, speeds, plan, drift = _wow_case(seconds=1, seed=11)
    if case == "stereo":
        xs, plans, curves = [sig, -0.5 * sig[::-1]], [plan, plan], [speeds, speeds]
    else:
        sig2, speeds2, plan2, drift2 = _wow_case(seconds=1, depth=0.02, seed=12)
        xs, plans, curves = [sig, sig2], [plan, plan2], [speeds, speeds2]
        drift = max(drift, drift2)
    max_n, nt = max(int(p["max_n"]) for p in plans), 16
    flat = rt._flatten_takes(
        torch.from_numpy(np.stack(xs).astype(np.float32)),
        torch.from_numpy(np.stack(curves)),
        *(torch.from_numpy(np.stack([p[k] for p in plans]))
          for k in ("n", "base_int", "base_frac")), max_n, nt, drift)
    sig_flat, s_lo, s_hi, n, bi, bf = (t.numpy() for t in flat)
    return (sig_flat, bi, s_lo, s_hi, n, bf, max_n, nt, drift), None


def _run_plan_entry(entry, args):
    sig, bi, s_lo, s_hi, n, bf, max_n, nt, drift = args
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (sig, bi, s_lo, s_hi, n, bf)]
    if entry == "K1":
        return kb.sinc_banded_plan(*t, max_n, nt, drift).numpy()
    U = nt + drift
    buf = kb.gather_windows(t[0], t[1], max_n + 2 * U, U)
    return kb.sinc_banded_gathered_plan(buf, *t[2:], max_n, nt, drift).numpy()


@pytest.mark.parametrize("entry", ["K1", "K2"])
@pytest.mark.parametrize("case", ["wow", "unaligned", "stereo", "batch", "n0"])
def test_plan_entries_match_jax_pallas(case, entry):
    """The plan entries (their plain versions on the CPU) against JAX's
    sinc_banded_pallas_dma_segments and, where the rows follow one speed
    curve, sinc_banded_pallas, both in interpret mode, within 3e-5."""
    args, speeds = _plan_case(case)
    sig, bi, s_lo, s_hi, n, bf, max_n, nt, drift = args
    got = _run_plan_entry(entry, args)
    assert got.shape == (len(n), max_n)
    assert np.all(got[np.arange(max_n)[None, :] >= n[:, None]] == 0)
    ref = np.asarray(sinc_pallas.sinc_banded_pallas_dma_segments(
        *(jnp.asarray(a) for a in (sig, s_lo, s_hi, n, bi, bf)), max_n, nt, drift,
        tile=8, interpret=True))
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)
    if speeds is not None:
        ref = np.asarray(sinc_pallas.sinc_banded_pallas(
            *(jnp.asarray(a) for a in (sig, speeds, n, bi, bf)), max_n, nt, drift,
            tile=8, interpret=True))
        np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)


@pytest.mark.parametrize("entry", ["K1", "K2"])
def test_plan_wrappers_use_plain_version_on_cpu_and_check_inputs(entry):
    args, _ = _plan_case("wow")
    sig, bi, s_lo, s_hi, n, bf, max_n, nt, drift = args
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (sig, bi, s_lo, s_hi, n, bf)]
    U = nt + drift
    if entry == "K1":
        fn, plain, head = kb.sinc_banded_plan, kb.sinc_banded_plan_plain, t[:2]
    else:
        fn, plain = kb.sinc_banded_gathered_plan, kb.sinc_banded_gathered_plan_plain
        head = [kb.gather_windows(t[0], t[1], max_n + 2 * U, U)]
    plan = t[2:]
    before = fn.launches
    out = fn(*head, *plan, max_n, nt, drift)
    assert fn.launches == before  # no kernel launch on the CPU
    assert torch.equal(out, plain(*head, *plan, max_n, nt, drift))
    bad = [plan[0].double(), plan[1][:-1], plan[2].long(), plan[3][:, None]]
    for i, b in enumerate(bad):
        with pytest.raises(ValueError):
            fn(*head, *plan[:i], b, *plan[i + 1:], max_n, nt, drift)
    with pytest.raises(ValueError):
        fn(head[0].double(), *head[1:], *plan, max_n, nt, drift)
    with pytest.raises(ValueError):
        fn(*head, *plan, max_n, 0, drift)
    with pytest.raises(ValueError):
        fn(*head, *plan, -1, nt, drift)
    with pytest.raises(ValueError):
        fn(head[0].to("meta"), *head[1:], *plan, max_n, nt, drift)
    if entry == "K1":
        with pytest.raises(ValueError):
            fn(head[0], head[1].long(), *plan, max_n, nt, drift)
    else:
        with pytest.raises(ValueError):  # the buffer's width follows nt + drift
            fn(*head, *plan, max_n, nt, drift + 1)


# ------------------------------------------- the CUDA tap loop's float32 model

_J = 7  # csrc/sinc_banded.cu: kJ, the taps of a block


def _recip_model(e):
    """rcp.approx.ftz.f32, modelled as the rounded reciprocal 2 ulp off
    (worse than the instruction's 1 ulp), then one Newton step."""
    e = np.asarray(e, np.float32)
    with np.errstate(divide="ignore"):
        r = (np.float32(1) / e * np.float32(1 + 2.0 ** -22)).astype(np.float32)
    return (r + r * (np.float32(1) - e * r)).astype(np.float32)


def _sincospi(x):
    x = np.asarray(x, np.float64)
    return np.sin(np.pi * x).astype(np.float32), np.cos(np.pi * x).astype(np.float32)


def _tap_weights_model(shift, fc, nt):
    """float32 numpy model of the CUDA tap weights: (lanes, 2 nt), tap j at
    column j + nt.  Exact seeds sin/cos(pi x_0) at the centre tap and
    sin/cos(i pi fc) for the steps (sincospif); taps j = 1 .. nt-1 and
    -1 .. -(nt-1) in blocks of 7 from an anchor rotated once a block, tap i
    of a block by angle addition; the 7 reciprocals of a block from one
    approximate reciprocal of their product plus one Newton step and the
    prefix products; the rest of a side tap by tap.  fc = 1 takes
    sin(pi (j - shift)) = (-1)^j sin(pi x_0).  No series near 0: the centre
    tap takes the exact seed, and |j - shift| >= 0.5 elsewhere."""
    f32 = np.float32
    W = np.zeros((len(shift), 2 * nt), f32)
    x0 = (-shift * fc).astype(f32)
    s0, c0 = _sincospi(x0)
    with np.errstate(invalid="ignore"):
        W[:, nt] = np.where(x0 == 0, fc, s0 * fc * _recip_model(f32(np.pi) * x0))
    sf, cf = _sincospi(fc)
    cr, sr = [np.ones_like(cf), cf], [np.zeros_like(sf), sf]
    for _ in range(2, _J + 1):
        cr.append((cr[-1] * cf - sr[-1] * sf).astype(f32))
        sr.append((sr[-1] * cf + cr[-2] * sf).astype(f32))
    for d in (1, -1):
        sa = (s0 * cr[1] + d * c0 * sr[1]).astype(f32)
        ca = (c0 * cr[1] - d * s0 * sr[1]).astype(f32)
        j = d
        for t0 in range(0, nt - 1, _J):
            n_b = min(_J, nt - 1 - t0)
            e = [(f32(j) - shift + f32(d * i)).astype(f32) for i in range(n_b)]
            if n_b == _J:
                p = [e[0]]
                for i in range(1, _J):
                    p.append((p[-1] * e[i]).astype(f32))
                q, r = _recip_model(p[-1]), [None] * _J
                for i in range(_J - 1, 0, -1):
                    r[i] = (q * p[i - 1]).astype(f32)
                    q = (q * e[i]).astype(f32)
                r[0] = q
            else:
                r = [_recip_model(x) for x in e]
            for i in range(n_b):
                jj = j + d * i
                hann = f32((0.5 - 0.5 * np.cos(np.pi * (jj + nt) / nt)) / np.pi)
                s = sa if (i == 0 or n_b < _J) else (sa * cr[i] + ca * f32(d) * sr[i])
                u = (hann * r[i]).astype(f32)
                W[:, jj + nt] = np.where(fc == 1, s0 * f32((-1) ** jj) * u, s * u)
                if n_b < _J:
                    sa, ca = ((sa * cr[1] + ca * f32(d) * sr[1]).astype(f32),
                              (ca * cr[1] - sa * f32(d) * sr[1]).astype(f32))
            if n_b == _J:
                sa, ca = ((sa * cr[_J] + ca * f32(d) * sr[_J]).astype(f32),
                          (ca * cr[_J] - sa * f32(d) * sr[_J]).astype(f32))
            j += d * n_b
    return W


@pytest.mark.parametrize("drift,max_n", [(16, 519), (192, 512)])
@pytest.mark.parametrize("fc_case", ["one", "floor", "mixed"])
def test_tap_weight_scheme_float32_model(fc_case, drift, max_n):
    """The CUDA tap loop's weight scheme in float32 against float64
    sinc * fc * hann, at the cutoffs the drift bounds allow (fc >= 1 / (1 +
    (drift - 2) / max_n)) and at shifts 0, +-0.5 and +-tiny.  Max error
    2.4e-7 over these cases (nt 50 and 16)."""
    rng = np.random.default_rng(drift)
    lanes = 2000
    shift = rng.uniform(-0.5, 0.5, lanes).astype(np.float32)
    shift[:5] = [0.0, 0.5, -0.5, 1e-7, -3e-8]
    fc = {"one": np.ones(lanes), "floor": np.full(lanes, 1 / (1 + (drift - 2) / max_n)),
          "mixed": np.minimum(1 + 0.02 * rng.standard_normal(lanes), 1.0)}[fc_case]
    fc = fc.astype(np.float32)
    for nt in (50, 16):
        j = np.arange(-nt, nt)[None, :]
        s, f = shift.astype(np.float64)[:, None], fc.astype(np.float64)[:, None]
        truth = np.sinc(f * (j - s)) * f * (0.5 - 0.5 * np.cos(np.pi * (j + nt) / nt))
        err = np.abs(_tap_weights_model(shift, fc, nt) - truth).max()
        assert err < 5e-7, (nt, err)
