"""Pipeline ``wow_flutter``, the default of a traffic file that names no
``pipeline``: the wow/flutter takes of ``lib/takes.py`` handed to the entry
as host arrays, the plan's parameters fixed at set-up from the first take,
and each answer, a padded grid, judged against the fused entries' plain
reference (``reference/restore.py``) by ``reference/compare.py``."""

from __future__ import annotations

from benchmark.lib import takes
from benchmark.reference import compare
from benchmark.reference.restore import Reference

NUMBERS = compare.NUMBERS


def make_pool(cfg: dict, traffic: dict, seed: int, dev, files):
    """The traffic's pool of host takes; ``files`` (a directory for files
    the pool needs) is not used."""
    return takes.make_pool(cfg, traffic, seed, dev)


def params(pool: list, cfg: dict) -> dict:
    """The plan's parameters from the first take's channel 0."""
    return takes.plan_params(pool[0]["x"][0], cfg)


def reference(take, params: dict, dev, tf32_in: tuple = ()):
    return Reference(take, params, dev, tf32_in=tf32_in)


def judge(grid, ref) -> dict:
    """``compare.judge`` of an answer; the reference's worked-out streams
    are dropped after, since each is judged once."""
    verdict = compare.judge(grid, ref)
    ref.streams.clear()
    return verdict


def work(ref) -> dict:
    """The sinc stage's inputs and real outputs of one take."""
    return {"inputs": int(ref.x.numel()), "outputs": int(ref.x.shape[0] * ref.counts().sum())}


def control(take, params: dict, dev, stages: tuple):
    """The reference computed with TF32 products in ``stages``, as the
    program's answer: a control that ``judge`` has to fail."""
    return reference(take, params, dev, tf32_in=stages).program_grids()
