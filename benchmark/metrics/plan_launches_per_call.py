"""``plan_launches_per_call``: the host's CUDA launch calls
(``cudaLaunchKernel*``, ``cuLaunchKernel*``) that start inside the
program's ``respeeder.plan`` spans, over the traced calls."""

from benchmark.lib import spans


def read(run):
    return spans.launches_per_call(run, "respeeder.plan")
