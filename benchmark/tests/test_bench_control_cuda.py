"""On the card: the control (the reference in TF32, put in the program's
place) and each planted fault come out not correct, while the program comes
out correct, at 1,024 envs (a size a test run holds; the readings at the
cells' own sizes are in PERF.md, from benchmark/control.py).

    python -m pytest benchmark/tests/test_bench_control_cuda.py -m cuda
"""

import math

import pytest
import torch

from benchmark import control
from benchmark.harness import check
from benchmark.tests.test_bench_manifest import ROOT

ENVS = 1024


def _fails(numbers, limits):
    """The compared numbers among `numbers` that are not finite or exceed
    their limits (a cell leaves some numbers uncompared: limit None)."""
    return [n for n in check.compared(limits) if n in numbers
            and not (math.isfinite(numbers[n]) and numbers[n] <= limits[n])]


@pytest.mark.cuda
@pytest.mark.parametrize("workload, minibatches", [("rodent-spa-wide", 16), ("fly-mc-wide", 16)])
def test_control_and_faults_fail_where_the_program_passes(workload, minibatches):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is TF32, which only the card computes")
    from benchmark.run import cache_dirs

    cache_dirs(ROOT)
    overrides = {"train_setup.train_config.num_envs": ENVS,
                 "train_setup.train_config.batch_size": ENVS // minibatches}
    r = control.readings(workload, 2**31 + 77, 2.0, "cuda", ROOT, overrides)
    limits = check.load_limits(ROOT, workload)
    assert not _fails(r["program"], limits), r["program"]
    assert _fails(r["control"], limits), r["control"]
    for name, numbers in r["faults"].items():
        assert _fails(numbers, limits), (name, numbers)
