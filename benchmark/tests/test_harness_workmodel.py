"""The work model's ladder counts are the port's own accounting, and each
cell's figures are printed."""

import json

import pytest

from benchmark import harness, problems, workmodel
from rust_robotics_tpu_torch.parallel import accounting


@pytest.mark.parametrize("n,closures", [(200, 1), (10_000, 99), (100_000, 999)])
def test_ladder_count_is_the_accounting_s(n, closures):
    b = workmodel.TANGENT
    want = accounting.ladder_factor_flops(n, b) + accounting.ladder_apply_flops(
        n, b, b * closures + 2)
    assert workmodel.ladder_ops(n, closures) == want


def test_each_cell_s_figures():
    """Per cell: the operations and bytes of one LM iteration and the least
    time on an H100, bound by operations (the chain LM moves little data)."""
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    peaks = workmodel.card_peaks("NVIDIA H100 80GB HBM3")
    for cell in bench["workloads"]:
        config = json.loads((harness.BENCH_DIR / "configs" / f"{cell['config']}.json").read_text())
        traffic = json.loads((harness.BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
        _, _, ef, _, _, _ = problems.synthesize_chain(config["poses"], config["loop_stride"])
        closures = len(ef) - (config["poses"] - 1)
        work = workmodel.chain_lm_iteration(config["poses"], closures,
                                            traffic["graphs_per_request"])
        least, bound = workmodel.least_time(work, peaks)
        print(f"{cell['name']}: {work['ops']:.4g} operations, {work['bytes']:.4g} bytes an "
              f"iteration; least time {least * 1e6:.4g} us on an H100, bound by {bound}")
        assert bound == "operations" and 0 < least < 1e-4


def test_card_peaks_match_by_name():
    assert workmodel.card_peaks("NVIDIA H100 80GB HBM3") == (3.35e12, 67e12)
    assert workmodel.card_peaks("NVIDIA H100 PCIe") == (2.0e12, 51e12)
    assert workmodel.card_peaks("cpu") is None
