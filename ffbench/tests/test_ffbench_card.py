"""A cell on the card: a short run of ``llava7b.qa`` at full size comes out
correct, and the control read on its sample fails the cell's limits.

    python -m pytest ffbench/tests -q -m gpu
"""

import pytest

from ffbench import check, run
from ffbench.tests.tiny import REPO


@pytest.mark.gpu
def test_llava_qa_on_the_card(card):
    bench = run.Bench(REPO / "BENCHMARK.json")
    result, checks = run.run_cell(bench, "llava7b.qa", 2**31 + 77, 8.0, False, device=card, control=True)
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu" and result["metrics"]["answer_p90_ms"]["value"] > 0
    control = {name: checks["control." + name]["value"] for name in check.NAMES}
    assert not check.judge(control, bench.cell("llava7b.qa")["limits"], 0, 0)[0]
