"""What the benchmark loads: a run never ``jax``, ``jaxlib``, ``flax`` or
``framefusion_tpu``; the reference nothing of the program. Module names are
compared by their top-level name whole: the port's name begins with the JAX
package's."""

import json
import subprocess
import sys

from ffbench import run
from ffbench.tests.tiny import REPO

RUN_SCRIPT = """
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from ffbench import run
from ffbench.tests import tiny
bench = tiny.make_bench(Path(tempfile.mkdtemp()))
run.run_cell(bench, "internvl8b.qa", 5, 1.0, True, device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_SCRIPT = """
import json, sys
sys.path.insert(0, {repo!r})
import ffbench.check, ffbench.reference.common, ffbench.reference.llava_video, ffbench.reference.internvl
import ffbench.weights, ffbench.generator, ffbench.flops, ffbench.stats
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(script: str) -> set:
    out = subprocess.run([sys.executable, "-c", script.format(repo=str(REPO))], capture_output=True, text=True,
                         check=True, cwd=str(REPO))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _top_level(RUN_SCRIPT)
    assert "framefusion_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE_SCRIPT)
    assert not loaded & (set(run.FORBIDDEN) | {"framefusion_tpu_torch"})


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("framefusion_tpu_torch.runtime", "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not set(run.forbidden_modules()) & {"framefusion_tpu_torch", "jaxtyping", "flax_like"}
    monkeypatch.setitem(sys.modules, "framefusion_tpu.ops", object())
    assert "framefusion_tpu" in run.forbidden_modules()
