"""The import rule: nothing the harness runs loads jax, jaxlib, flax or
igmc_tpu, and the reference loads nothing of igmc_torch either; modules
are compared by their whole top-level name."""

import json
import subprocess
import sys

from .conftest import ROOT

HARNESS = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.run import run_cell
run_cell("ml1m-serve-rerank", 5, 0.1, True, device="cpu",
         params_over={{"request_set": 4, "warmup_calls": 1, "traced_calls": 1,
                       "compared_calls": 2}})
run_cell("ml1m-train-pallas", 5, 0.1, False, device="cpu",
         config_over={{"data": {{"train_pool": 150}}}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.compare, portbench.reference.extract, portbench.reference.igmc
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)], capture_output=True,
                         text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    loaded = _top_level(HARNESS)
    assert not loaded & {"jax", "jaxlib", "flax", "igmc_tpu"}
    assert "igmc_torch" in loaded        # the program is what runs


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE)
    assert not loaded & {"jax", "jaxlib", "flax", "igmc_tpu", "igmc_torch"}
