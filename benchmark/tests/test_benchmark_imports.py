"""What the harness and the reference load, by whole top-level module name
(``p2vit_tpu_torch`` begins with ``p2vit_tpu``)."""

import json
import subprocess
import sys

from conftest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
import {mods}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(mods: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), mods=mods)], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_jax_or_the_program():
    names = loaded("benchmark.reference.vit, benchmark.reference.swin, benchmark.reference.intops")
    assert not names & {"jax", "jaxlib", "flax", "p2vit_tpu", "p2vit_tpu_torch"}


def test_harness_loads_no_jax():
    names = loaded("benchmark.harness, benchmark.families.vit, benchmark.families.swin, benchmark.control, "
                   "benchmark.sweep")
    assert not names & {"jax", "jaxlib", "flax", "p2vit_tpu", "p2vit_tpu_torch"}


def test_forbidden_modules_compares_whole_names():
    from benchmark import harness

    assert harness.forbidden_modules(["p2vit_tpu_torch.serving", "numpy", "jaxtyping"]) == []
    assert harness.forbidden_modules(["jax.numpy", "p2vit_tpu.ops", "flax"]) == ["flax", "jax", "p2vit_tpu"]
