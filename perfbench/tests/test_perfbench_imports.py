"""What the benchmark loads: nothing whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (compared whole: ``repro_torch`` is the
program), and the reference nothing of the program at all."""
import os
import subprocess
import sys

import pytest
from conftest import REPO

from perfbench import run

PROBE = """
import sys
sys.path[:0] = [{src!r}, {repo!r}]
{imports}
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def loaded(imports: str) -> set:
    code = PROBE.format(src=str(REPO / "src"), repo=str(REPO), imports=imports)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_harness_loads_no_jax_and_no_reference_package():
    names = loaded("import perfbench.run, perfbench.control, perfbench.drivers.prefill\n"
                   "import perfbench.drivers.train, perfbench.trace\n"
                   "import repro_torch.serve.engine, repro_torch.train.step\n"
                   "from perfbench import harness\n"
                   "for m in harness.load_bench()['per_layer']: harness.reader(m['name'])")
    assert not names & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in names and "perfbench" in names


def test_reference_loads_nothing_of_the_program():
    names = loaded("import perfbench.reference.model, perfbench.reference.planes\n"
                   "import perfbench.reference.train, perfbench.reference.weights")
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


@pytest.mark.parametrize("mods, found", [({"repro_torch.x", "numpy"}, []),
                                         ({"repro", "torch"}, ["repro"]),
                                         ({"jax.numpy", "reproduce"}, ["jax"]),
                                         ({"flax.linen", "jaxlib"}, ["flax", "jaxlib"])])
def test_banned_names_compare_whole(monkeypatch, mods, found):
    monkeypatch.setattr(sys, "modules", {m: None for m in mods})
    assert run.banned_modules() == found


def test_no_card_no_result(tmp_path):
    """Without a card (this test) or without the program the run exits with
    a code other than 0 and prints no result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, str(REPO / "perfbench" / "run.py"), "--workload",
                        "yi-6b.rag-prefill-4k.szx-kv1", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, env=env, timeout=300,
                       cwd=tmp_path)
    assert p.returncode != 0 and not p.stdout.strip()
