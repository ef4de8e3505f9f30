"""The port's top-level package re-exports the reference's public names.

``repro_torch.__all__`` equals ``repro.__all__``; each name resolves lazily
to the ``repro_torch.api`` object of the same name (``api`` to the module
itself), an unknown name raises ``AttributeError``, and ``import
repro_torch`` alone loads neither torch nor ``repro_torch.api``.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro
import repro_torch

ROOT = Path(__file__).resolve().parent.parent


def test_all_equals_the_reference():
    assert repro_torch.__all__ == repro.__all__
    assert repro_torch.__version__ == repro.__version__


@pytest.mark.parametrize("name", repro.__all__)
def test_each_name_resolves_through_the_api(name):
    import repro_torch.api as api

    got = getattr(repro_torch, name)
    assert got is (api if name == "api" else getattr(api, name))


def test_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError, match="no attribute 'SZx'"):
        repro_torch.SZx
    assert not hasattr(repro_torch, "__wrapped__")


def test_import_stays_cheap():
    code = ("import sys, repro_torch\n"
            "print(sorted(m for m in ('torch', 'repro_torch.api') if m in sys.modules))\n"
            "repro_torch.Bound\n"
            "print('repro_torch.api' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    assert res.stdout.split("\n")[:2] == ["[]", "True"], res.stdout + res.stderr
