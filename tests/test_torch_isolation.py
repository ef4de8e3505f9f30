"""repro_torch stands alone: no JAX, no ml_dtypes, nothing of ``repro``.

The port must run on a machine without JAX, so importing its public modules
may load none of the reference package, and no source file of the port (nor
chip_smoke.py) may import it.  Its codec runs on the card by default and
refuses to start without one instead of carrying on on the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "ml_dtypes", "repro")


def _banned(module: str) -> bool:
    return any(module == b or module.startswith(b + ".") for b in BANNED)


def test_import_loads_nothing_of_the_reference():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch, repro_torch.api, repro_torch.core.codec\n"
        "import repro_torch.core.codec.__main__, repro_torch.kernels.ops\n"
        "import repro_torch.kernels._build\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None\n"
        "          and any(m == b or m.startswith(b + '.') for b in %r)]\n"
        "print(loaded)\n" % (BANNED,)
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    assert res.stdout.strip() == "[]", res.stdout + res.stderr


def _imports(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            mods.append(node.module)
    return mods


def test_sources_import_nothing_of_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): m for f in files for m in _imports(f) if _banned(m)}
    assert not bad, bad


def test_codec_refuses_to_run_without_a_card(monkeypatch):
    from repro_torch.api import SZxCodec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SZxCodec()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SZxCodec(device="cuda:0")
    assert SZxCodec(device="cpu").device == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_the_port(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card, or
    when it stands alone without the repository."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    scripts = [lone] if torch.cuda.is_available() else [ROOT / "chip_smoke.py", lone]
    for script in scripts:
        res = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             cwd=script.parent, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
