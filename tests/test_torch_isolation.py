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
        "import repro_torch.kernels._build, repro_torch.core.codec.stage\n"
        "import repro_torch.store, repro_torch.store.__main__\n"
        "import repro_torch.core.codec.planes_codec, repro_torch.core.planes\n"
        "import repro_torch.core.grad_compress, repro_torch.pipeline_par.gpipe\n"
        "import repro_torch.configs, repro_torch.kernels.flash_attention\n"
        "import repro_torch.models.layers, repro_torch.models.transformer\n"
        "import repro_torch.serve.engine, repro_torch.launch.serve\n"
        "import repro_torch.kernels.block_stats, repro_torch.kernels.pack\n"
        "import repro_torch.core.pytree, repro_torch.core.codec.tree\n"
        "import repro_torch.data, repro_torch.data.pipeline, repro_torch.optim\n"
        "import repro_torch.checkpoint, repro_torch.checkpoint.manager\n"
        "import repro_torch.train.step, repro_torch.train.trainer\n"
        "import repro_torch.launch.train\n"
        "import repro_torch.obs, repro_torch.obs.registry, repro_torch.obs.export\n"
        "import repro_torch.obs.stream_stats, repro_torch.data.store_loader\n"
        "import repro_torch.data.scidata, repro_torch.serve.service\n"
        "import repro_torch.serve.store_service, repro_torch.serve.client\n"
        "import repro_torch.core.metrics\n"
        "import repro_torch.models.sharding, repro_torch.launch.mesh\n"
        "import repro_torch.launch.dryrun, repro_torch.roofline.analysis\n"
        "import repro_torch.roofline.hlo_cost\n"
        "repro_torch.configs.all_configs()\n"
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


EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))


def test_sources_import_nothing_of_the_reference():
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + EXAMPLES)
    assert len(files) > 10 and len(EXAMPLES) == 4
    bad = {str(f.relative_to(ROOT)): m for f in files for m in _imports(f) if _banned(m)}
    assert not bad, bad


def test_examples_load_nothing_of_the_reference():
    """Each examples/*_torch.py imported in a process where JAX cannot load:
    none of the reference comes in."""
    code = (
        "import importlib.util, sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes'):\n"
        "    sys.modules[name] = None\n"
        "for path in sys.argv[1:]:\n"
        "    spec = importlib.util.spec_from_file_location('example', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "loaded = [m for m, v in sys.modules.items() if v is not None\n"
        "          and any(m == b or m.startswith(b + '.') for b in %r)]\n"
        "print(loaded)\n" % (BANNED,)
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code, *map(str, EXAMPLES)], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert res.stdout.strip() == "[]", res.stdout + res.stderr


def test_codec_refuses_to_run_without_a_card(monkeypatch):
    from repro_torch.api import SZxCodec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SZxCodec()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SZxCodec(device="cuda:0")
    assert SZxCodec(device="cpu").device == torch.device("cpu")


def test_store_and_stage_refuse_to_run_without_a_card(monkeypatch, tmp_path):
    """No fallback: without ``device=`` the store and the second stage run on
    the card, and raise when there is none."""
    import numpy as np

    from repro_torch.core.codec import SZxCodec, stage
    from repro_torch.store import ArrayStore

    x = np.linspace(0, 1, 4096, dtype=np.float32).reshape(64, 64)
    ArrayStore.save(tmp_path / "a.szs", x, 1e-3, device="cpu")
    payload = SZxCodec(device="cpu").compress(x, 1e-3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArrayStore.save(tmp_path / "b.szs", x, 1e-3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArrayStore.open(tmp_path / "a.szs")
    for fn in (stage.stage_payload, stage.destage_payload):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(payload, stage.DEFLATE)
    with ArrayStore.open(tmp_path / "a.szs", device="cpu") as ca:
        assert ca.shape == (64, 64)


def test_planes_codec_refuses_to_run_without_a_card(monkeypatch):
    """A host array goes to the card unless ``device=`` asks for the CPU;
    without a card that raises instead of running the plain route."""
    import numpy as np

    from repro_torch.core import planes
    from repro_torch.core.codec import PlanesCodec

    x = np.linspace(0, 1, 256, dtype=np.float32).reshape(4, 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanesCodec().encode_blocks(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        planes.encode(x.reshape(-1))
    mu, _sexp, _planes = PlanesCodec(device="cpu").encode_blocks(x)
    assert mu.device.type == "cpu"


def test_serving_refuses_to_run_without_a_card(monkeypatch):
    """The serve launcher and the engine's caches run on the card unless
    ``device``/``--device`` asks for the CPU; without a card they raise."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.serve import engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3.2-1b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.make_cache(configs.get("llama3.2-1b").reduced(), 1, 8)
    cache = engine.make_cache(configs.get("llama3.2-1b").reduced(), 1, 8, device="cpu")
    assert cache["slot_pos"].device.type == "cpu"


def test_model_refuses_to_run_without_a_card(monkeypatch):
    """The model's parameters go to the card unless ``device`` asks for the
    CPU; without a card building them raises instead of running the plain
    route."""
    from repro_torch import configs
    from repro_torch.models import transformer as T

    cfg = configs.get("llama3.2-1b").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Transformer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.params_from_jax({}, cfg)
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert model.embed.device.type == "cpu"


def test_training_refuses_to_run_without_a_card(monkeypatch, tmp_path):
    """The train launcher, the state, the checkpoint manager, the tree codec
    and the compressed cache run on the card unless ``device``/``--device``
    asks for the CPU; without a card they raise."""
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.codec.tree import TreeCodec
    from repro_torch.data import CompressedInMemoryCache
    from repro_torch.launch import train
    from repro_torch.optim import AdamW
    from repro_torch.train import step

    cfg = configs.get("llama3.2-1b").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: train.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "1",
                                     "--ckpt", str(tmp_path / "c")]),
                 lambda: step.init_state(cfg, AdamW(lr=1e-3), torch.Generator()),
                 lambda: CheckpointManager(str(tmp_path / "m")),
                 lambda: TreeCodec(),
                 lambda: CompressedInMemoryCache()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert CheckpointManager(str(tmp_path / "m"), device="cpu").device.type == "cpu"


def test_ingest_refuses_to_run_without_a_card(monkeypatch, tmp_path):
    """The store loader, StoreLM and the train launcher with --data-store
    decode on the card unless ``device``/``--device`` asks for the CPU;
    without a card they raise."""
    import numpy as np

    from repro_torch.data import DataConfig, StoreLM, StoreLoader
    from repro_torch.launch import train
    from repro_torch.store import ArrayStore

    path = str(tmp_path / "corpus.szs")
    x = np.linspace(0, 1, 64 * 256, dtype=np.float32).reshape(64, 256)
    ArrayStore.save(path, x, 1e-3, chunk_shape=(16, 256), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: StoreLoader(path, (4, 64), 2),
                 lambda: StoreLM(path, DataConfig(256, 16, 2)),
                 lambda: train.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "1",
                                     "--seq", "16", "--batch", "2", "--data-store", path,
                                     "--ckpt", str(tmp_path / "c")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with StoreLoader(path, (4, 64), 2, device="cpu") as ld:
        assert ld.batch_at(0).device.type == "cpu"
    assert StoreLM(path, DataConfig(256, 16, 2), device="cpu").batch_at(0)["tokens"].shape \
        == (2, 16)


def test_store_service_refuses_to_run_without_a_card(monkeypatch, tmp_path):
    """The store service, its server, the remote client, the loader's URL
    source and a checkpoint leaf view decode on (or copy to) the card unless
    ``device``/``--device`` asks for the CPU; without a card they raise
    before any request is made."""
    import numpy as np

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import StoreLoader
    from repro_torch.data.store_loader import HttpStoreSource
    from repro_torch.serve.client import RemoteStore
    from repro_torch.serve.service import StoreService
    from repro_torch.serve.store_service import make_server, make_service
    from repro_torch.store import ArrayStore
    from repro_torch.store.__main__ import main as store_main

    path = str(tmp_path / "a.szs")
    ArrayStore.save(path, np.linspace(0, 1, 4096, dtype=np.float32).reshape(64, 64), 1e-3,
                    device="cpu")
    ckpt = CheckpointManager(str(tmp_path / "c"), compress=True, device="cpu")
    ckpt.save(0, {"w": np.linspace(0, 1, 4096, dtype=np.float32)})
    url = "http://127.0.0.1:9/v1/stores/a"       # never contacted: the check comes first
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: StoreService(), lambda: make_service(path), lambda: make_server(path),
                 lambda: RemoteStore(url), lambda: HttpStoreSource(url),
                 lambda: StoreLoader(url, (4, 4), 2),
                 lambda: ckpt.leaf_store("w", device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert store_main(["serve", path, "--port", "0"]) == 1
    assert StoreService(device="cpu").device.type == "cpu"
    assert RemoteStore(url, device="cpu").device.type == "cpu"
    with ckpt.leaf_store("w") as lv:
        assert lv[0:3].device.type == "cpu"


def test_building_a_model_leaves_the_matmul_flags_alone():
    """The precision flags are set only while a forward pass runs."""
    from repro_torch import configs
    from repro_torch.models import transformer as T

    mm = torch.backends.cuda.matmul
    before = mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction
    cfg = configs.get("llama3.2-1b").reduced()
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    T.forward(model, cfg, torch.zeros((1, 4), dtype=torch.int64))
    assert (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction) == before


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
