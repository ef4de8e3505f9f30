"""The port's TreeCodec, CheckpointManager and Trainer against the JAX
package's, on the CPU.

Streams and checkpoint files written from the same tree of arrays must be
byte-identical to the reference's (``backend="numpy"``, whose streams the
port's codec reproduces bit for bit), each package must restore the other's
(values bit-identical to the writer's own restore), and the fault-tolerance
contract of tests/test_substrate.py and tests/test_checkpoint_manager.py
must hold: atomic commits, keep-k, async errors on ``wait``, partial and
sliced restores, the trainer's restart with replay and its give-up.
"""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RManager
from repro.core.codec import SZxCodec as RCodec
from repro.core.codec.plan import Bound as RBound
from repro.core.codec.tree import TreeCodec as RTreeCodec
from repro.optim import AdamWState as RAdamWState
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import pytree
from repro_torch.core.codec import Bound, SZxCodec
from repro_torch.core.codec.tree import TreeCodec
from repro_torch.optim import AdamW, AdamWState
from repro_torch.train.trainer import Trainer, TrainerConfig

BF16 = np.dtype(ml_dtypes.bfloat16)


def _tree(seed=0, state_cls=RAdamWState):
    rng = np.random.default_rng(seed)
    w = (np.cumsum(rng.standard_normal(50_000)) * 0.01).astype(np.float32)
    return {
        "w": w.reshape(500, 100),
        "layers": [{"a": w[:3000].astype(np.float64), "b": w[:2000].astype(BF16)},
                   {"a": w[:5000].astype(np.float16), "b": np.ones(7, np.float32)}],
        "opt": state_cls(np.int32(seed), {"m": w[:1500].copy()}, {"m": np.zeros(4, np.float32)}),
        "step": np.int64(seed),
        "counts": rng.integers(0, 1 << 40, size=300).astype(np.int64),
        "mask": rng.integers(0, 2, size=200).astype(bool),
        "bytes8": rng.integers(0, 255, size=100).astype(np.uint8),
    }


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16)
        return t.numpy()
    return np.asarray(t)


def _bits(a) -> np.ndarray:
    a = _np(a)
    return a.view(f"u{a.itemsize}") if a.dtype.kind == "f" or a.dtype == BF16 else a


def _same(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.shape == b.shape and str(a.dtype) == str(b.dtype) and \
        np.array_equal(_bits(a), _bits(b))


def _codecs(bound=1e-4, chunk=1 << 14, **kw):
    port = TreeCodec(codec=SZxCodec(device="cpu"), bound=Bound.rel(bound), chunk_bytes=chunk, **kw)
    ref = RTreeCodec(codec=RCodec(backend="numpy"), bound=RBound.rel(bound), chunk_bytes=chunk,
                     **kw)
    return port, ref


# ---------------------------------------------------------------------------
# TreeCodec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_elems", [1024, 1 << 62])
def test_tree_stream_is_byte_identical_and_cross_restores(tmp_path, min_elems):
    port, ref = _codecs(min_compress_elems=min_elems)
    tree = _tree(3)
    with open(tmp_path / "p.szt", "wb") as f:
        pm = port.compress_tree(tree, f)
    with open(tmp_path / "r.szt", "wb") as f:
        rm = ref.compress_tree(tree, f)
    assert (tmp_path / "p.szt").read_bytes() == (tmp_path / "r.szt").read_bytes()
    assert pm == rm
    names = [m["name"] for m in pm["leaves"]]
    assert "opt/.step" in names and "layers/1/a" in names
    with open(tmp_path / "r.szt", "rb") as f:
        mine = port.decompress_tree(f)
    with open(tmp_path / "r.szt", "rb") as f:
        theirs = ref.decompress_tree(f)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert _same(mine[k], theirs[k]), k
    # the reference reads the port's stream into a template
    with open(tmp_path / "p.szt", "rb") as f:
        filled = ref.decompress_tree(f, template=tree)
    for n, a in pytree.leaf_paths(filled):
        assert _same(a, theirs[n]), n


def test_tree_select_template_and_errors(tmp_path):
    port, _ref = _codecs()
    tree = _tree(1, state_cls=AdamWState)
    with open(tmp_path / "t.szt", "wb") as f:
        port.compress_tree(tree, f)
    with open(tmp_path / "t.szt", "rb") as f:
        part = port.decompress_tree(f, select=["counts", "layers/0/b"])
        assert list(part) == ["counts", "layers/0/b"]
        assert _same(part["counts"], tree["counts"])
        assert part["layers/0/b"].dtype == torch.bfloat16
        full = port.decompress_tree(f, template=tree)
        assert isinstance(full["opt"], AdamWState) and int(full["opt"].step) == 1
        assert _same(full["mask"], tree["mask"]) and full["mask"].dtype == torch.bool
        w = tree["w"]
        assert float(np.abs(full["w"].numpy() - w).max()) <= 1e-4 * float(w.max() - w.min())
        with pytest.raises(ValueError, match="duplicate"):
            port.decompress_tree(f, select=["w", "w"])
        with pytest.raises(KeyError):
            port.decompress_tree(f, select=["nope"])
        with pytest.raises(ValueError):
            port.decompress_tree(f, select=["w"], template=tree)
    (tmp_path / "x.szt").write_bytes(b"not a stream at all")
    with open(tmp_path / "x.szt", "rb") as f, pytest.raises(ValueError, match="TreeCodec"):
        port.decompress_tree(f)


def test_tree_walk_is_sorted_and_tree_map_keeps_the_callers_order():
    tree = {"b": [1, {"z": 2, "y": 3}], "a": AdamWState(4, {"w": 5}, {"w": 6})}
    assert pytree.leaf_paths(tree) == [("a/.step", 4), ("a/.m/w", 5), ("a/.v/w", 6),
                                       ("b/0", 1), ("b/1/y", 3), ("b/1/z", 2)]
    doubled = pytree.tree_map(lambda x: 2 * x, tree)
    assert list(doubled) == ["b", "a"] and list(doubled["b"][1]) == ["z", "y"]
    assert doubled["b"][1]["z"] == 4 and doubled["a"].v["w"] == 12
    assert pytree.unflatten(tree, range(6))["b"][1] == {"z": 5, "y": 4}
    with pytest.raises(ValueError):
        pytree.unflatten(tree, range(7))


def test_none_is_an_empty_subtree_as_in_jax():
    """None is a node with no children: it yields no leaf and is rebuilt."""
    tree = {"a": 1, "b": None, "c": [None, 2, (None,)]}
    assert pytree.leaf_paths(tree) == [("a", 1), ("c/1", 2)]
    assert pytree.leaves(None) == []
    assert pytree.tree_map(lambda x: 10 * x, tree) == {"a": 10, "b": None, "c": [None, 20, (None,)]}
    assert pytree.unflatten(tree, [5, 6]) == {"a": 5, "b": None, "c": [None, 6, (None,)]}


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.uint64])
def test_unsigned_leaves_are_byte_identical(tmp_path, dtype):
    import io

    port, ref = _codecs()
    tree = {"u": np.arange(3000).astype(dtype), "w": _tree(0)["w"]}
    a, b = io.BytesIO(), io.BytesIO()
    pm = port.compress_tree(tree, a)
    rm = ref.compress_tree(tree, b)
    assert a.getvalue() == b.getvalue() and pm == rm
    b.seek(0)
    back = port.decompress_tree(b)["u"]
    assert back.dtype == getattr(torch, np.dtype(dtype).name)
    assert _same(back, tree["u"])


def test_tree_leaves_may_be_tensors():
    import io

    port, ref = _codecs()
    tree = _tree(2)
    as_tensors = pytree.tree_map(
        lambda a: torch.from_numpy(np.asarray(a).view(np.int16)).view(torch.bfloat16)
        if np.asarray(a).dtype == BF16 else torch.from_numpy(np.array(a)), tree)
    a, b = io.BytesIO(), io.BytesIO()
    port.compress_tree(as_tensors, a)
    ref.compress_tree(tree, b)
    assert a.getvalue() == b.getvalue()


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
def test_checkpoint_files_byte_identical_and_cross_restore(tmp_path, compress):
    kw = dict(compress=compress, chunk_bytes=1 << 14, keep=2)
    pm = CheckpointManager(str(tmp_path / "p"), device="cpu", bound=Bound.rel(1e-3), **kw)
    rm = RManager(str(tmp_path / "r"), bound=RBound.rel(1e-3), **kw)
    tree = _tree(4)
    pm.save(7, tree)
    rm.save(7, tree)
    dp, dr = tmp_path / "p" / "step_000000007", tmp_path / "r" / "step_000000007"
    assert (dp / "tree.szt").read_bytes() == (dr / "tree.szt").read_bytes()
    mp, mr = (json.loads((d / "MANIFEST.json").read_text()) for d in (dp, dr))
    mp.pop("time"), mr.pop("time")
    assert mp == mr
    assert sorted(os.listdir(dp)) == sorted(os.listdir(dr))
    # cross-restore: each manager reads the other's directory
    mine, step = CheckpointManager(str(tmp_path / "r"), device="cpu").restore(tree)
    theirs, rstep = RManager(str(tmp_path / "p")).restore(tree)
    assert step == rstep == 7
    for (n, a), b in zip(pytree.leaf_paths(mine), pytree.leaves(theirs)):
        assert _same(a, b), n
    assert pm.stats() == rm.stats()
    if compress:
        assert pm.stats()["ratio"] > 1.5


@pytest.mark.parametrize("compress", [False, True])
def test_checkpoint_of_a_tree_with_none_cross_restores(tmp_path, compress):
    w = (np.cumsum(np.random.default_rng(5).standard_normal(4096)) * 0.01).astype(np.float32)
    tree = {"a": w, "b": None}
    kw = dict(compress=compress, chunk_bytes=1 << 14)
    pm = CheckpointManager(str(tmp_path / "p"), device="cpu", bound=Bound.rel(1e-3), **kw)
    rm = RManager(str(tmp_path / "r"), bound=RBound.rel(1e-3), **kw)
    pm.save(1, tree)
    rm.save(1, tree)
    assert (tmp_path / "p" / "step_000000001" / "tree.szt").read_bytes() == \
        (tmp_path / "r" / "step_000000001" / "tree.szt").read_bytes()
    mine, step = CheckpointManager(str(tmp_path / "r"), device="cpu").restore(tree)
    theirs, rstep = RManager(str(tmp_path / "p")).restore(tree)
    assert step == rstep == 1
    assert mine["b"] is None and theirs["b"] is None
    assert _same(mine["a"], theirs["a"])


def test_checkpoint_keep_k_latest_and_uncommitted(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    t = _tree(0)
    for step in (1, 2, 3, 4):
        m.save(step, t)
    assert m.all_steps() == [3, 4] and m.latest_step() == 4
    os.makedirs(tmp_path / "step_000000009")
    (tmp_path / "step_000000009" / "MANIFEST.json").write_text("{}")
    os.makedirs(tmp_path / "step_000000010.tmp")
    assert m.latest_step() == 4
    m.save(5, t)
    assert m.all_steps() == [4, 5]
    assert os.path.isdir(tmp_path / "step_000000009")   # never reaped: not committed
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty"), device="cpu").restore(t)


def test_crash_mid_save_keeps_previous_step(tmp_path, monkeypatch):
    m = CheckpointManager(str(tmp_path), compress=True, bound=Bound.rel(1e-4), device="cpu")
    t0 = _tree(0)
    m.save(0, t0)

    def boom(self, tree, fileobj):
        fileobj.write(b"half a stream")
        raise OSError("disk died mid-save")

    monkeypatch.setattr(TreeCodec, "compress_tree", boom)
    with pytest.raises(OSError):
        m.save(1, _tree(1))
    monkeypatch.undo()
    assert m.all_steps() == [0]
    restored, step = m.restore(t0)
    assert step == 0 and _same(restored["counts"], t0["counts"])
    m.save(1, _tree(1))
    assert m.all_steps() == [0, 1]


def test_async_save_and_errors_on_wait(tmp_path, monkeypatch):
    m = CheckpointManager(str(tmp_path), compress=True, async_save=True, device="cpu")
    t = _tree(0)
    m.save(0, t)
    m.wait()
    assert m.all_steps() == [0]
    real = CheckpointManager._commit

    def boom(self, step, write_stream):
        raise RuntimeError("async writer died")

    monkeypatch.setattr(CheckpointManager, "_commit", boom)
    m.save(1, _tree(1))
    with pytest.raises(RuntimeError, match="async writer died"):
        m.wait()
    monkeypatch.setattr(CheckpointManager, "_commit", real)
    assert m.all_steps() == [0]
    # the leaves are encoded before save() returns: changing them after does
    # not change the checkpoint
    w = torch.from_numpy(t["w"].copy())
    m.save(2, {"w": w})
    w.fill_(0)
    m.wait()
    back = m.restore_leaves(["w"], 2)["w"]
    assert float(back.abs().max()) > 0.1


def test_restore_leaves_and_slices_match_the_reference(tmp_path):
    kw = dict(keep=1, compress=True, chunk_bytes=1 << 18)
    m = CheckpointManager(str(tmp_path / "p"), device="cpu", bound=Bound.rel(1e-5), **kw)
    r = RManager(str(tmp_path / "r"), bound=RBound.rel(1e-5), **kw)
    rng = np.random.default_rng(7)
    w = (np.cumsum(rng.standard_normal(300_000)) * 0.01).astype(np.float32)
    tree = {"emb": w.reshape(3000, 100), "vec": w[:70_000].astype(np.float64),
            "ids": np.arange(400, dtype=np.int32).reshape(100, 4)}
    m.save(0, tree)
    r.save(0, tree)
    for name, rows in (("emb", slice(100, 130)), ("emb", -1), ("emb", slice(2990, 9999)),
                       ("vec", slice(60_000, 70_000)), ("ids", slice(10, 20)), ("ids", 3),
                       ("emb", slice(5, 3))):
        a, b = m.restore_leaf_slice(name, rows), r.restore_leaf_slice(name, rows)
        assert _same(a, b), (name, rows)
    part = m.restore_leaves(["vec", "ids"])
    full = r.restore_leaves(["vec", "ids"])
    assert all(_same(part[k], full[k]) for k in part)
    with pytest.raises(KeyError):
        m.restore_leaf_slice("nope", slice(0, 1))
    with pytest.raises(ValueError):
        m.restore_leaf_slice("emb", slice(0, 10, 2))
    with pytest.raises(IndexError):
        m.restore_leaf_slice("emb", 99_999)


def test_v1_checkpoint_layout_still_restores(tmp_path):
    t = {"w": _tree(5)["w"].reshape(-1), "step": np.int64(5), "big": _tree(6)["w"]}
    d = tmp_path / "step_000000005"
    d.mkdir()
    codec = RCodec(backend="numpy")
    leaves = []
    for i, (name, arr) in enumerate(sorted(t.items())):
        arr = np.asarray(arr)
        fn = f"{i:05d}.bin"
        if name == "w":
            data, leaf_codec = codec.compress(arr, RBound.rel(1e-4)), "szx"
        elif name == "big":
            import io

            buf = io.BytesIO()
            codec.dump_chunked(arr, buf, RBound.rel(1e-4), chunk_bytes=1 << 14)
            data, leaf_codec = buf.getvalue(), "szx-chunked"
        else:
            data, leaf_codec = arr.tobytes(), "raw"
        (d / fn).write_bytes(data)
        leaves.append({"name": name, "file": fn, "shape": list(arr.shape),
                       "dtype": str(arr.dtype), "codec": leaf_codec,
                       "raw_bytes": arr.nbytes, "stored_bytes": len(data)})
    (d / "MANIFEST.json").write_text(json.dumps({"step": 5, "time": 0.0, "leaves": leaves}))
    (d / "_COMMITTED").write_text("ok")
    m = CheckpointManager(str(tmp_path), compress=True, device="cpu")
    r = RManager(str(tmp_path), compress=True)
    mine, step = m.restore(t)
    theirs, _ = r.restore(t)
    assert step == 5
    for k in t:
        assert _same(mine[k], theirs[k]), k
    assert int(m.restore_leaves(["step"])["step"]) == 5
    assert _same(m.restore_leaf_slice("big", slice(3, 9)), theirs["big"][3:9])


def test_stores_under_the_manager(tmp_path):
    m = CheckpointManager(str(tmp_path), bound=Bound.abs(1e-3), device="cpu")
    r = RManager(str(tmp_path), bound=RBound.abs(1e-3))
    x = (np.cumsum(np.random.default_rng(0).standard_normal((64, 300)), 1) * 0.01) \
        .astype(np.float32)
    path = m.save_store("corpus", x, chunk_bytes=1 << 14)
    assert m.stores() == ["corpus"] == r.stores()
    back = m.restore_store("corpus")
    assert _same(back, r.restore_store("corpus"))
    assert float(np.abs(back.numpy() - x).max()) <= 1e-3
    with m.open_store("corpus") as ca:
        assert _same(ca[3:5, 10:20], back[3:5, 10:20])
    r.save_store("theirs", x, chunk_bytes=1 << 14)
    assert open(path, "rb").read() == open(r.store_path("theirs"), "rb").read()
    with pytest.raises(ValueError):
        m.store_path("../x")


LEAVES = ["w", "layers/0/a", "layers/0/b", "layers/1/a"]     # f32, f64, bf16, f16
LEAF_SHAPES = {"w": [500, 100], "layers/0/a": [3000], "layers/0/b": [2000], "layers/1/a": [5000]}
LEAF_KEYS = [np.s_[...], np.s_[7], np.s_[100:1141], np.s_[-300:], np.s_[1999:2000],
             np.s_[5:5]]


def _leaf_checkpoints(tmp_path):
    kw = dict(keep=1, compress=True, chunk_bytes=1 << 12)
    m = CheckpointManager(str(tmp_path / "p"), device="cpu", bound=Bound.rel(1e-4), **kw)
    r = RManager(str(tmp_path / "r"), bound=RBound.rel(1e-4), **kw)
    tree = _tree(5)
    m.save(3, tree)
    r.save(3, tree)
    return m, r


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("leaf", LEAVES)
def test_leaf_store_matches_the_reference(tmp_path, leaf, writer, fused):
    """A leaf view of the port's checkpoint and of the reference's (each
    package opens both) gives the reference's leaf_store values on the same
    files, bit for bit, and its geometry, attrs and header-tier stats."""
    m, r = _leaf_checkpoints(tmp_path)
    root = str(tmp_path / ("p" if writer == "port" else "r"))
    mine = CheckpointManager(root, device="cpu").leaf_store(leaf, fused_range=fused)
    theirs = RManager(root).leaf_store(leaf, 3)
    try:
        assert mine.shape == theirs.shape and mine.nchunks == theirs.nchunks
        assert mine.nchunks >= (1 if leaf == "layers/0/b" else 2)
        assert mine.attrs == theirs.attrs
        assert mine.attrs["leaf_shape"] == LEAF_SHAPES[leaf]
        assert mine._seq_base == theirs._seq_base > 0
        assert mine.error_bound == theirs.error_bound
        for key in LEAF_KEYS:
            assert _same(mine[key], theirs[key]), key
        assert mine.stats(header_only=True).to_dict() == \
            theirs.stats(header_only=True).to_dict()
        st, rst = mine.stats(), theirs.stats()
        assert (st.count, st.min, st.max) == (rst.count, rst.min, rst.max)
        assert abs(st.sum[0] - rst.sum[0]) <= 1e-12 * max(abs(rst.sum[0]), 1.0)
        # and it holds the leaf: within the bound of the saved values
        want = m.restore_leaves([leaf])[leaf].reshape(-1)
        assert _same(mine[...], want)
    finally:
        mine.close()
        theirs.close()


def test_leaf_store_refuses_what_is_not_a_szx_leaf(tmp_path):
    m, r = _leaf_checkpoints(tmp_path)
    for mgr in (m, r):
        with pytest.raises(ValueError, match="store-viewable"):
            mgr.leaf_store("step")
        with pytest.raises(KeyError):
            mgr.leaf_store("nope")


def test_seq_base_mismatch_raises_as_in_the_reference(tmp_path):
    """Frames are validated as seq_base + chunk id, by ROI reads and both
    query tiers: a view over a leaf's frames with the wrong base raises,
    with the reference's message."""
    from repro.store.array import CompressedArray as RArray
    from repro_torch.store import format as format_mod
    from repro_torch.store.array import CompressedArray

    m, _r = _leaf_checkpoints(tmp_path)
    lv = m.leaf_store("w")
    idx = format_mod.build_store_index(lv._grid, lv._spec.code, lv._block_size, lv._e,
                                       lv._frames, lv.attrs)
    path = os.path.join(str(tmp_path / "p"), "step_000000003", "tree.szt")
    for base in (0, lv._seq_base + 1):
        mine = CompressedArray(open(path, "rb"), idx, device="cpu", own_file=True,
                               seq_base=base)
        theirs = RArray(open(path, "rb"), idx, own_file=True, seq_base=base)
        for read in (lambda a: a[0:10], lambda a: a.stats(), lambda a: a.stats(header_only=True)):
            with pytest.raises(ValueError) as got:
                read(mine)
            with pytest.raises(ValueError) as want:
                read(theirs)
            assert str(got.value) == str(want.value)
        mine.close()
        theirs.close()
    assert _same(lv[0:10], m.restore_leaf_slice("w", slice(0, 1)).reshape(-1)[:10])
    lv.close()


@pytest.mark.parametrize("workers", [0, 2])
def test_store_loader_over_a_leaf_view(tmp_path, workers):
    """A checkpoint leaf streams through the same loader: the port's batches
    over its leaf view equal the reference loader's over the reference's
    view of the same file, serial and pipelined."""
    from repro.data import StoreLoader as RLoader
    from repro_torch.data import StoreLoader

    m, r = _leaf_checkpoints(tmp_path)
    lv, rv = m.leaf_store("w"), r.leaf_store("w")
    with StoreLoader(lv, (512,), 4, seed=2, workers=workers) as ld, \
            RLoader(rv, (512,), 4, seed=2, workers=workers) as rld:
        piped = [b.clone() for b in ld.batches(steps=3)]
        for s in range(3):
            want = rld.batch_at(s)
            assert _same(ld.batch_at(s), want) and _same(piped[s], want), s
    lv.close()
    rv.close()


# ---------------------------------------------------------------------------
# Trainer (tests/test_substrate.py's toy model, on the port's optimizer)
# ---------------------------------------------------------------------------

def _toy_trainer(tmp_path, fault_hook=None, total=30):
    opt = AdamW(lr=1e-2)

    def step_fn(state, batch):
        p = [t.detach().requires_grad_() for t in pytree.leaves(state["params"])]
        params = pytree.unflatten(state["params"], p)
        with torch.enable_grad():
            pred = batch["x"] @ params["w"] + params["b"]
            loss = torch.mean((pred - batch["y"]) ** 2)
            g = torch.autograd.grad(loss, p)
        params, o, metrics = opt.update(pytree.unflatten(state["params"], list(g)),
                                        state["opt"], state["params"])
        return {"params": params, "opt": o}, {"loss": loss.detach(), **metrics}

    def batch_fn(step):
        rng = np.random.default_rng(step)
        x = rng.standard_normal((8, 16)).astype(np.float32)
        w_true = np.linspace(-1, 1, 16 * 4).reshape(16, 4).astype(np.float32)
        return {"x": torch.from_numpy(x), "y": torch.from_numpy(x @ w_true)}

    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((16, 4), generator=gen) * 0.1, "b": torch.zeros(4)}
    state = {"params": params, "opt": opt.init(params)}
    ckpt = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    tr = Trainer(TrainerConfig(total_steps=total, checkpoint_every=5, max_restarts=3),
                 step_fn, batch_fn, ckpt, fault_hook=fault_hook)
    return tr, state


def test_trainer_converges(tmp_path):
    tr, state = _toy_trainer(tmp_path)
    tr.run(state)
    assert tr.history[-1]["loss"] < tr.history[0]["loss"] * 0.5
    assert tr.ckpt.latest_step() == 29 and len(tr.step_times) == 30


def test_trainer_restarts_after_injected_fault(tmp_path):
    crashed = {"done": False}

    def fault(step):
        if step == 17 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")

    tr, state = _toy_trainer(tmp_path, fault_hook=fault)
    tr.run(state)
    assert tr.restarts == 1
    steps = [h["step"] for h in tr.history]
    assert steps.count(16) == 2          # replayed from the step-15 checkpoint
    assert steps[-1] == 29
    # a replayed step sees the restored state: its loss equals the first run's
    first, again = [h["loss"] for h in tr.history if h["step"] == 16]
    assert first == again


def test_trainer_gives_up_after_max_restarts(tmp_path):
    def fault(step):
        if step >= 6:
            raise RuntimeError("permafault")

    tr, state = _toy_trainer(tmp_path, fault_hook=fault)
    with pytest.raises(RuntimeError, match="max_restarts"):
        tr.run(state)
    assert tr.restarts == 4


def test_trainer_reraises_before_the_first_checkpoint(tmp_path):
    def fault(step):
        if step == 2:
            raise KeyError("early")

    tr, state = _toy_trainer(tmp_path, fault_hook=fault)
    with pytest.raises(KeyError):
        tr.run(state)
    assert tr.restarts == 1


def test_trainer_resumes_from_the_latest_checkpoint(tmp_path):
    tr, state = _toy_trainer(tmp_path, total=12)
    tr.run(state)
    tr2, state2 = _toy_trainer(tmp_path, total=20)
    tr2.run(state2)
    assert [h["step"] for h in tr2.history] == list(range(12, 20))
