"""Fault-tolerant checkpoint manager with optional SZx compression.

Counterpart of ``repro/checkpoint/manager.py``, with the same layout (one
directory per step, MANIFEST v2), so each package restores the other's
checkpoints:

    <root>/step_000123/
        MANIFEST.json      -- {"manifest_version": 2, "step", "time",
                               "file": "tree.szt", "leaves": [...], ...}
        tree.szt           -- ONE container-v3 TreeCodec stream
        _COMMITTED         -- commit marker (written last)

  * atomic commit: a ``.tmp`` directory renamed into place after the
    marker is written, so a crashed writer never corrupts the latest
    checkpoint; keep-last-k garbage collection over committed steps only;
  * error-bounded SZx compression of float leaves through ``TreeCodec``.
    Leaves on the card are compressed there (the port's encode kernel) and
    only the stream bytes are copied to the host, where the reference
    copies the whole tree to the host first; restores decode on the card;
  * async save: the leaves are encoded (on the card) before ``save``
    returns -- the state may be updated in place right after -- and the
    file writes and the commit run on a thread; an error surfaces on the
    next ``wait``;
  * partial restores: ``restore_leaves(names)`` reads only the named
    leaves' byte ranges, ``restore_leaf_slice`` only the frames (and SZx
    blocks) of a leading-axis slice;
  * stores: ``save_store``/``open_store``/``restore_store``/``stores``
    keep ``ArrayStore`` corpora under ``<root>/stores``, and ``leaf_store``
    opens one SZx leaf of a checkpoint as a lazy 1-d store view (ROI reads
    and ``StoreLoader`` windows over its frames in ``tree.szt``).
v1 checkpoints (one file per leaf) restore as well.
"""
from __future__ import annotations

import io
import json
import math
import os
import shutil
import threading
import time
from typing import Iterable, Optional

import torch

from repro_torch import obs
from repro_torch.core import pytree
from repro_torch.core.codec import container
from repro_torch.core.codec.plan import Bound, as_bound
from repro_torch.core.codec.szx_codec import SZxCodec
from repro_torch.core.codec.tree import TreeCodec, leaf_paths, torch_dtype_for

_MARKER = "_COMMITTED"
_STREAM = "tree.szt"
MANIFEST_VERSION = 2


class CheckpointManager:
    """Checkpoints of trees under ``root``.  ``device`` is where leaves are
    encoded and restored (``None``: the card, which must be there)."""

    def __init__(
        self,
        root: str,
        *,
        keep: int = 3,
        compress: bool = False,
        bound: Bound | float | None = None,
        async_save: bool = False,
        chunk_bytes: int = 64 << 20,
        workers: int = 1,
        stage: str | int | None = None,
        device=None,
    ):
        self.root = root
        self.keep = keep
        self.compress = compress
        self.bound = Bound.rel(1e-6) if bound is None else as_bound(
            bound, owner="CheckpointManager")
        self.async_save = async_save
        self.chunk_bytes = chunk_bytes
        self._codec = SZxCodec(workers=workers, stage=stage, device=device)
        # compress=False stores EVERY leaf raw: min_compress_elems above any
        # real leaf size routes all of them into the shared pack frame
        self._tree_codec = TreeCodec(
            codec=self._codec, bound=self.bound, chunk_bytes=chunk_bytes,
            min_compress_elems=1024 if compress else (1 << 62),
        )
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)

    @property
    def device(self) -> torch.device:
        return self._codec.device

    # ----------------------------------------------------------- save
    def save(self, step: int, tree, *, mesh=None, axis: str = "data") -> dict:
        """Commit ``tree`` as step ``step``; returns the stream manifest.

        With ``mesh`` every rank of it calls ``save``: each member along
        ``axis`` compresses its block-aligned range of every large leaf
        (``TreeCodec.compress_tree_sharded``; leaves may be ``DTensor``s),
        the rank at coordinate 0 commits the step, and all return after the
        commit."""
        if mesh is not None:
            return self._save_sharded(step, tree, mesh, axis)
        if not self.async_save:
            return self._save_sync(step, tree)
        self.wait()
        buf = io.BytesIO()
        manifest = self._encode(step, tree, buf)                # encode now

        def write(f) -> dict:
            f.write(buf.getbuffer())
            return manifest

        def run():
            try:
                self._commit(step, write)
            except BaseException as e:  # noqa: BLE001 -- surfaced on the next wait()
                self._last_error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return manifest

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    def _save_sharded(self, step: int, tree, mesh, axis: str) -> dict:
        import torch.distributed as dist

        self.wait()

        def encode(f) -> dict:
            with obs.span("checkpoint.save", step=step):
                return self._tree_codec.compress_tree_sharded(tree, f, mesh, axis=axis)

        if all(c == 0 for c in mesh.get_coordinate()):
            manifest = self._commit(step, encode)
        else:
            manifest = encode(None)
        if dist.is_initialized():
            dist.barrier()
        return manifest

    def _save_sync(self, step: int, tree) -> dict:
        return self._commit(step, lambda f: self._encode(step, tree, f))

    def _encode(self, step: int, tree, f) -> dict:
        """``tree`` as one TreeCodec stream into ``f``; returns its manifest.
        Per-leaf encode time lands as ``tree.leaf_encode`` spans."""
        with obs.span("checkpoint.save", step=step):
            stream_manifest = self._tree_codec.compress_tree(tree, f)
        if obs.enabled():
            obs.counter("checkpoint.saves").inc()
            obs.counter("checkpoint.saved_raw_bytes").inc(int(stream_manifest["raw_bytes"]))
            obs.counter("checkpoint.saved_bytes").inc(int(stream_manifest["stored_bytes"]))
        return stream_manifest

    def _commit(self, step: int, write_stream) -> dict:
        """Write the stream (``write_stream(file)`` returns its manifest)
        and MANIFEST.json into ``step_<n>.tmp``, mark it committed, rename
        it into place, GC; returns the stream manifest."""
        final = os.path.join(self.root, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _STREAM), "wb") as f:
            stream_manifest = write_stream(f)
        manifest = {
            "manifest_version": MANIFEST_VERSION,
            "step": step,
            "time": time.time(),
            "file": _STREAM,
            "leaves": stream_manifest["leaves"],
            # frame byte ranges duplicated from the stream's index footer:
            # a sliced restore seeks without re-reading the footer
            "frames": stream_manifest["frames"],
            "raw_bytes": stream_manifest["raw_bytes"],
            "stored_bytes": stream_manifest["stored_bytes"],
        }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, _MARKER), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)      # atomic commit
        self._gc()
        return stream_manifest

    def _gc(self) -> None:
        steps = self.all_steps()   # committed steps only, by construction
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"), ignore_errors=True)

    # ----------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in sorted(os.listdir(self.root)):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, d, _MARKER)):
                    out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: Optional[int]) -> tuple[str, dict]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {self.root}")
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        return d, manifest

    def restore(self, template, step: Optional[int] = None, *, shardings=None):
        """Restore into the structure of ``template`` (a tree; only its leaf
        names are read) -> (tree of tensors on the manager's device, step).

        ``shardings``: a matching tree of ``launch.mesh.NamedSharding`` --
        each leaf comes back as a ``DTensor`` on that mesh holding only this
        rank's shard (elastic restore onto any mesh: the file stores whole
        leaves)."""
        d, manifest = self._step_dir(step)
        by_name = {m["name"]: m for m in manifest["leaves"]}
        names = [name for name, _ in leaf_paths(template)]
        for name in names:
            if name not in by_name:
                raise KeyError(f"leaf {name} not in checkpoint step {manifest['step']}")
        # per-leaf decode time lands as tree.leaf_decode spans
        with obs.span("checkpoint.restore", step=int(manifest["step"])):
            if manifest.get("manifest_version", 1) >= 2:
                with open(os.path.join(d, manifest["file"]), "rb") as f:
                    arrays = self._tree_codec.decompress_tree(f, select=names)
            else:
                arrays = {n: self._restore_leaf_v1(d, by_name[n]) for n in names}
        if obs.enabled():
            obs.counter("checkpoint.restores").inc()
        out = [arrays.pop(n) for n in names]
        if shardings is not None:
            out = [sh.shard(t) for t, sh in zip(out, pytree.leaves(shardings))]
        return pytree.unflatten(template, out), manifest["step"]

    def restore_leaves(self, names: Iterable[str], step: Optional[int] = None
                       ) -> dict[str, torch.Tensor]:
        """Partial restore: read ONLY the named leaves' byte ranges."""
        d, manifest = self._step_dir(step)
        if manifest.get("manifest_version", 1) >= 2:
            with open(os.path.join(d, manifest["file"]), "rb") as f:
                return self._tree_codec.decompress_tree(f, select=list(names))
        by_name = {m["name"]: m for m in manifest["leaves"]}
        out = {}
        for n in names:
            if n not in by_name:
                raise KeyError(f"leaf {n} not in checkpoint step {manifest['step']}")
            out[n] = self._restore_leaf_v1(d, by_name[n])
        return out

    def restore_leaf_slice(self, name: str, rows, step: Optional[int] = None
                           ) -> torch.Tensor:
        """Rows ``rows`` (an int or a step-1 slice over the LEADING axis) of
        leaf ``name``, reading and decoding only the frames -- and within
        boundary frames only the SZx blocks -- that the slice touches."""
        d, manifest = self._step_dir(step)
        by_name = {m["name"]: m for m in manifest["leaves"]}
        if name not in by_name:
            raise KeyError(f"leaf {name} not in checkpoint step {manifest['step']}")
        meta = by_name[name]
        if manifest.get("manifest_version", 1) < 2:
            # v1 layouts have no per-leaf frame index: restore + slice
            return self._restore_leaf_v1(d, meta)[rows]
        shape = tuple(meta["shape"])
        if not shape:
            raise ValueError(f"leaf {name} is a scalar; use restore_leaves")
        dtype = torch_dtype_for(meta["dtype"])
        if isinstance(rows, slice):
            if rows.step not in (None, 1):
                raise ValueError("restore_leaf_slice supports step-1 slices only")
            lo, hi, _ = rows.indices(shape[0])
            if hi <= lo:                    # numpy semantics: empty slice
                return torch.empty((0,) + shape[1:], dtype=dtype, device=self.device)
            squeeze = False
        else:
            lo = int(rows) + (shape[0] if int(rows) < 0 else 0)
            if not 0 <= lo < shape[0]:
                raise IndexError(f"row {rows} out of range for shape {shape}")
            hi, squeeze = lo + 1, True
        row_elems = 1
        for s in shape[1:]:
            row_elems *= int(s)
        flat_lo, flat_hi = lo * row_elems, hi * row_elems
        with open(os.path.join(d, manifest["file"]), "rb") as f:
            frames = manifest["frames"] if "frames" in manifest else \
                container.read_index_footer(f)["frames"]
            if meta["codec"] == "raw":
                frame_off, _len = frames[meta["frames"][0]][:2]
                inner, _size = meta["pack"]
                itemsize = torch.empty(0, dtype=dtype).element_size()
                f.seek(frame_off + container.FRAME_HEADER.size + inner + flat_lo * itemsize)
                data = bytearray(container._read_exact(f, (flat_hi - flat_lo) * itemsize))
                out = torch.frombuffer(data, dtype=torch.uint8).view(dtype).to(self.device)
            else:
                out = torch.empty(flat_hi - flat_lo, dtype=dtype, device=self.device)
                self._fill_from_szx_frames(f, frames, meta["frames"], flat_lo, flat_hi, out)
        out = out.reshape((hi - lo,) + shape[1:])
        return out[0] if squeeze else out

    def _fill_from_szx_frames(self, f, frames, frame_range, flat_lo, flat_hi, out) -> None:
        """Fill ``out`` with elements [flat_lo, flat_hi) of a leaf stored as
        chunk frames: peek each frame's element count from its header, then
        read and block-range-decode only the intersecting frames."""
        lo_f, hi_f = frame_range
        base = 0                           # flat offset of the current frame
        for i in range(lo_f, hi_f):
            off, length = frames[i][:2]
            _flags, _plen, sheader = container.read_frame_stream_header_at(f, off, i)
            _m, _v, _dt, bs, n, _e, _nb, _nnc, _nmid = container.HEADER.unpack_from(sheader, 0)
            frame_lo, frame_hi = base, base + n
            base = frame_hi
            if frame_hi <= flat_lo:
                continue
            if frame_lo >= flat_hi:
                break
            payload, _flags = container.read_frame_at(f, off, length, i, device=self.device)
            ilo, ihi = max(flat_lo, frame_lo), min(flat_hi, frame_hi)
            b_lo, b_hi = (ilo - frame_lo) // bs, (ihi - frame_lo - 1) // bs + 1
            seg = self._codec.decompress_range(payload, b_lo, b_hi)
            out[ilo - flat_lo: ihi - flat_lo] = seg[
                (ilo - frame_lo) - b_lo * bs: (ihi - frame_lo) - b_lo * bs]
        if base < flat_hi:
            raise ValueError(f"leaf frames cover {base} elements, slice needs {flat_hi}")

    def _restore_leaf_v1(self, d: str, meta: dict) -> torch.Tensor:
        """Per-leaf-file layout of pre-TreeCodec checkpoints."""
        dtype = torch_dtype_for(meta["dtype"])
        shape = tuple(meta["shape"])
        path = os.path.join(d, meta["file"])
        if meta["codec"] == "szx-chunked":
            n = 1
            for s in shape:
                n *= int(s)
            with open(path, "rb") as f:
                return self._codec.load_chunked(f, n=n).reshape(shape).to(dtype)
        with open(path, "rb") as f:
            data = f.read()
        if meta["codec"] == "szx":
            return self._codec.decompress(data).reshape(shape).to(dtype)
        return torch.frombuffer(bytearray(data), dtype=torch.uint8).view(dtype) \
            .reshape(shape).to(self.device)

    # ------------------------------------------------- checkpoint <-> store
    def store_path(self, name: str) -> str:
        if not name or any(c in name for c in "/\\") or name.startswith("."):
            raise ValueError(f"bad store name {name!r}")
        return os.path.join(self.root, "stores", f"{name}.szs")

    def save_store(self, name: str, arr, *, bound=None,
                   chunk_shape: tuple[int, ...] | None = None,
                   chunk_bytes: int | None = None,
                   attrs: Optional[dict] = None) -> str:
        """Write ``arr`` as an ArrayStore under ``<root>/stores/<name>.szs``
        (tmp + rename); returns the path.  Defaults to the manager's bound
        and the store's ~2 MB chunks."""
        from repro_torch.store import ArrayStore
        from repro_torch.store.grid import DEFAULT_CHUNK_TARGET_BYTES

        path = self.store_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        try:
            ArrayStore.save(
                tmp, arr, self.bound if bound is None else bound,
                chunk_shape=chunk_shape,
                chunk_bytes=chunk_bytes or DEFAULT_CHUNK_TARGET_BYTES,
                device=self.device, workers=self._codec.workers, attrs=attrs,
                stage=self._codec.stage,
            )
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        return path

    def open_store(self, name: str, **open_kw):
        """Lazy ``CompressedArray`` over a saved corpus (``device=``,
        ``fused_range=``, ``cache=`` pass through; the device defaults to
        the manager's)."""
        from repro_torch.store import ArrayStore

        open_kw.setdefault("device", self.device)
        return ArrayStore.open(self.store_path(name), **open_kw)

    def restore_store(self, name: str) -> torch.Tensor:
        with self.open_store(name) as ca:
            return ca[...]

    def stores(self) -> list[str]:
        d = os.path.join(self.root, "stores")
        if not os.path.isdir(d):
            return []
        return sorted(fn[:-4] for fn in os.listdir(d) if fn.endswith(".szs"))

    def leaf_store(self, name: str, step: Optional[int] = None, *, device=None,
                   fused_range: bool = False):
        """Open ONE SZx-compressed checkpoint leaf as a lazy store view.

        Synthesizes a 1-d block-grid index over the leaf's chunk frames in
        ``tree.szt`` (same container, same per-chunk SZx streams as an
        ArrayStore file, just with GLOBAL frame sequence numbers -- hence
        ``seq_base``), so the leaf is ROI/window-queryable through
        ``CompressedArray`` and ``StoreLoader`` with bytes read ∝ ROI.
        The view is 1-d over the leaf's C-order flattening; its ``attrs``
        carry the logical ``leaf_shape``.  ``device`` (default: the
        manager's) and ``fused_range`` are ``ArrayStore.open``'s.
        """
        from repro_torch.core.codec import device as device_mod, plan
        from repro_torch.store import format as format_mod
        from repro_torch.store.array import CompressedArray
        from repro_torch.store.grid import ChunkGrid

        d, manifest = self._step_dir(step)
        if manifest.get("manifest_version", 1) < 2:
            raise ValueError("leaf_store needs a v2 (tree-stream) checkpoint")
        by_name = {m["name"]: m for m in manifest["leaves"]}
        if name not in by_name:
            raise KeyError(f"leaf {name} not in checkpoint step {manifest['step']}")
        meta = by_name[name]
        if meta["codec"] != "szx":
            raise ValueError(
                f"leaf {name} is stored {meta['codec']!r}; only szx-compressed leaves "
                "are store-viewable (raw-pack leaves restore via restore_leaves)"
            )
        shape = tuple(int(s) for s in meta["shape"]) or (1,)
        n = math.prod(shape)
        lo_f, hi_f = (int(v) for v in meta["frames"])
        frames_all = manifest["frames"]
        spec = plan.spec_for(torch_dtype_for(meta["dtype"]))
        dev = self.device if device is None else device_mod.resolve_device(
            device, "CheckpointManager.leaf_store")
        f = open(os.path.join(d, manifest["file"]), "rb")
        try:
            off0 = int(frames_all[lo_f][0])
            _flags, _plen, sheader = container.read_frame_stream_header_at(f, off0, lo_f)
            _m, _v, _dt, bs, n0, e, _nb, _nnc, _nmid = container.HEADER.unpack_from(sheader, 0)
            # tree chunking is uniform except the tail, so the first frame's
            # element count IS the chunk size of a 1-d grid over the leaf
            per = n if hi_f - lo_f == 1 else int(n0)
            grid = ChunkGrid((n,), (min(per, n),))
            if grid.nchunks != hi_f - lo_f:
                raise ValueError(
                    f"leaf {name}: {hi_f - lo_f} frames do not form a uniform chunk "
                    f"grid ({per} elements/frame over {n})"
                )
            frames = []
            for i in range(lo_f, hi_f):
                off, length = (int(v) for v in frames_all[i][:2])
                frames.append([off, length, grid.chunk_elements(grid.chunk_coord(i - lo_f))])
            idx = format_mod.build_store_index(
                grid, spec.code, int(bs), float(e), frames,
                {"leaf": name, "leaf_shape": list(shape), "step": manifest["step"]},
            )
            return CompressedArray(f, idx, device=dev, fused_range=fused_range,
                                   own_file=True, seq_base=lo_f)
        except BaseException:
            f.close()
            raise

    def stats(self, step: Optional[int] = None) -> dict:
        _, manifest = self._step_dir(step)
        raw = sum(m["raw_bytes"] for m in manifest["leaves"])
        stored = sum(m["stored_bytes"] for m in manifest["leaves"])
        return {"step": manifest["step"], "raw_bytes": raw, "stored_bytes": stored,
                "ratio": raw / max(stored, 1)}
