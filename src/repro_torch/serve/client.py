"""Stdlib HTTP client for the store service: remote ROI reads as tensors.

Counterpart of ``repro/serve/client.py``.  ``RemoteStore`` speaks the
service's wire API with nothing but ``urllib``: ``/info`` for geometry,
``/read?roi=`` for decoded windows (dtype/shape recovered from the
``X-Dtype``/``X-Shape`` response headers), ``/stats`` for compressed-domain
queries.  It talks to a server of either package.  Point it at either

  * a service root (``http://host:port``) -- uses the legacy default-store
    endpoints, or
  * a store base (``http://host:port/v1/stores/<name>``) -- uses the
    multi-store v1 endpoints.

Every request is an independent ``urlopen``, so one client is safe to share
across loader worker threads; the server's decoded-chunk LRU keeps repeated
windows cheap.  ``read`` returns a tensor on the client's ``device`` (the
card unless the caller asks for the CPU): the body's bytes are viewed as
the ``X-Dtype`` they carry and copied to the device once, on the calling
thread's current stream.  This is the transport behind
``repro_torch.data.store_loader``'s URL sources.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import torch

from repro_torch.core.codec.device import resolve_device, to_device
from repro_torch.core.codec.tree import torch_dtype_for


def roi_text(key) -> str:
    """A ``__getitem__`` key (ints / step-1 slices / Ellipsis) -> the
    service's textual ROI (the inverse of ``store.grid.parse_roi``)."""
    if key is Ellipsis or key is None:
        return ""
    if not isinstance(key, tuple):
        key = (key,)
    parts = []
    for k in key:
        if k is Ellipsis:
            parts.append("...")
        elif isinstance(k, slice):
            if k.step not in (None, 1):
                raise ValueError(
                    f"remote ROI reads support step-1 slices only, got {k}"
                )
            lo = "" if k.start is None else int(k.start)
            hi = "" if k.stop is None else int(k.stop)
            parts.append(f"{lo}:{hi}")
        elif hasattr(k, "__index__"):
            parts.append(str(k.__index__()))
        else:
            raise TypeError(
                f"remote ROI reads support ints, step-1 slices, and "
                f"Ellipsis; got {type(k).__name__}"
            )
    return ",".join(parts)


def body_tensor(body: bytes, dtype: torch.dtype, shape, device) -> torch.Tensor:
    """A ``/read`` body (little-endian, C order) as a tensor on ``device``:
    one copy of the bytes to the device, viewed as ``dtype``."""
    if not body:
        return torch.empty(shape, dtype=dtype, device=device)
    return to_device(np.frombuffer(body, np.uint8), device).view(dtype).reshape(shape)


class RemoteStore:
    """Lazy remote view of one served store: ``remote[roi]`` -> tensor on
    ``device`` (``None``: the card, which must be there)."""

    def __init__(self, url: str, *, timeout: float = 60.0, device=None):
        self._base = url.rstrip("/")
        self._timeout = float(timeout)
        self._info: dict | None = None
        self.device = resolve_device(device, "RemoteStore")

    def _get(self, path: str) -> tuple[dict, bytes]:
        req = urllib.request.Request(self._base + path)
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as r:
                return dict(r.headers), r.read()
        except urllib.error.HTTPError as err:
            detail = err.read().decode("utf-8", errors="replace")[:500]
            raise ValueError(
                f"store service returned {err.code} for "
                f"{self._base + path}: {detail}"
            ) from None

    # ------------------------------------------------------------- metadata
    def info(self, *, refresh: bool = False) -> dict:
        if self._info is None or refresh:
            _, body = self._get("/info")
            self._info = json.loads(body)
        return self._info

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(int(d) for d in self.info()["shape"])

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype_for(self.info()["dtype"])

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        return f"RemoteStore({self._base!r})"

    # ------------------------------------------------------------ ROI reads
    def read_bytes(self, roi: str) -> tuple[dict, bytes]:
        """Raw decoded bytes of a textual ROI, plus the response headers."""
        path = "/read"
        if roi:
            path += "?roi=" + urllib.parse.quote(roi)
        return self._get(path)

    def read(self, key=Ellipsis) -> torch.Tensor:
        headers, body = self.read_bytes(roi_text(key))
        dtype = torch_dtype_for(headers.get("X-Dtype", self.info()["dtype"]))
        shape_text = headers.get("X-Shape", "")
        shape = tuple(int(s) for s in shape_text.split(",")) if shape_text else ()
        return body_tensor(body, dtype, shape, self.device)

    def __getitem__(self, key) -> torch.Tensor:
        return self.read(key)

    # ------------------------------------------------- compressed-domain stats
    def stats(self, *, header_only: bool = False) -> dict:
        path = "/stats" + ("?header_only=1" if header_only else "")
        _, body = self._get(path)
        return json.loads(body)
