"""Plan layer: dtype resolution, error-bound resolution, blocking/padding.

The first stage of the codec pipeline (paper Algorithm 1, lines 1-2):
everything that must be decided *before* any per-block math runs.  A
:class:`Plan` is a tiny immutable record that the device and container layers
consume.  Inputs become torch tensors here: a CUDA tensor stays where it is,
a numpy array or CPU tensor is copied to the codec's device once.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.specs import DtypeSpec, spec_for, spec_for_code

DEFAULT_BLOCK_SIZE = 128  # paper Fig. 8: best compression-ratio/PSNR tradeoff


@dataclass(frozen=True)
class Bound:
    """The unified error-bound spec accepted everywhere a bound is taken.

    ``Bound.abs(1e-3)`` is an absolute bound ``e``; ``Bound.rel(1e-4)`` is a
    value-range-relative factor (``e = value * (max - min)``, resolved over
    the full array being compressed).  Every API that takes a bound also
    accepts a bare float, which means ``Bound.abs``.
    """

    value: float
    mode: str = "abs"

    def __post_init__(self):
        if self.mode not in ("abs", "rel"):
            raise ValueError(f"unknown bound mode {self.mode!r} (abs/rel)")
        if not float(self.value) > 0:
            raise ValueError("error bound must be positive")
        object.__setattr__(self, "value", float(self.value))

    @classmethod
    def abs(cls, value: float) -> "Bound":  # noqa: A003 - reads as Bound.abs
        """Absolute bound: ``|x - x'| <= value`` element-wise."""
        return cls(value, "abs")

    @classmethod
    def rel(cls, value: float) -> "Bound":
        """Value-range-relative bound: ``e = value * (max(x) - min(x))``."""
        return cls(value, "rel")

    @classmethod
    def parse(cls, text: str) -> "Bound":
        """CLI spelling: ``'1e-3'`` (abs), ``'abs:1e-3'``, or ``'rel:1e-4'``."""
        text = text.strip()
        if ":" in text:
            mode, _, value = text.partition(":")
            return cls(float(value), mode.strip())
        return cls(float(text), "abs")

    def __str__(self) -> str:
        return f"{self.mode}:{self.value:g}"


def as_bound(bound=None, mode: str | None = None, *, error_bound=None,
             owner: str = "", stacklevel: int = 3) -> Bound:
    """Normalize the unified bound argument (the ONE deprecation shim).

    ``bound`` is a :class:`Bound` or a bare positive number (meaning
    ``Bound.abs``).  ``mode`` and ``error_bound`` are the legacy kwargs:
    passing either emits a ``DeprecationWarning``.
    """
    if error_bound is not None:
        if bound is not None:
            raise TypeError(
                f"{owner or 'bound'}: pass bound OR the legacy error_bound=, "
                "not both"
            )
        warnings.warn(
            f"{owner or 'this API'}: the (error_bound, mode=) kwargs are "
            "deprecated; pass repro_torch.api.Bound.abs(e) / Bound.rel(r) instead",
            DeprecationWarning,
            stacklevel=stacklevel,
        )
        return Bound(float(error_bound), mode or "abs")
    if isinstance(bound, Bound):
        if mode is not None:
            raise TypeError(
                f"{owner or 'bound'}: pass the mode inside Bound "
                "(Bound.abs/Bound.rel), not as a mode= kwarg"
            )
        return bound
    if bound is None:
        raise TypeError(f"{owner or 'bound'}: an error bound is required")
    if mode is not None:
        warnings.warn(
            f"{owner or 'this API'}: the (error_bound, mode=) kwargs are "
            "deprecated; pass repro_torch.api.Bound.abs(e) / Bound.rel(r) instead",
            DeprecationWarning,
            stacklevel=stacklevel,
        )
        return Bound(float(bound), mode)
    return Bound(float(bound), "abs")


@dataclass(frozen=True)
class Plan:
    """Resolved compression parameters for one array (or one chunk of it)."""

    dtype: DtypeSpec
    n: int                 # logical element count
    block_size: int
    nblocks: int
    error_bound: float     # resolved ABSOLUTE bound (rel already applied)

    @property
    def raw_bytes(self) -> int:
        return self.n * self.dtype.itemsize


def as_tensor(x, device, dtype=None) -> torch.Tensor:
    """``x`` as a float tensor on ``device`` (no copy when it already lies
    there).  numpy ``bfloat16`` arrays are taken by their bits, so no
    ``ml_dtypes`` import is needed."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            x = torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
        elif a.dtype.kind in "fiub":
            x = torch.from_numpy(a if a.flags.writeable else a.copy())
        else:
            raise TypeError(f"SZx compresses float arrays, got {a.dtype}")
    if dtype is not None:
        x = x.to(spec_for(dtype).dtype)
    if not x.is_floating_point():
        raise TypeError(
            f"SZx compresses float arrays, got {str(x.dtype).removeprefix('torch.')}"
        )
    return x.to(device)


def resolve_error_bound(x: torch.Tensor, bound, mode: str = "abs",
                        spec: DtypeSpec | None = None) -> float:
    """Resolve a bound to an absolute e > 0 (paper REL semantics).

    The ONE place bound resolution happens.  A ``rel`` range ``max - min`` is
    taken in the storage dtype, as numpy does (the difference is formed in
    the compute dtype and rounded once, which is what numpy, ml_dtypes and
    IEEE subtraction in the storage width all give).
    """
    if not isinstance(bound, Bound):
        if mode not in ("abs", "rel"):
            raise ValueError(f"unknown mode {mode!r}")
        bound = Bound(float(bound), mode)
    spec = spec or spec_for(x.dtype)
    if bound.mode == "rel":
        rng = 0.0
        if x.numel():
            from repro_torch.core.codec.device import to_host

            cdt = spec.compute_dtype
            r = (x.max().to(cdt) - x.min().to(cdt)).to(spec.dtype)
            rng = float(to_host(r.reshape(1)).to(torch.float64)[0])
        e = bound.value * rng
        if e == 0.0:
            e = float(torch.finfo(spec.dtype).tiny)
    else:
        e = bound.value
    if e <= 0:
        raise ValueError("error bound must be positive")
    return e


def make_plan(x, bound, *, mode: str = "abs",
              block_size: int = DEFAULT_BLOCK_SIZE, dtype=None,
              device="cpu") -> tuple[Plan, torch.Tensor]:
    """Build the plan for ``x`` and return ``(plan, x as a tensor on device)``.

    ``bound`` is a :class:`Bound` or a bare number interpreted under
    ``mode``.  ``dtype`` forces the codec dtype (the input is cast); by
    default the input's own dtype is kept -- no silent upcast.
    """
    x = as_tensor(x, device, dtype)
    spec = spec_for(x.dtype)
    if not 1 <= block_size <= 0xFFFF:
        raise ValueError(f"block_size {block_size} out of range [1, 65535]")
    e = resolve_error_bound(x, bound, mode, spec)
    n = int(x.numel())
    nblocks = max((n + block_size - 1) // block_size, 0)
    return Plan(spec, n, block_size, nblocks, e), x


def plan_for_stream(dtype_code: int, block_size: int, n: int, e: float) -> Plan:
    """Reconstruct the plan of an existing stream (decode side)."""
    spec = spec_for_code(dtype_code)
    nblocks = max((n + block_size - 1) // block_size, 0)
    return Plan(spec, int(n), int(block_size), nblocks, float(e))


def to_blocks(x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Flatten and pad (edge-replicate) to (nblocks, block_size)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % plan.block_size
    if pad:
        flat = torch.cat([flat, flat[-1:].expand(pad)])
    return flat.reshape(-1, plan.block_size)


def chunk_elements(plan_block_size: int, chunk_bytes: int, itemsize: int) -> int:
    """Largest chunk element count <= chunk_bytes, aligned to block_size."""
    elems = max(chunk_bytes // itemsize, plan_block_size)
    return max(elems // plan_block_size, 1) * plan_block_size
