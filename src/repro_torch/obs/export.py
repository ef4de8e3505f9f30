"""Exporters over a :class:`repro_torch.obs.Registry`: Prometheus text exposition,
Chrome ``trace_event`` JSON (chrome://tracing / Perfetto), and a human
``summary()`` table.

Naming: internal metric names are dotted lowercase (``codec.compress.calls``)
and export as ``szx_`` + underscores (``szx_codec_compress_calls``).  Span
aggregates export as the ``szx_span_count`` / ``szx_span_seconds_total``
families labelled by span name, so Prometheus consumers see span timing
without parsing the trace log.
"""
from __future__ import annotations

import json
import os
import re

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return "szx_" + _NAME_RE.sub("_", name)


def _prom_label_value(v) -> str:
    s = str(v)
    return s.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(
        f'{_NAME_RE.sub("_", str(k))}="{_prom_label_value(v)}"'
        for k, v in sorted(merged.items())
    )
    return "{" + body + "}"


def _prom_num(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def prometheus_text(registry=None) -> str:
    """Render the registry in Prometheus text exposition format 0.0.4."""
    from repro_torch import obs

    registry = registry if registry is not None else obs.REGISTRY
    by_family: dict[str, list] = {}
    for m in registry.metrics():
        by_family.setdefault(m.name, []).append(m)
    lines: list[str] = []
    for name in sorted(by_family):
        series = by_family[name]
        kind = series[0].kind
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} {kind}")
        for m in series:
            if kind == "histogram":
                counts, total, count = m.value
                cum = 0
                for ub, c in zip(m.buckets, counts):
                    cum += c
                    lines.append(
                        f"{pname}_bucket"
                        f"{_prom_labels(m.labels, {'le': repr(float(ub))})}"
                        f" {cum}"
                    )
                cum += counts[-1]
                lines.append(
                    f"{pname}_bucket{_prom_labels(m.labels, {'le': '+Inf'})}"
                    f" {cum}"
                )
                lines.append(
                    f"{pname}_sum{_prom_labels(m.labels)} {_prom_num(total)}"
                )
                lines.append(
                    f"{pname}_count{_prom_labels(m.labels)} {count}"
                )
            else:
                lines.append(
                    f"{pname}{_prom_labels(m.labels)} {_prom_num(m.value)}"
                )
    agg = registry.span_aggregates()
    if agg:
        lines.append("# TYPE szx_span_count counter")
        for name in sorted(agg):
            lines.append(
                f"szx_span_count{_prom_labels({'name': name})} {agg[name][0]}"
            )
        lines.append("# TYPE szx_span_seconds_total counter")
        for name in sorted(agg):
            lines.append(
                f"szx_span_seconds_total{_prom_labels({'name': name})}"
                f" {_prom_num(agg[name][1] * 1e-9)}"
            )
    return "\n".join(lines) + "\n"


def chrome_trace(registry=None) -> dict:
    """Span log as a Chrome ``trace_event`` document (complete 'X' events).

    Load the JSON in chrome://tracing or https://ui.perfetto.dev -- nesting
    renders from per-thread timestamp containment, which the span stack
    guarantees.  Timestamps are ``perf_counter_ns``-based microseconds
    (monotonic within the process; absolute epoch is meaningless).
    """
    from repro_torch import obs

    registry = registry if registry is not None else obs.REGISTRY
    pid = os.getpid()
    events = []
    for name, t0_ns, dur_ns, tid, depth, attrs in registry.spans():
        ev = {
            "name": name, "cat": "szx", "ph": "X",
            "ts": t0_ns / 1e3, "dur": dur_ns / 1e3,
            "pid": pid, "tid": tid,
        }
        args = {"depth": depth}
        if attrs:
            args.update(attrs)
        ev["args"] = args
        events.append(ev)
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, registry=None) -> str:
    """Serialize :func:`chrome_trace` to ``path``; returns the path."""
    doc = chrome_trace(registry)
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
    return str(path)


def _fmt_table(rows: list[list[str]], header: list[str]) -> list[str]:
    widths = [
        max(len(str(r[i])) for r in [header, *rows])
        for i in range(len(header))
    ]
    def fmt(r):
        return "  ".join(str(c).ljust(w) for c, w in zip(r, widths)).rstrip()
    out = [fmt(header), fmt(["-" * w for w in widths])]
    out.extend(fmt(r) for r in rows)
    return out


def summary(registry=None) -> str:
    """Human-readable aggregate table: spans, counters/gauges, histograms."""
    from repro_torch import obs

    registry = registry if registry is not None else obs.REGISTRY
    sections: list[str] = []
    agg = registry.span_aggregates()
    if agg:
        rows = [
            [name, c, f"{t * 1e-9:.4f}", f"{t / c * 1e-6:.3f}"]
            for name, (c, t) in sorted(agg.items())
        ]
        sections.append("spans")
        sections.extend(_fmt_table(rows, ["span", "count", "total_s",
                                          "mean_ms"]))
    scalars, hists = [], []
    for m in registry.metrics():
        lbl = ",".join(f"{k}={v}" for k, v in sorted(m.labels.items()))
        label = f"{m.name}{{{lbl}}}" if lbl else m.name
        if m.kind == "histogram":
            _, total, count = m.value
            mean = total / count if count else 0.0
            hists.append([label, count, f"{total:.4f}", f"{mean * 1e3:.3f}"])
        else:
            v = m.value
            scalars.append([label, m.kind,
                            f"{v:.6g}" if isinstance(v, float) else v])
    if scalars:
        if sections:
            sections.append("")
        sections.append("metrics")
        sections.extend(_fmt_table(sorted(scalars), ["metric", "kind",
                                                     "value"]))
    if hists:
        sections.append("")
        sections.append("histograms")
        sections.extend(_fmt_table(sorted(hists), ["histogram", "count",
                                                   "sum_s", "mean_ms"]))
    if not sections:
        return "(no telemetry recorded)\n"
    return "\n".join(sections) + "\n"
