"""Runtime observability of the port: for now only the Prometheus text
exposition that `streaming.RankServer.metrics_text` renders (the JAX
package's runtime/observe.py:371, copied).

The observer itself (`ShardObserver`, the event trace, `attribute_frontier`
and the push-inflation attribution of the asynchronous host transports)
waits for ROADMAP Queue 1 item 7, with those transports.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple


def render_prometheus(families: Sequence[Tuple[str, str, object]],
                      prefix: str = "repro") -> str:
    """Render `(name, type, value)` families in the Prometheus text
    format.  `value` is a scalar, or a dict of `labels-dict -> scalar`
    (labels rendered sorted, values escaped), e.g.::

        render_prometheus([
            ("queries_served", "counter", 12),
            ("shard_pushes", "counter",
             {(("shard", "0"),): 41, (("shard", "1"),): 7}),
        ])
    """
    def fmt(v) -> str:
        f = float(v)
        if f == int(f) and abs(f) < 1e15:
            return str(int(f))
        return repr(f)

    lines: List[str] = []
    for name, typ, value in families:
        full = "%s_%s" % (prefix, name) if prefix else name
        lines.append("# TYPE %s %s" % (full, typ))
        if isinstance(value, dict):
            for labels, v in value.items():
                lab = ",".join(
                    '%s="%s"' % (k, str(lv).replace("\\", r"\\")
                                 .replace('"', r'\"').replace("\n", r"\n"))
                    for k, lv in labels)
                lines.append("%s{%s} %s" % (full, lab, fmt(v)))
        else:
            lines.append("%s %s" % (full, fmt(value)))
    return "\n".join(lines) + "\n"
