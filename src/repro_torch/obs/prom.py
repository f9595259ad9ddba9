"""Prometheus-style text exposition + a minimal scrape endpoint (port of
``repro.obs.prom``: the same text, byte for byte, metric prefix included).

``render`` turns a flat ``{name: value}`` sample dict into the text
format (`# HELP` / `# TYPE` / sample lines); ``parse`` inverts it for
the CI smoke validation.  ``MetricsServer`` is an optional stdlib
``http.server`` thread serving ``/metrics`` from a callback — no
third-party client library, which is the point: the container installs
nothing.
"""
from __future__ import annotations

import http.server
import json
import math
import threading
from typing import Callable, Dict, List, Mapping, Optional, Tuple

PREFIX = "repro_"


def _sanitize(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    return s if not s or not s[0].isdigit() else "_" + s


def render(samples: Mapping[str, object],
           help_text: Optional[Mapping[str, str]] = None,
           prefix: str = PREFIX) -> str:
    """Flat samples -> Prometheus text format.

    Values may be int/float/bool/None (None is skipped) or a list, which
    expands into one sample per index with a ``bucket`` label (the burst
    histogram).
    """
    help_text = help_text or {}
    lines: List[str] = []
    for name in sorted(samples):
        value = samples[name]
        if value is None:
            continue
        metric = prefix + _sanitize(name)
        h = help_text.get(name)
        if h:
            lines.append(f"# HELP {metric} {h}")
        lines.append(f"# TYPE {metric} gauge")
        if isinstance(value, (list, tuple)):
            for i, v in enumerate(value):
                lines.append(f'{metric}{{bucket="{i}"}} {_fmt(v)}')
        else:
            lines.append(f"{metric} {_fmt(value)}")
    return "\n".join(lines) + "\n"


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def parse(text: str) -> Dict[Tuple[str, str], float]:
    """Inverse of :func:`render`: ``{(metric, labels): value}``.

    Strict enough for the CI smoke check — every non-comment line must
    split into ``name[{labels}] value`` with a float value.
    """
    out: Dict[Tuple[str, str], float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        if not head:
            raise ValueError(f"line {lineno}: no metric name: {line!r}")
        labels = ""
        if "{" in head:
            head, _, rest = head.partition("{")
            labels = rest.rstrip("}")
        out[(head, labels)] = float(val)
    return out


def write_snapshot(path: str, samples: Mapping[str, object],
                   help_text: Optional[Mapping[str, str]] = None) -> None:
    """Write the text exposition (and a sibling ``.json`` dump)."""
    with open(path, "w") as f:
        f.write(render(samples, help_text))
    with open(path + ".json", "w") as f:
        json.dump({k: v for k, v in samples.items()}, f, indent=2,
                  default=float)


class MetricsServer:
    """Background ``/metrics`` endpoint over a snapshot callback."""

    def __init__(self, port: int, snapshot: Callable[[], Mapping[str, object]]):
        self._snapshot = snapshot
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):               # noqa: N802 (stdlib API name)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = render(outer._snapshot()).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):      # silence per-request stderr
                pass

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                                      Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)
