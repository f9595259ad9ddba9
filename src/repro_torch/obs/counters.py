"""Host manager of the engine's counter state (port of
``repro.obs.counters``).

The engine owns a device buffer (``obs.runtime.init_counters``) that
data-dependent contributions are added to in place, and a host half
(``init_host_counters``) for the values the host already knows. Both
are MONOTONIC, so a drain needs no reset: it is one device-to-host copy
of the device buffer (its two flat tensors concatenated bit for bit),
added to the host half. It runs on a burst cadence
(``ObsConfig.drain_every``) and once at run end, and it is the ONLY
device-to-host transfer the metrics layer makes.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.obs.runtime import COUNTERS, unpack_counters


class DeviceCounters:
    """Drain-side view of the engine's counter state."""

    def __init__(self) -> None:
        self._snap: Optional[Dict[str, np.ndarray]] = None
        self.n_drains = 0
        self.drain_s = 0.0          # wall time spent draining (the metrics
        #                             layer's entire host-sync cost)

    def drain(self, dev_ctr: Dict, host_ctr: Optional[Dict] = None
              ) -> Dict[str, np.ndarray]:
        """Fetch the cumulative counters: the device buffer in one copy
        (the fp32 half travels as its int32 bits), plus ``host_ctr``."""
        if not dev_ctr:
            return {}
        t0 = time.perf_counter()
        i32, f32 = dev_ctr["i32"], dev_ctr["f32"]
        # on the drain_every cadence and at run end
        # rpr-ok: RPR008 the drain: the metrics layer's one host read
        raw = torch.cat([i32, f32.view(torch.int32)]).cpu().numpy()
        self.drain_s += time.perf_counter() - t0
        self.n_drains += 1
        ni = i32.numel()
        host = {"i32": raw[:ni].astype(np.int64),
                "f32": raw[ni:].view(np.float32).astype(np.float64)}
        if host_ctr:
            host = {k: v + host_ctr[k] for k, v in host.items()}
        self._snap = unpack_counters(host)
        return self._snap

    def totals(self) -> Dict[str, object]:
        """Last drained snapshot as python scalars / int lists."""
        if self._snap is None:
            return {}
        out: Dict[str, object] = {}
        for name, v in self._snap.items():
            exact = COUNTERS[name].kind == "i32"
            if v.ndim:
                out[name] = [int(x) if exact else float(x) for x in v]
            else:
                out[name] = int(v) if exact else float(v)
        return out

    def rates(self) -> Dict[str, float]:
        """Derived ratios (clip rates, mean tokens/burst) from totals."""
        t = self.totals()
        out: Dict[str, float] = {}

        def ratio(num, den):
            d = t.get(den) or 0
            return float(t.get(num, 0)) / d if d else 0.0

        if t:
            out["act_clip_rate"] = ratio("act_sat", "act_elems")
            out["fq_clip_rate"] = ratio("fq_clip", "fq_elems")
            out["tokens_per_burst"] = ratio("decode_tokens", "decode_bursts")
            out["paged_tokens_per_call"] = ratio("paged_tokens_read",
                                                 "paged_calls")
        return out
