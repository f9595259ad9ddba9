"""Live FIT drift monitoring: does the served model still match its
calibration? (port of ``repro.obs.drift``)

FIT's offline promise (paper Sec. 3) is that quantization degradation
is predicted by EF traces x noise power over *calibrated* ranges.  That
prediction silently expires when serving traffic drifts off the
calibration distribution — activation ranges grow past the calibrated
min/max, clip rates climb, and the realized KL-vs-fp diverges from what
FIT scored.  This module is the online check ("A KL Lens on
Quantization", PAPERS.md: a forward-only logit-KL tap is a faithful
cheap proxy for quantization damage):

  * every ``every`` decode steps, run ONE fp-reference forward over the
    engine's live state (same tokens, same KV pages) next to the
    quantized forward, and record (a) the per-slot logit KL
    fp -> quantized, (b) per-site activation min/max against the
    calibrated ``SensitivityReport.act_ranges`` / ``kv_ranges``;
  * sites whose observed range exceeds calibration by
    ``ratio_threshold`` are flagged (grouped per layer in the report);
  * MoE models additionally get a router top-k flip gauge: the fp and
    quantized forwards' ``router_logits`` taps are compared per sample —
    the fraction of routed expert picks quantization flips is routing
    damage FIT's fixed-routing weight scores cannot see;
  * ``site_kls`` measures a per-weight-block online KL on the live
    state (quantize one block, KL against fp) — rank-correlating it
    against ``report.fit_weights({site: bits})`` is the drift demo's
    FIT-vs-reality check (``spearman >= 0.6`` on the Table-2 harness;
    see ``tests/test_obs.py``; the port holds its site KLs against the
    reference's on one state, ``tests/test_torch_obs.py``).

The sampling tap runs OUTSIDE the burst dispatch on a step cadence, so
the decode hot path stays zero-sync; its own (cadenced) host fetch — one
copy of every sampled value — is the sampling cost, not a per-burst one.

The port's decode steps write the KV caches in place, so a probe writes
the probed token's K/V at each slot's current position (within the
slot's write limit): exactly the position the next decode step writes
again before it reads it, so the served stream is unchanged.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.context import CollectContext, RecordTaps
from repro_torch.models.decode import decode_step

log = logging.getLogger("repro_torch.obs.drift")


def _logsoftmax(lg: torch.Tensor) -> torch.Tensor:
    lg = lg.to(torch.float32)
    s = lg - torch.amax(lg, dim=-1, keepdim=True)
    return s - torch.log(torch.sum(torch.exp(s), dim=-1, keepdim=True))


def _kl_rows(fp_logits: torch.Tensor, q_logits: torch.Tensor) -> torch.Tensor:
    """Per-row KL(fp || quantized) over the vocab axis."""
    lf, lq = _logsoftmax(fp_logits), _logsoftmax(q_logits)
    return torch.sum(torch.exp(lf) * (lf - lq), dim=-1)


def _replace_leaf(tree, path: str, value):
    """Functionally replace the leaf at a '/'-joined dict path."""
    keys = path.split("/")

    def rec(node, i):
        if i == len(keys):
            return value
        out = dict(node)
        out[keys[i]] = rec(node[keys[i]], i + 1)
        return out

    return rec(tree, 0)


def _get_leaf(tree, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def _routers(acts: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: a for k, a in acts.items() if k.endswith("router_logits")}


@dataclasses.dataclass
class DriftSample:
    step: int                       # cumulative decode steps at the tap
    slot: int
    kl: float                       # logit KL fp -> served for that slot
    max_ratio: float                # worst site range ratio this sample


class DriftMonitor:
    """Online FIT drift tap over a running :class:`repro_torch.serve.Engine`.

    ``fp_params`` must be the PRE-quantization parameter tree in the
    same (unrolled) layout the engine serves, on the engine's device.
    ``act_ranges`` maps tap sites (``layers/3/attn_out`` ...) to
    calibrated ``(lo, hi)`` — typically ``SensitivityReport.act_ranges``.
    """

    def __init__(self, fp_params, act_ranges: Mapping[str, Tuple[float,
                                                                 float]],
                 every: int = 64, ratio_threshold: float = 1.5,
                 report=None, calibration_scale: float = 1.0):
        self.fp_params = fp_params
        self.cal_ranges = dict(act_ranges)
        self.every = int(every)
        self.ratio_threshold = float(ratio_threshold)
        self.report = report
        # empty act_ranges: self-calibrate on the first sample, scaled by
        # ``calibration_scale`` — a scale of 1/S simulates calibration
        # that is S x stale (the drift-demo knob in launch.serve)
        self.calibration_scale = float(calibration_scale)
        self.samples: List[DriftSample] = []
        self.site_max_ratio: Dict[str, float] = {}
        # per-sample mean fraction of MoE router top-k picks the
        # quantized forward flips vs fp (empty for router-less models)
        self.router_flips: List[float] = []
        self._since = 0
        self._steps_total = 0
        self._rr = 0                    # round-robin slot cursor
        self._engine = None

    # -- engine wiring ---------------------------------------------------
    def attach(self, engine) -> "DriftMonitor":
        """Bind to an engine (also registers via ``engine.attach_drift``)."""
        if engine.cfg.family == "audio":
            raise ValueError("drift monitor reads LM logits; audio "
                             "families are not supported")
        self._engine = engine
        engine.attach_drift(self)
        return self

    @torch.no_grad()
    def _fp_probe(self, fp_params, state, tok):
        """The fp forward on the live state: (logits, per-row site
        minima and maxima, router logits)."""
        ctx = CollectContext()
        logits, _ = decode_step(fp_params, state, tok, self._engine.cfg,
                                ctx=ctx)
        lg = logits[:, 0, :self._engine.cfg.vocab_size]
        lo = {k: torch.amin(torch.clamp_max(a, 0.0).to(torch.float32),
                            dim=tuple(range(1, a.ndim)))
              for k, a in ctx.acts.items()}
        hi = {k: torch.amax(torch.clamp_min(a, 0.0).to(torch.float32),
                            dim=tuple(range(1, a.ndim)))
              for k, a in ctx.acts.items()}
        return lg, lo, hi, _routers(ctx.acts)

    @torch.no_grad()
    def _q_logits(self, state, tok):
        """The served forward: RecordTaps wraps the engine's OWN context,
        so the probe routes matmuls exactly as serving does while still
        surfacing the router_logits taps for the flip gauge."""
        eng = self._engine
        ctx = RecordTaps(eng._ctx)
        logits, _ = decode_step(eng.params, state, tok, eng.cfg, ctx=ctx)
        return logits[:, 0, :eng.cfg.vocab_size], _routers(ctx.acts)

    # -- the cadenced tap (called after each engine burst) ---------------
    def observe(self, n_steps: int) -> None:
        self._since += int(n_steps)
        self._steps_total += int(n_steps)
        if self._since < self.every or self._engine is None:
            return
        active = np.flatnonzero(self._engine._active)
        if active.size == 0:
            return
        self._since = 0
        slot = int(active[self._rr % active.size])
        self._rr += 1
        self._sample(slot)

    def _prepare_probe(self) -> None:
        """Map the next page for every active slot before probing.

        The engine grows page tables lazily at burst dispatch; between
        bursts a slot sitting on a page boundary has no mapping for its
        next write, so the probe's KV write would drop (and the probe
        would read the position without its own K/V). Growing by one
        step is exactly what the next burst would do anyway —
        reservations made at admission guarantee the pages exist.
        """
        eng = self._engine
        if getattr(eng, "_paged", False):
            eng._grow_tables(1)

    def _sample(self, slot: int) -> None:
        eng = self._engine
        self._prepare_probe()
        fl, lo, hi, fr = self._fp_probe(self.fp_params, eng._state, eng._tok)
        ql, qr = self._q_logits(eng._state, eng._tok)
        sites = list(hi)
        rsites = [s for s in fr if s in qr]
        # the cadenced sampling fetch: one copy of every value it reads
        parts = ([_kl_rows(fl, ql)[slot]] + [lo[s][slot] for s in sites]
                 + [hi[s][slot] for s in sites])
        for s in rsites:
            parts += [fr[s][slot], qr[s][slot]]
        flat = torch.cat([p.to(torch.float32).reshape(-1)
                          for p in parts]).cpu().numpy()
        kl, n = float(flat[0]), len(sites)
        lo_h = dict(zip(sites, flat[1:1 + n].tolist()))
        hi_h = dict(zip(sites, flat[1 + n:1 + 2 * n].tolist()))
        off, fr_h, qr_h = 1 + 2 * n, {}, {}
        for s in rsites:
            e = fr[s].shape[-1]
            fr_h[s], qr_h[s] = flat[off:off + e], flat[off + e:off + 2 * e]
            off += 2 * e
        self._observe_router(fr_h, qr_h)
        if not self.cal_ranges:
            c = self.calibration_scale
            self.cal_ranges = {site: (lo_h[site] * c, hi_h[site] * c)
                               for site in sites}
            log.info("drift monitor self-calibrated on %d sites "
                     "(scale %.3g)", len(self.cal_ranges), c)
        worst = 1.0
        for site, (clo, chi) in self.cal_ranges.items():
            if site not in hi_h:
                continue
            r = 1.0
            if chi > 1e-12:
                r = max(r, hi_h[site] / chi)
            if clo < -1e-12:
                r = max(r, lo_h[site] / clo)
            prev = self.site_max_ratio.get(site, 0.0)
            self.site_max_ratio[site] = max(prev, r)
            worst = max(worst, r)
        self.samples.append(DriftSample(step=self._steps_total, slot=slot,
                                        kl=kl, max_ratio=worst))
        if worst > self.ratio_threshold:
            log.warning("drift sample @%d steps: range ratio %.2f exceeds "
                        "calibration (threshold %.2f)", self._steps_total,
                        worst, self.ratio_threshold)

    def _observe_router(self, fp_routers: Mapping[str, np.ndarray],
                        q_routers: Mapping[str, np.ndarray]) -> None:
        """Top-k flip gauge: the fraction of the sampled slot's routed
        expert picks (its router rows, given here) that differ between
        the fp and quantized forwards, averaged over router sites. A
        rising flip rate means quantization is re-routing tokens —
        degradation FIT's fixed-routing weight scores cannot see."""
        if not fp_routers:
            return
        k = max(1, int(getattr(self._engine.cfg, "top_k", 1) or 1))
        flips = []
        for site, fa in fp_routers.items():
            qa = q_routers.get(site)
            if qa is None or fa.shape[-1] < k:
                continue
            f_top = set(np.argsort(fa)[-k:].tolist())
            q_top = set(np.argsort(qa)[-k:].tolist())
            flips.append(1.0 - len(f_top & q_top) / k)
        if flips:
            self.router_flips.append(float(np.mean(flips)))

    # -- per-block online KL (the FIT-vs-reality demo) -------------------
    @torch.no_grad()
    def site_kls(self, sites: Optional[Sequence[str]] = None,
                 bits: int = 4) -> Dict[str, float]:
        """Measured logit KL of quantizing ONE weight block on the live
        engine state, per site — the online counterpart of FIT's
        per-block offline score ``report.fit_weights({site: bits})``.

        Quantizes the fp reference block-at-a-time (paper min-max grid);
        the sweep costs one fp forward per site."""
        from repro_torch.quant.quantizer import QuantSpec, fake_quant_ref

        eng = self._engine
        if eng is None:
            raise RuntimeError("attach(engine) first")
        if sites is None:
            sites = sorted(self.report.weight_traces) if self.report \
                else []
        active = np.flatnonzero(eng._active)
        rows = active if active.size else np.arange(eng.ecfg.max_slots)
        self._prepare_probe()
        fl, _, _, _ = self._fp_probe(self.fp_params, eng._state, eng._tok)
        out: Dict[str, float] = {}
        for site in sites:
            try:
                leaf = _get_leaf(self.fp_params, site)
            except (KeyError, TypeError):
                continue
            if getattr(leaf, "ndim", 0) != 2:
                continue
            hybrid = _replace_leaf(
                self.fp_params, site,
                fake_quant_ref(leaf, QuantSpec(bits=bits)))
            sl, _, _, _ = self._fp_probe(hybrid, eng._state, eng._tok)
            kl = _kl_rows(fl, sl).cpu().numpy()
            out[site] = float(kl[rows].mean())
        return out

    # -- reporting -------------------------------------------------------
    def drift_report(self) -> Dict:
        """Flagged sites/layers + KL series summary."""
        flagged = sorted(s for s, r in self.site_max_ratio.items()
                         if r > self.ratio_threshold)
        layers = sorted({"/".join(s.split("/")[:2]) for s in flagged})
        kls = [s.kl for s in self.samples]
        # speculative-decoding accept-rate gauge: a dropping accept rate
        # is the live echo of draft-config drift — the FIT draft budget
        # was chosen against a KL proxy (core.fit.allocate_draft_bits),
        # and the realized accept rate is what that proxy predicted
        spec = None
        st = getattr(self._engine, "spec_stats", None) if self._engine \
            else None
        if st and st.get("dispatches"):
            spec = {
                "dispatches": int(st["dispatches"]),
                "proposed": int(st["proposed"]),
                "accepted": int(st["accepted"]),
                "accept_rate": st["accepted"] / max(st["proposed"], 1),
            }
        return {
            "spec": spec,
            "n_samples": len(self.samples),
            "every": self.every,
            "ratio_threshold": self.ratio_threshold,
            "kl_mean": float(np.mean(kls)) if kls else None,
            "kl_max": float(np.max(kls)) if kls else None,
            "router_flip_rate": (float(np.mean(self.router_flips))
                                 if self.router_flips else None),
            "router_flip_max": (float(np.max(self.router_flips))
                                if self.router_flips else None),
            "sites": {s: {"max_ratio": float(r),
                          "flagged": r > self.ratio_threshold}
                      for s, r in sorted(self.site_max_ratio.items())},
            "flagged_sites": flagged,
            "flagged_layers": layers,
            "in_calibration": not flagged,
        }
