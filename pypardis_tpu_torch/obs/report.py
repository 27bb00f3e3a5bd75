"""The schema'd run report and its one-screen rendering (counterpart
of ``pypardis_tpu/obs/report.py``).

``DBSCAN.report()`` returns :func:`build_run_report`'s dict.  The schema
string is the JAX package's, ``pypardis_tpu/run_report@1``, and so are
the keys, so the JAX-side readers take the port's reports: a
``resources`` section (peak host RSS, device live bytes and staging-pool
watermarks, finite on every route), and on a report rebuilt by
:func:`pypardis_tpu_torch.obs.flight.replay` from a flight file the
``partial`` and ``flight`` blocks.
"""

from __future__ import annotations

from typing import Dict, Optional

import os

from .recorder import RunRecorder
from .registry import _py

REPORT_SCHEMA = "pypardis_tpu/run_report@1"

# metrics_ keys that describe the shard layout and merge rather than
# timing: they group under report["sharding"].  The list is the JAX
# package's; the keys of routes the port lacks yet (global-Morton, the
# ring, streaming input) stay, so its reports and the JAX ones group
# alike.
_SHARDING_KEYS = (
    "halo_factor",
    "pad_waste",
    "owned_cap",
    "halo_cap",
    "n_shard_partitions",
    "n_partitions",
    "merge",
    "merge_rounds",
    "merge_converged",
    "halo_exchange",
    "halo_bytes",
    "input",
    "owner_computes",
    "duplicated_work_factor",
    "staged_bytes_reused",
    "staged_bytes",
    "overlap_efficiency",
    "partition_levels_s",
    "partition_builder",
    "mode",
    "boundary_tiles",
    "boundary_rows",
    "boundary_tile_bytes",
    "boundary_tile_caps",
    "sent_tiles",
    "sent_tiles_box",
    "boundary_bytes_box",
    "ring_rounds",
    "fixpoint_rounds",
    "stream_buckets",
    "stream_max_bucket_rows",
    "stream_sample_rows",
    "spill_bytes",
    "chained",
)

# Model-FLOP peak per card for the MFU denominator, matched by
# substring against torch.cuda.get_device_name().  The H100's is the
# dense bf16 tensor-core peak of the H100 SXM data sheet (989 TFLOP/s,
# the figure PERF.md's kernel bounds take): the kernels' "high" mode
# decides pairs on bf16 tensor cores with an exact fallback, so MFU
# against it is a consistent, comparable figure, not a claim of
# executed work.  PPTORCH_PEAK_FLOPS=<flops/sec> overrides it.
_PEAK_FLOPS_TABLE = (
    ("h100", 989e12),
)
# No table entry (a CPU fit, another card): a nominal 1 TFLOP/s keeps
# mfu finite and comparable across runs without claiming the host's
# peak; peak_source says which case applied.
_PEAK_FLOPS_DEFAULT = 1e12


def _peak_flops(backend=None):
    """(peak_flops, source): ``PPTORCH_PEAK_FLOPS`` (``"env"``), else
    the table row of the current CUDA card when ``backend`` is
    ``"cuda"`` (``"table:<row>"``), else the default (``"default"``)."""
    env = os.environ.get("PPTORCH_PEAK_FLOPS")
    if env:
        return float(env), "env"
    kind = ""
    if backend == "cuda":
        try:
            import torch

            kind = torch.cuda.get_device_name().lower()
        except Exception:  # noqa: BLE001 — reporting must never raise
            kind = ""
    for sub, peak in _PEAK_FLOPS_TABLE:
        if sub in kind:
            return peak, f"table:{sub}"
    return _PEAK_FLOPS_DEFAULT, "default"


def _compute_section(
    metrics: Dict, phases: Dict, n_dims: int, precision=None, backend=None
) -> Dict:
    """Achieved-FLOP/s and MFU from the kernels' in-band pair stats,
    with the JAX package's work model.

    Every live (row, col) tile pair costs ``block^2`` point pairs, each
    ``2 * (d + 2)`` flops under the matmul distance decomposition, and
    every pass walks the same live-pair list, so model FLOPs = ``pairs
    * block^2 * (d+2) * 2 * passes``.  This is a model count, not the
    work the card executed: it counts every pair of every live tile in
    every pass, including what B2's label-bound skip never computes
    (PERF.md §6 has the executed work).  So on the card
    ``achieved_flops_per_sec`` (model FLOPs over the cluster phase's
    wall seconds) and ``mfu`` (that over the card's peak, see
    :func:`_peak_flops`; ``mfu_f32_synth`` over a third of it) are
    model figures.  On the chained route ``pairs`` is the binding
    partition's total.  Every field is always present and finite: 0.0
    means the fit carried no pair telemetry.

    Band fields (zero off ``"mixed"`` and the sketch): ``band_pairs``
    counts pairs whose fast-pass d^2 fell in the rescore band on the
    counts pass, ``band_fraction`` is that over one pass's pairs
    examined (live tile visits x block^2), ``rescored_pairs`` the
    rescored tile visits x block^2 and ``rescored_visit_fraction`` their
    per-visit rate.
    """
    pairs = int(metrics.get("live_pairs", 0) or 0)
    block = int(metrics.get("kernel_block", 0) or 0)
    passes = int(metrics.get("kernel_passes", 0) or 0)
    band_pairs = int(metrics.get("band_pairs", 0) or 0)
    rescored_tiles = int(metrics.get("rescored_tiles", 0) or 0)
    tiles = int(metrics.get("kernel_tiles", 0) or 0)
    try:
        overlap_eff = float(
            metrics.get("exchange_overlap_efficiency", 0.0) or 0.0
        )
    except (TypeError, ValueError):
        overlap_eff = 0.0
    if overlap_eff != overlap_eff or overlap_eff in (
        float("inf"), float("-inf")
    ):
        overlap_eff = 0.0
    cluster_s = float(phases.get("cluster", 0.0) or 0.0)
    flops = float(pairs) * block * block * (n_dims + 2) * 2.0 * passes
    achieved = flops / cluster_s if cluster_s > 0 else 0.0
    peak, source = _peak_flops(backend)
    # Band stats are per-pass (counts-pass measurement), so the
    # fraction denominators are one pass's visits, not passes x pairs.
    visits = float(pairs)
    try:
        from ..ops.precision import norm_precision_mode

        mode = norm_precision_mode(
            "high" if precision is None else precision
        )
    except ValueError:
        mode = str(precision)
    return {
        "live_pairs": pairs,
        "kernel_block": block,
        "kernel_passes": passes,
        # The fraction of the dense T^2 tile grid the extraction kept,
        # and the share of boundary-ring seconds hidden behind the
        # counts pass (the global-Morton mesh route's; 0.0 in the
        # port, which has none yet).  Always present and finite.
        "live_pair_fraction": (
            round(min(pairs / float(tiles * tiles), 1.0), 8)
            if tiles > 0 else 0.0
        ),
        "kernel_tiles": tiles,
        "exchange_overlap_efficiency": round(overlap_eff, 6),
        "model_flops": flops,
        "achieved_flops_per_sec": round(achieved, 1),
        "peak_flops": peak,
        "peak_source": source,
        "mfu": round(achieved / peak, 8) if peak > 0 else 0.0,
        "mfu_f32_synth": (
            round(achieved / (peak / 3.0), 8) if peak > 0 else 0.0
        ),
        "precision_mode": mode,
        # Resolved sketch-prefilter width of the fit's kernel passes
        # (0 = off).  With sketch on, band_pairs/band_fraction below
        # count the SKETCH gate's ambiguous pairs (the stats columns
        # are shared with mixed precision — ops.sketch).
        "sketch_k": int(metrics.get("sketch_k", 0) or 0),
        "band_pairs": band_pairs,
        "rescored_pairs": rescored_tiles * block * block,
        "band_fraction": (
            round(band_pairs / (visits * block * block), 8)
            if visits * block > 0 else 0.0
        ),
        "rescored_visit_fraction": (
            round(rescored_tiles / visits, 8) if visits > 0 else 0.0
        ),
    }


def _clean(v):
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    if getattr(v, "ndim", 0):  # ndarray — scalars fall through to _py
        return _clean(v.tolist())
    v = _py(v)
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    return str(v)  # callables (metric=...), and anything else exotic


def build_run_report(
    recorder: Optional[RunRecorder],
    *,
    params: Dict,
    n_points: int,
    n_dims: int,
    n_devices: int,
    backend: str,
    metrics: Dict,
    serving: Optional[Dict] = None,
    live: Optional[Dict] = None,
) -> Dict:
    """Assemble the stable report dict from a fit's recorder + metrics.

    ``metrics`` is the model's ``metrics_`` (PhaseTimer ``*_s`` keys +
    the sharded path's stats); the recorder contributes event counts and
    the registry dump.  Every value is a plain Python scalar/list/dict —
    the whole report is json-serializable by construction.
    """
    metrics = {k: _clean(v) for k, v in metrics.items()}

    phases = {
        k[:-2]: round(float(v), 6)
        for k, v in metrics.items()
        if k.endswith("_s") and k != "total_s"
        and isinstance(v, (int, float))
    }

    sharding = {k: metrics[k] for k in _SHARDING_KEYS if k in metrics}
    sharding.setdefault("halo_factor", 0.0)
    sharding.setdefault("pad_waste", 0.0)
    sharding.setdefault("n_partitions", int(metrics.get("n_partitions", 1)))
    # Always present: a single-partition fit clusters each point once
    # (factor 1.0), stages nothing reusable, runs no chained overlap
    # loop (efficiency 0.0) and builds no KD tree (no level timings).
    sharding.setdefault("duplicated_work_factor", 1.0)
    sharding.setdefault("staged_bytes_reused", 0)
    sharding.setdefault("overlap_efficiency", 0.0)
    sharding.setdefault("partition_levels_s", [])
    # False means the fit ran the duplicate-and-recluster step (the
    # chained route) or no partitioned step at all, never "unknown".
    sharding.setdefault("owner_computes", False)

    psizes = metrics.get("partition_sizes")
    devices: Dict = {
        "count": int(n_devices),
        # Controller processes the fit spanned: 1 until the port's
        # multi-process layer (ROADMAP A10).
        "processes": 1,
    }
    if psizes is not None:
        if n_devices > 0 and len(psizes) % n_devices == 0:
            per_dev = len(psizes) // n_devices
            grouped = [
                psizes[d * per_dev:(d + 1) * per_dev]
                for d in range(n_devices)
            ]
        else:
            grouped = [psizes]
        devices["partition_sizes"] = grouped
        devices["points"] = metrics.get(
            "device_points", [sum(g) for g in grouped]
        )
    else:
        # Single-shard fit: everything on one device.
        devices["partition_sizes"] = [[int(n_points)]]
        devices["points"] = [int(n_points)]

    # Resource watermarks (obs.resources.ResourceSampler gauges):
    # always present and finite; 0 means the sampler never ran (an
    # empty fit), never NaN.
    res_g = (
        recorder.metrics.gauges_with_prefix("resources.")
        if recorder is not None
        else {}
    )

    def _res(key):
        try:
            v = float(res_g.get(f"resources.{key}", 0) or 0)
        except (TypeError, ValueError):
            return 0
        return int(v) if v == v and abs(v) != float("inf") else 0

    resources = {
        "peak_host_rss_bytes": _res("peak_host_rss_bytes"),
        "peak_device_bytes": _res("peak_device_bytes"),
        "staging_pool_bytes": _res("staging_pool_bytes"),
        "samples": _res("samples"),
    }

    ev = recorder.event_counts() if recorder is not None else {}
    events = {
        "restage": ev.get("retry.restage", 0),
        "transient_retry": sum(
            v for k, v in ev.items() if k.startswith("retry.")
        ),
        "pair_overflow": ev.get("pair_overflow", 0),
        "halo_overflow": ev.get("halo_overflow", 0),
        "merge_unconverged": ev.get("merge_unconverged", 0),
        "compile": ev.get("compile", 0),
        "fault_injected": ev.get("fault_injected", 0),
        "degraded": ev.get("degraded", 0),
    }

    # Fault-tolerance block, always present: injected faults, retries
    # spent and abandoned (the retry.<site> counters summed) and the
    # degradation rung a terminal failure landed on ("" when none),
    # written by utils/faults, utils/retry and the budget ladders.
    ctr = (
        recorder.metrics.counters_with_prefix("")
        if recorder is not None else {}
    )
    faults_block = {
        "injected": int(ctr.get("faults.injected", 0)),
        "retried": int(sum(
            v for k, v in ctr.items()
            if k.startswith("retry.") and k.endswith(".attempts")
        )),
        "giveups": int(sum(
            v for k, v in ctr.items()
            if k.startswith("retry.") and k.endswith(".giveups")
        )),
        "degraded": int(ctr.get("faults.degraded", 0)),
        "degraded_to": str(
            recorder.metrics.gauge("faults.degraded_to", "")
            if recorder is not None else ""
        ),
    }

    # Host-stepped propagation breakdown (the stepped.* gauges of
    # ops/pipeline._cluster_stepped): present only when a fit stepped.
    stepped = (
        {
            k[len("stepped."):]: v
            for k, v in recorder.metrics.gauges_with_prefix(
                "stepped."
            ).items()
        }
        if recorder is not None
        else {}
    )

    report = {
        "schema": REPORT_SCHEMA,
        "params": _clean(params),
        "run": {
            "n_points": int(n_points),
            "n_dims": int(n_dims),
            "n_devices": int(n_devices),
            "backend": str(backend),
            "total_s": round(float(metrics.get("total_s", 0.0)), 6),
            "points_per_sec": round(
                float(metrics.get("points_per_sec", 0.0)), 1
            ),
        },
        "phases": phases,
        "sharding": sharding,
        "compute": _compute_section(
            metrics, phases, n_dims, precision=params.get("precision"),
            backend=backend,
        ),
        "resources": resources,
        "devices": devices,
        "events": events,
        "faults": faults_block,
        "metrics": (
            recorder.metrics.as_dict()
            if recorder is not None
            else {"counters": {}, "gauges": {}, "timings": {},
                  "hists": {}}
        ),
    }
    if stepped:
        report["stepped"] = stepped
    # Serving-engine gauges (QPS, batch fill, latency percentiles):
    # present once the model's query engine has answered queries.
    if serving:
        report["serving"] = serving
    # Live-update gauges (serve.live): present once the model has a
    # LiveModel attached: insert/delete volumes, the re-cluster blast
    # radius, the index's epoch and delta bytes, update latencies.
    if live:
        report["live"] = live
    # Live-export destinations (attach_exporters leaves its gauges in
    # the registry): where the run's metrics were scraped or written.
    # Absent on runs with no exporter attached.
    export: Dict = {}
    if recorder is not None:
        http_port = recorder.metrics.gauge("metrics.http_port")
        snap_path = recorder.metrics.gauge("metrics.snapshot_path")
        if http_port is not None:
            export["http_port"] = int(http_port)
        if snap_path:
            export["snapshot_path"] = str(snap_path)
    if export:
        report["export"] = export
    return _clean(report)


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GB"


def format_summary(report: Dict) -> str:
    """Render a report as the one-screen run summary: the JAX package's
    text for the same report, line for line."""
    run, sh, ev = report["run"], report["sharding"], report["events"]
    lines = [
        f"pypardis_tpu run — {run['n_points']:,} pts x {run['n_dims']}D "
        f"on {run['n_devices']} {run['backend']} device(s)",
        f"  total {run['total_s']:.3f}s "
        f"({run['points_per_sec']:,.0f} pts/s)",
    ]
    if report["phases"]:
        lines.append(
            "  phases: "
            + " | ".join(
                f"{k} {v:.3f}s" for k, v in sorted(report["phases"].items())
            )
        )
    parts = sh.get("n_shard_partitions", sh.get("n_partitions", 1))
    shard_bits = [
        f"{parts} partition(s)",
        f"halo_factor {sh['halo_factor']:.3f}",
        f"pad_waste {sh['pad_waste']:.3f}",
        f"dup_work {sh['duplicated_work_factor']:.2f}x",
    ]
    if sh.get("input") == "stream":
        bits = f"stream ({sh.get('stream_buckets', '?')} buckets)"
        if sh.get("chained"):
            bits += " chained"
        shard_bits.append(bits)
    if sh.get("mode") == "global_morton":
        shard_bits.append(
            f"boundary {sh.get('boundary_tiles', 0)} tiles "
            f"({_fmt_bytes(sh.get('boundary_tile_bytes', 0))}, "
            f"{sh.get('fixpoint_rounds', 0)} fixpoint round(s))"
        )
        xov = report.get("compute", {}).get(
            "exchange_overlap_efficiency", 0
        )
        if xov:
            shard_bits.append(f"ring {xov:.0%} hidden behind counts")
        # Ring-traffic counters of the JAX global-Morton route (the
        # summary renders any report of either package alike).
        ctr = report.get("metrics", {}).get("counters", {})
        sent = ctr.get("gm.ring_bytes_sent", 0)
        if sent:
            shard_bits.append(
                f"ring {_fmt_bytes(sent)} sent / "
                f"{int(ctr.get('gm.ring_tiles_kept', 0))} tiles kept"
            )
    elif "halo_bytes" in sh:
        shard_bits.append(f"halo {_fmt_bytes(sh['halo_bytes'])}")
    if "merge" in sh:
        m = f"merge={sh['merge']}"
        if "merge_rounds" in sh:
            m += f" ({sh['merge_rounds']} rounds)"
        shard_bits.append(m)
    if sh.get("owner_computes"):
        shard_bits.append("owner-computes")
    if sh.get("staged_bytes_reused", 0) > 0:
        shard_bits.append(
            f"staged_reuse {_fmt_bytes(sh['staged_bytes_reused'])}"
        )
    if sh.get("overlap_efficiency", 0) > 0:
        shard_bits.append(f"overlap {sh['overlap_efficiency']:.0%}")
    lines.append("  sharding: " + ", ".join(shard_bits))
    levels = sh.get("partition_levels_s") or []
    if levels:
        lines.append(
            "  partition levels: "
            + " | ".join(f"{t:.3f}s" for t in levels)
            + (f" ({sh.get('partition_builder')})"
               if sh.get("partition_builder") else "")
        )
    st = report.get("stepped")
    if st:
        lines.append(
            "  stepped: "
            f"prepare {st.get('prepare_s', 0):.3f}s | "
            f"rounds {st.get('rounds_s', 0):.3f}s "
            f"({st.get('batches', 0)} x {st.get('batch_size', 0)}"
            f"{', speculative' if st.get('speculate') else ''}) | "
            f"border {st.get('border_s', 0):.3f}s | "
            f"pack {st.get('pack_s', 0):.3f}s"
        )
    comp = report.get("compute", {})
    if comp.get("live_pairs", 0) > 0:
        mixed_bit = ""
        if comp.get("precision_mode") == "mixed":
            mixed_bit = (
                f", mixed: {comp.get('band_fraction', 0):.2%} of pairs "
                f"in-band, "
                f"{comp.get('rescored_visit_fraction', 0):.0%} of tile "
                f"visits rescored"
            )
        frac_bit = ""
        if comp.get("kernel_tiles", 0) > 0:
            frac_bit = (
                f", {comp.get('live_pair_fraction', 0.0):.2%} of tile "
                f"pairs live"
            )
        lines.append(
            f"  compute: {comp['live_pairs']:,} live pairs x "
            f"{comp['kernel_passes']} pass(es) @ block "
            f"{comp['kernel_block']}{frac_bit} -> "
            f"{comp['achieved_flops_per_sec'] / 1e9:,.1f} GFLOP/s "
            f"(mfu {comp['mfu']:.2%} of {comp['peak_flops'] / 1e12:.0f} "
            f"TFLOP/s {comp['peak_source']} peak{mixed_bit})"
        )
    srv = report.get("serving")
    if srv:
        lines.append(
            f"  serving: {srv.get('queries', 0):,} queries in "
            f"{srv.get('batches', 0)} batch(es) @ "
            f"{srv.get('qps', 0):,.0f} q/s, "
            f"p50 {srv.get('p50_ms', 0):.2f}ms "
            f"p99 {srv.get('p99_ms', 0):.2f}ms, "
            f"fill {srv.get('batch_fill', 0):.0%}, "
            f"{srv.get('n_core', 0):,} cores / "
            f"{srv.get('n_leaves', 0)} leaves "
            f"({_fmt_bytes(srv.get('index_bytes', 0))})"
        )
    lv = report.get("live")
    if lv:
        bs = lv.get("batch_sizes") or []
        batch_bit = (
            f", batch mean {sum(bs) / len(bs):.1f} rows "
            f"({lv.get('reclusters_per_write', 0):.3f} reclusters/row)"
            if bs else ""
        )
        compact_bit = (
            f", compact x{lv.get('compactions', 0)} "
            f"({lv.get('compaction_s', 0):.1f}s, "
            f"{lv.get('epoch_swaps', 0)} swap(s))"
            if lv.get("compactions", 0) else ""
        )
        lines.append(
            f"  live: {lv.get('points', 0):,} pts "
            f"({lv.get('cores', 0):,} cores), "
            f"+{lv.get('inserts', 0)}/-{lv.get('deletes', 0)} in "
            f"{lv.get('updates', 0)} update(s), "
            f"recluster x{lv.get('recluster_events', 0)} "
            f"(tile frac {lv.get('recluster_tile_fraction', 0):.2f}), "
            f"epoch {lv.get('index_epoch', 0)} "
            f"({_fmt_bytes(lv.get('index_delta_bytes', 0))} delta), "
            f"insert p50 {lv.get('insert_p50_ms', 0):.1f}ms"
            f"{batch_bit}{compact_bit}"
        )
    tn = report.get("tune")
    if tn:
        plan = tn.get("plan", {})
        cfg = plan.get("config", {})
        pred = tn.get("predicted_phases", {}) or plan.get(
            "predicted", {}
        )
        act = tn.get("actual_phases", {})
        bits = [
            "auto plan " + " ".join(
                f"{k}={cfg.get(k)}"
                for k in ("mode", "block", "precision", "merge",
                          "dispatch")
                if cfg.get(k) is not None
            )
        ]
        if pred.get("total_s") is not None:
            cmp_bit = f"predicted {pred['total_s']:.2f}s"
            if act.get("total_s"):
                cmp_bit += f" vs actual {act['total_s']:.2f}s"
            bits.append(cmp_bit)
        bits.append(
            f"{tn.get('corpus_rows', 0)} corpus row(s), probe "
            f"{tn.get('probe_s', 0.0):.3f}s"
        )
        if plan.get("fallback_reason"):
            bits.append("heuristic fallback")
        lines.append("  tune: " + ", ".join(bits))
    hr = report.get("hierarchy")
    if hr:
        bits = [
            f"{hr.get('mst_edges', 0):,} MST edges in "
            f"{hr.get('boruvka_rounds', 0)} Borůvka round(s) "
            f"(cap {hr.get('round_cap', 0)})",
            f"{hr.get('condensed_clusters', 0)} condensed / "
            f"{hr.get('selected_clusters', 0)} selected cluster(s), "
            f"stability {hr.get('stability_total', 0.0):g}",
            f"eps* {hr.get('eps_selected', 0.0):g} "
            f"(ceiling {hr.get('eps_max', 0.0):g}, "
            f"{hr.get('distance_passes', 1)} distance pass)",
        ]
        if hr.get("ladder"):
            bits.append(f"ladder x{len(hr['ladder'])}")
        lines.append("  hierarchy: " + ", ".join(bits))
    exp = report.get("export")
    if exp:
        dests = []
        if exp.get("http_port") is not None:
            dests.append(f"scrape 127.0.0.1:{exp['http_port']}/metrics")
        if exp.get("snapshot_path"):
            dests.append(f"snapshots {exp['snapshot_path']}")
        hists = report.get("metrics", {}).get("hists") or {}
        hist_bit = ""
        for key in ("serving.latency_ms", *sorted(hists)):
            h = hists.get(key)
            if h and h.get("count"):
                hist_bit = (
                    f"; {key} p50 {h.get('p50_ms', 0):.2f}ms "
                    f"p99 {h.get('p99_ms', 0):.2f}ms "
                    f"({h.get('window_count', 0)} in window)"
                )
                break
        lines.append("  live-metrics: " + ", ".join(dests) + hist_bit)
    res = report.get("resources") or {}
    if res.get("samples", 0) > 0:
        pool = res.get("staging_pool_bytes", 0)
        lines.append(
            f"  resources: host rss peak "
            f"{_fmt_bytes(res.get('peak_host_rss_bytes', 0))}, device "
            f"peak {_fmt_bytes(res.get('peak_device_bytes', 0))}"
            + (f", staging pool {_fmt_bytes(pool)}" if pool else "")
            + f" ({res['samples']} samples)"
        )
    dev_pts = report["devices"].get("points")
    if dev_pts and len(dev_pts) > 1:
        lo, hi = min(dev_pts), max(dev_pts)
        skew = hi / max(lo, 1)
        lines.append(
            f"  devices: {len(dev_pts)} x [{lo:,}..{hi:,}] pts "
            f"(skew {skew:.2f}x)"
        )
    fl = report.get("faults") or {}
    if any(fl.get(k) for k in ("injected", "retried", "giveups",
                               "degraded")):
        bits = (
            f"  faults: {fl.get('injected', 0)} injected, "
            f"{fl.get('retried', 0)} retried, "
            f"{fl.get('giveups', 0)} giveups"
        )
        if fl.get("degraded"):
            bits += f", degraded -> {fl.get('degraded_to', '?')}"
        lines.append(bits)
    lines.append(
        "  events: "
        f"{ev['restage']} restage, {ev['pair_overflow']} pair-overflow, "
        f"{ev['halo_overflow']} halo-overflow, "
        f"{ev['merge_unconverged']} merge-retry, "
        f"{ev['compile']} compile, "
        f"{ev['transient_retry']} transient-retry"
    )
    return "\n".join(lines)
