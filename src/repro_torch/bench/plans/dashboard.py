"""Self-describing static HTML scaling dashboard (no JS, no network; port
of `repro.bench.plans.dashboard`, pure Python: the same records render
the same bytes).

One HTML file, generated from (a) the plan's completed cell records and
(b) a directory of `BENCH_*.json` reports, with every chart an inline SVG
— it renders from `file://`, inside CI artifact viewers, and over any
airgap, because there is nothing to fetch and nothing to execute.

Sections (each only when its data exists):

  scaling curves       wall vs shards / processes / grid columns, one
                       line per execution variant (the paper's strong and
                       weak scaling figures);
  plan-over-plan       each cell's fused wall across prior runs of this
                       plan (archived BENCH_plan_<name>.json reports) —
                       regression drift at a glance;
  per-phase split      stacked A / exchange / B bars per cell (Table 2);
  hidden exchange      sync-vs-pipelined exposed-exchange reduction for
                       cell pairs differing only in schedule;
  time per syn event   the paper's normalized metric per cell;
  cells table          every cell with its knobs, walls and signature;
  history              one chart per BENCH suite report (wall metrics).

Colors follow the repo dashboard palette (light + dark from the same
hues): categorical slots are assigned in fixed order — phase A / exchange
/ phase B always wear slots 1/2/3 — and series beyond the eighth fold
into a muted "other" bucket rather than inventing hues.  Values are
labeled directly in ink (never in the series color); SVG `<title>` nodes
carry the hover detail.
"""
from __future__ import annotations

import html
import json
from typing import Dict, List, Optional, Sequence, Tuple

from .reporting import PHASE_KEYS, identity_groups

# fixed categorical assignment; --sN custom properties hold both modes
_SLOTS = 8
_PHASE_SLOT = {"phase_a_s": 1, "exchange_s": 2, "phase_b_s": 3}
_PHASE_LABEL = {"phase_a_s": "phase A", "exchange_s": "exchange",
                "phase_b_s": "phase B"}

_CSS = """
.viz-root { color-scheme: light;
  --page:#f9f9f7; --surface:#fcfcfb; --ink:#0b0b0b; --ink2:#52514e;
  --muted:#898781; --grid:#e1e0d9; --axis:#c3c2b7;
  --border:rgba(11,11,11,0.10); --good:#006300;
  --s1:#2a78d6; --s2:#eb6834; --s3:#1baf7a; --s4:#eda100;
  --s5:#e87ba4; --s6:#008300; --s7:#4a3aa7; --s8:#e34948;
  background:var(--page); color:var(--ink);
  font:14px/1.5 system-ui,-apple-system,"Segoe UI",sans-serif;
  margin:0; padding:24px; }
@media (prefers-color-scheme: dark) { .viz-root { color-scheme: dark;
  --page:#0d0d0d; --surface:#1a1a19; --ink:#ffffff; --ink2:#c3c2b7;
  --muted:#898781; --grid:#2c2c2a; --axis:#383835;
  --border:rgba(255,255,255,0.10); --good:#0ca30c;
  --s1:#3987e5; --s2:#d95926; --s3:#199e70; --s4:#c98500;
  --s5:#d55181; --s6:#008300; --s7:#9085e9; --s8:#e66767; } }
.viz-root h1 { font-size:20px; margin:0 0 4px; }
.viz-root h2 { font-size:16px; margin:28px 0 8px; }
.viz-root .sub { color:var(--ink2); margin:0 0 16px; }
.viz-root figure { margin:0 0 20px; background:var(--surface);
  border:1px solid var(--border); border-radius:8px; padding:16px; }
.viz-root figcaption { color:var(--ink2); font-size:12px;
  margin-bottom:8px; }
.viz-root svg { display:block; max-width:100%; }
.viz-root svg text { font:11px system-ui,-apple-system,"Segoe UI",
  sans-serif; fill:var(--ink2); }
.viz-root svg .val { fill:var(--ink); }
.viz-root svg .tick { fill:var(--muted); }
.viz-root svg .gridline { stroke:var(--grid); stroke-width:1; }
.viz-root svg .axisline { stroke:var(--axis); stroke-width:1; }
.viz-root svg g.mark:hover { opacity:0.8; }
.viz-root .legend { display:flex; flex-wrap:wrap; gap:12px;
  font-size:12px; color:var(--ink2); margin:4px 0 8px; }
.viz-root .legend .sw { display:inline-block; width:10px; height:10px;
  border-radius:2px; margin-right:5px; vertical-align:-1px; }
.viz-root table { border-collapse:collapse; font-size:12px;
  background:var(--surface); border:1px solid var(--border);
  border-radius:8px; }
.viz-root th, .viz-root td { padding:4px 10px; text-align:left;
  border-bottom:1px solid var(--grid); }
.viz-root th { color:var(--ink2); font-weight:600; }
.viz-root td.num { font-variant-numeric:tabular-nums;
  text-align:right; }
.viz-root code { font-size:11px; }
.viz-root .ok { color:var(--good); }
.viz-root .bad { color:#d03b3b; }
"""


def _e(s) -> str:
    return html.escape(str(s), quote=True)


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) < 1e-3 or abs(v) >= 1e5:
        return f"{v:.2e}"
    return f"{v:.4g}"


def _slot(i: int) -> str:
    """Fixed-order categorical color; beyond the 8 slots, fold to muted
    (never cycle hues)."""
    return f"var(--s{i + 1})" if i < _SLOTS else "var(--muted)"


def _legend(items: Sequence[Tuple[str, str]]) -> str:
    spans = "".join(
        f'<span><span class="sw" style="background:{c}"></span>'
        f'{_e(lbl)}</span>' for lbl, c in items)
    return f'<div class="legend">{spans}</div>'


def _figure(title: str, caption: str, body: str) -> str:
    return (f"<figure><figcaption><strong>{_e(title)}</strong>"
            f"{(' — ' + _e(caption)) if caption else ''}</figcaption>"
            f"{body}</figure>")


def _xticks_grid(x0, x1, y0, y1, vmax, fmt=_fmt, n=4) -> str:
    """Vertical hairline grid + muted tick labels for a 0..vmax x-scale."""
    out = []
    for i in range(n + 1):
        v = vmax * i / n
        x = x0 + (x1 - x0) * (i / n)
        out.append(f'<line class="{"axisline" if i == 0 else "gridline"}" '
                   f'x1="{x:.1f}" y1="{y0}" x2="{x:.1f}" y2="{y1}"/>')
        out.append(f'<text class="tick" x="{x:.1f}" y="{y1 + 14}" '
                   f'text-anchor="middle">{fmt(v)}</text>')
    return "".join(out)


def hbar_chart(rows: Sequence[Tuple[str, float, str, str]],
               unit: str = "s", label_w: int = 300) -> str:
    """Horizontal bars: rows of (label, value, color, tooltip)."""
    if not rows:
        return ""
    bar_w, bar_h, gap = 340, 16, 8
    vmax = max(v for _, v, _, _ in rows) or 1.0
    h = len(rows) * (bar_h + gap) + 30
    w = label_w + bar_w + 90
    parts = [f'<svg viewBox="0 0 {w} {h}" role="img">']
    parts.append(_xticks_grid(label_w, label_w + bar_w, 0,
                              h - 24, vmax))
    y = 4
    for label, v, color, tip in rows:
        bw = bar_w * v / vmax
        parts.append(
            f'<g class="mark"><title>{_e(tip or label)}</title>'
            f'<text x="{label_w - 8}" y="{y + bar_h - 4}" '
            f'text-anchor="end">{_e(label)}</text>'
            f'<rect x="{label_w}" y="{y}" width="{max(bw, 1):.1f}" '
            f'height="{bar_h}" rx="3" fill="{color}"/>'
            f'<text class="val" x="{label_w + max(bw, 1) + 6:.1f}" '
            f'y="{y + bar_h - 4}">{_fmt(v)}{_e(unit)}</text></g>')
        y += bar_h + gap
    parts.append("</svg>")
    return "".join(parts)


def stacked_hbar_chart(rows: Sequence[Tuple[str, List[Tuple[str, float]],
                                            str]],
                       label_w: int = 300) -> str:
    """Stacked horizontal bars: (label, [(segment key, value)...], tip);
    segments wear the fixed phase slots with a 2px surface gap."""
    if not rows:
        return ""
    bar_w, bar_h, gap = 340, 16, 8
    vmax = max(sum(v for _, v in segs) for _, segs, _ in rows) or 1.0
    h = len(rows) * (bar_h + gap) + 30
    w = label_w + bar_w + 90
    parts = [f'<svg viewBox="0 0 {w} {h}" role="img">']
    parts.append(_xticks_grid(label_w, label_w + bar_w, 0, h - 24, vmax))
    y = 4
    for label, segs, tip in rows:
        total = sum(v for _, v in segs)
        parts.append(f'<g class="mark"><title>{_e(tip or label)}</title>'
                     f'<text x="{label_w - 8}" y="{y + bar_h - 4}" '
                     f'text-anchor="end">{_e(label)}</text>')
        x = float(label_w)
        for sk, v in segs:
            sw = bar_w * v / vmax
            slot = _PHASE_SLOT.get(sk, 4)
            parts.append(
                f'<rect x="{x:.1f}" y="{y}" '
                f'width="{max(sw - 2, 0.5):.1f}" height="{bar_h}" '
                f'fill="{_slot(slot - 1)}"><title>'
                f'{_e(_PHASE_LABEL.get(sk, sk))}: {_fmt(v)}s</title>'
                f'</rect>')
            x += sw
        parts.append(f'<text class="val" x="{x + 6:.1f}" '
                     f'y="{y + bar_h - 4}">{_fmt(total)}s</text></g>')
        y += bar_h + gap
    parts.append("</svg>")
    return "".join(parts)


def line_chart(series: Sequence[Tuple[str, List[Tuple[float, float]]]],
               x_label: str, y_label: str = "wall (s)") -> str:
    """Lines over a shared numeric x: (label, [(x, y)...]) per series."""
    series = [(lbl, sorted(pts)) for lbl, pts in series if pts]
    if not series:
        return ""
    W, H, ml, mr, mt, mb = 640, 280, 56, 16, 12, 40
    xs = sorted({x for _, pts in series for x, _ in pts})
    ymax = max(y for _, pts in series for _, y in pts) or 1.0
    x0, x1 = min(xs), max(xs)
    span = (x1 - x0) or 1.0

    def sx(x):
        return ml + (W - ml - mr) * (x - x0) / span

    def sy(y):
        return mt + (H - mt - mb) * (1 - y / (ymax * 1.05))

    parts = [f'<svg viewBox="0 0 {W} {H}" role="img">']
    for i in range(5):
        yv = ymax * 1.05 * i / 4
        yy = sy(yv)
        cls = "axisline" if i == 0 else "gridline"
        parts.append(f'<line class="{cls}" x1="{ml}" y1="{yy:.1f}" '
                     f'x2="{W - mr}" y2="{yy:.1f}"/>')
        parts.append(f'<text class="tick" x="{ml - 6}" y="{yy + 4:.1f}" '
                     f'text-anchor="end">{_fmt(yv)}</text>')
    for x in xs:
        parts.append(f'<text class="tick" x="{sx(x):.1f}" '
                     f'y="{H - mb + 16}" text-anchor="middle">'
                     f'{_fmt(x)}</text>')
    parts.append(f'<text class="tick" x="{(ml + W - mr) / 2:.1f}" '
                 f'y="{H - 6}" text-anchor="middle">{_e(x_label)}</text>')
    for i, (lbl, pts) in enumerate(series):
        color = _slot(i)
        path = " ".join(f"{'M' if j == 0 else 'L'}{sx(x):.1f},{sy(y):.1f}"
                        for j, (x, y) in enumerate(pts))
        parts.append(f'<g class="mark"><title>{_e(lbl)}</title>'
                     f'<path d="{path}" fill="none" stroke="{color}" '
                     f'stroke-width="2"/>')
        for x, y in pts:
            parts.append(f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" '
                         f'r="4" fill="{color}"><title>{_e(lbl)}: '
                         f'{x_label}={_fmt(x)}, {y_label}={_fmt(y)}'
                         f'</title></circle>')
        parts.append("</g>")
    parts.append("</svg>")
    return "".join(parts)


# -- plan sections -------------------------------------------------------

_LADDERS = (("shards", "total shards H", lambda c: c["shards"]),
            ("nprocs", "processes P", lambda c: c["nprocs"]),
            ("grid", "grid columns",
             lambda c: int(c["grid"].split("x")[0]) *
             int(c["grid"].split("x")[1])))


def _series_label(cell: dict, ladder: str) -> str:
    parts = []
    for a, short in (("profile", ""), ("delivery", ""), ("exchange", ""),
                     ("exchange_schedule", ""), ("placement", None),
                     ("stim", None)):
        if a == ladder:
            continue
        v = cell[a]
        if short is None:       # only when non-default (keeps labels short)
            from .schema import AXIS_DEFAULTS
            if [v] == AXIS_DEFAULTS[a]:
                continue
        parts.append(str(v))
    for a, tag in (("grid", "g"), ("shards", "H"), ("nprocs", "P")):
        if a != ladder:
            parts.append(f"{tag}{cell[a]}")
    return " ".join(parts)


def scaling_section(records: List[dict]) -> str:
    """One line chart per ladder axis that actually varies."""
    out = []
    for axis, x_label, xval in _LADDERS:
        series: Dict[str, List[Tuple[float, float]]] = {}
        for rec in records:
            res = rec["result"]
            if "wall_s" not in res:
                continue
            lbl = _series_label(rec["cell"], axis)
            series.setdefault(lbl, []).append(
                (float(xval(rec["cell"])), float(res["wall_s"])))
        series = {lbl: pts for lbl, pts in series.items()
                  if len({x for x, _ in pts}) >= 2}
        if not series:
            continue
        labels = sorted(series)
        shown = labels[:_SLOTS]
        folded = len(labels) - len(shown)
        chart = line_chart([(lbl, series[lbl]) for lbl in labels],
                           x_label=x_label)
        legend = _legend([(lbl, _slot(i)) for i, lbl in
                          enumerate(shown)] +
                         ([(f"other ({folded})", "var(--muted)")]
                          if folded else []))
        cap = (f"fused wall per cell vs {x_label}"
               + (f"; {folded} series folded into 'other'" if folded
                  else ""))
        out.append(_figure(f"Scaling over {axis}", cap, legend + chart))
    return "".join(out)


def phase_section(records: List[dict]) -> str:
    rows = []
    for rec in records:
        res = rec["result"]
        segs = [(pk, float(res[pk])) for pk in PHASE_KEYS if pk in res]
        if segs:
            rows.append((rec["key"], segs,
                         f"{rec['key']} — per-phase wall over "
                         f"{res.get('phase_steps', '?')} steps"))
    if not rows:
        return ""
    legend = _legend([(_PHASE_LABEL[pk], _slot(_PHASE_SLOT[pk] - 1))
                      for pk in PHASE_KEYS])
    return _figure("Per-phase split (A / exchange / B)",
                   "paper Table 2: computation vs communication vs "
                   "arborization, per cell",
                   legend + stacked_hbar_chart(rows))


def hidden_exchange_section(records: List[dict]) -> str:
    """Pairs differing only in exchange_schedule: how much of the sync
    exchange wall the pipelined schedule hides."""
    by_key = {}
    for rec in records:
        c, res = rec["cell"], rec["result"]
        if "exchange_s" not in res:
            continue
        base = tuple((a, c[a]) for a in sorted(c)
                     if a in ("grid", "profile", "delivery", "exchange",
                              "placement", "shards", "nprocs", "stim"))
        by_key.setdefault(base, {})[c["exchange_schedule"]] = (
            rec["key"], float(res["exchange_s"]))
    rows = []
    for base, scheds in sorted(by_key.items()):
        if "sync" in scheds and "pipelined" in scheds:
            (_, sy), (pk, pi) = scheds["sync"], scheds["pipelined"]
            hidden = (sy - pi) / sy if sy else 0.0
            label = pk.replace("_pipelined", "")
            rows.append((label, max(hidden, 0.0), _slot(1),
                         f"sync {_fmt(sy)}s vs pipelined exposed "
                         f"{_fmt(pi)}s"))
    if not rows:
        return ""
    return _figure("Hidden exchange fraction",
                   "1 - exposed/sync exchange wall for schedule pairs "
                   "(higher = more communication hidden behind phase A)",
                   hbar_chart(rows, unit=""))


def time_per_event_section(records: List[dict]) -> str:
    rows = [(rec["key"], float(rec["result"]["time_per_syn_event_s"]),
             _slot(0),
             f"{rec['key']}: {rec['result']['time_per_syn_event_s']}s "
             f"per synaptic event "
             f"({rec['result'].get('spikes')} spikes)")
            for rec in records
            if "time_per_syn_event_s" in rec["result"]]
    if not rows:
        return ""
    return _figure("Time per synaptic event",
                   "the paper's normalized metric: fused wall / "
                   "(spikes x synapses per neuron)",
                   hbar_chart(rows))


def cells_table(records: List[dict]) -> str:
    if not records:
        return ""
    head = ("<tr><th>cell</th><th>H</th><th>P</th><th>wall s</th>"
            "<th>spikes</th><th>rate Hz</th><th>raster sig</th></tr>")
    rows = []
    for rec in records:
        c, res = rec["cell"], rec["result"]
        rows.append(
            f"<tr><td><code>{_e(rec['key'])}</code></td>"
            f"<td class='num'>{c['shards']}</td>"
            f"<td class='num'>{c['nprocs']}</td>"
            f"<td class='num'>{_fmt(res.get('wall_s', 0))}</td>"
            f"<td class='num'>{res.get('spikes', '')}</td>"
            f"<td class='num'>{res.get('rate_hz', '')}</td>"
            f"<td><code>{_e(str(res.get('raster_sig', ''))[:16])}</code>"
            f"</td></tr>")
    return (f"<h2>Cells</h2><table>{head}{''.join(rows)}</table>")


def identity_section(records: List[dict]) -> str:
    groups = identity_groups(records)
    multi = {g: d for g, d in groups.items() if len(d["cells"]) > 1}
    if not multi:
        return ""
    items = []
    for g, d in sorted(multi.items()):
        cls, mark = (("ok", "identical") if d["identical"]
                     else ("bad", "DIVERGED"))
        items.append(f"<li><code>{_e(g)}</code>: {len(d['cells'])} "
                     f"layout variants — <span class='{cls}'>{mark}"
                     f"</span></li>")
    return ("<h2>Table 1 invariant</h2><p class='sub'>cells sharing "
            "physics must spike identically under every execution "
            "layout</p><ul>" + "".join(items) + "</ul>")


def plan_history_section(prior: Sequence[Tuple[str, dict]],
                         records: List[dict]) -> str:
    """Plan-over-plan: each cell's fused wall charted across prior runs
    of THIS plan (committed/archived BENCH_plan_<name>.json reports) plus
    the current store — regression drift per cell at a glance."""
    runs: List[Tuple[str, Dict[str, float]]] = []
    for label, rep in prior:
        walls = {k[:-len("_wall_s")]: float(v)
                 for k, v in rep.get("wall", {}).items()
                 if k.endswith("_wall_s") and isinstance(v, (int, float))}
        if walls:
            runs.append((label, walls))
    cur = {rec["key"]: float(rec["result"]["wall_s"])
           for rec in records if "wall_s" in rec["result"]}
    if cur:
        runs.append(("current", cur))
    if len(runs) < 2:
        return ""
    cells = sorted({c for _, walls in runs for c in walls})
    series = []
    for c in cells:
        pts = [(float(i), walls[c]) for i, (_, walls) in enumerate(runs)
               if c in walls]
        if len(pts) >= 2:
            series.append((c, pts))
    if not series:
        return ""
    shown = series[:_SLOTS]
    folded = len(series) - len(shown)
    legend = _legend([(lbl, _slot(i)) for i, (lbl, _) in
                      enumerate(shown)] +
                     ([(f"other ({folded})", "var(--muted)")]
                      if folded else []))
    run_key = "; ".join(f"{i}={lbl}" for i, (lbl, _) in enumerate(runs))
    return _figure("Wall across plan runs",
                   f"fused wall per cell over prior runs of this plan "
                   f"({run_key})",
                   legend + line_chart(series, x_label="run"))


def history_section(history: Dict[str, dict]) -> str:
    """One wall-metric chart per BENCH suite report."""
    out = []
    for name in sorted(history):
        rep = history[name]
        wall = rep.get("wall", {})
        items = sorted(wall.items())
        dropped = max(len(items) - 24, 0)
        if dropped:
            items = items[:24]
        rows = [(k, float(v), _slot(0), f"{name}.{k} = {_fmt(v)}s")
                for k, v in items if isinstance(v, (int, float))]
        env = rep.get("env", {})
        tool = "torch" if "torch" in env else "jax"
        cap = (f"{tool} {env.get(tool, '?')}, "
               f"{len(rep.get('deterministic', {}))} gated metrics"
               + (f"; first 24 of {len(wall)} wall metrics shown"
                  if dropped else ""))
        body = (hbar_chart(rows) if rows else
                "<p class='sub'>no wall metrics</p>")
        out.append(_figure(f"BENCH {name}", cap, body))
    if not out:
        return ""
    return "<h2>Committed benchmark history</h2>" + "".join(out)


def render(plan_config: dict, records: List[dict],
           history: Optional[Dict[str, dict]] = None,
           summary: Optional[dict] = None,
           prior_reports: Optional[Sequence[Tuple[str, dict]]] = None
           ) -> str:
    """Full dashboard HTML (self-contained, inline-SVG, no scripts)."""
    name = plan_config.get("name", "plan")
    n_axes = {a: len(v) for a, v in plan_config.get("axes", {}).items()
              if len(v) > 1}
    sub = (f"{len(records)} cells; swept axes: "
           f"{json.dumps(n_axes) if n_axes else 'none'}")
    if summary:
        sub += (f" — last run: {summary.get('executed', 0)} executed, "
                f"{summary.get('skipped', 0)} skipped, "
                f"{summary.get('failed', 0)} failed")
    body = [
        f"<h1>Experiment plan: {_e(name)}</h1>",
        f"<p class='sub'>{_e(sub)}</p>",
        scaling_section(records),
        plan_history_section(prior_reports or (), records),
        phase_section(records),
        hidden_exchange_section(records),
        time_per_event_section(records),
        identity_section(records),
        cells_table(records),
        history_section(history or {}),
    ]
    return ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>repro experiment plan: {_e(name)}</title>"
            f"<style>{_CSS}</style></head>"
            f"<body class='viz-root'>{''.join(body)}</body></html>")


def write(path: str, plan_config: dict, records: List[dict],
          history: Optional[Dict[str, dict]] = None,
          summary: Optional[dict] = None,
          prior_reports: Optional[Sequence[Tuple[str, dict]]] = None
          ) -> str:
    with open(path, "w") as f:
        f.write(render(plan_config, records, history=history,
                       summary=summary, prior_reports=prior_reports))
    return path
