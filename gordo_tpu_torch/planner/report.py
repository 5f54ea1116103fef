"""
The text table of ``gordo-tpu plan``, a copy of
``gordo_tpu/planner/report.py``: a row a bucket (what runs, how big, what
it costs, how much of it is padding) and the totals (``--as-json``
prints the plan's document instead).
"""

from typing import List

from .plan import FleetPlan


def _fmt_bytes(n: int) -> str:
    """
    >>> _fmt_bytes(512), _fmt_bytes(3 << 20)
    ('512B', '3.0MiB')
    """
    value = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if value < 1024.0 or unit == "GiB":
            return f"{value:.1f}{unit}" if unit != "B" else f"{int(value)}B"
        value /= 1024.0
    return f"{value:.1f}GiB"


def _fmt_seconds(s: float) -> str:
    return f"{s * 1000:.0f}ms" if s < 1.0 else f"{s:.1f}s"


def render_plan(plan: FleetPlan) -> str:
    """The plan as an aligned text table and a totals footer."""
    headers = ("bucket", "program", "members", "shape", "waste", "compile", "run", "hbm")
    rows: List[tuple] = []
    for bucket in plan.buckets:
        predicted = bucket.get("predicted") or {}
        rows.append((
            str(bucket["id"]),
            str(bucket["program"]),
            str(len(bucket["members"])),
            "x".join(str(d) for d in predicted.get("stacked_shape") or []),
            f"{100.0 * float(predicted.get('padding_waste', 0.0)):.1f}%",
            _fmt_seconds(float(predicted.get("compile_s", 0.0))) if predicted.get("compiles") else "cached",
            _fmt_seconds(float(predicted.get("run_s", 0.0))),
            _fmt_bytes(int(predicted.get("hbm_bytes", 0))),
        ))
    widths = [max(len(headers[i]), *(len(r[i]) for r in rows)) if rows else len(headers[i])
              for i in range(len(headers))]
    lines = [
        "  ".join(h.ljust(widths[i]) for i, h in enumerate(headers)).rstrip(),
        "  ".join("-" * widths[i] for i in range(len(headers))),
    ]
    for row in rows:
        lines.append("  ".join(cell.ljust(widths[i]) for i, cell in enumerate(row)).rstrip())
    totals = plan.totals
    lines.append("")
    lines.append(
        f"strategy={plan.strategy}  buckets={totals.get('buckets', 0)}  members={totals.get('members', 0)}  "
        f"compiles={totals.get('compiles', 0)}  "
        f"padding_waste={100.0 * float(totals.get('padding_waste', 0.0)):.1f}%"
    )
    lines.append(
        f"predicted: compile {_fmt_seconds(float(totals.get('predicted_compile_s', 0.0)))} + run "
        f"{_fmt_seconds(float(totals.get('predicted_run_s', 0.0)))} = "
        f"{_fmt_seconds(float(totals.get('predicted_wall_s', 0.0)))}  "
        f"(hbm peak {_fmt_bytes(int(totals.get('hbm_peak_bytes', 0)))}, plan {plan.plan_hash})"
    )
    return "\n".join(lines)
