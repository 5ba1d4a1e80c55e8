"""Shared arithmetic of the per-layer readers (no reader of its own)."""

from gillbench.trace import device_ms_by_span


def roofline_share(ctx, span, kernel_has, bound_s, keep=lambda a: True):
    """100 x the summed least time of the calls of `span` whose kernels the
    trace holds, over those kernels' summed device time; None without one."""
    spans = [s for s in ctx.get("spans", ()) if s["name"] == span
             and keep(s["attrs"])]
    ms = device_ms_by_span(ctx["red"], spans, span, kernel_has)
    if not ms:
        return None
    by = {s["idx"]: s for s in spans}
    bound = sum(bound_s(by[i]["attrs"]) for i in ms)
    return 100.0 * bound / (sum(ms.values()) / 1e3)


def idle_share(ctx):
    if not ctx.get("slice_s") or not ctx.get("red", {}).get("kernels"):
        return None
    return 100.0 * max(0.0, 1.0 - ctx["busy_s"] / ctx["slice_s"])


def mfu(ctx):
    from gillbench.flops import PEAK_BF16

    if not ctx.get("slice_s") or not ctx.get("flops"):
        return None
    return 100.0 * ctx["flops"] / (ctx["slice_s"] * PEAK_BF16)
