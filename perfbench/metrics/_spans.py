"""What the span readers share (no metric of its own): the device
intervals of the program's spans (``obs/trace.py``: ``args.dev_ts`` and
``args.dev_dur``, µs on the host's wall clock) in a traced window.

A span's device interval holds another's when it starts no later and
ends no earlier, to ``SLACK_US``: spans of one stream nest by their
device intervals whatever thread opened them (the embedding's and the
FM's backward run on autograd's thread). A program without such spans
gives no intervals, and its readers read None."""

from typing import Iterable, List, Optional, Tuple

#: Rounding of the card's float milliseconds to µs and back.
SLACK_US = 1.0

Interval = Tuple[float, float]


def intervals(ctx, names: Iterable[str]) -> List[Interval]:
    """(start, end) in µs of the window's device-timed spans named in
    ``names``, by start."""
    names = set(names)
    out = []
    for s in ctx.spans:
        args = s.get("args") or {}
        if s["name"] in names and "dev_dur" in args:
            out.append((args["dev_ts"], args["dev_ts"] + args["dev_dur"]))
    return sorted(out)


def inside(iv: Interval, outer: Interval) -> bool:
    return outer[0] - SLACK_US <= iv[0] and iv[1] <= outer[1] + SLACK_US


def union_us(ivs: List[Interval]) -> float:
    """Length of the union of ``ivs`` (sorted by start)."""
    total, end = 0.0, float("-inf")
    for a, b in ivs:
        a = max(a, end)
        if b > a:
            total += b - a
            end = b
    return total


def per_step_ms(ctx, names: Iterable[str]) -> Optional[float]:
    """The device time of the spans named in ``names``, per step of the
    window, in ms; None where the window has none or no steps."""
    ivs = intervals(ctx, names)
    if not ivs or ctx.steps <= 0:
        return None
    return sum(b - a for a, b in ivs) / 1e3 / ctx.steps
