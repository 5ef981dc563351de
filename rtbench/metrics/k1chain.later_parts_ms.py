"""Device ms a frame of the K1 launches of parts 1 to P-1: what the parts
after the first cost, whose entry t the earlier parts set.

In a scene of P sub-block parts each bounce segment launches G5's
prologue (the first part's entry t), then K1 and its epilogue G4 once a
part, in part order (``ops/subblock_traversal.py:raycast_subblock``).
Those launches run inside the step's captured CUDA graph, where no host
span can tell the parts apart; the device trace can, by the order of the
K1 launches after each segment's prologue.  P is the ``parts`` arg of the
program's last ``scene.subblock`` span before the window.

The window's edges are the host's, and the trace's device clock may lie
off it by a millisecond or more, so they can cut a segment: the K1
launches before the window's first prologue are the last of their
segment, and the last segment may hold fewer than P.  None without a
trace or frames, without P (a program that does not record it), with
P < 2, or where a whole segment does not hold exactly P K1 launches.
"""

from rtbench import program, trace

SOURCE, UNIT = "device_trace", "ms"
LAYER = "K1 part chain"
MOVES = "frame_ms"
PROLOGUE = "wide_prologue"  # G5's first entry point, one a segment


def segments(run):
    """(head, segments): the (start us, end us) of each K1 launch that
    starts inside the traced window, those before its first prologue in
    ``head`` and the others by bounce segment."""
    lo, hi = run.traced
    head, out = [], []
    for name, a, b in run.device_events:
        if not lo <= a < hi:
            continue
        if PROLOGUE in name.lower():
            out.append([])
        elif trace.group(name) == "K1":
            (out[-1] if out else head).append((a, min(b, hi)))
    return head, out


def read(run):
    if run.traced is None or not run.n_frames:
        return None
    span = program.last_before_window(run, "scene.subblock")
    p = None if span is None else (span.args or {}).get("parts")
    if p is None or p < 2:
        return None
    head, segs = segments(run)
    if (not segs or len(head) > p or len(segs[-1]) > p
            or any(len(s) != p for s in segs[:-1])):
        return None
    # head[i] is part p - len(head) + i; every other segment starts at 0
    later = head[max(0, len(head) - p + 1):] + [
        k for s in segs for k in s[1:]]
    return sum(b - a for a, b in later) / 1e3 / run.n_frames
