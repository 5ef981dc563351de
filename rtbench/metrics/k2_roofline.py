"""K2's share of its roofline, in %: the least bytes the shade step needs
over the card's memory rate, against K2's device time in the traced
window.

The least bytes, frozen here.  Each bounce segment hands K2 every ray of
the frame.  A ray alive as the segment starts has each input column read
once and each output column written once, with a 32-bit seed: in t, u,
v, origin, direction, ray colour, incoming light (15 x 4 B), the material
index (4 B), alive (1 B), the seed (4 B); out origin, direction, ray
colour, incoming light (12 x 4 B), alive (1 B), the seed (4 B).  A dead
ray needs its alive flag read (1 B) and nothing written.  The share of
rays alive as each segment starts comes from the plain reference's own
paths at the pixels the check samples (``run.live_share``), not from the
program.  The material table is not counted: a launch reads only the rows
its rays hit, a number the data sets.  H100 SXM HBM3: 3.35 TB/s (data
sheet)."""

SOURCE, UNIT = "device_trace", "%"
LAYER = "K2 shade"
MOVES = "frame_ms"
PEAK_BYTES_S = 3.35e12
BYTES_IN = 15 * 4 + 4 + 1 + 4
BYTES_OUT = 12 * 4 + 1 + 4
BYTES_DEAD = 1


def read(run):
    if run.traced is None or run.live_share is None:
        return None
    k2_ms = run.group_ms_per_frame().get("K2")
    if not k2_ms:
        return None
    least = run.rays_per_frame * sum(
        s * (BYTES_IN + BYTES_OUT) + (1.0 - s) * BYTES_DEAD
        for s in run.live_share)
    return 100.0 * (least / PEAK_BYTES_S * 1e3) / k2_ms
