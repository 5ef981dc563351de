"""Spans and the device trace of a run.

Host spans are the benchmark's own, around its calls into the program.
In a ``--trace 1`` run each span is also a ``torch.profiler``
``record_function`` range, so it lies on the profiler's clock beside the
card's kernels.  The kernel grouping and the busy arithmetic (the union of
kernel intervals) are copied from ``chip_smoke.py``'s phase 11
(``_kernel_group``, ``_profile_frames``).
"""

from __future__ import annotations

import time

import torch

PREFIX = "rtbench."

# kernel name fragments -> group, first match wins (chip_smoke.py
# _kernel_group; "Memcpy DtoH" is a copy to the host)
GROUPS = (("G1 ray front", ("ray_front_kernel",)),
          ("G5 K3 prologue/epilogue", ("wide_prologue", "wide_epilogue")),
          ("G6 band fold", ("band_fold",)),
          ("block write", ("write_block",)),
          ("G2 sort keys", ("coherence_key_kernel",)),
          ("G3 reorder index pass", ("reorder_index_kernel",)),
          ("G3 reorder gather", ("reorder_kernel",)),
          ("G3 restore", ("restore_kernel",)),
          ("G4 K1 epilogue", ("part_epilogue_kernel",)),
          ("G7 bvh walk", ("bvh_walk",)),
          ("G8 brute sweep", ("brute_sweep",)),
          ("G9 packet walk", ("packet_walk",)),
          ("K3", ("wide_traverse",)), ("K1", ("traverse",)),
          ("K2", ("shade_kernel",)), ("sort", ("radix", "sort")),
          ("readback", ("memcpy dtoh",)),
          ("copy", ("memcpy", "memset")),
          ("gather/scatter", ("gather", "scatter", "index")))
TRAVERSALS = {"pallas2": "K1", "pallas": "K3", "brute": "G8 brute sweep",
              "bvh": "G7 bvh walk", "packet": "G9 packet walk"}


def group(name: str) -> str:
    n = name.lower()
    for g, keys in GROUPS:
        if any(k in n for k in keys):
            return g
    return "other torch kernels"


class Spans:
    """Named host spans: ``perf_counter`` seconds, and with ``profiled``
    a profiler range each."""

    def __init__(self, profiled: bool):
        self.profiled = profiled
        self.spans: list[tuple[str, float, float]] = []
        self._open: dict[str, tuple[float, object]] = {}

    def begin(self, name: str) -> None:
        rf = None
        if self.profiled:
            rf = torch.autograd.profiler.record_function(PREFIX + name)
            rf.__enter__()
        self._open[name] = (time.perf_counter(), rf)

    def end(self, name: str) -> float:
        t0, rf = self._open.pop(name)
        if rf is not None:
            rf.__exit__(None, None, None)
        t1 = time.perf_counter()
        self.spans.append((name, t0, t1))
        return t1 - t0

    def durations(self, name: str) -> list[float]:
        return [t1 - t0 for n, t0, t1 in self.spans if n == name]


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def read(prof) -> tuple[list, list]:
    """(device events, host spans) of a finished profiler: device events
    (name, start us, end us) of every kernel, copy and set on the card;
    host spans (name without the prefix, start us, end us) of the
    benchmark's ranges; both on the profiler's clock, in time order."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if e.name().startswith(PREFIX):
            # the profiler copies each range onto the card's timeline too
            if e.device_type() != cuda:
                host.append((e.name()[len(PREFIX):], start, end))
        elif e.device_type() == cuda:
            dev.append((e.name(), start, end))
    dev.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return dev, host


def busy_intervals(events, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of the events' intervals inside [lo, hi], merged."""
    out: list[list[float]] = []
    for _, a, b in events:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_gaps(busy, host, lo: float, hi: float) -> dict[str, float]:
    """Seconds the card sat idle inside [lo, hi], split by the host span
    that was open meanwhile ("other" where none was)."""
    if not busy:
        return {"other": (hi - lo) / 1e6}
    gaps = [(lo, busy[0][0])] + [(busy[i][1], busy[i + 1][0])
                                 for i in range(len(busy) - 1)]
    gaps.append((busy[-1][1], hi))
    inner = [h for h in host if h[0] != "window"]  # disjoint, by start
    out: dict[str, float] = {}
    j = 0
    for a, b in gaps:
        if b <= a:
            continue
        while j < len(inner) and inner[j][2] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(inner) and inner[k][1] < b:
            n, s, e = inner[k]
            part = min(b, e) - max(a, s)
            if part > 0:
                out[n] = out.get(n, 0.0) + part / 1e6
                covered += part
            k += 1
        if b - a > covered:
            out["other"] = out.get("other", 0.0) + (b - a - covered) / 1e6
    return out
