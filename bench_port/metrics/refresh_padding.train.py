"""The share of the per-genome refreshes' sorted slots that are padding:
100 (1 - points / slots) from the program's counters over the window
(``fsw.refresh.points``, the real points, and ``fsw.refresh.slots``, items
x the padded length N; ``train/fsw_lazy.py`` ``LazyPlanes``)."""


def read(r):
    counters = r.run.records.get("counters", {})
    points, slots = counters.get("fsw.refresh.points"), counters.get("fsw.refresh.slots")
    if not slots or points is None:
        return None
    return 100.0 * (1.0 - points / slots)
