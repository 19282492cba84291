"""The slots the exact FSW route sorts a training step, in millions, over
the window: the program's counter ``fsw.exact.slots`` (``models/fsw.py``:
every exact sort's rows x N under autograd, padding and a chunk's
recompute in the backward included) over the window's steps. A step that
sorts its batch once reads B x C x N / 1e6 per genome (C x V on the shared
route); re-sorting every chunk in the backward doubles it, and padding
each batch to its own longest item would lower it. None where the program
does not count them."""


def read(r):
    records = r.run.records
    slots, steps = records.get("counters", {}).get("fsw.exact.slots"), records.get("steps")
    if slots is None or not steps:
        return None
    return slots / steps / 1e6
