"""Edges a second: all the work of the window over all of its time.
The work is the yardstick's (the trial kind's ``work``), not the
program's count."""


def read(rec):
    if not rec.trials or rec.window_s <= 0:
        return None
    return sum(t["work"] for t in rec.trials) / rec.window_s
