"""ms a BFS level: ``fused.last_frontier["seconds"]`` (the host's clock
around the program's call, every route tried) summed over the traced
window's trials, over the summed depths of their answers."""


def read(rec):
    secs = [t.get("seconds") for t in rec.trials]
    depth = [t.get("depth") for t in rec.trials]
    if not secs or None in secs or None in depth or not sum(depth):
        return None
    return 1e3 * sum(secs) / sum(depth)
