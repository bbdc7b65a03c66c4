"""The share of BFS trials that ended on the dense xspmv route
(``fused.last_frontier["route"] == "dense"``), in %."""


def read(rec):
    routes = [t.get("route") for t in rec.trials]
    if not routes or None in routes:
        return None
    return 100.0 * routes.count("dense") / len(routes)
