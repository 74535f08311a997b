"""``device_idle_pct``: the share of the traced window (whole outer
iterations, host clock) in which no operation ran on the card: 100 (1 -
busy / window), busy the union of the device intervals."""


def read(run):
    tr = run.get("trace")
    if not tr or not tr["events"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
