"""A kernel family's share of its roofline in the trace: the least time of
each of its launches (``perfbench/roofline``) summed, over the device time
of those launches summed."""


def share(run, family, shape_key):
    tr = run.get("trace")
    shape = run["shapes"].get(shape_key)
    if not tr or shape is None:
        return None
    bound_ms = device_ms = 0.0
    for symbol, least in family.launch_bounds(shape).values():
        durs = [dur for name, _, dur in tr["events"] if symbol in name]
        bound_ms += least * len(durs)
        device_ms += sum(durs) / 1e6
    return 100.0 * bound_ms / device_ms if device_ms > 0 else None
