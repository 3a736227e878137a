"""The device's idle share of the traced stretch: 100 × (1 − the union of
the device events' intervals / the stretch's length), in %."""


def read(tr):
    if not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
