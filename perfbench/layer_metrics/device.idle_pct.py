"""device.idle_pct: the share of the traced window in which no operation
ran on the card (the union of the device records' intervals against the
window's length).  Percent."""


def read(view):
    if view.window_s <= 0 or not view.events:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s)
