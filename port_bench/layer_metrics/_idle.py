"""The device's idle share of the traced window, 100 less the union of the
card's kernel, copy and set intervals over the window; averaged over the
cards of a cell of several ranks."""


def read(rec):
    busy, window = rec.get("busy_s"), rec.get("window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
