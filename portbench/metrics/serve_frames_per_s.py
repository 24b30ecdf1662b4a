"""detect() replies received in the window over the window's length."""


def read(rec):
    if rec.kind != "serve":
        return None
    return rec.counters["replies_in_window"] / rec.window_s
