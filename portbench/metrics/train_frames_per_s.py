"""Frames trained (B x T x steps) over the window's wall time; the
window ends with the last step's device work done."""


def read(rec):
    if rec.kind != "train":
        return None
    return rec.counters["frames"] / rec.window_s
