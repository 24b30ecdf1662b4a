"""Mean host ms a train step spent in the forward and the loss, no sync
(the program's ``train.forward`` spans, traced sub-window)."""

from portbench import spans


def read(rec):
    if rec.kind != "train":
        return None
    return spans.per_parent_ms("train.step", "train.optimizer", ("train.forward",))
