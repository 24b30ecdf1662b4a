"""Mean host ms a train step spent in the clip's norm and AdamW, no sync
(the program's ``train.optimizer`` spans, traced sub-window)."""

from portbench import spans


def read(rec):
    if rec.kind != "train":
        return None
    return spans.per_parent_ms("train.step", "train.optimizer", ("train.optimizer",))
