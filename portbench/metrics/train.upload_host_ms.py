"""Mean host ms a train step spent uploading the batch to the card, no sync
(the program's ``train.upload`` spans, traced sub-window)."""

from portbench import spans


def read(rec):
    if rec.kind != "train":
        return None
    return spans.per_parent_ms("train.step", "train.optimizer", ("train.upload",))
