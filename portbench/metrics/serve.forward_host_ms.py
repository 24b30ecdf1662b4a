"""Mean host ms a dispatch spent in the detector's forward call, no sync
(the program's ``serve.forward`` spans, traced sub-window)."""

from portbench import spans


def read(rec):
    if rec.kind != "serve":
        return None
    return spans.per_parent_ms("serve.dispatch", "serve.reply", ("serve.forward",))
