"""Mean host ms a dispatch spent in decode and NMS, each NMS sweep a host
sync (the program's ``serve.nms`` spans, traced sub-window)."""

from portbench import spans


def read(rec):
    if rec.kind != "serve":
        return None
    return spans.per_parent_ms("serve.dispatch", "serve.reply", ("serve.nms",))
