"""Mean host ms a request waited from its submit to the start of the
dispatch that ran it (the program's ``serve.queue_wait`` spans, traced
sub-window)."""

from portbench import spans


def read(rec):
    return spans.mean_ms("serve.queue_wait") if rec.kind == "serve" else None
