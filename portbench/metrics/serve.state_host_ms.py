"""Mean host ms a dispatch spent stacking the streams' recurrent states
into the batch and splitting them back (the program's
``serve.state_stack`` + ``serve.state_split`` spans, traced sub-window)."""

from portbench import spans


def read(rec):
    if rec.kind != "serve":
        return None
    return spans.per_parent_ms("serve.dispatch", "serve.reply",
                               ("serve.state_stack", "serve.state_split"))
