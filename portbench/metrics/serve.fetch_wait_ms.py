"""Mean host ms a dispatch spent waiting on the device: for the forward's
kernels before NMS, and for the copy of NMS's results to the host (the
program's ``serve.device_wait`` and ``serve.fetch`` spans, traced
sub-window)."""

from portbench import spans


def read(rec):
    if rec.kind != "serve":
        return None
    return spans.per_parent_ms("serve.dispatch", "serve.reply",
                               ("serve.device_wait", "serve.fetch"))
