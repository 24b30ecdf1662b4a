"""Mean NMS fixed-point sweeps a dispatch (the ``sweeps`` the program
counts on its ``serve.nms`` spans, traced sub-window)."""

from portbench import spans


def read(rec):
    return spans.mean_attr("serve.nms", "sweeps") if rec.kind == "serve" else None
