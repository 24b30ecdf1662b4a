"""Seconds from process start to the first timed step or request:
imports, CUDA start, the kernel libraries, the weights, the inputs and
the warm-up (and, on a fresh checkout, the kernel build)."""


def read(rec):
    return rec.setup_s
