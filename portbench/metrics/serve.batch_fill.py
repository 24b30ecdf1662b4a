"""Mean of the replies' ``batch`` (requests served by their dispatch)
over the service's ``max_batch``."""


def read(rec):
    if rec.kind != "serve" or not rec.attempted:
        return None
    return 100.0 * rec.counters["batch_fill"]
