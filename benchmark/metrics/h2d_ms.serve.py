"""Device ms a batch in host-to-device copies."""


def read(rec):
    if rec.kind != "serve" or rec.timeline is None:
        return None
    return rec.per_iteration_ms(lambda n: n.startswith("Memcpy HtoD"))
