"""Device busy ms a batched step over the traced session."""


def read(t):
    return t.busy_ms_per_step()
