"""Device busy ms a frame: the union of the device operations' intervals over
the traced frames, per frame."""


def read(t):
    return t.busy_ms_per_step()
