"""Device ms a step of the "att_field" stage (ops/distance_field.py, K1)."""


def read(t):
    return t.stage_ms("att_field")
