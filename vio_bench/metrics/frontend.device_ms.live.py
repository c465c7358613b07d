"""Device ms a step of the staged step's "detect" stage (ops/scale_space.py, ops/edge_detect.py)."""


def read(t):
    return t.stage_ms("detect")
