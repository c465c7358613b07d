"""Device ms a step of "(product path)" (pipeline.advance: the pose and the device selects)."""


def read(t):
    return t.stage_ms("(product path)")
