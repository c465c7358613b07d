"""Device ms a step of "minimize_vel", "forward_match" and "ext_rot_vel" (ops/tracker.py, K2)."""


def read(t):
    return t.stage_ms("minimize_vel", "forward_match", "ext_rot_vel")
