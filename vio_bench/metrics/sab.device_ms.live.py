"""Device ms a step of "imu+rotate" and "sab" (ops/imu.py, ops/sab.py, K3)."""


def read(t):
    return t.stage_ms("imu+rotate", "sab")
