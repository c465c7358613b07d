"""Device ms a step of "directed_match" and "reg+ekf(fused)" (ops/matching.py, K4, K5)."""


def read(t):
    return t.stage_ms("directed_match", "reg+ekf(fused)")
