"""100 x the port kernels' bound ms, times the lanes, / their device ms over the traced session."""


def read(t):
    return t.roofline_pct()
