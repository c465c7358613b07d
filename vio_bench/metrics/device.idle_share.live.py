"""1 - device busy time / traced window."""


def read(t):
    return t.idle_share()
