"""1 - device busy time / traced session."""


def read(t):
    return t.idle_share()
