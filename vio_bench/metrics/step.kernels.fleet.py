"""Device kernels a batched step (memory copies and fills not counted)."""


def read(t):
    return t.kernels_per_step()
