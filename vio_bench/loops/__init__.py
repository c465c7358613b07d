"""The loops that drive the traffic mixes, one module per ``kind``."""
