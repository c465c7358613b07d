"""Host ms from calling process_frame to its return (staging, the graph
launch), mean over the window's untraced frames."""


def read(t):
    return t.host_ms("process_frame")
