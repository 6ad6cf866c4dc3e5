"""p95 response time of the window's requests in an overloaded cell, in
s: recorded, not judged (just above capacity the queue grows all
through the window and the tail swings with it). Requests due before
the traced part only: the profiler slows the host."""
from portbench.readers import p_nearest


def read(obs, data):
    return p_nearest(obs["host_latency_s"], 0.95)
