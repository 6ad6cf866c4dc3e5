"""p99 of how late the open-loop client offered the window's requests
against their due times, in ms (the client's own layer); in a traced
run, the requests due before the traced part."""
from portbench.readers import p_nearest


def read(obs, data):
    v = p_nearest(obs["late_s"], 0.99)
    return None if v is None else v * 1e3
