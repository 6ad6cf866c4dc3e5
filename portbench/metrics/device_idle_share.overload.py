"""% of the traced window in which no kernel ran on the device (the
union of kernel intervals, ``readers.idle_share``)."""
from portbench.readers import idle_share


def read(obs, data):
    return idle_share(obs)
