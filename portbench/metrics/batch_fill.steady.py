"""Valid items a micro-batch over its capacity, in the window, in %
(``Scheduler.stats``: batched items / batches / capacity)."""


def read(obs, data):
    f = obs["batch_fill"]
    return None if f is None else 100.0 * f
