"""Host ms of one search (BM25 on the card, ``topk_select``, one copy
back), the mean over the window's searches (in a traced run, those
before the traced part)."""


def read(obs, data):
    s = obs["search_s"]
    return 1e3 * sum(s) / len(s) if s else None
