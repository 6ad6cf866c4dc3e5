"""% of the window's requests answered at admission
(``Response.admitted`` False): every item from the prior."""


def read(obs, data):
    n = obs["n_requests"]
    return 100.0 * obs["n_rejected"] / n if n else None
