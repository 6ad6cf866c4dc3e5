"""% of the window's admitted items answered by a Trust-DB hit
(``TIER_CACHED``)."""
from portbench.readers import tier_share


def read(obs, data):
    return tier_share(obs, 1)
