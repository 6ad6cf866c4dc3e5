"""% of the window's admitted items whose tier is the prior
(``TIER_PRIOR``): shed inside the fused step."""
from portbench.readers import tier_share


def read(obs, data):
    return tier_share(obs, 2)
