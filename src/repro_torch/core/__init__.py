# The paper's primary contribution: the Optimal Load Shedding Algorithm
# and the trustworthy-IR pipeline around it (counterpart of
# ``repro.core``; the jnp twins ``classify_jnp`` / ``effective_deadline_jnp``
# and the unused ``gather_eval_indices`` / ``fused_shed_eval`` are not
# ported).
from repro_torch.core.regimes import Regime, classify
from repro_torch.core.deadline import effective_deadline, extension_factor
from repro_torch.core.load_monitor import LoadMonitor
from repro_torch.core.shedder import (LoadShedder, ShedResult, SimClock,
                                      TIER_CACHED, TIER_EVAL, TIER_INVALID,
                                      TIER_PRIOR, combine_trust,
                                      eval_indices_from_rank, shed_plan)
from repro_torch.core.fused_shedder import FusedLoadShedder, PendingShed
from repro_torch.core.adaptive import AdaptiveWeightController
from repro_torch.core.baselines import ProcessAll, RLSEDA
from repro_torch.core.pipeline import (PipelineOutput, SearchResults,
                                       SyntheticSearcher, TrustIRPipeline,
                                       trust_fidelity)

__all__ = [
    "Regime", "classify",
    "effective_deadline", "extension_factor",
    "LoadMonitor", "LoadShedder", "ShedResult", "SimClock",
    "TIER_CACHED", "TIER_EVAL", "TIER_INVALID", "TIER_PRIOR",
    "combine_trust", "eval_indices_from_rank", "shed_plan",
    "FusedLoadShedder", "PendingShed",
    "AdaptiveWeightController", "ProcessAll", "RLSEDA",
    "PipelineOutput", "SearchResults", "SyntheticSearcher",
    "TrustIRPipeline", "trust_fidelity",
]
