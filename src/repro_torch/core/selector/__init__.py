from repro_torch.core.selector.bandit import UtilBandit, mix_seed
from repro_torch.core.selector.louvain import louvain
from repro_torch.core.selector.rlcd import rlcd_communities
from repro_torch.core.selector.selection import (ClientInfo,
                                                 InfeasibleStageError,
                                                 ParticipantSelector)
from repro_torch.core.selector.similarity import similarity_matrix

__all__ = ["ClientInfo", "InfeasibleStageError", "ParticipantSelector",
           "UtilBandit", "louvain", "mix_seed", "rlcd_communities",
           "similarity_matrix"]
