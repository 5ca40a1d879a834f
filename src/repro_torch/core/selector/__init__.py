from repro_torch.core.selector.similarity import (label_sketches,
                                                  output_layer_gradient,
                                                  similarity_matrix,
                                                  sketch_projection,
                                                  topm_neighbors)
from repro_torch.core.selector.louvain import louvain
from repro_torch.core.selector.rlcd import (label_propagation,
                                            rlcd_communities,
                                            sketch_communities)
from repro_torch.core.selector.bandit import UtilBandit, mix_seed
from repro_torch.core.selector.selection import (ClientInfo,
                                                 InfeasibleStageError,
                                                 ParticipantSelector)
from repro_torch.core.selector.vectorized import (ClientPopulation,
                                                  VectorizedSelector,
                                                  population_from_selector)

__all__ = ["ClientInfo", "ClientPopulation", "InfeasibleStageError",
           "ParticipantSelector", "UtilBandit", "VectorizedSelector",
           "label_propagation", "label_sketches", "louvain", "mix_seed",
           "output_layer_gradient", "population_from_selector",
           "rlcd_communities", "similarity_matrix", "sketch_communities",
           "sketch_projection", "topm_neighbors"]
