from repro_torch.data.partition import (dirichlet_partition, iid_partition,
                                        label_distribution)
from repro_torch.data.synthetic import (SyntheticLM, SyntheticVision,
                                        input_specs, make_lm_batch)

__all__ = ["SyntheticLM", "SyntheticVision", "dirichlet_partition",
           "iid_partition", "input_specs", "label_distribution",
           "make_lm_batch"]
