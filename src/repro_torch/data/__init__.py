from repro_torch.data.partition import (dirichlet_partition, iid_partition,
                                        label_distribution)
from repro_torch.data.synthetic import SyntheticVision

__all__ = ["SyntheticVision", "dirichlet_partition", "iid_partition",
           "label_distribution"]
