from repro_torch.fl.client import (SimClient, batch_index_plan,
                                   fleet_label_histograms, make_client_fleet)
from repro_torch.fl.engine import RoundEngine, make_fused_round, weighted_avg
from repro_torch.fl.server import RoundResult, SmartFreezeServer
from repro_torch.fl.sim import (FederatedLoop, FleetTimeModel, RoundRecord,
                                SyncAggregation)

__all__ = ["FederatedLoop", "FleetTimeModel", "RoundEngine", "RoundRecord",
           "RoundResult", "SimClient", "SmartFreezeServer", "SyncAggregation",
           "batch_index_plan", "fleet_label_histograms", "make_client_fleet",
           "make_fused_round", "weighted_avg"]
