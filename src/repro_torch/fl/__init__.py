from repro_torch.fl.client import (SimClient, batch_index_plan,
                                   fleet_label_histograms, make_client_fleet)
from repro_torch.fl.compression import (ErrorFeedback, topk_compress,
                                        topk_decompress)
from repro_torch.fl.engine import (RoundEngine, make_fused_round,
                                   make_lm_cached_fed_round_step,
                                   weighted_avg)
from repro_torch.fl.quant import (CACHE_TIERS, EncodedFeatures,
                                  decode_features, dequantize_int8,
                                  encode_features, quantize_int8)
from repro_torch.fl.server import FedAvgServer, RoundResult, SmartFreezeServer
from repro_torch.fl.sim import (AsyncBufferedAggregation, AvailabilityTrace,
                                DeadlineAggregation, FederatedLoop,
                                FleetTimeModel, RoundRecord, SyncAggregation)

__all__ = ["AsyncBufferedAggregation", "AvailabilityTrace", "CACHE_TIERS",
           "DeadlineAggregation", "EncodedFeatures", "ErrorFeedback",
           "FedAvgServer", "FederatedLoop", "FleetTimeModel", "RoundEngine",
           "RoundRecord", "RoundResult", "SimClient", "SmartFreezeServer",
           "SyncAggregation", "batch_index_plan", "decode_features",
           "dequantize_int8", "encode_features", "fleet_label_histograms",
           "make_client_fleet", "make_fused_round",
           "make_lm_cached_fed_round_step", "quantize_int8",
           "topk_compress", "topk_decompress", "weighted_avg"]
