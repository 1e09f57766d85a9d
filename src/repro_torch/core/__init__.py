"""Books, symbol planes, the chunked wire format and the plain-torch
codecs (port of ``repro.core``), with the paper's two encoders and its
shard statistics."""
from .encoder import encoded_size_bits, single_stage_encode, three_stage_encode
from .stats import ShardStatsCollector, per_shard_report, shard_histograms

__all__ = ["encoded_size_bits", "single_stage_encode", "three_stage_encode",
           "ShardStatsCollector", "per_shard_report", "shard_histograms"]
