from .samplers import AspectRatioGroupSampler, InferenceSampler, RankBatchSampler, ShuffledBatchSampler

__all__ = ["AspectRatioGroupSampler", "InferenceSampler", "RankBatchSampler", "ShuffledBatchSampler"]
